"""The port's spans (``gnnome_tpu_torch/utils/timing.py``) on the CPU: off,
a span never enters ``record_function``; under ``torch.profiler`` a
training step and a scoring request show their spans in the profiler's
events, nested as documented; spans are kept (with two CUDA events each)
only on an initialised CUDA device and outside ``trace_only()``, which a
stand-in for ``torch.cuda`` shows here; recording changes no number the
step or request computes; ``Timer`` keeps its phases and printout."""
import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gnnome_tpu_torch.config import Config
from gnnome_tpu_torch.graphs import synthetic_assembly_graph
from gnnome_tpu_torch.infer import score_model
from gnnome_tpu_torch.models.zoo import get_model
from gnnome_tpu_torch.train.step import (host_units, make_example,
                                         make_optimizer, train_step)
from gnnome_tpu_torch.utils import timing

SPANS = {"train.step", "train.forward", "train.backward", "train.optimizer",
         "model.forward", "score.request", "score.graph_build",
         "score.features", "score.copy"}


@pytest.fixture(scope="module")
def graph():
    return synthetic_assembly_graph(n_reads=200, genome_len=20_000,
                                    read_len=900, seed=3)[0]


@pytest.fixture(autouse=True)
def empty_recorder():
    timing.clear()
    yield
    timing.clear()


class _Event:
    """A CUDA event's stand-in: its time is the order it was recorded in."""
    clock = itertools.count()

    def __init__(self, enable_timing):
        assert enable_timing

    def record(self):
        self.t = next(_Event.clock)

    def elapsed_time(self, end):
        return float(end.t - self.t)


@pytest.fixture
def cuda(monkeypatch):
    """The recorder sees an initialised CUDA device."""
    fake = SimpleNamespace(is_initialized=lambda: True, Event=_Event,
                           synchronize=lambda: None)
    monkeypatch.setattr(timing, "torch",
                        SimpleNamespace(profiler=torch.profiler, cuda=fake))


def _cfg(normalization: str) -> Config:
    cfg = Config()
    cfg.model.normalization = normalization
    cfg.model.num_gnn_layers = 2
    cfg.model.dim_latent = 16
    cfg.train.masking = False
    return cfg


def _step(graph, normalization: str):
    """One training step from fresh weights: (loss, logits, parameters)."""
    cfg = _cfg(normalization)
    model = get_model(cfg.model).init_weights(5)
    opt = make_optimizer(model, 1e-3)
    (u,) = host_units(graph, cfg, np.random.default_rng(0))
    ex = make_example(u.in_deg, u.out_deg, u.e_feat, u.y, u.src, u.dst,
                      u.n_nodes, "cpu")
    loss, logits = train_step(model, opt, ex, 1.3, cfg,
                              torch.Generator().manual_seed(7))
    return loss, logits, {n: p.detach().clone()
                          for n, p in model.named_parameters()}


def _score(graph):
    cfg = _cfg("batch")
    return score_model(get_model(cfg.model).init_weights(5), graph, cfg,
                       "cpu")


def _tree(fn):
    """``fn()``'s result under the profiler, and its spans as the
    profiler's events show them: ``(name, enclosing span's name)`` in the
    order they opened."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    evs = sorted((e for e in prof.events() if e.name in SPANS),
                 key=lambda e: e.time_range.start)
    tree = []
    for e in evs:
        p = e.cpu_parent
        while p is not None and p.name not in SPANS:
            p = p.cpu_parent
        tree.append((e.name, None if p is None else p.name))
    return out, tree


def test_off_enters_no_record_function(monkeypatch, graph):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    # the name the recorder opens (PyTorch's optimizers open their own)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _step(graph, "batch")
    _score(graph)
    assert timing.spans() == []


@pytest.mark.parametrize("normalization,passes", [("batch", 1),
                                                  ("layer", 2)])
def test_train_step_spans(graph, normalization, passes):
    _, tree = _tree(lambda: _step(graph, normalization))
    assert tree == ([("train.step", None), ("train.forward", "train.step")]
                    + [("model.forward", "train.forward")] * passes
                    + [("train.backward", "train.step"),
                       ("train.optimizer", "train.step")])
    assert timing.spans() == []          # nothing kept without CUDA


def test_score_model_spans(graph):
    _, tree = _tree(lambda: _score(graph))
    assert tree == [("score.request", None),
                    ("score.graph_build", "score.request"),
                    ("score.features", "score.request"),
                    ("model.forward", "score.request"),
                    ("score.copy", "score.request")]
    assert timing.spans() == []


@pytest.mark.parametrize("normalization,passes", [("batch", 1),
                                                  ("layer", 2)])
def test_kept_on_cuda(cuda, graph, normalization, passes):
    """On CUDA each span keeps its name, whether it is a root, and the
    device time between its events, in the order the spans closed."""
    _tree(lambda: _step(graph, normalization))
    recs = timing.spans()
    assert [(r["name"], r["root"]) for r in recs] == (
        [("model.forward", False)] * passes
        + [("train.forward", False), ("train.backward", False),
           ("train.optimizer", False), ("train.step", True)])
    ms = {r["name"]: r["device_ms"] for r in recs}
    assert ms["train.step"] > ms["train.forward"] > ms["model.forward"] > 0
    timing.clear()
    _tree(lambda: _score(graph))
    assert [(r["name"], r["root"]) for r in timing.spans()] == [
        ("score.graph_build", False), ("score.features", False),
        ("model.forward", False), ("score.copy", False),
        ("score.request", True)]


def test_trace_only_keeps_nothing(cuda, graph):
    with timing.trace_only():
        _, tree = _tree(lambda: _score(graph))
    assert [name for name, _ in tree][0] == "score.request"
    assert timing.spans() == []
    _tree(lambda: _score(graph))         # kept again after it
    assert len(timing.spans()) == 5


def test_kept_only_while_profiling(cuda, graph):
    _score(graph)
    assert timing.spans() == []


@pytest.mark.parametrize("normalization", ["batch", "layer"])
def test_recording_changes_no_step(cuda, graph, normalization):
    off = _step(graph, normalization)
    on, tree = _tree(lambda: _step(graph, normalization))
    assert tree and timing.spans()
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    assert all(torch.equal(off[2][n], on[2][n]) for n in off[2])


def test_recording_changes_no_logits(cuda, graph):
    off = _score(graph)
    on, tree = _tree(lambda: _score(graph))
    assert tree and timing.spans() and np.array_equal(off, on)


def test_timer_keeps_phases_and_printout():
    timer = timing.Timer("infer.")
    for _ in range(2):
        with timer.phase("score"):
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.phase("decode"):
            pass
    assert list(timer.phases) == ["score", "decode"]
    assert all(v >= 0 for v in timer.phases.values())
    lines = timer.summary().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["score", "decode", "total"]
    assert "infer.decode" in {e.name for e in prof.events()}
    assert "infer.score" not in {e.name for e in prof.events()}


def test_profile_trace_carries_the_spans(cuda, graph, tmp_path):
    """``cli infer --profile DIR``'s trace holds the spans by name, and
    the recorder keeps none of them."""
    import json

    from gnnome_tpu_torch import cli

    with cli._maybe_trace(str(tmp_path)):
        _score(graph)
    with open(tmp_path / "trace.json") as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert {"score.request", "score.graph_build", "score.features",
            "model.forward", "score.copy"} <= names
    assert timing.spans() == []
