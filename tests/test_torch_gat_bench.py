"""The port's GAT on the benchmark's training path, on the CPU: the cell
``train-gat-g524k``'s driver at 2,048 nodes (``make_example(...,
model_cfg=...)``, ``train_step``, seeded weights) against the plain
reference ``benchmarks/reference/gat.py`` within the cell's limits; the
reference's TF32 control and the graph without its self-loops each fail a
limit; the zoo's spans (``model.forward`` in every zoo model, one
``gat.attention`` and one ``gat.aggregate`` a GAT layer), kept on CUDA
and changing no number; the GAT weights under the port's names; the
yardstick's K2 walk and step costs against hand counts."""
import itertools
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks.harness import compare, gat_costs, gat_weights  # noqa: E402
from benchmarks.harness import manifest  # noqa: E402
from gnnome_tpu_torch.config import Config  # noqa: E402
from gnnome_tpu_torch.graphs import synthetic_assembly_graph  # noqa: E402
from gnnome_tpu_torch.models.zoo import get_model  # noqa: E402
from gnnome_tpu_torch.train.step import (host_units,  # noqa: E402
                                         make_example, make_optimizer,
                                         train_step)
from gnnome_tpu_torch.utils import timing  # noqa: E402

CELL = "train-gat-g524k"
NODES = 2048
SPANS = {"train.step", "train.forward", "model.forward", "gat.attention",
         "gat.aggregate"}


def _driver(seed):
    """The driver after set-up and release, and the cell's limits; its
    processor graph's edge count kept as ``drv.proc_edges``."""
    c = manifest.cell(CELL)
    mod = manifest.load_module("drivers", c.traffic["driver"] + ".py")
    drv = mod.Driver(c.config, dict(c.traffic, nodes=NODES), seed, "cpu")
    drv.setup()
    drv.proc_edges = drv.ex.g_proc.n_edges
    drv.release()
    return drv, c.limits


@pytest.fixture(scope="module")
def run():
    """The driver's set-up at 2,048 nodes and its reference."""
    drv, limits = _driver(2 ** 31 + 99)
    return drv, limits, drv.reference()


@pytest.mark.parametrize("seed", [5, 2 ** 33 + 17])
def test_port_against_the_reference(seed):
    drv, limits = _driver(seed)
    assert drv.proc_edges == drv.graph.num_edges + NODES
    correct, checks = compare.verdict(
        drv.gaps(drv.outputs(), drv.reference()), limits)
    assert correct, checks
    assert len(drv.prog["losses"]) == 3
    assert set(drv.prog["grad1"]) == set(drv.w0)


@pytest.mark.parametrize("kind", ["tf32", "no_self_loops"])
def test_control_and_fault_fail_a_limit(run, kind):
    drv, limits, ref = run
    out = drv.reference(**({"tf32": True} if kind == "tf32"
                           else {"self_loops": False}))
    correct, checks = compare.verdict(drv.gaps(out, ref), limits)
    assert not correct, checks


def test_weights_under_the_ports_names():
    c = manifest.cell(CELL).config
    w = gat_weights.make_weights(c, 7, "cpu")
    cfg = manifest.load_module("drivers", "train_zoo_full_graph.py") \
        .port_config(c)
    model = get_model(cfg.model)
    model.load_state_dict(w, strict=True)
    d, heads = c["dim_latent"], c["heads"]
    assert w["gnn.convs.0.fc.weight"].shape == (heads * d, d)
    assert w["proj.7.weight"].shape == (d, heads * d)
    for name, _, bound in gat_weights.param_specs(c):
        assert w[name].abs().max() <= bound
    assert w["gnn.convs.3.bias"].abs().max() > 0.5 * (heads * d) ** -0.5
    again = gat_weights.make_weights(c, 7, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)


# ------------------------------------------------------------------ spans
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


LAYERS = 3


def _step(graph, name):
    """One training step of a zoo model from fresh weights: (loss,
    logits, parameters)."""
    cfg = Config()
    cfg.model.model = name
    cfg.model.num_gnn_layers = LAYERS
    cfg.model.dim_latent = 16
    cfg.train.masking = False
    model = get_model(cfg.model).init_weights(5)
    opt = make_optimizer(model, 1e-3)
    (u,) = host_units(graph, cfg, np.random.default_rng(0))
    ex = make_example(u.in_deg, u.out_deg, u.e_feat, u.y, u.src, u.dst,
                      u.n_nodes, "cpu", model_cfg=cfg.model)
    loss, logits = train_step(model, opt, ex, 1.3, cfg,
                              torch.Generator().manual_seed(7))
    return loss, logits, {n: p.detach().clone()
                          for n, p in model.named_parameters()}


def _tree(fn):
    """``fn()``'s result under the profiler, and its spans: ``(name,
    enclosing span's name)`` in the order they opened."""
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


@pytest.mark.parametrize("name", ["gatedgcn", "gcn", "gat", "sage"])
def test_zoo_forward_span(graph, name):
    _, tree = _tree(lambda: _step(graph, name))
    layer = ([("gat.attention", "model.forward"),
              ("gat.aggregate", "model.forward")] if name == "gat" else [])
    assert tree == ([("train.step", None), ("train.forward", "train.step"),
                     ("model.forward", "train.forward")] + layer * LAYERS)


def test_off_enters_no_record_function(monkeypatch, graph):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _step(graph, "gat")
    assert timing.spans() == []


def test_gat_spans_kept_on_cuda(cuda, graph):
    off = _step(graph, "gat")
    on, _ = _tree(lambda: _step(graph, "gat"))
    names = [r["name"] for r in timing.spans()]
    assert names.count("gat.attention") == names.count("gat.aggregate") \
        == LAYERS
    assert names.index("model.forward") > names.index("gat.aggregate")
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    assert all(torch.equal(off[2][n], on[2][n]) for n in off[2])


# ------------------------------------------------------------------ costs
def test_k2_side_cost_hand_count():
    # N = 4 nodes, E = 6 slots, D = 3: payload 6*3 floats, 5 row pointers,
    # 6 permutation entries (src side only), 4*3 floats of sums
    assert gat_costs.k2_side_cost(4, 6, 3) == (
        4 * 18 + 4 * (5 + 6) + 4 * 12, 18.0, 0.0)
    assert gat_costs.k2_side_cost(4, 6, 3, perm=False) == (
        4 * 18 + 4 * 5 + 4 * 12, 18.0, 0.0)


def test_gat_step_flops_hand_count():
    cfg = {"dim_latent": 2, "hidden_ne_features": 3, "heads": 2,
           "hidden_edge_scores": 4, "score_hidden_2": 2, "node_features": 2,
           "edge_features": 2, "num_gnn_layers": 1}
    N, E = 5, 7
    first = 2 * N * 2 * 3 + 2 * E * 2 * 3                 # 144
    rest = (2 * N * 3 * 2 + 2 * E * 3 * 2                 # encoders' seconds
            + 2 * N * 2 * 4 + 2 * N * 4 * 2               # fc, proj
            + 2 * (2 * N * 2 * 4) + 2 * E * 2 * 4         # W1, least form
            + 2 * E * 4 * 2 + 2 * E * 2 * 1)              # W2, W3
    assert rest == 716
    assert gat_costs.gat_step_flops(cfg, N, E) == 2 * first + 3 * rest \
        == 2436
