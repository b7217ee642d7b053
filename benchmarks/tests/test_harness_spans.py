"""The metrics that read the program's spans (``harness/spans.py`` and its
readers) against hand-made span records, and the spans a traced CPU run
of each cell leaves: one root span a traced step or request."""
import pytest

from benchmarks.harness import manifest, runner, spans
from benchmarks.harness.profile import Trace


def _ctx(units: int, busy: float = 1.0):
    trace = Trace(window_s=2.0, busy_s=busy, kernels={}, launches=0)
    return runner.LayerContext(config={}, traffic={}, kind="train",
                               window={"seconds": 1.0, "units": []},
                               traced_units=[(10, 40)] * units, trace=trace)


def _rec(name, root, device_ms):
    return {"name": name, "root": root, "device_ms": device_ms}


def _steps(n, forward=(3.0, 5.0)):
    """``n`` training steps' spans, ``forward`` the two passes of each."""
    recs = []
    for k in range(n):
        recs += [_rec("model.forward", False, forward[0]),
                 _rec("model.forward", False, forward[1]),
                 _rec("train.forward", False, 8.0 + k),
                 _rec("train.backward", False, 11.0 + 2 * k),
                 _rec("train.optimizer", False, 0.5),
                 _rec("train.step", True, 20.0 + k)]
    return recs


def test_per_unit_means():
    recs = _steps(3)
    ctx = _ctx(3)
    assert spans.per_unit_ms(ctx, "train.forward", recs=recs) == 9.0
    assert spans.per_unit_ms(ctx, "train.backward", recs=recs) == 13.0
    assert spans.per_unit_ms(ctx, "train.optimizer", recs=recs) == 0.5
    # two passes a step: their sum per step
    assert spans.per_unit_ms(ctx, "model.forward", recs=recs) == 8.0
    assert spans.per_unit_ms(ctx, "train.step", recs=recs) == 21.0


@pytest.mark.parametrize("why,ctx,recs", [
    ("no device trace", _ctx(3, busy=0.0), _steps(3)),
    ("no traced unit", _ctx(0), _steps(3)),
    ("roots are not the units", _ctx(2), _steps(3)),
    ("no span", _ctx(3), []),
    ("no span of the name", _ctx(3),
     [r for r in _steps(3) if r["name"] != "model.forward"]),
])
def test_per_unit_reads_nothing(why, ctx, recs):
    assert spans.per_unit_ms(ctx, "model.forward", recs=recs) is None, why


def test_records_taken_once_per_segment(monkeypatch):
    from gnnome_tpu_torch.utils import timing

    held = [_steps(1)]
    monkeypatch.setattr(timing, "spans", lambda: list(held[0]))
    monkeypatch.setattr(timing, "clear", lambda: held.__setitem__(0, []))
    ctx = _ctx(1)
    first = spans.records(ctx)
    assert len(first) == 6 and held[0] == []
    assert spans.records(ctx) is first          # the same segment
    assert spans.records(_ctx(1)) == []         # a new one: what is new
    assert spans.records(_ctx(1, busy=0.0)) is None
    monkeypatch.delattr(timing, "spans")       # a program without them
    assert spans.records(_ctx(1)) is None


def _score_recs(n):
    """``n`` requests of the mix: the model's forward is the root."""
    return [_rec("model.forward", True, 6.0 + k) for k in range(n)]


@pytest.mark.parametrize("metric,recs,units,want", [
    ("forward_ms.train", _steps(3), 3, 9.0),
    ("backward_ms.train", _steps(3), 3, 13.0),
    ("optimizer_ms.train", _steps(3), 3, 0.5),
    ("forward_ms.score", _score_recs(4), 4, 7.5),
])
def test_readers(monkeypatch, metric, recs, units, want):
    monkeypatch.setattr(spans, "records", lambda ctx: recs)
    mod = manifest.load_module("metrics", metric + ".py")
    assert mod.read(_ctx(units)) == pytest.approx(want)
    assert mod.read(_ctx(units, busy=0.0)) is None


@pytest.mark.parametrize("cell,override,root,units,inner", [
    ("train-b64-g524k", {"nodes": 2048}, "train.step", 3,
     ["train.forward", "model.forward", "train.backward",
      "train.optimizer"]),
    ("train-ln64-g262k", {"nodes": 2048}, "train.step", 3,
     ["train.forward", "model.forward", "model.forward", "train.backward",
      "train.optimizer"]),
    ("score-b64-mix", {"graphs": [256, 512]}, "model.forward", 4, []),
])
def test_traced_cpu_run_leaves_one_root_a_unit(monkeypatch, cell, override,
                                               root, units, inner):
    """The spans a traced run keeps, with a stand-in for ``torch.cuda``
    that the recorder sees as initialised (a CPU run keeps none)."""
    import itertools
    from types import SimpleNamespace

    import torch

    from gnnome_tpu_torch.utils import timing

    clock = itertools.count()

    class Event:
        def __init__(self, enable_timing):
            pass

        def record(self):
            self.t = next(clock)

        def elapsed_time(self, end):
            return float(end.t - self.t)

    cuda = SimpleNamespace(is_initialized=lambda: True, Event=Event,
                           synchronize=lambda: None)
    monkeypatch.setattr(timing, "torch",
                        SimpleNamespace(profiler=torch.profiler, cuda=cuda))
    timing.clear()
    r = runner.run_cell(cell, 2 ** 31 + 7, 0.5, True, "cpu",
                        traffic_override=override)
    recs = timing.spans()
    timing.clear()
    assert r["correct"], r["checks"]
    assert r["metrics"] == {}            # no device trace on the CPU
    assert [s["name"] for s in recs if s["root"]] == [root] * units
    assert sorted(s["name"] for s in recs if not s["root"]) == \
        sorted(inner * units)
