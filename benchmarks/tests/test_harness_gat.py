"""The cell ``train-gat-g524k``: a run at a tiny size on the CPU through
the same run as on the card (set-up, window, check), each planted fault
and the control not correct, the K2 walks' roofline reader against a
stand-in trace, and, on the card, the run at 65,536 nodes reading every
per-layer metric of the cell.  Run the card test with ``python3 -m pytest
-p no:cacheprovider -m cuda benchmarks/tests``."""
import pytest

from benchmarks.harness import compare, costs, gat_costs, manifest, runner
from benchmarks.harness.profile import Trace

CELL = "train-gat-g524k"
TINY = {"nodes": 2048}


def test_tiny_run_on_the_cpu():
    r = runner.run_cell(CELL, 2 ** 31 + 11, 2.0, False, "cpu",
                        traffic_override=TINY)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and r["attempted"] >= 1
    assert set(r["metrics"]) == {"train_edges_per_s", "peak_mem_gib",
                                 "setup_s"}


def test_faults_and_control_are_not_correct():
    c = manifest.cell(CELL)
    mod = manifest.load_module("drivers", c.traffic["driver"] + ".py")
    drv = mod.Driver(c.config, dict(c.traffic, **TINY), 777, "cpu")
    drv.setup()
    drv.release()
    ref = drv.reference()
    outs = dict(drv.faults(ref), tf32=drv.reference(tf32=True))
    assert set(outs) == {"state_unchanged", "half_batch", "no_self_loops",
                         "tf32"}
    for name, out in outs.items():
        correct, checks = compare.verdict(drv.gaps(out, ref), c.limits)
        assert not correct, (name, checks)


def _ctx(launches, seconds, units):
    c = manifest.cell(CELL)
    tr = Trace(window_s=1.0, busy_s=1.0, launches=launches,
               kernels={"gn::csr_row_sum<4, float>": [seconds, launches]})
    return runner.LayerContext(c.config, c.traffic, "train",
                               {"seconds": 1.0, "units": units}, units, tr)


def test_k2side_reader_counts_the_walks():
    read = manifest.load_module("metrics", "k2side_roofline.gat.py").read
    c = manifest.cell(CELL).config
    n, e = 1000, 4000
    ep = n + e
    walk = [gat_costs.k2_side_cost(n, ep, w, p) for w, p in
            [(3, False)] * 3 + [(192, False), (3, True), (192, True)]]
    least = 8 * sum(costs.bound_seconds(*w) for w in walk) \
        + costs.bound_seconds(*costs.k2_cost(n, e, 64))
    units = [(n, e)] * 2
    assert read(_ctx(2 * 50, 4 * least, units)) == pytest.approx(50.0)
    assert read(_ctx(2 * 50 + 1, 4 * least, units)) is None
    assert c["num_gnn_layers"] == 8 and c["heads"] * c["dim_latent"] == 192


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
def test_cell_on_the_card(card):
    from gnnome_tpu_torch.ops import kernels

    side = kernels.k2_side_sum.launches
    r = runner.run_cell(CELL, 4242, 1.0, True, card,
                        traffic_override={"nodes": 65536})
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    want = {m["name"] for m in manifest.cell(CELL).per_layer}
    assert set(r["metrics"]) == want
    assert 0 <= r["metrics"]["idle_share.train"]["value"] <= 100
    assert 0 < r["metrics"]["k2side_roofline.gat"]["value"] <= 100
    # 48 one-sided walks a step, in the checked steps, the window and the
    # traced segment
    assert (kernels.k2_side_sum.launches - side) % 48 == 0
