"""The yardstick's arithmetic against hand counts at tiny shapes: the
kernels' least bytes and operations, the matrix products of a step and a
request, the per-layer readers and the reduction of a trace."""
import pytest

from benchmarks.harness import costs, readers
from benchmarks.harness.profile import Trace, short_name, summarize
from benchmarks.harness.runner import LayerContext

TINY = {"dim_latent": 2, "hidden_ne_features": 1, "hidden_edge_scores": 1,
        "score_hidden_2": 1, "node_features": 1, "edge_features": 1,
        "num_gnn_layers": 1}


def test_bound_seconds():
    assert costs.bound_seconds(3.35e12, 0.0) == pytest.approx(1.0)
    assert costs.bound_seconds(0.0, 67e12) == pytest.approx(1.0)
    assert costs.bound_seconds(0.0, 67e12, 34e12) == pytest.approx(2.0)
    assert costs.bound_seconds(6.7e12, 67e12) == pytest.approx(2.0)


@pytest.mark.parametrize("fn,want", [
    # N=2, E=3, width 1; bytes by hand from each docstring's list
    (costs.k3_cost, (4 * (8 + 9 + 4 + 8) + 4 * (9 + 6), 60.0, 0.0)),
    (costs.k8_cost, (4 * (16 + 9 + 4 + 6 + 12) + 16 + 4 * (9 + 6),
                     147.0, 9.0)),
    (costs.k1_cost, (4 * (8 + 3 + 9) + 4 * 6, 6.0, 0.0)),
    (costs.k2_cost, (4 * 6 + 4 * 4 + 4 * (3 + 6), 6.0, 0.0)),
])
def test_kernel_costs_by_hand(fn, want):
    assert fn(2, 3, 1) == want


def test_matmul_flops_by_hand():
    # one node, one edge, d=2, every other width 1, one layer: encoders'
    # first layers 2 + 2, second layers 4 + 4, the layer 5 * 8 + 8, the
    # predictor 2 * 4 + 4 + 2 + 2
    assert costs.request_flops(TINY, 1, 1) == 4 + 8 + 48 + 16
    # two passes: first layers 2 * 2 + 2 (the edge encoder runs once),
    # the rest 2 * 4 + 4 + 2 * 48 + 2 * 16; backward twice the forward
    # but once for the first layers
    assert costs.step_flops(TINY, 1, 1) == 3 * 6 + 3 * 140 - 6


def test_step_flops_at_the_cell_size():
    cfg = dict(TINY, dim_latent=64, hidden_ne_features=16,
               hidden_edge_scores=64, score_hidden_2=32, node_features=2,
               edge_features=2, num_gnn_layers=8)
    assert 2.0e12 < costs.step_flops(cfg, 524288, 2411218) < 2.5e12


def _ctx(kernels, units, window_s=2.0, busy_s=1.5, win_units=None,
         win_seconds=1.0):
    tr = Trace(window_s=window_s, busy_s=busy_s, kernels=kernels,
               launches=sum(v[1] for v in kernels.values()))
    win = {"seconds": win_seconds, "units": win_units or units}
    return LayerContext(dict(TINY, dim_latent=64), {}, "train", win, units,
                        tr)


def test_roofline_reader():
    n, e = 1000, 5000
    ctx = _ctx({"k3_pass_v<float, 4>": [1e-3, 8],
                "k3_pass_u<float, 4>": [1e-3, 8],
                "k8_pass_v<float>": [5.0, 8]}, [(n, e)] * 2)
    least = 2 * 8 * costs.bound_seconds(*costs.k3_cost(n, e, 128))
    got = readers.roofline(ctx, r"\bk3_pass_[uv]\b", lambda nn, ee:
                           readers.calls(8, costs.k3_cost(nn, ee, 128)))
    assert got == pytest.approx(100.0 * least / 2e-3)
    assert readers.roofline(ctx, r"\bk9_", lambda nn, ee: 1.0) is None


def test_idle_launches_mfu_readers():
    ctx = _ctx({"a": [1.0, 30], "b": [0.5, 10]}, [(1, 1)] * 4,
               win_units=[(1, 1)] * 10, win_seconds=2.0)
    assert readers.idle_share(ctx) == pytest.approx(25.0)
    assert readers.launches_per_unit(ctx) == 10.0
    assert readers.mfu(ctx, costs.request_flops) == pytest.approx(
        100.0 * 10 * costs.request_flops(ctx.config, 1, 1) / 2.0 / 67e12)
    blind = _ctx({}, [(1, 1)], busy_s=0.0)
    assert readers.idle_share(blind) is None and readers.mfu(
        blind, costs.request_flops) is None


def test_summarize():
    dev = [("void (anonymous namespace)::a<float>(int)", 0.0, 1.0),
           ("b", 0.5, 2.0), ("void (anonymous namespace)::a<float>(int)",
                             3.0, 4.0)]
    host = [("aten::x", 2.0, 3.5, 0), ("aten::y", 2.1, 2.9, 1),
            ("cudaLaunchKernel", 1.9, 2.2, 2)]
    tr = summarize(dev, host, 0.0, 5.0)
    assert tr.busy_s == pytest.approx(3.0) and tr.window_s == 5.0
    assert tr.kernels == {"a<float>": [2.0, 2], "b": [1.5, 1]}
    assert tr.launches == 3
    assert tr.device_ops == [["a<float>", 2.0], ["b", 1.5]]
    assert tr.idle_gaps == [["aten::x", 1.0], ["host idle", 1.0]]
    assert tr.kernel_seconds(r"^a<") == (2.0, 2)


def test_short_name():
    assert short_name("void gn::(anonymous namespace)::csr_row_sum<4, "
                      "float>(int, int, int const*)") == \
        "gn::csr_row_sum<4, float>"
    assert short_name("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH"
