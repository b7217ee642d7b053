"""The CUDA kernels K1, K2 (and its one-sided walk), K3, K6, K7, K8, K9,
the batch-norm edge adjoint and the layer-norm edge stage and its adjoint
against their plain PyTorch versions, on the card; every wrapper at E = 0;
two card train steps from one state bitwise equal, with no host
synchronisation inside a step (batch norm, layer norm, none, the zoo); and
the card probes.  The model, CLI and recorded-run paths on the card are in
``tests/test_torch_cuda_paths.py``, the ranks sharing the card in
``tests/test_torch_cuda_parallel.py``.  Every test here is ``cuda``-marked
and skips where no GPU is present.

These files import neither JAX nor the JAX package, so they run on a
machine without them; skip the JAX-importing conftest there:

    python3 -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda*.py

Graphs: a synthetic assembly graph; a hub graph with an isolated node and
a node of more than 64 in- and out-edges (its slot list crosses the
32-slot index chunks twice); a graph of fewer edges than one index chunk;
the golden E. coli-scale graph (tests/fixtures/golden_ecoli_v1.npz, N =
9,600, E = 257,346, its real CSR) and, for K9, the same graph with its node
ids relabelled by a seeded permutation (the same degrees, no id locality).
K3, K6 and K8 run at d = 16, 20 (five float4 lanes of a team of 8), 64,
128 (the dual symmetry pass) and 192 (two column chunks); K6 also on
column slices of wider arrays, with row strides that keep the float4 path
and with odd ones that take the one-float path; K7 up to d = 256, and on
both of its paths bitwise equal; K1 up to d = 192 on column slices and odd
row strides; K2 up to width 256, dense, on column slices and odd row
strides; K9 at H = 16, 20, 64, 128 and 256, dense, on column slices and on
odd row strides; the one-sided K2 walk at D = 3, 16, 64 and 192 into each
side, dense and on column slices.  The golden graph runs at the widths its
paths run (``on_graphs``).  Each case of the edge kernels checks both edge
orientations (``graph.roles(flip)``, flip False and True) in turn.

Tolerances: e_out and z repeat the plain version's per-op rounding (only
sigmoid's exp may differ by an ulp): ``atol=1e-5`` and exact; node sums add
~30 terms in another order (the plain version scatters with atomics):
``rtol=1e-5, atol=1e-4``.  K7 / K8's float64 global sums: ``rtol=1e-9``
relative to the sum of magnitudes (the order differs); K8's per-edge x is
exact, d_eo ``atol=1e-5`` (sigmoid); K2's and K9's sums exact against the
plain version on CPU copies, where ``index_add_`` adds each node's terms in
slot order as the kernel does, and within the node-sum tolerance of the
plain version on the card; so are the one-sided walk's (exact); K1 repeats
the plain version's adds: exact.  The bf16 instantiations of K1, K2, K3,
K6, K7, K8 and K9 after them state their own, and so do the probes'
kernels (``gnnome_tpu_torch/probes``: the K3 variants, ``stream_sum`` and
the Mosaic repro probe's four kernels) at the end.
"""
import numpy as np
import pytest
import torch

from gnnome_tpu_torch.graphs import synthetic_assembly_graph
from gnnome_tpu_torch.graphs.container import AssemblyGraph
from gnnome_tpu_torch.ops import DeviceGraph
from gnnome_tpu_torch.ops import kernels as K
from gnnome_tpu_torch.probes.dma_probe import GRID_SWEEP, K_SWEEP
from torch_recipes import cuda  # noqa: F401  (the fixture)
from torch_recipes import (GOLDEN, NO_EDGE_CASES, TRAIN_STEP_LAUNCHES,
                           UNFUSED_STEP_ALL_BF16, UNFUSED_STEP_BF16,
                           UNFUSED_STEP_LAUNCHES, ZOO_STEP_SIDE_SUMS,
                           check_no_edge_call, expected_launches, times)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def graph(cuda):
    g, _, _, _ = synthetic_assembly_graph(n_reads=300, genome_len=20000,
                                          read_len=400, seed=70,
                                          with_sequences=False,
                                          false_edge_frac=0.15)
    return DeviceGraph.from_graph(g, cuda)


def hub_graph(device):
    """400 nodes, ~4,000 random edges; node 0 has none, node 7 has 90 in-
    and 80 out-edges."""
    rng = np.random.default_rng(21)
    n = 400
    src = rng.integers(1, n, 4000)
    dst = rng.integers(1, n, 4000)
    src = np.concatenate([src, rng.integers(1, n, 90), np.full(80, 7)])
    dst = np.concatenate([dst, np.full(90, 7), rng.integers(1, n, 80)])
    g = DeviceGraph.build(src, dst, n, device)
    deg_in = (g.dst_ptr[1:] - g.dst_ptr[:-1]).cpu()
    deg_out = (g.src_ptr[1:] - g.src_ptr[:-1]).cpu()
    assert deg_in[0] == deg_out[0] == 0
    assert deg_in[7] > 64 and deg_out[7] > 64
    return g


def tiny_graph(device):
    """6 nodes, 5 edges: fewer than one chunk of slot indices (8, 16 or 32)
    for every team, so most teams and blocks of K6 and K7 get no slot."""
    return DeviceGraph.build([0, 1, 2, 4, 5], [1, 2, 3, 1, 0], 6, device)


def relabelled(g, device, seed: int = 0):
    """``g``'s ``DeviceGraph`` with its node ids relabelled by a seeded
    random permutation: the same degrees, no id locality."""
    perm = np.random.default_rng(seed).permutation(g.num_nodes)
    return DeviceGraph.build(perm[np.asarray(g.src)], perm[np.asarray(g.dst)],
                             g.num_nodes, device)


@pytest.fixture(scope="module")
def graphs(graph, cuda):
    golden = AssemblyGraph.load(GOLDEN)
    return {"assembly": graph, "hub": hub_graph(cuda),
            "tiny": tiny_graph(cuda),
            "golden": DeviceGraph.from_graph(golden, cuda),
            "relabelled": relabelled(golden, cuda)}


WIDTHS = [16, 20, 64, 128, 192]
SMALL = ["assembly", "hub", "tiny"]


def on_graphs(small, widths, golden, relabelled=False):
    """``(graph, width)`` cases: every width of ``widths`` on the small
    graphs ``small``; on the golden graph only those of ``golden``, the
    widths its paths run (d = 64, the dual pass's 128) and the wide ones
    (192: two column chunks; 256 for the sums), and with ``relabelled``
    d = 64 on its relabelled copy.  Odd widths and row strides run on the
    small graphs, and on the golden graph through the odd-stride layouts
    and pads at these widths."""
    return ([(w, d) for w in small for d in widths]
            + [("golden", d) for d in golden]
            + ([("relabelled", 64)] if relabelled else []))


CASES = on_graphs(["assembly", "hub"], WIDTHS, (64, 128, 192))
K1_CASES = on_graphs(["assembly"], [6, 16, 20, 64, 192], (64, 192))
K2_CASES = on_graphs(["assembly"], [16, 21, 64, 128, 256], (64, 128, 256))
K2_BF16_CASES = on_graphs(SMALL, [3, 16, 21, 64, 128, 256], (64, 128, 256))
K7_CASES = on_graphs(SMALL, [16, 20, 64, 128, 192, 256], (64, 128, 192))
K7_BF16_CASES = on_graphs(SMALL, [16, 20, 64, 128, 192], (64, 128, 192))
K9_CASES = on_graphs(SMALL, [16, 20, 64, 128, 256], (64, 128, 256),
                     relabelled=True)
K9_BF16_CASES = on_graphs(SMALL, [16, 20, 64, 128, 256], (64, 128, 256))


@pytest.mark.parametrize("which,d", CASES)
def test_k3_kernel_vs_plain(graphs, cuda, d, which):
    for flip in (False, True):
        graph = graphs[which]
        gen = torch.Generator(device=cuda).manual_seed(5)
        N, E = graph.n_nodes, graph.n_edges
        proj = torch.randn(N, 5 * d, device=cuda, generator=gen)
        proj_u, proj_v = proj[:, :2 * d], proj[:, 2 * d:4 * d]   # strided rows
        b3e = torch.randn(E, d, device=cuda, generator=gen)
        e_in = torch.randn(E, d, device=cuda, generator=gen)
        bn = torch.stack([torch.randn(d, device=cuda, generator=gen) * 0.3,
                          torch.rand(d, device=cuda, generator=gen) + 0.5,
                          torch.rand(d, device=cuda, generator=gen) + 0.5,
                          torch.randn(d, device=cuda, generator=gen) * 0.1])
        u, v, v_csr, u_csr = graph.roles(flip)
        n0 = K.k3_edge_stage.launches
        k3 = (u, v, v_csr, u_csr, proj_u, proj_v, b3e, e_in, bn)
        got = K.k3_edge_stage(*k3)
        assert K.k3_edge_stage.launches == n0 + 1
        ref = K.k3_edge_stage_plain(u, v, proj_u, proj_v, b3e, e_in, bn)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-5)
        for x, y in zip(got[1:], ref[1:]):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-4)
        again = K.k3_edge_stage(*k3)
        assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


# row padding of puv / be: none (dense), 8 floats (column slices whose row
# strides keep the float4 path), 1 float (odd strides: the one-float path)
K6_LAYOUTS = {"dense": 0, "strided": 8, "unaligned": 1}


@pytest.mark.parametrize("layout", list(K6_LAYOUTS))
@pytest.mark.parametrize("which,h", CASES)
def test_k6_kernel_vs_plain(graphs, cuda, h, which, layout):
    for flip in (False, True):
        graph = graphs[which]
        gen = torch.Generator(device=cuda).manual_seed(6)
        pad = K6_LAYOUTS[layout]
        puv = torch.randn(graph.n_nodes, 2 * h + pad, device=cuda,
                          generator=gen)[:, :2 * h]
        be = torch.randn(graph.n_edges, h + pad, device=cuda,
                         generator=gen)[:, :h]
        assert puv.is_contiguous() == be.is_contiguous() == (pad == 0)
        u, v, _, _ = graph.roles(flip)
        n0 = K.k6_score_gate.launches
        got = K.k6_score_gate(u, v, puv, be)
        assert K.k6_score_gate.launches == n0 + 1
        torch.cuda.synchronize()
        assert got.shape == (graph.n_edges, h) and got.is_contiguous()
        torch.testing.assert_close(got, K.k6_score_gate_plain(u, v, puv, be),
                                   rtol=0, atol=0)
        assert torch.equal(got, K.k6_score_gate(u, v, puv, be))


def test_wrapper_rejects_bad_inputs(graph, cuda):
    u, v, _, _ = graph.roles(False)
    puv = torch.zeros(graph.n_nodes, 128, device=cuda)
    with pytest.raises(TypeError):
        K.k6_score_gate(u, v, puv, torch.zeros(graph.n_edges, 64,
                                               device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        K.k6_score_gate(u, v, puv, torch.zeros(graph.n_edges + 1, 64,
                                               device=cuda))
    with pytest.raises(ValueError):         # rows must be dense in features
        K.k6_score_gate(u, v, puv, torch.zeros(64, graph.n_edges,
                                               device=cuda).t())
    # a row-strided be (a column slice) is taken
    be = torch.ones(graph.n_edges, 72, device=cuda)[:, :64]
    assert torch.equal(K.k6_score_gate(u, v, puv, be),
                       torch.ones(graph.n_edges, 64, device=cuda))


@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("which,d", K1_CASES)
def test_k1_kernel_vs_plain(graphs, cuda, d, pad, which):
    """d=16/20/64/192 take the float4 path on strided column slices; d=6,
    and any odd row stride (``pad`` 1), the per-feature path."""
    for flip in (False, True):
        graph = graphs[which]
        gen = torch.Generator(device=cuda).manual_seed(10)
        proj = torch.randn(graph.n_nodes, 5 * d + pad, device=cuda,
                           generator=gen)
        proj_u, proj_v = proj[:, :2 * d], proj[:, 2 * d:4 * d]   # strided rows
        b3e = torch.randn(graph.n_edges, d, device=cuda, generator=gen)
        u, v, _, _ = graph.roles(flip)
        n0 = K.k1_gather_gate.launches
        got = K.k1_gather_gate(u, v, proj_u, proj_v, b3e)
        assert K.k1_gather_gate.launches == n0 + 1
        ref = K.k1_gather_gate_plain(u, v, proj_u, proj_v, b3e)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
        assert torch.equal(got, K.k1_gather_gate(u, v, proj_u, proj_v, b3e))


# row padding of K2's u-side payload: 8 (a column slice, as the backward of
# K1 passes it), 0 (dense) and 1 (an odd row stride)
K2_PADS = [8, 0, 1]


@pytest.mark.parametrize("pad", K2_PADS)
@pytest.mark.parametrize("which,width", K2_CASES)
def test_k2_kernel_vs_plain(graphs, cuda, width, pad, which):
    """The u-side payload padded by ``pad`` columns, the v side dense;
    exact against the plain version on CPU copies."""
    for flip in (False, True):
        graph = graphs[which]
        gen = torch.Generator(device=cuda).manual_seed(11)
        wide = torch.randn(graph.n_edges, width + pad, device=cuda,
                           generator=gen)
        pay_u = wide[:, :width]
        pay_v = torch.randn(graph.n_edges, width, device=cuda, generator=gen)
        u, v, v_csr, u_csr = graph.roles(flip)
        n0 = K.k2_aggregate.launches
        got = K.k2_aggregate(u, v, v_csr, u_csr, pay_u, pay_v)
        assert K.k2_aggregate.launches == n0 + 1
        ref = K.k2_aggregate_plain(u, v, pay_u, pay_v, graph.n_nodes)
        torch.cuda.synchronize()
        for x, y in zip(got, ref):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-4)
        cpu = K.k2_aggregate_plain(u.cpu(), v.cpu(), pay_u.cpu(), pay_v.cpu(),
                                   graph.n_nodes)
        for x, y in zip(got, cpu):
            torch.testing.assert_close(x.cpu(), y, rtol=0, atol=0)
        again = K.k2_aggregate(u, v, v_csr, u_csr, pay_u, pay_v)
        assert all(torch.equal(p, q) for p, q in zip(got, again))


def _train_inputs(graph, cuda, d, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    N, E = graph.n_nodes, graph.n_edges

    def randn(*shape):
        return torch.randn(*shape, device=cuda, generator=gen)

    proj = randn(N, 4 * d)                    # [B1|A2|B2|A3], as the model
    bn = torch.stack([randn(d) * 0.3,
                      torch.rand(d, device=cuda, generator=gen) + 0.5,
                      torch.rand(d, device=cuda, generator=gen) + 0.5,
                      randn(d) * 0.1])
    return dict(proj_u=proj[:, :2 * d], proj_v=proj[:, 2 * d:],
                b3e=randn(E, d), e_in=randn(E, d), d_e_out=randn(E, d),
                d_sum_u=randn(N, 2 * d), d_sum_v=randn(N, 2 * d), bn=bn)


def _close64(got, ref, terms):
    """float64 sums in another order: within 1e-9 of the summed |terms|."""
    assert bool(((got - ref).abs() <= 1e-9 * terms + 1e-12).all())


@pytest.mark.parametrize("which,d", K7_CASES)
def test_k7_kernel_vs_plain(graphs, cuda, d, which):
    for flip in (False, True):
        graph = graphs[which]
        a = _train_inputs(graph, cuda, d, seed=7)
        u, v, _, _ = graph.roles(flip)
        bu, bv = a["proj_u"][:, :d], a["proj_v"][:, :d]    # strided halves
        n0 = K.k7_gate_stats.launches
        got = K.k7_gate_stats(u, v, bu, bv, a["b3e"])
        assert K.k7_gate_stats.launches == n0 + 1
        ref = K.k7_gate_stats_plain(u, v, bu, bv, a["b3e"])
        x = (bu[u.long()] + bv[v.long()] + a["b3e"]).double()
        _close64(got, ref, torch.cat([x.abs().sum(0), (x * x).sum(0)]))
        assert torch.equal(got, K.k7_gate_stats(u, v, bu, bv, a["b3e"]))


@pytest.mark.parametrize("d", [20, 64, 192])
def test_k7_paths_bitwise_equal(graph, cuda, d):
    """The order of K7's float64 adds is set by E and d alone: gate halves
    with odd row strides (the one-float path) give the float4 path's sums
    bit for bit."""
    a = _train_inputs(graph, cuda, d, seed=17)
    u, v, _, _ = graph.roles(False)
    bu, bv = a["proj_u"][:, :d], a["proj_v"][:, :d]
    odd = torch.empty(graph.n_nodes, 2 * d + 1, device=cuda)
    odd[:, :d], odd[:, d + 1:] = bu, bv
    bu1, bv1 = odd[:, :d], odd[:, d + 1:]
    assert bu1.stride(0) % 4 and torch.equal(bu1, bu) and torch.equal(bv1, bv)
    assert torch.equal(K.k7_gate_stats(u, v, bu, bv, a["b3e"]),
                       K.k7_gate_stats(u, v, bu1, bv1, a["b3e"]))


@pytest.mark.parametrize("which,d", CASES)
def test_k8_kernel_vs_plain(graphs, cuda, d, which):
    for flip in (False, True):
        graph = graphs[which]
        a = _train_inputs(graph, cuda, d, seed=8)
        u, v, v_csr, u_csr = graph.roles(flip)
        args = (a["d_sum_u"], a["d_sum_v"], a["proj_u"], a["proj_v"], a["b3e"],
                a["e_in"], a["d_e_out"], a["bn"])
        n0 = K.k8_train_layer_bwd.launches
        got = K.k8_train_layer_bwd(u, v, v_csr, u_csr, *args)
        assert K.k8_train_layer_bwd.launches == n0 + 1
        ref = K.k8_train_layer_bwd_plain(u, v, *args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)      # x
        torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)   # d_eo
        for x, y in zip(got[2:4], ref[2:4]):                        # node sums
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-4)
        deo = ref[1].double().abs()                 # bounds |d_y| term by term
        _close64(got[4], ref[4], torch.cat([
            deo.sum(0), (deo * ref[0].double().abs()).sum(0)]))
        again = K.k8_train_layer_bwd(u, v, v_csr, u_csr, *args)
        assert all(torch.equal(p, q) for p, q in zip(got, again))  # no atomics


@pytest.mark.parametrize("layout", list(K6_LAYOUTS))
@pytest.mark.parametrize("which,h", K9_CASES)
def test_k9_kernel_vs_plain(graphs, cuda, h, which, layout):
    """One launch writes [sum_u | sum_v], bit-equal to the plain version on
    CPU copies (index_add_ adds in slot order there, as the kernel does)
    and within the node-sum tolerance of it on the card; dense payloads,
    column slices whose row strides keep the float4 path, and odd row
    strides (the one-float path)."""
    for flip in (False, True):
        graph = graphs[which]
        gen = torch.Generator(device=cuda).manual_seed(9)
        pad = K6_LAYOUTS[layout]
        pay = torch.randn(graph.n_edges, h + pad, device=cuda,
                          generator=gen)[:, :h]
        assert pay.is_contiguous() == (pad == 0)
        u, v, v_csr, u_csr = graph.roles(flip)
        n0 = K.k9_aggregate.launches
        got = K.k9_aggregate(u, v, v_csr, u_csr, pay)
        assert K.k9_aggregate.launches == n0 + 1
        torch.cuda.synchronize()
        assert got.shape == (graph.n_nodes, 2 * h) and got.is_contiguous()
        ref = K.k9_aggregate_plain(u.cpu(), v.cpu(), pay.cpu(), graph.n_nodes)
        torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=0)
        torch.testing.assert_close(
            got, K.k9_aggregate_plain(u, v, pay, graph.n_nodes), rtol=1e-5,
            atol=1e-4)
        assert torch.equal(got, K.k9_aggregate(u, v, v_csr, u_csr, pay))


def _two_card_steps(cuda, cfg):
    """Two train steps of ``cfg.model`` (``init_weights(3)``) from one
    state (weights, data, dropout seed) on a synthetic graph: the same
    loss, logits, gradients and parameters after Adam, bit for bit; then a
    third step in ``torch.cuda.set_sync_debug_mode("error")``, where an
    operation that would wait for the device raises: a step never does.
    Returns the two steps' launches, all and bf16, and the first step's
    loss, logits, gradients and parameters."""
    from gnnome_tpu_torch.models import get_model
    from gnnome_tpu_torch.train.step import (host_units, make_example,
                                             make_optimizer, train_step)

    g, _, _, _ = synthetic_assembly_graph(n_reads=300, genome_len=25000,
                                          read_len=400, seed=13)
    cfg.train.masking = False
    cfg.train.num_nodes_per_cluster = 10_000
    (unit,) = host_units(g, cfg, np.random.default_rng(0))
    ex = make_example(unit.in_deg, unit.out_deg, unit.e_feat, unit.y,
                      unit.src, unit.dst, unit.n_nodes, cuda, cfg.model)
    K.reset_launch_counts()
    outs = []
    for _ in range(2):
        model = get_model(cfg.model).init_weights(3).to(cuda)
        opt = make_optimizer(model, 1e-3)
        gen = torch.Generator(device=cuda).manual_seed(5)
        loss, logits = train_step(model, opt, ex, 2.0, cfg, gen)
        outs.append((loss, logits, [p.grad.clone() for p in
                                    model.parameters()],
                     [p.detach().clone() for p in model.parameters()]))
    counts = K.launch_counts(), K.launch_counts(torch.bfloat16)
    (l0, lo0, g0, p0), (l1, lo1, g1, p1) = outs
    assert torch.isfinite(lo0).all()
    assert torch.equal(l0, l1) and torch.equal(lo0, lo1)
    assert all(torch.equal(a, b) for a, b in zip(g0 + p0, g1 + p1))
    torch.cuda.set_sync_debug_mode("error")
    try:
        train_step(model, opt, ex, 2.0, cfg, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return counts, outs[0]


@pytest.mark.parametrize("norm,launches", [
    ("batch", TRAIN_STEP_LAUNCHES), ("layer", UNFUSED_STEP_LAUNCHES),
    ("none", UNFUSED_STEP_LAUNCHES)])
def test_two_card_train_steps_bitwise_equal(cuda, norm, launches):
    """Two train steps from one state give the same loss, logits, gradients
    and parameters after Adam, bit for bit, launch only the kernels of the
    model's path (two 8-layer steps; batch norm runs both symmetry passes
    as one dual-width pass; layer norm and none run the edge stage and its
    adjoint once a layer and pass), and never wait for the device."""
    from gnnome_tpu_torch.config import Config

    cfg = Config()
    cfg.model.normalization = norm
    (counts, _), _ = _two_card_steps(cuda, cfg)
    assert counts == expected_launches(**times(launches, 2))


# The layer-norm edge stage and its adjoint (float32 only), with LayerNorm
# and norm-free: on the assembly graph at d = 6 (one feature a lane), 16 (4
# lanes of float4 a row), 64 (16 lanes), 96 (24 of a team of 32) and 200
# (two vectors a lane), on the hub graph at 16 and 64, on the golden graph
# at 6, 64 and 200, and at the layer-norm cell's size (1.21M edge rows over
# 262,144 nodes, random endpoints) at 64.  Tolerances: the forward's row
# mean and variance add in another order than torch.mean, so e_out, the
# payloads and [mean, rstd] are within rtol=1e-5, atol=1e-5 of the plain
# version (float32 rounding of the normalised values; a relu mask that flips
# does so where y is within rounding of 0, so e_out moves by no more).  The
# adjoint, fed the same g3, e_out and statistics as its plain version (so
# its recomputed relu mask is the same, bit for bit), is within rtol=1e-4,
# atol=1e-5 of it (its two row sums in another order), d_weight and d_bias
# within 1e-5 of the summed magnitudes of their float32 terms of the sums
# taken in float64 (the kernel adds them in float64 blocks, the plain
# version in float32).
LN_CASES = ([("assembly", d) for d in (6, 16, 64, 96, 200)]
            + [("hub", 16), ("hub", 64), ("cell", 64)]
            + [("golden", d) for d in (6, 64, 200)])
LN_CELL_EDGES, LN_CELL_NODES = 1_210_000, 262_144


def _ln_inputs(graphs, cuda, which, d, norm, flip):
    gen = torch.Generator(device=cuda).manual_seed(40 + d)
    if which == "cell":
        n, E = LN_CELL_NODES, LN_CELL_EDGES
        u, v = (torch.randint(0, n, (E,), device=cuda, generator=gen,
                              dtype=torch.int32) for _ in range(2))
    else:
        g = graphs[which]
        n, E = g.n_nodes, g.n_edges
        u, v, _, _ = g.roles(flip)

    def randn(*shape):
        return torch.randn(*shape, device=cuda, generator=gen)

    w = torch.rand(d, device=cuda, generator=gen) + 0.5 if norm else None
    b = randn(d) * 0.1 if norm else None
    return dict(u=u, v=v, g3=randn(E, 3 * d), e_in=randn(E, d), w=w, b=b,
                d_e_out=randn(E, d), d_sum_u=randn(n, 2 * d),
                d_sum_v=randn(n, 2 * d))


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("which,d", LN_CASES)
def test_ln_edge_stage_kernels_vs_plain(graphs, cuda, which, d, norm):
    t = _ln_inputs(graphs, cuda, which, d, norm, flip=which == "hub")
    fwd = (t["g3"], t["e_in"], t["w"], t["b"], 1e-5)
    n0, a0 = K.ln_edge_stage.launches, K.ln_edge_adjoint.launches
    got = K.ln_edge_stage(*fwd)
    assert K.ln_edge_stage.launches == n0 + 1
    ref = K.ln_edge_stage_plain(*fwd)
    torch.cuda.synchronize()
    assert (got[3] is None) == (not norm)
    for x, y in zip(got, ref):
        if y is not None:
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
    e_out, _, _, stats = got
    adj = (t["u"], t["v"], t["d_sum_u"], t["d_sum_v"], t["g3"], e_out,
           t["d_e_out"], stats, t["w"], t["b"])
    got_a = K.ln_edge_adjoint(*adj)
    assert K.ln_edge_adjoint.launches == a0 + 1
    ref_a = K.ln_edge_adjoint_plain(*adj)
    torch.cuda.synchronize()
    for x, y in zip(got_a[:3], ref_a[:3]):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5)
    if norm:
        x, mean, rstd = t["g3"][:, :d], stats[:, :1], stats[:, 1:]
        xhat = (x - mean) * rstd
        d_y = torch.where(xhat * t["w"] + t["b"] > 0, ref_a[2], 0.0)
        prods = torch.stack([d_y * xhat, d_y]).double()
        want, terms = prods.sum(1), prods.abs().sum(1)
        assert bool(((got_a[3].double() - want).abs()
                     <= 1e-5 * terms + 1e-6).all())
    else:
        assert got_a[3] is None
    again = K.ln_edge_stage(*fwd), K.ln_edge_adjoint(*adj)
    for x, y in zip((*got, *got_a), (*again[0], *again[1])):
        assert (x is None and y is None) or torch.equal(x, y)


# (width, column padding) of the one-sided walk's payload; on the golden
# graph the zoo's widths 64 and 192 (dense and a column slice) and GAT's 3
SIDE_SUM_LAYOUTS = [(3, 0), (16, 0), (64, 0), (64, 5), (192, 0), (192, 8),
                    (192, 5)]
SIDE_SUM_CASES = ([(w, d, p) for w in SMALL for d, p in SIDE_SUM_LAYOUTS]
                  + [("golden", d, p) for d, p in SIDE_SUM_LAYOUTS
                     if d != 16 and p in (0, 5)])


@pytest.mark.parametrize("which,width,pad", SIDE_SUM_CASES)
@pytest.mark.parametrize("side", ["dst", "src"])
def test_k2_side_sum_kernel_vs_cpu_plain(graphs, cuda, side, width, pad,
                                         which):
    """Exact against its plain version on CPU copies, one launch counted,
    bitwise reproducible; ``pad`` > 0 reads a column slice."""
    graph = graphs[which]
    gen = torch.Generator(device=cuda).manual_seed(9)
    pay = torch.randn(graph.n_edges, width + pad, device=cuda,
                      generator=gen)[:, :width]
    _, _, by_dst, by_src = graph.roles(False)
    idx, csr = (graph.dst, by_dst) if side == "dst" else (graph.src, by_src)
    n0 = K.k2_side_sum.launches
    got = K.k2_side_sum(idx, csr, pay)
    assert K.k2_side_sum.launches == n0 + 1
    torch.cuda.synchronize()
    ref = K.k2_side_sum_plain(idx.cpu(), pay.cpu(), graph.n_nodes)
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=0)
    assert torch.equal(got, K.k2_side_sum(idx, csr, pay))


@pytest.mark.parametrize("name,directed", [
    ("gatedgcn", False), ("gat", True), ("gatedgcn", True), ("gcn", True),
    ("sage", True)])
def test_two_card_zoo_train_steps_bitwise_equal(cuda, name, directed):
    """Two zoo train steps (plain BCE, dropout 0.2) from one state, bit for
    bit, launching only the one-sided walk and the predictor's K2, and
    never waiting for the device."""
    from gnnome_tpu_torch.config import Config

    cfg = Config()
    cfg.model.model = name
    cfg.model.directed = directed
    (counts, _), _ = _two_card_steps(cuda, cfg)
    assert counts == expected_launches(
        k2_side_sum=2 * ZOO_STEP_SIDE_SUMS[name], k2_aggregate=2)


# ------------------------------------------------------------------- bf16
# The bfloat16 instantiations of K3, K6, K7, K8 and K9 (compute.dtype=
# bfloat16) against their plain versions in bf16, which round at the same
# points.  Edge outputs (e_out, z, x, d_eo) are the same operations rounded
# the same way: exact.  bf16 node sums are float32 sums in another order
# (the plain version scatters with atomics), rounded once: within the
# float32 sums' tolerance plus one bf16 spacing (2^-7 of the value).  K7's
# and K8's float64 sums and K9's float32 sums as in float32.
BF16_SUM_TOL = dict(rtol=2.0 ** -7 + 1e-5, atol=1e-4)


def _bf16(t):
    return t.to(torch.bfloat16)


def _affine_rows(d, cuda, gen):
    """The folded BN affine the bf16 path takes: [0, 1, scale, bias]."""
    return _bf16(torch.stack([torch.zeros(d, device=cuda),
                              torch.ones(d, device=cuda),
                              torch.rand(d, device=cuda, generator=gen) + 0.5,
                              torch.randn(d, device=cuda, generator=gen)
                              * 0.1]))


@pytest.mark.parametrize("which,d", CASES)
def test_k3_bf16_kernel_vs_plain(graphs, cuda, d, which):
    for flip in (False, True):
        graph = graphs[which]
        gen = torch.Generator(device=cuda).manual_seed(25)
        N, E = graph.n_nodes, graph.n_edges
        proj = _bf16(torch.randn(N, 5 * d, device=cuda, generator=gen))
        proj_u, proj_v = proj[:, :2 * d], proj[:, 2 * d:4 * d]   # strided rows
        b3e = _bf16(torch.randn(E, d, device=cuda, generator=gen))
        e_in = _bf16(torch.randn(E, d, device=cuda, generator=gen))
        bn = _affine_rows(d, cuda, gen)
        u, v, v_csr, u_csr = graph.roles(flip)
        n0 = K.k3_edge_stage.launches
        k3 = (u, v, v_csr, u_csr, proj_u, proj_v, b3e, e_in, bn)
        got = K.k3_edge_stage(*k3)
        assert K.k3_edge_stage.launches == n0 + 1
        ref = K.k3_edge_stage_plain(u, v, proj_u, proj_v, b3e, e_in, bn)
        torch.cuda.synchronize()
        assert all(t.dtype == torch.bfloat16 for t in got)
        torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)
        for x, y in zip(got[1:], ref[1:]):
            torch.testing.assert_close(x.float(), y.float(), **BF16_SUM_TOL)
        again = K.k3_edge_stage(*k3)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("layout", list(K6_LAYOUTS))
@pytest.mark.parametrize("which,h", CASES)
def test_k6_bf16_kernel_vs_plain(graphs, cuda, h, which, layout):
    """Dense rows, column slices whose row strides keep the 8-byte vector
    path, and odd strides (one element per lane): bit-equal."""
    for flip in (False, True):
        graph = graphs[which]
        gen = torch.Generator(device=cuda).manual_seed(26)
        pad = K6_LAYOUTS[layout]
        puv = _bf16(torch.randn(graph.n_nodes, 2 * h + pad, device=cuda,
                                generator=gen))[:, :2 * h]
        be = _bf16(torch.randn(graph.n_edges, h + pad, device=cuda,
                               generator=gen))[:, :h]
        u, v, _, _ = graph.roles(flip)
        got = K.k6_score_gate(u, v, puv, be)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        torch.testing.assert_close(got, K.k6_score_gate_plain(u, v, puv, be),
                                   rtol=0, atol=0)
        assert torch.equal(got, K.k6_score_gate(u, v, puv, be))


def _bf16_train_inputs(graph, cuda, d, seed):
    a = _train_inputs(graph, cuda, d, seed)
    out = {k: _bf16(t) for k, t in a.items() if k != "bn"}
    out["bn"] = _affine_rows(d, cuda, torch.Generator(
        device=cuda).manual_seed(seed))
    return out


@pytest.mark.parametrize("which,d", K7_BF16_CASES)
def test_k7_bf16_kernel_vs_plain(graphs, cuda, d, which):
    for flip in (False, True):
        graph = graphs[which]
        a = _bf16_train_inputs(graph, cuda, d, seed=27)
        u, v, _, _ = graph.roles(flip)
        bu, bv = a["proj_u"][:, :d], a["proj_v"][:, :d]    # strided halves
        got = K.k7_gate_stats(u, v, bu, bv, a["b3e"])
        ref = K.k7_gate_stats_plain(u, v, bu, bv, a["b3e"])
        x = ((bu[u.long()] + bv[v.long()]) + a["b3e"]).double()
        _close64(got, ref, torch.cat([x.abs().sum(0), (x * x).sum(0)]))
        assert torch.equal(got, K.k7_gate_stats(u, v, bu, bv, a["b3e"]))


@pytest.mark.parametrize("which,d", CASES)
def test_k8_bf16_kernel_vs_plain(graphs, cuda, d, which):
    for flip in (False, True):
        graph = graphs[which]
        a = _bf16_train_inputs(graph, cuda, d, seed=28)
        u, v, v_csr, u_csr = graph.roles(flip)
        args = (a["d_sum_u"], a["d_sum_v"], a["proj_u"], a["proj_v"], a["b3e"],
                a["e_in"], a["d_e_out"], a["bn"])
        got = K.k8_train_layer_bwd(u, v, v_csr, u_csr, *args)
        ref = K.k8_train_layer_bwd_plain(u, v, *args)
        torch.cuda.synchronize()
        assert [t.dtype for t in got] == [torch.bfloat16] * 4 + [torch.float64]
        torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)      # x
        torch.testing.assert_close(got[1], ref[1], rtol=0, atol=0)      # d_eo
        for x, y in zip(got[2:4], ref[2:4]):                        # node sums
            torch.testing.assert_close(x.float(), y.float(), **BF16_SUM_TOL)
        deo = ref[1].double().abs()
        _close64(got[4], ref[4], torch.cat([
            deo.sum(0), (deo * ref[0].double().abs()).sum(0)]))
        again = K.k8_train_layer_bwd(u, v, v_csr, u_csr, *args)
        assert all(torch.equal(p, q) for p, q in zip(got, again))


@pytest.mark.parametrize("layout", list(K6_LAYOUTS))
@pytest.mark.parametrize("which,h", K9_BF16_CASES)
def test_k9_bf16_kernel_vs_plain(graphs, cuda, h, which, layout):
    """A bf16 payload's float32 [sum_u | sum_v], bit-equal to the plain
    version on CPU copies and within the node-sum tolerance of it on the
    card."""
    for flip in (False, True):
        graph = graphs[which]
        gen = torch.Generator(device=cuda).manual_seed(29)
        pad = K6_LAYOUTS[layout]
        pay = _bf16(torch.randn(graph.n_edges, h + pad, device=cuda,
                                generator=gen))[:, :h]
        u, v, v_csr, u_csr = graph.roles(flip)
        got = K.k9_aggregate(u, v, v_csr, u_csr, pay)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32
        assert got.shape == (graph.n_nodes, 2 * h)
        ref = K.k9_aggregate_plain(u.cpu(), v.cpu(), pay.cpu(), graph.n_nodes)
        torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=0)
        torch.testing.assert_close(
            got, K.k9_aggregate_plain(u, v, pay, graph.n_nodes), rtol=1e-5,
            atol=1e-4)
        assert torch.equal(got, K.k9_aggregate(u, v, v_csr, u_csr, pay))


def test_two_card_bf16_train_steps_bitwise_equal(cuda):
    """Two batch-norm train steps at compute.dtype=bfloat16 from one state:
    bitwise equal, through the bf16 kernels only (8/8/8/8/1/1
    K7/K3/K8/edge adjoint/K6/K9 per step), float32 logits, gradients and
    parameters, no host synchronisation."""
    from gnnome_tpu_torch.config import Config

    cfg = Config()
    cfg.compute.dtype = "bfloat16"
    (counts, counts_bf16), (_, lo0, g0, p0) = _two_card_steps(cuda, cfg)
    assert counts == counts_bf16 == expected_launches(
        **times(TRAIN_STEP_LAUNCHES, 2))
    assert lo0.dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in g0 + p0)


# The bf16 instantiations of K1 and K2 (the layer-norm and norm-free models
# at compute.dtype=bfloat16): K1's gate repeats the plain version's two
# rounded adds and its copies are copies: exact.  K2 sums bf16 payloads in
# float32 in slot order: bit-equal to the plain version on CPU copies.
# Row layouts: column slices of a [N, 5d] projection (16-byte words at d =
# 16, 64 and 192, 8-byte words at d = 20, one element at d = 6) and odd
# row strides (one element per thread).
@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("which,d", K1_CASES)
def test_k1_bf16_kernel_vs_plain(graphs, cuda, d, pad, which):
    for flip in (False, True):
        graph = graphs[which]
        gen = torch.Generator(device=cuda).manual_seed(30)
        proj = _bf16(torch.randn(graph.n_nodes, 5 * d + pad, device=cuda,
                                 generator=gen))
        proj_u, proj_v = proj[:, :2 * d], proj[:, 2 * d:4 * d]
        b3e = _bf16(torch.randn(graph.n_edges, d, device=cuda, generator=gen))
        u, v, _, _ = graph.roles(flip)
        K.reset_launch_counts()
        got = K.k1_gather_gate(u, v, proj_u, proj_v, b3e)
        assert K.launch_counts(torch.bfloat16)["k1_gather_gate"] == 1
        assert K.launch_counts(torch.float32)["k1_gather_gate"] == 0
        ref = K.k1_gather_gate_plain(u, v, proj_u, proj_v, b3e)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16
        assert got.shape == (graph.n_edges, 3 * d)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
        assert torch.equal(got, K.k1_gather_gate(u, v, proj_u, proj_v, b3e))


@pytest.mark.parametrize("pad", K2_PADS)
@pytest.mark.parametrize("which,width", K2_BF16_CASES)
def test_k2_bf16_kernel_vs_cpu_plain(graphs, cuda, width, pad, which):
    """bf16 payloads (u side padded by ``pad`` columns) into float32
    sums."""
    for flip in (False, True):
        graph = graphs[which]
        gen = torch.Generator(device=cuda).manual_seed(31)
        pay_u = _bf16(torch.randn(graph.n_edges, width + pad, device=cuda,
                                  generator=gen))[:, :width]
        pay_v = _bf16(torch.randn(graph.n_edges, width, device=cuda,
                                  generator=gen))
        u, v, v_csr, u_csr = graph.roles(flip)
        K.reset_launch_counts()
        got = K.k2_aggregate(u, v, v_csr, u_csr, pay_u, pay_v)
        assert K.launch_counts(torch.bfloat16)["k2_aggregate"] == 1
        torch.cuda.synchronize()
        ref = K.k2_aggregate_plain(u.cpu(), v.cpu(), pay_u.cpu(), pay_v.cpu(),
                                   graph.n_nodes)
        for x, y in zip(got, ref):
            assert x.dtype == torch.float32
            torch.testing.assert_close(x.cpu(), y, rtol=0, atol=0)
        again = K.k2_aggregate(u, v, v_csr, u_csr, pay_u, pay_v)
        assert all(torch.equal(p, q) for p, q in zip(got, again))


@pytest.mark.parametrize("norm", ["none", "layer"])
def test_two_card_unfused_bf16_train_steps_bitwise_equal(cuda, norm):
    """Two layer-norm or norm-free train steps at compute.dtype=bfloat16
    from one state: bitwise equal, 32 K1 and 68 K2 over the two 8-layer
    steps, of them in bf16 every one (none) or those of the first layer and
    K1's adjoint there (layer norm, float32 from its first norms on, whose
    float32 layers 2-8 run the layer-norm edge stage and its adjoint: 28 of
    each), float32 logits, gradients and parameters, no host
    synchronisation."""
    from gnnome_tpu_torch.config import Config

    cfg = Config()
    cfg.model.normalization = norm
    cfg.compute.dtype = "bfloat16"
    (counts, counts_bf16), (_, lo0, g0, p0) = _two_card_steps(cuda, cfg)
    assert counts == expected_launches(**times(UNFUSED_STEP_ALL_BF16[norm],
                                               2))
    assert counts_bf16 == expected_launches(**times(UNFUSED_STEP_BF16[norm],
                                                    2))
    assert lo0.dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in g0 + p0)


# The batch-norm edge adjoint (csrc/bn_edge_adjoint.cu): bit for bit its
# plain version run on the card, in float32 and bf16, at the dual width
# 128, the single pass's 64 and 36 (not a whole number of 16-byte words:
# the one-element path), on a row count that leaves a ragged last tile, the
# golden graph's edge count and the ~2.41M edges of the cell
# train-b64-g524k; rows 2 bytes off a 16-byte boundary take the
# one-element path too.
def _adjoint_inputs(E, w, dt, cuda, seed, offset=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    mean = torch.randn(w, device=cuda, generator=gen) * 0.3
    inv = torch.rand(w, device=cuda, generator=gen) + 0.5
    gamma = torch.rand(w, device=cuda, generator=gen) + 0.5
    beta = torch.randn(w, device=cuda, generator=gen) * 0.1
    if dt == torch.bfloat16:
        scale = gamma * inv
        bn = torch.stack([torch.zeros_like(scale), torch.ones_like(scale),
                          scale, beta - mean * scale]).to(dt)
    else:
        bn = torch.stack([mean, inv, gamma, beta])
    x = (torch.randn(E, w, device=cuda, generator=gen) / inv + mean).to(dt)
    d_eo = torch.randn(E, w, device=cuda, generator=gen).to(dt)
    c1, c2 = (torch.randn(w, device=cuda, generator=gen) * 1e-4
              for _ in range(2))
    return (_shifted(x, offset), _shifted(d_eo, offset), bn,
            torch.stack([gamma * inv, c1, c2]))


def _shifted(t, offset: int):
    """``t``'s values, contiguous, ``offset`` elements into a storage."""
    out = torch.empty(t.numel() + offset, dtype=t.dtype,
                      device=t.device)[offset:].view(t.shape)
    return out.copy_(t)


@pytest.mark.parametrize("rows", [100_003, 257_346, 2_410_000])
@pytest.mark.parametrize("w", [128, 64, 36])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_bn_edge_adjoint_kernel_vs_plain(cuda, dt, w, rows):
    x, d_eo, bn, sc = _adjoint_inputs(rows, w, dt, cuda, seed=31)
    n0, b0 = K.bn_edge_adjoint.launches, K.bn_edge_adjoint.launches_bf16
    got = K.bn_edge_adjoint(x, d_eo, bn, sc)
    assert K.bn_edge_adjoint.launches == n0 + 1
    assert K.bn_edge_adjoint.launches_bf16 == b0 + (dt == torch.bfloat16)
    ref = K.bn_edge_adjoint_plain(x, d_eo, bn, sc)
    torch.cuda.synchronize()
    y = ((x - bn[0]) * bn[1]) * bn[2] + bn[3]
    assert 0.3 < float((y > 0).float().mean()) < 0.7
    assert got.dtype == dt and got.shape == x.shape and got.is_contiguous()
    assert torch.equal(got, ref)
    assert torch.equal(got, K.bn_edge_adjoint(x, d_eo, bn, sc))


@pytest.mark.parametrize("rows", [5_001, 257_346])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_bn_edge_adjoint_unaligned_rows(cuda, dt, rows):
    x, d_eo, bn, sc = _adjoint_inputs(rows, 64, dt, cuda, seed=32, offset=1)
    assert x.is_contiguous() and x.data_ptr() % 16
    assert torch.equal(K.bn_edge_adjoint(x, d_eo, bn, sc),
                       K.bn_edge_adjoint_plain(x, d_eo, bn, sc))


def test_bn_edge_adjoint_rejects_bad_inputs(cuda):
    x, d_eo, bn, sc = _adjoint_inputs(1_000, 64, torch.float32, cuda, seed=33)
    n0 = K.bn_edge_adjoint.launches
    with pytest.raises(TypeError):                       # float64 rows
        K.bn_edge_adjoint(x.double(), d_eo.double(), bn.double(), sc)
    with pytest.raises(TypeError):                       # sc not float32
        K.bn_edge_adjoint(x, d_eo, bn, sc.double())
    with pytest.raises(TypeError):                       # mixed dtypes
        K.bn_edge_adjoint(x, d_eo.bfloat16(), bn, sc)
    with pytest.raises(ValueError):                      # d_eo's shape
        K.bn_edge_adjoint(x, d_eo[:-1], bn, sc)
    with pytest.raises(ValueError):                      # bn's width
        K.bn_edge_adjoint(x, d_eo, bn[:, :32], sc)
    with pytest.raises(ValueError):                      # a column slice
        K.bn_edge_adjoint(torch.zeros(1_000, 72, device=cuda)[:, :64],
                          d_eo, bn, sc)
    with pytest.raises(ValueError):                      # rows not dense
        K.bn_edge_adjoint(x, torch.zeros(64, 1_000, device=cuda).t(), bn, sc)
    assert K.bn_edge_adjoint.launches == n0
    empty = torch.zeros(0, 64, device=cuda)
    out = K.bn_edge_adjoint(empty, empty, bn, sc)
    assert out.shape == (0, 64) and K.bn_edge_adjoint.launches == n0


# Every wrapper at E = 0 on the card (a halo rank whose block holds no
# edge), at the width of the CPU test and the model's 64: the outputs of
# ``torch_recipes.no_edge_call`` on the card, no launch counted.
@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("name,dt", NO_EDGE_CASES)
def test_every_wrapper_at_no_edges_on_card(cuda, name, dt, d):
    check_no_edge_call(name, dt, cuda, d)


# ----------------------------------------------------------------- probes
# The card probes (gnnome_tpu_torch/probes): every instantiated K3 variant
# (csrc/probes/k3_ablate.cu) against its plain version, at the tolerances
# of K3 above (float32: e_out atol 1e-5, sums rtol 1e-5 + atol 1e-4; bf16:
# e_out exact, sums BF16_SUM_TOL), walk words exact; `full` at K3's own
# team size and depth bit for bit K3, and sums_unstored with its sums
# stored bit for bit `full`.  stream_sum (csrc/probes/stream_sum.cu) bit
# for bit its plain version: the same adds in the same order.
@pytest.mark.parametrize("which", ["hub", "golden"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_k3_ablate_variants_vs_plain(graphs, cuda, d, dtype, which):
    for flip in (False, True):
        from gnnome_tpu_torch.probes import k3_ablate as P

        graph = graphs[which]
        rows = P.inputs(graph.n_nodes, graph.n_edges, d, dtype, cuda, seed=9)
        u, v, v_csr, u_csr = graph.roles(flip)
        k3 = K.k3_edge_stage(u, v, v_csr, u_csr, *rows)
        full = P.k3_ablate("full", u, v, v_csr, u_csr, *rows)
        assert all(torch.equal(full[k], r)
                   for k, r in zip(("e_out", "sum_v", "sum_u"), k3))
        kept = P.k3_ablate("sums_unstored", u, v, v_csr, u_csr, *rows,
                           store_sums=True)
        assert all(torch.equal(kept[k], full[k]) for k in full)
        bf16 = dtype == torch.bfloat16
        sum_tol = BF16_SUM_TOL if bf16 else dict(rtol=1e-5, atol=1e-4)
        for variant, team, stages in sorted(P.INSTANCES):
            n0 = P.k3_ablate.launches
            got = P.k3_ablate(variant, u, v, v_csr, u_csr, *rows, team=team,
                              stages=stages)
            assert P.k3_ablate.launches == n0 + 1
            ref = P.k3_ablate_plain(variant, u, v, *rows)
            torch.cuda.synchronize()
            assert set(got) == set(ref), variant
            for k in got:
                what = f"{variant}:{team}:{stages} {k}"
                if k.startswith("walk"):
                    assert torch.equal(got[k], ref[k]), what
                elif k == "e_out":
                    torch.testing.assert_close(got[k], ref[k], rtol=0,
                                               atol=0 if bf16 else 1e-5,
                                               msg=what)
                else:
                    torch.testing.assert_close(got[k].float(), ref[k].float(),
                                               **sum_tol, msg=what)


def test_k3_ablate_refuses(graph, cuda):
    from gnnome_tpu_torch.probes import k3_ablate as P

    rows = P.inputs(graph.n_nodes, graph.n_edges, 64, torch.float32, cuda)
    u, v, v_csr, u_csr = graph.roles(False)
    with pytest.raises(ValueError, match="not built"):
        P.k3_ablate("walk_only", u, v, v_csr, u_csr, *rows, team=8)
    with pytest.raises(ValueError, match="window partials"):
        P.k3_ablate("per_tile", u, v, v_csr, u_csr, *rows)
    odd = P.inputs(graph.n_nodes, graph.n_edges, 18, torch.float32, cuda)
    with pytest.raises(ValueError, match="vector path"):
        P.k3_ablate("full", u, v, v_csr, u_csr, *odd, team=8)


# stream_sum at T = 96, ET = 512 for every K, and at every point of the
# probe's K and grid sweeps
STREAM_POINTS = ([(96, 512, k) for k in range(1, 13)]
                 + sorted(set(K_SWEEP + GRID_SWEEP)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,ET,k", STREAM_POINTS)
def test_stream_sum_vs_plain(cuda, T, ET, k, dtype):
    from gnnome_tpu_torch.probes import dma_probe

    d = 64
    xs = dma_probe.inputs(k, T * ET, d, dtype, cuda, seed=k)
    n0 = dma_probe.stream_sum.launches
    got = dma_probe.chain(dma_probe.stream_sum, xs, T, ET, 3)
    assert dma_probe.stream_sum.launches == n0 + 3
    ref = dma_probe.chain(lambda ins, *_: dma_probe.stream_sum_plain(ins),
                          xs, T, ET, 3)
    assert got.dtype == dtype and torch.equal(got, ref)
    with pytest.raises(ValueError, match="16-byte"):
        dma_probe.stream_sum([x[:T, :3].contiguous() for x in xs], T, 1)


# The Mosaic repro probe's kernels (csrc/probes/mosaic_ops.cu) against their
# plain versions, float32 and bf16, at the scripts' shapes and odd ones, on
# row-strided views: row_stack (and its inverse, its output into a zeroed
# wider buffer) and row_gather exact, out-of-range indices a zero row;
# row_stack's sigmoid within 1e-6 (float32; expf against torch's exp) or
# one bf16 spacing; segment_sum bit for bit its plain version on CPU copies
# (index_add_ adds each row's terms in ascending order there, as the kernel
# does) and a second launch bit for bit the first, out-of-range terms
# dropped; small_matmul within 1e-5 x sum |a||b| (float32; another order
# of the same float32 products), bf16 also one bf16 spacing.  Then every
# case of CASES passes on the card, and no wrapper launches at zero rows.
MOSAIC_DTYPES = [torch.float32, torch.bfloat16]


def _mosaic_randn(shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dtype)


def _mosaic_index(n, rows, seed):
    """int32 indices in [-3, rows + 3): repeats and some out of range."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(-3, rows + 3, (n,), generator=gen,
                         dtype=torch.int32)


@pytest.mark.parametrize("dtype", MOSAIC_DTYPES)
@pytest.mark.parametrize("h,d", [(256, 64), (37, 5), (1, 130)])
def test_row_stack_vs_plain(cuda, h, d, dtype):
    from gnnome_tpu_torch.probes import mosaic_repro as M

    a = _mosaic_randn((h, 2 * d + 3), dtype, h + d)[:, :2 * d]
    lo, hi = a[:, :d].to(cuda), a[:, d:].to(cuda)
    n0 = M.row_stack.launches
    got = M.row_stack(lo, hi)
    assert M.row_stack.launches == n0 + 1
    assert torch.equal(got.cpu(), M.row_stack_plain(a[:, :d], a[:, d:]))
    b = _mosaic_randn((2 * h, d), dtype, 7).to(cuda)
    assert torch.equal(M.row_stack(b[:h], b[h:], inverse=True),
                       M.row_stack_plain(b[:h], b[h:], inverse=True))
    buf = torch.zeros((2 * h, 2 * d), dtype=dtype, device=cuda)
    M.row_stack(lo, hi, out=buf[:, :d])
    assert torch.equal(buf[:, :d], got) and not buf[:, d:].any()
    sig = M.row_stack(lo, hi, sigmoid=True).float()
    ref = M.row_stack_plain(lo, hi, sigmoid=True).float()
    tol = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-6
    assert float((sig - ref).abs().max()) <= tol


@pytest.mark.parametrize("dtype", MOSAIC_DTYPES)
@pytest.mark.parametrize("n,rows,w", [(512, 256, 128), (7, 3, 130),
                                      (1000, 40, 1)])
def test_row_gather_vs_plain(cuda, n, rows, w, dtype):
    from gnnome_tpu_torch.probes import mosaic_repro as M

    table = _mosaic_randn((rows, w + 2), dtype, n)[:, :w].to(cuda)
    idx = _mosaic_index(n, rows, w).to(cuda)
    n0 = M.row_gather.launches
    got = M.row_gather(table, idx)
    assert M.row_gather.launches == n0 + 1
    assert torch.equal(got, M.row_gather_plain(table, idx))
    bad = (idx < 0) | (idx >= rows)
    assert bad.any() and not got[bad].any()


@pytest.mark.parametrize("dtype", MOSAIC_DTYPES)
@pytest.mark.parametrize("n,rows,w", [(512, 256, 128), (2500, 40, 200),
                                      (5, 3, 1)])
def test_segment_sum_vs_plain(cuda, n, rows, w, dtype):
    from gnnome_tpu_torch.probes import mosaic_repro as M

    pay = _mosaic_randn((n, w + 1), dtype, n + w)[:, :w].to(cuda)
    idx = _mosaic_index(n, rows, rows).to(cuda)
    n0 = M.segment_sum.launches
    got = M.segment_sum(idx, pay, rows)
    again = M.segment_sum(idx, pay, rows)
    assert M.segment_sum.launches == n0 + 2
    assert got.dtype == dtype and torch.equal(got, again)
    assert torch.equal(got.cpu(), M.segment_sum_plain(idx.cpu(), pay.cpu(),
                                                      rows))
    dup = M.segment_sum(idx, pay, rows, dup=True)
    assert torch.equal(dup, torch.cat([got, got], 1))


@pytest.mark.parametrize("dtype", MOSAIC_DTYPES)
@pytest.mark.parametrize("m,k,n", [(512, 256, 128), (512, 64, 64),
                                   (33, 17, 5), (1, 300, 19)])
def test_small_matmul_vs_plain(cuda, m, k, n, dtype):
    from gnnome_tpu_torch.probes import mosaic_repro as M

    a = _mosaic_randn((m, k + 4), dtype, m)[:, 2:k + 2].to(cuda)
    b = _mosaic_randn((k, n), dtype, n).to(cuda)
    n0 = M.small_matmul.launches
    got = M.small_matmul(a, b)
    assert M.small_matmul.launches == n0 + 1
    ref = M.small_matmul_plain(a, b).float()
    tol = 1e-5 * M.small_matmul_plain(a.abs(), b.abs()).float()
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * torch.maximum(got.float().abs(), ref.abs())
    assert got.dtype == dtype and bool(((got.float() - ref).abs()
                                        <= tol).all())
    assert torch.equal(got, M.small_matmul(a, b))


def test_mosaic_cases_pass(cuda):
    """Every case of the five scripts (42 with the dtypes) through the
    probe's entry ``run_cases``, counters from 0: PASS, each of the four
    kernels launched, every ``small_matmul`` launch counted under its
    instantiation; then the four kernels alone at P3's shapes in float32
    and bf16 PASS beside their library calls, ``small_matmul`` through its
    vector instantiation."""
    from gnnome_tpu_torch import probes
    from gnnome_tpu_torch.probes import mosaic_repro as M

    probes.reset_launch_counts()
    rows = M.run_cases(cuda, seed=5, reps=2)
    assert [r["status"] for r in rows] == ["PASS"] * len(M.CASES), [
        (r["case"], r.get("error")) for r in rows if r["status"] != "PASS"]
    assert len(rows) == len(M.CASES) == 42
    assert all(r["ms"] > 0 and r["bound_ms"] > 0 for r in rows)
    counts = probes.launch_counts()
    assert all(counts[k] for k in M.OPS), counts
    assert sum(counts[f"small_matmul:{r}"] for r in M.MATMUL_ROUTES) == (
        counts["small_matmul"])
    before = dict(M.small_matmul.routes)
    for dt in (torch.float32, torch.bfloat16):
        ops = M.op_times(cuda, dt, seed=5, reps=2)
        assert {r["status"] for r in ops.values()} == {"PASS"}, ops
        assert all(r.get("library_ms") for r in ops.values())
    p3 = {r: M.small_matmul.routes[r] - before[r] for r in M.MATMUL_ROUTES}
    assert p3["vector"] > 0 and p3["scalar"] == 0


def test_probe_build_reports_resources(cuda):
    """``-Xptxas -v`` reports registers for every instantiation of
    ``small_matmul`` (4) and ``stream_sum`` (24: K x dtype) in
    ``build/nvcc_probes.log``."""
    import os

    from gnnome_tpu_torch.probes import library, ptxas_resources

    library()
    with open(os.path.join(K.BUILD_DIR, "nvcc_probes.log")) as f:
        log = f.read()
    res = {n: ptxas_resources(log, (n,)) for n in ("small_matmul",
                                                  "stream_sum")}
    assert [len(res["small_matmul"]), len(res["stream_sum"])] == [4, 24]
    assert all(r["registers"] for rs in res.values() for r in rs), res


def test_mosaic_zero_rows_launch_nothing(cuda):
    from gnnome_tpu_torch.probes import launch_counts
    from gnnome_tpu_torch.probes import mosaic_repro as M

    a = torch.randn(6, 8, device=cuda)
    idx = torch.zeros(0, dtype=torch.int32, device=cuda)
    before = launch_counts()
    assert M.row_stack(a[:0, :4], a[:0, 4:]).shape == (0, 4)
    assert M.row_gather(a, idx).shape == (0, 8)
    assert not M.segment_sum(idx, a[:0], 3).any()
    assert M.small_matmul(a[:0], a.t().contiguous()).shape == (0, 6)
    assert launch_counts() == before
    with pytest.raises(TypeError, match="int32"):
        M.row_gather(a, idx.long())


# small_matmul's two instantiations (csrc/probes/mosaic_ops.cu): operands
# whose base and row strides lie on 16 bytes take the vector one (cp.async
# chunks, zero-filled past the edge), an offset view the scalar one (element
# loads); each within 1e-5 x sum |a||b| of the plain version (bf16 also one
# bf16 spacing) and bit for bit on repeat, at shapes that cross the 32 x 16
# output tile and the 64-deep k-tile (and its 4-stage ring: K = 300) and
# P3's; `small_matmul.routes` counts the instantiation that ran.
MATMUL_SHAPES = [(512, 256, 128), (65, 129, 70), (256, 64, 64), (33, 17, 5),
                 (1, 300, 19), (512, 64, 64)]


def _matmul_operand(rows, cols, dtype, seed, view, cuda):
    """[rows, cols] on the card: ``aligned`` a column slice of a buffer whose
    rows are 8 elements + 64 wider than cols rounded up to 8 (16-byte rows;
    [256, 64] gets row stride 128, the scripts' lane slice), ``offset`` the
    same starting one element in (no 16-byte row)."""
    ld = -(-cols // 8) * 8 + 64
    buf = _mosaic_randn((rows, ld), dtype, seed).to(cuda)
    start = 0 if view == "aligned" else 1
    return buf[:, start:start + cols]


@pytest.mark.parametrize("dtype", MOSAIC_DTYPES)
@pytest.mark.parametrize("view", ["aligned", "offset"])
@pytest.mark.parametrize("m,k,n", MATMUL_SHAPES)
def test_small_matmul_instantiations_vs_plain(cuda, m, k, n, view, dtype):
    from gnnome_tpu_torch.probes import mosaic_repro as M

    a = _matmul_operand(m, k, dtype, m + k, view, cuda)
    b = _matmul_operand(k, n, dtype, k + n, view, cuda)
    route = "vector" if view == "aligned" else "scalar"
    assert M.matmul_route(a, b) == route
    before = dict(M.small_matmul.routes)
    got = M.small_matmul(a, b)
    again = M.small_matmul(a, b)
    assert M.small_matmul.routes[route] == before[route] + 2
    assert sum(M.small_matmul.routes.values()) == sum(before.values()) + 2
    ref = M.small_matmul_plain(a, b).float()
    tol = 1e-5 * M.small_matmul_plain(a.abs(), b.abs()).float()
    if dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * torch.maximum(got.float().abs(), ref.abs())
    assert got.dtype == dtype and got.shape == (m, n)
    assert bool(((got.float() - ref).abs() <= tol).all())
    assert torch.equal(got, again)


# stream_sum where a logical block is not whole tiles (4,100 16-byte words
# a block: float32 d = 40, bf16 d = 80, ET = 410; tiles of 1,024 words)
# and T below the card's 132 SMs: bit for bit its plain version.
@pytest.mark.parametrize("dtype,d", [(torch.float32, 40),
                                     (torch.bfloat16, 80)])
@pytest.mark.parametrize("k", [1, 2, 3, 12])
@pytest.mark.parametrize("T", [1, 7, 100])
def test_stream_sum_ragged_tiles_few_blocks(cuda, T, k, dtype, d):
    from gnnome_tpu_torch.probes import dma_probe

    ET = 410
    assert ET * d * torch.tensor([], dtype=dtype).element_size() // 16 == 4100
    xs = dma_probe.inputs(k, T * ET, d, dtype, cuda, seed=T + k)
    got = dma_probe.chain(dma_probe.stream_sum, xs, T, ET, 2)
    ref = dma_probe.chain(lambda ins, *_: dma_probe.stream_sum_plain(ins),
                          xs, T, ET, 2)
    assert torch.equal(got, ref)
