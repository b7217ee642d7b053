"""The CUDA kernels K1, K2 (and its one-sided walk), K3, K6, K7, K8 and K9
against their plain PyTorch versions, on the card, and two card train
steps from one state bitwise equal (batch norm, layer norm, two zoo
models), the halo path's forward at two ranks on the card against the
single-device one, and the entry points of ``entry.py`` (``entry``, a 2-rank
``dryrun_multichip``).  Every test here is
``cuda``-marked and skips where no GPU is present.

This file imports neither JAX nor the JAX package, so it runs on a machine
without them; skip the JAX-importing conftest there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

K3, K6 and K8 run at d = 16, 20 (five float4 lanes of a team of 8), 64,
128 and 192 (two column chunks), on the synthetic assembly graph and on a
hub graph with an isolated node and a node of more than 64 in- and
out-edges (its slot list crosses the 32-slot index chunks twice); K6 also
on column slices of wider arrays, with row strides that keep the float4
path and with odd ones that take the one-float path; K7 up to d = 256 on
those graphs and on a graph of fewer edges than one index chunk, and on
both of its paths bitwise equal; K2 up to width 256; K9 at H = 16, 20,
64, 128 and 256 on all three graphs, dense, on column slices and on odd row
strides; the one-sided K2 walk at D = 3, 16, 64 and 192 into each side,
dense and on column slices, on all three graphs.

Tolerances: e_out and z repeat the plain version's per-op rounding (only
sigmoid's exp may differ by an ulp): ``atol=1e-5`` and exact; node sums add
~30 terms in another order (the plain version scatters with atomics):
``rtol=1e-5, atol=1e-4``.  K7 / K8's float64 global sums: ``rtol=1e-9``
relative to the sum of magnitudes (the order differs); K8's per-edge x is
exact, d_eo ``atol=1e-5`` (sigmoid); K2's sums as K3's; K9's exact against
the plain version on CPU copies, where ``index_add_`` adds each node's terms
in slot order as the kernel does, and so are the one-sided walk's; K1
repeats the plain version's adds: exact.  The bf16 instantiations of K1,
K2, K3, K6, K7, K8 and K9 at the end of the file state their own, and so
do the probes' kernels (``gnnome_tpu_torch/probes``: the K3 variants,
``stream_sum`` and the Mosaic repro probe's four kernels) after them.
"""
import pytest
import torch

from gnnome_tpu_torch.graphs import synthetic_assembly_graph
from gnnome_tpu_torch.ops import DeviceGraph
from gnnome_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


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
    import numpy as np

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


@pytest.fixture(scope="module")
def graphs(graph, cuda):
    return {"assembly": graph, "hub": hub_graph(cuda),
            "tiny": tiny_graph(cuda)}


WIDTHS = [16, 20, 64, 128, 192]


@pytest.mark.parametrize("which", ["assembly", "hub"])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("flip", [False, True])
def test_k3_kernel_vs_plain(graphs, cuda, flip, d, which):
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
    got = K.k3_edge_stage(u, v, v_csr, u_csr, proj_u, proj_v, b3e, e_in, bn)
    assert K.k3_edge_stage.launches == n0 + 1
    ref = K.k3_edge_stage_plain(u, v, proj_u, proj_v, b3e, e_in, bn)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-5)
    for x, y in zip(got[1:], ref[1:]):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-4)
    again = K.k3_edge_stage(u, v, v_csr, u_csr, proj_u, proj_v, b3e, e_in, bn)
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # no atomics


# row padding of puv / be: none (dense), 8 floats (column slices whose row
# strides keep the float4 path), 1 float (odd strides: the one-float path)
K6_LAYOUTS = {"dense": 0, "strided": 8, "unaligned": 1}


@pytest.mark.parametrize("layout", list(K6_LAYOUTS))
@pytest.mark.parametrize("which", ["assembly", "hub"])
@pytest.mark.parametrize("h", WIDTHS)
@pytest.mark.parametrize("flip", [False, True])
def test_k6_kernel_vs_plain(graphs, cuda, flip, h, which, layout):
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


@pytest.mark.parametrize("d", [16, 64, 6])
@pytest.mark.parametrize("flip", [False, True])
def test_k1_kernel_vs_plain(graph, cuda, flip, d):
    """d=16/64 take the float4 path on strided column slices; d=6 the
    per-feature path."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    proj = torch.randn(graph.n_nodes, 5 * d, device=cuda, generator=gen)
    proj_u, proj_v = proj[:, :2 * d], proj[:, 2 * d:4 * d]   # strided rows
    b3e = torch.randn(graph.n_edges, d, device=cuda, generator=gen)
    u, v, _, _ = graph.roles(flip)
    n0 = K.k1_gather_gate.launches
    got = K.k1_gather_gate(u, v, proj_u, proj_v, b3e)
    assert K.k1_gather_gate.launches == n0 + 1
    ref = K.k1_gather_gate_plain(u, v, proj_u, proj_v, b3e)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("width", [16, 64, 128, 256])
@pytest.mark.parametrize("flip", [False, True])
def test_k2_kernel_vs_plain(graph, cuda, flip, width):
    """Payloads as the backward of K1 passes them: a column slice of a
    wider array (u side) and a dense array (v side)."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    wide = torch.randn(graph.n_edges, width + 8, device=cuda, generator=gen)
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


@pytest.mark.parametrize("which", ["assembly", "hub", "tiny"])
@pytest.mark.parametrize("d", [16, 20, 64, 128, 192, 256])
@pytest.mark.parametrize("flip", [False, True])
def test_k7_kernel_vs_plain(graphs, cuda, flip, d, which):
    graph = graphs[which]
    a = _train_inputs(graph, cuda, d, seed=7)
    u, v, _, _ = graph.roles(flip)
    bu, bv = a["proj_u"][:, :d], a["proj_v"][:, :d]    # strided gate halves
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


@pytest.mark.parametrize("which", ["assembly", "hub"])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("flip", [False, True])
def test_k8_kernel_vs_plain(graphs, cuda, flip, d, which):
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
    for x, y in zip(got[2:4], ref[2:4]):                            # node sums
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-4)
    deo = ref[1].double().abs()                 # bounds |d_y| term by term
    _close64(got[4], ref[4], torch.cat([deo.sum(0),
                                        (deo * ref[0].double().abs()).sum(0)]))
    again = K.k8_train_layer_bwd(u, v, v_csr, u_csr, *args)
    assert all(torch.equal(p, q) for p, q in zip(got, again))      # no atomics


@pytest.mark.parametrize("layout", list(K6_LAYOUTS))
@pytest.mark.parametrize("which", ["assembly", "hub", "tiny"])
@pytest.mark.parametrize("h", [16, 20, 64, 128, 256])
@pytest.mark.parametrize("flip", [False, True])
def test_k9_kernel_vs_plain(graphs, cuda, flip, h, which, layout):
    """One launch writes [sum_u | sum_v], bit-equal to the plain version on
    CPU copies (index_add_ adds in slot order there, as the kernel does);
    dense payloads, column slices whose row strides keep the float4 path,
    and odd row strides (the one-float path)."""
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
    assert torch.equal(got, K.k9_aggregate(u, v, v_csr, u_csr, pay))


@pytest.mark.parametrize("norm,launches", [
    ("batch", {"k3_edge_stage": 16, "k6_score_gate": 2, "k7_gate_stats": 16,
               "k8_train_layer_bwd": 16, "k9_aggregate": 2}),
    ("layer", {"k1_gather_gate": 32, "k2_aggregate": 68})])
def test_two_card_train_steps_bitwise_equal(cuda, norm, launches):
    """Two train steps from one state (weights, data, dropout seed) give the
    same loss, logits, gradients and parameters after Adam, bit for bit,
    and launch only the kernels of the model's path (two 8-layer steps;
    batch norm runs both symmetry passes as one dual-width pass)."""
    import numpy as np

    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.models import SymGatedGCN
    from gnnome_tpu_torch.train.step import (host_units, make_example,
                                             make_optimizer, train_step)

    g, _, _, _ = synthetic_assembly_graph(n_reads=300, genome_len=25000,
                                          read_len=400, seed=13)
    cfg = Config()
    cfg.model.normalization = norm
    cfg.train.masking = False
    cfg.train.num_nodes_per_cluster = 10_000
    (unit,) = host_units(g, cfg, np.random.default_rng(0))
    ex = make_example(unit.in_deg, unit.out_deg, unit.e_feat, unit.y,
                      unit.src, unit.dst, unit.n_nodes, cuda)
    K.reset_launch_counts()
    outs = []
    for _ in range(2):
        model = SymGatedGCN.from_config(cfg.model).init_weights(3).to(cuda)
        opt = make_optimizer(model, 1e-3)
        gen = torch.Generator(device=cuda).manual_seed(5)
        loss, logits = train_step(model, opt, ex, 2.0, cfg, gen)
        grads = [p.grad.clone() for p in model.parameters()]
        outs.append((loss, logits, grads,
                     [p.detach().clone() for p in model.parameters()]))
    assert K.launch_counts() == {**{k: 0 for k in K.KERNELS}, **launches}
    (l0, lo0, g0, p0), (l1, lo1, g1, p1) = outs
    assert torch.isfinite(lo0).all()
    assert torch.equal(l0, l1) and torch.equal(lo0, lo1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


@pytest.mark.parametrize("which", ["assembly", "hub", "tiny"])
@pytest.mark.parametrize("width,pad", [(3, 0), (16, 0), (64, 0), (64, 5),
                                       (192, 0), (192, 8)])
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


@pytest.mark.parametrize("name,directed,side_sums", [
    ("gatedgcn", False, 48), ("gat", True, 96)])
def test_two_card_zoo_train_steps_bitwise_equal(cuda, name, directed,
                                                side_sums):
    """Two zoo train steps (plain BCE, dropout 0.2) from one state, bit for
    bit, launching only the one-sided walk and the predictor's K2."""
    import numpy as np

    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.models import get_model
    from gnnome_tpu_torch.train.step import (host_units, make_example,
                                             make_optimizer, train_step)

    g, _, _, _ = synthetic_assembly_graph(n_reads=300, genome_len=25000,
                                          read_len=400, seed=13)
    cfg = Config()
    cfg.model.model = name
    cfg.model.directed = directed
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
        outs.append((loss, logits,
                     [p.grad.clone() for p in model.parameters()],
                     [p.detach().clone() for p in model.parameters()]))
    assert K.launch_counts() == {**{k: 0 for k in K.KERNELS},
                                 "k2_side_sum": side_sums, "k2_aggregate": 2}
    (l0, lo0, g0, p0), (l1, lo1, g1, p1) = outs
    assert torch.isfinite(lo0).all()
    assert torch.equal(l0, l1) and torch.equal(lo0, lo1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


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


@pytest.mark.parametrize("which", ["assembly", "hub"])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("flip", [False, True])
def test_k3_bf16_kernel_vs_plain(graphs, cuda, flip, d, which):
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
    got = K.k3_edge_stage(u, v, v_csr, u_csr, proj_u, proj_v, b3e, e_in, bn)
    assert K.k3_edge_stage.launches == n0 + 1
    ref = K.k3_edge_stage_plain(u, v, proj_u, proj_v, b3e, e_in, bn)
    torch.cuda.synchronize()
    assert all(t.dtype == torch.bfloat16 for t in got)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=0)
    for x, y in zip(got[1:], ref[1:]):
        torch.testing.assert_close(x.float(), y.float(), **BF16_SUM_TOL)
    again = K.k3_edge_stage(u, v, v_csr, u_csr, proj_u, proj_v, b3e, e_in, bn)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("layout", list(K6_LAYOUTS))
@pytest.mark.parametrize("which", ["assembly", "hub"])
@pytest.mark.parametrize("h", WIDTHS)
@pytest.mark.parametrize("flip", [False, True])
def test_k6_bf16_kernel_vs_plain(graphs, cuda, flip, h, which, layout):
    """Dense rows, column slices whose row strides keep the 8-byte vector
    path, and odd strides (one element per lane): bit-equal."""
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


@pytest.mark.parametrize("which", ["assembly", "hub", "tiny"])
@pytest.mark.parametrize("d", [16, 20, 64, 128, 192])
@pytest.mark.parametrize("flip", [False, True])
def test_k7_bf16_kernel_vs_plain(graphs, cuda, flip, d, which):
    graph = graphs[which]
    a = _bf16_train_inputs(graph, cuda, d, seed=27)
    u, v, _, _ = graph.roles(flip)
    bu, bv = a["proj_u"][:, :d], a["proj_v"][:, :d]    # strided gate halves
    got = K.k7_gate_stats(u, v, bu, bv, a["b3e"])
    ref = K.k7_gate_stats_plain(u, v, bu, bv, a["b3e"])
    x = ((bu[u.long()] + bv[v.long()]) + a["b3e"]).double()
    _close64(got, ref, torch.cat([x.abs().sum(0), (x * x).sum(0)]))
    assert torch.equal(got, K.k7_gate_stats(u, v, bu, bv, a["b3e"]))


@pytest.mark.parametrize("which", ["assembly", "hub"])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("flip", [False, True])
def test_k8_bf16_kernel_vs_plain(graphs, cuda, flip, d, which):
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
    for x, y in zip(got[2:4], ref[2:4]):                            # node sums
        torch.testing.assert_close(x.float(), y.float(), **BF16_SUM_TOL)
    deo = ref[1].double().abs()
    _close64(got[4], ref[4], torch.cat([deo.sum(0),
                                        (deo * ref[0].double().abs()).sum(0)]))
    again = K.k8_train_layer_bwd(u, v, v_csr, u_csr, *args)
    assert all(torch.equal(p, q) for p, q in zip(got, again))


@pytest.mark.parametrize("layout", list(K6_LAYOUTS))
@pytest.mark.parametrize("which", ["assembly", "hub", "tiny"])
@pytest.mark.parametrize("h", [16, 20, 64, 128, 256])
@pytest.mark.parametrize("flip", [False, True])
def test_k9_bf16_kernel_vs_plain(graphs, cuda, flip, h, which, layout):
    """A bf16 payload's float32 [sum_u | sum_v], bit-equal to the plain
    version on CPU copies."""
    graph = graphs[which]
    gen = torch.Generator(device=cuda).manual_seed(29)
    pad = K6_LAYOUTS[layout]
    pay = _bf16(torch.randn(graph.n_edges, h + pad, device=cuda,
                            generator=gen))[:, :h]
    u, v, v_csr, u_csr = graph.roles(flip)
    got = K.k9_aggregate(u, v, v_csr, u_csr, pay)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (graph.n_nodes, 2 * h)
    ref = K.k9_aggregate_plain(u.cpu(), v.cpu(), pay.cpu(), graph.n_nodes)
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=0)
    assert torch.equal(got, K.k9_aggregate(u, v, v_csr, u_csr, pay))


def test_two_card_bf16_train_steps_bitwise_equal(cuda):
    """Two batch-norm train steps at compute.dtype=bfloat16 from one state:
    bitwise equal, through the bf16 kernels only (8/8/8/1/1 per step)."""
    import numpy as np

    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.models import SymGatedGCN
    from gnnome_tpu_torch.train.step import (host_units, make_example,
                                             make_optimizer, train_step)

    g, _, _, _ = synthetic_assembly_graph(n_reads=300, genome_len=25000,
                                          read_len=400, seed=13)
    cfg = Config()
    cfg.compute.dtype = "bfloat16"
    cfg.train.masking = False
    cfg.train.num_nodes_per_cluster = 10_000
    (unit,) = host_units(g, cfg, np.random.default_rng(0))
    ex = make_example(unit.in_deg, unit.out_deg, unit.e_feat, unit.y,
                      unit.src, unit.dst, unit.n_nodes, cuda)
    K.reset_launch_counts()
    outs = []
    for _ in range(2):
        model = SymGatedGCN.from_config(cfg.model).init_weights(3).to(cuda)
        opt = make_optimizer(model, 1e-3)
        gen = torch.Generator(device=cuda).manual_seed(5)
        loss, logits = train_step(model, opt, ex, 2.0, cfg, gen)
        outs.append((loss, logits, [p.grad.clone() for p in
                                    model.parameters()],
                     [p.detach().clone() for p in model.parameters()]))
    assert K.launch_counts() == {**{k: 0 for k in K.KERNELS},
                                 "k3_edge_stage": 16, "k6_score_gate": 2,
                                 "k7_gate_stats": 16,
                                 "k8_train_layer_bwd": 16, "k9_aggregate": 2}
    (l0, lo0, g0, p0), (l1, lo1, g1, p1) = outs
    assert lo0.dtype == torch.float32 and torch.isfinite(lo0).all()
    assert all(t.dtype == torch.float32 for t in g0 + p0)
    assert torch.equal(l0, l1) and torch.equal(lo0, lo1)
    assert all(torch.equal(a, b) for a, b in zip(g0 + p0, g1 + p1))


# The bf16 instantiations of K1 and K2 (the layer-norm and norm-free models
# at compute.dtype=bfloat16): K1's gate repeats the plain version's two
# rounded adds and its copies are copies: exact.  K2 sums bf16 payloads in
# float32 in slot order: bit-equal to the plain version on CPU copies.
# Row layouts: column slices of a [N, 5d] projection (16-byte words at d =
# 16, 64 and 192, 8-byte words at d = 20, one element at d = 6) and odd
# row strides (one element per thread).
@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("d", [6, 16, 20, 64, 192])
@pytest.mark.parametrize("flip", [False, True])
def test_k1_bf16_kernel_vs_plain(graph, cuda, flip, d, pad):
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
    assert got.dtype == torch.bfloat16 and got.shape == (graph.n_edges, 3 * d)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert torch.equal(got, K.k1_gather_gate(u, v, proj_u, proj_v, b3e))


@pytest.mark.parametrize("which", ["assembly", "hub", "tiny"])
@pytest.mark.parametrize("width", [3, 16, 64, 128, 256])
@pytest.mark.parametrize("flip", [False, True])
def test_k2_bf16_kernel_vs_cpu_plain(graphs, cuda, flip, width, which):
    """bf16 payloads (u side a column slice) into float32 sums."""
    graph = graphs[which]
    gen = torch.Generator(device=cuda).manual_seed(31)
    pay_u = _bf16(torch.randn(graph.n_edges, width + 8, device=cuda,
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


@pytest.mark.parametrize("norm,bf16_launches", [
    ("none", {"k1_gather_gate": 32, "k2_aggregate": 68}),
    ("layer", {"k1_gather_gate": 4, "k2_aggregate": 4})])
def test_two_card_unfused_bf16_train_steps_bitwise_equal(cuda, norm,
                                                         bf16_launches):
    """Two layer-norm or norm-free train steps at compute.dtype=bfloat16
    from one state: bitwise equal, 32 K1 and 68 K2 over the two 8-layer
    steps, of them in bf16 every one (none) or those of the first layer and
    K1's adjoint there (layer norm, float32 from its first norms on)."""
    import numpy as np

    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.models import SymGatedGCN
    from gnnome_tpu_torch.train.step import (host_units, make_example,
                                             make_optimizer, train_step)

    g, _, _, _ = synthetic_assembly_graph(n_reads=300, genome_len=25000,
                                          read_len=400, seed=13)
    cfg = Config()
    cfg.model.normalization = norm
    cfg.compute.dtype = "bfloat16"
    cfg.train.masking = False
    cfg.train.num_nodes_per_cluster = 10_000
    (unit,) = host_units(g, cfg, np.random.default_rng(0))
    ex = make_example(unit.in_deg, unit.out_deg, unit.e_feat, unit.y,
                      unit.src, unit.dst, unit.n_nodes, cuda)
    K.reset_launch_counts()
    outs = []
    for _ in range(2):
        model = SymGatedGCN.from_config(cfg.model).init_weights(3).to(cuda)
        opt = make_optimizer(model, 1e-3)
        gen = torch.Generator(device=cuda).manual_seed(5)
        loss, logits = train_step(model, opt, ex, 2.0, cfg, gen)
        outs.append((loss, logits, [p.grad.clone() for p in
                                    model.parameters()],
                     [p.detach().clone() for p in model.parameters()]))
    zero = {k: 0 for k in K.KERNELS}
    assert K.launch_counts() == {**zero, "k1_gather_gate": 32,
                                 "k2_aggregate": 68}
    assert K.launch_counts(torch.bfloat16) == {**zero, **bf16_launches}
    (l0, lo0, g0, p0), (l1, lo1, g1, p1) = outs
    assert lo0.dtype == torch.float32 and torch.isfinite(lo0).all()
    assert all(t.dtype == torch.float32 for t in g0 + p0)
    assert torch.equal(l0, l1) and torch.equal(lo0, lo1)
    assert all(torch.equal(a, b) for a, b in zip(g0 + p0, g1 + p1))


# The halo path (parallel/halo.py) on the card: two ranks share it over
# gloo, their strips staged through host memory.  Logits against the
# single-device card forward at the forward tolerance of
# tests/test_torch_train.py:62 (node sums and statistics add in another
# order); each rank launches K3 8 times and K6 once.
@pytest.mark.parametrize("false_edge_frac", [0.0, 0.01])
def test_halo_forward_two_ranks_vs_single_device(cuda, false_edge_frac):
    import os

    import numpy as np

    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.infer import load_model
    from gnnome_tpu_torch.models import (edge_features, load_model_weights,
                                         node_features)
    from gnnome_tpu_torch.parallel import checks
    from gnnome_tpu_torch.parallel.group import spawn

    g, _, _, _ = synthetic_assembly_graph(n_reads=512, genome_len=40000,
                                          read_len=500, seed=77,
                                          false_edge_frac=false_edge_frac)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    params, state = load_model_weights(os.path.join(root, "weights",
                                                    "weights.npz"))
    cfg = Config()
    x, e = node_features(g), edge_features(g)
    with torch.inference_mode():
        ref = load_model(params, state, cfg, cuda)(
            DeviceGraph.from_graph(g, cuda), torch.from_numpy(x).to(cuda),
            torch.from_numpy(e).to(cuda))[:, 0].cpu().numpy()
    res = spawn(checks.score_job, 2, g.src, g.dst, g.num_nodes, x, e, params,
                state, cfg, device="cuda", deadline_s=600)
    np.testing.assert_allclose(res[0]["logits"], ref, atol=5e-5, rtol=1e-4)
    for r in res:
        assert r["launches"] == {**{k: 0 for k in K.KERNELS},
                                 "k3_edge_stage": 8, "k6_score_gate": 1}


# The entry points (gnnome_tpu_torch/entry.py) on the card: entry()'s
# logits against entry(device="cpu") within the forward tolerance of
# tests/test_torch_train.py:62, a second card call bitwise equal, 8 K3 + 1
# K6 float32 launches; a 2-rank dry run (gloo ranks sharing the card, or
# NCCL with two GPUs) with 16/16/16/2/2 K7/K3/K8/K6/K9 launches per rank.
def test_entry_on_card_vs_cpu(cuda):
    import numpy as np

    from gnnome_tpu_torch.entry import entry

    fn_cpu, args_cpu = entry("cpu")
    ref = fn_cpu(*args_cpu).numpy()
    fn, args = entry("cuda")
    K.reset_launch_counts()
    a = fn(*args)
    counts = K.launch_counts()
    b = fn(*args)
    np.testing.assert_allclose(a.cpu().numpy(), ref, atol=5e-5, rtol=1e-4)
    assert torch.equal(a, b)
    assert counts == {**{k: 0 for k in K.KERNELS}, "k3_edge_stage": 8,
                      "k6_score_gate": 1}


def test_dryrun_two_ranks_on_card(cuda):
    import numpy as np

    from gnnome_tpu_torch.entry import dryrun_multichip

    res = dryrun_multichip(2, "cuda")
    assert np.isfinite(res["loss"])
    want = {**{k: 0 for k in K.KERNELS}, "k3_edge_stage": 16,
            "k6_score_gate": 2, "k7_gate_stats": 16,
            "k8_train_layer_bwd": 16, "k9_aggregate": 2}
    assert res["launches_per_rank"] == [want, want]


# ----------------------------------------------------------------- probes
# The card probes (gnnome_tpu_torch/probes): every instantiated K3 variant
# (csrc/probes/k3_ablate.cu) against its plain version, at the tolerances
# of K3 above (float32: e_out atol 1e-5, sums rtol 1e-5 + atol 1e-4; bf16:
# e_out exact, sums BF16_SUM_TOL), walk words exact; `full` at K3's own
# team size and depth bit for bit K3, and sums_unstored with its sums
# stored bit for bit `full`.  stream_sum (csrc/probes/stream_sum.cu) bit
# for bit its plain version: the same adds in the same order.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("flip", [False, True])
def test_k3_ablate_variants_vs_plain(graphs, cuda, flip, d, dtype):
    from gnnome_tpu_torch.probes import k3_ablate as P

    graph = graphs["hub"]
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", list(range(1, 13)))
def test_stream_sum_vs_plain(cuda, k, dtype):
    from gnnome_tpu_torch.probes import dma_probe

    T, ET, d = 96, 512, 64
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
    from gnnome_tpu_torch.probes import mosaic_repro as M

    rows = M.run_cases(cuda, seed=5, reps=2)
    assert [r["status"] for r in rows] == ["PASS"] * len(M.CASES), [
        (r["case"], r.get("error")) for r in rows if r["status"] != "PASS"]
    assert all(r["ms"] > 0 and r["bound_ms"] > 0 for r in rows)


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
