"""The CUDA kernels K1, K2, K3, K6, K7, K8 and K9 against their plain
PyTorch versions, on the card, and two card train steps from one state
bitwise equal (batch norm and layer norm).  Every test here is
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
both of its paths bitwise equal; K2 and K9 up to width 256.

Tolerances: e_out and z repeat the plain version's per-op rounding (only
sigmoid's exp may differ by an ulp): ``atol=1e-5`` and exact; node sums add
~30 terms in another order (the plain version scatters with atomics):
``rtol=1e-5, atol=1e-4``.  K7 / K8's float64 global sums: ``rtol=1e-9``
relative to the sum of magnitudes (the order differs); K8's per-edge x is
exact, d_eo ``atol=1e-5`` (sigmoid); K9's and K2's sums as K3's; K1 repeats
the plain version's adds: exact.
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


@pytest.mark.parametrize("h", [16, 64, 128, 256])
@pytest.mark.parametrize("flip", [False, True])
def test_k9_kernel_vs_plain(graph, cuda, flip, h):
    gen = torch.Generator(device=cuda).manual_seed(9)
    pay = torch.randn(graph.n_edges, h, device=cuda, generator=gen)
    u, v, v_csr, u_csr = graph.roles(flip)
    n0 = K.k9_aggregate.launches
    got = K.k9_aggregate(u, v, v_csr, u_csr, pay)
    assert K.k9_aggregate.launches == n0 + 1
    ref = K.k9_aggregate_plain(u, v, pay, graph.n_nodes)
    torch.cuda.synchronize()
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-4)
    again = K.k9_aggregate(u, v, v_csr, u_csr, pay)
    assert all(torch.equal(p, q) for p, q in zip(got, again))


@pytest.mark.parametrize("norm,launches", [
    ("batch", {"k3_edge_stage": 32, "k6_score_gate": 4, "k7_gate_stats": 32,
               "k8_train_layer_bwd": 32, "k9_aggregate": 4}),
    ("layer", {"k1_gather_gate": 32, "k2_aggregate": 68})])
def test_two_card_train_steps_bitwise_equal(cuda, norm, launches):
    """Two train steps from one state (weights, data, dropout seed) give the
    same loss, logits, gradients and parameters after Adam, bit for bit,
    and launch only the kernels of the model's path (two 8-layer steps)."""
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
