"""K3 / K6 / K7 of gnnome_tpu_torch, and the training functions that carry
K7, K8 and K9, against the JAX functions they replace.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held against ``gnnome_tpu.ops.message.fused_eval_edge_stage`` and
``fused_score_gate`` (Pallas kernels in interpret mode, windowed plans with an
overflow tail; K6 also on column slices), K7's against the Pallas
``k7_gate_stats`` with the caller's overflow-tail sums, and against the JAX
package's XLA edge-stage ops, at both flips and narrow width.  The JAX side runs on padded, packed, re-slotted
arrays; the comparison is in host edge order (through each side's
``eid_of_slot``/``slot_of_eid``) and on the first N node rows.

The training edge stage (``train_edge_stage``: K7 + K3 forward, K8
backward) and the score gate's backward (K9) are held against
``fused_train_stage`` and the VJP of ``fused_score_gate`` in interpret mode,
forward outputs and the VJP under seeded random cotangents, both flips, and
through ``torch.autograd.gradcheck`` in float64.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py.

Tolerances: edge outputs ``atol=1e-5`` (the same elementwise arithmetic;
the JAX interpret path runs its row selects as f32 one-hot matmuls at
HIGHEST precision), node sums ``rtol=1e-5, atol=1e-5`` (sums of ~30 terms in
another order).  The training functions take those of the JAX package's own
fused-vs-XLA training tests (tests/test_pallas_k4.py:55,60,81): forward
outputs ``atol=5e-5, rtol=1e-4`` (the JAX kernel folds the batch statistics
into one affine, the port does not), batch statistics ``1e-5``, gradients
``atol=2e-4, rtol=5e-3``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gnnome_tpu.graphs import synthetic_assembly_graph
from gnnome_tpu.models.norm import batch_norm
from gnnome_tpu.ops import GraphTensors
from gnnome_tpu.ops import message as jmsg
from gnnome_tpu.ops.graph_tensors import with_windowed_plans
from gnnome_tpu.ops.pallas_kernels import set_interpret

from gnnome_tpu_torch.ops import (DeviceGraph, eval_edge_stage, score_gate,
                                  train_edge_stage)
from gnnome_tpu_torch.ops import kernels as K

TILE, WIN, D = 128, 128, 16
EDGE_TOL = dict(rtol=0, atol=1e-5)
SUM_TOL = dict(rtol=1e-5, atol=1e-5)
FWD_TOL = dict(rtol=1e-4, atol=5e-5)
STAT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=5e-3, atol=2e-4)


@pytest.fixture(autouse=True)
def _interpret_mode():
    set_interpret(True)
    yield
    set_interpret(False)


@pytest.fixture(scope="module")
def graphs():
    g, _, _, _ = synthetic_assembly_graph(n_reads=300, genome_len=20000,
                                          read_len=400, seed=70,
                                          with_sequences=False,
                                          false_edge_frac=0.15)
    gt = GraphTensors.from_graph(g, TILE, WIN)
    gt_w = with_windowed_plans(gt, flip_too=True, tile_e=TILE, window=WIN)
    return g, gt, gt_w, DeviceGraph.from_graph(g)


def _inputs(g, seed, d=D):
    rng = np.random.default_rng(seed)
    n, e = g.num_nodes, g.num_edges
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    var = rng.uniform(0.3, 3.0, d).astype(np.float32)
    inv = torch.rsqrt(torch.from_numpy(var) + 1e-5).numpy()
    bn = np.stack([f(d) * 0.3, inv,
                   rng.uniform(0.5, 1.5, d).astype(np.float32), f(d) * 0.1])
    return dict(proj_u=f(n, 2 * d), proj_v=f(n, 2 * d), b3e=f(e, d),
                e_in=f(e, d), bn=bn), var


def _jax_slots(gt, host_rows):
    """Host-order [E, D] -> the JAX side's padded slot order [Ep, D]."""
    return gt.edges_to_slots(gt.pad_edges(host_rows))


def _jax_host(gt, slot_rows, n_edges):
    return np.asarray(gt.slots_to_edges(slot_rows))[:n_edges]


def _port(g, dg, a, flip):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    e_out, sum_v, sum_u = eval_edge_stage(
        dg, t["proj_u"], t["proj_v"], dg.edges_to_slots(t["b3e"]),
        dg.edges_to_slots(t["e_in"]), t["bn"], flip=flip)
    return dg.slots_to_edges(e_out).numpy(), sum_v.numpy(), sum_u.numpy()


@pytest.mark.parametrize("flip", [False, True])
def test_k3_plain_vs_pallas_fused_eval_edge_stage(graphs, flip):
    g, _, gt, dg = graphs
    assert (gt.wplan_flip if flip else gt.wplan).n_ovf > 0   # overflow tail
    a, _ = _inputs(g, seed=1)
    # the JAX kernel takes an affine: it is the BN rows [0, 1, scale, bias]
    a["bn"][0], a["bn"][1] = 0.0, 1.0
    n = g.num_nodes
    e_out_p, sum_v, sum_u = jmsg.fused_eval_edge_stage(
        gt, gt.pad_nodes(a["proj_u"]), gt.pad_nodes(a["proj_v"]),
        jmsg.pack_edges(_jax_slots(gt, a["b3e"])),
        jmsg.pack_edges(_jax_slots(gt, a["e_in"])),
        jnp.asarray(a["bn"][2]), jnp.asarray(a["bn"][3]), flip=flip)
    ref_e = _jax_host(gt, jmsg.unpack_edges(e_out_p), g.num_edges)
    got_e, got_v, got_u = _port(g, dg, a, flip)
    np.testing.assert_allclose(got_e, ref_e, **EDGE_TOL)
    np.testing.assert_allclose(got_v, np.asarray(sum_v)[:n], **SUM_TOL)
    np.testing.assert_allclose(got_u, np.asarray(sum_u)[:n], **SUM_TOL)


@pytest.mark.parametrize("d", [D, 160])
@pytest.mark.parametrize("flip", [False, True])
def test_k3_plain_vs_xla_edge_stage(graphs, flip, d):
    """Against the JAX package's unfused XLA ops: fused_gate_gather ->
    eval batch_norm -> relu -> residual -> sigmoid -> gated_mean_pair.
    d = 160 is a width the card path takes in two column chunks."""
    g, gt, _, dg = graphs
    a, var = _inputs(g, seed=2, d=d)
    bn = a["bn"]
    gate, a2h_u, a3h_v = jmsg.fused_gate_gather(
        gt, gt.pad_nodes(a["proj_u"]), gt.pad_nodes(a["proj_v"]),
        _jax_slots(gt, a["b3e"]), flip=flip, backend="xla")
    gate, _ = batch_norm({"scale": bn[2], "bias": bn[3]},
                         {"mean": bn[0], "var": var}, gate, gt.edge_mask,
                         g.num_edges, training=False)
    e_out = jax.nn.relu(gate) + _jax_slots(gt, a["e_in"])
    sigma = jax.nn.sigmoid(e_out) * gt.edge_mask
    h_fwd, h_bwd = jmsg.gated_mean_pair(gt, sigma, a2h_u, a3h_v, flip=flip,
                                        eps=1e-6, backend="xla")
    got_e, got_v, got_u = _port(g, dg, a, flip)
    n = g.num_nodes
    np.testing.assert_allclose(got_e, _jax_host(gt, e_out, g.num_edges),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got_v[:, :d] / (got_v[:, d:] + 1e-6),
                               np.asarray(h_fwd)[:n], **SUM_TOL)
    np.testing.assert_allclose(got_u[:, :d] / (got_u[:, d:] + 1e-6),
                               np.asarray(h_bwd)[:n], **SUM_TOL)


@pytest.mark.parametrize("flip", [False, True])
def test_k6_plain_vs_pallas_fused_score_gate(graphs, flip):
    g, _, gt, dg = graphs
    rng = np.random.default_rng(3)
    puv = rng.standard_normal((g.num_nodes, 2 * D)).astype(np.float32)
    be = rng.standard_normal((g.num_edges, D)).astype(np.float32)
    z_p = jmsg.fused_score_gate(gt, flip, gt.pad_nodes(puv),
                                jmsg.pack_edges(_jax_slots(gt, be)))
    ref = _jax_host(gt, jmsg.unpack_edges(z_p), g.num_edges)
    z = score_gate(dg, flip, torch.from_numpy(puv),
                   dg.edges_to_slots(torch.from_numpy(be)))
    np.testing.assert_allclose(dg.slots_to_edges(z).numpy(), ref, **EDGE_TOL)


@pytest.mark.parametrize("flip", [False, True])
def test_k6_plain_vs_pallas_on_column_slices(graphs, flip):
    """``puv`` and ``be`` as column slices of wider arrays (row-strided, as
    the card kernel takes them) against JAX ``fused_score_gate``."""
    g, _, gt, dg = graphs
    rng = np.random.default_rng(16)
    puv_w = rng.standard_normal((g.num_nodes, 2 * D + 5)).astype(np.float32)
    be_w = rng.standard_normal((g.num_edges, D + 3)).astype(np.float32)
    puv, be = puv_w[:, :2 * D], be_w[:, :D]
    z_p = jmsg.fused_score_gate(gt, flip, gt.pad_nodes(puv),
                                jmsg.pack_edges(_jax_slots(gt, be)))
    ref = _jax_host(gt, jmsg.unpack_edges(z_p), g.num_edges)
    t_puv = torch.from_numpy(puv_w)[:, :2 * D]
    t_be = dg.edges_to_slots(torch.from_numpy(be_w))[:, :D]
    assert not t_puv.is_contiguous() and not t_be.is_contiguous()
    z = score_gate(dg, flip, t_puv, t_be)
    np.testing.assert_allclose(dg.slots_to_edges(z).numpy(), ref, **EDGE_TOL)


@pytest.mark.parametrize("flip", [False, True])
def test_k7_plain_vs_pallas_k7_gate_stats(graphs, flip):
    """K7's plain version against the Pallas K7 (interpret mode) on the
    windowed plan: its per-tile rows summed, plus the overflow-tail edges,
    which the Pallas kernel leaves out, added as the JAX caller adds them
    (gnnome_tpu/ops/message.py:417-430).  The JAX side sums in float32:
    ``rtol=1e-5, atol=1e-5``."""
    from gnnome_tpu.ops.pallas_kernels import k7_gate_stats

    g, _, gt, dg = graphs
    plan = gt.wplan_flip if flip else gt.wplan
    assert plan.n_ovf > 0                                   # overflow tail
    rng = np.random.default_rng(15)
    n, E, d = g.num_nodes, g.num_edges, D
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    proj_u, proj_v, b3e = f(n, 2 * d), f(n, 2 * d), f(E, d)

    pu, pv = gt.pad_nodes(proj_u), gt.pad_nodes(proj_v)
    b3e_p = jmsg.pack_edges(_jax_slots(gt, b3e))
    stats = k7_gate_stats(plan, pu, pv, b3e_p)
    s = stats.reshape(plan.n_tiles, 8, 2 * d).sum(axis=0)[0]
    u_idx, v_idx = (gt.dst, gt.src) if flip else (gt.src, gt.dst)
    uo, vo = jmsg._ovf_idx(plan, u_idx), jmsg._ovf_idx(plan, v_idx)
    x_o = ((jnp.take(pu, uo, axis=0)[:, :d] + jnp.take(pv, vo, axis=0)[:, :d])
           + jmsg._ovf_take(plan, b3e_p, d))
    xf_o = x_o * plan.ovf_mask
    assert float(jnp.abs(xf_o).sum()) > 0                   # the tail counts
    ref = np.concatenate([np.asarray(s[:d] + xf_o.sum(axis=0)),
                          np.asarray(s[d:] + (xf_o * x_o).sum(axis=0))])

    u, v, _, _ = dg.roles(flip)
    t_u, t_v = torch.from_numpy(proj_u), torch.from_numpy(proj_v)
    got = K.k7_gate_stats_plain(u, v, t_u[:, :d], t_v[:, :d],
                                dg.edges_to_slots(torch.from_numpy(b3e)))
    assert got.dtype == torch.float64 and got.shape == (2 * d,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_device_graph_layout(graphs):
    """Slot order is JAX's stable dst sort; both CSRs list each node's edges
    in slot order."""
    g, gt, _, dg = graphs
    E, N = g.num_edges, g.num_nodes
    np.testing.assert_array_equal(dg.eid_of_slot.numpy(),
                                  gt.host("eid_of_slot")[:E])
    np.testing.assert_array_equal(dg.dst.numpy(), gt.host("dst")[:E])
    src, dst = dg.src.numpy(), dg.dst.numpy()
    sp, perm, dp = dg.src_ptr.numpy(), dg.src_perm.numpy(), dg.dst_ptr.numpy()
    for i in range(0, N, 37):
        np.testing.assert_array_equal(np.arange(dp[i], dp[i + 1]),
                                      np.nonzero(dst == i)[0])
        np.testing.assert_array_equal(perm[sp[i]:sp[i + 1]],
                                      np.nonzero(src == i)[0])
    assert all(t.dtype == torch.int32 for t in
               (dg.src, dg.dst, dg.slot_of_eid, dg.eid_of_slot, dg.dst_ptr,
                dg.src_perm, dg.src_ptr))


@pytest.mark.parametrize("flip", [False, True])
def test_device_graph_partner_arrays(graphs, flip):
    """Each role's CSR-order partner array (what K3 and K8 read) against
    numpy: node i's entries list the other endpoint of its edges in that
    role, in slot order, and ``nbr[k]`` is the partner of slot ``perm[k]``."""
    g, _, _, dg = graphs
    N = g.num_nodes
    src, dst = np.asarray(g.src), np.asarray(g.dst)
    order = np.argsort(dst, kind="stable")          # slot order
    src_s, dst_s = src[order], dst[order]
    u_np, v_np = (dst_s, src_s) if flip else (src_s, dst_s)
    u_idx, v_idx, v_csr, u_csr = dg.roles(flip)
    np.testing.assert_array_equal(u_idx.numpy(), u_np)
    np.testing.assert_array_equal(v_idx.numpy(), v_np)
    for (ptr, perm, nbr), node_of, partner_of in ((v_csr, v_np, u_np),
                                                  (u_csr, u_np, v_np)):
        assert nbr.dtype == torch.int32 and nbr.shape == (g.num_edges,)
        ptr, nbr = ptr.numpy(), nbr.numpy()
        slots = np.arange(g.num_edges) if perm is None else perm.numpy()
        np.testing.assert_array_equal(nbr, partner_of[slots])
        for i in range(0, N, 23):
            mine = np.nonzero(node_of == i)[0]       # slot order
            np.testing.assert_array_equal(nbr[ptr[i]:ptr[i + 1]],
                                          partner_of[mine])


def test_wrappers_count_only_kernel_launches(graphs):
    """On the CPU the wrappers take the plain versions: no launch counted,
    through the eval stage and a training forward and backward alike."""
    g, _, _, dg = graphs
    K.reset_launch_counts()
    _port(g, dg, _inputs(g, seed=4)[0], flip=False)
    t = {k: torch.from_numpy(v).requires_grad_()
         for k, v in _train_inputs(g, seed=4).items()}
    e_out, sum_v, sum_u, _, _ = train_edge_stage(
        dg, False, t["h"], t["w_uv"], t["b_uv"], t["w3"], t["b3"],
        dg.edges_to_slots(t["e"]), t["gamma"], t["beta"])
    z = score_gate(dg, False, sum_v, e_out)
    (z.sum() + sum_u.sum()).backward()
    assert K.launch_counts() == {name: 0 for name in K.KERNELS}
    assert set(K.KERNELS) == {"k1_gather_gate", "k2_aggregate",
                              "k3_edge_stage", "k6_score_gate",
                              "k7_gate_stats", "k8_train_layer_bwd",
                              "k9_aggregate"}


# ------------------------------------------------------- training functions
def _train_inputs(g, seed, d=D):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(h=f(g.num_nodes, d), w_uv=f(d, 4 * d) * 0.5,
                b_uv=f(4 * d) * 0.1, w3=f(d, d) * 0.5, b3=f(d) * 0.1,
                e=f(g.num_edges, d),
                gamma=rng.uniform(0.5, 1.5, d).astype(np.float32),
                beta=f(d) * 0.1)


def _jax_train_stage(gt, a, flip):
    """JAX ``fused_train_stage`` (Pallas, interpret mode) as a function of
    (h, w_uv, b_uv, w3, b3, e [Ep, d] slot order, gamma, beta)."""
    def fn(h, w_uv, b_uv, w3, b3, e_slots, gamma, beta):
        zero = jnp.zeros_like(w3)
        wbd = jnp.concatenate([jnp.concatenate([w3, zero], axis=1),
                               jnp.concatenate([zero, w3], axis=1)], axis=0)
        e_out_p, sum_v, sum_u, mean, var = jmsg.fused_train_stage(
            gt, h, w_uv, b_uv, wbd, jnp.concatenate([b3, b3]),
            jmsg.pack_edges(e_slots), gamma, beta, flip=flip)
        return jmsg.unpack_edges(e_out_p), sum_v, sum_u, mean, var

    args = (gt.pad_nodes(a["h"]), a["w_uv"], a["b_uv"], a["w3"], a["b3"],
            _jax_slots(gt, a["e"]), a["gamma"], a["beta"])
    return fn, tuple(jnp.asarray(x) for x in args)


@pytest.mark.parametrize("d", [D, 160])
@pytest.mark.parametrize("flip", [False, True])
def test_train_edge_stage_vs_pallas_fused_train_stage(graphs, flip, d):
    """Forward outputs, batch statistics and the VJP against h, w_uv, b_uv,
    B3, e, gamma and beta under seeded random cotangents (real edges and
    nodes only; JAX's padded rows get zero cotangents).  d = 160 is a width
    the card path takes in two column chunks."""
    g, _, gt, dg = graphs
    assert (gt.wplan_flip if flip else gt.wplan).n_ovf > 0   # overflow tail
    n, E = g.num_nodes, g.num_edges
    a = _train_inputs(g, seed=10, d=d)
    rng = np.random.default_rng(11)
    d_eo = rng.standard_normal((E, d)).astype(np.float32)
    d_sv = rng.standard_normal((n, 2 * d)).astype(np.float32)
    d_su = rng.standard_normal((n, 2 * d)).astype(np.float32)

    fn, args = _jax_train_stage(gt, a, flip)
    (e_out, sum_v, sum_u, mean, var), vjp = jax.vjp(fn, *args)
    ref_grads = vjp((_jax_slots(gt, d_eo), gt.pad_nodes(d_sv),
                     gt.pad_nodes(d_su), jnp.zeros_like(mean),
                     jnp.zeros_like(var)))

    t = {k: torch.from_numpy(v).requires_grad_() for k, v in a.items()}
    out = train_edge_stage(dg, flip, t["h"], t["w_uv"], t["b_uv"], t["w3"],
                           t["b3"], dg.edges_to_slots(t["e"]), t["gamma"],
                           t["beta"])
    np.testing.assert_allclose(dg.slots_to_edges(out[0]).detach().numpy(),
                               _jax_host(gt, e_out, E), **FWD_TOL)
    np.testing.assert_allclose(out[1].detach().numpy(),
                               np.asarray(sum_v)[:n], **FWD_TOL)
    np.testing.assert_allclose(out[2].detach().numpy(),
                               np.asarray(sum_u)[:n], **FWD_TOL)
    np.testing.assert_allclose(out[3].numpy(), np.asarray(mean), **STAT_TOL)
    np.testing.assert_allclose(out[4].numpy(), np.asarray(var), **STAT_TOL)
    assert not out[3].requires_grad and not out[4].requires_grad

    torch.autograd.backward(
        out[:3], (dg.edges_to_slots(torch.from_numpy(d_eo)),
                  torch.from_numpy(d_sv), torch.from_numpy(d_su)))
    names = ("h", "w_uv", "b_uv", "w3", "b3", "e", "gamma", "beta")
    for name, ref in zip(names, ref_grads):
        ref = np.asarray(ref)
        if name == "h":
            ref = ref[:n]
        elif name == "e":
            ref = _jax_host(gt, ref, E)
        np.testing.assert_allclose(t[name].grad.numpy(), ref, **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("flip", [False, True])
def test_score_gate_backward_vs_pallas_vjp(graphs, flip):
    """K9's plain version (through ``score_gate``'s backward) against the
    VJP of JAX ``fused_score_gate`` (K9 in interpret mode)."""
    g, _, gt, dg = graphs
    n, E = g.num_nodes, g.num_edges
    rng = np.random.default_rng(12)
    puv = rng.standard_normal((n, 2 * D)).astype(np.float32)
    be = rng.standard_normal((E, D)).astype(np.float32)
    dz = rng.standard_normal((E, D)).astype(np.float32)

    def fn(puv_, be_slots):
        return jmsg.unpack_edges(jmsg.fused_score_gate(
            gt, flip, puv_, jmsg.pack_edges(be_slots)))

    z, vjp = jax.vjp(fn, gt.pad_nodes(puv), _jax_slots(gt, be))
    d_puv, d_be = vjp(_jax_slots(gt, dz))

    tp = torch.from_numpy(puv).requires_grad_()
    tb = torch.from_numpy(be).requires_grad_()
    zt = score_gate(dg, flip, tp, dg.edges_to_slots(tb))
    np.testing.assert_allclose(dg.slots_to_edges(zt).detach().numpy(),
                               _jax_host(gt, z, E), **EDGE_TOL)
    zt.backward(dg.edges_to_slots(torch.from_numpy(dz)))
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(d_puv)[:n],
                               **SUM_TOL)
    np.testing.assert_allclose(tb.grad.numpy(), _jax_host(gt, d_be, E),
                               **EDGE_TOL)


@pytest.fixture(scope="module")
def tiny():
    g, _, _, _ = synthetic_assembly_graph(n_reads=6, genome_len=1500,
                                          read_len=400, seed=3)
    assert 0 < g.num_edges < 100
    return g, DeviceGraph.from_graph(g)


@pytest.mark.parametrize("flip", [False, True])
def test_train_edge_stage_gradcheck(tiny, flip):
    """Float64 finite differences through the batch statistics, K3, K8 and
    the node-space chain, all three differentiable outputs."""
    g, dg = tiny
    rng = np.random.default_rng(13)
    d = 3

    def f(*s):
        return torch.tensor(rng.standard_normal(s), dtype=torch.float64,
                            requires_grad=True)

    args = (f(g.num_nodes, d), f(d, 4 * d), f(4 * d), f(d, d), f(d),
            f(g.num_edges, d), f(d), f(d))
    assert torch.autograd.gradcheck(
        lambda *a: train_edge_stage(dg, flip, *a)[:3], args, eps=1e-6,
        atol=1e-5)


@pytest.mark.parametrize("flip", [False, True])
def test_score_gate_gradcheck(tiny, flip):
    g, dg = tiny
    rng = np.random.default_rng(14)
    puv = torch.tensor(rng.standard_normal((g.num_nodes, 6)),
                       dtype=torch.float64, requires_grad=True)
    be = torch.tensor(rng.standard_normal((g.num_edges, 3)),
                      dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda p, b: score_gate(dg, flip, p, b), (puv, be), eps=1e-6,
        atol=1e-5)
