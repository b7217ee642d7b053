"""K3 / K6 of gnnome_tpu_torch against the JAX functions they replace.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held against ``gnnome_tpu.ops.message.fused_eval_edge_stage`` and
``fused_score_gate`` (Pallas kernels in interpret mode, windowed plans with an
overflow tail) and against the JAX package's XLA edge-stage ops, at both
flips and narrow width.  The JAX side runs on padded, packed, re-slotted
arrays; the comparison is in host edge order (through each side's
``eid_of_slot``/``slot_of_eid``) and on the first N node rows.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py.

Tolerances: edge outputs ``atol=1e-5`` (the same elementwise arithmetic;
the JAX interpret path runs its row selects as f32 one-hot matmuls at
HIGHEST precision), node sums ``rtol=1e-5, atol=1e-5`` (sums of ~30 terms in
another order).
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

from gnnome_tpu_torch.ops import DeviceGraph, eval_edge_stage, score_gate
from gnnome_tpu_torch.ops import kernels as K

TILE, WIN, D = 128, 128, 16
EDGE_TOL = dict(rtol=0, atol=1e-5)
SUM_TOL = dict(rtol=1e-5, atol=1e-5)


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


@pytest.mark.parametrize("flip", [False, True])
def test_k3_plain_vs_xla_edge_stage(graphs, flip):
    """Against the JAX package's unfused XLA ops: fused_gate_gather ->
    eval batch_norm -> relu -> residual -> sigmoid -> gated_mean_pair."""
    g, gt, _, dg = graphs
    a, var = _inputs(g, seed=2)
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
    d = D
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


def test_wrappers_count_only_kernel_launches(graphs):
    """On the CPU the wrappers take the plain versions: no launch counted."""
    g, _, _, dg = graphs
    K.reset_launch_counts()
    _port(g, dg, _inputs(g, seed=4)[0], flip=False)
    assert K.launch_counts() == {"k3_edge_stage": 0, "k6_score_gate": 0}
