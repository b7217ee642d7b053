"""The layer-norm and norm-free SymGatedGCN of gnnome_tpu_torch (CPU: the
plain versions of K1 and K2) against the JAX package's unfused path.

* K1 and K2 through ``gate_gather`` / ``aggregate`` / ``gated_mean_pair``
  against JAX ``fused_gate_gather``, ``_aggregate_pallas`` and
  ``gated_mean_pair`` (Pallas in interpret mode on windowed plans with an
  overflow tail, and XLA), both flips, Dp = 2d and d.
* The backwards of the three autograd Functions against ``jax.vjp`` of
  ``fused_gate_gather``, ``gated_mean_pair`` and ``gather_uv_planned``
  (backend ``pallas``) under seeded cotangents, and
  ``torch.autograd.gradcheck`` in float64, as also the float32 layers'
  ``unfused_edge_stage`` (K1, the layer-norm edge stage and K2 in one
  Function), which is held besides to the autograd chain it replaced,
  forward and every gradient, with LayerNorm and norm-free.
* The model's eval logits against JAX ``forward`` (Pallas interpret and
  XLA), one symmetry-loss training step's loss and gradients against
  ``jax.value_and_grad`` of the JAX loss, ``cli train`` with a bitwise
  resume, models shared by the two packages, weight conversion.

Inputs are made with numpy from seeds, at the ``graphs`` fixture's size of
tests/test_torch_kernels.py (300 reads, d=16, 2-3 layers).  Tolerances:
edge outputs ``atol=1e-5`` (the same adds; the JAX interpret path selects
rows with f32 one-hot matmuls); node sums ``rtol=atol=1e-5`` (sums of ~30
terms in another order); backwards and training gradients ``atol=2e-4,
rtol=5e-3`` (tests/test_pallas_k4.py:81); logits ``atol=2e-5, rtol=1e-4``
(tests/test_model_parity.py:76); the step's loss ``atol=5e-5, rtol=1e-4``
(tests/test_pallas_k4.py:55); the edge-stage Function's gradients against
the chain ``rtol=1e-4, atol=1e-5`` (the LayerNorm adjoint in closed form,
float32 rounding; its forward is the chain's operations, bit for bit).
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnome_tpu.config import Config as JaxConfig
from gnnome_tpu.config import ModelConfig as JaxModelConfig
from gnnome_tpu.graphs import synthetic_assembly_graph as jax_synthetic
from gnnome_tpu.models import edge_features, node_features
from gnnome_tpu.models.checkpoint import load_model_weights as jax_load_weights
from gnnome_tpu.models.sym_gated_gcn import forward, init_params
from gnnome_tpu.ops import GraphTensors
from gnnome_tpu.ops import message as jmsg
from gnnome_tpu.ops.graph_tensors import with_windowed_plans
from gnnome_tpu.ops.pallas_kernels import set_interpret
from gnnome_tpu.train import step as jax_step
from gnnome_tpu.train.loss import symmetry_loss as jax_symmetry_loss

from gnnome_tpu_torch import cli
from gnnome_tpu_torch.config import Config, ModelConfig
from gnnome_tpu_torch.graphs import synthetic_assembly_graph
from gnnome_tpu_torch.models import (SymGatedGCN, load_model_weights,
                                     module_state_from_numpy,
                                     numpy_from_module_state)
from gnnome_tpu_torch.models.norm import LN_EPS, apply_norm, layer_norm
from gnnome_tpu_torch.ops import (DeviceGraph, aggregate, gate_gather,
                                  gated_mean_pair, gather_uv,
                                  unfused_edge_stage)
from gnnome_tpu_torch.ops import kernels as K
from gnnome_tpu_torch.ops import message as tmsg
from gnnome_tpu_torch.train.step import (make_example, make_optimizer,
                                         train_step)

TILE, WIN, D = 128, 128, 16
EDGE_TOL = dict(rtol=0, atol=1e-5)
SUM_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=5e-3, atol=2e-4)
LOGIT_TOL = dict(rtol=1e-4, atol=2e-5)
LOSS_TOL = dict(rtol=1e-4, atol=5e-5)
STAGE_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
EPS = 1e-6


@pytest.fixture(autouse=True)
def _interpret_mode():
    set_interpret(True)
    yield
    set_interpret(False)


@pytest.fixture(scope="module")
def graphs():
    """The graph of tests/test_torch_kernels.py: both windowed plans carry an
    overflow tail (15% false edges)."""
    g, _, _, _ = jax_synthetic(n_reads=300, genome_len=20000, read_len=400,
                               seed=70, with_sequences=True,
                               false_edge_frac=0.15)
    gt = GraphTensors.from_graph(g, TILE, WIN)
    gt_w = with_windowed_plans(gt, flip_too=True, tile_e=TILE, window=WIN)
    assert gt_w.wplan.n_ovf > 0 and gt_w.wplan_flip.n_ovf > 0
    return g, {"xla": gt, "pallas": gt_w}, DeviceGraph.from_graph(g)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _jax_slots(gt, host_rows):
    """Host-order [E, D] -> the JAX side's padded slot order [Ep, D]."""
    return gt.edges_to_slots(gt.pad_edges(host_rows))


def _jax_host(gt, slot_rows, n_edges):
    return np.asarray(gt.slots_to_edges(slot_rows))[:n_edges]


def _port_host(dg, slot_rows):
    return dg.slots_to_edges(slot_rows).detach().numpy()


# ------------------------------------------------------------- K1 and K2
@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("flip", [False, True])
def test_k1_plain_vs_fused_gate_gather(graphs, flip, backend):
    g, gts, dg = graphs
    gt = gts[backend]
    rng = np.random.default_rng(20)
    proj = _f32(rng, g.num_nodes, 5 * D)
    b3e = _f32(rng, g.num_edges, D)
    ref = jmsg.fused_gate_gather(
        gt, gt.pad_nodes(proj[:, :2 * D]), gt.pad_nodes(proj[:, 2 * D:4 * D]),
        _jax_slots(gt, b3e), flip=flip, backend=backend)
    tp = torch.from_numpy(proj)
    g3 = gate_gather(dg, flip, tp[:, :2 * D], tp[:, 2 * D:4 * D],
                     dg.edges_to_slots(torch.from_numpy(b3e)))
    got = _port_host(dg, g3)
    for i, r in enumerate(ref):
        np.testing.assert_allclose(got[:, i * D:(i + 1) * D],
                                   _jax_host(gt, r, g.num_edges), **EDGE_TOL)


@pytest.mark.parametrize("width", [2 * D, D])
@pytest.mark.parametrize("flip", [False, True])
def test_k2_plain_vs_pallas_aggregate(graphs, flip, width):
    g, gts, dg = graphs
    gt = gts["pallas"]
    rng = np.random.default_rng(21)
    pay_u, pay_v = (_f32(rng, g.num_edges, width) for _ in range(2))
    u_idx, v_idx = (gt.dst, gt.src) if flip else (gt.src, gt.dst)
    plan = gt.wplan_flip if flip else gt.wplan
    sum_u, sum_v = jmsg._aggregate_pallas(plan, u_idx, v_idx,
                                          _jax_slots(gt, pay_u),
                                          _jax_slots(gt, pay_v))
    got_u, got_v = aggregate(dg, flip,
                             dg.edges_to_slots(torch.from_numpy(pay_u)),
                             dg.edges_to_slots(torch.from_numpy(pay_v)))
    n = g.num_nodes
    np.testing.assert_allclose(got_u.numpy(), np.asarray(sum_u)[:n],
                               **SUM_TOL)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(sum_v)[:n],
                               **SUM_TOL)


def _mean_inputs(g, seed):
    rng = np.random.default_rng(seed)
    sigma = rng.uniform(0.0, 1.0, (g.num_edges, D)).astype(np.float32)
    return sigma, _f32(rng, g.num_edges, D), _f32(rng, g.num_edges, D)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("flip", [False, True])
def test_gated_mean_pair_vs_jax(graphs, flip, backend):
    g, gts, dg = graphs
    gt = gts[backend]
    sigma, a2h, a3h = _mean_inputs(g, 22)
    ref = jmsg.gated_mean_pair(gt, _jax_slots(gt, sigma), _jax_slots(gt, a2h),
                               _jax_slots(gt, a3h), flip=flip, eps=EPS,
                               backend=backend)
    t = [dg.edges_to_slots(torch.from_numpy(a)) for a in (sigma, a2h, a3h)]
    got = gated_mean_pair(dg, flip, *t, EPS)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:g.num_nodes],
                                   **SUM_TOL)


def test_wrappers_take_plain_versions_on_cpu(graphs):
    """CPU tensors run the plain versions: no K1 or K2 launch is counted,
    forward or backward."""
    g, _, dg = graphs
    rng = np.random.default_rng(23)
    h = torch.from_numpy(_f32(rng, g.num_nodes, 4 * D)).requires_grad_()
    b3e = torch.from_numpy(_f32(rng, g.num_edges, D)).requires_grad_()
    K.reset_launch_counts()
    g3 = gate_gather(dg, False, h[:, :2 * D], h[:, 2 * D:], b3e)
    h_fwd, h_bwd = gated_mean_pair(dg, False, torch.sigmoid(g3[:, :D]),
                                   g3[:, D:2 * D], g3[:, 2 * D:], EPS)
    h_u, h_v = gather_uv(dg, True, h_fwd + h_bwd)
    (h_u.sum() + (h_v * h_v).sum()).backward()
    assert K.launch_counts() == {name: 0 for name in K.KERNELS}
    assert h.grad is not None and b3e.grad is not None


# -------------------------------------------------------------- backwards
def _close_on_real(got, ref, n_rows, what):
    np.testing.assert_allclose(got, np.asarray(ref)[:n_rows], **GRAD_TOL,
                               err_msg=what)


@pytest.mark.parametrize("flip", [False, True])
def test_gate_gather_backward_vs_pallas_vjp(graphs, flip):
    g, gts, dg = graphs
    gt = gts["pallas"]
    n, E = g.num_nodes, g.num_edges
    rng = np.random.default_rng(24)
    pu, pv, b3e = _f32(rng, n, 2 * D), _f32(rng, n, 2 * D), _f32(rng, E, D)
    d_g3 = _f32(rng, E, 3 * D)

    def fn(pu_, pv_, b3e_):
        return jmsg.fused_gate_gather(gt, pu_, pv_, b3e_, flip=flip,
                                      backend="pallas")

    _, vjp = jax.vjp(fn, gt.pad_nodes(pu), gt.pad_nodes(pv),
                     _jax_slots(gt, b3e))
    ref = vjp(tuple(_jax_slots(gt, d_g3[:, i * D:(i + 1) * D])
                    for i in range(3)))
    t = [torch.from_numpy(a).requires_grad_() for a in (pu, pv, b3e)]
    g3 = gate_gather(dg, flip, t[0], t[1], dg.edges_to_slots(t[2]))
    g3.backward(dg.edges_to_slots(torch.from_numpy(d_g3)))
    _close_on_real(t[0].grad.numpy(), ref[0], n, "proj_u")
    _close_on_real(t[1].grad.numpy(), ref[1], n, "proj_v")
    np.testing.assert_allclose(t[2].grad.numpy(), _jax_host(gt, ref[2], E),
                               **GRAD_TOL, err_msg="b3e")


@pytest.mark.parametrize("flip", [False, True])
def test_gated_mean_pair_backward_vs_pallas_vjp(graphs, flip):
    g, gts, dg = graphs
    gt = gts["pallas"]
    n, E = g.num_nodes, g.num_edges
    sigma, a2h, a3h = _mean_inputs(g, 25)
    rng = np.random.default_rng(26)
    d_fwd, d_bwd = _f32(rng, n, D), _f32(rng, n, D)

    def fn(s, a2, a3):
        return jmsg.gated_mean_pair(gt, s, a2, a3, flip=flip, eps=EPS,
                                    backend="pallas")

    _, vjp = jax.vjp(fn, *(_jax_slots(gt, a) for a in (sigma, a2h, a3h)))
    ref = vjp((gt.pad_nodes(d_fwd), gt.pad_nodes(d_bwd)))
    t = [torch.from_numpy(a).requires_grad_() for a in (sigma, a2h, a3h)]
    got = gated_mean_pair(dg, flip, *(dg.edges_to_slots(x) for x in t), EPS)
    torch.autograd.backward(got, (torch.from_numpy(d_fwd),
                                  torch.from_numpy(d_bwd)))
    for name, x, r in zip(("sigma", "a2h_u", "a3h_v"), t, ref):
        np.testing.assert_allclose(x.grad.numpy(), _jax_host(gt, r, E),
                                   **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("flip", [False, True])
def test_gather_uv_backward_vs_pallas_vjp(graphs, flip):
    g, gts, dg = graphs
    gt = gts["pallas"]
    n, E = g.num_nodes, g.num_edges
    rng = np.random.default_rng(27)
    h, d_u, d_v = _f32(rng, n, D), _f32(rng, E, D), _f32(rng, E, D)
    (hu, hv), vjp = jax.vjp(
        lambda x: jmsg.gather_uv_planned(gt, flip, x, backend="pallas"),
        gt.pad_nodes(h))
    (ref,) = vjp((_jax_slots(gt, d_u), _jax_slots(gt, d_v)))
    th = torch.from_numpy(h).requires_grad_()
    got = gather_uv(dg, flip, th)
    np.testing.assert_array_equal(_port_host(dg, got[0]),
                                  _jax_host(gt, hu, E))
    np.testing.assert_array_equal(_port_host(dg, got[1]),
                                  _jax_host(gt, hv, E))
    torch.autograd.backward(got, tuple(dg.edges_to_slots(torch.from_numpy(a))
                                       for a in (d_u, d_v)))
    _close_on_real(th.grad.numpy(), ref, n, "h")


@pytest.fixture(scope="module")
def tiny():
    g, _, _, _ = synthetic_assembly_graph(n_reads=6, genome_len=1500,
                                          read_len=400, seed=3)
    assert 0 < g.num_edges < 100
    return g, DeviceGraph.from_graph(g)


@pytest.mark.parametrize("op", ["gate_gather", "gated_mean_pair",
                                "gather_uv", "unfused_edge_stage",
                                "unfused_edge_stage_none"])
@pytest.mark.parametrize("flip", [False, True])
def test_unfused_functions_gradcheck(tiny, flip, op):
    """Float64 finite differences through K1's and K2's plain versions and
    the layer-norm edge stage's (with LayerNorm, and norm-free)."""
    g, dg = tiny
    rng = np.random.default_rng(28)
    n, E, d = g.num_nodes, g.num_edges, 3

    def f(*s):
        return torch.tensor(rng.standard_normal(s), dtype=torch.float64,
                            requires_grad=True)

    if op == "gate_gather":
        fn, args = (lambda a, b, c: gate_gather(dg, flip, a, b, c),
                    (f(n, 2 * d), f(n, 2 * d), f(E, d)))
    elif op == "unfused_edge_stage":
        def fn(pu, pv, b3e, e, w, b):
            return unfused_edge_stage(dg, flip, pu, pv, b3e, e, w, b, LN_EPS)
        args = (f(n, 2 * d), f(n, 2 * d), f(E, d), f(E, d), f(d), f(d))
    elif op == "unfused_edge_stage_none":
        def fn(pu, pv, b3e, e):
            return unfused_edge_stage(dg, flip, pu, pv, b3e, e, None, None,
                                      LN_EPS)
        args = (f(n, 2 * d), f(n, 2 * d), f(E, d), f(E, d))
    elif op == "gated_mean_pair":
        def fn(s, a, b):
            return gated_mean_pair(dg, flip, torch.sigmoid(s), a, b, EPS)
        args = (f(E, d), f(E, d), f(E, d))
    else:
        fn, args = (lambda h: gather_uv(dg, flip, h), (f(n, d),))
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-5)


# ------------------------------------------ the float32 edge-stage Function
def _edge_stage_chain(dg, flip, pu, pv, b3e, e, ln):
    """The unfused layer's edge stage as the PyTorch chain the bf16 route
    keeps: ``gate_gather``, ``apply_norm``, relu, residual, sigmoid,
    ``gated_mean_pair``."""
    d = e.shape[1]
    g3 = gate_gather(dg, flip, pu, pv, b3e)
    e_out = torch.relu(apply_norm(ln, g3[:, :d])) + e
    return (e_out, *gated_mean_pair(dg, flip, torch.sigmoid(e_out),
                                    g3[:, d:2 * d], g3[:, 2 * d:], EPS))


def _edge_stage_function(dg, flip, pu, pv, b3e, e, ln):
    """The same through ``unfused_edge_stage``, the gated means divided as
    the layer divides them."""
    d = e.shape[1]
    e_out, sum_u, sum_v = unfused_edge_stage(
        dg, flip, pu, pv, b3e, e, None if ln is None else ln.weight,
        None if ln is None else ln.bias, LN_EPS)
    return (e_out, sum_v[:, :d] / (sum_v[:, d:] + EPS),
            sum_u[:, :d] / (sum_u[:, d:] + EPS))


@pytest.mark.parametrize("norm", ["layer", "none"])
@pytest.mark.parametrize("flip", [False, True])
def test_unfused_edge_stage_vs_chain(graphs, flip, norm):
    """The Function through the plain versions of K1, the layer-norm edge
    stage, K2 and the stage's adjoint against the autograd chain it
    replaces: e_out and the gated means bit for bit (the same operations),
    every gradient (proj_u, proj_v, b3e, e, the LayerNorm weight and bias)
    within ``STAGE_GRAD_TOL`` (the LayerNorm adjoint in its closed form,
    float32 rounding), under seeded cotangents."""
    g, _, dg = graphs
    n, E = g.num_nodes, g.num_edges
    rng = np.random.default_rng(29)
    inputs = [_f32(rng, *s) for s in ((n, 2 * D), (n, 2 * D), (E, D),
                                      (E, D))]
    cots = [torch.from_numpy(_f32(rng, *s)) for s in ((E, D), (n, D),
                                                      (n, D))]
    ln = None
    if norm == "layer":
        ln = torch.nn.LayerNorm(D)
        with torch.no_grad():
            ln.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, D)))
            ln.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, D)))
    runs = []
    for fn in (_edge_stage_chain, _edge_stage_function):
        t = [torch.from_numpy(a).requires_grad_() for a in inputs]
        if ln is not None:
            ln.zero_grad()
        out = fn(dg, flip, *t, ln)
        torch.autograd.backward(out, cots)
        grads = [x.grad for x in t]
        if ln is not None:
            grads += [ln.weight.grad.clone(), ln.bias.grad.clone()]
        runs.append(([o.detach() for o in out], grads))
    (out0, g0), (out1, g1) = runs
    for a, b in zip(out0, out1):
        assert torch.equal(a, b)
    names = ["proj_u", "proj_v", "b3e", "e", "weight", "bias"]
    for name, a, b in zip(names, g1, g0):
        torch.testing.assert_close(a, b, **STAGE_GRAD_TOL, msg=name)


def test_unfused_edge_stage_takes_float32_route_only(monkeypatch, graphs):
    """A float32 layer-norm layer runs the Function (its K1 and K2 calls are
    its own), a bf16 one the chain: the layer chooses by K1's operands."""
    g, _, dg = graphs
    layer = SymGatedGCN.from_config(ModelConfig(
        **{**SMALL, "normalization": "layer"})).gnn.convs[0]
    rng = np.random.default_rng(30)
    h = torch.from_numpy(_f32(rng, g.num_nodes, D))
    e = torch.from_numpy(_f32(rng, g.num_edges, D))
    seen = []
    real = tmsg.k2_aggregate

    def k2(*a):
        seen.append(sys._getframe(1).f_code.co_qualname)
        return real(*a)

    monkeypatch.setattr(tmsg, "k2_aggregate", k2)
    with torch.inference_mode():
        layer(dg, h, e, False)
        layer(dg, h.bfloat16(), e.bfloat16(), False, dtype=torch.bfloat16)
    assert seen == ["_UnfusedEdgeStage.forward", "_Aggregate.forward"]


# ------------------------------------------------------------------ model
SMALL = dict(num_gnn_layers=3, dim_latent=D, hidden_edge_scores=D,
             dropout=0.0)


def _jax_params(norm, seed=4, **kw):
    cfg = JaxModelConfig(**{**SMALL, **kw, "normalization": norm})
    return jax.tree_util.tree_map(np.asarray,
                                  init_params(jax.random.PRNGKey(seed), cfg))


def _port_model(params, state, norm, **kw):
    m = SymGatedGCN.from_config(ModelConfig(**{**SMALL, **kw,
                                               "normalization": norm}))
    m.load_state_dict(module_state_from_numpy(params, state, norm))
    return m


def _jitter_norms(params, seed):
    """Non-trivial norm scale/bias (init is 1 and 0)."""
    rng = np.random.default_rng(seed)
    for bn in ("bn_h", "bn_e"):
        p = params["gnn"][bn]
        p["scale"] = rng.uniform(0.5, 1.5, p["scale"].shape).astype(np.float32)
        p["bias"] = rng.normal(0, 0.1, p["bias"].shape).astype(np.float32)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("norm", ["layer", "none"])
def test_eval_logits_vs_jax(graphs, norm, flip, backend):
    g, gts, dg = graphs
    gt = gts[backend]
    params, state = _jax_params(norm)
    _jitter_norms(params, 5)
    x, e = node_features(g, reverse=flip), edge_features(g)
    ref, _ = forward(params, state, gt, gt.pad_nodes(x), gt.pad_edges(e),
                     JaxModelConfig(**SMALL, normalization=norm),
                     training=False, flip=flip, backend=backend)
    model = _port_model(params, state, norm)
    with torch.inference_mode():
        got = model(dg, torch.from_numpy(x), torch.from_numpy(e), flip=flip)
    np.testing.assert_allclose(got.numpy()[:, 0],
                               np.asarray(ref)[:g.num_edges, 0], **LOGIT_TOL)


def test_eval_logits_vs_jax_at_d96(graphs):
    """The layer-norm model at d = 96, whose gated means are K2 sums of
    width 192 (two column chunks on the card), against the JAX forward
    (Pallas, interpret mode)."""
    g, gts, dg = graphs
    gt = gts["pallas"]
    wide = dict(dim_latent=96, hidden_edge_scores=96)
    params, state = _jax_params("layer", **wide)
    _jitter_norms(params, 5)
    x, e = node_features(g), edge_features(g)
    ref, _ = forward(params, state, gt, gt.pad_nodes(x), gt.pad_edges(e),
                     JaxModelConfig(**{**SMALL, **wide,
                                       "normalization": "layer"}),
                     training=False, flip=False, backend="pallas")
    model = _port_model(params, state, "layer", **wide)
    with torch.inference_mode():
        got = model(dg, torch.from_numpy(x), torch.from_numpy(e))
    np.testing.assert_allclose(got.numpy()[:, 0],
                               np.asarray(ref)[:g.num_edges, 0], **LOGIT_TOL)


def test_layer_norm_vs_torch_layer_norm():
    """The explicit form agrees with ``F.layer_norm`` (both float32)."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(1.0, 3.0, (500, D)).astype(np.float32))
    ln = torch.nn.LayerNorm(D)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, D)))
        ln.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, D)))
        torch.testing.assert_close(layer_norm(ln, x), ln(x), rtol=1e-5,
                                   atol=1e-5)


# ------------------------------------------------------------- train step
@pytest.fixture(scope="module")
def step_data():
    """The train-step recipe of tests/test_torch_train.py (random edge
    features and labels, masking off), 2 layers."""
    g, _, _, _ = jax_synthetic(n_reads=200, genome_len=20_000, read_len=900,
                               seed=3, with_sequences=False)
    rng = np.random.default_rng(17)
    e = rng.normal(size=(g.num_edges, 2)).astype(np.float32)
    y = (np.random.default_rng(0).random(g.num_edges) < 0.5
         ).astype(np.float32)
    return g, e, y


def _jax_step_grads(data, params, state, norm, backend, pw):
    g, e, y = data
    cfg = JaxConfig()
    cfg.model = JaxModelConfig(**{**SMALL, "num_gnn_layers": 2,
                                  "normalization": norm})
    cfg.train.masking = False
    cfg.compute.backend = backend
    ex = jax_step.make_example(cfg, g.in_degrees(), g.out_degrees(), e, y,
                               g.src, g.dst, g.num_nodes)

    def loss_fn(p):
        lo, st = forward(p, state, ex.gt, ex.x, ex.e, cfg.model,
                         training=True, flip=False, backend=backend,
                         slot_io=True)
        lr_, _ = forward(p, st, ex.gt, ex.x_rev, ex.e, cfg.model,
                         training=True, flip=True, backend=backend,
                         slot_io=True)
        return jax_symmetry_loss(lo[:, 0], lr_[:, 0], ex.labels, pw,
                                 alpha=cfg.train.alpha, mask=ex.mask)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("norm,backend", [("layer", "pallas"),
                                          ("layer", "xla"),
                                          ("none", "xla")])
def test_symmetry_train_step_vs_jax(step_data, norm, backend):
    """One symmetry-loss step: the loss and every parameter's gradient."""
    g, e, y = step_data
    pw = 1.7
    params, state = _jax_params(norm, seed=5, num_gnn_layers=2)
    _jitter_norms(params, 7)
    loss_ref, g_ref = _jax_step_grads(step_data, params, state, norm,
                                      backend, pw)
    cfg = Config()
    model = _port_model(params, state, norm, num_gnn_layers=2)
    opt = make_optimizer(model, 1e-3)
    ex = make_example(g.in_degrees(), g.out_degrees(), e, y, g.src, g.dst,
                      g.num_nodes, "cpu")
    loss, _ = train_step(model, opt, ex, pw, cfg, None)
    np.testing.assert_allclose(float(loss), loss_ref, **LOSS_TOL)
    ref = module_state_from_numpy(g_ref, state, norm)
    grads = dict(model.named_parameters())
    assert grads.keys() == ref.keys()
    for name, p in grads.items():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   **GRAD_TOL, err_msg=name)


def test_two_cpu_layer_norm_steps_bitwise_equal(step_data):
    g, e, y = step_data
    params, state = _jax_params("layer", seed=5, num_gnn_layers=2)
    cfg = Config()
    runs = []
    for _ in range(2):
        model = _port_model(params, state, "layer", num_gnn_layers=2,
                            dropout=0.2)
        opt = make_optimizer(model, 1e-3)
        ex = make_example(g.in_degrees(), g.out_degrees(), e, y, g.src,
                          g.dst, g.num_nodes, "cpu")
        loss, logits = train_step(model, opt, ex, 1.7, cfg,
                                  torch.Generator().manual_seed(3))
        runs.append((loss, logits, [p.grad for p in model.parameters()],
                     [p.detach() for p in model.parameters()]))
    (l0, lo0, g0, p0), (l1, lo1, g1, p1) = runs
    assert torch.equal(l0, l1) and torch.equal(lo0, lo1)
    assert all(torch.equal(a, b) for a, b in zip(g0 + p0, g1 + p1))


# ------------------------------------------------------ weights, configs
@pytest.mark.parametrize("norm", ["layer", "none"])
def test_convert_round_trips(norm):
    """npz pytrees -> module -> npz pytrees: the model's leaves bit for bit,
    the leaves it lacks at the JAX init values; module -> npz -> module bit
    for bit."""
    params, state = _jax_params(norm)
    _jitter_norms(params, 8)
    sd = module_state_from_numpy(params, state, norm)
    model = _port_model(params, state, norm)
    assert sd.keys() == model.state_dict().keys()
    p2, s2 = numpy_from_module_state(sd)
    leaves = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))  # noqa: E731
    a, b = leaves(params), leaves(p2)
    assert a.keys() == b.keys()
    for k in a:
        bn = "bn_" in jax.tree_util.keystr(k)
        if bn and norm == "none":
            want = np.ones_like(a[k]) if "scale" in str(k) else 0 * a[k]
        else:
            want = a[k]
        np.testing.assert_array_equal(b[k], want, err_msg=str(k))
    for bn in ("bn_h", "bn_e"):
        np.testing.assert_array_equal(s2["gnn"][bn]["mean"], 0.0)
        np.testing.assert_array_equal(s2["gnn"][bn]["var"], 1.0)
        np.testing.assert_array_equal(s2["gnn"][bn]["count"], 0)
    sd2 = module_state_from_numpy(p2, s2, norm)
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)


def test_from_config_normalizations():
    for norm, kind in (("batch", torch.nn.BatchNorm1d),
                       ("layer", torch.nn.LayerNorm)):
        m = SymGatedGCN.from_config(ModelConfig(normalization=norm))
        assert isinstance(m.gnn.convs[0].bn_h, kind)
        assert isinstance(m.gnn.convs[7].bn_e, kind)
        assert m.predictor.fused == (norm == "batch")
    m = SymGatedGCN.from_config(ModelConfig(normalization="none"))
    assert not any("bn_" in k for k in m.state_dict())
    m = SymGatedGCN.from_config(ModelConfig(normalization="layer"))
    m.gnn.convs[0].bn_h.weight.data.fill_(3.0)
    m.init_weights(1)
    assert torch.equal(m.gnn.convs[0].bn_h.weight, torch.ones(64))
    assert torch.equal(m.gnn.convs[0].bn_h.bias, torch.zeros(64))
    from gnnome_tpu_torch.models.zoo import ZOO
    for zoo in ("gatedgcn", "gcn", "gat", "sage"):
        assert type(SymGatedGCN.from_config(ModelConfig(model=zoo))) is ZOO[zoo]
    with pytest.raises(ValueError, match="sym_gatedgcn"):
        SymGatedGCN.from_config(ModelConfig(model="gin"))
    with pytest.raises(ValueError, match="normalization"):
        SymGatedGCN.from_config(ModelConfig(normalization="group"))


# ------------------------------------------------------ cli train, layer
TINY_LAYER = ["--set", "model.num_gnn_layers=2", "--set",
              "model.dim_latent=16", "--set", "model.hidden_edge_scores=16",
              "--set", "model.normalization=layer"]


@pytest.fixture(scope="module")
def trained_layer(tmp_path_factory):
    """``cli train`` of the layer-norm model on a small synthetic dataset:
    masking on, clusters of 200 nodes, symmetry loss, dropout 0.2."""
    root = tmp_path_factory.mktemp("torch_train_layer")
    ds = root / "ds"
    for sub in ("processed", "info"):
        (ds / "hifiasm" / sub).mkdir(parents=True)
    g, reads, _, _ = synthetic_assembly_graph(
        n_reads=300, genome_len=25000, read_len=400, seed=13,
        with_sequences=True)
    g.save(str(ds / "hifiasm" / "processed" / "0.npz"))
    reads.save(str(ds / "hifiasm" / "info" / "0_reads.npz"))
    common = ["--train", str(ds), "--valid", str(ds), "--asm", "hifiasm",
              "--set", "compute.device=cpu",
              "--set", "train.num_nodes_per_cluster=200",
              "--set", f"paths.checkpoints_path={root / 'ckpt'}",
              "--set", f"paths.models_path={root / 'models'}", *TINY_LAYER]

    def run(*extra):
        return cli.main(["train", *common, *extra])

    model_path = run("--name", "t", "--set", "train.num_epochs=1")
    return root, g, run, model_path


def test_cli_train_layer_norm_resume_bitwise(trained_layer):
    """A resumed layer-norm run writes the checkpoint of the run that was
    never interrupted, bit for bit."""
    root, _, run, _ = trained_layer
    with open(root / "ckpt" / "log_t_seed1.jsonl") as f:
        assert [json.loads(line)["epoch"] for line in f] == [0]
    run("--name", "t", "--resume", "--set", "train.num_epochs=2")
    run("--name", "u", "--set", "train.num_epochs=2")
    ckpt = root / "ckpt"
    with np.load(ckpt / "ckpt_t_seed1_resumed-2.npz") as a, \
            np.load(ckpt / "ckpt_u_seed1.npz") as b:
        assert a.files == b.files
        assert "opt/gnn.convs.0.bn_h.weight/exp_avg" in a.files
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k


def test_port_layer_norm_model_scores_the_same_in_jax(trained_layer):
    """The layer-norm model that the port's ``cli train`` saved loads in the
    JAX package; JAX XLA and the port give the same logits."""
    _, g, _, model_path = trained_layer
    params, state = jax_load_weights(model_path)
    kw = dict(num_gnn_layers=2, dim_latent=16, hidden_edge_scores=16,
              normalization="layer")
    gt = GraphTensors.from_graph(g)
    x, e = node_features(g), edge_features(g)
    ref, _ = forward(params, state, gt, gt.pad_nodes(x), gt.pad_edges(e),
                     JaxModelConfig(**kw), training=False, backend="xla")
    m = SymGatedGCN.from_config(ModelConfig(**kw))
    m.load_state_dict(module_state_from_numpy(
        *load_model_weights(model_path), "layer"))
    with torch.inference_mode():
        got = m(DeviceGraph.from_graph(g), torch.from_numpy(x),
                torch.from_numpy(e))
    np.testing.assert_allclose(got.numpy()[:, 0],
                               np.asarray(ref)[:g.num_edges, 0], **LOGIT_TOL)
    assert os.path.isfile(model_path)
