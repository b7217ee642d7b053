"""The bfloat16 compute mode of the layer-norm and norm-free SymGatedGCN
(``compute.dtype=bfloat16`` with ``model.normalization=layer|none``)
against the JAX package's bf16 mode, on the CPU (the plain versions of K1
and K2).

The dtype flow is not "bf16 everywhere": JAX's ``layer_norm`` computes its
statistics in bf16 and multiplies by the float32 scale and bias, so type
promotion makes the layer-norm model float32 from the first layer's norms
on (norm.py:111-115), with bf16-rounded weights promoted against float32
activations; the norm-free model stays bf16.  ``test_dtype_flow`` reads
that flow from both packages.

Inputs are made with numpy from seeds: the small model of
tests/test_torch_bf16.py (3 layers, d=16) on ``synthetic_assembly_graph(
n_reads=300, seed=70)``, and the two-layer train-step recipe of
tests/test_torch_unfused.py.  The JAX side runs its XLA backend (with
``GN_UNROLL_LAYERS=1`` for layer norm: under ``lax.scan`` the bf16 carry
turns float32 in its first layer and the scan refuses it) and its Pallas
backend in interpret mode.  Bounds are those of tests/test_torch_bf16.py:
bf16 values within two bf16 spacings (XLA on the CPU may keep a fused
chain in float32 between its bf16 rounding points); logits max |diff|
< 0.15 x mean |logit| (``LOGIT_REL``); the loss within 0.15 relative;
gradients with cosine > 0.999 and each element within 0.5 x max(|g|, rms
of g), the JAX package's own bounds between its two bf16 backends.  K2's
float32 sums of bf16 payloads are held to float32 reassociation against
``segment_sum`` and bit for bit against a sequential float32 sum, and to
the rounding of the JAX Pallas kernel's bf16 partials against it.
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
from gnnome_tpu.graphs import synthetic_assembly_graph
from gnnome_tpu.models import edge_features, node_features
from gnnome_tpu.models import sym_gated_gcn as jsgg
from gnnome_tpu.models.norm import layer_norm as jax_layer_norm
from gnnome_tpu.models.sym_gated_gcn import forward as jax_forward
from gnnome_tpu.models.sym_gated_gcn import init_params
from gnnome_tpu.ops import GraphTensors
from gnnome_tpu.ops import message as jmsg
from gnnome_tpu.ops.graph_tensors import with_windowed_plans
from gnnome_tpu.ops.pallas_kernels import set_interpret
from gnnome_tpu.train import step as jax_step
from gnnome_tpu.train.loss import symmetry_loss as jax_symmetry_loss

from gnnome_tpu_torch import cli
from gnnome_tpu_torch.config import Config, ModelConfig
from gnnome_tpu_torch.infer import score_graph
from gnnome_tpu_torch.models import (SymGatedGCN, load_model_weights,
                                     module_state_from_numpy)
from gnnome_tpu_torch.models.norm import layer_norm
from gnnome_tpu_torch.ops import DeviceGraph, aggregate, gate_gather
from gnnome_tpu_torch.ops import kernels as K
from gnnome_tpu_torch.ops import message as tmsg
from gnnome_tpu_torch.train.loss import symmetry_loss
from gnnome_tpu_torch.train.step import (make_example, make_optimizer,
                                         train_step)

BF, F32 = torch.bfloat16, torch.float32
SMALL = dict(num_gnn_layers=3, dim_latent=16, hidden_edge_scores=16,
             dropout=0.0)
D = 16
SPACING = 2.0 ** -7       # a bf16 value's spacing is at most this x |value|
LOGIT_REL = 0.15          # max |diff| / mean |logit|
LOSS_REL = 0.15
GRAD_COS, GRAD_ELEM = 0.999, 0.5
SUM_TOL = dict(rtol=1e-5, atol=1e-5)     # float32 sums in another order
NORMS = ["layer", "none"]


def _bf(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF)


def _jbf(a):
    return jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)


def _bf_np(rng, *shape):
    """bf16-representable standard normals, as float32."""
    return _bf(rng.standard_normal(shape)).float().numpy()


def assert_bf16_close(got, ref, what=""):
    """Within two bf16 spacings of the reference value."""
    got = got.double().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(np.asarray(ref, np.float32), np.float64)
    bad = np.abs(got - ref) > 2 * SPACING * np.abs(ref) + 1e-30
    assert not bad.any(), (f"{what}: {bad.sum()} elements, worst "
                           f"{np.abs(got - ref)[bad].max()}")


def assert_logits_close(got, ref, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref).max() / (np.abs(ref).mean() + 1e-6)
    assert err < LOGIT_REL, f"{what}: max |diff| / mean |logit| = {err}"


def _as_module(tree, state, norm):
    """A JAX parameter pytree as the port's parameter names -> tensors
    (the norm-free model has no norm leaves)."""
    return module_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), state, norm)


def assert_grads_close(got, ref, what=""):
    """``got`` (parameter name -> gradient) against ``ref``, every tensor
    flattened into one vector."""
    assert got.keys() <= ref.keys()
    g = np.concatenate([got[k].double().numpy().ravel() for k in got])
    r = np.concatenate([ref[k].double().numpy().ravel() for k in got])
    assert np.isfinite(g).all()
    rms = float(np.sqrt((r ** 2).mean())) + 1e-8
    elem = (np.abs(g - r) / np.maximum(np.abs(r), rms)).max()
    cos = float((g * r).sum() / (np.linalg.norm(g) * np.linalg.norm(r)
                                 + 1e-12))
    assert cos > GRAD_COS, f"{what}: gradient cosine {cos}"
    assert elem < GRAD_ELEM, f"{what}: gradient element error {elem}"


@pytest.fixture
def unrolled(monkeypatch):
    """The JAX XLA backend with its layers unrolled: the layer-norm model's
    bf16 carry turns float32 in layer 1, which ``lax.scan`` refuses.  The
    tests call the un-jitted JAX functions, so every trace reads it."""
    monkeypatch.setenv("GN_UNROLL_LAYERS", "1")


# ------------------------------------------------------------- K1 and K2
@pytest.fixture(scope="module")
def graphs():
    """The graph of tests/test_torch_unfused.py: both windowed plans carry
    an overflow tail (15% false edges)."""
    g, _, _, _ = synthetic_assembly_graph(n_reads=300, genome_len=20000,
                                          read_len=400, seed=70,
                                          with_sequences=True,
                                          false_edge_frac=0.15)
    gt = GraphTensors.from_graph(g, 128, 128)
    gt_w = with_windowed_plans(gt, flip_too=True, tile_e=128, window=128)
    assert gt_w.wplan.n_ovf > 0 and gt_w.wplan_flip.n_ovf > 0
    return g, {"xla": gt, "pallas": gt_w}, DeviceGraph.from_graph(g)


def _jax_slots(gt, host_rows):
    return gt.edges_to_slots(gt.pad_edges(host_rows))


def _jax_host(gt, slot_rows, n_edges):
    return np.asarray(jnp.asarray(gt.slots_to_edges(slot_rows))
                      .astype(jnp.float32))[:n_edges]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("flip", [False, True])
def test_k1_bf16_plain_vs_jax(graphs, flip, backend):
    """K1 in bf16 (pallas_kernels.py:193, message.py:107): the gate
    rnd(rnd(B1h[u] + B2h[v]) + b3e) within two bf16 spacings of JAX's bf16
    ``fused_gate_gather``, the gathered A2h and A3h columns exact."""
    set_interpret(backend == "pallas")
    g, gts, dg = graphs
    gt = gts[backend]
    rng = np.random.default_rng(40)
    proj = _bf_np(rng, g.num_nodes, 5 * D)
    b3e = _bf_np(rng, g.num_edges, D)
    try:
        ref = jmsg.fused_gate_gather(
            gt, _jbf(gt.pad_nodes(proj[:, :2 * D])),
            _jbf(gt.pad_nodes(proj[:, 2 * D:4 * D])),
            _jbf(_jax_slots(gt, b3e)), flip=flip, backend=backend)
    finally:
        set_interpret(False)
    assert all(r.dtype == jnp.bfloat16 for r in ref)
    tp = _bf(proj)
    g3 = gate_gather(dg, flip, tp[:, :2 * D], tp[:, 2 * D:4 * D],
                     dg.edges_to_slots(_bf(b3e)))
    assert g3.dtype == BF
    got = dg.slots_to_edges(g3).double().numpy()
    E = g.num_edges
    assert_bf16_close(got[:, :D], _jax_host(gt, ref[0], E), "gate")
    for i in (1, 2):
        np.testing.assert_array_equal(got[:, i * D:(i + 1) * D],
                                      _jax_host(gt, ref[i], E))


@pytest.mark.parametrize("width", [2 * D, D])
@pytest.mark.parametrize("flip", [False, True])
def test_k2_bf16_plain_vs_jax(graphs, flip, width):
    """K2 over bf16 payloads: float32 sums, against ``segment_sum`` of the
    payloads cast to float32 (the JAX XLA path, message.py:780-791) within
    float32 reassociation, bit-equal to a sequential float32 sum in slot
    order, and against JAX's Pallas ``_aggregate_pallas`` (interpret mode)
    within the rounding of its bf16 partials: each of a node's at most
    (degree + 2) roundings moves its sum by at most half a spacing of the
    summed magnitudes."""
    g, gts, dg = graphs
    gt = gts["pallas"]
    n, E = g.num_nodes, g.num_edges
    rng = np.random.default_rng(41)
    pay_u, pay_v = (_bf_np(rng, E, width) for _ in range(2))
    t_u, t_v = (dg.edges_to_slots(_bf(p)) for p in (pay_u, pay_v))
    got_u, got_v = aggregate(dg, flip, t_u, t_v)
    assert got_u.dtype == got_v.dtype == F32
    u_idx, v_idx, _, _ = dg.roles(flip)
    set_interpret(True)
    try:
        ju, jv = (gt.dst, gt.src) if flip else (gt.src, gt.dst)
        plan = gt.wplan_flip if flip else gt.wplan
        pal_u, pal_v = jmsg._aggregate_pallas(
            plan, ju, jv, _jbf(_jax_slots(gt, pay_u)),
            _jbf(_jax_slots(gt, pay_v)))
    finally:
        set_interpret(False)
    for got, pay_slots, idx, pal in ((got_u, t_u, u_idx, pal_u),
                                     (got_v, t_v, v_idx, pal_v)):
        pay32 = pay_slots.float().numpy()
        ids = idx.numpy()
        ref = jax.ops.segment_sum(jnp.asarray(pay32), jnp.asarray(ids),
                                  num_segments=n)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **SUM_TOL)
        loop = np.zeros((n, width), np.float32)
        np.add.at(loop, ids, pay32)
        np.testing.assert_array_equal(got.numpy(), loop)
        mag = np.zeros((n, width), np.float64)
        np.add.at(mag, ids, np.abs(pay32))
        deg = np.bincount(ids, minlength=n)[:, None]
        pal = np.asarray(pal.astype(jnp.float32))[:n]
        tol = (deg + 2) * (SPACING / 2) * mag + 1e-6
        assert (np.abs(got.numpy() - pal) <= tol).all()


def test_k1_k2_refuse_mixed_dtypes(graphs):
    """K1 and K2 take every operand in one dtype: a mixed call raises
    TypeError on the CPU as on the card, never promoting quietly."""
    g, _, dg = graphs
    u, v, v_csr, u_csr = dg.roles(False)
    rng = np.random.default_rng(42)
    pu = torch.from_numpy(_bf_np(rng, g.num_nodes, 2 * D))
    b3e = torch.from_numpy(_bf_np(rng, g.num_edges, D))
    pay = torch.from_numpy(_bf_np(rng, g.num_edges, 2 * D))
    with pytest.raises(TypeError, match="K1: mixed dtypes"):
        K.k1_gather_gate(u, v, pu.to(BF), pu.to(BF), b3e)
    with pytest.raises(TypeError, match="K1: mixed dtypes"):
        K.k1_gather_gate(u, v, pu, pu.to(BF), b3e)
    with pytest.raises(TypeError, match="K2: mixed dtypes"):
        K.k2_aggregate(u, v, v_csr, u_csr, pay.to(BF), pay)
    assert K.k1_gather_gate(u, v, pu.to(BF), pu.to(BF),
                            b3e.to(BF)).dtype == BF


# ---------------------------------------------------------------- layer norm
def test_layer_norm_bf16_vs_jax():
    """LayerNorm of a bf16 input: the statistics and the normalised value
    in bf16, then the float32 scale and bias promote the result to float32
    (norm.py:111-115); within two bf16 spacings of JAX's pre-promotion
    value, scaled."""
    rng = np.random.default_rng(43)
    x = _bf_np(rng, 400, D) * 3.0 + 1.0
    scale = rng.uniform(0.5, 1.5, D).astype(np.float32)
    bias = rng.normal(0, 0.1, D).astype(np.float32)
    ref = jax_layer_norm({"scale": jnp.asarray(scale),
                          "bias": jnp.asarray(bias)}, _jbf(x))
    xj = _jbf(x)
    mean = xj.mean(axis=-1, keepdims=True)
    var = ((xj - mean) ** 2).mean(axis=-1, keepdims=True)
    pre = (xj - mean) * jax.lax.rsqrt(var + 1e-5)
    assert pre.dtype == jnp.bfloat16 and ref.dtype == jnp.float32
    ln = torch.nn.LayerNorm(D)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        got = layer_norm(ln, _bf(x))
    assert got.dtype == F32
    pre = np.asarray(pre.astype(jnp.float32), np.float64)
    tol = 2 * SPACING * np.abs(pre * scale) + 1e-6
    assert (np.abs(got.double().numpy() - np.asarray(ref)) <= tol).all()


# ------------------------------------------------------------ the dtype flow
@pytest.fixture(scope="module")
def small():
    g, _, _, _ = synthetic_assembly_graph(n_reads=300, genome_len=20000,
                                          read_len=400, seed=70,
                                          with_sequences=True,
                                          false_edge_frac=0.15)
    gt = GraphTensors.from_graph(g, 128, 128)
    return g, {"xla": gt, "pallas": with_windowed_plans(
        gt, flip_too=True, tile_e=128, window=128)}


def _jax_params(norm, seed=4, **kw):
    cfg = JaxModelConfig(**{**SMALL, **kw, "normalization": norm})
    params, state = jax.tree_util.tree_map(
        np.asarray, init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + 1)
    for bn in ("bn_h", "bn_e"):                  # non-trivial norm affine
        p = params["gnn"][bn]
        p["scale"] = rng.uniform(0.5, 1.5, p["scale"].shape).astype(np.float32)
        p["bias"] = rng.normal(0, 0.1, p["bias"].shape).astype(np.float32)
    return params, state


def _port_model(params, state, norm, **kw):
    m = SymGatedGCN.from_config(ModelConfig(**{**SMALL, **kw,
                                               "normalization": norm}))
    m.load_state_dict(module_state_from_numpy(params, state, norm))
    return m


def _name(dt):
    return {jnp.dtype(jnp.bfloat16): "bf16", jnp.dtype(jnp.float32): "f32",
            BF: "bf16", F32: "f32"}[dt if isinstance(dt, torch.dtype)
                                     else jnp.dtype(dt)]


def _flow_jax(monkeypatch, small, norm):
    """The JAX package's dtype flow, read while its Pallas backend
    (interpret mode) runs the bf16 forward and ``jax.grad`` of the summed
    logits: each layer's (h, e) out, K1's inputs, K2's payloads by caller
    (the gated mean forward, K1's adjoint, the predictor gathers'
    adjoint), the predictor's inputs."""
    g, gts = small
    gt = gts["pallas"]
    params, state = _jax_params(norm)
    rec = {"layers": [], "k1": [], "k2": [], "predictor": []}
    layer, gate, agg, score = (jsgg.sym_gated_gcn_layer,
                               jmsg.fused_gate_gather,
                               jmsg._aggregate_pallas, jsgg.score_edges)

    def layer_rec(*a, **k):
        h, e, s = layer(*a, **k)
        rec["layers"].append((_name(h.dtype), _name(e.dtype)))
        return h, e, s

    def gate_rec(gt_, pu, pv, b3e, **k):
        rec["k1"].append(tuple(_name(t.dtype) for t in (pu, pv, b3e)))
        return gate(gt_, pu, pv, b3e, **k)

    def agg_rec(plan, u, v, pay_u, pay_v):
        rec["k2"].append((sys._getframe(1).f_code.co_name,
                          _name(pay_u.dtype), _name(pay_v.dtype)))
        return agg(plan, u, v, pay_u, pay_v)

    def score_rec(p, gt_, h, e, **k):
        rec["predictor"].append((_name(h.dtype), _name(e.dtype)))
        return score(p, gt_, h, e, **k)

    monkeypatch.setattr(jsgg, "sym_gated_gcn_layer", layer_rec)
    monkeypatch.setattr(jmsg, "fused_gate_gather", gate_rec)
    monkeypatch.setattr(jmsg, "_aggregate_pallas", agg_rec)
    monkeypatch.setattr(jsgg, "score_edges", score_rec)
    x, e = node_features(g), edge_features(g)

    def loss(p):
        lo, _ = jax_forward(p, state, gt, gt.pad_nodes(x), gt.pad_edges(e),
                            JaxModelConfig(**SMALL, normalization=norm),
                            training=True, flip=False, backend="pallas",
                            dtype=jnp.bfloat16)
        return lo.sum()

    set_interpret(True)
    try:
        jax.grad(loss)(params)
    finally:
        set_interpret(False)
    # (_aggregate_fwd: the custom VJP's forward rule calling it again)
    names = {"gated_mean_pair": "forward", "_gate_gather_bwd": "k1_adjoint",
             "_gather_uv_pallas_bwd": "gather_adjoint"}
    rec["k2"] = [(names[c], a, b) for c, a, b in rec["k2"]
                 if c != "_aggregate_fwd"]
    return rec


def _flow_port(monkeypatch, small, norm):
    """The port's dtype flow, read the same way (CPU, plain versions)."""
    g, _ = small
    params, state = _jax_params(norm)
    model = _port_model(params, state, norm).train()
    rec = {"layers": [], "k1": [], "k2": [], "predictor": []}
    k1, k2 = tmsg.k1_gather_gate, tmsg.k2_aggregate

    def k1_rec(u, v, pu, pv, b3e):
        rec["k1"].append(tuple(_name(t.dtype) for t in (pu, pv, b3e)))
        return k1(u, v, pu, pv, b3e)

    def k2_rec(u, v, v_csr, u_csr, pay_u, pay_v):
        rec["k2"].append((sys._getframe(1).f_code.co_qualname,
                          _name(pay_u.dtype), _name(pay_v.dtype)))
        return k2(u, v, v_csr, u_csr, pay_u, pay_v)

    monkeypatch.setattr(tmsg, "k1_gather_gate", k1_rec)
    monkeypatch.setattr(tmsg, "k2_aggregate", k2_rec)
    for conv in model.gnn.convs:
        conv.register_forward_hook(lambda m, a, out: rec["layers"].append(
            (_name(out[0].dtype), _name(out[1].dtype))))
    model.predictor.register_forward_pre_hook(
        lambda m, a: rec["predictor"].append((_name(a[1].dtype),
                                               _name(a[2].dtype))))
    lo = model(DeviceGraph.from_graph(g), torch.from_numpy(node_features(g)),
               torch.from_numpy(edge_features(g)), dtype=BF)
    assert lo.dtype == F32
    lo.sum().backward()
    names = {"_Aggregate.forward": "forward",
             "_UnfusedEdgeStage.forward": "forward",
             "_GateGather.backward": "k1_adjoint",
             "_UnfusedEdgeStage.backward": "k1_adjoint",
             "_GatherUV.backward": "gather_adjoint"}
    rec["k2"] = [(names[c], a, b) for c, a, b in rec["k2"]]
    return rec


def _expected_flow(norm, L=SMALL["num_gnn_layers"]):
    """The table of the module docstring, per layer."""
    if norm == "none":
        b = ("bf16",) * 3
        return {"layers": [("bf16", "bf16")] * L, "k1": [b] * L,
                "k2": ([("forward", "bf16", "bf16")] * L
                       + [("gather_adjoint", "bf16", "bf16")]
                       + [("k1_adjoint", "bf16", "bf16")] * L),
                "predictor": [("bf16", "bf16")]}
    return {"layers": [("f32", "f32")] * L,
            "k1": [("bf16",) * 3] + [("f32",) * 3] * (L - 1),
            "k2": ([("forward", "f32", "f32")] * L
                   + [("gather_adjoint", "f32", "f32")]
                   + [("k1_adjoint", "f32", "f32")] * (L - 1)
                   + [("k1_adjoint", "bf16", "bf16")]),
            "predictor": [("f32", "f32")]}


@pytest.mark.parametrize("norm", NORMS)
def test_dtype_flow(monkeypatch, small, norm):
    """Per layer, the dtype of ``h`` and ``e`` out, of K1's inputs and of
    K2's payloads (forward and both adjoints, in call order: the backward
    runs the layers last to first), and the predictor's inputs, read from
    both packages: equal to each other and to the table."""
    with monkeypatch.context() as mp:
        ref = _flow_jax(mp, small, norm)
    with monkeypatch.context() as mp:
        got = _flow_port(mp, small, norm)
    assert got == ref
    assert got == _expected_flow(norm)


# ------------------------------------------------------------- eval forward
@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("norm", NORMS)
def test_eval_forward_vs_jax(unrolled, small, norm, flip, backend):
    """bf16 eval logits against JAX ``forward`` at dtype=bfloat16."""
    g, gts = small
    gt = gts[backend]
    params, state = _jax_params(norm)
    x, e = node_features(g, reverse=flip), edge_features(g)
    set_interpret(backend == "pallas")
    try:
        ref, _ = jax_forward(params, state, gt, gt.pad_nodes(x),
                             gt.pad_edges(e),
                             JaxModelConfig(**SMALL, normalization=norm),
                             training=False, flip=flip, backend=backend,
                             dtype=jnp.bfloat16)
    finally:
        set_interpret(False)
    model = _port_model(params, state, norm)
    with torch.inference_mode():
        got = model(DeviceGraph.from_graph(g), torch.from_numpy(x),
                    torch.from_numpy(e), flip=flip, dtype=BF)
        f32 = model(DeviceGraph.from_graph(g), torch.from_numpy(x),
                    torch.from_numpy(e), flip=flip)
    assert got.dtype == F32 and not torch.equal(got, f32)
    assert_logits_close(got.numpy()[:, 0],
                        np.asarray(ref)[:g.num_edges, 0],
                        f"{norm} {backend} flip={flip}")


# -------------------------------------------------------- gradients, step
@pytest.fixture(scope="module")
def step_data():
    """The train-step recipe of tests/test_torch_unfused.py (random edge
    features and labels), 2 layers."""
    g, _, _, _ = synthetic_assembly_graph(n_reads=200, genome_len=20_000,
                                          read_len=900, seed=3,
                                          with_sequences=False)
    rng = np.random.default_rng(17)
    e = rng.normal(size=(g.num_edges, 2)).astype(np.float32)
    y = (np.random.default_rng(0).random(g.num_edges) < 0.5
         ).astype(np.float32)
    return g, e, y


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("norm", NORMS)
def test_symmetry_loss_gradients_vs_jax(unrolled, step_data, norm, backend):
    """The symmetry loss over the two bf16 passes and every parameter's
    gradient against ``jax.value_and_grad`` of the JAX loss (its two
    forwards at dtype=bfloat16, step.py:254-276)."""
    g, e, y = step_data
    pw = 1.7
    params, state = _jax_params(norm, seed=5, num_gnn_layers=2)
    cfg = JaxConfig()
    cfg.model = JaxModelConfig(**{**SMALL, "num_gnn_layers": 2,
                                  "normalization": norm})
    cfg.train.masking = False
    cfg.compute.backend = backend
    ex = jax_step.make_example(cfg, g.in_degrees(), g.out_degrees(), e, y,
                               g.src, g.dst, g.num_nodes)

    def loss_fn(p):
        kw = dict(training=True, backend=backend, slot_io=True,
                  dtype=jnp.bfloat16)
        lo, st = jax_forward(p, state, ex.gt, ex.x, ex.e, cfg.model,
                             flip=False, **kw)
        lr_, _ = jax_forward(p, st, ex.gt, ex.x_rev, ex.e, cfg.model,
                             flip=True, **kw)
        return jax_symmetry_loss(lo[:, 0], lr_[:, 0], ex.labels, pw,
                                 alpha=cfg.train.alpha, mask=ex.mask)

    set_interpret(backend == "pallas")
    try:
        loss_ref, g_ref = jax.value_and_grad(loss_fn)(params)
    finally:
        set_interpret(False)
    model = _port_model(params, state, norm, num_gnn_layers=2).train()
    tex = make_example(g.in_degrees(), g.out_degrees(), e, y, g.src, g.dst,
                       g.num_nodes, "cpu")
    lo, lr_ = model.forward_pair(tex.g, tex.x, tex.x_rev, tex.e, None,
                                 slot_io=True, dtype=BF)
    loss = symmetry_loss(lo[:, 0], lr_[:, 0], tex.labels, pw,
                         alpha=Config().train.alpha)
    loss.backward()
    assert loss.dtype == F32
    assert abs(loss.item() - float(loss_ref)) < LOSS_REL * abs(
        float(loss_ref))
    assert all(p.grad.dtype == F32 for p in model.parameters())
    assert_grads_close({n: p.grad for n, p in model.named_parameters()},
                       _as_module(g_ref, state, norm), f"{norm} {backend}")


def _bf16_cfg(norm, lr, **kw):
    cfg = Config()
    cfg.model = ModelConfig(**{**SMALL, "num_gnn_layers": 2,
                               "normalization": norm, **kw})
    cfg.train.lr = lr
    cfg.compute.dtype = "bfloat16"
    return cfg


@pytest.mark.parametrize("norm", NORMS)
def test_train_step_vs_jax_make_steps(step_data, norm):
    """One port ``train_step`` at compute.dtype=bfloat16 against the step of
    JAX ``make_steps`` at dtype=bfloat16 (Pallas, interpret mode): loss,
    logits, and the float32 parameters after Adam at the scale of the
    lr."""
    g, e, y = step_data
    lr, pw = 1e-3, 1.7
    params, state = _jax_params(norm, seed=5, num_gnn_layers=2)
    jcfg = JaxConfig()
    jcfg.model = JaxModelConfig(**{**SMALL, "num_gnn_layers": 2,
                                   "normalization": norm})
    jcfg.train.masking = False
    jcfg.train.lr = lr
    jcfg.compute.backend = "pallas"
    jcfg.compute.dtype = "bfloat16"
    ex_j = jax_step.make_example(jcfg, g.in_degrees(), g.out_degrees(), e,
                                 y, g.src, g.dst, g.num_nodes)
    set_interpret(True)
    try:
        tx, jstep, _ = jax_step.make_steps(jcfg)
        p_ref, _, _, loss_ref, logits_ref = jstep(
            params, state, tx.init(params), ex_j.gt, ex_j.x, ex_j.x_rev,
            ex_j.e, ex_j.labels, ex_j.mask, np.float32(pw),
            jax.random.PRNGKey(7))
    finally:
        set_interpret(False)
    model = _port_model(params, state, norm, num_gnn_layers=2)
    ex = make_example(g.in_degrees(), g.out_degrees(), e, y, g.src, g.dst,
                      g.num_nodes, "cpu")
    loss, logits = train_step(model, make_optimizer(model, lr), ex, pw,
                              _bf16_cfg(norm, lr), None)
    assert loss.dtype == logits.dtype == F32
    assert abs(float(loss) - float(loss_ref)) < LOSS_REL * abs(
        float(loss_ref))
    assert_logits_close(ex.g.slots_to_edges(logits).numpy(),
                        jax_step.logits_to_host(ex_j, logits_ref), "logits")
    ref = _as_module(p_ref, state, norm)
    for name, p in model.named_parameters():
        assert p.dtype == F32, name
        assert float((p.detach() - ref[name]).abs().max()) <= 2 * lr + 1e-6, (
            name)


@pytest.mark.parametrize("norm", NORMS)
def test_two_cpu_bf16_train_steps_bitwise_equal(step_data, norm):
    """Two bf16 steps from one state, dropout 0.2 from one seed: loss,
    logits, gradients, parameters and buffers bitwise equal."""
    g, e, y = step_data
    params, state = _jax_params(norm, seed=5, num_gnn_layers=2)
    cfg = _bf16_cfg(norm, 1e-3, dropout=0.2)
    runs = []
    for _ in range(2):
        model = _port_model(params, state, norm, num_gnn_layers=2,
                            dropout=0.2)
        ex = make_example(g.in_degrees(), g.out_degrees(), e, y, g.src,
                          g.dst, g.num_nodes, "cpu")
        loss, logits = train_step(model, make_optimizer(model, 1e-3), ex,
                                  1.5, cfg, torch.Generator().manual_seed(3))
        runs.append((loss, logits, [p.grad.clone() for p in
                                    model.parameters()],
                     [t.clone() for t in model.state_dict().values()]))
    (l0, lo0, g0, s0), (l1, lo1, g1, s1) = runs
    assert torch.equal(l0, l1) and torch.equal(lo0, lo1)
    assert all(torch.equal(a, b) for a, b in zip(g0 + s0, g1 + s1))


# ------------------------------------------------------------------ the CLI
TINY = ["--set", "model.num_gnn_layers=2", "--set", "model.dim_latent=16",
        "--set", "model.hidden_edge_scores=16"]


@pytest.fixture(scope="module", params=NORMS)
def trained(request, tmp_path_factory):
    """``cli train --set compute.dtype=bfloat16`` of the layer-norm or the
    norm-free model on the CPU: a small synthetic dataset with reads, one
    epoch, masking and clusters of 200 nodes, dropout 0.2."""
    norm = request.param
    root = tmp_path_factory.mktemp(f"bf16_{norm}")
    ds = root / "ds"
    for sub in ("processed", "info"):
        (ds / "hifiasm" / sub).mkdir(parents=True)
    g, reads, _, genome = synthetic_assembly_graph(
        n_reads=160, genome_len=15000, read_len=500, seed=13,
        with_sequences=True, false_edge_frac=0.0)
    g.save(str(ds / "hifiasm" / "processed" / "0.npz"))
    reads.save(str(ds / "hifiasm" / "info" / "0_reads.npz"))
    common = ["--train", str(ds), "--valid", str(ds), "--asm", "hifiasm",
              "--set", "compute.device=cpu", "--set", "compute.dtype=bfloat16",
              "--set", f"model.normalization={norm}",
              "--set", "train.num_nodes_per_cluster=200",
              "--set", f"paths.checkpoints_path={root / 'ckpt'}",
              "--set", f"paths.models_path={root / 'models'}", *TINY]

    def run(*extra):
        return cli.main(["train", *common, *extra])

    model_path = run("--name", "b", "--set", "train.num_epochs=1")
    return norm, root, ds, g, genome, run, model_path


def test_cli_train_bf16_resume_twice_bitwise_identical(trained):
    """The epoch logs a finite loss; the saved model is float32; resuming
    twice from one checkpoint writes identical checkpoints, equal to those
    of a run never interrupted."""
    _, root, _, _, _, run, model_path = trained
    ckpt = root / "ckpt"
    with open(ckpt / "log_b_seed1.jsonl") as f:
        logs = [json.loads(line) for line in f]
    assert [r["epoch"] for r in logs] == [0]
    assert np.isfinite(logs[0]["train/loss"])
    with np.load(model_path) as z:
        assert all(z[k].dtype in (np.float32, np.int32, np.int64)
                   for k in z.files)
    for i in range(2):
        run("--name", "b", "--resume", "--set", "train.num_epochs=2")
        os.replace(ckpt / "ckpt_b_seed1_resumed-2.npz", ckpt / f"r{i}.npz")
    run("--name", "c", "--set", "train.num_epochs=2")
    with np.load(ckpt / "r0.npz") as a, np.load(ckpt / "r1.npz") as b, \
            np.load(ckpt / "ckpt_c_seed1.npz") as c:
        assert a.files == b.files == c.files
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
            assert np.array_equal(a[k], c[k]), k


def test_cli_infer_bf16_on_cpu(trained, tmp_path):
    """``cli infer --set compute.dtype=bfloat16`` with the model ``cli
    train`` saved, on the CPU: the logits cache holds finite float32 logits
    for every edge, equal to ``score_graph`` at bf16 and not to the float32
    scores, and the assembly is written."""
    norm, _, ds, g, _, _, model_path = trained
    savedir = str(tmp_path / "out")
    summary = cli.main(["infer", "--data", str(ds), "--asm", "hifiasm",
                        "--out", savedir, "--model", model_path,
                        "--set", "compute.device=cpu",
                        "--set", "compute.dtype=bfloat16",
                        "--set", f"model.normalization={norm}", *TINY,
                        "--set", "decode.len_threshold=1000",
                        "--set", "decode.num_decoding_paths=10"])
    assert summary["device"] == "cpu"
    lo16 = np.load(os.path.join(savedir, "decode", "0_predicts.npy"))
    assert lo16.dtype == np.float32 and lo16.shape == (g.num_edges,)
    assert np.isfinite(lo16).all()
    cfg = Config().apply_overrides(["compute.device=cpu",
                                    f"model.normalization={norm}",
                                    *TINY[1::2]])
    lo32 = score_graph(g, *load_model_weights(model_path), cfg)
    cfg.compute.dtype = "bfloat16"
    assert np.array_equal(score_graph(g, *load_model_weights(model_path),
                                      cfg), lo16)
    assert not np.array_equal(lo16, lo32)
    assert os.path.isfile(os.path.join(savedir, "assembly",
                                       "0_assembly.fasta"))
