"""The bfloat16 compute mode of gnnome_tpu_torch (``compute.dtype=
bfloat16``, the batch-norm SymGatedGCN) against the JAX package's bf16 mode
(``dtype=jnp.bfloat16``), on the CPU (the kernels' plain versions).

Inputs are made with numpy from seeds: the small model of
tests/test_torch_model.py (3 layers, d=16), the golden subgraph with the
shipped weights, and the dual-pass recipe of tests/test_torch_dual.py.  The
JAX side runs its XLA backend and its Pallas backend in interpret mode.

Bounds are the JAX package's own between its two bf16 backends
(tests_tpu/test_on_tpu_parity.py:87-123): logits max |diff| < 0.15 x mean
|logit|; the loss within 0.15 relative; gradients with cosine > 0.999 and
each element within 0.5 x max(|g|, rms of g).  The shipped weights give
logits of mean |logit| ~8 through 8 layers, where bf16 moves single logits
by several units (the JAX package's own two bf16 backends differ by up to
8.25 on the golden subgraph, cosine 0.9982, AP 4e-5 apart); there the
yardsticks are the logits' cosine (> 0.995), the largest change of a
probability (< 0.25; bf16 against float32 on the whole golden graph: 0.23)
and the average precision (within 5e-4).  Each bf16 plain kernel is
held against the JAX counterpart's operations written in XLA with the casts
of the JAX bf16 kernel body: bf16 edge outputs within two bf16 spacings of
the reference value (XLA on the CPU may keep a fused chain in float32
between its bf16 rounding points, which moves a result by one spacing, and
a rounded input can move the next result by one more), sums within that
plus the spacing of the summed magnitudes.  Checkpoints and resumes in bf16
stay bitwise.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnome_tpu.config import Config as JaxConfig
from gnnome_tpu.config import ModelConfig as JaxModelConfig
from gnnome_tpu.graphs import synthetic_assembly_graph
from gnnome_tpu.graphs.container import AssemblyGraph
from gnnome_tpu.models import edge_features, node_features
from gnnome_tpu.models.norm import batch_norm as jax_batch_norm
from gnnome_tpu.models.sym_gated_gcn import forward as jax_forward
from gnnome_tpu.models.sym_gated_gcn import forward_dual as jax_forward_dual
from gnnome_tpu.models.sym_gated_gcn import init_params
from gnnome_tpu.ops import GraphTensors
from gnnome_tpu.ops.graph_tensors import with_windowed_plans
from gnnome_tpu.ops.pallas_kernels import set_interpret
from gnnome_tpu.train import step as jax_step
from gnnome_tpu.train.loss import symmetry_loss as jax_symmetry_loss

from gnnome_tpu_torch import cli
from gnnome_tpu_torch.config import Config, ModelConfig, compute_dtype
from gnnome_tpu_torch.infer import score_graph
from gnnome_tpu_torch.models import (SymGatedGCN, load_model_weights,
                                     module_state_from_numpy,
                                     numpy_from_module_state)
from gnnome_tpu_torch.models.nn import dropout
from gnnome_tpu_torch.models.norm import batch_norm_eval, batch_norm_train
from gnnome_tpu_torch.ops import DeviceGraph
from gnnome_tpu_torch.ops import kernels as K
from gnnome_tpu_torch.train.loss import symmetry_loss
from gnnome_tpu_torch.train.step import (make_example, make_optimizer,
                                         train_step)
from gnnome_tpu_torch.utils.fastx import read_fastx, reverse_complement

BF = torch.bfloat16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "weights", "weights.npz")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "golden_ecoli_v1.npz")
SMALL = dict(num_gnn_layers=3, dim_latent=16, hidden_edge_scores=16,
             dropout=0.0)
LOGIT_REL = 0.15          # max |diff| / mean |logit|
LOSS_REL = 0.15
GRAD_COS, GRAD_ELEM = 0.999, 0.5
SCORE_COS, SCORE_DP, SCORE_AP = 0.995, 0.25, 5e-4
SPACING = 2.0 ** -7       # a bf16 value's spacing is at most this x |value|
D = 16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(_np(tree)))


def assert_logits_close(got, ref, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref).max() / (np.abs(ref).mean() + 1e-6)
    assert err < LOGIT_REL, f"{what}: max |diff| / mean |logit| = {err}"


def assert_grads_close(got, ref, what=""):
    """Two gradient pytrees of the same leaves, flattened in one order."""
    a, b = _leaves(got), _leaves(ref)
    assert a.keys() == b.keys()
    g = np.concatenate([np.ravel(a[k]).astype(np.float64) for k in a])
    r = np.concatenate([np.ravel(b[k]).astype(np.float64) for k in a])
    assert np.isfinite(g).all()
    rms = float(np.sqrt((r ** 2).mean())) + 1e-8
    elem = (np.abs(g - r) / np.maximum(np.abs(r), rms)).max()
    cos = float((g * r).sum() / (np.linalg.norm(g) * np.linalg.norm(r)
                                 + 1e-12))
    assert cos > GRAD_COS, f"{what}: gradient cosine {cos}"
    assert elem < GRAD_ELEM, f"{what}: gradient element error {elem}"


def assert_scores_agree(got, ref, labels=None, what=""):
    """Shipped-weight logits: cosine, probabilities and (with ``labels``)
    the average precision, as the module docstring sets them."""
    from gnnome_tpu_torch.train.metrics import get_aps

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    cos = (got * ref).sum() / (np.linalg.norm(got) * np.linalg.norm(ref))
    assert cos > SCORE_COS, f"{what}: logit cosine {cos}"
    dp = np.abs(1 / (1 + np.exp(-got)) - 1 / (1 + np.exp(-ref))).max()
    assert dp < SCORE_DP, f"{what}: largest probability change {dp}"
    if labels is not None:
        d_ap = abs(get_aps(got, labels) - get_aps(ref, labels))
        assert d_ap < SCORE_AP, f"{what}: AP differs by {d_ap}"


def assert_bf16_close(got, ref, mag=None, what=""):
    """bf16 values within two bf16 spacings of the reference, plus one
    spacing of ``mag`` (the summed magnitudes, for sums)."""
    got = np.asarray(torch.as_tensor(got).double())
    ref = np.asarray(torch.as_tensor(np.asarray(ref, np.float32)).double())
    tol = 2 * SPACING * np.abs(ref) + 1e-30
    if mag is not None:
        tol = tol + SPACING * np.asarray(mag, np.float64)
    bad = np.abs(got - ref) > tol
    assert not bad.any(), (f"{what}: {bad.sum()} elements, worst "
                           f"{np.abs(got - ref)[bad].max()}")


def _bf(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF)


def _jbf(a):
    return jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)


def _t2np(t):
    return t.float().numpy()


# ------------------------------------------------------------------ kernels
@pytest.fixture(scope="module")
def kgraph():
    g, _, _, _ = synthetic_assembly_graph(n_reads=300, genome_len=20000,
                                          read_len=400, seed=70,
                                          with_sequences=False,
                                          false_edge_frac=0.15)
    return g, DeviceGraph.from_graph(g)


def _kernel_inputs(g, seed, d=D):
    """bf16-representable numpy inputs (float32 arrays) for the kernels; the
    BN rows are the folded affine [0, 1, scale, bias]."""
    rng = np.random.default_rng(seed)
    n, e = g.num_nodes, g.num_edges

    def f(*s, scale=1.0):
        return _t2np(_bf(rng.standard_normal(s) * scale))

    bn = np.stack([np.zeros(d), np.ones(d),
                   _t2np(_bf(rng.uniform(0.5, 1.5, d))), f(d, scale=0.1)])
    return dict(proj_u=f(n, 2 * d), proj_v=f(n, 2 * d), b3e=f(e, d),
                e_in=f(e, d), bn=bn.astype(np.float32),
                d_sum_u=f(n, 2 * d), d_sum_v=f(n, 2 * d), d_e_out=f(e, d),
                puv=f(n, 2 * d), be=f(e, d),
                pay=np.maximum(f(e, d), 0.0))


def _roles(dg, flip):
    u, v, _, _ = dg.roles(flip)
    return u, v, jnp.asarray(u.numpy()), jnp.asarray(v.numpy())


def _jseg(pay, idx, n):
    return jax.ops.segment_sum(pay.astype(jnp.float32), idx, num_segments=n)


@pytest.mark.parametrize("flip", [False, True])
def test_k3_bf16_plain_vs_jax_xla(kgraph, flip):
    """K3's bf16 contract (pallas_kernels.py:339-352, message.py:443-448):
    the endpoint sum rounded, + b3e, the affine, relu + residual in bf16,
    sigma in float32 rounded, bf16 products summed in float32 and
    emitted in bf16."""
    g, dg = kgraph
    a = _kernel_inputs(g, 1)
    u, v, ju, jv = _roles(dg, flip)
    n, d = g.num_nodes, D
    pu, pv = _jbf(a["proj_u"]), _jbf(a["proj_v"])
    gu, gv = pu[ju], pv[jv]
    gate = ((gu[:, :d].astype(jnp.float32) + gv[:, :d].astype(jnp.float32))
            .astype(jnp.bfloat16) + _jbf(a["b3e"]))
    gate = gate * _jbf(a["bn"][2]) + _jbf(a["bn"][3])
    eo = jax.nn.relu(gate) + _jbf(a["e_in"])
    sig = jax.nn.sigmoid(eo.astype(jnp.float32)).astype(jnp.bfloat16)
    pay_v = jnp.concatenate([sig * gu[:, d:], sig], 1)
    pay_u = jnp.concatenate([sig * gv[:, d:], sig], 1)
    ref_v, ref_u = _jseg(pay_v, jv, n), _jseg(pay_u, ju, n)
    got = K.k3_edge_stage_plain(u, v, _bf(a["proj_u"]), _bf(a["proj_v"]),
                                _bf(a["b3e"]), _bf(a["e_in"]), _bf(a["bn"]))
    assert all(t.dtype == BF for t in got)
    assert_bf16_close(got[0], np.asarray(eo.astype(jnp.float32)), what="e_out")
    for t, ref, pay, idx in ((got[1], ref_v, pay_v, jv),
                             (got[2], ref_u, pay_u, ju)):
        mag = _jseg(jnp.abs(pay), idx, n)
        assert_bf16_close(t, np.asarray(ref), np.asarray(mag), what="sums")


@pytest.mark.parametrize("flip", [False, True])
def test_k6_bf16_plain_vs_jax_xla(kgraph, flip):
    """K6's bf16 contract (pallas_kernels.py:706): relu((pu[u] + pv[v]) +
    be), each add rounded to bf16."""
    g, dg = kgraph
    a = _kernel_inputs(g, 2)
    u, v, ju, jv = _roles(dg, flip)
    puv = _jbf(a["puv"])
    s = (puv[ju][:, :D].astype(jnp.float32)
         + puv[jv][:, D:].astype(jnp.float32)).astype(jnp.bfloat16)
    ref = jax.nn.relu(s + _jbf(a["be"]))
    got = K.k6_score_gate_plain(u, v, _bf(a["puv"]), _bf(a["be"]))
    assert got.dtype == BF
    assert_bf16_close(got, np.asarray(ref.astype(jnp.float32)), what="z")


@pytest.mark.parametrize("flip", [False, True])
def test_k7_bf16_plain_vs_jax_xla(kgraph, flip):
    """K7's bf16 contract (pallas_kernels.py:474): the gate as K3 rounds
    it, [sum x | sum x^2] in (at least) float32."""
    g, dg = kgraph
    a = _kernel_inputs(g, 3)
    u, v, ju, jv = _roles(dg, flip)
    x = ((_jbf(a["proj_u"])[ju][:, :D].astype(jnp.float32)
          + _jbf(a["proj_v"])[jv][:, :D].astype(jnp.float32))
         .astype(jnp.bfloat16) + _jbf(a["b3e"])).astype(jnp.float32)
    ref = np.concatenate([np.asarray(x.sum(0)), np.asarray((x * x).sum(0))])
    mag = np.concatenate([np.asarray(jnp.abs(x).sum(0)),
                          np.asarray((x * x).sum(0))])
    got = K.k7_gate_stats_plain(u, v, _bf(a["proj_u"])[:, :D],
                                _bf(a["proj_v"])[:, :D], _bf(a["b3e"]))
    assert got.dtype == torch.float64
    # float32 sums in JAX: within 1e-5 of the summed magnitudes; a gate
    # element rounded one spacing apart moves a sum by its spacing
    assert (np.abs(got.numpy() - ref) <= 1e-5 * mag + 1e-6).all()


@pytest.mark.parametrize("flip", [False, True])
def test_k8_bf16_plain_vs_jax_xla(kgraph, flip):
    """K8's bf16 contract (pallas_kernels.py:539-601): x and the affine as
    K3 rounds them, sigma and the adjoint chain in float32, d_eo rounded,
    the node payloads [d_y * scale | sigma * d_m] rounded to bf16 and
    summed with x in float32, [sum d_y | sum d_y * x] in float32.  As in
    the port, d_y is taken from the rounded d_eo."""
    g, dg = kgraph
    a = _kernel_inputs(g, 4)
    u, v, ju, jv = _roles(dg, flip)
    n, d, f32, b16 = g.num_nodes, D, jnp.float32, jnp.bfloat16
    gu, gv = _jbf(a["proj_u"])[ju], _jbf(a["proj_v"])[jv]
    du = _jbf(a["d_sum_u"])[ju].astype(f32)
    dv = _jbf(a["d_sum_v"])[jv].astype(f32)
    x = ((gu[:, :d].astype(f32) + gv[:, :d].astype(f32)).astype(b16)
         + _jbf(a["b3e"]))
    scale = _jbf(a["bn"][2])
    gaff = x * scale + _jbf(a["bn"][3])
    eo = jax.nn.relu(gaff) + _jbf(a["e_in"])
    sigma = jax.nn.sigmoid(eo.astype(f32))
    d_sigma = (dv[:, :d] * gu[:, d:].astype(f32) + dv[:, d:]
               + du[:, :d] * gv[:, d:].astype(f32) + du[:, d:])
    d_eo = (_jbf(a["d_e_out"]).astype(f32)
            + d_sigma * sigma * (1.0 - sigma)).astype(b16)
    d_y = d_eo.astype(f32) * (gaff.astype(f32) > 0)
    dys = (d_y * scale.astype(f32)).astype(b16)
    pay_u = jnp.concatenate([dys, (sigma * dv[:, :d]).astype(b16), x], 1)
    pay_v = jnp.concatenate([dys, (sigma * du[:, :d]).astype(b16), x], 1)
    xf = x.astype(f32)
    stats = np.concatenate([np.asarray(d_y.sum(0)),
                            np.asarray((d_y * xf).sum(0))])
    got = K.k8_train_layer_bwd_plain(
        u, v, *(_bf(a[k]) for k in ("d_sum_u", "d_sum_v", "proj_u",
                                    "proj_v", "b3e", "e_in", "d_e_out",
                                    "bn")))
    assert [t.dtype for t in got] == [BF] * 4 + [torch.float64]
    assert_bf16_close(got[0], np.asarray(xf), what="x")
    assert_bf16_close(got[1], np.asarray(d_eo.astype(f32)), what="d_eo")
    for t, pay, idx in ((got[2], pay_u, ju), (got[3], pay_v, jv)):
        assert_bf16_close(t, np.asarray(_jseg(pay, idx, n)),
                          np.asarray(_jseg(jnp.abs(pay), idx, n)),
                          what="node sums")
    mag = np.concatenate([np.asarray(jnp.abs(d_y).sum(0)),
                          np.asarray(jnp.abs(d_y * xf).sum(0))])
    assert (np.abs(got[4].numpy() - stats) <= 2 * SPACING * mag + 1e-6).all()


@pytest.mark.parametrize("flip", [False, True])
def test_k9_bf16_plain_vs_jax_xla(kgraph, flip):
    """K9's bf16 contract (message.py:713-734): a bf16 payload summed into
    both endpoints in float32, [N, 2H] float32; bit-equal to a sequential
    float32 sum in slot order."""
    g, dg = kgraph
    a = _kernel_inputs(g, 5)
    u, v, ju, jv = _roles(dg, flip)
    pay = _jbf(a["pay"])
    ref = np.concatenate([np.asarray(_jseg(pay, ju, g.num_nodes)),
                          np.asarray(_jseg(pay, jv, g.num_nodes))], 1)
    got = K.k9_aggregate_plain(u, v, _bf(a["pay"]), g.num_nodes)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    loop = np.zeros((g.num_nodes, 2 * D), np.float32)
    for s, (i, j) in enumerate(zip(u.numpy(), v.numpy())):
        loop[i, :D] += a["pay"][s]
        loop[j, D:] += a["pay"][s]
    assert np.array_equal(got.numpy(), loop)


def test_bf16_wrappers_keep_the_dtype_contract(kgraph):
    """On the CPU the wrappers take the plain versions in bf16 and return
    K1, K3 and K6 outputs in bf16, K7 float64, K8 bf16 with float64 sums,
    K2 and K9 float32 sums; no launch is counted; the zoo's one-sided K2
    walk refuses bf16."""
    g, dg = kgraph
    a = {k: _bf(v) for k, v in _kernel_inputs(g, 6).items()}
    u, v, v_csr, u_csr = dg.roles(False)
    K.reset_launch_counts()
    out3 = K.k3_edge_stage(u, v, v_csr, u_csr, a["proj_u"], a["proj_v"],
                           a["b3e"], a["e_in"], a["bn"])
    out8 = K.k8_train_layer_bwd(u, v, v_csr, u_csr, a["d_sum_u"],
                                a["d_sum_v"], a["proj_u"], a["proj_v"],
                                a["b3e"], a["e_in"], a["d_e_out"], a["bn"])
    assert [t.dtype for t in out3] == [BF] * 3
    assert [t.dtype for t in out8] == [BF] * 4 + [torch.float64]
    assert K.k6_score_gate(u, v, a["puv"], a["be"]).dtype == BF
    assert K.k7_gate_stats(u, v, a["proj_u"][:, :D], a["proj_v"][:, :D],
                           a["b3e"]).dtype == torch.float64
    assert K.k9_aggregate(u, v, v_csr, u_csr, a["pay"]).dtype == torch.float32
    assert K.k1_gather_gate(u, v, a["proj_u"], a["proj_v"],
                            a["b3e"]).dtype == BF
    assert [t.dtype for t in K.k2_aggregate(u, v, v_csr, u_csr, a["pay"],
                                            a["pay"])] == [torch.float32] * 2
    assert K.launch_counts() == {name: 0 for name in K.KERNELS}
    with pytest.raises(TypeError, match="K2 side sum: float32 only"):
        K.k2_side_sum(dg.dst, v_csr, a["pay"])


# --------------------------------------------------------- model, eval mode
@pytest.fixture(scope="module")
def small():
    """tests/test_torch_model.py's small model: random JAX init weights,
    non-trivial BN running statistics."""
    g, _, _, _ = synthetic_assembly_graph(n_reads=300, genome_len=20000,
                                          read_len=400, seed=70,
                                          with_sequences=True,
                                          false_edge_frac=0.15)
    params, state = _np(init_params(jax.random.PRNGKey(4),
                                    JaxModelConfig(**SMALL)))
    rng = np.random.default_rng(0)
    for bn in ("bn_h", "bn_e"):
        s = state["gnn"][bn]
        s["mean"] = rng.normal(0, 0.3, s["mean"].shape).astype(np.float32)
        s["var"] = rng.uniform(0.5, 2.0, s["var"].shape).astype(np.float32)
    gt = GraphTensors.from_graph(g, 128, 128)
    return g, params, state, gt


def _jax_eval(params, state, cfg_kw, gt, g, x, e, flip, backend, tile=128):
    if backend == "pallas":
        gt = with_windowed_plans(gt, flip_too=True, tile_e=tile, window=128)
        set_interpret(True)
    try:
        lo, _ = jax_forward(params, state, gt, gt.pad_nodes(x),
                            gt.pad_edges(e), JaxModelConfig(**cfg_kw),
                            training=False, flip=flip, backend=backend,
                            dtype=jnp.bfloat16)
    finally:
        set_interpret(False)
    lo = np.asarray(lo)
    assert lo.dtype == np.float32
    return lo[: g.num_edges, 0]


def _port_model(params, state, cfg_kw):
    m = SymGatedGCN.from_config(ModelConfig(**cfg_kw))
    m.load_state_dict(module_state_from_numpy(params, state))
    return m


def _port_eval(model, g, x, e, flip):
    with torch.inference_mode():
        lo = model(DeviceGraph.from_graph(g), torch.from_numpy(x),
                   torch.from_numpy(e), flip=flip, dtype=BF)
    assert lo.dtype == torch.float32
    return lo.numpy()[:, 0]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("flip", [False, True])
def test_eval_forward_vs_jax(small, flip, backend):
    g, params, state, gt = small
    x, e = node_features(g, reverse=flip), edge_features(g)
    ref = _jax_eval(params, state, SMALL, gt, g, x, e, flip, backend)
    got = _port_eval(_port_model(params, state, SMALL), g, x, e, flip)
    assert_logits_close(got, ref, f"{backend} flip={flip}")


def test_eval_forward_bf16_is_not_float32(small):
    """The bf16 forward really runs in bf16: it differs from the float32
    forward, by about what bf16 rounding gives, and is bitwise
    reproducible."""
    g, params, state, _ = small
    x, e = node_features(g), edge_features(g)
    m = _port_model(params, state, SMALL)
    got = _port_eval(m, g, x, e, False)
    with torch.inference_mode():
        f32 = m(DeviceGraph.from_graph(g), torch.from_numpy(x),
                torch.from_numpy(e)).numpy()[:, 0]
    assert not np.array_equal(got, f32)
    assert_logits_close(got, f32, "bf16 vs float32")
    assert np.array_equal(got, _port_eval(m, g, x, e, False))


@pytest.fixture(scope="module")
def golden_sub():
    """The golden-subgraph recipe of tests/test_torch_model.py:104-119."""
    g = AssemblyGraph.load(FIXTURE)
    hard = np.nonzero((g.y == 0) & (g.overlap_similarity > 0.95))[0]
    keep = np.zeros(g.num_nodes, dtype=bool)
    keep[:1600] = True
    for eid in hard[:: max(1, len(hard) // 4)][:4]:
        for v in (int(g.src[eid]), int(g.dst[eid])):
            keep[max(0, v - 400): v + 400] = True
    return g.node_subgraph(keep)[0]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("flip", [False, True])
def test_shipped_weights_golden_subgraph_vs_jax(golden_sub, flip, backend):
    g = golden_sub
    params, state = load_model_weights(WEIGHTS)
    x, e = node_features(g, reverse=flip), edge_features(g)
    ref = _jax_eval(params, state, {}, GraphTensors.from_graph(g, 512, 128),
                    g, x, e, flip, backend, tile=512)
    got = _port_eval(_port_model(params, state, {}), g, x, e, flip)
    assert_scores_agree(got, ref, g.y, f"{backend} flip={flip}")


# -------------------------------------------------------- the dual pass
@pytest.fixture(scope="module")
def dual_data():
    """tests/test_torch_dual.py's graph, features and labels, and its
    jittered BN parameters and statistics (2 layers)."""
    g, _, _, _ = synthetic_assembly_graph(n_reads=420, genome_len=40000,
                                          read_len=520, seed=11)
    gt = with_windowed_plans(GraphTensors.build(g.src, g.dst, g.num_nodes,
                                                2048, 512), flip_too=True)
    x, e = node_features(g), edge_features(g)
    y = np.random.default_rng(3).integers(0, 2, g.num_edges).astype(
        np.float32)
    cfg_kw = {**SMALL, "num_gnn_layers": 2}
    params, state = _np(init_params(jax.random.PRNGKey(1),
                                    JaxModelConfig(**cfg_kw)))
    rng = np.random.default_rng(1)
    for bn in ("bn_h", "bn_e"):
        p, s = params["gnn"][bn], state["gnn"][bn]
        p["scale"] = rng.uniform(0.5, 1.5, p["scale"].shape).astype(np.float32)
        p["bias"] = rng.normal(0, 0.1, p["bias"].shape).astype(np.float32)
        s["mean"] = rng.normal(0, 0.3, s["mean"].shape).astype(np.float32)
        s["var"] = rng.uniform(0.5, 2.0, s["var"].shape).astype(np.float32)
    return g, gt, x, e, y, params, state, cfg_kw


def _jax_dual(gt, params, state, x, e, cfg_kw, training, backend):
    """JAX ``forward_dual`` in bf16; the Pallas backend needs interpret
    mode set by the caller."""
    return jax_forward_dual(
        params, state, gt, jnp.asarray(gt.pad_nodes(x)),
        jnp.asarray(gt.pad_nodes(x[:, [1, 0]])),
        jnp.asarray(gt.pad_edges(e)), JaxModelConfig(**cfg_kw),
        training=training, rng=None, backend=backend, dtype=jnp.bfloat16)


def _port_dual(g, model, x, e):
    return model.forward_dual(DeviceGraph.from_graph(g), torch.from_numpy(x),
                              torch.from_numpy(np.ascontiguousarray(
                                  x[:, [1, 0]])),
                              torch.from_numpy(e), dtype=BF)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("training", [False, True])
def test_forward_dual_vs_jax(dual_data, training, backend):
    """Both directions' logits (and in training the BN running state) of
    the port's bf16 ``forward_dual`` against JAX ``forward_dual`` in bf16:
    its fused dual pass (Pallas) or its two sequential passes (XLA)."""
    g, gt, x, e, _, params, state, cfg_kw = dual_data
    set_interpret(backend == "pallas")
    try:
        lo_ref, lr_ref, st_ref = _jax_dual(gt, params, state, x, e, cfg_kw,
                                           training, backend)
    finally:
        set_interpret(False)
    model = _port_model(params, state, cfg_kw).train(training)
    with torch.no_grad():
        lo, lr = _port_dual(g, model, x, e)
    E = g.num_edges
    assert lo.dtype == lr.dtype == torch.float32
    assert_logits_close(lo.numpy()[:, 0], np.asarray(lo_ref)[:E, 0], "org")
    assert_logits_close(lr.numpy()[:, 0], np.asarray(lr_ref)[:E, 0], "flip")
    _, st_got = numpy_from_module_state(model.state_dict())
    a, b = _leaves(st_got), _leaves(st_ref)
    for k in a:
        if np.issubdtype(a[k].dtype, np.floating):
            # float32 statistics of bf16 gates: within 1e-2 of the scale
            np.testing.assert_allclose(a[k], b[k], rtol=1e-2, atol=1e-2,
                                       err_msg=jax.tree_util.keystr(k))
        else:
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_symmetry_loss_gradients_vs_jax(dual_data, backend):
    """The symmetry loss through the port's bf16 ``forward_dual`` and every
    parameter gradient against ``jax.value_and_grad`` of JAX
    ``forward_dual`` in bf16 (the JAX loss_fn, step.py:245-275)."""
    g, gt, x, e, y, params, state, cfg_kw = dual_data
    pw = 1.3
    mask = jnp.asarray(gt.host_prefix_mask(g.num_edges))   # host order
    y_pad = jnp.asarray(gt.pad_edges(y[:, None]))[:, 0]

    def loss_fn(p):
        lo, lr, _ = _jax_dual(gt, p, state, x, e, cfg_kw, True, backend)
        return jax_symmetry_loss(lo[:, 0], lr[:, 0], y_pad, pw, alpha=0.1,
                                 mask=mask)

    # the VJP runs the Pallas kernels too: interpret mode throughout
    set_interpret(backend == "pallas")
    try:
        loss_ref, g_ref = jax.value_and_grad(loss_fn)(params)
    finally:
        set_interpret(False)
    model = _port_model(params, state, cfg_kw).train()
    lo, lr = _port_dual(g, model, x, e)
    loss = symmetry_loss(lo[:, 0], lr[:, 0], torch.from_numpy(y), pw,
                         alpha=0.1)
    loss.backward()
    assert loss.dtype == torch.float32
    assert abs(loss.item() - float(loss_ref)) < LOSS_REL * abs(
        float(loss_ref))
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    grads = {n: p.grad for n, p in model.named_parameters()}
    g_got, _ = numpy_from_module_state({**model.state_dict(), **grads})
    assert_grads_close(g_got, g_ref, backend)


# ---------------------------------------------------------- the train step
def _bf16_cfg(cfg_kw, lr):
    cfg = Config()
    cfg.model = ModelConfig(**cfg_kw)
    cfg.train.lr = lr
    cfg.compute.dtype = "bfloat16"
    return cfg


def test_train_step_vs_jax_make_steps(dual_data):
    """One port ``train_step`` at compute.dtype=bfloat16 against the step of
    JAX ``make_steps`` at dtype=bfloat16 (Pallas, interpret mode): loss,
    logits, and the parameters after Adam at the scale of the lr."""
    g, _, _, _, y, params, state, cfg_kw = dual_data
    rng = np.random.default_rng(17)
    e = rng.normal(size=(g.num_edges, 2)).astype(np.float32)
    lr, pw = 1e-3, 1.7
    jcfg = JaxConfig()
    jcfg.model = JaxModelConfig(**cfg_kw)
    jcfg.train.masking = False
    jcfg.train.lr = lr
    jcfg.compute.backend = "pallas"
    jcfg.compute.dtype = "bfloat16"
    jcfg.compute.edge_pad_multiple = 2048
    jcfg.compute.node_pad_multiple = 512
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
    model = _port_model(params, state, cfg_kw)
    ex = make_example(g.in_degrees(), g.out_degrees(), e, y, g.src, g.dst,
                      g.num_nodes, "cpu")
    loss, logits = train_step(model, make_optimizer(model, lr), ex, pw,
                              _bf16_cfg(cfg_kw, lr), None)
    assert loss.dtype == logits.dtype == torch.float32
    assert abs(float(loss) - float(loss_ref)) < LOSS_REL * abs(
        float(loss_ref))
    assert_logits_close(ex.g.slots_to_edges(logits).numpy(),
                        jax_step.logits_to_host(ex_j, logits_ref), "logits")
    p_got, _ = numpy_from_module_state(model.state_dict())
    a, b = _leaves(p_got), _leaves(p_ref)
    for k in a:
        assert a[k].dtype == np.float32, k
        assert np.abs(a[k] - b[k]).max() <= 2 * lr + 1e-6, k


def test_two_cpu_bf16_train_steps_bitwise_equal(dual_data):
    """Two bf16 steps from one state, dropout 0.2 from one seed: loss,
    logits, gradients, parameters and buffers bitwise equal."""
    g, _, _, e, y, params, state, cfg_kw = dual_data
    cfg = _bf16_cfg({**cfg_kw, "dropout": 0.2}, 1e-3)
    runs = []
    for _ in range(2):
        model = _port_model(params, state, {**cfg_kw, "dropout": 0.2})
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


def test_bf16_dropout_keeps_the_float32_mask():
    """A bf16 tensor keeps the elements a float32 one keeps from the same
    generator state, and is scaled in bf16."""
    x = torch.randn(200, 16, generator=torch.Generator().manual_seed(0))
    a = dropout(x, 0.2, torch.Generator().manual_seed(5))
    b = dropout(x.to(BF), 0.2, torch.Generator().manual_seed(5))
    assert b.dtype == BF
    assert torch.equal(a != 0, b != 0)
    assert torch.equal(b, torch.where(b != 0, x.to(BF) / 0.8,
                                      torch.zeros_like(b)))


@pytest.mark.parametrize("training", [False, True])
def test_batch_norm_bf16_vs_jax(training):
    """BatchNorm of a bf16 input: float32 statistics and normalisation,
    bf16 output, float32 running statistics (norm.py:44-68)."""
    rng = np.random.default_rng(8)
    x = _t2np(_bf(rng.normal(1.0, 2.0, (301, D))))
    p = {"scale": rng.uniform(0.5, 1.5, D).astype(np.float32),
         "bias": rng.normal(0, 0.1, D).astype(np.float32)}
    s = {"mean": rng.normal(0, 1, D).astype(np.float32),
         "var": rng.uniform(0.5, 2, D).astype(np.float32),
         "count": np.int32(0)}
    ref, s_ref = jax_batch_norm(p, s, _jbf(x), jnp.ones((301, 1)), 301,
                                training)
    bn = torch.nn.BatchNorm1d(D).train(training)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(s["mean"]))
        bn.running_var.copy_(torch.from_numpy(s["var"]))
        got = (batch_norm_train(bn, _bf(x)) if training
               else batch_norm_eval(bn, _bf(x)))
    assert got.dtype == BF and bn.running_mean.dtype == torch.float32
    assert_bf16_close(got, np.asarray(ref.astype(jnp.float32)), what="y")
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(s_ref["mean"]), atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(s_ref["var"]), atol=1e-5)


# ------------------------------------------------------------ config, CLI
def test_dtype_set_on_the_command_line():
    cfg = Config().apply_overrides(["compute.dtype=bfloat16",
                                    "compute.device=cpu"])
    assert cfg.compute.dtype == "bfloat16"
    assert compute_dtype(cfg) == BF
    assert compute_dtype(Config()) == torch.float32
    with pytest.raises(ValueError, match="float32|bfloat16"):
        Config().apply_overrides(["compute.dtype=float16"])


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_dtype_from_a_jax_written_config(tmp_path, precision):
    """A JAX-written file with dtype=bfloat16 (at either matmul precision:
    with bf16 operands TF32 does not apply) loads as bfloat16."""
    jcfg = JaxConfig()
    jcfg.compute.dtype = "bfloat16"
    jcfg.compute.matmul_precision = precision
    path = str(tmp_path / "c.json")
    jcfg.save(path)
    cfg = Config.load(path)
    assert dataclasses.asdict(cfg.compute) == {"device": "cuda",
                                               "dtype": "bfloat16"}


@pytest.mark.parametrize("norm", ["layer", "none"])
@pytest.mark.parametrize("route", ["set", "file"])
def test_bf16_refused_for_layer_and_none(tmp_path, norm, route):
    """bfloat16 with layer or no normalisation is no longer refused: the
    ``--set`` route and a JAX-written config both load it, and the compute
    dtype the model gets is bfloat16."""
    if route == "set":
        cfg = Config().apply_overrides([f"model.normalization={norm}",
                                        "compute.dtype=bfloat16"])
    else:
        jcfg = JaxConfig()
        jcfg.model.normalization = norm
        jcfg.compute.dtype = "bfloat16"
        path = str(tmp_path / "c.json")
        jcfg.save(path)
        cfg = Config.load(path)
    assert cfg.model.normalization == norm
    assert cfg.compute.dtype == "bfloat16"
    assert compute_dtype(cfg) == BF


@pytest.mark.parametrize("norm", ["layer", "none"])
def test_model_refuses_bf16_for_layer_and_none(small, norm):
    """The layer-norm and norm-free models run at dtype=bfloat16 (no
    refusal): finite float32 logits that differ from the float32 run's by
    bf16 rounding."""
    g, _, _, _ = small
    model = SymGatedGCN.from_config(ModelConfig(**{**SMALL,
                                                   "normalization": norm}))
    model.init_weights(3)
    args = (DeviceGraph.from_graph(g), torch.from_numpy(node_features(g)),
            torch.from_numpy(edge_features(g)))
    with torch.inference_mode():
        lo16, lo32 = model(*args, dtype=BF), model(*args)
    assert lo16.dtype == torch.float32 and lo16.shape == lo32.shape
    assert not torch.equal(lo16, lo32)
    assert_logits_close(lo16.numpy(), lo32.numpy(), f"{norm} bf16 vs float32")


def test_zoo_ignores_the_compute_dtype(small):
    """A zoo model scores in float32 under compute.dtype=bfloat16, as the
    JAX zoo ignores ``dtype``."""
    g, _, _, _ = small
    cfg = Config()
    cfg.model = ModelConfig(**{**SMALL, "model": "gcn"})
    cfg.compute.device = "cpu"
    from gnnome_tpu_torch.models import get_model
    from gnnome_tpu_torch.models.convert import pytrees_from_model
    params, state = pytrees_from_model(get_model(cfg.model).init_weights(2))
    f32 = score_graph(g, params, state, cfg)
    cfg.compute.dtype = "bfloat16"
    assert np.array_equal(score_graph(g, params, state, cfg), f32)


TINY = ["--set", "model.num_gnn_layers=3", "--set", "model.dim_latent=16",
        "--set", "model.hidden_edge_scores=16"]


@pytest.fixture(scope="module")
def bf16_trained(tmp_path_factory):
    """``cli train`` at compute.dtype=bfloat16 on the CPU: a small synthetic
    dataset, two epochs, masking and clusters of 200 nodes, dropout 0.2."""
    root = tmp_path_factory.mktemp("bf16_train")
    ds = root / "ds"
    for sub in ("processed", "info"):
        (ds / "hifiasm" / sub).mkdir(parents=True)
    g, reads, _, _ = synthetic_assembly_graph(
        n_reads=300, genome_len=25000, read_len=400, seed=13,
        with_sequences=True)
    g.save(str(ds / "hifiasm" / "processed" / "0.npz"))
    reads.save(str(ds / "hifiasm" / "info" / "0_reads.npz"))
    common = ["--train", str(ds), "--valid", str(ds), "--asm", "hifiasm",
              "--set", "compute.device=cpu", "--set", "compute.dtype=bfloat16",
              "--set", "train.num_nodes_per_cluster=200",
              "--set", f"paths.checkpoints_path={root / 'ckpt'}",
              "--set", f"paths.models_path={root / 'models'}", *TINY]

    def run(*extra):
        return cli.main(["train", *common, *extra])

    model_path = run("--name", "b", "--set", "train.num_epochs=2")
    return root, g, run, model_path


def test_cli_train_bf16_saves_a_float32_model(bf16_trained):
    """The epochs log finite losses, and the saved npz is float32 and
    scores in bf16 and in float32."""
    root, g, _, model_path = bf16_trained
    with open(root / "ckpt" / "log_b_seed1.jsonl") as f:
        logs = [json.loads(line) for line in f]
    assert [r["epoch"] for r in logs] == [0, 1]
    assert all(np.isfinite(r["train/loss"]) for r in logs)
    with np.load(model_path) as z:
        assert all(z[k].dtype in (np.float32, np.int32, np.int64)
                   for k in z.files)
    cfg = Config().apply_overrides(["compute.device=cpu", *TINY[1::2]])
    lo32 = score_graph(g, *load_model_weights(model_path), cfg)
    cfg.compute.dtype = "bfloat16"
    lo16 = score_graph(g, *load_model_weights(model_path), cfg)
    assert lo16.dtype == np.float32
    assert_logits_close(lo16, lo32, "bf16 vs float32 scoring")


def test_cli_train_bf16_resume_twice_bitwise_identical(bf16_trained):
    """Resuming a bf16 run twice from one checkpoint writes identical
    checkpoints, equal to those of a run never interrupted."""
    root, _, run, _ = bf16_trained
    ckpt = root / "ckpt"
    for i in range(2):
        run("--name", "b", "--resume", "--set", "train.num_epochs=3")
        os.replace(ckpt / "ckpt_b_seed1_resumed-3.npz", ckpt / f"r{i}.npz")
    run("--name", "c", "--set", "train.num_epochs=3")
    with np.load(ckpt / "r0.npz") as a, np.load(ckpt / "r1.npz") as b, \
            np.load(ckpt / "ckpt_c_seed1.npz") as c:
        assert a.files == b.files == c.files
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
            assert np.array_equal(a[k], c[k]), k


def test_cli_infer_bf16_on_cpu(tmp_path):
    """``cli infer --set compute.dtype=bfloat16`` with the shipped weights
    on an error-free synthetic genome: finite float32 logits for every edge
    and an exact contig.  (The logits are not held to the float32 run's:
    on this graph's near-identical edges bf16 rounding moves single logits
    by several units in the JAX package's bf16 mode as well.)"""
    g, reads, _, genome = synthetic_assembly_graph(
        n_reads=120, genome_len=12_000, read_len=500, seed=1,
        with_sequences=True, false_edge_frac=0.0)
    ds = tmp_path / "ds"
    for sub in ("processed", "info"):
        (ds / "hifiasm" / sub).mkdir(parents=True)
    g.save(str(ds / "hifiasm" / "processed" / "0.npz"))
    reads.save(str(ds / "hifiasm" / "info" / "0_reads.npz"))
    savedir = str(ds / "hifiasm")
    summary = cli.main(["infer", "--data", str(ds), "--asm", "hifiasm",
                        "--out", savedir, "--model", WEIGHTS,
                        "--set", "compute.device=cpu",
                        "--set", "compute.dtype=bfloat16",
                        "--set", "decode.len_threshold=2000",
                        "--set", "decode.num_decoding_paths=10"])
    assert summary["device"] == "cpu"
    contigs = list(read_fastx(os.path.join(savedir, "assembly",
                                           "0_assembly.fasta")))
    top = max(contigs, key=lambda c: len(c.seq))
    assert len(top.seq) >= 2000
    assert top.seq in genome or top.seq in reverse_complement(genome)
    lo16 = np.load(os.path.join(savedir, "decode", "0_predicts.npy"))
    assert lo16.dtype == np.float32 and lo16.shape == (g.num_edges,)
    assert np.isfinite(lo16).all()
