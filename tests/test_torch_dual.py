"""The dual-width symmetry pass of gnnome_tpu_torch (``forward_dual``: both
passes of the symmetry loss as one pass at doubled width, batch norm)
against the JAX package's ``forward_dual`` and the port's own
``forward_pair``, on the CPU (the kernels' plain versions).

The JAX side runs its fused Pallas path in interpret mode on windowed plans,
as tests/test_model_dual.py does; the port runs in float32.  Inputs are
made with numpy from seeds (tests/test_model_dual.py's graph recipe, d=16,
2-3 layers), BatchNorm statistics and scales jittered away from their init
values.  Dropout is 0 wherever the two are compared.

Tolerances: logits ``atol=2e-5, rtol=1e-4`` (tests/test_model_parity.py:76);
BatchNorm running statistics ``1e-5`` and every gradient of the symmetry
loss ``atol=2e-4, rtol=5e-3`` (tests/test_pallas_k4.py:60,81); the loss
``atol=5e-5, rtol=1e-4`` (tests/test_pallas_k4.py:55).  Against its own
``forward_pair`` the port differs only in the order of float32 adds inside
the block-diagonal matmuls, held to the logits' tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnome_tpu.config import Config as JaxConfig
from gnnome_tpu.config import ModelConfig as JaxModelConfig
from gnnome_tpu.graphs import synthetic_assembly_graph as jax_synthetic
from gnnome_tpu.models import edge_features, node_features
from gnnome_tpu.models.norm import batch_norm_dual as jax_batch_norm_dual
from gnnome_tpu.models.sym_gated_gcn import forward_dual as jax_forward_dual
from gnnome_tpu.models.sym_gated_gcn import init_params
from gnnome_tpu.ops import GraphTensors
from gnnome_tpu.ops.graph_tensors import with_windowed_plans
from gnnome_tpu.ops.pallas_kernels import set_interpret
from gnnome_tpu.train import step as jax_step
from gnnome_tpu.train.loss import symmetry_loss as jax_symmetry_loss

from gnnome_tpu_torch.config import Config, ModelConfig
from gnnome_tpu_torch.models import (SymGatedGCN, module_state_from_numpy,
                                     numpy_from_module_state)
from gnnome_tpu_torch.models.norm import batch_norm_dual
from gnnome_tpu_torch.ops import DeviceGraph
from gnnome_tpu_torch.train.loss import symmetry_loss
from gnnome_tpu_torch.train.step import (eval_step, make_example,
                                         make_optimizer, train_step)

LOGIT_TOL = dict(atol=2e-5, rtol=1e-4)
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-4, rtol=5e-3)
LOSS_TOL = dict(atol=5e-5, rtol=1e-4)
SMALL = dict(num_gnn_layers=3, dim_latent=16, hidden_edge_scores=16,
             dropout=0.0)


@pytest.fixture(autouse=True)
def _interpret_mode():
    set_interpret(True)
    yield
    set_interpret(False)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(_np(tree)))


def _assert_trees_close(got, ref, tol, what):
    a, b = _leaves(got), _leaves(ref)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k], np.float64),
                                   np.asarray(b[k], np.float64), **tol,
                                   err_msg=f"{what} {jax.tree_util.keystr(k)}")


def _jittered(layers: int, seed: int):
    """JAX init params and state with non-trivial BatchNorm scales, shifts
    and running statistics."""
    params, state = _np(init_params(jax.random.PRNGKey(seed),
                                    JaxModelConfig(**{**SMALL,
                                                      "num_gnn_layers": layers})))
    rng = np.random.default_rng(seed)
    for bn in ("bn_h", "bn_e"):
        p, s = params["gnn"][bn], state["gnn"][bn]
        p["scale"] = rng.uniform(0.5, 1.5, p["scale"].shape).astype(np.float32)
        p["bias"] = rng.normal(0, 0.1, p["bias"].shape).astype(np.float32)
        s["mean"] = rng.normal(0, 0.3, s["mean"].shape).astype(np.float32)
        s["var"] = rng.uniform(0.5, 2.0, s["var"].shape).astype(np.float32)
    return params, state


def _model(params, state, norm="batch", **kw):
    cfg = ModelConfig(**{**SMALL, **kw, "normalization": norm})
    m = SymGatedGCN.from_config(cfg)
    m.load_state_dict(module_state_from_numpy(params, state, norm))
    return m


@pytest.fixture(scope="module")
def data():
    """tests/test_model_dual.py's graph (windowed plans both ways), its
    features, seeded labels."""
    g, _, _, _ = jax_synthetic(n_reads=420, genome_len=40000, read_len=520,
                               seed=11)
    gt = with_windowed_plans(GraphTensors.build(g.src, g.dst, g.num_nodes,
                                                2048, 512), flip_too=True)
    x = node_features(g)
    e = edge_features(g)
    y = np.random.default_rng(3).integers(0, 2, g.num_edges).astype(
        np.float32)
    return g, gt, x, e, y


def _jax_dual(gt, params, state, x, e, layers, training):
    return jax_forward_dual(
        params, state, gt, jnp.asarray(gt.pad_nodes(x)),
        jnp.asarray(gt.pad_nodes(x[:, [1, 0]])), jnp.asarray(gt.pad_edges(e)),
        JaxModelConfig(**{**SMALL, "num_gnn_layers": layers}),
        training=training, rng=None, backend="pallas")


def _port_dual(g, model, x, e):
    return model.forward_dual(DeviceGraph.from_graph(g), torch.from_numpy(x),
                              torch.from_numpy(np.ascontiguousarray(
                                  x[:, [1, 0]])),
                              torch.from_numpy(e))


# ------------------------------------------------------------- batch_norm_dual
@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_dual_vs_jax(training):
    """Outputs, the running statistics chained org then flip, and the
    count advancing by two."""
    rng = np.random.default_rng(4)
    d = 16
    x2 = np.concatenate([rng.normal(1.0, 2.0, (301, d)),
                         rng.normal(-0.5, 0.7, (301, d))], 1).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, d).astype(np.float32),
         "bias": rng.normal(0, 0.1, d).astype(np.float32)}
    s = {"mean": rng.normal(0, 1, d).astype(np.float32),
         "var": rng.uniform(0.5, 2, d).astype(np.float32),
         "count": np.int32(3)}
    ref, s_ref = jax_batch_norm_dual(p, s, jnp.asarray(x2),
                                     jnp.ones((301, 1)), 301, training)
    bn = torch.nn.BatchNorm1d(d).train(training)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(s["mean"]))
        bn.running_var.copy_(torch.from_numpy(s["var"]))
        bn.num_batches_tracked.fill_(3)
        got = batch_norm_dual(bn, torch.from_numpy(x2))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LOGIT_TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(s_ref["mean"]), **STATE_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(s_ref["var"]), **STATE_TOL)
    assert int(bn.num_batches_tracked) == int(s_ref["count"]) == (
        5 if training else 3)


def test_batch_norm_dual_weight_gradient_sums_both_halves():
    rng = np.random.default_rng(5)
    x2 = torch.from_numpy(rng.normal(size=(50, 8)).astype(np.float32))
    bn = torch.nn.BatchNorm1d(4)
    g_out = torch.from_numpy(rng.normal(size=(50, 8)).astype(np.float32))
    (batch_norm_dual(bn, x2) * g_out).sum().backward()
    y = torch.cat([torch.nn.functional.batch_norm(
        x2[:, k * 4:(k + 1) * 4], None, None, training=True)
        for k in range(2)], 1)
    want = (y * g_out).reshape(50, 2, 4).sum((0, 1))
    torch.testing.assert_close(bn.weight.grad, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(bn.bias.grad, g_out.reshape(50, 2, 4).sum((0, 1)))


# ---------------------------------------------------------- vs JAX forward_dual
@pytest.mark.parametrize("training", [False, True])
def test_forward_dual_vs_jax_forward_dual(data, training):
    """Logits of both directions and the chained BN running state against
    JAX ``forward_dual`` (Pallas, interpret mode)."""
    g, gt, x, e, _ = data
    params, state = _jittered(3, seed=0)
    lo_ref, lr_ref, st_ref = _jax_dual(gt, params, state, x, e, 3, training)
    model = _model(params, state).train(training)
    with torch.no_grad():
        lo, lr = _port_dual(g, model, x, e)
    E = g.num_edges
    np.testing.assert_allclose(lo.numpy()[:, 0], np.asarray(lo_ref)[:E, 0],
                               **LOGIT_TOL)
    np.testing.assert_allclose(lr.numpy()[:, 0], np.asarray(lr_ref)[:E, 0],
                               **LOGIT_TOL)
    _, st_got = numpy_from_module_state(model.state_dict())
    _assert_trees_close(st_got, st_ref, STATE_TOL, "BN state")


def test_symmetry_loss_gradients_vs_jax_forward_dual(data):
    """Every gradient of the symmetry loss through ``forward_dual`` against
    ``jax.value_and_grad`` of JAX ``forward_dual`` (interpret mode)."""
    g, gt, x, e, y = data
    params, state = _jittered(2, seed=1)
    pw = 1.3
    mask = jnp.asarray(gt.host_prefix_mask(g.num_edges))   # host order
    y_pad = jnp.asarray(gt.pad_edges(y[:, None]))[:, 0]

    def loss_fn(p):
        lo, lr, _ = _jax_dual(gt, p, state, x, e, 2, True)
        return jax_symmetry_loss(lo[:, 0], lr[:, 0], y_pad, pw, alpha=0.1,
                                 mask=mask)

    loss_ref, g_ref = jax.value_and_grad(loss_fn)(params)
    model = _model(params, state, num_gnn_layers=2).train()
    lo, lr = _port_dual(g, model, x, e)
    loss = symmetry_loss(lo[:, 0], lr[:, 0], torch.from_numpy(y), pw,
                         alpha=0.1)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), **LOSS_TOL)
    grads = {n: p.grad for n, p in model.named_parameters()}
    g_got, _ = numpy_from_module_state({**model.state_dict(), **grads})
    _assert_trees_close(g_got, _np(g_ref), GRAD_TOL, "gradient")


# ------------------------------------------------------ vs the port's own pair
@pytest.mark.parametrize("training", [False, True])
def test_forward_dual_vs_forward_pair(data, training):
    g, _, x, e, _ = data
    params, state = _jittered(3, seed=2)
    pair = _model(params, state).train(training)
    dual = _model(params, state).train(training)
    dg = DeviceGraph.from_graph(g)
    xs = (torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(
        x[:, [1, 0]])), torch.from_numpy(e))
    with torch.no_grad():
        ref = pair.forward_pair(dg, *xs)
        got = dual.forward_dual(dg, *xs)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **LOGIT_TOL)
    for (k, a), (k2, b) in zip(dual.state_dict().items(),
                               pair.state_dict().items()):
        assert k == k2
        np.testing.assert_allclose(a.numpy(), b.numpy(), **STATE_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("norm", ["layer", "none"])
@pytest.mark.parametrize("training", [False, True])
def test_forward_dual_is_forward_pair_without_batch_norm(data, norm,
                                                         training):
    """Layer norm and none decline the dual mode, as in JAX: the two
    sequential passes, bit for bit."""
    g, _, x, e, _ = data
    cfg = ModelConfig(**{**SMALL, "normalization": norm, "dropout": 0.2})
    pair = SymGatedGCN.from_config(cfg).init_weights(3).train(training)
    dual = SymGatedGCN.from_config(cfg).init_weights(3).train(training)
    dg = DeviceGraph.from_graph(g)
    xs = (torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(
        x[:, [1, 0]])), torch.from_numpy(e))
    with torch.no_grad():
        ref = pair.forward_pair(dg, *xs, torch.Generator().manual_seed(0))
        got = dual.forward_dual(dg, *xs, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


# ----------------------------------------------------------- the train step
@pytest.fixture(scope="module")
def step_data():
    """The train-step recipe of tests/test_torch_train.py (random edge
    features and labels, masking off)."""
    g, _, _, _ = jax_synthetic(n_reads=200, genome_len=20_000, read_len=900,
                               seed=3, with_sequences=False)
    rng = np.random.default_rng(17)
    e = rng.normal(size=(g.num_edges, 2)).astype(np.float32)
    y = (np.random.default_rng(0).random(g.num_edges) < 0.5
         ).astype(np.float32)
    return g, e, y


def test_train_and_eval_steps_run_forward_dual(step_data, monkeypatch):
    """With batch norm ``train_step`` and ``eval_step`` take the dual pass
    (never ``forward_pair``), and their losses are the symmetry loss of
    ``forward_dual`` in training and in eval mode."""
    g, e, y = step_data
    params, state = _jittered(2, seed=4)
    ex = make_example(g.in_degrees(), g.out_degrees(), e, y, g.src, g.dst,
                      g.num_nodes, "cpu")
    cfg = Config()
    cfg.model = ModelConfig(**{**SMALL, "num_gnn_layers": 2})

    def refuse(*_a, **_k):
        raise AssertionError("forward_pair called on the batch-norm step")

    ref_model = _model(params, state, num_gnn_layers=2)
    with torch.no_grad():
        lo, lr = ref_model.eval().forward_dual(ex.g, ex.x, ex.x_rev, ex.e,
                                               slot_io=True)
        eval_ref = symmetry_loss(lo[:, 0], lr[:, 0], ex.labels, 1.5,
                                 alpha=cfg.train.alpha)
        lo, lr = ref_model.train().forward_dual(ex.g, ex.x, ex.x_rev, ex.e,
                                                slot_io=True)
        train_ref = symmetry_loss(lo[:, 0], lr[:, 0], ex.labels, 1.5,
                                  alpha=cfg.train.alpha)
    monkeypatch.setattr(SymGatedGCN, "forward_pair", refuse)
    model = _model(params, state, num_gnn_layers=2)
    loss, _ = eval_step(model, ex, 1.5, cfg)
    assert torch.equal(loss, eval_ref)
    loss, _ = train_step(model, make_optimizer(model, 1e-3), ex, 1.5, cfg,
                         None)
    assert torch.equal(loss, train_ref)


def test_dual_train_step_vs_jax_make_steps_dual(step_data):
    """One port ``train_step`` (the dual pass) against the step of JAX
    ``make_steps`` with its Pallas backend, whose ``loss_fn`` runs its own
    ``forward_dual`` (interpret mode): loss, logits, BN state after the
    step, and the parameters after Adam at the scale of the lr."""
    g, e, y = step_data
    params, state = _jittered(2, seed=5)
    lr, pw = 1e-3, 1.7
    jcfg = JaxConfig()
    jcfg.model = JaxModelConfig(**{**SMALL, "num_gnn_layers": 2})
    jcfg.train.masking = False
    jcfg.train.lr = lr
    jcfg.compute.backend = "pallas"
    jcfg.compute.edge_pad_multiple = 2048
    jcfg.compute.node_pad_multiple = 512
    ex_j = jax_step.make_example(jcfg, g.in_degrees(), g.out_degrees(), e,
                                 y, g.src, g.dst, g.num_nodes)
    tx, jstep, _ = jax_step.make_steps(jcfg)
    p_ref, st_ref, _, loss_ref, logits_ref = jstep(
        params, state, tx.init(params), ex_j.gt, ex_j.x, ex_j.x_rev, ex_j.e,
        ex_j.labels, ex_j.mask, np.float32(pw), jax.random.PRNGKey(7))

    cfg = Config()
    cfg.model = ModelConfig(**{**SMALL, "num_gnn_layers": 2})
    cfg.train.lr = lr
    model = _model(params, state, num_gnn_layers=2)
    ex = make_example(g.in_degrees(), g.out_degrees(), e, y, g.src, g.dst,
                      g.num_nodes, "cpu")
    loss, logits = train_step(model, make_optimizer(model, lr), ex, pw, cfg,
                              None)
    np.testing.assert_allclose(float(loss), float(loss_ref), **LOSS_TOL)
    # the windowed plans' tail-overflow layout moves the JAX side's slots:
    # compare in host edge order
    np.testing.assert_allclose(ex.g.slots_to_edges(logits).numpy(),
                               jax_step.logits_to_host(ex_j, logits_ref),
                               **LOGIT_TOL)
    p_got, st_got = numpy_from_module_state(model.state_dict())
    _assert_trees_close(st_got, st_ref, STATE_TOL, "BN state")
    a, b = _leaves(p_got), _leaves(p_ref)
    for k in a:
        assert np.abs(a[k] - b[k]).max() <= 2 * lr + 1e-6, k
