"""gnnome_tpu_torch training (CPU: the kernels' plain versions) against the
JAX package: the training forward, one whole symmetry-loss train step, the
host-side units, losses and metrics; bitwise-equal steps; ``cli train`` end
to end with resume; models shared between the two packages.

The JAX side runs its XLA backend in float32 (``highest`` matmuls), as its
own tests do.  Dropout is 0 wherever the two are compared: masks from
``jax.random`` and from a ``torch.Generator`` cannot be matched.

Tolerances, those of the JAX package's fused-vs-XLA training tests
(tests/test_pallas_k4.py:55,60,81): logits and forward outputs ``atol=5e-5,
rtol=1e-4``; BatchNorm running statistics ``1e-5``; gradients ``atol=2e-4,
rtol=5e-3``.  Adam is optax's in JAX and ``torch.optim.Adam`` here: the same
update, other rounding, so parameters after a step are compared at the scale
of the learning rate (the first Adam step moves each by about ``lr``).
Models written by one package and scored by the other: ``atol=2e-5,
rtol=1e-4`` (tests/test_model_parity.py:76).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnome_tpu.config import Config as JaxConfig
from gnnome_tpu.config import ModelConfig as JaxModelConfig
from gnnome_tpu.graphs import synthetic_assembly_graph as jax_synthetic
from gnnome_tpu.graphs.container import AssemblyGraph as JaxAssemblyGraph
from gnnome_tpu.graphs.partition import partition_graph as jax_partition
from gnnome_tpu.models import edge_features, node_features
from gnnome_tpu.models.checkpoint import load_model_weights as jax_load_weights
from gnnome_tpu.models.norm import batch_norm as jax_batch_norm
from gnnome_tpu.models.sym_gated_gcn import forward, init_params
from gnnome_tpu.ops import GraphTensors
from gnnome_tpu.train import metrics as jax_metrics
from gnnome_tpu.train import step as jax_step
from gnnome_tpu.train.loss import bce_with_logits as jax_bce
from gnnome_tpu.train.loss import symmetry_loss as jax_symmetry_loss

from gnnome_tpu_torch import cli
from gnnome_tpu_torch.config import Config, ModelConfig
from gnnome_tpu_torch.graphs import synthetic_assembly_graph
from gnnome_tpu_torch.graphs.partition import partition_graph
from gnnome_tpu_torch.infer import score_graph
from gnnome_tpu_torch.models import (SymGatedGCN, load_model_weights,
                                     module_state_from_numpy,
                                     numpy_from_module_state)
from gnnome_tpu_torch.models.nn import dropout
from gnnome_tpu_torch.models.norm import batch_norm_train
from gnnome_tpu_torch.ops import DeviceGraph
from gnnome_tpu_torch.train import metrics
from gnnome_tpu_torch.train.loss import bce_with_logits, symmetry_loss
from gnnome_tpu_torch.train.step import (host_units, make_example,
                                         make_optimizer, train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "weights", "weights.npz")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "golden_ecoli_v1.npz")
FWD_TOL = dict(atol=5e-5, rtol=1e-4)
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-4, rtol=5e-3)
LOGIT_TOL = dict(atol=2e-5, rtol=1e-4)
SMALL = dict(num_gnn_layers=3, dim_latent=16, hidden_edge_scores=16,
             dropout=0.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(_np(tree)))


def _model(params, state, cfg_kw):
    m = SymGatedGCN.from_config(ModelConfig(**cfg_kw))
    m.load_state_dict(module_state_from_numpy(params, state))
    return m


def _assert_trees_close(got, ref, tol, what):
    a, b = _leaves(got), _leaves(ref)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], **tol,
                                   err_msg=f"{what} {jax.tree_util.keystr(k)}")


# ------------------------------------------------------- training forward
@pytest.fixture(scope="module")
def small():
    g, _, _, _ = jax_synthetic(n_reads=300, genome_len=20000, read_len=400,
                               seed=70, with_sequences=True,
                               false_edge_frac=0.15)
    params, state = _np(init_params(jax.random.PRNGKey(4),
                                    JaxModelConfig(**SMALL)))
    rng = np.random.default_rng(0)
    for bn in ("bn_h", "bn_e"):
        s = state["gnn"][bn]
        s["mean"] = rng.normal(0, 0.3, s["mean"].shape).astype(np.float32)
        s["var"] = rng.uniform(0.5, 2.0, s["var"].shape).astype(np.float32)
    return g, params, state


@pytest.fixture(scope="module")
def golden_sub():
    """The golden-subgraph recipe of tests/test_torch_model.py:104-118."""
    g = JaxAssemblyGraph.load(FIXTURE)
    hard = np.nonzero((g.y == 0) & (g.overlap_similarity > 0.95))[0]
    keep = np.zeros(g.num_nodes, dtype=bool)
    keep[:1600] = True
    band = 400
    for eid in hard[:: max(1, len(hard) // 4)][:4]:
        for v in (int(g.src[eid]), int(g.dst[eid])):
            keep[max(0, v - band): v + band] = True
    sub, _, _ = g.node_subgraph(keep)
    assert sub.num_edges > 10_000
    return sub


def _check_training_forward(g, params, state, cfg_kw, flip):
    x, e = node_features(g, reverse=flip), edge_features(g)
    gt = GraphTensors.from_graph(g)
    ref, st_ref = forward(params, state, gt, gt.pad_nodes(x),
                          gt.pad_edges(e), JaxModelConfig(**cfg_kw),
                          training=True, flip=flip, backend="xla")
    model = _model(params, state, cfg_kw).train()
    with torch.no_grad():
        got = model(DeviceGraph.from_graph(g), torch.from_numpy(x),
                    torch.from_numpy(e), flip=flip)
    np.testing.assert_allclose(got.numpy()[:, 0],
                               np.asarray(ref)[: g.num_edges, 0], **FWD_TOL)
    _, st_got = numpy_from_module_state(model.state_dict())
    _assert_trees_close(st_got, st_ref, STATE_TOL, "BN state")


@pytest.mark.parametrize("flip", [False, True])
def test_training_forward_vs_jax_xla_small(small, flip):
    g, params, state = small
    _check_training_forward(g, params, state, SMALL, flip)


@pytest.mark.parametrize("flip", [False, True])
def test_training_forward_vs_jax_xla_shipped_weights(golden_sub, flip):
    params, state = jax_load_weights(WEIGHTS)
    _check_training_forward(golden_sub, params, state, dict(dropout=0.0),
                            flip)


# -------------------------------------------------------------- train step
@pytest.fixture(scope="module")
def step_data():
    """The recipe of tests/test_determinism.py:64-88 (random edge features,
    random labels, masking off) at the small width."""
    g, _, _, _ = jax_synthetic(n_reads=200, genome_len=20_000, read_len=900,
                               seed=3, with_sequences=False)
    rng = np.random.default_rng(17)
    e = rng.normal(size=(g.num_edges, 2)).astype(np.float32)
    y = (np.random.default_rng(0).random(g.num_edges) < 0.5
         ).astype(np.float32)
    params, state = _np(init_params(jax.random.PRNGKey(5),
                                    JaxModelConfig(**SMALL)))
    return g, e, y, params, state


def _port_example(g, e, y, device="cpu"):
    return make_example(g.in_degrees(), g.out_degrees(), e, y, g.src, g.dst,
                        g.num_nodes, device)


def _port_step(data, lr, pos_weight):
    g, e, y, params, state = data
    cfg = Config()
    cfg.model = ModelConfig(**SMALL)
    model = _model(params, state, SMALL)
    opt = make_optimizer(model, lr)
    loss, logits = train_step(model, opt, _port_example(g, e, y), pos_weight,
                              cfg, None)
    grads = {n: p.grad for n, p in model.named_parameters()}
    sd = model.state_dict()
    g_params, _ = numpy_from_module_state({**sd, **grads})
    new_params, new_state = numpy_from_module_state(sd)
    return float(loss), logits.numpy(), g_params, new_params, new_state


def test_symmetry_train_step_vs_jax_make_steps(step_data):
    """One symmetry-loss step: loss, logits, every gradient, BN state after
    the step, and the parameters after Adam at the scale of the lr."""
    g, e, y, params, state = step_data
    lr, pw = 1e-3, 1.7
    cfg = JaxConfig()
    cfg.model = JaxModelConfig(**SMALL)
    cfg.train.masking = False
    cfg.train.lr = lr
    cfg.compute.backend = "xla"
    ex = jax_step.make_example(cfg, g.in_degrees(), g.out_degrees(), e, y,
                               g.src, g.dst, g.num_nodes)
    tx, jstep, _ = jax_step.make_steps(cfg)
    p_ref, st_ref, _, loss_ref, logits_ref = jstep(
        params, state, tx.init(params), ex.gt, ex.x, ex.x_rev, ex.e,
        ex.labels, ex.mask, np.float32(pw), jax.random.PRNGKey(7))

    def loss_fn(p):   # make_steps' loss_fn with the two sequential passes
        lo, st = forward(p, state, ex.gt, ex.x, ex.e, cfg.model,
                         training=True, flip=False, backend="xla",
                         slot_io=True)
        lr_, _ = forward(p, st, ex.gt, ex.x_rev, ex.e, cfg.model,
                         training=True, flip=True, backend="xla",
                         slot_io=True)
        return jax_symmetry_loss(lo[:, 0], lr_[:, 0], ex.labels, pw,
                                 alpha=cfg.train.alpha, mask=ex.mask)

    loss_g, g_ref = jax.value_and_grad(loss_fn)(params)

    loss, logits, g_got, p_got, st_got = _port_step(step_data, lr, pw)
    E = g.num_edges
    np.testing.assert_allclose(loss, float(loss_ref), **FWD_TOL)
    np.testing.assert_allclose(float(loss_g), float(loss_ref), rtol=1e-6)
    # both sides hold edges in the same stable dst-sorted slot order
    np.testing.assert_allclose(logits, np.asarray(logits_ref)[:E],
                               **FWD_TOL)
    _assert_trees_close(g_got, g_ref, GRAD_TOL, "gradient")
    _assert_trees_close(st_got, st_ref, STATE_TOL, "BN state")
    a, b = _leaves(p_got), _leaves(p_ref)
    for k in a:
        assert np.abs(a[k] - b[k]).max() <= 2 * lr + 1e-6, k


def test_two_cpu_train_steps_bitwise_equal(step_data):
    runs = [_port_step(step_data, 1e-3, 1.7) for _ in range(2)]
    (l0, lo0, g0, p0, s0), (l1, lo1, g1, p1, s1) = runs
    assert l0 == l1 and np.array_equal(lo0, lo1)
    for t0, t1 in ((g0, g1), (p0, p1), (s0, s1)):
        a, b = _leaves(t0), _leaves(t1)
        assert all(np.array_equal(a[k], b[k]) for k in a)


# ------------------------------------------------------ layers and helpers
def test_batch_norm_train_vs_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(2.0, 3.0, (257, 16)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
         "bias": rng.normal(0, 0.1, 16).astype(np.float32)}
    s = {"mean": rng.normal(0, 1, 16).astype(np.float32),
         "var": rng.uniform(0.5, 2, 16).astype(np.float32),
         "count": np.int32(3)}
    ref, s_ref = jax_batch_norm(p, s, jnp.asarray(x), jnp.ones((257, 1)),
                                257, training=True, repeat_updates=2)
    bn = torch.nn.BatchNorm1d(16)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(s["mean"]))
        bn.running_var.copy_(torch.from_numpy(s["var"]))
        bn.num_batches_tracked.fill_(3)
        got = batch_norm_train(bn, torch.from_numpy(x), repeat_updates=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(s_ref["mean"]), **STATE_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(s_ref["var"]), **STATE_TOL)
    assert int(bn.num_batches_tracked) == int(s_ref["count"]) == 5


def test_dropout_uses_only_its_generator():
    x = torch.ones(4000, 16)
    before = torch.get_rng_state()
    a = dropout(x, 0.2, torch.Generator().manual_seed(1))
    b = dropout(x, 0.2, torch.Generator().manual_seed(1))
    assert torch.equal(torch.get_rng_state(), before)
    assert torch.equal(a, b)
    kept = a != 0
    assert 0.78 < float(kept.float().mean()) < 0.82
    assert torch.all(a[kept] == 1.0 / 0.8)
    model = SymGatedGCN(num_layers=1, hidden_features=8, dropout=0.2).train()
    with pytest.raises(ValueError, match="Generator"):
        model(None, torch.zeros(2, 2), torch.zeros(1, 2))


def test_losses_vs_jax_and_torch():
    rng = np.random.default_rng(1)
    org = rng.normal(size=300).astype(np.float32)
    rev = rng.normal(size=300).astype(np.float32)
    y = (rng.random(300) < 0.4).astype(np.float32)
    to, tr, ty = (torch.from_numpy(a) for a in (org, rev, y))
    ref = torch.nn.functional.binary_cross_entropy_with_logits(
        to, ty, pos_weight=torch.tensor([2.5]))
    assert abs(float(bce_with_logits(to, ty, 2.5)) - float(ref)) < 1e-6
    assert abs(float(bce_with_logits(to, ty, 2.5))
               - float(jax_bce(org, y, 2.5))) < 1e-6
    mask = (rng.random(300) < 0.7).astype(np.float32)
    got = symmetry_loss(to, tr, ty, 2.5, alpha=0.1,
                        mask=torch.from_numpy(mask))
    want = jax_symmetry_loss(org, rev, y, 2.5, alpha=0.1, mask=mask)
    assert abs(float(got) - float(want)) < 1e-6


def test_metrics_copy_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=500)
    labels = (rng.random(500) < 0.8).astype(np.float32)
    assert (metrics.compute_metrics(logits, labels, 0.5)
            == jax_metrics.compute_metrics(logits, labels, 0.5))


def test_host_units_match_jax():
    """Masking and clustering give the JAX package's units from the same
    numpy seed: the same nodes, edges, features and labels."""
    kw = dict(n_reads=300, genome_len=25000, read_len=400, seed=13,
              with_sequences=True)
    g_port, g_jax = synthetic_assembly_graph(**kw)[0], jax_synthetic(**kw)[0]
    cfg, jcfg = Config(), JaxConfig()
    for c in (cfg, jcfg):
        c.train.num_nodes_per_cluster = 200
    got = host_units(g_port, cfg, np.random.default_rng(9))
    ref = jax_step.host_units(g_jax, jcfg, np.random.default_rng(9))
    assert len(got) == len(ref) > 1
    for a, b in zip(got, ref):
        for f in ("in_deg", "out_deg", "e_feat", "y", "src", "dst",
                  "n_nodes"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    parts = partition_graph(g_port, 4)
    jparts = jax_partition(g_jax, 4)
    for a, b in zip(parts, jparts):
        np.testing.assert_array_equal(a.orig_edges, b.orig_edges)


# ---------------------------------------------------------- cli train, CPU
TINY_MODEL = ["--set", "model.num_gnn_layers=3", "--set",
              "model.dim_latent=16", "--set", "model.hidden_edge_scores=16"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``cli train`` on a small synthetic dataset: 2 epochs, masking on,
    clusters of 200 nodes (600-node graph), symmetry loss, dropout 0.2."""
    root = tmp_path_factory.mktemp("torch_train")
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
              "--set", f"paths.models_path={root / 'models'}", *TINY_MODEL]

    def run(*extra):
        return cli.main(["train", *common, *extra])

    model_path = run("--name", "t", "--set", "train.num_epochs=2")
    return root, g, run, model_path


def test_cli_train_cpu_logs_epochs_and_saves_model(trained):
    root, g, _, model_path = trained
    assert model_path.endswith("model_t_seed1.npz")
    with open(root / "ckpt" / "log_t_seed1.jsonl") as f:
        logs = [json.loads(line) for line in f]
    assert [r["epoch"] for r in logs] == [0, 1]
    assert all(np.isfinite(r["train/loss"]) and np.isfinite(r["valid/loss"])
               for r in logs)
    # the saved model loads in the port's infer
    cfg = Config()
    cfg.compute.device = "cpu"
    cfg.model = ModelConfig(num_gnn_layers=3, dim_latent=16,
                            hidden_edge_scores=16)
    logits = score_graph(g, *load_model_weights(model_path), cfg)
    assert logits.shape == (g.num_edges,) and np.isfinite(logits).all()


def test_cli_train_resume_twice_bitwise_identical(trained):
    """Resuming twice from one checkpoint writes identical checkpoints, and
    they equal the checkpoint of a run that was never interrupted."""
    root, _, run, _ = trained
    ckpt = root / "ckpt"
    for i in range(2):
        run("--name", "t", "--resume", "--set", "train.num_epochs=3")
        os.replace(ckpt / "ckpt_t_seed1_resumed-3.npz", ckpt / f"r{i}.npz")
    run("--name", "u", "--set", "train.num_epochs=3")
    with np.load(ckpt / "r0.npz") as a, np.load(ckpt / "r1.npz") as b, \
            np.load(ckpt / "ckpt_u_seed1.npz") as c:
        assert a.files == b.files == c.files
        assert any(k.startswith("opt/") for k in a.files)
        assert any(k.startswith("rng/") for k in a.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
            assert np.array_equal(a[k], c[k]), k


def test_port_trained_model_scores_the_same_in_jax(trained):
    """A model that the port's ``cli train`` saved loads through the JAX
    package's ``load_model_weights``; JAX XLA and the port give the same
    logits."""
    _, g, _, model_path = trained
    params, state = jax_load_weights(model_path)
    cfg_kw = dict(num_gnn_layers=3, dim_latent=16, hidden_edge_scores=16)
    gt = GraphTensors.from_graph(g)
    x, e = node_features(g), edge_features(g)
    ref, _ = forward(params, state, gt, gt.pad_nodes(x), gt.pad_edges(e),
                     JaxModelConfig(**cfg_kw), training=False, backend="xla")
    m = _model(*load_model_weights(model_path), cfg_kw)
    with torch.inference_mode():
        got = m(DeviceGraph.from_graph(g), torch.from_numpy(x),
                torch.from_numpy(e))
    np.testing.assert_allclose(got.numpy()[:, 0],
                               np.asarray(ref)[: g.num_edges, 0],
                               **LOGIT_TOL)


def test_example_is_in_slot_order():
    g, _, _, _ = synthetic_assembly_graph(n_reads=40, genome_len=3000,
                                          read_len=300, seed=0)
    rng = np.random.default_rng(4)
    e = rng.normal(size=(g.num_edges, 2)).astype(np.float32)
    y = (rng.random(g.num_edges) < 0.5).astype(np.float32)
    ex = _port_example(g, e, y)
    dg = DeviceGraph.from_graph(g)
    assert torch.equal(ex.e, dg.edges_to_slots(torch.from_numpy(e)))
    assert torch.equal(ex.labels, dg.edges_to_slots(torch.from_numpy(y)))
    assert np.array_equal(ex.labels_host, ex.labels.numpy())


def test_overfit_run_learns_on_cpu(tmp_path):
    """The overfit recipe ``chip_smoke.py`` runs on the card (that of
    tests/test_train.py:131-170: 12 epochs, lr 1e-3, full width, dropout
    0.2), here on the CPU: the loss drops by 10% and the saved model ranks
    the true edges (AP > 0.75)."""
    import sys
    sys.path.insert(0, ROOT)
    try:
        from chip_smoke import (OVERFIT_GRAPH, OVERFIT_LOSS_DROP,
                                OVERFIT_MIN_AP, write_dataset)
    finally:
        sys.path.remove(ROOT)
    g, reads, _, _ = synthetic_assembly_graph(**OVERFIT_GRAPH)
    ds = write_dataset(str(tmp_path / "ds"), g, reads)
    best = cli.main(["train", "--train", ds, "--valid", ds, "--asm",
                     "hifiasm", "--name", "o", "--overfit",
                     "--set", "compute.device=cpu",
                     "--set", f"paths.checkpoints_path={tmp_path}",
                     "--set", f"paths.models_path={tmp_path}",
                     "--set", "train.num_epochs=12", "--set", "train.lr=1e-3",
                     "--set", "train.masking=false",
                     "--set", "train.num_nodes_per_cluster=10000"])
    with open(tmp_path / "log_o_seed1.jsonl") as f:
        losses = [json.loads(line)["train/loss"] for line in f]
    assert len(losses) == 12
    assert losses[-1] < OVERFIT_LOSS_DROP * losses[0]
    cfg = Config()
    cfg.compute.device = "cpu"
    logits = score_graph(g, *load_model_weights(best), cfg)
    assert metrics.get_aps(logits, g.y) > OVERFIT_MIN_AP
