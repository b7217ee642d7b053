"""The model zoo of gnnome_tpu_torch (GatedGCN, GCN, GAT, SAGE; CPU: the
plain version of the one-sided K2 walk) against the JAX package's zoo.

For each model, directed and undirected: eval logits against the JAX
forward (XLA, ``highest`` matmul precision), every gradient of the BCE loss
of a training forward against ``jax.grad`` through the converter,
GatedGCN's BatchNorm state after a training forward, one ``train_step``
against the step of JAX ``make_steps``; the converter's round trip, models
saved by one package scored by the other, ``cli train`` and ``cli infer``
with every zoo name, a bitwise resume; ``sum_into`` / ``gather_rows``
against ``np.add.at`` and under gradcheck.

Inputs come from numpy seeds and JAX init weights (d=16, 3 layers).
Tolerances: logits ``atol=2e-5, rtol=1e-4`` (tests/test_model_parity.py:76);
gradients ``atol=2e-4, rtol=5e-3`` and BatchNorm state ``1e-5``
(tests/test_pallas_k4.py:60,81); the loss ``atol=5e-5, rtol=1e-4``
(tests/test_pallas_k4.py:55); parameters after one Adam step within 2 lr
(each moves by about lr); the one-sided walk's plain version bit-equal to
``np.add.at`` (both add each node's rows in slot order).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from gnnome_tpu.config import Config as JaxConfig
from gnnome_tpu.config import ModelConfig as JaxModelConfig
from gnnome_tpu.graphs import synthetic_assembly_graph as jax_synthetic
from gnnome_tpu.infer import score_graph as jax_score_graph
from gnnome_tpu.models import edge_features, node_features
from gnnome_tpu.models.checkpoint import load_pytrees as jax_load_pytrees
from gnnome_tpu.models.checkpoint import save_model_weights as jax_save
from gnnome_tpu.models.zoo import get_model as jax_get_model
from gnnome_tpu.models.zoo import processor_graph_for
from gnnome_tpu.ops import GraphTensors
from gnnome_tpu.train import step as jax_step
from gnnome_tpu.train.loss import bce_with_logits as jax_bce

from gnnome_tpu_torch import cli
from gnnome_tpu_torch.config import Config, ModelConfig
from gnnome_tpu_torch.graphs import synthetic_assembly_graph
from gnnome_tpu_torch.infer import score_graph
from gnnome_tpu_torch.models import (get_model, load_model_pytrees,
                                     load_model_weights, pytrees_from_model)
from gnnome_tpu_torch.models.convert import (zoo_module_state_from_numpy,
                                             zoo_numpy_from_module_state)
from gnnome_tpu_torch.models.zoo import (ZOO, add_reverse_edges,
                                         add_self_loop, processor_graph)
from gnnome_tpu_torch.ops import DeviceGraph, gather_rows, sum_into
from gnnome_tpu_torch.ops import kernels as K
from gnnome_tpu_torch.train.loss import bce_with_logits
from gnnome_tpu_torch.train.step import (make_example, make_optimizer,
                                         train_step)

NAMES = ["gatedgcn", "gcn", "gat", "sage"]
LOGIT_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=2e-4, rtol=5e-3)
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_TOL = dict(atol=5e-5, rtol=1e-4)
SMALL = dict(num_gnn_layers=3, dim_latent=16, hidden_edge_scores=16,
             dropout=0.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(_np(tree)))


def _assert_trees_close(got, ref, tol, what):
    a, b = _leaves(got), _leaves(ref)
    assert a.keys() == b.keys(), (sorted(a), sorted(b))
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k], np.float64),
                                   np.asarray(b[k], np.float64), **tol,
                                   err_msg=f"{what} {jax.tree_util.keystr(k)}")


def _cfgs(name, directed, **kw):
    kw = {**SMALL, "model": name, "directed": directed, **kw}
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _jax_init(name, jcfg, seed):
    """JAX init weights; the GatedGCN's BatchNorm scales and running
    statistics jittered away from their init values."""
    params, state = _np(jax_get_model(name)[0](jax.random.PRNGKey(seed),
                                               jcfg))
    if name == "gatedgcn":
        rng = np.random.default_rng(seed)
        for bn in ("bn_h", "bn_e"):
            p, s = params["gnn"][bn], state["gnn"][bn]
            p["scale"] = rng.uniform(0.5, 1.5, p["scale"].shape).astype(
                np.float32)
            p["bias"] = rng.normal(0, 0.1, p["bias"].shape).astype(np.float32)
            s["mean"] = rng.normal(0, 0.3, s["mean"].shape).astype(np.float32)
            s["var"] = rng.uniform(0.5, 2.0, s["var"].shape).astype(np.float32)
    return params, state


def _port_model(cfg, params, state):
    m = get_model(cfg)
    load_model_pytrees(m, params, state)
    return m


@pytest.fixture(scope="module")
def graph():
    g, _, _, _ = jax_synthetic(n_reads=150, genome_len=12000, read_len=400,
                               seed=30, with_sequences=True,
                               false_edge_frac=0.1)
    return g


def _jax_forward(name, jcfg, g, params, state, training, x=None, e=None):
    gt = GraphTensors.from_graph(g, 256, 64)
    gt_proc = processor_graph_for(name, g, jcfg, 256, 64)
    x = node_features(g) if x is None else x
    e = edge_features(g) if e is None else e
    with jax.default_matmul_precision("highest"):
        return jax_get_model(name)[1](
            params, state, gt, gt.pad_nodes(x), gt.pad_edges(e), jcfg,
            training=training, rng=None, gt_proc=gt_proc)


def _port_forward(model, cfg, g, x=None, e=None):
    x = node_features(g) if x is None else x
    e = edge_features(g) if e is None else e
    return model(DeviceGraph.from_graph(g), torch.from_numpy(x),
                 torch.from_numpy(e),
                 processor_graph(cfg, g.src, g.dst, g.num_nodes))


# ------------------------------------------------------------ forward + grads
@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_zoo_eval_logits_vs_jax(graph, name, directed):
    jcfg, cfg = _cfgs(name, directed)
    params, state = _jax_init(name, jcfg, seed=1)
    ref, _ = _jax_forward(name, jcfg, graph, params, state, False)
    with torch.no_grad():
        got = _port_forward(_port_model(cfg, params, state), cfg, graph)
    E = graph.num_edges
    np.testing.assert_allclose(got.numpy()[:, 0], np.asarray(ref)[:E, 0],
                               **LOGIT_TOL)


@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_zoo_bce_gradients_vs_jax(graph, name, directed):
    """A training forward (batch statistics, dropout 0): the BCE loss, every
    gradient, and the GatedGCN's BatchNorm state after it."""
    jcfg, cfg = _cfgs(name, directed)
    params, state = _jax_init(name, jcfg, seed=2)
    E = graph.num_edges
    y = (np.random.default_rng(5).random(E) < 0.6).astype(np.float32)
    pw = 1.4

    def loss_fn(p):
        lo, st = _jax_forward(name, jcfg, graph, p, state, True)
        return jax_bce(lo[:E, 0], y, pw), st

    (loss_ref, st_ref), g_ref = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    model = _port_model(cfg, params, state).train()
    loss = bce_with_logits(_port_forward(model, cfg, graph)[:, 0],
                           torch.from_numpy(y), pw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), **LOSS_TOL)
    grads = {n: p.grad for n, p in model.named_parameters()}
    g_got, st_got = zoo_numpy_from_module_state(
        name, {**model.state_dict(), **grads})
    _assert_trees_close(g_got, _np(g_ref), GRAD_TOL, f"{name} gradient")
    if name == "gatedgcn":
        _assert_trees_close(st_got, st_ref, STATE_TOL, "BN state")


@pytest.mark.parametrize("name", NAMES)
def test_zoo_train_step_vs_jax_make_steps(graph, name):
    """One port ``train_step`` (plain BCE, one flip=False pass) against the
    step of JAX ``make_steps`` (XLA): loss, logits and the parameters after
    Adam at the scale of the lr."""
    lr, pw = 1e-3, 1.7
    jcfg_m, cfg_m = _cfgs(name, True)
    params, state = _jax_init(name, jcfg_m, seed=3)
    rng = np.random.default_rng(17)
    E = graph.num_edges
    e = rng.normal(size=(E, 2)).astype(np.float32)
    y = (rng.random(E) < 0.5).astype(np.float32)
    jcfg = JaxConfig()
    jcfg.model = jcfg_m
    jcfg.train.masking = False
    jcfg.train.lr = lr
    jcfg.compute.backend = "xla"
    jcfg.compute.edge_pad_multiple = 256
    jcfg.compute.node_pad_multiple = 64
    ex_j = jax_step.make_example(jcfg, graph.in_degrees(),
                                 graph.out_degrees(), e, y, graph.src,
                                 graph.dst, graph.num_nodes)
    gt_proc = processor_graph_for(name, graph, jcfg_m, 256, 64)
    tx, jstep, _ = jax_step.make_steps(jcfg)
    with jax.default_matmul_precision("highest"):
        p_ref, _, _, loss_ref, logits_ref = jstep(
            params, state, tx.init(params), ex_j.gt, ex_j.x, ex_j.x_rev,
            ex_j.e, ex_j.labels, ex_j.mask, np.float32(pw),
            jax.random.PRNGKey(7), gt_proc=gt_proc)

    cfg = Config()
    cfg.model = cfg_m
    model = _port_model(cfg_m, params, state)
    ex = make_example(graph.in_degrees(), graph.out_degrees(), e, y,
                      graph.src, graph.dst, graph.num_nodes, "cpu", cfg_m)
    loss, logits = train_step(model, make_optimizer(model, lr), ex, pw, cfg,
                              None)
    np.testing.assert_allclose(float(loss), float(loss_ref), **LOSS_TOL)
    np.testing.assert_allclose(ex.g.slots_to_edges(logits).numpy(),
                               jax_step.logits_to_host(ex_j, logits_ref),
                               **LOGIT_TOL)
    a, b = _leaves(pytrees_from_model(model)[0]), _leaves(p_ref)
    assert a.keys() == b.keys()
    for k in a:
        assert np.abs(a[k] - b[k]).max() <= 2 * lr + 1e-6, k


def test_two_cpu_zoo_steps_bitwise_equal(graph):
    """Two GAT steps from one state, dropout 0.2 from one seed."""
    _, cfg_m = _cfgs("gat", False, dropout=0.2)
    cfg = Config()
    cfg.model = cfg_m
    y = (np.random.default_rng(0).random(graph.num_edges) < 0.5).astype(
        np.float32)
    ex = make_example(graph.in_degrees(), graph.out_degrees(),
                      edge_features(graph), y, graph.src, graph.dst,
                      graph.num_nodes, "cpu", cfg_m)
    runs = []
    for _ in range(2):
        model = get_model(cfg_m).init_weights(4)
        loss, logits = train_step(model, make_optimizer(model, 1e-3), ex,
                                  1.0, cfg, torch.Generator().manual_seed(9))
        runs.append((loss, logits, [p.detach().clone()
                                    for p in model.parameters()]))
    (l0, lo0, p0), (l1, lo1, p1) = runs
    assert torch.equal(l0, l1) and torch.equal(lo0, lo1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


# ------------------------------------------------------------------ weights
@pytest.mark.parametrize("name", NAMES)
def test_zoo_convert_round_trip_exact(name):
    jcfg, cfg = _cfgs(name, True, normalization="batch")
    params, state = _jax_init(name, jcfg, seed=6)
    sd = zoo_module_state_from_numpy(name, params, state)
    p2, s2 = zoo_numpy_from_module_state(name, sd)
    a, b = _leaves(p2), _leaves(params)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    a, b = _leaves(s2), _leaves(state)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    model = get_model(cfg).init_weights(3)
    load_model_pytrees(model, *pytrees_from_model(model))
    sd3 = zoo_module_state_from_numpy(name, *pytrees_from_model(model))
    assert all(torch.equal(v, sd3[k]) for k, v in model.state_dict().items())


@pytest.mark.parametrize("name", NAMES)
def test_jax_saved_zoo_npz_scores_the_same(graph, name, tmp_path):
    """An npz the JAX package saved for a zoo model: the same logits from
    both packages' ``score_graph``."""
    jcfg_full = JaxConfig()
    jcfg_full.model, cfg_m = _cfgs(name, False)
    jcfg_full.compute.edge_pad_multiple = 256
    jcfg_full.compute.node_pad_multiple = 64
    params, state = _jax_init(name, jcfg_full.model, seed=8)
    path = str(tmp_path / "m.npz")
    jax_save(path, params, state)
    trees = jax_load_pytrees(path)
    with jax.default_matmul_precision("highest"):
        ref = jax_score_graph(graph, trees["params"], trees.get("state", {}),
                              jcfg_full)
    cfg = Config()
    cfg.model = cfg_m
    cfg.compute.device = "cpu"
    got = score_graph(graph, *load_model_weights(path), cfg)
    np.testing.assert_allclose(got, ref, **LOGIT_TOL)


# ------------------------------------------------------------------ the walk
@pytest.mark.parametrize("side", ["dst", "src"])
def test_side_sum_plain_bitwise_vs_np_add_at(graph, side):
    dg = DeviceGraph.from_graph(graph)
    rng = np.random.default_rng(2)
    pay = rng.normal(size=(graph.num_edges, 7)).astype(np.float32)
    idx = (dg.dst if side == "dst" else dg.src).numpy()
    want = np.zeros((graph.num_nodes, 7), np.float32)
    np.add.at(want, idx, pay)
    got = sum_into(dg, side, torch.from_numpy(pay))
    assert np.array_equal(got.numpy(), want)
    _, _, by_dst, by_src = dg.roles(False)
    K.reset_launch_counts()
    plain = K.k2_side_sum(torch.from_numpy(idx),
                          by_dst if side == "dst" else by_src,
                          torch.from_numpy(pay))
    assert np.array_equal(plain.numpy(), want)
    assert K.launch_counts()["k2_side_sum"] == 0     # CPU: plain version


@pytest.mark.parametrize("side", ["dst", "src"])
def test_sum_into_and_gather_rows_gradcheck(side):
    src = np.array([0, 2, 2, 1, 3, 0, 4, 2])
    dst = np.array([1, 1, 0, 3, 3, 2, 2, 4])
    dg = DeviceGraph.build(src, dst, 6)        # node 5 has no edges
    rng = np.random.default_rng(0)
    pay = torch.from_numpy(rng.normal(size=(8, 3))).requires_grad_()
    h = torch.from_numpy(rng.normal(size=(6, 3))).requires_grad_()
    assert torch.autograd.gradcheck(lambda p: sum_into(dg, side, p), (pay,))
    assert torch.autograd.gradcheck(lambda t: gather_rows(dg, side, t), (h,))


def test_processor_graphs_match_jax(graph):
    """The transformed edge lists in host order, as JAX builds them."""
    for name in NAMES:
        for directed in (True, False):
            jcfg, cfg = _cfgs(name, directed)
            ref = processor_graph_for(name, graph, jcfg, 256, 64)
            got = processor_graph(cfg, graph.src, graph.dst, graph.num_nodes)
            assert (ref is None) == (got is None), (name, directed)
            if got is None:
                continue
            E = ref.n_edges
            src, dst = graph.src, graph.dst
            if not directed:
                src, dst = add_reverse_edges(src, dst)
            if ZOO[name].kind != "gatedgcn":
                src, dst = add_self_loop(src, dst, graph.num_nodes)
            eid = got.eid_of_slot.numpy()
            assert np.array_equal(got.src.numpy(), src[eid])
            assert np.array_equal(got.dst.numpy(), dst[eid])
            assert got.n_edges == E == src.shape[0]


# ---------------------------------------------------------------- cli
@pytest.fixture(scope="module")
def zoo_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_cli")
    g, reads, _, _ = synthetic_assembly_graph(n_reads=120, genome_len=10000,
                                              read_len=400, seed=12,
                                              with_sequences=True)
    ds = root / "ds"
    for sub in ("processed", "info"):
        (ds / "hifiasm" / sub).mkdir(parents=True)
    g.save(str(ds / "hifiasm" / "processed" / "0.npz"))
    reads.save(str(ds / "hifiasm" / "info" / "0_reads.npz"))
    return root, str(ds), g


TINY = ["--set", "model.num_gnn_layers=2", "--set", "model.dim_latent=8",
        "--set", "model.hidden_edge_scores=8", "--set", "compute.device=cpu"]


@pytest.mark.parametrize("name", NAMES)
def test_cli_train_then_infer_with_zoo_model(zoo_dataset, name):
    """``cli train --set model.model=NAME`` saves a model that ``cli
    infer`` decodes with, and that the JAX package scores the same."""
    root, ds, g = zoo_dataset
    out = root / name
    common = [*TINY, "--set", f"model.model={name}"]
    model_path = cli.main(["train", "--train", ds, "--valid", ds, "--asm",
                           "hifiasm", "--name", name, *common,
                           "--set", "train.num_epochs=1",
                           "--set", f"paths.checkpoints_path={out}",
                           "--set", f"paths.models_path={out}"])
    with open(out / f"log_{name}_seed1.jsonl") as f:
        log = [json.loads(line) for line in f]
    assert len(log) == 1 and np.isfinite(log[0]["train/loss"])
    summary = cli.main(["infer", "--data", ds, "--asm", "hifiasm", "--out",
                        str(out / "asm"), "--model", model_path, *common,
                        "--set", "decode.len_threshold=1000"])
    assert summary["graphs"] and summary["device"] == "cpu"
    assert os.path.isfile(out / "asm" / "decode" / "0_predicts.npy")
    # the port's npz in the JAX package
    jcfg = JaxConfig()
    jcfg.model = JaxModelConfig(model=name, num_gnn_layers=2, dim_latent=8,
                                hidden_edge_scores=8)
    jcfg.compute.edge_pad_multiple = 256
    jcfg.compute.node_pad_multiple = 64
    trees = jax_load_pytrees(model_path)
    with jax.default_matmul_precision("highest"):
        ref = jax_score_graph(g, trees["params"], trees.get("state", {}),
                              jcfg)
    got = np.load(out / "asm" / "decode" / "0_predicts.npy")
    np.testing.assert_allclose(got, ref, **LOGIT_TOL)


def test_cli_train_zoo_resume_bitwise(zoo_dataset):
    """Resuming a GatedGCN run (dropout 0.2, masking) twice from one
    checkpoint writes identical checkpoints, equal to an uninterrupted
    run's."""
    root, ds, _ = zoo_dataset
    ck = root / "resume"
    common = ["train", "--train", ds, "--valid", ds, "--asm", "hifiasm",
              *TINY, "--set", "model.model=gatedgcn",
              "--set", "model.directed=false",
              "--set", f"paths.checkpoints_path={ck}",
              "--set", f"paths.models_path={ck}"]
    cli.main([*common, "--name", "t", "--set", "train.num_epochs=1"])
    for i in range(2):
        cli.main([*common, "--name", "t", "--resume",
                  "--set", "train.num_epochs=2"])
        os.replace(ck / "ckpt_t_seed1_resumed-2.npz", ck / f"r{i}.npz")
    cli.main([*common, "--name", "u", "--set", "train.num_epochs=2"])
    with np.load(ck / "r0.npz") as a, np.load(ck / "r1.npz") as b, \
            np.load(ck / "ckpt_u_seed1.npz") as c:
        assert a.files == b.files == c.files
        assert any(k.startswith("state/gnn/bn_h") for k in a.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
            assert np.array_equal(a[k], c[k]), k
