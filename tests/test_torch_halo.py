"""gnnome_tpu_torch's halo-exchange graph parallelism (``parallel/halo.py``)
on CPU ranks over gloo: the plan against a brute-force map, the exchange
against a single-process reference and its adjoints, and the eval forward
at P = 2 and 4 against the port's single-device forward and the JAX
package's halo path on a mesh of P virtual CPU devices.

Each P runs every rank job of this file in one spawned group (a
module-scoped fixture); the rank functions live in the package
(``gnnome_tpu_torch.parallel.checks``), since spawned ranks import them.

Graphs: the synthetic assembly graphs of tests/test_halo.py:23-32 (no false
edges, seed 60) and :123-133 (1% false edges: overflow rows), a random
graph with no banded plan (tests/test_halo.py:151), the golden subgraph
(tests/test_torch_model.py:104-118), whose capped plan fails in both node
orders, and the node-shuffled graph of tests/test_halo.py:170, which
``band_order`` re-bands.  Shipped weights (batch norm, d=64, 8 layers).

Tolerances: halo vs single-device logits ``atol=5e-5, rtol=1e-4`` (the
forward tolerance of tests/test_torch_train.py:62: node sums and batch
statistics add their terms in another order); vs the JAX halo path
``atol=2e-5, rtol=1e-4`` (tests/test_model_parity.py:76); the exchange
moves float64 values and adds float64 partials: ``rtol=1e-12``.
"""
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from gnnome_tpu.config import Config as JaxConfig
from gnnome_tpu.graphs import synthetic_assembly_graph as jax_synthetic
from gnnome_tpu.graphs.container import AssemblyGraph as JaxAssemblyGraph
from gnnome_tpu.models.checkpoint import load_model_weights as jax_weights
from gnnome_tpu.parallel import make_mesh
from gnnome_tpu.parallel.halo import halo_score_graph as jax_halo_score

from gnnome_tpu_torch.config import Config
from gnnome_tpu_torch.infer import load_model, score_graph
from gnnome_tpu_torch.models import (edge_features, load_model_weights,
                                     node_features)
from gnnome_tpu_torch.ops import DeviceGraph
from gnnome_tpu_torch.parallel import checks, halo
from gnnome_tpu_torch.parallel.group import spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "weights", "weights.npz")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "golden_ecoli_v1.npz")
FWD_TOL = dict(atol=5e-5, rtol=1e-4)
LOGIT_TOL = dict(atol=2e-5, rtol=1e-4)
EXACT_TOL = dict(atol=1e-12, rtol=1e-12)
GRAPHS = ("banded", "overflow", "unbanded", "golden_sub", "shuffled")
EX_SEED, EX_WIDTH = 3, 5


def _synthetic(seed, false_edge_frac):
    g, _, _, _ = jax_synthetic(n_reads=512, genome_len=40000, read_len=500,
                               seed=seed, with_sequences=True,
                               false_edge_frac=false_edge_frac)
    return g


def _golden_sub():
    g = JaxAssemblyGraph.load(FIXTURE)
    hard = np.nonzero((g.y == 0) & (g.overlap_similarity > 0.95))[0]
    keep = np.zeros(g.num_nodes, dtype=bool)
    keep[:1600] = True
    band = 400
    for eid in hard[:: max(1, len(hard) // 4)][:4]:
        for v in (int(g.src[eid]), int(g.dst[eid])):
            keep[max(0, v - band): v + band] = True
    sub, _, _ = g.node_subgraph(keep)
    return sub


def _shuffled():
    """tests/test_halo.py:170-189: RC pairs permuted at random."""
    g = _synthetic(5, 0.0)
    rng = np.random.default_rng(4)
    pair_perm = rng.permutation(g.num_nodes // 2)
    new_of_old = np.empty(g.num_nodes, dtype=np.int64)
    new_of_old[0::2] = 2 * pair_perm
    new_of_old[1::2] = 2 * pair_perm + 1
    old_of_new = np.argsort(new_of_old)
    return dataclasses.replace(
        g, src=new_of_old[g.src].astype(g.src.dtype),
        dst=new_of_old[g.dst].astype(g.dst.dtype),
        read_length=g.read_length[old_of_new], _csr=None, _csc=None)


@dataclasses.dataclass
class Arrays:
    src: np.ndarray
    dst: np.ndarray
    n: int
    x: np.ndarray
    e: np.ndarray


def _arrays(name) -> Arrays:
    if name == "unbanded":     # tests/test_halo.py:151-167
        rng = np.random.default_rng(0)
        n = 512
        src = rng.integers(0, n, 4000)
        dst = rng.integers(0, n, 4000)
        deg = [np.bincount(a, minlength=n).astype(np.float32)
               for a in (dst, src)]
        x = np.stack([(v - v.mean()) / v.std(ddof=1) for v in deg], 1)
        e = rng.normal(size=(4000, 2)).astype(np.float32)
        return Arrays(src, dst, n, x.astype(np.float32), e)
    g = {"banded": lambda: _synthetic(60, 0.0),
         "overflow": lambda: _synthetic(77, 0.01),
         "golden_sub": _golden_sub, "shuffled": _shuffled}[name]()
    return Arrays(np.asarray(g.src), np.asarray(g.dst), g.num_nodes,
                  node_features(g), edge_features(g))


@pytest.fixture(scope="module")
def graphs():
    return {name: _arrays(name) for name in GRAPHS}


@pytest.fixture(scope="module")
def weights():
    return load_model_weights(WEIGHTS)


def _cpu_cfg():
    cfg = Config()
    cfg.compute.device = "cpu"
    return cfg


@pytest.fixture(scope="module")
def single_device(graphs, weights):
    model = load_model(*weights, _cpu_cfg(), "cpu")
    out = {}
    with torch.inference_mode():
        for name, a in graphs.items():
            g = DeviceGraph.build(a.src, a.dst, a.n)
            out[name] = model(g, torch.from_numpy(a.x),
                              torch.from_numpy(a.e)).numpy()[:, 0]
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def ranks(request, graphs, weights):
    """One spawned group of P ranks runs every job of this file."""
    P = request.param
    plan, _ = halo.plan_graph(graphs["banded"].src, graphs["banded"].dst,
                              graphs["banded"].n, P)
    jobs = [(checks.exchange_job, (plan, EX_SEED, EX_WIDTH))]
    jobs += [(checks.score_job, (a.src, a.dst, a.n, a.x, a.e, *weights,
                                 _cpu_cfg())) for a in graphs.values()]
    res = spawn(checks.run_jobs, P, jobs, deadline_s=600)
    return P, plan, res


# ------------------------------------------------------------------ the plan
def _brute_force_check(plan, src, dst):
    """Every edge once, on its dst's owner; its src's extended row holds
    that node; overflow rows exactly the src nodes farther than K."""
    src, dst = np.asarray(src), np.asarray(dst)
    seen = np.zeros(src.size, dtype=int)
    ovf = set()
    for r in range(plan.n_parts):
        lo, hi = plan.block(r)
        kl, kr = plan.strips(r)
        rows = plan.ext_rows(r)
        a, b = plan.cuts[r], plan.cuts[r + 1]
        eids = plan.edges(r)
        seen[eids] += 1
        assert np.all((dst[eids] >= lo) & (dst[eids] < hi))
        assert np.array_equal(rows[plan.src_ext[a:b]], src[eids])
        assert np.array_equal(rows[plan.dst_ext[a:b]], dst[eids])
        assert np.all(np.diff(plan.dst_ext[a:b]) >= 0)   # slot order
        for s, k in zip(src[eids], plan.src_ext[a:b]):
            reach = max(lo - s, s - (hi - 1), 0)
            if reach > plan.K:
                ovf.add(int(s))
                assert k >= kl + (hi - lo) + kr
            else:
                assert k < kl + (hi - lo) + kr
    assert np.all(seen == 1)
    assert sorted(ovf) == plan.ovf.tolist()


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("name", GRAPHS)
def test_plan_against_brute_force(graphs, name, P):
    a = graphs[name]
    plan, nol = halo.plan_graph(a.src, a.dst, a.n, P)
    src, dst = (a.src, a.dst) if nol is None else (nol[a.src], nol[a.dst])
    _brute_force_check(plan, src, dst)
    sizes = np.diff(plan.bounds)
    assert np.all(plan.bounds[:-1] % 2 == 0) and sizes.max() - sizes.min() <= 2
    assert plan.K <= halo.MAX_K_FRAC * sizes.min()


@pytest.mark.parametrize("name", ["unbanded", "golden_sub"])
def test_graph_without_banded_plan_takes_the_uncapped_route(graphs, name):
    a = graphs[name]
    nol = halo.band_order(a.src, a.dst, a.n)
    for P in (2, 4):
        assert halo.build_halo_plan(a.src, a.dst, a.n, P) is None
        assert halo.build_halo_plan(nol[a.src], nol[a.dst], a.n, P) is None
        plan, _ = halo.plan_graph(a.src, a.dst, a.n, P)
        assert plan.route == "overflow-uncapped" and plan.R > 0


def test_shuffled_graph_is_rebanded(graphs):
    a = graphs["shuffled"]
    assert halo.build_halo_plan(a.src, a.dst, a.n, 4) is None
    plan, nol = halo.plan_graph(a.src, a.dst, a.n, 4)
    assert nol is not None and plan.route == "banded"
    assert np.array_equal(nol[0::2] ^ 1, nol[1::2])
    assert np.array_equal(np.sort(nol), np.arange(a.n))


def test_band_order_matches_jax():
    from gnnome_tpu.parallel.halo import band_order as jax_band_order

    g = _shuffled()
    assert np.array_equal(halo.band_order(g.src, g.dst, g.num_nodes),
                          jax_band_order(g.src, g.dst, g.num_nodes))


# -------------------------------------------------------------- the exchange
def test_exchange_matches_single_process_reference(ranks):
    P, plan, res = ranks
    x_all = np.random.default_rng(EX_SEED).normal(size=(plan.n_nodes,
                                                        EX_WIDTH))
    total = np.zeros_like(x_all)
    outs = [r[0] for r in res]
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["ext"], x_all[plan.ext_rows(r)])
        np.add.at(total, plan.ext_rows(r), out["y"])
    for r, out in enumerate(outs):
        lo, hi = plan.block(r)
        np.testing.assert_allclose(out["ret"], total[lo:hi], **EXACT_TOL)


def test_exchange_adjoints(ranks):
    """``<extend(x), y> = <x, return(y)>`` summed over ranks, and each
    Function's backward is the other's forward."""
    P, plan, res = ranks
    x_all = np.random.default_rng(EX_SEED).normal(size=(plan.n_nodes,
                                                        EX_WIDTH))
    outs = [r[0] for r in res]
    lhs = sum((o["ext"] * o["y"]).sum() for o in outs)
    rhs = sum((o["ret"] * x_all[slice(*plan.block(r))]).sum()
              for r, o in enumerate(outs))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)
    for o in outs:
        np.testing.assert_allclose(o["d_h"], o["ret"], **EXACT_TOL)
        np.testing.assert_allclose(o["d_y"], o["ext"], **EXACT_TOL)


# ------------------------------------------------------------------ the model
@pytest.mark.parametrize("name", GRAPHS)
def test_eval_logits_match_single_device(ranks, single_device, name):
    P, _, res = ranks
    out = res[0][1 + GRAPHS.index(name)]
    want = "banded" if name in ("banded", "overflow", "shuffled") else \
        "overflow-uncapped"
    assert out["route"] == want
    assert all(r[1 + GRAPHS.index(name)]["logits"] is None for r in res[1:])
    np.testing.assert_allclose(out["logits"], single_device[name], **FWD_TOL)


@pytest.mark.parametrize("name", ["banded", "overflow"])
def test_eval_logits_match_jax_halo(ranks, name):
    """The port's halo logits against JAX ``halo_score_graph`` on a mesh of
    P virtual CPU devices (XLA backend, float32)."""
    P, _, res = ranks
    g = _synthetic(60, 0.0) if name == "banded" else _synthetic(77, 0.01)
    cfg = JaxConfig()
    cfg.compute.backend = "xla"
    cfg.compute.edge_pad_multiple = 256
    cfg.compute.node_pad_multiple = 64
    params, state = jax_weights(WEIGHTS)
    ref = jax_halo_score(g, params, state, cfg, make_mesh(P))
    assert ref is not None
    got = res[0][1 + GRAPHS.index(name)]["logits"]
    np.testing.assert_allclose(got, np.asarray(ref), **LOGIT_TOL)


def test_score_graph_with_mesh_spawns_ranks(graphs, weights, single_device):
    """``infer.score_graph`` with ``compute.mesh=2`` runs the halo path."""
    g = _synthetic(77, 0.01)
    cfg = _cpu_cfg()
    cfg.compute.mesh = 2
    got = score_graph(g, *weights, cfg)
    np.testing.assert_allclose(got, single_device["overflow"], **FWD_TOL)


# ------------------------------------------- fewer RC pairs than ranks
FEW_TOL = dict(atol=1e-4, rtol=1e-4)
FEW_LR, FEW_PW = 1e-3, 1.3


def _few_pairs_cfg(train: bool):
    cfg = _cpu_cfg()
    if train:
        from gnnome_tpu_torch.config import ModelConfig

        cfg.model = ModelConfig(num_gnn_layers=3, dropout=0.0)
        cfg.train.masking = False
        cfg.train.num_nodes_per_cluster = 10 ** 6
        cfg.train.lr = FEW_LR
    return cfg


@pytest.fixture(scope="module")
def few_pairs(weights):
    """A graph of 3 RC pairs (6 nodes, 8 edges), its single-device logits
    with the shipped weights, one training unit, seeded init weights and
    the single-device step's loss and logits from them."""
    from gnnome_tpu_torch.graphs import synthetic_assembly_graph
    from gnnome_tpu_torch.models import pytrees_from_model
    from gnnome_tpu_torch.models.zoo import get_model
    from gnnome_tpu_torch.train.step import (host_units, make_example,
                                             make_optimizer, train_step)

    g, _, _, _ = synthetic_assembly_graph(
        n_reads=3, genome_len=1500, read_len=600, seed=1,
        with_sequences=True)
    assert g.num_nodes == 6 and g.num_edges > 0
    x, e = node_features(g), edge_features(g)
    model = load_model(*weights, _cpu_cfg(), "cpu")
    with torch.inference_mode():
        ref = model(DeviceGraph.build(g.src, g.dst, g.num_nodes),
                    torch.from_numpy(x), torch.from_numpy(e)).numpy()[:, 0]
    cfg = _few_pairs_cfg(True)
    (unit,) = host_units(g, cfg, np.random.default_rng(0))
    params, state = pytrees_from_model(
        get_model(cfg.model).init_weights(7))
    params, state = checks._copy(params), checks._copy(state)
    single = checks._model(params, state, cfg, "cpu")
    ex = make_example(unit.in_deg, unit.out_deg, unit.e_feat, unit.y,
                      unit.src, unit.dst, unit.n_nodes, "cpu")
    loss, lo = train_step(single, make_optimizer(single, FEW_LR), ex,
                          FEW_PW, cfg, None)
    step_logits = lo.numpy()[ex.g.slot_of_eid.numpy()]
    return g, x, e, ref, unit, params, state, float(loss), step_logits


@pytest.fixture(scope="module", params=[3, 4], ids=["P3", "P4"])
def few_pairs_ranks(request, few_pairs, weights):
    P = request.param
    g, x, e, _, unit, params, state, _, _ = few_pairs
    jobs = [(checks.score_job, (g.src, g.dst, g.num_nodes, x, e, *weights,
                                _cpu_cfg())),
            (checks.train_step_job, (unit, params, state,
                                     _few_pairs_cfg(True), FEW_PW))]
    return P, spawn(checks.run_jobs, P, jobs, deadline_s=600)


def test_few_pairs_plan_leaves_a_block_empty():
    """3 pairs over 4 ranks: one block is empty, K is 0 and every edge
    whose src lies in another block takes an overflow row; over 3 ranks
    every block holds one pair."""
    from gnnome_tpu_torch.graphs import synthetic_assembly_graph

    g, _, _, _ = synthetic_assembly_graph(
        n_reads=3, genome_len=1500, read_len=600, seed=1)
    for P, empty in ((3, 0), (4, 1)):
        plan, nol = halo.plan_graph(g.src, g.dst, g.num_nodes, P)
        src, dst = (g.src, g.dst) if nol is None else (nol[g.src],
                                                       nol[g.dst])
        _brute_force_check(plan, src, dst)
        sizes = np.diff(plan.bounds)
        assert int((sizes == 0).sum()) == empty
        assert np.all(plan.bounds % 2 == 0)
        if empty:
            assert plan.K == 0


def test_few_pairs_eval_logits_match_single_device(few_pairs_ranks,
                                                   few_pairs):
    P, res = few_pairs_ranks
    ref = few_pairs[3]
    out = res[0][0]
    np.testing.assert_allclose(out["logits"], ref, **FEW_TOL)
    edges = [r[0]["n_edges"] for r in res]
    assert sum(edges) == ref.shape[0]
    if P == 4:
        assert 0 in edges          # the empty rank holds no edge


def test_few_pairs_train_step_bitwise_equal_across_ranks(few_pairs_ranks,
                                                         few_pairs):
    """One Adam step: the loss and logits of the single-device step, and
    parameters bitwise equal on every rank (the empty one included)."""
    P, res = few_pairs_ranks
    loss, logits = few_pairs[7], few_pairs[8]
    out = res[0][1]
    np.testing.assert_allclose(out["loss"], loss, **FWD_TOL)
    np.testing.assert_allclose(out["logits"], logits, **FWD_TOL)

    def leaves(tree, prefix=""):
        flat = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                flat.update(leaves(v, f"{prefix}{k}/"))
            else:
                flat[prefix + k] = np.asarray(v)
        return flat

    ref = leaves(out["params"])
    for r in res[1:]:
        got = leaves(r[1]["params"])
        assert got.keys() == ref.keys()
        assert all(np.array_equal(got[k], ref[k]) for k in ref)
        assert r[1]["loss"] == out["loss"]


# --------------------------------------------------------------- the config
TRAIN_REASON = ("the JAX package trains this config on one device; use "
                "compute.mesh=0 for the same run")


@pytest.mark.parametrize("command", ["infer", "train"])
@pytest.mark.parametrize("override,reason", [
    ("model.normalization=layer", "model.normalization='layer'"),
    ("model.normalization=none", "model.normalization='none'"),
    ("model.model=gcn", "model.model='gcn'"),
    ("model.model=gatedgcn", "model.model='gatedgcn'")])
def test_mesh_refuses_other_models(override, reason, command):
    """The config loads (as in JAX).  ``train`` refuses these models at
    ``compute.mesh > 1`` with its own reason: JAX ``train`` trains them on
    one device (train/loop.py:143-158,222-223).  ``infer`` runs them on the
    sharded path (``parallel/sharded.py``, JAX's GSPMD path) and passes the
    check."""
    from gnnome_tpu_torch.config import check_compute

    cfg = Config()
    cfg.apply_overrides([override, "compute.mesh=2"])
    if command == "infer":
        check_compute(cfg, command)
        return
    with pytest.raises(ValueError) as e:
        check_compute(cfg, command)
    assert "batch-norm SymGatedGCN only" in str(e.value)
    assert reason in str(e.value)
    assert TRAIN_REASON in str(e.value) and "GSPMD" not in str(e.value)


@pytest.mark.parametrize("override", ["model.normalization=layer",
                                      "model.model=gcn"])
def test_cli_train_mesh_refuses_with_the_train_reason(tmp_path, override):
    """``cli train --set compute.mesh=4`` with a model the halo path does
    not run refuses before any rank starts, with the train reason."""
    from gnnome_tpu_torch import cli

    with pytest.raises(ValueError) as e:
        cli.main(["train", "--train", str(tmp_path), "--valid",
                  str(tmp_path), "--asm", "hifiasm", "--set",
                  "compute.device=cpu", "--set", "compute.mesh=4", "--set",
                  override])
    assert TRAIN_REASON in str(e.value)


def test_cli_infer_mesh_refuses_with_the_gspmd_reason(tmp_path):
    """``cli infer --set compute.mesh=4`` with the layer-norm model, which
    the JAX package sends to GSPMD, runs on the port's sharded path: four
    ranks score the graph, rank 0 writes the logits of the single-device
    forward and a FASTA."""
    from gnnome_tpu_torch import cli
    from gnnome_tpu_torch.graphs import synthetic_assembly_graph
    from gnnome_tpu_torch.models import get_model, pytrees_from_model
    from gnnome_tpu_torch.models.checkpoint import save_model_weights

    g, reads, _, _ = synthetic_assembly_graph(
        n_reads=120, genome_len=12_000, read_len=500, seed=1,
        with_sequences=True, false_edge_frac=0.0)
    small = ["model.normalization=layer", "model.num_gnn_layers=2",
             "model.dim_latent=16", "model.hidden_edge_scores=16"]
    cfg = _cpu_cfg()
    cfg.apply_overrides(small)
    model = get_model(cfg.model).init_weights(7)
    path = str(tmp_path / "layer.npz")
    save_model_weights(path, *pytrees_from_model(model))
    ds = tmp_path / "ds"
    for sub in ("processed", "info"):
        (ds / "hifiasm" / sub).mkdir(parents=True)
    g.save(str(ds / "hifiasm" / "processed" / "0.npz"))
    reads.save(str(ds / "hifiasm" / "info" / "0_reads.npz"))
    out = ds / "hifiasm"
    summary = cli.main(["infer", "--data", str(ds), "--asm", "hifiasm",
                        "--out", str(out), "--model", path, "--set",
                        "compute.device=cpu", "--set", "compute.mesh=4",
                        "--set", "decode.len_threshold=2000",
                        *sum((["--set", s] for s in small), [])])
    assert summary["ranks"] == 4 and len(summary["rank_launches"]) == 4
    with torch.inference_mode():
        ref = model(DeviceGraph.build(g.src, g.dst, g.num_nodes),
                    torch.from_numpy(node_features(g)),
                    torch.from_numpy(edge_features(g))).numpy()[:, 0]
    np.testing.assert_allclose(np.load(out / "decode" / "0_predicts.npy"),
                               ref, **FWD_TOL)
    assert (out / "assembly" / "0_assembly.fasta").is_file()


def test_mesh_from_a_jax_written_config(tmp_path):
    from gnnome_tpu_torch.config import check_compute

    jax_cfg = JaxConfig()
    jax_cfg.compute.mesh = 4
    path = str(tmp_path / "c.json")
    jax_cfg.save(path)
    assert Config.load(path).compute.mesh == 4
    jax_cfg.model.normalization = "layer"
    jax_cfg.save(path)
    cfg = Config.load(path)
    assert cfg.compute.mesh == 4 and cfg.model.normalization == "layer"
    with pytest.raises(ValueError, match="batch-norm SymGatedGCN only"):
        check_compute(cfg, "train")


def test_halo_path_refuses_other_models():
    from gnnome_tpu_torch.config import ModelConfig
    from gnnome_tpu_torch.models.zoo import get_model

    model = get_model(ModelConfig(normalization="layer"))
    with pytest.raises(ValueError, match="batch-norm SymGatedGCN only"):
        halo.check_model(model)


def test_mesh_needs_a_card_when_cuda_is_asked_for(monkeypatch):
    from gnnome_tpu_torch.parallel.group import transport

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="compute.device=cpu"):
        transport("cuda", 2)
    assert transport("cpu", 4) == ("gloo", False)


def test_cli_infer_mesh_writes_the_single_device_contigs(tmp_path):
    """``cli infer --set compute.mesh=2`` on the CPU: the logits cache and
    the FASTA of the single-device run; every rank scored its shard."""
    from gnnome_tpu_torch import cli
    from gnnome_tpu_torch.graphs import synthetic_assembly_graph

    g, reads, _, _ = synthetic_assembly_graph(
        n_reads=120, genome_len=12_000, read_len=500, seed=1,
        with_sequences=True, false_edge_frac=0.0)
    runs = {}
    for name, extra in (("one", []), ("mesh", ["--set", "compute.mesh=2"])):
        ds = tmp_path / name
        for sub in ("processed", "info"):
            (ds / "hifiasm" / sub).mkdir(parents=True)
        g.save(str(ds / "hifiasm" / "processed" / "0.npz"))
        reads.save(str(ds / "hifiasm" / "info" / "0_reads.npz"))
        out = ds / "hifiasm"
        summary = cli.main(["infer", "--data", str(ds), "--asm", "hifiasm",
                            "--out", str(out), "--model", WEIGHTS,
                            "--set", "compute.device=cpu",
                            "--set", "decode.len_threshold=2000",
                            "--set", "decode.num_decoding_paths=10", *extra])
        runs[name] = (summary, np.load(out / "decode" / "0_predicts.npy"),
                      (out / "assembly" / "0_assembly.fasta").read_text())
    (s1, lo1, fa1), (s2, lo2, fa2) = runs["one"], runs["mesh"]
    assert s2["ranks"] == 2 and len(s2["rank_launches"]) == 2
    np.testing.assert_allclose(lo2, lo1, **FWD_TOL)
    assert fa2 == fa1


@pytest.mark.parametrize("hang_s", [0, 600])
def test_a_failing_or_hanging_rank_fails_the_group(hang_s):
    """A rank that raises, or outlives the deadline, makes ``spawn`` raise
    and every rank end (no path goes on with fewer ranks)."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as e:
        spawn(checks.failing_job, 2, 1, hang_s, deadline_s=30)
    assert ("fails on purpose" in str(e.value) if not hang_s
            else "deadline of 30 s passed" in str(e.value))
    assert time.monotonic() - t0 < 120
