"""gnnome_tpu_torch's sharded path (``parallel/sharded.py``: ``compute.mesh
> 1`` inference for the layer-norm and norm-free SymGatedGCN and the zoo)
on CPU ranks over gloo: the logits at P = 2 and 3 against the port's
single-device forward and against JAX ``sharded_score_graph`` on a mesh of
P virtual CPU devices (tests/conftest.py:18), a 3-pair graph at P = 4 (one
rank's block empty), the zoo's processor-graph plan against ``g``'s, the
bf16 setting (float32 logits and a notice), and ``cli infer`` with
``compute.mesh=2`` against the single-device run.

Each P runs every model's forward in one spawned group (a module-scoped
fixture); the rank jobs live in the package (``parallel.checks``).

Graph: the synthetic graph of tests/test_parallel.py:31-33 (150 reads,
``genome_len=12000``).  Weights: JAX init weights (d = 16, 3 layers) with
the norms' scales and biases and the GatedGCN's running statistics
jittered away from their init values, carried to the port by
``models/convert``.  Tolerance: ``atol=2e-5, rtol=1e-4``, the tolerance of
tests/test_parallel.py:40 (node sums add their terms in another order).
"""
import jax
import numpy as np
import pytest
import torch

from gnnome_tpu.config import Config as JaxConfig
from gnnome_tpu.config import ModelConfig as JaxModelConfig
from gnnome_tpu.graphs import synthetic_assembly_graph as jax_synthetic
from gnnome_tpu.models.zoo import get_model as jax_get_model
from gnnome_tpu.parallel import make_mesh
from gnnome_tpu.parallel.sharded import sharded_score_graph as jax_sharded

from gnnome_tpu_torch.config import Config, ModelConfig
from gnnome_tpu_torch.graphs import synthetic_assembly_graph
from gnnome_tpu_torch.infer import score_graph
from gnnome_tpu_torch.models import edge_features, node_features
from gnnome_tpu_torch.models.checkpoint import save_model_weights
from gnnome_tpu_torch.models.zoo import processor_edges, processor_graph
from gnnome_tpu_torch.ops import DeviceGraph
from gnnome_tpu_torch.parallel import checks, sharded
from gnnome_tpu_torch.parallel.group import Group, spawn
from gnnome_tpu_torch.parallel.halo import plan_graph

LOGIT_TOL = dict(atol=2e-5, rtol=1e-4)
SMALL = dict(num_gnn_layers=3, dim_latent=16, hidden_edge_scores=16,
             dropout=0.0)
# id: (model.model, model.normalization, model.directed)
MODELS = {"layer": ("sym_gatedgcn", "layer", True),
          "none": ("sym_gatedgcn", "none", True),
          "gatedgcn": ("gatedgcn", "batch", True),
          "gatedgcn_undirected": ("gatedgcn", "batch", False),
          "gcn": ("gcn", "batch", True),
          "gat": ("gat", "batch", True),
          "sage": ("sage", "batch", True)}
PROC_MODELS = ["gatedgcn_undirected", "gcn", "gat", "sage"]
FEW_MODELS = ["layer", "gcn"]


def _model_cfgs(mid):
    name, norm, directed = MODELS[mid]
    kw = {**SMALL, "model": name, "normalization": norm, "directed": directed}
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _cfg(mid, **compute):
    cfg = Config()
    cfg.model = _model_cfgs(mid)[1]
    cfg.compute.device = "cpu"
    for k, v in compute.items():
        setattr(cfg.compute, k, v)
    return cfg


def _jax_weights(mid, seed=3):
    """JAX init weights with non-trivial norms (numpy pytrees)."""
    jcfg, _ = _model_cfgs(mid)
    params, state = jax.tree_util.tree_map(
        np.asarray, jax_get_model(jcfg.model)[0](jax.random.PRNGKey(seed),
                                                 jcfg))
    params = jax.tree_util.tree_map(np.array, params)
    state = jax.tree_util.tree_map(np.array, state)
    rng = np.random.default_rng(seed)
    norms = params.get("gnn", {})
    for bn in ("bn_h", "bn_e"):
        if bn not in norms:
            continue
        p = norms[bn]
        p["scale"] = rng.uniform(0.5, 1.5, p["scale"].shape).astype(
            np.float32)
        p["bias"] = rng.normal(0, 0.1, p["bias"].shape).astype(np.float32)
        s = state.get("gnn", {}).get(bn)
        if s:
            s["mean"] = rng.normal(0, 0.3, s["mean"].shape).astype(np.float32)
            s["var"] = rng.uniform(0.5, 2.0, s["var"].shape).astype(
                np.float32)
    return params, state


def _single_device(g, mid, params, state):
    """The port's single-device eval logits [E] on the CPU."""
    cfg = _cfg(mid)
    model = checks._model(params, state, cfg, "cpu")
    gp = processor_graph(cfg.model, g.src, g.dst, g.num_nodes)
    args = (DeviceGraph.build(g.src, g.dst, g.num_nodes),
            torch.from_numpy(node_features(g)),
            torch.from_numpy(edge_features(g)))
    with torch.inference_mode():
        return model(*args + (() if gp is None else (gp,))).numpy()[:, 0]


@pytest.fixture(scope="module")
def graph():
    g, _, _, _ = jax_synthetic(n_reads=150, genome_len=12000, read_len=400,
                               seed=21, with_sequences=True)
    return g


@pytest.fixture(scope="module")
def weights():
    return {mid: _jax_weights(mid) for mid in MODELS}


@pytest.fixture(scope="module")
def single_device(graph, weights):
    return {mid: _single_device(graph, mid, *weights[mid]) for mid in MODELS}


def _score_jobs(g, weights, mids):
    x, e = node_features(g), edge_features(g)
    return [(checks.score_job, (g.src, g.dst, g.num_nodes, x, e,
                                *weights[mid], _cfg(mid))) for mid in mids]


@pytest.fixture(scope="module", params=[2, 3], ids=["P2", "P3"])
def ranks(request, graph, weights):
    """One spawned group of P ranks scores the graph with every model."""
    P = request.param
    res = spawn(checks.run_jobs, P, _score_jobs(graph, weights, MODELS),
                deadline_s=600)
    return P, res


# ------------------------------------------------------------------ logits
@pytest.mark.parametrize("mid", list(MODELS))
def test_sharded_logits_match_single_device(ranks, single_device, mid):
    P, res = ranks
    i = list(MODELS).index(mid)
    out = res[0][i]
    assert all(r[i]["logits"] is None for r in res[1:])
    assert sum(r[i]["n_edges"] for r in res) == single_device[mid].shape[0]
    np.testing.assert_allclose(out["logits"], single_device[mid],
                               **LOGIT_TOL)


@pytest.mark.parametrize("mid", list(MODELS))
def test_sharded_logits_match_jax(ranks, graph, weights, mid):
    """The port's sharded logits against JAX ``sharded_score_graph`` on a
    mesh of P virtual CPU devices (XLA backend, float32, ``highest``
    matmul precision)."""
    P, res = ranks
    jcfg = JaxConfig()
    jcfg.model = _model_cfgs(mid)[0]
    jcfg.compute.backend = "xla"
    jcfg.compute.edge_pad_multiple = 256
    jcfg.compute.node_pad_multiple = 64
    with jax.default_matmul_precision("highest"):
        ref = jax_sharded(graph, *weights[mid], jcfg, make_mesh(P))
    got = res[0][list(MODELS).index(mid)]["logits"]
    np.testing.assert_allclose(got, np.asarray(ref), **LOGIT_TOL)


# ------------------------------------------------- fewer RC pairs than ranks
@pytest.fixture(scope="module")
def few_pairs(weights):
    """A graph of 3 RC pairs (6 nodes) scored at P = 4 (one block empty)
    and on one device."""
    g, _, _, _ = synthetic_assembly_graph(
        n_reads=3, genome_len=1500, read_len=600, seed=1,
        with_sequences=True)
    assert g.num_nodes == 6 and g.num_edges > 0
    res = spawn(checks.run_jobs, 4, _score_jobs(g, weights, FEW_MODELS),
                deadline_s=600)
    ref = {mid: _single_device(g, mid, *weights[mid]) for mid in FEW_MODELS}
    return res, ref


@pytest.mark.parametrize("mid", FEW_MODELS)
def test_few_pairs_sharded_logits_match_single_device(few_pairs, mid):
    res, ref = few_pairs
    i = FEW_MODELS.index(mid)
    edges = [r[i]["n_edges"] for r in res]
    assert 0 in edges and sum(edges) == ref[mid].shape[0]
    if mid == "gcn":              # the processor graph: one self-loop a node
        proc = [r[i]["proc"]["n_edges"] for r in res]
        assert 0 in proc and sum(proc) == ref[mid].shape[0] + 6
    np.testing.assert_allclose(res[0][i]["logits"], ref[mid], **LOGIT_TOL)


# -------------------------------------------------- the processor graph
@pytest.mark.parametrize("P", [2, 3])
@pytest.mark.parametrize("mid", PROC_MODELS)
def test_processor_plan_shares_blocks_and_node_order(graph, mid, P):
    """A zoo shard's processor-graph plan has ``g``'s blocks and node
    order, holds every processor edge once on its dst's owner, and (the
    undirected GatedGCN) its first E edge states land on ``g``'s slots
    edge for edge."""
    model_cfg = _cfg(mid).model
    x, e = node_features(graph), edge_features(graph)
    src, dst = np.asarray(graph.src), np.asarray(graph.dst)
    plan, nol = plan_graph(src, dst, graph.num_nodes, P)
    ps, pd = processor_edges(model_cfg, src, dst, graph.num_nodes)
    if nol is not None:
        ps, pd = nol[ps], nol[pd]
    pplan = sharded.processor_plan(ps, pd, graph.num_nodes, P)
    assert np.array_equal(pplan.bounds, plan.bounds)
    seen = np.zeros(ps.shape[0], dtype=int)
    for r in range(P):
        group = Group(r, P, torch.device("cpu"), "gloo", False)
        sg = sharded.shard_for_model(model_cfg, group, src, dst,
                                     graph.num_nodes, x, e)
        assert sg.proc is not sg.sh and sg.proc.plan.route == pplan.route
        assert torch.equal(sg.proc.x, sg.sh.x)
        a, b = pplan.cuts[r], pplan.cuts[r + 1]
        mine = pplan.edges(r)
        seen[mine] += 1
        rows = pplan.ext_rows(r)
        assert np.array_equal(rows[pplan.src_ext[a:b]], ps[mine])
        assert np.array_equal(rows[pplan.dst_ext[a:b]], pd[mine])
        if mid == "gatedgcn_undirected":
            slots = sg.proc_slots.numpy()
            assert np.array_equal(mine[slots], plan.edges(r))
            np.testing.assert_array_equal(sg.proc.e.numpy()[slots],
                                          sg.sh.e.numpy())
        else:
            assert sg.proc_slots is None
    assert np.all(seen == 1)


# ---------------------------------------------------------------- the entry
def test_bf16_at_mesh_runs_float32_and_says_so(graph, weights,
                                               single_device, capfd):
    """``compute.dtype=bfloat16`` with ``compute.mesh=2`` and the
    layer-norm model: the float32 logits, and rank 0 says so (the JAX
    package's sharded forward passes no dtype)."""
    cfg = _cfg("layer", dtype="bfloat16", mesh=2)
    got = score_graph(graph, *weights["layer"], cfg)
    np.testing.assert_allclose(got, single_device["layer"], **LOGIT_TOL)
    out = capfd.readouterr().out
    assert out.count("compute.dtype=bfloat16: the sharded path") == 1
    assert "runs the SymGatedGCN (model.normalization=layer) in float32" in out
    assert "gnnome_tpu/parallel/sharded.py:73-77" in out


def _dataset(root, g, reads):
    for sub in ("processed", "info"):
        (root / "hifiasm" / sub).mkdir(parents=True)
    g.save(str(root / "hifiasm" / "processed" / "0.npz"))
    reads.save(str(root / "hifiasm" / "info" / "0_reads.npz"))
    return root


@pytest.mark.parametrize("mid", ["layer", "gcn"])
def test_cli_infer_mesh_writes_the_single_device_fasta(tmp_path, weights,
                                                       mid):
    """``cli infer --set compute.mesh=2`` on the CPU with the layer-norm
    model or GCN: the logits of the single-device run and its FASTA byte
    for byte; every rank scored its shard."""
    from gnnome_tpu_torch import cli

    g, reads, _, _ = synthetic_assembly_graph(
        n_reads=120, genome_len=12_000, read_len=500, seed=1,
        with_sequences=True, false_edge_frac=0.0)
    model = str(tmp_path / "model.npz")
    save_model_weights(model, *weights[mid])
    name, norm, _ = MODELS[mid]
    sets = [f"model.model={name}", f"model.normalization={norm}",
            *(f"model.{k}={v}" for k, v in SMALL.items()),
            "compute.device=cpu", "decode.len_threshold=2000",
            "decode.num_decoding_paths=10"]
    runs = {}
    for run, extra in (("one", []), ("mesh", ["compute.mesh=2"])):
        ds = _dataset(tmp_path / run, g, reads)
        out = ds / "hifiasm"
        summary = cli.main(["infer", "--data", str(ds), "--asm", "hifiasm",
                            "--out", str(out), "--model", model,
                            *sum((["--set", s] for s in sets + extra), [])])
        runs[run] = (summary, np.load(out / "decode" / "0_predicts.npy"),
                     (out / "assembly" / "0_assembly.fasta").read_bytes())
    (s1, lo1, fa1), (s2, lo2, fa2) = runs["one"], runs["mesh"]
    assert s2["ranks"] == 2 and len(s2["rank_launches"]) == 2
    np.testing.assert_allclose(lo2, lo1, **LOGIT_TOL)
    assert len(fa1) > 0 and fa2 == fa1
