"""The port's recorded-run scripts (``scripts/torch_*.py``) against the JAX
package's (``scripts/product_train_run.py``, ``golden_ecoli_run.py``,
``train_quality_run.py``, ``config4_route.py``), on the CPU at small sizes.

Both sides load by path.  Tolerances: logits ``atol=2e-5, rtol=1e-4`` (the
torch-oracle parity tests, tests/test_model_parity.py:76); per-layer
activations within 1e-4 of the layer's largest magnitude (float32 spacing
at the edge activations' |e| of several thousand is 2.4e-4-4.9e-4, so an
absolute 1e-4 is below what float32 resolves there); validation losses
within 1e-5; config-4 train losses within 1e-5 relative and eval AP within
1e-5 (``AP_TOL``).
"""
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from gnnome_tpu_torch.graphs.container import AssemblyGraph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "golden_ecoli_v1.npz")
WEIGHTS = os.path.join(ROOT, "weights", "weights.npz")
TINY = ["model.num_gnn_layers=2", "model.dim_latent=16",
        "model.hidden_edge_scores=16"]
LOGIT_TOL = dict(atol=2e-5, rtol=1e-4)
# config-4 eval AP after Adam steps on float32 gradients summed in another
# order: 2.4e-6 apart after two epochs with train and eval losses within
# 2e-7 relative (AP ranks 18,744 logits, and small logit moves reorder
# near-equal ones); JAX's figure is rounded to 6 decimals besides
AP_TOL = 1e-5


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_recorded_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sets(overrides):
    return sum((["--set", o] for o in overrides), [])


def _npz(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k].copy() for k in z.files}


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------ product run
def test_product_dataset_equals_jax(tmp_path):
    """``build_dataset`` writes the JAX script's three graphs, array for
    array."""
    jx, pt = _load("product_train_run"), _load("torch_product_train_run")
    jx.build_dataset(str(tmp_path / "jax"), "cpu")
    pt.build_dataset(str(tmp_path / "port"), "card")
    rel = os.path.join("hifiasm", "processed")
    names = sorted(os.listdir(tmp_path / "jax" / rel))
    assert names == ["0.npz", "1.npz", "2.npz"]
    assert sorted(os.listdir(tmp_path / "port" / rel)) == names
    for n in names:
        a, b = _npz(tmp_path / "jax" / rel / n), _npz(tmp_path / "port" / rel
                                                       / n)
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), (n, k)


def test_product_cpu_run_resumes_bitwise(tmp_path):
    """A CPU run of one epoch, resumed twice to two: both continuations
    bitwise equal, and equal to a two-epoch run never interrupted."""
    pt = _load("torch_product_train_run")
    out = pt.main(["--mode", "cpu", "--epochs", "1", "--out",
                   str(tmp_path / "run.json"), *_sets(TINY)])
    assert out["resume_bit_identical"] is True
    assert out["resume_equals_uninterrupted"] is True
    assert out["device"] == "cpu" and out["peak_mb"] is None
    (row,) = out["epoch_metrics"]
    assert np.isfinite(row["train/loss"]) and np.isfinite(row["valid/loss"])
    # masked graphs of 1,200-2,800 nodes: at least one clustered graph
    (ep,) = out["launches_per_epoch"]
    assert ep["train_units"] > 3 and ep["valid_units"] > 3
    assert not any(ep["launches"].values())      # plain versions launch none


# ------------------------------------------------------------- golden run
@pytest.fixture(scope="module")
def golden_sub(tmp_path_factory):
    """The golden-subgraph recipe of ``chip_smoke.golden_subgraph`` with
    every read's two strands kept (the greedy decoder walks both)."""
    g = AssemblyGraph.load(FIXTURE)
    hard = np.nonzero((g.y == 0) & (g.overlap_similarity > 0.95))[0]
    keep = np.zeros(g.num_nodes, dtype=bool)
    keep[:1600] = True
    for eid in hard[:: max(1, len(hard) // 4)][:4]:
        for v in (int(g.src[eid]), int(g.dst[eid])):
            keep[max(0, v - 400): v + 400] = True
    keep = np.repeat(keep.reshape(-1, 2).any(1), 2)
    sub = g.node_subgraph(keep)[0]
    path = str(tmp_path_factory.mktemp("golden") / "sub.npz")
    sub.save(path)
    return path


def test_golden_run_vs_oracle(golden_sub, tmp_path):
    """The script on the CPU: its logits against the oracle's, every
    layer against the oracle's, the parity it records."""
    pt = _load("torch_golden_ecoli_run")
    logits = {}
    out = pt.main(["--cached", "--fixture", golden_sub, "--device", "cpu",
                   "--out", str(tmp_path / "golden.json")], logits)
    np.testing.assert_allclose(logits["port"], logits["oracle"], **LOGIT_TOL)
    assert out["edge_prob_parity"]["max_abs_prob_diff"] < 1e-5
    assert out["edge_prob_parity"]["port_repeat_bitwise"] is True
    assert out["average_precision"]["abs_diff_port_oracle"] < 1e-6
    assert len(out["per_layer_max_abs_diff"]) == 8
    for row in out["per_layer_max_abs_diff"]:
        assert row["max_abs_dh"] <= 1e-4 * max(1.0, row["max_abs_h"]), row
        assert row["max_abs_de"] <= 1e-4 * max(1.0, row["max_abs_e"]), row
    assert out["decode"]["port"] == {**out["decode"]["oracle"],
                                     "decode_seconds": out["decode"]["port"][
                                         "decode_seconds"]}
    assert out["jax_record"] is None          # not the tracked fixture


def test_golden_logits_and_decode_vs_jax(golden_sub):
    """The port's logits (``score_model``, as the script scores) against
    JAX's ``sym_gated_gcn_forward``; the script's decode summary of them
    against JAX's ``decode_greedy`` of JAX's logits."""
    from gnnome_tpu.config import DecodeConfig as JaxDecodeConfig
    from gnnome_tpu.config import ModelConfig as JaxModelConfig
    from gnnome_tpu.decode.assembly import calculate_n50, calculate_ng50
    from gnnome_tpu.decode.greedy import decode_greedy as jax_decode
    from gnnome_tpu.graphs.container import AssemblyGraph as JaxGraph
    from gnnome_tpu.models import sym_gated_gcn_forward
    from gnnome_tpu.models.checkpoint import load_model_weights as jax_load
    from gnnome_tpu.ops import GraphTensors

    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.infer import load_model, score_model
    from gnnome_tpu_torch.models import edge_features, node_features
    from gnnome_tpu_torch.models.checkpoint import load_model_weights

    pt = _load("torch_golden_ecoli_run")
    g = AssemblyGraph.load(golden_sub)
    cfg = Config()
    cfg.compute.device = "cpu"
    port = score_model(load_model(*load_model_weights(WEIGHTS), cfg,
                                  "cpu").eval(), g, cfg, "cpu")
    jg = JaxGraph.load(golden_sub)
    gt = GraphTensors.from_graph(jg)
    lo, _ = sym_gated_gcn_forward(*jax_load(WEIGHTS), gt,
                                  gt.pad_nodes(node_features(g)),
                                  gt.pad_edges(edge_features(g)),
                                  JaxModelConfig(), training=False)
    ref = np.asarray(lo)[: g.num_edges, 0]
    np.testing.assert_allclose(port, ref, **LOGIT_TOL)
    res = jax_decode(jg, ref.astype(np.float32),
                     JaxDecodeConfig(load_checkpoint=False),
                     rng=np.random.default_rng(7))
    lens = res.contigs_len
    want = {"contigs": len(lens), "total_bases": int(sum(lens)),
            "n50": int(calculate_n50(lens)),
            "ng50": int(calculate_ng50(lens, pt.ECOLI_BP)),
            "longest": int(max(lens))}
    got = pt.decode_summary(g, port, pt.ECOLI_BP, 7)
    assert {k: got[k] for k in want} == want


# ------------------------------------------------------------ quality run
SMALL_SPEC = dict(genome_len=40_000, read_len=3_000, n_reads=150,
                  error_rate=0.02, hard_false_frac=0.10, false_edge_frac=0.15,
                  n_coverage_gaps=1, n_repeat_pairs=5, sim_band_frac=0.15)


@pytest.fixture(scope="module")
def quality(tmp_path_factory):
    """Both modules with ``TRAIN_SPEC`` cut to one small graph, and a root
    holding training graph 0 (seed 100) and validation graph 0 (seed 200)
    built by each."""
    jx, pt = _load("train_quality_run"), _load("torch_train_quality_run")
    jx.TRAIN_SPEC = dict(SMALL_SPEC)
    pt.TRAIN_SPEC = dict(SMALL_SPEC)
    root = tmp_path_factory.mktemp("quality")
    graphs = {}
    for split, seed in (("train", 100), ("valid", 200)):
        pdir = root / split / "hifiasm" / "processed"
        os.makedirs(pdir)
        a, b = jx._build_graph(seed), pt._build_graph(seed)
        a.save(str(pdir / "0.npz"))
        graphs[split] = (a, b)
    return jx, pt, str(root), graphs


@pytest.mark.parametrize("split", ["train", "valid"])
def test_quality_graph_equals_jax(quality, split):
    _, _, root, graphs = quality
    jax_g, port_g = graphs[split]
    path = os.path.join(root, "port.npz")
    ref = os.path.join(root, split, "hifiasm", "processed", "0.npz")
    port_g.save(path)
    a, b = _npz(ref), _npz(path)
    assert a.keys() == b.keys() and a["num_nodes"] == jax_g.num_nodes
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_quality_parity_arm_vs_jax(quality):
    """Two epochs of the parity arm from JAX's ``init_params(PRNGKey(1))``:
    the port's validation losses within 1e-5 of the JAX arm's, and the
    port's oracle arm within 1e-5 of the port."""
    from gnnome_tpu.config import ModelConfig as JaxModelConfig
    from gnnome_tpu.models.sym_gated_gcn import init_params

    jx, pt, root, _ = quality
    try:
        ref = jx.stage_parity(root, 2)
    finally:                    # the JAX stage leaves them on
        torch.use_deterministic_algorithms(False)
    init = _to_numpy(init_params(jax.random.PRNGKey(1), JaxModelConfig()))
    got = pt.stage_parity(root, 2, "cpu", init=init)
    assert len(got["port"]) == len(ref["jax"]) == 2
    for a, b in zip(got["port"], ref["jax"]):
        assert abs(a["valid_loss"] - b["valid_loss"]) <= 1e-5, (a, b)
        assert abs(a["train_loss"] - b["train_loss"]) <= 1e-5, (a, b)
    assert got["divergence"]["max_abs_valid_loss_diff"] <= 1e-5
    assert got["device"] == "cpu"


# ---------------------------------------------------------- config-4 route
def test_config4_run_units_vs_jax():
    """``run_units`` on ``positional_bench_assembly_graph(4096)`` in
    clusters of 1,024 nodes, float32, dropout 0, from JAX's
    ``init_params(PRNGKey(1))``, evaluated on the full graph each epoch."""
    from gnnome_tpu.config import Config as JaxConfig
    from gnnome_tpu.graphs.synthetic import (
        positional_bench_assembly_graph as jax_graph)
    from gnnome_tpu.models.sym_gated_gcn import init_params

    jx, pt = _load("config4_route"), _load("torch_config4_route")
    jcfg = JaxConfig()
    jcfg.model.num_gnn_layers, jcfg.model.dim_latent = 2, 16
    jcfg.model.hidden_edge_scores, jcfg.model.dropout = 16, 0.0
    jcfg.train.num_epochs, jcfg.train.seed = 2, 1
    jcfg.train.masking, jcfg.train.num_nodes_per_cluster = False, 1024
    jcfg.compute.dtype, jcfg.compute.matmul_precision = "float32", "highest"
    jcfg.compute.bucket_growth = 1.2
    jg = jax_graph(4096, 0)
    ref = jx.run_units(jg, jcfg, 2, eval_graph=jg, label="jax")
    g = pt.build_graph(4096, 0)
    assert np.array_equal(g.src, jg.src) and np.array_equal(g.y, jg.y)
    cfg = pt.make_cfg(1024, 2, "cpu", [*TINY, "model.dropout=0",
                                       "compute.dtype=float32"])
    init = _to_numpy(init_params(jax.random.PRNGKey(1), jcfg.model))
    got = pt.run_units(g, cfg, 2, eval_graph=g, label="port", init=init)
    assert got["units_per_epoch"] == ref["units_per_epoch"] > 1
    for a, b in zip(got["epochs"], ref["epochs"]):
        np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(a["eval_loss"], b["eval_loss"], rtol=1e-5)
        assert abs(a["eval_ap"] - b["eval_ap"]) <= AP_TOL, (a, b)
