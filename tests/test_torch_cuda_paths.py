"""The port's paths on the card, each held against the port's own CPU run,
a recorded JAX figure or itself: the golden graph's eval forward (every
normalisation of the SymGatedGCN in float32 and bf16, and the zoo), one
train step of each model against the CPU's step, the ``cli`` routes
(``infer``, the GFA route, ``run`` with a stub hifiasm, ``build-graph
--training``, ``train`` with resumes, overfit runs that must learn, a zoo
model), and the recorded-run scripts at reduced sizes.  Every test here is
``cuda``-marked and skips where no GPU is present; the file imports no JAX
(run it as ``tests/test_torch_cuda.py`` says).

The golden graph is tests/fixtures/golden_ecoli_v1.npz (N = 9,600, E =
257,346) at the published widths (d = H = 64, 8 layers): the batch-norm
model with the shipped weights, the others with ``init_weights(7)``.
Bounds (``torch_recipes``), set before any card run: float32 logits
within 1e-4 + 1e-4 |x| of the CPU run, probabilities within 1e-5, the AP
within 1e-4 of the JAX package's (0.9992886, bf16 0.9992662); bf16 logits
by their cosine, largest probability change and AP; a step's loss within
1e-5 relative, gradients within 2e-4 + 5e-3 |g| (bf16: the JAX package's
bounds between its two backends); two card runs bitwise equal; every
kernel's launches counted from 0.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gnnome_tpu_torch.ops import kernels as K
from torch_recipes import cuda  # noqa: F401  (the fixture)
from torch_recipes import (AP_TOL, FORWARD_LAUNCHES, GOLDEN, INFER_GRAPH,
                           INFER_LEN_THRESHOLD, INIT_SEED, JAX_GOLDEN_AP,
                           JAX_GOLDEN_AP_BF16, K1K2_FORWARD_LAUNCHES,
                           K1K2_STEP_LAUNCHES, LOGIT_ATOL, LOGIT_RTOL,
                           PROB_ATOL, ROOT, SCORE_AP, SCORE_COS, SCORE_DP,
                           TRAIN_STEP_LAUNCHES, UNFUSED_FORWARD_ALL_BF16,
                           UNFUSED_FORWARD_BF16, UNFUSED_FORWARD_LAUNCHES,
                           UNFUSED_SCORE_COS, UNFUSED_SCORE_DP,
                           UNFUSED_STEP_LAUNCHES, WEIGHTS,
                           ZOO_FORWARD_SIDE_SUMS, check_step,
                           expected_launches, golden_subgraph,
                           make_infer_dataset, overfit_run, times,
                           write_dataset)

pytestmark = pytest.mark.cuda

# the models of the golden-graph checks: (model.model, normalization,
# directed, compute.dtype)
MODELS = {"batch-float32": ("sym_gatedgcn", "batch", True, "float32"),
          "batch-bfloat16": ("sym_gatedgcn", "batch", True, "bfloat16"),
          "layer-float32": ("sym_gatedgcn", "layer", True, "float32"),
          "none-float32": ("sym_gatedgcn", "none", True, "float32"),
          "layer-bfloat16": ("sym_gatedgcn", "layer", True, "bfloat16"),
          "none-bfloat16": ("sym_gatedgcn", "none", True, "bfloat16"),
          "gatedgcn": ("gatedgcn", "batch", True, "float32"),
          "gcn": ("gcn", "batch", True, "float32"),
          "gat": ("gat", "batch", True, "float32"),
          "sage": ("sage", "batch", True, "float32"),
          "gatedgcn_undirected": ("gatedgcn", "batch", False, "float32")}


def _model_of(case: str):
    """``(cfg, new_model(device))`` of a ``MODELS`` case: the batch-norm
    SymGatedGCN with the shipped weights, every other model seeded."""
    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.infer import load_model
    from gnnome_tpu_torch.models import get_model, load_model_weights

    cfg = Config()
    (cfg.model.model, cfg.model.normalization, cfg.model.directed,
     cfg.compute.dtype) = MODELS[case]
    if cfg.model.model == "sym_gatedgcn" and cfg.model.normalization == (
            "batch"):
        params, state = load_model_weights(WEIGHTS)
        return cfg, lambda device: load_model(params, state, cfg, device)
    return cfg, lambda device: get_model(cfg.model).init_weights(
        INIT_SEED).to(device)


@pytest.fixture(scope="module")
def golden():
    from gnnome_tpu_torch.graphs.container import AssemblyGraph

    return AssemblyGraph.load(GOLDEN)


def _scores_agree(lo, ref, labels, min_cos, max_dp, max_ap) -> None:
    """bf16 logits against a reference run: cosine, the largest
    probability change and the AP difference."""
    from gnnome_tpu_torch.train.metrics import get_aps

    lo, ref = lo.astype(np.float64), ref.astype(np.float64)
    cos = float((lo * ref).sum() / (np.linalg.norm(lo) * np.linalg.norm(ref)))
    dp = float(np.abs(1 / (1 + np.exp(-lo)) - 1 / (1 + np.exp(-ref))).max())
    d_ap = abs(get_aps(lo, labels) - get_aps(ref, labels))
    assert cos > min_cos and dp < max_dp and d_ap < max_ap, (cos, dp, d_ap)


# per case: (launches per forward, of them bf16)
FORWARD_CASES = {
    "batch-float32": (FORWARD_LAUNCHES, {}),
    "batch-bfloat16": (FORWARD_LAUNCHES, FORWARD_LAUNCHES),
    "layer-float32": (UNFUSED_FORWARD_LAUNCHES, {}),
    "none-float32": (UNFUSED_FORWARD_LAUNCHES, {}),
    "layer-bfloat16": (UNFUSED_FORWARD_ALL_BF16["layer"],
                       UNFUSED_FORWARD_BF16["layer"]),
    "none-bfloat16": (UNFUSED_FORWARD_ALL_BF16["none"],
                      UNFUSED_FORWARD_BF16["none"]),
    **{case: ({"k2_side_sum": ZOO_FORWARD_SIDE_SUMS[MODELS[case][0]]}, {})
       for case in ("gatedgcn", "gcn", "gat", "sage",
                    "gatedgcn_undirected")}}


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_golden_forward_card_vs_cpu(cuda, golden, case):
    """The golden graph scored on the card against the port's CPU run
    (the zoo on its processor graph): two card forwards bitwise equal, each
    launching exactly its kernels (and those in bf16); float32 logits
    within 1e-4 + 1e-4 |x| of the CPU's, bf16 ones by ``SCORE_*`` (the
    layer-norm and norm-free models' ``UNFUSED_SCORE_*``); the batch-norm
    model's probabilities within 1e-5 and AP within 1e-4 of the JAX
    package's."""
    from gnnome_tpu_torch.models import edge_features, node_features
    from gnnome_tpu_torch.models.zoo import processor_graph
    from gnnome_tpu_torch.ops import DeviceGraph
    from gnnome_tpu_torch.train.metrics import get_aps

    cfg, new_model = _model_of(case)
    per_forward, per_forward_bf16 = FORWARD_CASES[case]
    bf16 = cfg.compute.dtype == "bfloat16"
    kw = {"dtype": torch.bfloat16} if bf16 else {}
    x, e = node_features(golden), edge_features(golden)

    def setup(device):
        gp = processor_graph(cfg.model, golden.src, golden.dst,
                             golden.num_nodes, device)
        args = (DeviceGraph.from_graph(golden, device),
                torch.as_tensor(x, device=device),
                torch.as_tensor(e, device=device))
        return new_model(device), args + (() if gp is None else (gp,))

    with torch.inference_mode():
        m_cpu, args_cpu = setup("cpu")
        lo_cpu = m_cpu(*args_cpu, **kw).reshape(-1).numpy()
        model, args = setup(cuda)
        model(*args, **kw)                                  # warm-up
        K.reset_launch_counts()
        runs = [model(*args, **kw).reshape(-1) for _ in range(2)]
        torch.cuda.synchronize()
    assert K.launch_counts() == expected_launches(**times(per_forward, 2))
    assert K.launch_counts(torch.bfloat16) == expected_launches(
        **times(per_forward_bf16, 2))
    assert torch.equal(runs[0], runs[1])
    lo = runs[0].cpu().numpy()
    assert lo.shape == (golden.num_edges,) and lo.dtype == np.float32
    assert np.isfinite(lo).all()
    if bf16:
        bounds = ((SCORE_COS, SCORE_DP) if cfg.model.normalization == "batch"
                  else (UNFUSED_SCORE_COS, UNFUSED_SCORE_DP))
        _scores_agree(lo, lo_cpu, golden.y, *bounds, SCORE_AP)
    else:
        d = np.abs(lo - lo_cpu)
        assert (d <= LOGIT_ATOL + LOGIT_RTOL * np.abs(lo_cpu)).all(), d.max()
    if case == "batch-float32":
        sig = lambda a: 1.0 / (1.0 + np.exp(-a.astype(np.float64)))  # noqa
        assert np.abs(sig(lo) - sig(lo_cpu)).max() <= PROB_ATOL
    if cfg.model.model == "sym_gatedgcn" and cfg.model.normalization == (
            "batch"):
        want = JAX_GOLDEN_AP_BF16 if bf16 else JAX_GOLDEN_AP
        assert abs(get_aps(lo, golden.y) - want) < AP_TOL


# ----------------------------------------------------------- train step
def _step_result(model, loss, logits) -> dict:
    return {"loss": loss.detach().clone(), "logits": logits.detach().clone(),
            "grads": {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()},
            "state": {n: b.detach().clone()
                      for n, b in model.named_buffers()}}


@pytest.mark.parametrize("case", list(MODELS))
def test_card_train_step_vs_cpu_step(cuda, golden, case):
    """One full-width train step (dropout 0; the symmetry loss, the zoo's
    plain BCE) on the golden subgraph, on the card against the port's CPU
    step: the loss, every gradient and the buffers.  The batch-norm step
    runs both passes as one dual-width pass (``forward_dual``); in float32
    it is also held against the two sequential passes (``forward_pair``)
    on the card, logits included."""
    from gnnome_tpu_torch.train.loss import symmetry_loss
    from gnnome_tpu_torch.train.step import (host_units, make_example,
                                             make_optimizer, train_step)

    cfg, new_model = _model_of(case)
    cfg.train.masking = False
    cfg.train.num_nodes_per_cluster = 10 ** 9         # one unit per graph
    cfg.model.dropout = 0.0
    sub = golden_subgraph(golden)
    (unit,) = host_units(sub, cfg, np.random.default_rng(0))

    def example(device):
        return make_example(unit.in_deg, unit.out_deg, unit.e_feat, unit.y,
                            unit.src, unit.dst, unit.n_nodes, device,
                            cfg.model)

    def one_step(device):
        model = new_model(device)
        opt = make_optimizer(model, cfg.train.lr)
        gen = torch.Generator(device=device).manual_seed(0)
        loss, logits = train_step(model, opt, example(device), 4.0, cfg, gen)
        return _step_result(model, loss, logits)

    bf16 = cfg.compute.dtype == "bfloat16"
    got = one_step(cuda)
    check_step(got, one_step(torch.device("cpu")), bf16)
    if case == "batch-float32":
        ex = example(cuda)
        model = new_model(cuda).train()
        lo, lr = model.forward_pair(ex.g, ex.x, ex.x_rev, ex.e, None,
                                    slot_io=True)
        loss = symmetry_loss(lo[:, 0], lr[:, 0], ex.labels, 4.0,
                             alpha=cfg.train.alpha)
        loss.backward()
        check_step(got, _step_result(model, loss, lo[:, 0]), bf16,
                       logits=True)


# ------------------------------------------------------------------ cli
def test_host_library_builds_and_loads(cuda):
    """The C++ host library (``build/libgnnome_host.so``: similarities,
    labels, partitions, the decoder's walks) builds and loads on the card's
    machine; without it those fall back to Python."""
    from gnnome_tpu_torch import native

    assert native.get_lib() is not None


def _threads() -> str:
    return str(min(8, os.cpu_count() or 1))


def _infer(ds, out, model, *sets, asm="hifiasm"):
    """``cli infer`` on the card, counters from 0; its summary and
    launches, all and bf16."""
    from gnnome_tpu_torch import cli

    K.reset_launch_counts()
    summary = cli.main(["infer", "--data", ds, "--asm", asm, "--out", out,
                        "--model", model, "--set",
                        f"decode.len_threshold={INFER_LEN_THRESHOLD}",
                        *sets])
    assert summary["device"].startswith("cuda")
    return summary, K.launch_counts(), K.launch_counts(torch.bfloat16)


def _exact_top_contig(out, genome) -> None:
    """The longest contig of ``out``'s FASTA is an exact substring of the
    genome (or of its reverse complement) and at least the length
    threshold long."""
    from gnnome_tpu_torch.utils.fastx import read_fastx, reverse_complement

    contigs = list(read_fastx(os.path.join(out, "assembly",
                                           "0_assembly.fasta")))
    top = max(contigs, key=lambda c: len(c.seq))
    assert top.seq in genome or top.seq in reverse_complement(genome)
    assert len(top.seq) >= INFER_LEN_THRESHOLD


def _write_reads_gfa(root, dialect):
    """The decoding dataset's genome and reads (``INFER_GRAPH``: the same
    genome and reads, drawn the same way from the seed) as a GFA of
    ``dialect`` and a FASTA under ``root``; ``(gfa, reads, genome)``."""
    from gnnome_tpu_torch.graphs.synthetic import (random_genome,
                                                   simulate_reads_from_genome,
                                                   write_synthetic_gfa)

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(INFER_GRAPH["seed"])
    genome = random_genome(INFER_GRAPH["genome_len"], rng)
    records, starts, ends, strands = simulate_reads_from_genome(
        genome, INFER_GRAPH["n_reads"], INFER_GRAPH["read_len"], rng)
    gfa = os.path.join(root, f"{dialect}.gfa")
    reads = os.path.join(root, f"{dialect}_reads.fasta")
    write_synthetic_gfa(records, starts, ends, strands, gfa, reads,
                        dialect=dialect)
    return gfa, reads, genome


def _build_graph(gfa, reads, dialect, ds, *extra) -> str:
    from gnnome_tpu_torch import cli

    cli.main(["build-graph", "--gfa", gfa, "--reads", reads, "--asm",
              dialect, "--out", ds, "--threads", _threads(), *extra])
    return ds


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cli_infer_on_card(cuda, tmp_path, dtype):
    """``cli infer`` with the shipped weights on the decoding dataset: 8 K3
    + 1 K6, no probe kernel (the probes lie on no path), the longest
    contig an exact substring of the genome."""
    from gnnome_tpu_torch import probes

    ds, genome = make_infer_dataset(str(tmp_path / "ds"))
    out = str(tmp_path / "out")
    before = probes.launch_counts()
    _, counts, _ = _infer(ds, out, WEIGHTS, "--set",
                          f"compute.dtype={dtype}")
    assert counts == expected_launches(**FORWARD_LAUNCHES)
    assert probes.launch_counts() == before
    _exact_top_contig(out, genome)


@pytest.mark.parametrize("dialect", ["hifiasm", "raven"])
def test_gfa_route_on_card(cuda, tmp_path, dialect):
    """The front of the main path with the port alone: the decoding
    dataset's reads as a GFA of ``dialect``, ``cli build-graph`` (host),
    then ``cli infer`` on the card: 8 K3 + 1 K6, an exact contig."""
    gfa, reads, genome = _write_reads_gfa(str(tmp_path / "gfa"), dialect)
    ds = _build_graph(gfa, reads, dialect, str(tmp_path / "ds"))
    out = os.path.join(ds, dialect)
    _, counts, _ = _infer(ds, out, WEIGHTS, asm=dialect)
    assert counts == expected_launches(**FORWARD_LAUNCHES)
    _exact_top_contig(out, genome)


STUB_HIFIASM = """#!/bin/sh
# stub hifiasm for ``cli run``: writes the prepared GFA as
# <-o prefix>.bp.raw.r_utg.gfa, the file hifiasm --prt-raw writes
out=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift 2;; *) shift;; esac
done
cp "{gfa}" "$out.bp.raw.r_utg.gfa"
"""


def test_cli_run_with_stub_hifiasm_on_card(cuda, tmp_path):
    """``cli run`` with a stub hifiasm that copies the prepared GFA: 8 K3 +
    1 K6, and the FASTA of ``build-graph`` + ``infer``, byte for byte."""
    from gnnome_tpu_torch import cli

    gfa, reads, _ = _write_reads_gfa(str(tmp_path / "gfa"), "hifiasm")
    ds = _build_graph(gfa, reads, "hifiasm", str(tmp_path / "ds"))
    _infer(ds, os.path.join(ds, "hifiasm"), WEIGHTS)
    tools = tmp_path / "tools"
    tools.mkdir()
    (tools / "hifiasm").write_text(STUB_HIFIASM.format(gfa=gfa))
    (tools / "hifiasm").chmod(0o755)
    out = str(tmp_path / "run")
    K.reset_launch_counts()
    cli.main(["run", "-r", reads, "-o", out, "-t", _threads(), "-m",
              WEIGHTS, "--set", f"paths.hifiasm_dir={tools}", "--set",
              f"decode.len_threshold={INFER_LEN_THRESHOLD}"])
    assert K.launch_counts() == expected_launches(**FORWARD_LAUNCHES)
    fasta = os.path.join("hifiasm", "assembly", "0_assembly.fasta")
    with open(os.path.join(out, fasta), "rb") as a, open(
            os.path.join(ds, fasta), "rb") as b:
        assert a.read() == b.read()


def test_build_graph_training_then_overfit_epoch_on_card(cuda, tmp_path):
    """``cli build-graph --training`` on the hifiasm GFA, then one ``cli
    train --overfit`` epoch on the card: 8/8/8/8/1/1 K7/K3/K8/edge
    adjoint/K6/K9 per unit, one finite loss logged, the best model
    saved."""
    from gnnome_tpu_torch import cli

    gfa, reads, _ = _write_reads_gfa(str(tmp_path / "gfa"), "hifiasm")
    ds = _build_graph(gfa, reads, "hifiasm", str(tmp_path / "ds"),
                      "--training")
    K.reset_launch_counts()
    best = cli.main(["train", "--train", ds, "--valid", ds, "--asm",
                     "hifiasm", "--name", "gfa", "--overfit",
                     "--set", "train.num_epochs=1",
                     "--set", f"paths.checkpoints_path={tmp_path}/ckpt",
                     "--set", f"paths.models_path={tmp_path}/models"])
    counts = K.launch_counts()
    units = counts["k9_aggregate"]
    assert units >= 1
    assert counts == expected_launches(**times(TRAIN_STEP_LAUNCHES, units))
    with open(tmp_path / "ckpt" / "log_gfa_seed1.jsonl") as f:
        log = [json.loads(line) for line in f]
    assert len(log) == 1 and np.isfinite(log[0]["train/loss"])
    assert os.path.isfile(best)


def test_cli_train_golden_resumes_bitwise_on_card(cuda, golden, tmp_path):
    """``cli train`` with the default settings on the golden graph as a
    training dataset (train = valid): one epoch of U units of 8/8/8/8/1/1
    K7/K3/K8/edge adjoint/K6/K9 and V validation units of 8 K3 + 1 K6
    (U, V > 1), finite losses, the best model saved; two resumes from its
    checkpoint bitwise equal."""
    from gnnome_tpu_torch import cli

    ds = write_dataset(str(tmp_path / "golden"), golden)
    common = ["train", "--train", ds, "--valid", ds, "--asm", "hifiasm",
              "--name", "golden",
              "--set", f"paths.checkpoints_path={tmp_path}/ckpt",
              "--set", f"paths.models_path={tmp_path}/models"]
    K.reset_launch_counts()
    model_path = cli.main([*common, "--set", "train.num_epochs=1"])
    counts = K.launch_counts()
    units = counts["k9_aggregate"]
    v_units = (counts["k3_edge_stage"] - 8 * units) // 8
    assert units > 1 and v_units > 1
    assert counts == expected_launches(
        **{**times(TRAIN_STEP_LAUNCHES, units),
           "k3_edge_stage": 8 * (units + v_units),
           "k6_score_gate": units + v_units})
    with open(tmp_path / "ckpt" / "log_golden_seed1.jsonl") as f:
        log = [json.loads(line) for line in f]
    assert [r["epoch"] for r in log] == [0]
    assert all(np.isfinite(log[0][k]) for k in ("train/loss", "valid/loss"))
    assert os.path.isfile(model_path)
    resumed = []
    for i in range(2):
        cli.main([*common, "--resume", "--set", "train.num_epochs=2"])
        dst = tmp_path / "ckpt" / f"resumed_{i}.npz"
        os.replace(tmp_path / "ckpt" / "ckpt_golden_seed1_resumed-2.npz", dst)
        resumed.append(dst)
    with np.load(resumed[0]) as a, np.load(resumed[1]) as b:
        assert a.files == b.files
        assert all(np.array_equal(a[k], b[k]) for k in a.files)


# per case: (launches per overfit step, per forward of `cli infer` with the
# model it saved; None: the batch-norm model decodes with the shipped
# weights in test_cli_infer_on_card)
OVERFIT_CASES = {
    "batch-float32": (TRAIN_STEP_LAUNCHES, None),
    "layer-float32": (UNFUSED_STEP_LAUNCHES, UNFUSED_FORWARD_LAUNCHES),
    "batch-bfloat16": (TRAIN_STEP_LAUNCHES, None),
    "none-bfloat16": (K1K2_STEP_LAUNCHES, K1K2_FORWARD_LAUNCHES)}


@pytest.mark.parametrize("case", list(OVERFIT_CASES))
def test_cli_overfit_learns_on_card(cuda, tmp_path, case):
    """``cli train --overfit`` (12 epochs, lr 1e-3) on the card must learn
    (``torch_recipes.overfit_run``), 12 steps of the model's launches (in
    bf16 every one bf16), no probe kernel; the layer-norm and the bf16
    norm-free model then decode the decoding dataset with the model they
    saved: an exact contig, the model's launches per forward (bf16: every
    one bf16)."""
    from gnnome_tpu_torch import probes

    norm, dtype = case.split("-")
    per_step, per_forward = OVERFIT_CASES[case]
    before = probes.launch_counts()
    best, (counts, counts_bf16) = overfit_run(str(tmp_path / "train"), norm,
                                              dtype)
    assert counts == expected_launches(**times(per_step, 12))
    assert probes.launch_counts() == before
    if dtype == "bfloat16":
        assert counts_bf16 == counts
    if per_forward is None:
        return
    ds, genome = make_infer_dataset(str(tmp_path / "ds"))
    out = str(tmp_path / "out")
    _, counts, counts_bf16 = _infer(
        ds, out, best, "--set", f"model.normalization={norm}", "--set",
        f"compute.dtype={dtype}")
    assert counts == expected_launches(**per_forward)
    if dtype == "bfloat16":
        assert counts_bf16 == counts
    _exact_top_contig(out, genome)


def test_cli_zoo_gcn_on_card(cuda, tmp_path):
    """A zoo model's paths: ``cli train --set model.model=gcn`` (two
    epochs: 16 one-sided walks and one K2 per training unit, 8 walks per
    validation unit; finite losses), then ``cli infer`` with the model it
    saved: 8 walks, finite logits of shape [E]."""
    from gnnome_tpu_torch import cli
    from gnnome_tpu_torch.graphs.container import AssemblyGraph

    ds, _ = make_infer_dataset(str(tmp_path / "ds"))
    gcn = ["--set", "model.model=gcn"]
    K.reset_launch_counts()
    model_path = cli.main(["train", "--train", ds, "--valid", ds, "--asm",
                           "hifiasm", "--name", "gcn", *gcn,
                           "--set", "train.num_epochs=2",
                           "--set", f"paths.checkpoints_path={tmp_path}/ck",
                           "--set", f"paths.models_path={tmp_path}/models"])
    counts = K.launch_counts()
    units = counts["k2_aggregate"]
    v_units = (counts["k2_side_sum"] - 16 * units) // 8
    assert units > 0 and v_units > 0
    assert counts == expected_launches(k2_side_sum=16 * units + 8 * v_units,
                                       k2_aggregate=units)
    with open(tmp_path / "ck" / "log_gcn_seed1.jsonl") as f:
        log = [json.loads(line) for line in f]
    assert len(log) == 2 and all(np.isfinite(r["train/loss"]) for r in log)
    out = os.path.join(ds, "hifiasm")
    _, counts, _ = _infer(ds, out, model_path, *gcn)
    assert counts == expected_launches(
        k2_side_sum=ZOO_FORWARD_SIDE_SUMS["gcn"])
    logits = np.load(os.path.join(out, "decode", "0_predicts.npy"))
    graph = AssemblyGraph.load(os.path.join(ds, "hifiasm", "processed",
                                            "0.npz"))
    assert logits.shape == (graph.num_edges,) and np.isfinite(logits).all()


# --------------------------------------------------------- recorded runs
# Each recorded-run script in a process of its own at a reduced size, its
# JSON checked: the quality run's parity arm for 2 epochs on a graph of
# RECORDED_QUALITY_SPEC (train seed 100, validation seed 200), validation
# loss within RECORDED_PARITY_LOSS and AP within RECORDED_PARITY_AP of the
# oracle's each epoch (set before any card run from the CPU runs, 1.7e-6
# apart at two layers); the config-4 route at RECORDED_CONFIG4.
RECORDED_QUALITY_SPEC = ["genome_len=60000", "n_reads=200"]
RECORDED_CONFIG4 = ["--config4-nodes", "65536", "--both-nodes", "32768",
                    "--cluster-nodes", "16384", "--epochs-a", "1",
                    "--epochs-b", "2"]
RECORDED_PARITY_LOSS, RECORDED_PARITY_AP = 1e-5, 1e-4


def _recorded(script: str, args: list, tmp_path) -> dict:
    """``scripts/<script>.py args --out ...`` in a process of its own; its
    JSON."""
    out = tmp_path / f"{script}.json"
    p = subprocess.run([sys.executable, os.path.join(ROOT, "scripts",
                                                     f"{script}.py"),
                        *args, "--out", str(out)], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, (p.stdout + p.stderr)[-3000:]
    return json.loads(out.read_text())


def test_product_train_run_on_card(cuda, tmp_path):
    """The card mode's three masked and clustered graphs, 1 epoch: two
    resumes bitwise equal and equal to an uninterrupted run, launches per
    unit (the script checks them: units x 8/8/8/8/1/1 plus validation
    units x 0/8/0/0/1/0, no other kernel)."""
    prod = _recorded("torch_product_train_run", [
        "--mode", "card", "--epochs", "1", "--root", str(tmp_path / "p")],
        tmp_path)
    assert prod["resume_bit_identical"] is True
    assert prod["resume_equals_uninterrupted"] is True
    assert prod["launches_match_units"] is True


def test_golden_ecoli_run_on_card(cuda, tmp_path):
    """The golden run at full size (the tracked fixture): the AP within
    1e-4 of the JAX record 0.9992886, probabilities within 1e-5 of the
    oracle's, the decode of the JAX record (4 contigs, 5,858,100 bases,
    NG50 5,385,917), 8 K3 + 1 K6 per forward."""
    gold = _recorded("torch_golden_ecoli_run", ["--cached"], tmp_path)
    ap = gold["average_precision"]
    assert ap["jax_record"] is not None
    assert ap["abs_diff_port_jax_record"] <= AP_TOL
    assert gold["edge_prob_parity"]["max_abs_prob_diff"] <= PROB_ATOL
    assert gold["decode_equals_jax_record"] is True
    assert gold["forward"]["launches_per_forward"] == expected_launches(
        **FORWARD_LAUNCHES)


def test_train_quality_parity_on_card(cuda, tmp_path):
    """The quality run's parity arm, 2 epochs on one graph of a reduced
    spec: each epoch's validation loss and AP against the oracle's; 2
    steps and 2 evals of launches."""
    qual = _recorded("torch_train_quality_run", [
        "--stage", "build", "parity", "--root", str(tmp_path / "q"),
        "--parity-epochs", "2", "--train-seeds", "100", "--valid-seeds",
        "200", *sum((["--spec", kv] for kv in RECORDED_QUALITY_SPEC), [])],
        tmp_path)
    par = qual["collapse_parity"]
    assert len(par["port"]) == 2
    for a, b in zip(par["port"], par["torch_oracle"]):
        assert abs(a["valid_loss"] - b["valid_loss"]) <= RECORDED_PARITY_LOSS
        assert abs(a["ap"] - b["ap"]) <= RECORDED_PARITY_AP
    assert par["launches"]["all"] == expected_launches(
        **{**times(TRAIN_STEP_LAUNCHES, 2),
           "k3_edge_stage": 32, "k6_score_gate": 4})


def test_config4_route_on_card(cuda, tmp_path):
    """The config-4 route at 65,536 / 32,768 nodes in clusters of 16,384 (1
    and 2 epochs): finite losses, launches per unit."""
    c4 = _recorded("torch_config4_route", RECORDED_CONFIG4, tmp_path)
    runs = [c4["A_config4_cluster_route"], c4["B_convergence"]["full_graph"],
            c4["B_convergence"]["cluster"]]
    for r in runs:
        assert r["launches_match_units"] is True
        assert all(np.isfinite(e["train_loss"]) for e in r["epochs"])
        assert all(np.isfinite(e.get("eval_loss", 0.0)) for e in r["epochs"])
