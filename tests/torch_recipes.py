"""Recipes, tolerances and launch tables that the port's CPU tests and its
card suite (``tests/test_torch_cuda*.py``) share, one definition each.

This module imports neither JAX nor the JAX package: the card's machine
has neither, and the card suite runs there with ``--noconftest``.  Test
files import it as ``torch_recipes`` (pytest puts ``tests/`` on the path,
as for ``torch_ref``).
"""
from __future__ import annotations

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from gnnome_tpu_torch.ops import DeviceGraph
from gnnome_tpu_torch.ops import kernels as K

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_ecoli_v1.npz")
WEIGHTS = os.path.join(ROOT, "weights", "weights.npz")


@pytest.fixture(scope="module")
def cuda():
    """The card; skips where there is none (decided here, never while a
    test module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ------------------------------------------------------------- datasets
# The decoding dataset: an error-free 50 kb genome at ~7x; no false edges,
# so the decoded contig must be exact (with false edges the shipped weights
# follow planted chimeric edges).
INFER_GRAPH = dict(n_reads=400, genome_len=50_000, read_len=900, seed=1,
                   with_sequences=True, false_edge_frac=0.0)
INFER_LEN_THRESHOLD = 5000
# the overfit run of tests/test_train.py:131-170 (12 epochs, lr 1e-3): the
# last loss under OVERFIT_LOSS_DROP x the first, the saved model's AP above
# OVERFIT_MIN_AP
OVERFIT_GRAPH = dict(n_reads=120, genome_len=10000, read_len=400, seed=12,
                     with_sequences=True)
OVERFIT_LOSS_DROP, OVERFIT_MIN_AP = 0.9, 0.75
# a graph of fewer RC pairs than ranks (3 pairs at P = 4: one rank's block
# is empty)
FEW_PAIRS_GRAPH = dict(n_reads=3, genome_len=1500, read_len=600, seed=1,
                       with_sequences=True, false_edge_frac=0.0)


def write_dataset(root: str, graph, reads=None) -> str:
    """``graph`` (and ``reads``) in the dataset layout under ``root``."""
    for sub in ("processed", "info"):
        os.makedirs(os.path.join(root, "hifiasm", sub), exist_ok=True)
    graph.save(os.path.join(root, "hifiasm", "processed", "0.npz"))
    if reads is not None:
        reads.save(os.path.join(root, "hifiasm", "info", "0_reads.npz"))
    return root


def make_infer_dataset(root: str):
    """The decoding dataset (``INFER_GRAPH``) under ``root``
    (``hifiasm/processed/0.npz``, ``hifiasm/info/0_reads.npz``); returns
    ``(root, genome)``."""
    from gnnome_tpu_torch.graphs import synthetic_assembly_graph

    g, reads, _, genome = synthetic_assembly_graph(**INFER_GRAPH)
    return write_dataset(root, g, reads), genome


def golden_keep(g) -> np.ndarray:
    """The golden-subgraph recipe of tests/test_torch_model.py:104-118:
    the band around node 0 plus bands around a few hard negatives."""
    hard = np.nonzero((g.y == 0) & (g.overlap_similarity > 0.95))[0]
    keep = np.zeros(g.num_nodes, dtype=bool)
    keep[:1600] = True
    for eid in hard[:: max(1, len(hard) // 4)][:4]:
        for v in (int(g.src[eid]), int(g.dst[eid])):
            keep[max(0, v - 400): v + 400] = True
    return keep


def golden_subgraph(g):
    return g.node_subgraph(golden_keep(g))[0]


def gat_graph(src, dst, n: int, device="cpu") -> DeviceGraph:
    """The GAT's processor graph of ``(src, dst)``: the edges and a
    self-loop a node."""
    from gnnome_tpu_torch.config import ModelConfig
    from gnnome_tpu_torch.models.zoo import processor_graph

    return processor_graph(ModelConfig(model="gat"), np.asarray(src),
                           np.asarray(dst), n, device)


def gat_hub_graph(device="cpu") -> DeviceGraph:
    """300 nodes, 1,500 random edges, 2,500 into node 7, as the GAT's
    processor graph: a hub of over 2,500 in-edges."""
    rng = np.random.default_rng(4)
    n = 300
    src = rng.integers(0, n, 4000)
    dst = np.concatenate([rng.integers(1, n, 1500), np.full(2500, 7)])
    g = gat_graph(src, dst, n, device)
    assert int(g.dst_ptr[8] - g.dst_ptr[7]) > 2500
    return g


def overfit_run(root: str, normalization: str = "batch",
                dtype: str = "float32", device: str | None = None):
    """``cli train --overfit`` of the overfit recipe (``OVERFIT_GRAPH``, 12
    epochs, lr 1e-3, compute dtype ``dtype``; on the card unless
    ``device``) under ``root``, which must learn: the last loss under
    ``OVERFIT_LOSS_DROP`` x the first, the saved model's AP (scored at
    ``dtype`` on the same device) above ``OVERFIT_MIN_AP``.  Returns the
    best model's path and the launches of the run, all and bf16 (counters
    from 0)."""
    import json

    from gnnome_tpu_torch import cli
    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.graphs import synthetic_assembly_graph
    from gnnome_tpu_torch.infer import score_graph
    from gnnome_tpu_torch.models import load_model_weights
    from gnnome_tpu_torch.train.metrics import get_aps

    g, reads, _, _ = synthetic_assembly_graph(**OVERFIT_GRAPH)
    small = write_dataset(os.path.join(root, "small"), g, reads)
    on = [] if device is None else ["--set", f"compute.device={device}"]
    K.reset_launch_counts()
    best = cli.main(["train", "--train", small, "--valid", small, "--asm",
                     "hifiasm", "--name", "o", "--overfit", *on,
                     "--set", f"paths.checkpoints_path={root}/ckpt",
                     "--set", f"paths.models_path={root}/models",
                     "--set", "train.num_epochs=12", "--set", "train.lr=1e-3",
                     "--set", "train.masking=false",
                     "--set", "train.num_nodes_per_cluster=10000",
                     "--set", f"model.normalization={normalization}",
                     "--set", f"compute.dtype={dtype}"])
    counts = K.launch_counts(), K.launch_counts(torch.bfloat16)
    with open(os.path.join(root, "ckpt", "log_o_seed1.jsonl")) as f:
        losses = [json.loads(line)["train/loss"] for line in f]
    assert len(losses) == 12
    assert losses[-1] < OVERFIT_LOSS_DROP * losses[0], losses
    cfg = Config()
    cfg.compute.device = device or cfg.compute.device
    cfg.model.normalization = normalization
    cfg.compute.dtype = dtype
    ap = get_aps(score_graph(g, *load_model_weights(best), cfg), g.y)
    assert ap > OVERFIT_MIN_AP, ap
    return best, counts


# ----------------------------------------------------------- tolerances
# Set from the float32 arithmetic before any card run.  Logits pass 8
# layers of float32 matmuls in another order (CPU vs cuBLAS), which moves
# large logits by ~1e-5 relative (GOLDEN_ECOLI_r05.json: 5.5e-4 at |logit|
# ~ 50) and near-zero ones by more than the 2e-5 of the CPU parity tests.
LOGIT_ATOL, LOGIT_RTOL = 1e-4, 1e-4
PROB_ATOL = 1e-5
JAX_GOLDEN_AP = 0.9992886          # the JAX package, CPU, same graph+weights
AP_TOL = 1e-4
# bf16 (compute.dtype=bfloat16): the golden graph's AP within AP_TOL of the
# JAX package's bf16 figure (its XLA backend on the CPU, eval, flip=False,
# shipped weights).  Card against the port's CPU bf16 run: 8 layers of
# bf16 move single logits by several units (tests/test_torch_bf16.py), so
# logits are held by their cosine, the largest probability change and the
# AP (SCORE_*); a train step by the JAX package's bf16 bounds between its
# two backends (tests_tpu/test_on_tpu_parity.py:87-123); BN running
# statistics (float32, from bf16 gates) within 1e-2 + 1e-2 |x|.
JAX_GOLDEN_AP_BF16 = 0.9992662
SCORE_COS, SCORE_DP, SCORE_AP = 0.995, 0.25, 5e-4
BF16_LOSS_REL, BF16_GRAD_COS, BF16_GRAD_ELEM = 0.15, 0.999, 0.5
BF16_STATE_ATOL, BF16_STATE_RTOL = 1e-2, 1e-2
# the layer-norm and norm-free models in bf16 (seeded init weights, golden
# graph), card vs CPU: from the port's CPU bf16 forward against its float32
# one on the golden subgraph (cosine 0.99999 / 0.99994, probabilities
# within 0.0009 / 0.0026) with a margin of 10x; the AP within SCORE_AP
UNFUSED_SCORE_COS, UNFUSED_SCORE_DP = 0.9995, 0.02
# one train step, card against the port's CPU step, full width, dropout 0:
# the loss within 1e-5 relative; gradients within the repository's
# gradient tolerance (tests/test_pallas_k4.py:81).  A first bound of 1e-3
# of each tensor's largest magnitude failed on the gate biases B1, B2, B3,
# whose exact gradient is zero (BatchNorm removes any constant added to the
# gate), so their values are rounding noise.  BN running statistics as the
# forward outputs.
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_ATOL, STEP_GRAD_RTOL = 2e-4, 5e-3
STEP_STATE_ATOL, STEP_STATE_RTOL = 1e-5, 1e-4
INIT_SEED = 7           # init_weights seed of every model but the shipped one


def _f64(x) -> np.ndarray:
    """A tensor or array as numpy; floating values as float64."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        x = (x.double() if x.is_floating_point() else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float64) if np.issubdtype(x.dtype, np.floating) else x


def check_step(got, ref, bf16: bool, logits: bool = False) -> None:
    """A train step (``got``: ``loss``, ``grads`` and ``state`` by name,
    tensors or arrays, and ``logits``) against a reference step: the loss,
    every gradient and the state (float32 ``STEP_*``; bf16 ``BF16_*``, the
    gradients flattened into one vector: their cosine and the largest
    difference over max(|ref|, the reference's RMS)); integer state
    exactly; with ``logits`` the logits within ``LOGIT_*``."""
    loss_g, loss_r = float(got["loss"]), float(ref["loss"])
    names = list(ref["grads"])
    if bf16:
        assert abs(loss_g - loss_r) < BF16_LOSS_REL * abs(loss_r)
        g = np.concatenate([_f64(got["grads"][n]).ravel() for n in names])
        r = np.concatenate([_f64(ref["grads"][n]).ravel() for n in names])
        rms = float(np.sqrt((r ** 2).mean())) + 1e-8
        elem = float((np.abs(g - r) / np.maximum(np.abs(r), rms)).max())
        cos = float(g @ r / (np.linalg.norm(g) * np.linalg.norm(r) + 1e-12))
        assert np.isfinite(g).all() and cos > BF16_GRAD_COS, cos
        assert elem < BF16_GRAD_ELEM, elem
        atol, rtol = BF16_STATE_ATOL, BF16_STATE_RTOL
    else:
        assert abs(loss_g - loss_r) <= STEP_LOSS_RTOL * abs(loss_r)
        bad = []
        for n in names:
            a, b = _f64(got["grads"][n]), _f64(ref["grads"][n])
            if not (np.abs(a - b) <= STEP_GRAD_ATOL
                    + STEP_GRAD_RTOL * np.abs(b)).all():
                bad.append(n)
        assert not bad, bad
        atol, rtol = STEP_STATE_ATOL, STEP_STATE_RTOL
    for n, r in ref["state"].items():
        a, b = _f64(got["state"][n]), _f64(r)
        if np.issubdtype(b.dtype, np.floating):
            assert (np.abs(a - b) <= atol + rtol * np.abs(b)).all(), n
        else:
            assert np.array_equal(a, b), n
    if logits:
        a, b = _f64(got["logits"]), _f64(ref["logits"])
        assert a.shape == b.shape and np.isfinite(a).all()
        d = np.abs(a - b)
        assert (d <= LOGIT_ATOL + LOGIT_RTOL * np.abs(b)).all(), d.max()


# -------------------------------------------------------- launch tables
def expected_launches(**counts) -> dict:
    """Every kernel's launch count: ``counts``, and 0 for the others."""
    return {**{k: 0 for k in K.KERNELS}, **counts}


def times(table: dict, n: int) -> dict:
    return {k: n * v for k, v in table.items()}


# the eval forward of the batch-norm model: 8 K3 + 1 K6
FORWARD_LAUNCHES = {"k3_edge_stage": 8, "k6_score_gate": 1}
# the batch-norm symmetry-loss step runs both passes as one dual-width pass
# (forward_dual): per layer one K7 and one K3, their K8 and batch-norm edge
# adjoint; one K6, its K9.  The halo step runs the two passes apart.
TRAIN_STEP_LAUNCHES = {"k3_edge_stage": 8, "k6_score_gate": 1,
                       "k7_gate_stats": 8, "k8_train_layer_bwd": 8,
                       "bn_edge_adjoint": 8, "k9_aggregate": 1}
HALO_STEP_LAUNCHES = times(TRAIN_STEP_LAUNCHES, 2)
# the layer-norm and norm-free model in float32: per forward one K1, one
# layer-norm edge stage and one K2 (the gated means) per layer; per
# symmetry-loss step two forwards and their backwards (per layer the
# stage's adjoint and K2 for K1's adjoint, K2 for each predictor's endpoint
# gathers)
UNFUSED_FORWARD_LAUNCHES = {"k1_gather_gate": 8, "k2_aggregate": 8,
                            "ln_edge_stage": 8}
UNFUSED_STEP_LAUNCHES = {"k1_gather_gate": 16, "k2_aggregate": 34,
                         "ln_edge_stage": 16, "ln_edge_adjoint": 16}
# the same layers through the PyTorch chain between K1 and K2 (bf16
# operands; the sharded layer of parallel/sharded.py): K1 and K2 only
K1K2_FORWARD_LAUNCHES = {"k1_gather_gate": 8, "k2_aggregate": 8}
K1K2_STEP_LAUNCHES = {"k1_gather_gate": 16, "k2_aggregate": 34}
# their bf16 mode: the norm-free model runs every K1 and K2 in bf16,
# through the chain; the layer-norm model turns float32 at its first norms
# (LayerNorm's float32 weight and bias promote it, as in the JAX package),
# so only its first layer's K1 runs in bf16, and per step that K1's adjoint
# K2 too, and its float32 layers 2-8 run the layer-norm edge stage.  All
# launches (UNFUSED_*_ALL_BF16), and those in bf16
UNFUSED_FORWARD_ALL_BF16 = {"none": K1K2_FORWARD_LAUNCHES,
                            "layer": {**K1K2_FORWARD_LAUNCHES,
                                      "ln_edge_stage": 7}}
UNFUSED_STEP_ALL_BF16 = {"none": K1K2_STEP_LAUNCHES,
                         "layer": {**K1K2_STEP_LAUNCHES, "ln_edge_stage": 14,
                                   "ln_edge_adjoint": 14}}
UNFUSED_FORWARD_BF16 = {"none": K1K2_FORWARD_LAUNCHES,
                        "layer": {"k1_gather_gate": 1}}
UNFUSED_STEP_BF16 = {"none": K1K2_STEP_LAUNCHES,
                     "layer": {"k1_gather_gate": 2, "k2_aggregate": 2}}
# the model zoo: per eval forward the one-sided K2 walk runs once per
# sum_into (GatedGCN, GCN, SAGE one a layer; GAT two a layer, its
# softmax's denominators and its messages, with its three forward kernels
# around them); per step also once per gather_rows in the backward
# (GatedGCN two a layer, GCN and SAGE one) or, for GAT, four more walks a
# layer (the adjoints of its messages, denominators, el and er) with its
# three adjoint kernels, and one K2 for the predictor's gathers; the Graph
# Transformer's step also runs its four residual BatchNorms a layer as one
# Function each (forward and backward kernels; its eval forward takes the
# running statistics, no kernel)
GAT_FORWARD_KERNELS = {"gat_node_logits": 8, "gat_edge_softmax": 8,
                    "gat_messages": 8}
ZOO_FORWARD_LAUNCHES = {"gatedgcn": {"k2_side_sum": 8},
                        "gcn": {"k2_side_sum": 8},
                        "gat": {"k2_side_sum": 16, **GAT_FORWARD_KERNELS},
                        "sage": {"k2_side_sum": 8},
                        "graph_transformer": {"k2_side_sum": 8}}
ZOO_STEP_LAUNCHES = {"gatedgcn": {"k2_side_sum": 24, "k2_aggregate": 1},
                     "gcn": {"k2_side_sum": 16, "k2_aggregate": 1},
                     "gat": {"k2_side_sum": 48, "k2_aggregate": 1,
                             **GAT_FORWARD_KERNELS, "gat_message_adjoint": 8,
                             "gat_logit_adjoint": 8, "gat_node_adjoint": 8},
                     "sage": {"k2_side_sum": 16, "k2_aggregate": 1},
                     "graph_transformer": {"k2_side_sum": 24,
                                           "k2_aggregate": 1,
                                           "bn_residual_forward": 32,
                                           "bn_residual_backward": 32}}


# ------------------------------------------------------------- no edges
NO_EDGE_N, NO_EDGE_D = 5, 8
# float32 only: the one-sided walk and the GAT kernels (the zoo ignores the
# compute dtype) and the layer-norm edge stage and its adjoint (bf16 keeps
# the PyTorch chain)
FLOAT32_ONLY = ("k2_side_sum", "ln_edge_stage", "ln_edge_adjoint",
                "gat_node_logits", "gat_edge_softmax", "gat_messages",
                "gat_message_adjoint", "gat_logit_adjoint", "gat_node_adjoint")
# the residual BatchNorm takes batch statistics: no rows raises, forward and
# backward (tests/test_torch_residual_bn.py)
NEEDS_ROWS = ("bn_residual_forward", "bn_residual_backward")
NO_EDGE_CASES = [(name, dt) for name in sorted(K.KERNELS)
                 for dt in (torch.float32, torch.bfloat16)
                 if not (name in FLOAT32_ONLY and dt == torch.bfloat16)
                 and name not in NEEDS_ROWS]


def no_edge_call(name, dt, device="cpu", d: int = NO_EDGE_D):
    """``(wrapper call, expected outputs)`` of wrapper ``name`` on a graph
    of ``NO_EDGE_N`` nodes and no edges on ``device``: empty edge rows,
    zero node sums, zero float64 statistics (what a halo rank whose block
    holds no edge gets); the GAT's node kernels on no node."""
    n = NO_EDGE_N
    dg = DeviceGraph.build(np.zeros(0, np.int64), np.zeros(0, np.int64), n,
                           device)
    u, v, v_csr, u_csr = dg.roles(False)
    gen = torch.Generator().manual_seed(0)
    proj = torch.randn(n, 4 * d, generator=gen).to(device, dt)
    pu, pv = proj[:, :2 * d], proj[:, 2 * d:]
    f32, f64 = torch.float32, torch.float64

    def edges(w):
        return torch.zeros(0, w, dtype=dt, device=device)

    def zeros(*s, t=dt):
        return torch.zeros(*s, dtype=t, device=device)

    bn = torch.stack([torch.zeros(d), torch.ones(d), torch.ones(d),
                      torch.zeros(d)]).to(device, dt)
    # the GAT kernels (float32): 3 heads of d; the node kernels on no node
    nh = torch.randn(n, 3, generator=gen).to(device)
    feat = torch.randn(n, 3 * d, generator=gen).to(device)
    attn = torch.randn(2, 3, d, generator=gen).to(device)
    return {
        "k1_gather_gate": (lambda: K.k1_gather_gate(u, v, pu, pv, edges(d)),
                           [edges(3 * d)]),
        "k2_aggregate": (lambda: K.k2_aggregate(u, v, v_csr, u_csr,
                                                edges(2 * d), edges(2 * d)),
                         [zeros(n, 2 * d, t=f32)] * 2),
        "k2_side_sum": (lambda: K.k2_side_sum(u, u_csr, edges(d)),
                        [zeros(n, d, t=f32)]),
        "k3_edge_stage": (lambda: K.k3_edge_stage(u, v, v_csr, u_csr, pu, pv,
                                                  edges(d), edges(d), bn),
                          [edges(d), zeros(n, 2 * d), zeros(n, 2 * d)]),
        "k6_score_gate": (lambda: K.k6_score_gate(u, v, pu, edges(d)),
                          [edges(d)]),
        "k7_gate_stats": (lambda: K.k7_gate_stats(u, v, pu[:, :d], pv[:, :d],
                                                  edges(d)),
                          [zeros(2 * d, t=f64)]),
        "k8_train_layer_bwd": (
            lambda: K.k8_train_layer_bwd(u, v, v_csr, u_csr, zeros(n, 2 * d),
                                         zeros(n, 2 * d), pu, pv, edges(d),
                                         edges(d), edges(d), bn),
            [edges(d), edges(d), zeros(n, 3 * d), zeros(n, 3 * d),
             zeros(2 * d, t=f64)]),
        "k9_aggregate": (lambda: K.k9_aggregate(u, v, v_csr, u_csr, edges(d)),
                         [zeros(n, 2 * d, t=f32)]),
        "bn_edge_adjoint": (lambda: K.bn_edge_adjoint(
            edges(d), edges(d), bn, zeros(3, d, t=f32)), [edges(d)]),
        "ln_edge_stage": (lambda: K.ln_edge_stage(
            edges(3 * d), edges(d), bn[2], bn[3], 1e-5),
            [edges(d), edges(2 * d), edges(2 * d), edges(2)]),
        "ln_edge_adjoint": (
            lambda: K.ln_edge_adjoint(u, v, zeros(n, 2 * d), zeros(n, 2 * d),
                                      edges(3 * d), edges(d), edges(d),
                                      edges(2), bn[2], bn[3]),
            [edges(2 * d), edges(2 * d), edges(d), zeros(2, d)]),
        "gat_node_logits": (lambda: K.gat_node_logits(feat[:0], *attn),
                            [zeros(0, 3)] * 2),
        "gat_node_adjoint": (
            lambda: K.gat_node_adjoint(feat[:0], *attn, nh[:0], nh[:0],
                                       feat[:0]),
            [zeros(0, 3 * d), zeros(2, 3, d)]),
        "gat_edge_softmax": (lambda: K.gat_edge_softmax(u, v, v_csr[0], nh,
                                                        nh), [edges(3)]),
        "gat_messages": (lambda: K.gat_messages(u, v, feat, edges(3), nh),
                         [edges(3 * d), edges(3)]),
        "gat_message_adjoint": (
            lambda: K.gat_message_adjoint(u, v, feat, feat, edges(3), nh),
            [edges(3 * d), edges(3), edges(3)]),
        "gat_logit_adjoint": (
            lambda: K.gat_logit_adjoint(u, v, nh, nh, edges(3), edges(3), nh),
            [edges(3)]),
    }[name]


def check_no_edge_call(name, dt, device="cpu", d: int = NO_EDGE_D) -> None:
    """E = 0: the wrapper returns the outputs of ``no_edge_call``, in the
    dtypes of its contract, and counts no launch."""
    call, want = no_edge_call(name, dt, device, d)
    K.reset_launch_counts()
    got = call()
    got = list(got) if isinstance(got, tuple) else [got]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.device == b.device and torch.equal(a, b)
    assert K.launch_counts() == {k: 0 for k in K.KERNELS}


# ------------------------------------------------------- two launchers
MULTIHOST_SMOKE = os.path.join(ROOT, "scripts", "torch_multihost_smoke.py")
MULTIHOST_LINE = re.compile(r"MULTIHOST_OK rank=(\d+) world=(\d+) "
                            r"local=(\d+) transport=(\S+) loss=(\S+) "
                            r"launches=(\S+)")
LAUNCH_ENV = {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0",
              "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
              "MASTER_PORT": "1"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_two_hosts(n_nodes: int, nproc: int, device: str,
                     timeout: float = 300) -> dict:
    """Two ``torch.distributed.run`` launchers on 127.0.0.1 with ``nproc``
    ranks each running scripts/torch_multihost_smoke.py; every rank's
    ``MULTIHOST_OK`` fields by global rank.  Retried once on another port
    when the first was taken; every launcher is killed on a timeout."""
    for attempt in range(2):
        port = _free_port()
        env = {k: v for k, v in os.environ.items()
               if k not in LAUNCH_ENV and not k.startswith("TORCHELASTIC")}
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--nnodes", "2",
             "--node-rank", str(i), "--nproc-per-node", str(nproc),
             "--master-addr", "127.0.0.1", "--master-port", str(port),
             MULTIHOST_SMOKE, "--device", device, "--n-nodes", str(n_nodes)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=ROOT) for i in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            pytest.fail(f"launchers timed out after {timeout} s")
        joined = "\n".join(outs)
        if all(p.returncode == 0 for p in procs):
            return {int(m[0]): m for m in MULTIHOST_LINE.findall(joined)}
        if attempt == 0 and re.search(r"address already in use|EADDRINUSE",
                                      joined, re.I):
            continue
        pytest.fail("launchers failed:\n" + joined[-4000:])


# ----------------------------------------------------------- wire counts
def check_wire_counts(res, plan, kind: str, d: int, L: int,
                      n_params: int = 0, passes: int = 2) -> None:
    """Every rank's bytes and calls of a halo ``kind`` ("forward", with the
    logits' gather, or "step"; ``res`` every rank's ``checks`` result)
    equal what ``parallel/projection.py`` counts for it."""
    from gnnome_tpu_torch.parallel.projection import (forward_traffic,
                                                      step_traffic)

    assert [r["K"] for r in res] == [plan.K] * len(res)
    assert [r["R"] for r in res] == [plan.R] * len(res)
    for r in res:
        want = (forward_traffic(plan, r["rank"], d, L) if kind == "forward"
                else step_traffic(plan, r["rank"], d, L, n_params,
                                  passes=passes))
        assert r["bytes"] == want.sent, (kind, r["rank"])
        assert r["calls"] == want.calls, (kind, r["rank"])
