#!/usr/bin/env python3
"""Smoke run of gnnome_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--seed N]

Builds the CUDA kernels (``build/libgnnome_kernels.so``) and the host
library (``build/libgnnome_host.so``) from the sources in the checkout, then
runs its phases, each printing one JSON line (with ``elapsed_s``, the
seconds since the script started):

1. ``env``: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, compute capability, build seconds, the compiler's per-kernel
   register and spill report.
2. ``model``: the E. coli-scale golden graph
   (tests/fixtures/golden_ecoli_v1.npz: N=9,600, E=257,346) scored with
   ``weights/weights.npz`` (d=H=64, 8 layers) on the card; held against the
   port's own CPU run; two card runs bitwise equal; K3 launched 8 times and
   K6 once per forward; average precision against the graph's labels.
3. ``model_unfused``: the same graph scored by the layer-norm and the
   norm-free model at full width and depth (d=H=64, 8 layers, seeded init
   weights): card vs CPU, two card runs bitwise equal, exactly 8 K1 and 8
   K2 launches per forward and no other kernel, forward time and memory.
4. ``kernels``: K1, K2 (at Dp = 128 and 64), K3, K6, K7, K8 and K9 (each at
   both flips) at the golden graph's shapes on its real CSR, inputs from
   ``--seed``; each kernel against its plain PyTorch version on the card,
   and timed beside its least possible time and, where one PyTorch call
   computes the same function, that call's time: ``kernel_ms`` by CUDA
   events around 10 back-to-back calls (median of 10 such repeats, after
   warm-up; the host's share of a call included, which a short kernel's
   wrapper can exceed), ``device_ms`` the same with each repeat's calls
   queued behind a sleep kernel (the device alone); for K3 and K8 also the
   memory rate their device time gives the bytes they move, for K6 and K7
   the rate it gives their bound's bytes.  Then K3, K6, K7 and K8 at
   d = 192 and K2, K9 at width 256 on the same graph, and K6 at H = 20 on
   its one-float path; K6 on column slices of wider arrays (row-strided);
   each against its plain version and bitwise reproducible.
5. ``infer``: a synthetic dataset written in the dataset layout, then
   ``gnnome_tpu_torch.cli infer`` on the card (the eval path, with every
   launch counter set to 0 just before it); the longest contig must be an
   exact substring of the genome.
6. ``train_step`` and ``train_step_layer``: the full-width model (d=64, 8
   layers), started from the shipped weights (batch norm) or seeded init
   weights (layer norm).  On the golden subgraph, one symmetry-loss step on
   the card against the port's CPU step (loss, every gradient, BN state);
   on the whole golden graph as one unit, two steps from one state bitwise
   equal (loss, logits, gradients, parameters after Adam), exactly 16 K7,
   16 K3, 16 K8, 2 K6 and 2 K9 launches per step (layer norm: 16 K1 and 34
   K2), no host synchronisation inside a step
   (``torch.cuda.set_sync_debug_mode("error")``), the step time and peak
   memory.
7. ``train``: ``gnnome_tpu_torch.cli train`` on the card with the default
   settings (the training path, counters set to 0 just before it): one
   epoch on the golden graph written as a training dataset (train = valid);
   resumed twice from its checkpoint, the two checkpoints bitwise equal;
   then an overfit run on a small synthetic dataset (12 epochs, lr 1e-3)
   whose last loss must be under 0.9x its first and whose saved model must
   score an average precision above 0.75.
8. ``cli_layer``: the layer-norm model's paths, each with the counters set
   to 0 just before it: ``cli train --set model.normalization=layer`` on
   the overfit dataset (12 epochs, lr 1e-3), which must learn as phase 7's
   run must, then ``cli infer`` with the model it saved on phase 5's
   dataset, whose longest contig must be an exact substring of the genome.

Then one JSON line with every kernel's numbers (``ms`` its device time,
``call_ms`` its back-to-back call time; ``launches`` from the training path
of phase 7, for K1 and K2 from that of phase 8; every path's in
``launches_by_path``), the ``nvidia-smi`` line, and the last line
``{"ok": true, "device": {...}}``.  Any failed phase raises and the script
exits non-zero; without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "golden_ecoli_v1.npz")
WEIGHTS = os.path.join(ROOT, "weights", "weights.npz")
WORK = os.path.join(ROOT, "build", "chip_smoke")
START = time.perf_counter()

# the phase-4 dataset: an error-free 50 kb genome at ~7x; no false edges, so
# the decoded contig must be exact (with false edges the shipped weights
# follow planted chimeric edges)
INFER_GRAPH = dict(n_reads=400, genome_len=50_000, read_len=900, seed=1,
                   with_sequences=True, false_edge_frac=0.0)
INFER_LEN_THRESHOLD = 5000

# H100 SXM data sheet: HBM3 bandwidth, float32 and float64 (non-tensor-core)
# peaks
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F64_FLOPS_PER_S = 34e12

# tolerances, set from the float32 arithmetic, before any card run:
# edge outputs repeat the plain version's per-op rounding (only sigmoid's
# exp may differ by an ulp); node sums add ~27 terms of |x| <~ 5 in another
# order; logits pass 8 layers of float32 matmuls in another order (CPU vs
# cuBLAS), which moves large logits by ~1e-5 relative (the JAX-vs-torch
# golden record, GOLDEN_ECOLI_r05.json: 5.5e-4 at |logit| ~ 50) and
# near-zero ones by more than the 2e-5 of the CPU parity tests
EDGE_ATOL = 1e-5
SUM_ATOL, SUM_RTOL = 1e-4, 1e-5
LOGIT_ATOL, LOGIT_RTOL = 1e-4, 1e-4
PROB_ATOL = 1e-5
JAX_GOLDEN_AP = 0.9992886          # the JAX package, CPU, same graph+weights
AP_TOL = 1e-4
# the width checks of the kernels phase: d above 128 for K3, K6, K7 and K8
# (two column chunks), payloads of 256 for K2 and K9, and K6 at H = 20 with
# odd row strides (its one-float path)
WIDE_D, WIDE_PAY, ODD_H = 192, 256, 20
# K7 / K8 global sums are float64 in another order than the plain version's:
# within 1e-9 of the summed magnitudes.  K8's x is exact (the same
# operations), d_eo within EDGE_ATOL (sigmoid), its node sums as K3's.
SUM64_RTOL = 1e-9
# one train step, card against the port's CPU step, full width, shipped
# weights, dropout 0: the loss within 1e-5 relative; gradients elementwise
# within the repository's gradient tolerance (tests/test_pallas_k4.py:81:
# 8 layers of float32 matmuls summed in another order, forward and back).
# A first bound of 1e-3 of each tensor's largest magnitude failed on the
# gate biases B1, B2, B3, whose exact gradient is zero (BatchNorm removes
# any constant added to the gate), so their values are rounding noise.
# BN running statistics as the forward outputs.
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_ATOL, STEP_GRAD_RTOL = 2e-4, 5e-3
STEP_STATE_ATOL, STEP_STATE_RTOL = 1e-5, 1e-4
# the overfit run of tests/test_train.py:131-170
OVERFIT_GRAPH = dict(n_reads=120, genome_len=10000, read_len=400, seed=12,
                     with_sequences=True)
OVERFIT_LOSS_DROP, OVERFIT_MIN_AP = 0.9, 0.75
TRAIN_STEP_LAUNCHES = {"k3_edge_stage": 16, "k6_score_gate": 2,
                       "k7_gate_stats": 16, "k8_train_layer_bwd": 16,
                       "k9_aggregate": 2}
# the layer-norm and norm-free model runs K1 and K2 only: per forward one K1
# and one K2 (the gated means) per layer; per symmetry-loss step two
# forwards and their backwards (K2 for each K1, two row gathers for each
# gated-mean K2, K2 for each predictor's endpoint gathers)
UNFUSED_FORWARD_LAUNCHES = {"k1_gather_gate": 8, "k2_aggregate": 8}
UNFUSED_STEP_LAUNCHES = {"k1_gather_gate": 16, "k2_aggregate": 34}
UNFUSED_INIT_SEED = 7              # init_weights seed of those models


def expected_launches(**counts) -> dict:
    """Every kernel's launch count: ``counts``, and 0 for the others."""
    from gnnome_tpu_torch.ops import kernels as K

    return {**{k: 0 for k in K.KERNELS}, **counts}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw,
                      "elapsed_s": time.perf_counter() - START}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


def make_infer_dataset(root: str):
    """Write the phase-4 synthetic graph + reads into the dataset layout
    under ``root`` (``hifiasm/processed/0.npz``, ``hifiasm/info/0_reads.npz``);
    returns (root, genome)."""
    from gnnome_tpu_torch.graphs import synthetic_assembly_graph

    g, reads, _, genome = synthetic_assembly_graph(**INFER_GRAPH)
    return write_dataset(root, g, reads), genome


def average_precision(probs, labels) -> float:
    """Area under the precision-recall step curve (sklearn's
    average_precision_score; the reference's get_aps)."""
    import numpy as np

    order = np.argsort(-probs, kind="mergesort")
    p, y = probs[order], labels[order].astype(np.float64)
    last = np.r_[np.nonzero(np.diff(p))[0], p.size - 1]
    tp = np.cumsum(y)[last]
    fp = (last + 1) - tp
    precision, recall = tp / (tp + fp), tp / tp[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def cuda_ms(fn, reps: int = 10, n: int = 10, warmup: int = 3,
            queued: bool = False) -> float:
    """Milliseconds per call of ``fn`` on the card: the median over ``reps``
    repeats of ``n`` back-to-back calls between two CUDA events.  Calls
    queue ahead of the device, so the host's per-call overhead hides
    behind the kernels whenever the device is the bottleneck.  With
    ``queued`` the host queues each repeat's calls while the device still
    runs a sleep kernel, so the time is the device's alone: the host's share
    of a call, which can exceed a short kernel's time, is left out."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, cycles = [], 1 << 24            # ~10 ms of sleep at 1.7 GHz
    while len(times) < reps:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(cycles)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        ahead = not queued or not a.query()     # the device still slept
        b.synchronize()
        if ahead:
            times.append(a.elapsed_time(b) / n)
        else:                      # the host fell behind: sleep longer
            cycles *= 2
            check(cycles <= 1 << 32, "calls queued behind a sleep kernel")
    return statistics.median(times)


def kernel_times(fn) -> dict:
    """A kernel wrapper's ``kernel_ms`` (back-to-back calls, host included)
    and ``device_ms`` (calls queued behind a sleep: the device alone)."""
    return {"kernel_ms": cuda_ms(fn), "device_ms": cuda_ms(fn, queued=True)}


def bound(nbytes: float, flops: float, flops64: float = 0.0):
    """Least time in ms: the larger of bytes over the memory rate and the
    float32 plus float64 operations over their peak rates."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / F32_FLOPS_PER_S + flops64 / F64_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def golden_subgraph(g):
    """The golden-subgraph recipe of tests/test_torch_model.py:104-118: the
    band around node 0 plus bands around a few hard negatives."""
    import numpy as np

    hard = np.nonzero((g.y == 0) & (g.overlap_similarity > 0.95))[0]
    keep = np.zeros(g.num_nodes, dtype=bool)
    keep[:1600] = True
    for eid in hard[:: max(1, len(hard) // 4)][:4]:
        for v in (int(g.src[eid]), int(g.dst[eid])):
            keep[max(0, v - 400): v + 400] = True
    return g.node_subgraph(keep)[0]


def write_dataset(root: str, graph, reads=None) -> str:
    """``graph`` (and ``reads``) in the dataset layout under ``root``."""
    for sub in ("processed", "info"):
        os.makedirs(os.path.join(root, "hifiasm", sub), exist_ok=True)
    graph.save(os.path.join(root, "hifiasm", "processed", "0.npz"))
    if reads is not None:
        reads.save(os.path.join(root, "hifiasm", "info", "0_reads.npz"))
    return root


# ------------------------------------------------------------------- phases
def phase_env():
    import torch

    from gnnome_tpu_torch import native
    from gnnome_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    K.build_kernels(force=True)
    t_kernels = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(native.get_lib() is not None, "host library built and loaded")
    t_host = time.perf_counter() - t0
    with open(os.path.join(K.BUILD_DIR, "nvcc.log")) as f:
        ptxas = [ln.strip() for ln in f
                 if "Used" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("env", nvidia_smi=nvidia_smi(), torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)),
         build_s={"cuda_kernels": t_kernels, "host_library": t_host},
         ptxas=ptxas)


def bn_rows(d: int, randn, rand):
    """Eval/batch BatchNorm rows [mean, rsqrt(var + eps), gamma, beta]."""
    import torch

    return torch.stack([randn(d) * 0.3, rand(d) * 1.5 + 0.5, rand(d) + 0.5,
                        randn(d) * 0.1])


def within_sums(got, ref) -> bool:
    return bool(((got - ref).abs() <= SUM_ATOL + SUM_RTOL * ref.abs()).all())


def within64(got, ref, terms) -> bool:
    """float64 sums in another order: within SUM64_RTOL of the summed
    magnitudes ``terms``."""
    return bool(((got - ref).abs() <= SUM64_RTOL * terms + 1e-12).all())


def check_k3(g, flip, proj_u, proj_v, b3e, e_in, bn, what):
    """K3 against its plain version at one flip, and a second launch bitwise
    equal to the first; returns (kernel args, max |diff| of e_out, of all)."""
    import torch

    from gnnome_tpu_torch.ops import kernels as K

    u, v, v_csr, u_csr = g.roles(flip)
    args = (u, v, v_csr, u_csr, proj_u, proj_v, b3e, e_in, bn)
    got = K.k3_edge_stage(*args)
    ref = K.k3_edge_stage_plain(u, v, proj_u, proj_v, b3e, e_in, bn)
    torch.cuda.synchronize()
    diff = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    check(diff[0] <= EDGE_ATOL, f"K3 {what} flip={flip} e_out diff {diff[0]}")
    for x, y in zip(got[1:], ref[1:]):
        check(within_sums(x, y), f"K3 {what} flip={flip} node sums")
    again = K.k3_edge_stage(*args)
    check(all(torch.equal(p, q) for p, q in zip(got, again)),
          f"K3 {what} flip={flip} bitwise reproducible")
    return args, diff[0], max(diff)


def check_k7(g, flip, bu, bv, b3e, what):
    import torch

    from gnnome_tpu_torch.ops import kernels as K

    u, v, _, _ = g.roles(flip)
    got = K.k7_gate_stats(u, v, bu, bv, b3e)
    ref = K.k7_gate_stats_plain(u, v, bu, bv, b3e)
    x = (bu[u.long()] + bv[v.long()] + b3e).double()
    check(within64(got, ref, torch.cat([x.abs().sum(0), (x * x).sum(0)])),
          f"K7 {what} flip={flip} sums within tolerance")
    check(torch.equal(got, K.k7_gate_stats(u, v, bu, bv, b3e)),
          f"K7 {what} flip={flip} bitwise reproducible")
    return (float((got - ref).abs().max()),
            float(((got - ref).abs() / ref.abs().clamp_min(1e-300)).max()))


def check_k6(g, flip, puv, be, what):
    """K6 bit-equal to its plain version and bitwise reproducible; returns
    the max |diff| (0)."""
    import torch

    from gnnome_tpu_torch.ops import kernels as K

    u, v, _, _ = g.roles(flip)
    got = K.k6_score_gate(u, v, puv, be)
    ref = K.k6_score_gate_plain(u, v, puv, be)
    torch.cuda.synchronize()
    diff = float((got - ref).abs().max())
    check(diff == 0.0, f"K6 {what} flip={flip} diff {diff}")
    check(torch.equal(got, K.k6_score_gate(u, v, puv, be)),
          f"K6 {what} flip={flip} bitwise reproducible")
    return diff


def check_k8(g, flip, args, what):
    """K8 against its plain version (x exact, d_eo within EDGE_ATOL, node
    sums, float64 sums) and bitwise reproducible; returns (max |diff| of
    x, d_eo and the node sums, of d_eo)."""
    import torch

    from gnnome_tpu_torch.ops import kernels as K

    u, v, v_csr, u_csr = g.roles(flip)
    got = K.k8_train_layer_bwd(u, v, v_csr, u_csr, *args)
    ref = K.k8_train_layer_bwd_plain(u, v, *args)
    torch.cuda.synchronize()
    check(torch.equal(got[0], ref[0]), f"K8 {what} flip={flip} x exact")
    d_eo_diff = float((got[1] - ref[1]).abs().max())
    check(d_eo_diff <= EDGE_ATOL,
          f"K8 {what} flip={flip} d_eo diff {d_eo_diff}")
    for a_, b_ in zip(got[2:4], ref[2:4]):
        check(within_sums(a_, b_), f"K8 {what} flip={flip} node sums")
    deo = ref[1].double().abs()
    check(within64(got[4], ref[4], torch.cat(
        [deo.sum(0), (deo * ref[0].double().abs()).sum(0)])),
        f"K8 {what} flip={flip} global sums within tolerance")
    again = K.k8_train_layer_bwd(u, v, v_csr, u_csr, *args)
    check(all(torch.equal(p, q) for p, q in zip(got, again)),
          f"K8 {what} flip={flip} bitwise reproducible")
    return (max(float((p - q).abs().max()) for p, q in zip(got[:4], ref[:4])),
            d_eo_diff)


def check_sum_kernel(name, got, ref, again, what):
    """K2 / K9: node sums against the plain version, bitwise reproducible;
    returns the max |diff|."""
    for a_, b_ in zip(got, ref):
        check(within_sums(a_, b_), f"{name} {what} sums within tolerance")
    check(all(__import__("torch").equal(p, q) for p, q in zip(got, again)),
          f"{name} {what} bitwise reproducible")
    return max(float((a_ - b_).abs().max()) for a_, b_ in zip(got, ref))


def phase_kernels(seed: int, dev, per_forward: dict):
    """Each kernel vs its plain version at the golden graph's shapes, and
    K2, K3, K7, K8, K9 at widths above 128 on the same graph."""
    import torch

    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.ops import DeviceGraph
    from gnnome_tpu_torch.ops import kernels as K

    graph = AssemblyGraph.load(GOLDEN)
    g = DeviceGraph.from_graph(graph, dev)
    N, E, d, H = g.n_nodes, g.n_edges, 64, 64
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    def rand(*shape):
        return torch.rand(*shape, device=dev, generator=gen)

    proj = randn(N, 5 * d)                  # [B1|A2|B2|A3|A1], as the model
    proj_u, proj_v = proj[:, :2 * d], proj[:, 2 * d:4 * d]
    b3e, e_in = randn(E, d), randn(E, d)
    bn = bn_rows(d, randn, rand)
    puv, be = randn(N, 2 * H), randn(E, H)
    f4, i4 = 4, 4
    out = {}

    # least time: read proj_u/proj_v (used columns), b3e, e_in, bn, u/v
    # indices, both row-pointer arrays and one slot permutation; write
    # e_out and both [N, 2d] sums.  ~20 flops per (edge, feature) over the
    # two passes (gate 2, BN 4, relu 1, residual 1, sigmoid ~3 twice,
    # gated products and sums 3 twice).
    k3_bytes = (f4 * (2 * N * 2 * d + 3 * E * d + 4 * d + 2 * N * 2 * d)
                + i4 * (3 * E + 2 * (N + 1)))
    k3_bound, k3_by = bound(k3_bytes, 20.0 * E * d)
    # what the kernel moves: the bound's bytes, pass 2's re-read of e_out
    # and the second partner array (one per CSR)
    k3_moved = k3_bytes + f4 * E * d + i4 * E
    k3 = {"launches_per_forward": per_forward["k3_edge_stage"]}
    for flip in (False, True):
        args, diff_e, diff = check_k3(g, flip, proj_u, proj_v, b3e, e_in, bn,
                                      f"d={d}")
        u, v = args[:2]
        t = kernel_times(lambda: K.k3_edge_stage(*args))
        k3[f"flip={flip}"] = {
            "max_abs_diff": diff, "max_abs_diff_e_out": diff_e, **t,
            "achieved_gbps": k3_moved / t["device_ms"] / 1e6,
            "plain_ms": cuda_ms(lambda: K.k3_edge_stage_plain(
                u, v, proj_u, proj_v, b3e, e_in, bn))}
    k3.update(bound_ms=k3_bound, bound_by=k3_by, bytes=k3_bytes,
              moved_bytes=k3_moved, bitwise_reproducible=True,
              tolerance={"e_out_atol": EDGE_ATOL, "sums_atol": SUM_ATOL,
                         "sums_rtol": SUM_RTOL})
    out["k3_edge_stage"] = k3

    # read puv, be, u/v indices; write z; add, add, max per element
    k6_bytes = f4 * (N * 2 * H + 2 * E * H) + i4 * 2 * E
    k6_bound, k6_by = bound(k6_bytes, 3.0 * E * H)
    k6 = {"launches_per_forward": per_forward["k6_score_gate"]}
    # the same values as column slices of wider arrays (row-strided)
    puv_s = torch.zeros(N, 2 * H + 8, device=dev)[:, :2 * H].copy_(puv)
    be_s = torch.zeros(E, H + 8, device=dev)[:, :H].copy_(be)
    for flip in (False, True):
        u, v, _, _ = g.roles(flip)
        diff = check_k6(g, flip, puv, be, f"H={H}")
        check_k6(g, flip, puv_s, be_s, f"H={H} strided")
        t = kernel_times(lambda: K.k6_score_gate(u, v, puv, be))
        k6[f"flip={flip}"] = {
            "max_abs_diff": diff, **t,
            "achieved_gbps": k6_bytes / t["device_ms"] / 1e6,
            "strided_device_ms": cuda_ms(lambda: K.k6_score_gate(
                u, v, puv_s, be_s), queued=True),
            "plain_ms": cuda_ms(lambda: K.k6_score_gate_plain(u, v, puv,
                                                              be))}
    k6.update(bound_ms=k6_bound, bound_by=k6_by, bytes=k6_bytes,
              bitwise_reproducible=True, tolerance={"atol": 0.0})
    out["k6_score_gate"] = k6

    # ---- training kernels: the model's [N, 4d] training projection
    proj4 = randn(N, 4 * d)                 # [B1|A2|B2|A3]
    tu, tv = proj4[:, :2 * d], proj4[:, 2 * d:]
    d_e_out, d_sum_u, d_sum_v = randn(E, d), randn(N, 2 * d), randn(N, 2 * d)

    # read the two [N, d] gate columns, b3e, u/v indices; write [2d] f64.
    # Per (edge, feature): 2 f32 adds (the gate); 3 f64 operations (sum x,
    # x*x, sum x*x)
    k7_bytes = f4 * (2 * N * d + E * d) + i4 * 2 * E + 8 * 2 * d
    k7_bound, k7_by = bound(k7_bytes, 2.0 * E * d, 3.0 * E * d)
    k7 = {}
    bu, bv = tu[:, :d], tv[:, :d]
    for flip in (False, True):
        u, v, _, _ = g.roles(flip)
        diff, rel = check_k7(g, flip, bu, bv, b3e, f"d={d}")
        t = kernel_times(lambda: K.k7_gate_stats(u, v, bu, bv, b3e))
        k7[f"flip={flip}"] = {
            "max_abs_diff": diff, "max_rel_diff": rel, **t,
            "achieved_gbps": k7_bytes / t["device_ms"] / 1e6,
            "plain_ms": cuda_ms(lambda: K.k7_gate_stats_plain(u, v, bu, bv,
                                                              b3e))}
    k7.update(bound_ms=k7_bound, bound_by=k7_by, bytes=k7_bytes,
              tolerance={"sum64_rtol_of_magnitudes": SUM64_RTOL})
    out["k7_gate_stats"] = k7

    k8 = {}
    k8_args = (d_sum_u, d_sum_v, tu, tv, b3e, e_in, d_e_out, bn)
    for flip in (False, True):
        u, v, v_csr, u_csr = g.roles(flip)
        diff, d_eo_diff = check_k8(g, flip, k8_args, f"d={d}")
        k8[f"flip={flip}"] = {
            "max_abs_diff": diff, "max_abs_diff_d_eo": d_eo_diff,
            **kernel_times(lambda: K.k8_train_layer_bwd(
                u, v, v_csr, u_csr, *k8_args)),
            "plain_ms": cuda_ms(lambda: K.k8_train_layer_bwd_plain(
                u, v, *k8_args))}
    # read d_sum_u/v, proj_u/v ([N, 2d] each), b3e, e_in, d_e_out, bn, u/v
    # indices, both row-pointer arrays and one slot permutation; write x,
    # d_eo, node_u/v ([N, 3d]) and [2d] f64.  Per (edge, feature) about 49
    # float32 operations over the two passes (gate 2, BN 4 twice, relu and
    # residual 2 twice, sigmoid ~4 twice, d_sigma 7, d_eo 4, d_y 1, three
    # sums of 2, 2 and 1 twice) and 3 float64 (sum d_y, d_y*x, its sum)
    k8_bytes = (f4 * (4 * N * 2 * d + 3 * E * d + 4 * d + 2 * E * d
                      + 2 * N * 3 * d) + 8 * 2 * d
                + i4 * (3 * E + 2 * (N + 1)))
    k8_bound, k8_by = bound(k8_bytes, 49.0 * E * d, 3.0 * E * d)
    # what the kernel moves: the bound's bytes, pass 2's re-reads of x,
    # d_eo and e_in, and the second partner array
    k8_moved = k8_bytes + f4 * 3 * E * d + i4 * E
    for flip in (False, True):
        r = k8[f"flip={flip}"]
        r["achieved_gbps"] = k8_moved / r["device_ms"] / 1e6
    k8.update(bound_ms=k8_bound, bound_by=k8_by, bytes=k8_bytes,
              moved_bytes=k8_moved, bitwise_reproducible=True,
              tolerance={"x": "exact", "d_eo_atol": EDGE_ATOL,
                         "sums_atol": SUM_ATOL, "sums_rtol": SUM_RTOL,
                         "sum64_rtol_of_magnitudes": SUM64_RTOL})
    out["k8_train_layer_bwd"] = k8

    k9 = {}
    pay = torch.relu(randn(E, H))           # dz * (z > 0): about half zeros
    for flip in (False, True):
        u, v, v_csr, u_csr = g.roles(flip)
        diff = check_sum_kernel(
            "K9", K.k9_aggregate(u, v, v_csr, u_csr, pay),
            K.k9_aggregate_plain(u, v, pay, N),
            K.k9_aggregate(u, v, v_csr, u_csr, pay), f"flip={flip}")
        # the one PyTorch call for the same sums: index_add_ over the
        # stacked index [u; v + N] and payload [pay; pay] (built outside
        # the timing); it adds with atomics, so its sums vary run to run
        uv = torch.cat([u.long(), v.long() + N])
        pay2 = torch.cat([pay, pay])
        acc = torch.zeros(2 * N, H, device=dev)
        k9[f"flip={flip}"] = {
            "max_abs_diff": diff,
            **kernel_times(lambda: K.k9_aggregate(u, v, v_csr, u_csr,
                                                  pay)),
            "plain_ms": cuda_ms(lambda: K.k9_aggregate_plain(u, v, pay, N)),
            "library_ms": cuda_ms(lambda: acc.zero_().index_add_(0, uv,
                                                                 pay2))}
    # read pay, both row-pointer arrays and one slot permutation; write the
    # two [N, H] sums; one add per (edge, feature) and endpoint
    k9_bytes = f4 * (E * H + 2 * N * H) + i4 * (E + 2 * (N + 1))
    k9_bound, k9_by = bound(k9_bytes, 2.0 * E * H)
    k9.update(bound_ms=k9_bound, bound_by=k9_by, bytes=k9_bytes,
              tolerance={"sums_atol": SUM_ATOL, "sums_rtol": SUM_RTOL},
              library_call="torch.Tensor.index_add_ on [u; v+N], [pay; pay]")
    out["k9_aggregate"] = k9

    # ---- the layer-norm model's kernels: K1 on the [N, 5d] projection's
    # column slices, as the model calls it
    k1 = {}
    for flip in (False, True):
        u, v, _, _ = g.roles(flip)
        got = K.k1_gather_gate(u, v, proj_u, proj_v, b3e)
        ref = K.k1_gather_gate_plain(u, v, proj_u, proj_v, b3e)
        torch.cuda.synchronize()
        diff = float((got - ref).abs().max())
        check(diff <= EDGE_ATOL, f"K1 flip={flip} diff {diff}")
        check(torch.equal(got, K.k1_gather_gate(u, v, proj_u, proj_v, b3e)),
              f"K1 flip={flip} bitwise reproducible")
        k1[f"flip={flip}"] = {
            "max_abs_diff": diff,
            **kernel_times(lambda: K.k1_gather_gate(u, v, proj_u, proj_v,
                                                    b3e)),
            "plain_ms": cuda_ms(lambda: K.k1_gather_gate_plain(
                u, v, proj_u, proj_v, b3e))}
    # read the used [N, 2d] halves of the projection, b3e, u/v indices;
    # write [E, 3d]; two adds per (edge, feature)
    k1_bytes = f4 * (2 * N * 2 * d + E * d + E * 3 * d) + i4 * 2 * E
    k1_bound, k1_by = bound(k1_bytes, 2.0 * E * d)
    k1.update(bound_ms=k1_bound, bound_by=k1_by, bytes=k1_bytes,
              tolerance={"atol": EDGE_ATOL})
    out["k1_gather_gate"] = k1

    # K2 at Dp = 2d (the gated mean, K1's adjoint) and Dp = d (the
    # predictor gathers' adjoint)
    k2 = {}
    for width in (2 * d, d):
        pay_u, pay_v = randn(E, width), randn(E, width)
        pay2 = torch.cat([pay_u, pay_v])
        acc = torch.zeros(2 * N, width, device=dev)
        r = {}
        for flip in (False, True):
            u, v, v_csr, u_csr = g.roles(flip)
            diff = check_sum_kernel(
                "K2", K.k2_aggregate(u, v, v_csr, u_csr, pay_u, pay_v),
                K.k2_aggregate_plain(u, v, pay_u, pay_v, N),
                K.k2_aggregate(u, v, v_csr, u_csr, pay_u, pay_v),
                f"Dp={width} flip={flip}")
            # the one PyTorch call for the same sums, as for K9
            uv = torch.cat([u.long(), v.long() + N])
            r[f"flip={flip}"] = {
                "max_abs_diff": diff,
                **kernel_times(lambda: K.k2_aggregate(
                    u, v, v_csr, u_csr, pay_u, pay_v)),
                "plain_ms": cuda_ms(lambda: K.k2_aggregate_plain(
                    u, v, pay_u, pay_v, N)),
                "library_ms": cuda_ms(lambda: acc.zero_().index_add_(
                    0, uv, pay2))}
        # read both payloads, both row-pointer arrays and one slot
        # permutation; write the two [N, Dp] sums; one add per element
        k2_bytes = f4 * (2 * E * width + 2 * N * width) + i4 * (E + 2 * (N + 1))
        k2_bound, k2_by = bound(k2_bytes, 2.0 * E * width)
        r.update(bound_ms=k2_bound, bound_by=k2_by, bytes=k2_bytes)
        k2[f"Dp={width}"] = r
    k2.update(tolerance={"sums_atol": SUM_ATOL, "sums_rtol": SUM_RTOL},
              library_call="torch.Tensor.index_add_ on [u; v+N], "
                           "[pay_u; pay_v]")
    out["k2_aggregate"] = k2

    # ---- widths above 128: K3, K6, K7, K8 at d = WIDE_D (two column
    # chunks) and K2, K9 at WIDE_PAY, and K6 at ODD_H with odd row strides
    # (the one-float path), each against its plain version and bitwise
    # reproducible, both flips; not timed
    dw, wp, ho = WIDE_D, WIDE_PAY, ODD_H
    # K6's operands as column slices: row strides 2 * dw + 8 and dw + 8
    # (float4 rows), 2 * ho + 1 and ho + 1 (one float per lane)
    puv_w = randn(N, 2 * dw + 8)[:, :2 * dw]
    be_w = randn(E, dw + 8)[:, :dw]
    puv_o = randn(N, 2 * ho + 1)[:, :2 * ho]
    be_o = randn(E, ho + 1)[:, :ho]
    projw = randn(N, 5 * dw)
    b3w, e_inw, d_e_outw = randn(E, dw), randn(E, dw), randn(E, dw)
    bnw = bn_rows(dw, randn, rand)
    d_suw, d_svw = randn(N, 2 * dw), randn(N, 2 * dw)
    pay_u, pay_v = randn(E, wp), randn(E, wp)
    wide = {"d": dw, "width": wp, "k6_odd_h": ho}
    for flip in (False, True):
        u, v, v_csr, u_csr = g.roles(flip)
        pu, pv = projw[:, :2 * dw], projw[:, 2 * dw:4 * dw]
        r = {}
        _, _, r["k3_max_abs_diff"] = check_k3(g, flip, pu, pv, b3w, e_inw,
                                              bnw, f"d={dw}")
        r["k6_max_abs_diff"] = check_k6(g, flip, puv_w, be_w, f"H={dw}")
        r["k6_odd_max_abs_diff"] = check_k6(g, flip, puv_o, be_o,
                                            f"H={ho} one-float")
        r["k7_max_abs_diff"], _ = check_k7(g, flip, pu[:, :dw], pv[:, :dw],
                                           b3w, f"d={dw}")
        r["k8_max_abs_diff"], _ = check_k8(
            g, flip, (d_suw, d_svw, pu, pv, b3w, e_inw, d_e_outw, bnw),
            f"d={dw}")
        r["k2_max_abs_diff"] = check_sum_kernel(
            "K2", K.k2_aggregate(u, v, v_csr, u_csr, pay_u, pay_v),
            K.k2_aggregate_plain(u, v, pay_u, pay_v, N),
            K.k2_aggregate(u, v, v_csr, u_csr, pay_u, pay_v),
            f"Dp={wp} flip={flip}")
        r["k9_max_abs_diff"] = check_sum_kernel(
            "K9", K.k9_aggregate(u, v, v_csr, u_csr, pay_u),
            K.k9_aggregate_plain(u, v, pay_u, N),
            K.k9_aggregate(u, v, v_csr, u_csr, pay_u), f"H={wp} flip={flip}")
        wide[f"flip={flip}"] = r
    wide["bitwise_reproducible"] = True
    out["wide"] = wide
    emit("kernels", graph={"nodes": N, "edges": E}, d=d, H=H, seed=seed,
         **out)
    return out


def card_vs_cpu_forward(graph, new_model, dev, per_forward: dict,
                        what: str):
    """Scores ``graph`` with ``new_model(device)`` on the CPU and on the
    card: two card forwards bitwise equal, each launching the kernels of
    ``per_forward`` that often and no other; finite logits within
    LOGIT_ATOL + LOGIT_RTOL·|x| of the CPU run.  Returns (card logits, CPU
    logits, a summary with the forward time and peak memory)."""
    import numpy as np
    import torch

    from gnnome_tpu_torch.models import edge_features, node_features
    from gnnome_tpu_torch.ops import DeviceGraph
    from gnnome_tpu_torch.ops import kernels as K

    x_np, e_np = node_features(graph), edge_features(graph)

    def setup(device):
        return (new_model(device), DeviceGraph.from_graph(graph, device),
                torch.as_tensor(x_np, device=device),
                torch.as_tensor(e_np, device=device))

    with torch.inference_mode():
        m_cpu, g_cpu, x_cpu, e_cpu = setup("cpu")
        t0 = time.perf_counter()
        lo_cpu = m_cpu(g_cpu, x_cpu, e_cpu).reshape(-1).numpy()
        cpu_s = time.perf_counter() - t0

        model, g, x, e = setup(dev)
        model(g, x, e)                                      # warm-up
        K.reset_launch_counts()
        runs = [model(g, x, e).reshape(-1) for _ in range(2)]
        torch.cuda.synchronize()
        counts = K.launch_counts()
        check(counts == expected_launches(**{k: 2 * n for k, n
                                             in per_forward.items()}),
              f"{what}: per-forward launches (2 forwards): {counts}")
        check(torch.equal(runs[0], runs[1]),
              f"{what}: two card runs bitwise equal")
        torch.cuda.reset_peak_memory_stats(dev)
        fwd_ms = cuda_ms(lambda: model(g, x, e), reps=5, n=5)
        peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    lo = runs[0].cpu().numpy()
    check(bool(np.isfinite(lo).all()) and lo.shape == (graph.num_edges,),
          f"{what}: finite logits of shape [E]")
    dlo = np.abs(lo - lo_cpu)
    check(bool((dlo <= LOGIT_ATOL + LOGIT_RTOL * np.abs(lo_cpu)).all()),
          f"{what}: logits vs CPU run (max {dlo.max()})")
    return lo, lo_cpu, {
        "launches_per_forward": {k: n // 2 for k, n in counts.items()},
        "bitwise_reproducible": True,
        "max_abs_logit_diff_vs_cpu": float(dlo.max()),
        "logit_range": [float(lo.min()), float(lo.max())],
        "forward_ms": fwd_ms, "max_memory_allocated_mb": peak_mb,
        "cpu_forward_s": cpu_s}


def phase_model(dev):
    """Golden graph, shipped weights: card vs the port's CPU run."""
    import numpy as np

    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.infer import load_model
    from gnnome_tpu_torch.models import load_model_weights

    graph = AssemblyGraph.load(GOLDEN)
    params, state = load_model_weights(WEIGHTS)
    lo, lo_cpu, fwd = card_vs_cpu_forward(
        graph, lambda device: load_model(params, state, Config(), device),
        dev, {"k3_edge_stage": 8, "k6_score_gate": 1}, "batch norm")
    sig = lambda a: 1.0 / (1.0 + np.exp(-a.astype(np.float64)))  # noqa: E731
    p, p_cpu = sig(lo), sig(lo_cpu)
    dp = float(np.abs(p - p_cpu).max())
    check(dp <= PROB_ATOL, f"probabilities vs CPU run (max {dp})")
    ap = average_precision(p, graph.y)
    check(abs(ap - JAX_GOLDEN_AP) < AP_TOL, f"AP {ap} vs {JAX_GOLDEN_AP}")
    emit("model", graph={"nodes": graph.num_nodes, "edges": graph.num_edges},
         weights=os.path.relpath(WEIGHTS, ROOT), **fwd,
         max_abs_prob_diff_vs_cpu=dp, average_precision=ap,
         ap_delta_vs_jax=ap - JAX_GOLDEN_AP,
         tolerance={"logit_atol": LOGIT_ATOL, "logit_rtol": LOGIT_RTOL,
                    "prob_atol": PROB_ATOL, "ap": AP_TOL})
    return fwd["launches_per_forward"]


def phase_model_unfused(dev):
    """Golden graph, the layer-norm and the norm-free model at full width
    and depth with seeded init weights: card vs the port's CPU run."""
    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.models import SymGatedGCN

    graph = AssemblyGraph.load(GOLDEN)
    out = {}
    for norm in ("layer", "none"):
        cfg = Config()
        cfg.model.normalization = norm

        def new_model(device):
            model = SymGatedGCN.from_config(cfg.model)
            return model.init_weights(UNFUSED_INIT_SEED).to(device)

        _, _, out[norm] = card_vs_cpu_forward(
            graph, new_model, dev, UNFUSED_FORWARD_LAUNCHES, norm)
    emit("model_unfused",
         graph={"nodes": graph.num_nodes, "edges": graph.num_edges},
         weights=f"init_weights({UNFUSED_INIT_SEED})",
         tolerance={"logit_atol": LOGIT_ATOL, "logit_rtol": LOGIT_RTOL},
         **out)


def phase_infer():
    """The main path: ``cli infer`` on the card, counters from 0."""
    from gnnome_tpu_torch import cli
    from gnnome_tpu_torch.ops import kernels as K
    from gnnome_tpu_torch.utils.fastx import read_fastx, reverse_complement

    shutil.rmtree(WORK, ignore_errors=True)
    t0 = time.perf_counter()
    ds, genome = make_infer_dataset(os.path.join(WORK, "ds"))
    build_s = time.perf_counter() - t0
    savedir = os.path.join(ds, "hifiasm")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    summary = cli.main(["infer", "--data", ds, "--asm", "hifiasm",
                        "--out", savedir, "--model", WEIGHTS,
                        "--set", f"decode.len_threshold={INFER_LEN_THRESHOLD}"])
    wall_s = time.perf_counter() - t0
    counts = K.launch_counts()
    check(summary["device"].startswith("cuda"), "infer ran on the card")
    check(counts == {**{k: 0 for k in K.KERNELS},
                     "k3_edge_stage": 8, "k6_score_gate": 1},
          f"eval-path launches {counts}")
    fasta = os.path.join(savedir, "assembly", "0_assembly.fasta")
    contigs = list(read_fastx(fasta))
    top = max(contigs, key=lambda c: len(c.seq))
    exact = top.seq in genome or top.seq in reverse_complement(genome)
    check(exact, "longest contig is an exact substring of the genome")
    check(len(top.seq) >= INFER_LEN_THRESHOLD, "longest contig length")
    emit("infer", dataset={k: v for k, v in INFER_GRAPH.items()},
         dataset_build_s=build_s, wall_s=wall_s, timing_s=summary["timing"],
         peak_rss_mb=summary["peak_rss_mb"], num_contigs=len(contigs),
         longest_contig=len(top.seq), exact_substring=exact,
         genome_len=len(genome), launches=counts)
    return counts


def _step_result(model, loss, logits):
    return {"loss": loss.detach().clone(), "logits": logits.detach().clone(),
            "grads": {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()},
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "buffers": {n: b.detach().clone()
                        for n, b in model.named_buffers()}}


def phase_train_step(dev, normalization: str = "batch"):
    """Full-width training steps, from the shipped weights (batch norm) or
    seeded init weights (layer norm): card vs CPU on the golden subgraph;
    bitwise reproducibility, launches, time and memory on the whole golden
    graph."""
    import numpy as np
    import torch

    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.infer import load_model
    from gnnome_tpu_torch.models import SymGatedGCN, load_model_weights
    from gnnome_tpu_torch.ops import kernels as K
    from gnnome_tpu_torch.train.step import (host_units, make_example,
                                             make_optimizer, train_step)

    golden = AssemblyGraph.load(GOLDEN)
    if normalization == "batch":
        params, state = load_model_weights(WEIGHTS)
        weights = os.path.relpath(WEIGHTS, ROOT)
        want = expected_launches(**TRAIN_STEP_LAUNCHES)

        def new_model(cfg, device):
            return load_model(params, state, cfg, device)
    else:
        weights = f"init_weights({UNFUSED_INIT_SEED})"
        want = expected_launches(**UNFUSED_STEP_LAUNCHES)

        def new_model(cfg, device):
            model = SymGatedGCN.from_config(cfg.model)
            return model.init_weights(UNFUSED_INIT_SEED).to(device)

    def one_step(graph, cfg, device, seed):
        (unit,) = host_units(graph, cfg, np.random.default_rng(0))
        ex = make_example(unit.in_deg, unit.out_deg, unit.e_feat, unit.y,
                          unit.src, unit.dst, unit.n_nodes, device)
        model = new_model(cfg, device)
        opt = make_optimizer(model, cfg.train.lr)
        gen = torch.Generator(device=device).manual_seed(seed)
        loss, logits = train_step(model, opt, ex, 4.0, cfg, gen)
        return _step_result(model, loss, logits), (model, opt, ex, gen)

    cfg = Config()
    cfg.model.normalization = normalization
    cfg.train.masking = False
    cfg.train.num_nodes_per_cluster = 10 ** 9         # one unit per graph
    cfg.model.dropout = 0.0                            # card vs CPU
    sub = golden_subgraph(golden)
    t0 = time.perf_counter()
    ref, _ = one_step(sub, cfg, torch.device("cpu"), 0)
    cpu_s = time.perf_counter() - t0
    got, _ = one_step(sub, cfg, dev, 0)
    loss_c, loss_g = float(ref["loss"]), float(got["loss"])
    check(abs(loss_g - loss_c) <= STEP_LOSS_RTOL * abs(loss_c),
          f"step loss card {loss_g} vs CPU {loss_c}")
    grad_diff, grad_max, bad = {}, {}, []
    for name, r in ref["grads"].items():
        delta = (got["grads"][name].cpu() - r).abs()
        grad_diff[name] = float(delta.max())
        grad_max[name] = float(r.abs().max())
        if not bool((delta <= STEP_GRAD_ATOL + STEP_GRAD_RTOL * r.abs()).all()):
            bad.append(name)
    worst = max(grad_diff, key=grad_diff.get)
    for name, r in ref["buffers"].items():
        b_ = got["buffers"][name].cpu()
        if r.dtype.is_floating_point:
            ok = bool(((b_ - r).abs() <= STEP_STATE_ATOL
                       + STEP_STATE_RTOL * r.abs()).all())
        else:
            ok = torch.equal(b_, r)
        check(ok, f"BN state {name} card vs CPU")
    check(not bad, f"gradients card vs CPU outside tolerance: {bad} "
                   f"{[(grad_diff[n], grad_max[n]) for n in bad]}")

    # the whole golden graph as one unit, default dropout 0.2
    cfg.model.dropout = 0.2
    K.reset_launch_counts()
    a, (model, opt, ex, gen) = one_step(golden, cfg, dev, 5)
    per_step = K.launch_counts()
    b, _ = one_step(golden, cfg, dev, 5)
    check(per_step == want, f"launches per step {per_step}")
    for key in ("loss", "logits"):
        check(torch.equal(a[key], b[key]), f"two card steps: {key} bitwise")
    for key in ("grads", "params", "buffers"):
        check(all(torch.equal(a[key][n], b[key][n]) for n in a[key]),
              f"two card steps: {key} bitwise")
    check(bool(torch.isfinite(a["logits"]).all())
          and a["logits"].shape == (golden.num_edges,),
          "finite logits of shape [E]")
    # the step never waits for the device: an operation that would
    # synchronise with the host raises in this mode
    torch.cuda.set_sync_debug_mode("error")
    try:
        train_step(model, opt, ex, 4.0, cfg, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = cuda_ms(lambda: train_step(model, opt, ex, 4.0, cfg, gen),
                      reps=5, n=3, warmup=2)
    emit("train_step" if normalization == "batch"
         else f"train_step_{normalization}", weights=weights,
         subgraph={"nodes": sub.num_nodes, "edges": sub.num_edges},
         loss_card=loss_g, loss_cpu=loss_c, cpu_step_s=cpu_s,
         max_grad_diff={"tensor": worst, "abs": grad_diff[worst],
                        "tensor_max_abs": grad_max[worst]},
         max_grad_diff_by_tensor=grad_diff,
         graph={"nodes": golden.num_nodes, "edges": golden.num_edges},
         launches_per_step=per_step, bitwise_reproducible=True,
         host_synchronisations_in_step=0,
         step_ms=step_ms,
         max_memory_allocated_mb=torch.cuda.max_memory_allocated(dev) / 2**20,
         tolerance={"loss_rtol": STEP_LOSS_RTOL,
                    "grad_atol": STEP_GRAD_ATOL, "grad_rtol": STEP_GRAD_RTOL,
                    "state_atol": STEP_STATE_ATOL,
                    "state_rtol": STEP_STATE_RTOL})
    return per_step


def phase_train():
    """The training path: ``cli train`` on the card, counters from 0."""
    import numpy as np

    from gnnome_tpu_torch import cli
    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.ops import kernels as K

    root = os.path.join(WORK, "train")
    shutil.rmtree(root, ignore_errors=True)
    golden = AssemblyGraph.load(GOLDEN)
    ds = write_dataset(os.path.join(root, "golden"), golden)
    paths = ["--set", f"paths.checkpoints_path={root}/ckpt",
             "--set", f"paths.models_path={root}/models"]
    common = ["train", "--train", ds, "--valid", ds, "--asm", "hifiasm",
              "--name", "golden", *paths]

    def log_of(name):
        with open(os.path.join(root, "ckpt", f"log_{name}_seed1.jsonl")) as f:
            return [json.loads(line) for line in f]

    K.reset_launch_counts()
    t0 = time.perf_counter()
    model_path = cli.main([*common, "--set", "train.num_epochs=1"])
    wall_s = time.perf_counter() - t0
    counts = K.launch_counts()
    # U training units (16 K7, 16 K3, 16 K8, 2 K6, 2 K9 each) and V
    # validation units (16 K3, 2 K6 each)
    units = counts["k9_aggregate"] // 2
    check(units > 1 and counts["k7_gate_stats"] == 16 * units
          and counts["k8_train_layer_bwd"] == 16 * units,
          f"training launches {counts}")
    v_units = (counts["k3_edge_stage"] - 16 * units) // 16
    check(v_units > 1 and counts["k3_edge_stage"] == 16 * (units + v_units)
          and counts["k6_score_gate"] == 2 * (units + v_units),
          f"validation launches {counts}")
    log = log_of("golden")
    check([r["epoch"] for r in log] == [0], "one epoch logged")
    check(all(np.isfinite(log[0][k]) for k in ("train/loss", "valid/loss")),
          "finite losses")
    check(os.path.isfile(model_path), "best model saved")

    ckpt = os.path.join(root, "ckpt")
    resumed = []
    for i in range(2):
        cli.main([*common, "--resume", "--set", "train.num_epochs=2"])
        dst = os.path.join(ckpt, f"resumed_{i}.npz")
        os.replace(os.path.join(ckpt, "ckpt_golden_seed1_resumed-2.npz"), dst)
        resumed.append(dst)
    with np.load(resumed[0]) as a, np.load(resumed[1]) as b:
        same = a.files == b.files and all(np.array_equal(a[k], b[k])
                                          for k in a.files)
        n_arrays = len(a.files)
    check(same, "two resumes from one checkpoint bitwise equal")

    _, overfit, _ = overfit_run(root)
    emit("train", graph={"nodes": golden.num_nodes,
                         "edges": golden.num_edges},
         epoch_wall_s=wall_s, units={"train": units, "valid": v_units},
         launches=counts, log=log[0], resume_checkpoint_arrays=n_arrays,
         resume_bitwise_identical=True, overfit=overfit,
         tolerance={"loss_drop": OVERFIT_LOSS_DROP, "min_ap": OVERFIT_MIN_AP})
    return counts


def overfit_run(root: str, normalization: str = "batch"):
    """``cli train --overfit`` on the small synthetic dataset (12 epochs, lr
    1e-3) under ``root``, which must learn: the last loss under
    OVERFIT_LOSS_DROP times the first, the saved model's AP above
    OVERFIT_MIN_AP.  Returns (best-model path, summary, the launch counts
    read just after ``cli train``)."""
    from gnnome_tpu_torch import cli
    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.graphs import synthetic_assembly_graph
    from gnnome_tpu_torch.infer import score_graph
    from gnnome_tpu_torch.models import load_model_weights
    from gnnome_tpu_torch.ops import kernels as K
    from gnnome_tpu_torch.train.metrics import get_aps

    g, reads, _, _ = synthetic_assembly_graph(**OVERFIT_GRAPH)
    small = write_dataset(os.path.join(root, "small"), g, reads)
    name = "overfit" if normalization == "batch" else f"overfit_{normalization}"
    t0 = time.perf_counter()
    best = cli.main(["train", "--train", small, "--valid", small, "--asm",
                     "hifiasm", "--name", name, "--overfit",
                     "--set", f"paths.checkpoints_path={root}/ckpt",
                     "--set", f"paths.models_path={root}/models",
                     "--set", "train.num_epochs=12", "--set", "train.lr=1e-3",
                     "--set", "train.masking=false",
                     "--set", "train.num_nodes_per_cluster=10000",
                     "--set", f"model.normalization={normalization}"])
    counts = K.launch_counts()
    wall_s = time.perf_counter() - t0
    with open(os.path.join(root, "ckpt", f"log_{name}_seed1.jsonl")) as f:
        losses = [json.loads(line)["train/loss"] for line in f]
    check(losses[-1] < OVERFIT_LOSS_DROP * losses[0],
          f"{name} loss {losses[0]} -> {losses[-1]}")
    cfg = Config()
    cfg.model.normalization = normalization
    ap = get_aps(score_graph(g, *load_model_weights(best), cfg), g.y)
    check(ap > OVERFIT_MIN_AP, f"{name} AP {ap}")
    return best, {"graph": dict(OVERFIT_GRAPH), "nodes": g.num_nodes,
                  "edges": g.num_edges, "losses": losses, "ap": ap,
                  "wall_s": wall_s}, counts


def phase_cli_layer():
    """The layer-norm model's paths: ``cli train`` (overfit run) and ``cli
    infer`` with the model it saved, on the card, counters from 0 before
    each."""
    from gnnome_tpu_torch import cli
    from gnnome_tpu_torch.ops import kernels as K
    from gnnome_tpu_torch.utils.fastx import read_fastx, reverse_complement

    root = os.path.join(WORK, "layer")
    shutil.rmtree(root, ignore_errors=True)
    K.reset_launch_counts()
    best, overfit, train_counts = overfit_run(root, "layer")
    # 12 epochs of one unit, no validation (--overfit)
    check(train_counts == expected_launches(**{
        k: 12 * n for k, n in UNFUSED_STEP_LAUNCHES.items()}),
        f"layer-norm training launches {train_counts}")

    ds, genome = make_infer_dataset(os.path.join(root, "ds"))
    savedir = os.path.join(ds, "hifiasm")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    summary = cli.main(["infer", "--data", ds, "--asm", "hifiasm",
                        "--out", savedir, "--model", best,
                        "--set", f"decode.len_threshold={INFER_LEN_THRESHOLD}",
                        "--set", "model.normalization=layer"])
    wall_s = time.perf_counter() - t0
    infer_counts = K.launch_counts()
    check(summary["device"].startswith("cuda"), "infer ran on the card")
    check(infer_counts == expected_launches(**UNFUSED_FORWARD_LAUNCHES),
          f"layer-norm eval-path launches {infer_counts}")
    contigs = list(read_fastx(os.path.join(savedir, "assembly",
                                           "0_assembly.fasta")))
    top = max(contigs, key=lambda c: len(c.seq))
    exact = top.seq in genome or top.seq in reverse_complement(genome)
    check(exact, "layer norm: longest contig is an exact substring")
    check(len(top.seq) >= INFER_LEN_THRESHOLD, "longest contig length")
    emit("cli_layer", overfit=overfit, train_launches=train_counts,
         infer={"wall_s": wall_s, "timing_s": summary["timing"],
                "num_contigs": len(contigs), "longest_contig": len(top.seq),
                "exact_substring": exact, "genome_len": len(genome),
                "launches": infer_counts},
         tolerance={"loss_drop": OVERFIT_LOSS_DROP, "min_ap": OVERFIT_MIN_AP})
    return train_counts, infer_counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    for path in (GOLDEN, WEIGHTS):
        check(os.path.isfile(path), f"{path} present (run from a checkout)")
    from gnnome_tpu_torch.config import resolve_device

    dev = resolve_device("cuda")
    phase_env()
    per_forward = phase_model(dev)
    phase_model_unfused(dev)
    k = phase_kernels(args.seed, dev, per_forward)
    paths = {"infer": phase_infer()}
    phase_train_step(dev)
    phase_train_step(dev, "layer")
    paths["train"] = phase_train()
    paths["train_layer"], paths["infer_layer"] = phase_cli_layer()

    def row(name, src, replaces, main_path, timing=None):
        r = timing or k[name]
        flip0 = r["flip=False"]
        return {"name": name, "route": "cuda",
                "source": f"gnnome_tpu_torch/csrc/{src}",
                "replaces": f"gnnome_tpu/ops/pallas_kernels.py:{replaces}",
                "launches": paths[main_path][name],
                "launches_by_path": {p: c[name] for p, c in paths.items()},
                "max_abs_err": max(r[f]["max_abs_diff"]
                                   for f in ("flip=False", "flip=True")),
                "ms": flip0["device_ms"], "call_ms": flip0["kernel_ms"],
                "plain_ms": flip0["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": flip0.get("library_ms")}

    # K2 at the gated mean's width Dp = 128; its error over both widths
    k2 = row("k2_aggregate", "k2_aggregate.cu", 263, "train_layer",
             k["k2_aggregate"]["Dp=128"])
    k2["max_abs_err"] = max(
        k["k2_aggregate"][w][f]["max_abs_diff"]
        for w in ("Dp=128", "Dp=64") for f in ("flip=False", "flip=True"))
    print(json.dumps({"kernels": [
        row("k1_gather_gate", "k1_gather_gate.cu", 207, "train_layer"),
        k2,
        row("k3_edge_stage", "k3_edge_stage.cu", 355, "train"),
        row("k6_score_gate", "k6_score_gate.cu", 709, "train"),
        row("k7_gate_stats", "k7_gate_stats.cu", 457, "train"),
        row("k8_train_layer_bwd", "k8_train_layer_bwd.cu", 604, "train"),
        row("k9_aggregate", "k9_aggregate.cu", 771, "train"),
    ]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
