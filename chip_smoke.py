#!/usr/bin/env python3
"""Smoke run of gnnome_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--seed N]

Builds the CUDA kernels (``build/libgnnome_kernels.so``) and the host
library (``build/libgnnome_host.so``) from the sources in the checkout, then
runs four phases, each printing one JSON line:

1. ``env``: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, compute capability, build seconds, the compiler's per-kernel
   register and spill report.
2. ``model``: the E. coli-scale golden graph
   (tests/fixtures/golden_ecoli_v1.npz: N=9,600, E=257,346) scored with
   ``weights/weights.npz`` (d=H=64, 8 layers) on the card; held against the
   port's own CPU run; two card runs bitwise equal; K3 launched 8 times and
   K6 once per forward; average precision against the graph's labels.
3. ``kernels``: K3 (both flips) and K6 (both flips) at the golden graph's
   shapes on its real CSR, inputs from ``--seed``; each kernel against its
   plain PyTorch version on the card, and timed (CUDA events around 10
   back-to-back calls, median of 10 such repeats, after warm-up) beside its
   least possible time, with the per-forward launches from phase 2.
4. ``infer``: a synthetic dataset written in the dataset layout, then
   ``gnnome_tpu_torch.cli infer`` on the card (the main path, with every
   launch counter set to 0 just before it); the longest contig must be an
   exact substring of the genome.

Then one JSON line with every kernel's numbers, the ``nvidia-smi`` line, and
the last line ``{"ok": true, "device": {...}}``.  Any failed phase raises and
the script exits non-zero; without a CUDA device it exits non-zero at once.
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

# the phase-4 dataset: an error-free 50 kb genome at ~7x; no false edges, so
# the decoded contig must be exact (with false edges the shipped weights
# follow planted chimeric edges)
INFER_GRAPH = dict(n_reads=400, genome_len=50_000, read_len=900, seed=1,
                   with_sequences=True, false_edge_frac=0.0)
INFER_LEN_THRESHOLD = 5000

# H100 SXM data sheet: HBM3 bandwidth and float32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

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


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


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
    for sub in ("processed", "info"):
        os.makedirs(os.path.join(root, "hifiasm", sub), exist_ok=True)
    g.save(os.path.join(root, "hifiasm", "processed", "0.npz"))
    reads.save(os.path.join(root, "hifiasm", "info", "0_reads.npz"))
    return root, genome


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


def cuda_ms(fn, reps: int = 10, n: int = 10, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn`` on the card: the median over ``reps``
    repeats of ``n`` back-to-back calls between two CUDA events.  Calls
    queue ahead of the device, so the host's per-call overhead hides
    behind the kernels whenever the device is the bottleneck."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


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


def phase_kernels(seed: int, dev, per_forward: dict):
    """Each kernel vs its plain version at the golden graph's shapes."""
    import torch

    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.ops import DeviceGraph
    from gnnome_tpu_torch.ops import kernels as K

    graph = AssemblyGraph.load(GOLDEN)
    g = DeviceGraph.from_graph(graph, dev)
    N, E, d, H = g.n_nodes, g.n_edges, 64, 64
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s):
        return torch.randn(*s, device=dev, generator=gen)

    proj = randn(N, 5 * d)                  # [B1|A2|B2|A3|A1], as the model
    proj_u, proj_v = proj[:, :2 * d], proj[:, 2 * d:4 * d]
    b3e, e_in = randn(E, d), randn(E, d)
    bn = torch.stack([randn(d) * 0.3,
                      torch.rand(d, device=dev, generator=gen) * 1.5 + 0.5,
                      torch.rand(d, device=dev, generator=gen) + 0.5,
                      randn(d) * 0.1])
    puv, be = randn(N, 2 * H), randn(E, H)
    f4, i4 = 4, 4
    out = {}

    k3 = {"launches_per_forward": per_forward["k3_edge_stage"]}
    for flip in (False, True):
        u, v, v_csr, u_csr = g.roles(flip)
        args = (u, v, v_csr, u_csr, proj_u, proj_v, b3e, e_in, bn)
        got = K.k3_edge_stage(*args)
        ref = K.k3_edge_stage_plain(u, v, proj_u, proj_v, b3e, e_in, bn)
        torch.cuda.synchronize()
        diff = [float((a - b).abs().max()) for a, b in zip(got, ref)]
        check(diff[0] <= EDGE_ATOL, f"K3 flip={flip} e_out diff {diff[0]}")
        for x, y in zip(got[1:], ref[1:]):
            ok = bool(((x - y).abs() <= SUM_ATOL + SUM_RTOL * y.abs()).all())
            check(ok, f"K3 flip={flip} node sums within tolerance")
        k3[f"flip={flip}"] = {
            "max_abs_diff": max(diff),
            "max_abs_diff_e_out": diff[0],
            "kernel_ms": cuda_ms(lambda: K.k3_edge_stage(*args)),
            "plain_ms": cuda_ms(lambda: K.k3_edge_stage_plain(
                u, v, proj_u, proj_v, b3e, e_in, bn))}
    # least time: read proj_u/proj_v (used columns), b3e, e_in, bn, u/v
    # indices, both row-pointer arrays and one slot permutation; write
    # e_out and both [N, 2d] sums.  ~20 flops per (edge, feature) over the
    # two passes (gate 2, BN 4, relu 1, residual 1, sigmoid ~3 twice,
    # gated products and sums 3 twice).
    k3_bytes = (f4 * (2 * N * 2 * d + 3 * E * d + 4 * d + 2 * N * 2 * d)
                + i4 * (3 * E + 2 * (N + 1)))
    k3_bound, k3_by = bound(k3_bytes, 20.0 * E * d)
    k3.update(bound_ms=k3_bound, bound_by=k3_by, bytes=k3_bytes,
              tolerance={"e_out_atol": EDGE_ATOL, "sums_atol": SUM_ATOL,
                         "sums_rtol": SUM_RTOL})
    out["k3_edge_stage"] = k3

    k6 = {"launches_per_forward": per_forward["k6_score_gate"]}
    for flip in (False, True):
        u, v, _, _ = g.roles(flip)
        got = K.k6_score_gate(u, v, puv, be)
        ref = K.k6_score_gate_plain(u, v, puv, be)
        torch.cuda.synchronize()
        diff = float((got - ref).abs().max())
        check(diff <= EDGE_ATOL, f"K6 flip={flip} diff {diff}")
        k6[f"flip={flip}"] = {
            "max_abs_diff": diff,
            "kernel_ms": cuda_ms(lambda: K.k6_score_gate(u, v, puv, be)),
            "plain_ms": cuda_ms(lambda: K.k6_score_gate_plain(u, v, puv,
                                                              be))}
    # read puv, be, u/v indices; write z; add, add, max per element
    k6_bytes = f4 * (N * 2 * H + 2 * E * H) + i4 * 2 * E
    k6_bound, k6_by = bound(k6_bytes, 3.0 * E * H)
    k6.update(bound_ms=k6_bound, bound_by=k6_by, bytes=k6_bytes,
              tolerance={"atol": EDGE_ATOL})
    out["k6_score_gate"] = k6
    emit("kernels", graph={"nodes": N, "edges": E}, d=d, H=H, seed=seed,
         library_call=None, **out)
    return out


def phase_model(dev):
    """Golden graph, shipped weights: card vs the port's CPU run."""
    import numpy as np
    import torch

    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.infer import load_model
    from gnnome_tpu_torch.models import (edge_features, load_model_weights,
                                         node_features)
    from gnnome_tpu_torch.ops import DeviceGraph
    from gnnome_tpu_torch.ops import kernels as K

    graph = AssemblyGraph.load(GOLDEN)
    cfg = Config()
    params, state = load_model_weights(WEIGHTS)
    x_np, e_np = node_features(graph), edge_features(graph)

    def setup(device):
        return (load_model(params, state, cfg, device),
                DeviceGraph.from_graph(graph, device),
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
        check(counts == {"k3_edge_stage": 16, "k6_score_gate": 2},
              f"per-forward launches (2 forwards): {counts}")
        check(torch.equal(runs[0], runs[1]), "two card runs bitwise equal")
        fwd_ms = cuda_ms(lambda: model(g, x, e), reps=5, n=5)
    lo = runs[0].cpu().numpy()
    check(bool(np.isfinite(lo).all()) and lo.shape == (graph.num_edges,),
          "finite logits of shape [E]")
    dlo = np.abs(lo - lo_cpu)
    check(bool((dlo <= LOGIT_ATOL + LOGIT_RTOL * np.abs(lo_cpu)).all()),
          f"logits vs CPU run (max {dlo.max()})")
    sig = lambda a: 1.0 / (1.0 + np.exp(-a.astype(np.float64)))  # noqa: E731
    p, p_cpu = sig(lo), sig(lo_cpu)
    dp = float(np.abs(p - p_cpu).max())
    check(dp <= PROB_ATOL, f"probabilities vs CPU run (max {dp})")
    ap = average_precision(p, graph.y)
    check(abs(ap - JAX_GOLDEN_AP) < AP_TOL, f"AP {ap} vs {JAX_GOLDEN_AP}")
    emit("model", graph={"nodes": graph.num_nodes, "edges": graph.num_edges},
         weights=os.path.relpath(WEIGHTS, ROOT),
         launches_per_forward={k: n // 2 for k, n in counts.items()},
         bitwise_reproducible=True, max_abs_logit_diff_vs_cpu=float(dlo.max()),
         max_abs_prob_diff_vs_cpu=dp, average_precision=ap,
         ap_delta_vs_jax=ap - JAX_GOLDEN_AP, logit_range=[float(lo.min()),
                                                          float(lo.max())],
         forward_ms=fwd_ms, cpu_forward_s=cpu_s,
         tolerance={"logit_atol": LOGIT_ATOL, "logit_rtol": LOGIT_RTOL,
                    "prob_atol": PROB_ATOL, "ap": AP_TOL})
    return {k: n // 2 for k, n in counts.items()}


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
    check(counts == {"k3_edge_stage": 8, "k6_score_gate": 1},
          f"main-path launches {counts}")
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
    k = phase_kernels(args.seed, dev, per_forward)
    launches = phase_infer()

    def row(name, src, replaces, r):
        flip0 = r["flip=False"]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(r[f]["max_abs_diff"]
                                   for f in ("flip=False", "flip=True")),
                "ms": flip0["kernel_ms"], "plain_ms": flip0["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None}

    print(json.dumps({"kernels": [
        row("k3_edge_stage", "gnnome_tpu_torch/csrc/k3_edge_stage.cu",
            "gnnome_tpu/ops/pallas_kernels.py:355", k["k3_edge_stage"]),
        row("k6_score_gate", "gnnome_tpu_torch/csrc/k6_score_gate.cu",
            "gnnome_tpu/ops/pallas_kernels.py:709", k["k6_score_gate"]),
    ]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
