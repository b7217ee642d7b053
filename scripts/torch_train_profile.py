#!/usr/bin/env python
"""Where the time of one gnnome_tpu_torch training step goes, on a GPU.

    python scripts/torch_train_profile.py [--iters 5] [--out DIR]
        [--normalization batch|layer|none] [--dtype float32|bfloat16]

Runs symmetry-loss train steps (batch norm: both passes as one dual-width
pass; layer norm, none: two passes; backward, Adam) of the
full-width SymGatedGCN (d=64, 8 layers, dropout 0.2), started from
weights/weights.npz (batch norm, the default) or seeded init weights
(``init_weights(7)``: layer norm, none), on the E. coli-scale golden graph
(tests/fixtures/golden_ecoli_v1.npz) as one unit (no masking, no
clustering), at compute dtype ``--dtype`` (every normalisation),
under ``torch.profiler``, and prints one JSON line: the step's
wall time (host clock around synchronised steps, unprofiled), the device
busy time per kernel name summed over the profiled steps, the device
launches per step, the share of the
unprofiled step the device sat idle (and of the profiled one, which the
profiler's host overhead stretches), the peak device memory, and the card
(``nvidia-smi`` name and power limit).  With ``--out`` it also writes the Chrome trace there.
Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=None, help="directory for trace.json")
    ap.add_argument("--normalization", default="batch",
                    choices=("batch", "layer", "none"))
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from gnnome_tpu_torch.config import Config, resolve_device
    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.infer import load_model
    from gnnome_tpu_torch.models import SymGatedGCN, load_model_weights
    from gnnome_tpu_torch.train.step import (host_units, make_example,
                                             make_optimizer, train_step)
    from gnnome_tpu_torch.utils.timing import trace_only

    dev = resolve_device("cuda")
    graph = AssemblyGraph.load(os.path.join(ROOT, "tests", "fixtures",
                                            "golden_ecoli_v1.npz"))
    cfg = Config()
    cfg.model.normalization = args.normalization
    cfg.compute.dtype = args.dtype
    cfg.train.masking = False
    cfg.train.num_nodes_per_cluster = 10 ** 9        # the graph is one unit
    (unit,) = host_units(graph, cfg, np.random.default_rng(0))
    ex = make_example(unit.in_deg, unit.out_deg, unit.e_feat, unit.y,
                      unit.src, unit.dst, unit.n_nodes, dev)
    if args.normalization == "batch":
        params, state = load_model_weights(os.path.join(ROOT, "weights",
                                                        "weights.npz"))
        model = load_model(params, state, cfg, dev)
    else:
        model = SymGatedGCN.from_config(cfg.model).init_weights(7).to(dev)
    opt = make_optimizer(model, cfg.train.lr)
    gen = torch.Generator(device=dev).manual_seed(0)

    def step():
        return train_step(model, opt, ex, 4.0, cfg, gen)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    walls = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, trace_only():
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0

    kernels = {}
    busy_us = 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        # user-annotated ranges (``Optimizer.step#Adam.step``) span kernels
        # that are counted on their own
        if (dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            kernels[ev.key] = {"us_per_step": dev_us / args.iters,
                               "calls_per_step": ev.count / args.iters}
            busy_us += dev_us
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
    walls.sort()
    step_ms = walls[len(walls) // 2] * 1e3
    busy_ms = busy_us / args.iters / 1e3
    prof_ms = prof_wall / args.iters * 1e3
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({
        "card": card, "normalization": args.normalization,
        "dtype": args.dtype,
        "graph": {"nodes": graph.num_nodes, "edges": graph.num_edges},
        "step_ms_median": step_ms,
        "profiled_step_ms": prof_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / step_ms),
        "device_idle_share_profiled": max(0.0, 1.0 - busy_ms / prof_ms),
        "max_memory_allocated_mb": peak_mb,
        "device_launches_per_step": sum(k["calls_per_step"]
                                        for k in kernels.values()),
        "kernels": dict(sorted(kernels.items(),
                               key=lambda kv: -kv[1]["us_per_step"])),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
