#!/usr/bin/env python
"""Where the time of one gnnome_tpu_torch eval forward goes, on a GPU.

    python scripts/torch_eval_profile.py [--iters 10] [--out DIR]
        [--normalization batch|layer|none] [--dtype float32|bfloat16]

Scores the E. coli-scale golden graph (tests/fixtures/golden_ecoli_v1.npz)
with weights/weights.npz (batch norm, the default) or seeded init weights
(``init_weights(7)``: layer norm, none) at compute dtype ``--dtype``
(every normalisation) on the card under ``torch.profiler``
and prints one JSON line: the forward's wall time (host clock around
synchronised runs),
the device busy time per kernel name summed over the profiled forwards, the
share of the forward the device sat idle, and the card (``nvidia-smi`` name
and power limit).  With ``--out`` it also writes the Chrome trace there.
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
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None, help="directory for trace.json")
    ap.add_argument("--normalization", default="batch",
                    choices=("batch", "layer", "none"))
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from gnnome_tpu_torch.config import Config, compute_dtype, resolve_device
    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.infer import load_model
    from gnnome_tpu_torch.models import (SymGatedGCN, edge_features,
                                         load_model_weights, node_features)
    from gnnome_tpu_torch.ops import DeviceGraph

    dev = resolve_device("cuda")
    graph = AssemblyGraph.load(os.path.join(ROOT, "tests", "fixtures",
                                            "golden_ecoli_v1.npz"))
    cfg = Config()
    cfg.model.normalization = args.normalization
    cfg.compute.dtype = args.dtype
    dtype = compute_dtype(cfg)
    if args.normalization == "batch":
        params, state = load_model_weights(os.path.join(ROOT, "weights",
                                                        "weights.npz"))
        model = load_model(params, state, cfg, dev)
    else:
        model = SymGatedGCN.from_config(cfg.model).init_weights(7).to(dev)
    g = DeviceGraph.from_graph(graph, dev)
    x = torch.as_tensor(node_features(graph), device=dev)
    e = torch.as_tensor(edge_features(graph), device=dev)

    with torch.inference_mode():
        for _ in range(3):
            model(g, x, e, dtype=dtype)
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            model(g, x, e, dtype=dtype)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                model(g, x, e, dtype=dtype)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0

    kernels = {}
    busy_us = 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = {"us_per_forward": dev_us / args.iters,
                               "calls_per_forward": ev.count / args.iters}
            busy_us += dev_us
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
    walls.sort()
    fwd_us = prof_wall / args.iters * 1e6
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({
        "card": card, "normalization": args.normalization,
        "dtype": args.dtype,
        "graph": {"nodes": graph.num_nodes, "edges": graph.num_edges},
        "forward_ms_median": walls[len(walls) // 2] * 1e3,
        "profiled_forward_ms": fwd_us / 1e3,
        "device_busy_ms_per_forward": busy_us / args.iters / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_us / args.iters / fwd_us),
        "kernels": dict(sorted(kernels.items(),
                               key=lambda kv: -kv[1]["us_per_forward"])),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
