#!/usr/bin/env python
"""Projected scaling of gnnome_tpu_torch's halo path over P GPUs for the
five configurations of scripts/scaling_projection.py, from the port's own
schedule (``gnnome_tpu_torch/parallel/projection.py``).  A model, not a
measurement: every output line and the JSON say so.

For each configuration it builds the graph (``random_bench_graph`` at the
configuration's size, degree and locality) and the real halo plan at each
rank count (``plan_graph``: K, R, route), counts the wire bytes and calls
of a forward (eval) or a train step exactly, and projects

    t_P = t_1 / P + wire / link rate + calls x latency.

* t_1, the single-device time of the same forward or step on the same
  graph, is measured on ``--device`` (CUDA events on the card, after one
  warm-up, median of ``REPS``), or given per configuration with
  ``--eval-ms NAME=MS`` / ``--train-ms NAME=MS``.  The single-device step
  runs the symmetry loss as one dual-width pass; the halo step runs two
  directional passes, so t_1 / P understates the ranks' compute.  A
  configuration that does not fit the card is reported, not projected.
* Link rates: NVLink 4 within a host (450 GB/s each way), NDR InfiniBand
  where the ring crosses hosts (50 GB/s each way per GPU), the data-sheet
  figures of ``projection.LINKS``; the configuration over two or more
  hosts is projected at InfiniBand's rate throughout (its slowest link
  paces every exchange).
* The latency per call has no default: ``--latency-ms MS`` (every call),
  or ``--measure-latency``: the medians of an idle ``all_reduce`` and ring
  exchange over two ranks on ``--device`` (``parallel/checks.py``
  ``collective_job``; on one card that is gloo between ranks sharing it,
  and the JSON says so).

    python scripts/torch_scaling_projection.py --measure-latency
    python scripts/torch_scaling_projection.py --latency-ms 0.02 \\
        --configs 1_ecoli_infer --eval-ms 1_ecoli_infer=3.1 --device cpu

The table goes to standard output and the JSON to ``--out`` (default:
standard output, the table then to standard error).  Nothing else is
written.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KIND = "projection (a model, not a measurement)"
REPS = 5

# scripts/scaling_projection.py:51-60, the five configurations:
# (name, nodes, degree, locality, mode, rank counts, link)
CONFIGS = [
    ("1_ecoli_infer", 9_600, 6.0, 64, "eval", (2, 4, 8), "nvlink4"),
    ("2_bacterial_train", 9_600, 6.0, 64, "train", (2, 4, 8), "nvlink4"),
    ("3_raven_ont_infer", 20_480, 8.0, 128, "eval", (2, 4, 8), "nvlink4"),
    ("4_human_chr_train_1host", 1_048_576, 6.0, 64, "train", (2, 4, 8),
     "nvlink4"),
    ("5_chm13_train_2hosts", 2_097_152, 6.0, 64, "train", (8, 16, 32),
     "ndr_ib"),
]
LINK_SOURCES = {
    "nvlink4": "NVLink 4, H100 SXM5 data sheet: 900 GB/s per GPU both "
               "ways, 450 GB/s each way",
    "ndr_ib": "NDR InfiniBand 400 Gb/s, one HCA per GPU (DGX H100): "
              "50 GB/s each way"}


def card() -> str:
    """``nvidia-smi``'s name and power limit of the cards, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"no nvidia-smi ({e})"


def parse_ms(items) -> dict:
    out = {}
    for item in items or ():
        name, _, ms = item.partition("=")
        out[name] = float(ms)
    return out


def measure_t1(unit, mode: str, device: str, reps: int) -> float:
    """Milliseconds of one single-device eval forward or train step of the
    default model (``init_weights(0)``, float32) on ``unit``."""
    import torch

    from gnnome_tpu_torch.config import Config, resolve_device
    from gnnome_tpu_torch.models.zoo import get_model
    from gnnome_tpu_torch.train.step import (make_example, make_optimizer,
                                             train_step)

    dev = resolve_device(device)
    cfg = Config()
    cfg.compute.device = device
    model = get_model(cfg.model).init_weights(0).to(dev)
    ex = make_example(unit.in_deg, unit.out_deg, unit.e_feat, unit.y,
                      unit.src, unit.dst, unit.n_nodes, dev)
    if mode == "eval":
        model.eval()

        def fn():
            with torch.inference_mode():
                model(ex.g, ex.x, ex.e, slot_io=True)
    else:
        opt = make_optimizer(model, cfg.train.lr)
        gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)

        def fn():
            train_step(model, opt, ex, 1.0, cfg, gen)
    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize(dev)
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def measure_latency(device: str, reps: int = 20) -> dict:
    """Seconds of an idle ``all_reduce`` and ring exchange of a [64]
    float32 row over two ranks on ``device`` (medians, host clock)."""
    from gnnome_tpu_torch.parallel.checks import collective_job
    from gnnome_tpu_torch.parallel.group import describe, spawn

    res = spawn(collective_job, 2, 64, reps, device=device, deadline_s=600)
    return {"p2p": max(r["exchange"]["host_ms"] for r in res) / 1e3,
            "collective": max(r["all_reduce"]["host_ms"] for r in res) / 1e3,
            "source": f"measured: {describe(device, 2)}, median of {reps}, "
                      "the slower rank"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    lat = ap.add_mutually_exclusive_group(required=True)
    lat.add_argument("--latency-ms", type=float)
    lat.add_argument("--measure-latency", action="store_true")
    ap.add_argument("--eval-ms", action="append", metavar="NAME=MS")
    ap.add_argument("--train-ms", action="append", metavar="NAME=MS")
    ap.add_argument("--configs", help="comma-separated names (default all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="-")
    args = ap.parse_args(argv)

    import torch

    from gnnome_tpu_torch.config import Config
    from gnnome_tpu_torch.graphs.synthetic import random_bench_graph
    from gnnome_tpu_torch.models.zoo import get_model
    from gnnome_tpu_torch.parallel.checks import bench_unit
    from gnnome_tpu_torch.parallel.projection import LINKS, project_curve

    given = {**parse_ms(args.eval_ms), **parse_ms(args.train_ms)}
    names = [c[0] for c in CONFIGS]
    chosen = args.configs.split(",") if args.configs else names
    unknown = sorted(set(chosen) - set(names)) + sorted(set(given) - set(names))
    if unknown:
        ap.error(f"unknown configuration(s) {unknown}; known: {names}")
    if args.measure_latency:
        latency = measure_latency(args.device)
    else:
        latency = {"p2p": args.latency_ms / 1e3,
                   "collective": args.latency_ms / 1e3,
                   "source": "given (--latency-ms)"}
    cfg = Config()
    model = get_model(cfg.model)
    d, L = cfg.model.dim_latent, cfg.model.num_gnn_layers
    n_params = sum(p.numel() for p in model.parameters())
    table = sys.stdout if args.out != "-" else sys.stderr
    result = {"kind": KIND, "card": card(), "torch": torch.__version__,
              "latency": latency,
              "links": {k: {"bytes_per_s": LINKS[k],
                            "source": LINK_SOURCES[k]} for k in LINKS},
              "model": {"d": d, "layers": L, "params": n_params,
                        "dtype": "float32"},
              "configs": {}}
    print(f"| kind | config | edges | P | K | R | route | t1/P ms | wire ms "
          f"| latency ms | t_P ms | efficiency |", file=table)
    print("|---|---|---|---|---|---|---|---|---|---|---|---|", file=table)
    for name, n, deg, loc, mode, counts, link in CONFIGS:
        if name not in chosen:
            continue
        src, dst = random_bench_graph(n, deg, seed=0, locality=loc)
        entry = {"n_nodes": n, "n_edges": int(src.shape[0]), "mode": mode,
                 "link": link}
        if name in given:
            t1_ms, entry["t1_source"] = given[name], "given"
        else:
            try:
                t1_ms = measure_t1(bench_unit(src, dst, n), mode,
                                   args.device, REPS)
                entry["t1_source"] = (f"measured on {args.device}: "
                                      f"{result['card']}")
            except torch.cuda.OutOfMemoryError as e:
                entry["t1_ms"] = None
                entry["skipped"] = f"the single-device {mode} does not fit " \
                                   f"the card ({str(e)[:200]})"
                result["configs"][name] = entry
                print(f"| {KIND} | {name} | not projected: "
                      f"{entry['skipped']} |", file=table)
                torch.cuda.empty_cache()
                continue
        entry["t1_ms"] = t1_ms
        points, skipped = project_curve(
            src, dst, n, t1_ms / 1e3, counts, mode, d, L, n_params,
            LINKS[link], latency, passes=2 if mode == "train" else 1)
        entry["curve"] = [p.as_dict() for p in points]
        entry["skipped_counts"] = skipped
        result["configs"][name] = entry
        for p in points:
            print(f"| {KIND} | {name} | {entry['n_edges']} | {p.P} | {p.K} "
                  f"| {p.R} | {p.route} | {p.t_compute_s * 1e3:.4f} "
                  f"| {p.t_wire_s * 1e3:.4f} | {p.t_latency_s * 1e3:.4f} "
                  f"| {p.t_step_s * 1e3:.4f} | {p.efficiency:.4f} |",
                  file=table, flush=True)
        for s in skipped:
            print(f"| {KIND} | {name} | P={s['P']} skipped: {s['reason']} |",
                  file=table)
    text = json.dumps(result, indent=1)
    if args.out == "-":
        print(text, flush=True)
    else:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
