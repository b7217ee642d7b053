#!/usr/bin/env python
"""Profile the port's greedy decoder (``gnnome_tpu_torch.decode``) at
chromosome scale: the counterpart of ``scripts/decode_profile.py``, which
times the JAX package's decoder.

Builds an assembly-shaped graph with ``random_rc_bench_graph`` (degrees and
scale are what decode cost depends on), draws edge logits from
``N(1, 2)`` (seed 1), and times one full ``decode_greedy`` run on the host
(``--profile``: under cProfile, the 25 costliest functions).  Host only: no
GPU is used.  Prints one line and, with ``--out``, writes it as JSON.

    python scripts/torch_decode_profile.py [--nodes N] [--degree D]
        [--paths K] [--profile] [--out FILE]
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import platform
import pstats
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gnnome_tpu_torch.config import DecodeConfig  # noqa: E402
from gnnome_tpu_torch.decode.greedy import decode_greedy  # noqa: E402
from gnnome_tpu_torch.graphs.synthetic import (  # noqa: E402
    random_rc_bench_graph as build)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=524_288)
    ap.add_argument("--degree", type=float, default=6.0)
    ap.add_argument("--paths", type=int, default=100)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from gnnome_tpu_torch.native import have_native

    t0 = time.perf_counter()
    g = build(args.nodes, args.degree)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    scores = rng.normal(1.0, 2.0, g.num_edges).astype(np.float32)
    cfg = DecodeConfig(num_decoding_paths=args.paths, len_threshold=0)

    t0 = time.perf_counter()
    if args.profile:
        pr = cProfile.Profile()
        pr.enable()
    res = decode_greedy(g, scores, cfg)
    if args.profile:
        pr.disable()
    dt = time.perf_counter() - t0
    out = {"nodes": g.num_nodes, "edges": g.num_edges, "paths": args.paths,
           "graph_build_s": build_s, "decode_s": dt,
           "contigs": len(res.walks), "visited": int(res.visited.sum()),
           "native": have_native(), "host_cpus": os.cpu_count(),
           "host": platform.processor() or platform.machine()}
    print(f"decode: {dt:.2f}s  contigs={len(res.walks)}  "
          f"visited={out['visited']}/{g.num_nodes}", flush=True)
    print(json.dumps(out), flush=True)
    if args.profile:
        s = io.StringIO()
        pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(25)
        print(s.getvalue())
    if args.out:
        from gnnome_tpu_torch.utils.record import write_json
        write_json(args.out, out)
    return out


if __name__ == "__main__":
    main()
