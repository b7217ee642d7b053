#!/usr/bin/env python
"""Sanitizer stress of the port's C++ host library
(``gnnome_tpu_torch/csrc/host/gnnome_native.cpp`` through
``gnnome_tpu_torch/native.py``): the counterpart of
``scripts/native_sanitize_stress.py``.

Drives every entry-point family (the threaded similarity batch, the
ground-truth label sweep, greedy decode with its checkpoint and resume
path, a degenerate graph, edit-distance edge cases) without importing
torch or JAX, so the run works under AddressSanitizer, UBSan and TSan
(their runtimes trip over the frameworks' own libraries).

    python scripts/torch_native_sanitize_stress.py
        the library as ``native.py`` builds it (``build/libgnnome_host.so``)
    python scripts/torch_native_sanitize_stress.py --sanitize address
        (or ``undefined``, ``thread``): builds the library with
        ``g++ -O1 -g -fsanitize=<kind> -fno-omit-frame-pointer`` into
        ``build/sanitize/libgnnome_host_<kind>.so`` (never into ``native/``
        and never over ``build/libgnnome_host.so``), then reruns this
        script with that library and the sanitizer runtime preloaded
        (``LD_PRELOAD=$(g++ -print-file-name=lib<asan|ubsan|tsan>.so)``,
        ``ASAN_OPTIONS=detect_leaks=0:halt_on_error=1``,
        ``UBSAN_OPTIONS=halt_on_error=1:print_stacktrace=1``).
    python scripts/torch_native_sanitize_stress.py --lib PATH
        the stress on a library built elsewhere (``PATH`` loaded as is).

Prints ``ALL OK`` and exits 0 when every check passes.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SRC = os.path.join(ROOT, "gnnome_tpu_torch", "csrc", "host",
                   "gnnome_native.cpp")
RUNTIME = {"address": "libasan.so", "undefined": "libubsan.so",
           "thread": "libtsan.so"}


def build_sanitized(kind: str) -> str:
    """``gnnome_native.cpp`` built with ``-fsanitize=kind`` into
    ``build/sanitize/``; returns the library's path."""
    out_dir = os.path.join(ROOT, "build", "sanitize")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libgnnome_host_{kind}.so")
    subprocess.run(["g++", "-O1", "-g", "-march=native", "-fPIC", "-shared",
                    "-std=c++17", "-pthread", f"-fsanitize={kind}",
                    "-fno-omit-frame-pointer", SRC, "-o", lib], check=True)
    return lib


def runtime_path(kind: str) -> str:
    return subprocess.run(["g++", f"-print-file-name={RUNTIME[kind]}"],
                          check=True, capture_output=True,
                          text=True).stdout.strip()


def stress(lib_path: str | None) -> None:
    import numpy as np

    from gnnome_tpu_torch import native

    if lib_path is not None:          # load this library as it is
        native._SO_PATH, native._SRC = lib_path, ""
    lib = native.get_lib()
    assert lib is not None, "native lib failed to load"
    print(f"library: {native._SO_PATH}", flush=True)

    from gnnome_tpu_torch.config import DecodeConfig
    from gnnome_tpu_torch.decode.greedy import decode_greedy
    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.graphs.labels import compute_gt_labels
    from gnnome_tpu_torch.graphs.similarity import overlap_similarities
    from gnnome_tpu_torch.graphs.synthetic import synthetic_assembly_graph

    for seed in (0, 1, 2):
        g, reads, _, _ = synthetic_assembly_graph(
            n_reads=250, genome_len=20000, read_len=400, seed=seed,
            with_sequences=True, false_edge_frac=0.2)
        # similarity over the packed read store (threaded C++ aligner)
        sim = overlap_similarities(g.src, g.dst, g.overlap_length, reads,
                                   n_threads=3)
        assert sim.shape == g.src.shape and np.isfinite(sim).all()
        y = compute_gt_labels(g.src, g.dst, g.read_strand, g.read_start,
                              g.read_end, g.read_chr)
        assert y.shape == g.src.shape
        # decode with random logits at two thresholds + the label oracle
        rng = np.random.default_rng(seed)
        scores = rng.standard_normal(g.num_edges).astype(np.float32) * 3
        for cfgkw in ({}, {"len_threshold": 500}):
            r = decode_greedy(g, scores, DecodeConfig(**cfgkw),
                              rng=np.random.default_rng(1))
        r2 = decode_greedy(g, y.astype(np.float32) * 10 - 5, DecodeConfig(),
                           rng=np.random.default_rng(1))
        # resume path: a checkpoint directory decoded into twice
        with tempfile.TemporaryDirectory() as ckdir:
            r3 = decode_greedy(g, scores, DecodeConfig(),
                               checkpoint_dir=ckdir,
                               rng=np.random.default_rng(2))
            r4 = decode_greedy(g, scores, DecodeConfig(),
                               checkpoint_dir=ckdir,
                               rng=np.random.default_rng(2))
        print(f"seed {seed}: edges {g.num_edges} contig walks "
              f"{len(r.walks)}/{len(r2.walks)}/{len(r3.walks)}/"
              f"{len(r4.walks)}", flush=True)

    # a tiny, degenerate graph
    g0 = AssemblyGraph(num_nodes=2, src=np.array([0], np.int32),
                       dst=np.array([1], np.int32),
                       read_length=np.array([100, 100], np.int64),
                       prefix_length=np.array([50], np.int64),
                       overlap_length=np.array([50], np.int64))
    r = decode_greedy(g0, np.array([1.0], np.float32), DecodeConfig())
    print("tiny graph ok:", len(r.walks), flush=True)

    # raw edit distance edge cases
    for a, b in ((b"", b""), (b"A", b""), (b"ACGT" * 100, b"ACGT" * 100),
                 (b"A" * 5000, b"C" * 5000)):
        d = lib.gn_edit_distance(a, len(a), b, len(b))
        assert 0 <= d <= max(len(a), len(b))
    print("edit distance edge cases ok", flush=True)
    print("ALL OK", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sanitize", choices=sorted(RUNTIME),
                    help="build the library with this sanitizer and run "
                         "the stress under it")
    ap.add_argument("--lib", default=None,
                    help="the host library to load as it is")
    args = ap.parse_args(argv)
    if args.sanitize is None:
        stress(args.lib)
        return 0
    lib = build_sanitized(args.sanitize)
    env = {**os.environ, "LD_PRELOAD": runtime_path(args.sanitize),
           "ASAN_OPTIONS": "detect_leaks=0:halt_on_error=1",
           "UBSAN_OPTIONS": "halt_on_error=1:print_stacktrace=1",
           "TSAN_OPTIONS": "halt_on_error=1"}
    print(f"sanitizer {args.sanitize}: {lib} under {env['LD_PRELOAD']}",
          flush=True)
    return subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--lib", lib], env=env).returncode


if __name__ == "__main__":
    sys.exit(main())
