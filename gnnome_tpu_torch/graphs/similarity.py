"""Overlap-similarity featurisation.

The reference computes, per edge, ``1 - editdist / ol_len`` over the overlap
region ``read_src[-ol:]`` vs ``read_dst[:ol]`` with edlib (reference
graph_parser.py:101-117), and ``0.5`` for zero-length overlaps.  Here the edit
distance comes from the in-repo C++ engine (native/gnnome_native.cpp,
multi-threaded, straight from the packed ReadStore) with a numpy fallback.

Optimisation over the reference: the RC-twin edge ``(v^1, u^1)`` has the same
edit distance as ``(u, v)`` (Levenshtein is invariant under reverse-complement
of both strings), so only one of each twin pair is computed.
"""
from __future__ import annotations

import os

import numpy as np

from ..native import get_lib
from .container import ReadStore


def _edit_distance_numpy(a: str, b: str) -> int:
    """Exact global edit distance, vectorised DP rows (test-scale fallback)."""
    n, m = len(a), len(b)
    if n == 0:
        return m
    if m == 0:
        return n
    bv = np.frombuffer(b.encode(), dtype=np.uint8)
    prev = np.arange(m + 1, dtype=np.int64)
    for i in range(1, n + 1):
        ai = ord(a[i - 1])
        sub = prev[:-1] + (bv != ai)
        dele = prev[1:] + 1
        cur = np.empty(m + 1, dtype=np.int64)
        cur[0] = i
        np.minimum(sub, dele, out=cur[1:])
        # insertion needs a sequential min-scan: cur[j] = min(cur[j], cur[j-1]+1)
        np.minimum.accumulate(cur - np.arange(m + 1), out=cur)
        cur += np.arange(m + 1)
        prev = cur
    return int(prev[m])


def edit_distance(a: str, b: str) -> int:
    lib = get_lib()
    if lib is not None:
        return int(lib.gn_edit_distance(a.encode(), len(a), b.encode(), len(b)))
    return _edit_distance_numpy(a, b)


def overlap_similarities(src: np.ndarray, dst: np.ndarray, ol: np.ndarray,
                         reads: ReadStore, n_threads: int | None = None,
                         max_k_frac: float = 0.0) -> np.ndarray:
    """Per-edge ``overlap_similarity`` (reference graph_parser.py:101-117).

    ``max_k_frac > 0`` caps each edge's Ukkonen band at that fraction of the
    overlap length: similarities >= 1 - max_k_frac stay EXACT, heavily
    diverged pairs (random/wrong-strand overlaps, whose banded cost is
    O(L * trueED)) report a clamped value ~<= 1 - max_k_frac instead.  A
    speed knob for synthetic-graph generation; the product GFA path keeps the
    default exact semantics (reference parity).  Native path only — the
    numpy fallback always computes exact distances."""
    n_edges = src.shape[0]
    sims = np.full(n_edges, 0.5, dtype=np.float32)
    if n_edges == 0:
        return sims

    # Compute each RC-twin pair once: canonical representative of edge (u, v)
    # is the lexicographically smaller of (u, v) and (v^1, u^1).
    key = np.stack([src.astype(np.int64), dst.astype(np.int64)], axis=1)
    twin = np.stack([dst.astype(np.int64) ^ 1, src.astype(np.int64) ^ 1], axis=1)
    is_canon = (key[:, 0] < twin[:, 0]) | ((key[:, 0] == twin[:, 0]) & (key[:, 1] <= twin[:, 1]))
    canon_ids = np.nonzero(is_canon & (ol > 0))[0]

    dists = np.empty(canon_ids.shape[0], dtype=np.int64)
    lib = get_lib()
    if lib is not None and canon_ids.size:
        n_threads = n_threads or max(1, (os.cpu_count() or 1))
        lib.gn_overlap_edit_distance_batch_capped(
            reads._blob, reads._offsets,
            np.ascontiguousarray(src[canon_ids], dtype=np.int32),
            np.ascontiguousarray(dst[canon_ids], dtype=np.int32),
            np.ascontiguousarray(ol[canon_ids], dtype=np.int64),
            canon_ids.shape[0], n_threads, float(max_k_frac), dists)
    else:
        for i, e in enumerate(canon_ids.tolist()):
            L = int(ol[e])
            a = reads.get(int(src[e]))[-L:]
            b = reads.get(int(dst[e]))[:L]
            dists[i] = _edit_distance_numpy(a, b)

    olc = ol[canon_ids].astype(np.float64)
    sims[canon_ids] = (1.0 - dists / olc).astype(np.float32)

    # Propagate to RC twins via a pair lookup.
    lut = {}
    s_l, d_l = src.tolist(), dst.tolist()
    for e in canon_ids.tolist():
        lut[(s_l[e], d_l[e])] = sims[e]
    rest = np.nonzero(~is_canon & (ol > 0))[0]
    for e in rest.tolist():
        tw = (d_l[e] ^ 1, s_l[e] ^ 1)
        if tw in lut:
            sims[e] = lut[tw]
        else:  # twin absent (asymmetric graph) — compute directly
            L = int(ol[e])
            a = reads.get(s_l[e])[-L:]
            b = reads.get(d_l[e])[:L]
            sims[e] = np.float32(1.0 - edit_distance(a, b) / L)
    return sims
