"""Greedy contig decoding over CSR arrays.

Same decoding semantics as the reference (inference.py:30-361):

* sample ``num_decoding_paths`` seed edges among the not-yet-visited subgraph,
  categorically with p ∝ sigmoid(score) (inference.py:54-67,199-212);
* from each seed edge (src, dst): greedy-argmax walk forward from ``dst`` over
  successors, then backward from ``src^1`` (the RC strand) with the forward
  walk's nodes blocked, finally RC-reversed and spliced (inference.py:70-164);
* keep the candidate with the most contig bases (``sum(prefix) + len(last)``,
  inference.py:30-37,306); absorb transitively jumped-over nodes
  ``succ(s) ∩ pred(d)`` plus RC pairs into the visited set (inference.py:
  316-322); stop when the best contig is shorter than ``len_threshold``
  (inference.py:336-337);
* checkpoint every 10 contigs with atomic rename, resumable (inference.py:
  189-197,346-359).

The whole per-iteration hot path runs in C++ (native/gnnome_native.cpp) over
CSR arrays, one call per phase: ``gn_sample_seed_edges`` (one-pass weighted
categorical sampling over the unvisited subgraph), ``gn_decode_round`` (all
candidate walks in parallel threads + backward-splice + contig scoring +
first-max selection; only the winning walk crosses the ctypes boundary) and
``gn_absorb_walk`` (visited marking + transitive absorption).  The reference's
dict-of-lists Python walk (its decode hot spot) is kept as a fallback/oracle,
exercised by the equality tests in tests/test_decode.py.
"""
from __future__ import annotations

import ctypes
import os
import pickle
from dataclasses import dataclass, field

import numpy as np

from ..config import DecodeConfig
from ..native import get_lib


@dataclass
class DecodeResult:
    walks: list = field(default_factory=list)
    walks_len: list = field(default_factory=list)
    contigs_len: list = field(default_factory=list)
    visited: np.ndarray | None = None


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


class _Walker:
    """Greedy walker over a CSR adjacency, native-accelerated.

    ``early_stop_logp``: stop when every candidate log-prob falls below it
    (reference inference.py:27-28,98-100).  ``random_choice`` picks a uniform
    random successor instead of the argmax (reference RANDOM flag,
    inference.py:102-104) — Python path only.
    """

    def __init__(self, graph, log_probs: np.ndarray,
                 early_stop_logp: float | None = None,
                 random_choice: bool = False,
                 rng: np.random.Generator | None = None):
        row_ptr, col, eid = graph.csr()
        self.row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
        self.col = np.ascontiguousarray(col, dtype=np.int32)
        self.eid = np.ascontiguousarray(eid, dtype=np.int64)
        self.log_probs = np.ascontiguousarray(log_probs, dtype=np.float32)
        self.n = graph.num_nodes
        self.stamp = np.zeros(self.n, dtype=np.int32)
        self.epoch = 0
        self.early_stop_logp = early_stop_logp
        self.random_choice = random_choice
        self.rng = rng or np.random.default_rng(0)
        self.lib = None if random_choice else get_lib()
        self.walk_buf = np.empty(self.n, dtype=np.int32)

    def next_epoch(self) -> int:
        self.epoch += 1
        if self.epoch == np.iinfo(np.int32).max:
            self.stamp[:] = 0
            self.epoch = 1
        return self.epoch

    def walk(self, start: int, visited: np.ndarray, epoch: int):
        """Greedy walk from ``start`` over successors.  Returns
        (walk int32[n], sum_log_prob).  Stamps visited nodes with ``epoch``."""
        if self.lib is not None:
            slp = ctypes.c_double(0.0)
            use_es = 1 if self.early_stop_logp is not None else 0
            thr = self.early_stop_logp if use_es else 0.0
            ln = self.lib.gn_greedy_walk(
                self.row_ptr, self.col, self.eid, self.log_probs, visited,
                self.stamp, epoch, start, self.n, use_es, thr, self.walk_buf,
                ctypes.byref(slp))
            return self.walk_buf[:ln].copy(), float(slp.value)
        return self._walk_py(start, visited, epoch)

    def _walk_py(self, start: int, visited: np.ndarray, epoch: int):
        """Python oracle (mirrors inference.py:70-111)."""
        walk, slp = [], 0.0
        current = start
        stamp = self.stamp
        while True:
            walk.append(current)
            stamp[current] = epoch
            stamp[current ^ 1] = epoch
            lo, hi = self.row_ptr[current], self.row_ptr[current + 1]
            if hi == lo:
                break
            if hi - lo == 1:
                nb = int(self.col[lo])
                if visited[nb] or stamp[nb] == epoch:
                    break
                slp += float(self.log_probs[self.eid[lo]])
                current = nb
                continue
            cands = [(int(self.col[k]), int(self.eid[k]))
                     for k in range(lo, hi)
                     if not (visited[self.col[k]] or stamp[self.col[k]] == epoch)]
            if not cands:
                break
            if self.early_stop_logp is not None and all(
                    self.log_probs[e] < self.early_stop_logp for _, e in cands):
                break
            if self.random_choice:
                nb, e = cands[self.rng.integers(0, len(cands))]
            else:
                nb, e = max(cands, key=lambda ce: self.log_probs[ce[1]])
            slp += float(self.log_probs[e])
            current = nb
        return np.asarray(walk, dtype=np.int32), slp

    def edge_ids(self, walk: np.ndarray) -> np.ndarray:
        walk = np.ascontiguousarray(walk, dtype=np.int32)
        out = np.empty(max(len(walk) - 1, 0), dtype=np.int64)
        if len(walk) < 2:
            return out
        if self.lib is not None:
            r = self.lib.gn_walk_edge_ids(self.row_ptr, self.col, self.eid,
                                          walk, len(walk), out)
            if r < 0:
                raise KeyError(f"walk edge missing at position {-1 - r}")
            return out
        for i in range(len(walk) - 1):
            u, v = int(walk[i]), int(walk[i + 1])
            for k in range(self.row_ptr[u], self.row_ptr[u + 1]):
                if self.col[k] == v:
                    out[i] = self.eid[k]
                    break
            else:
                raise KeyError((u, v))
        return out


def _candidate_walks(walker: _Walker, graph, seeds: np.ndarray,
                     visited: np.ndarray, n_threads: int):
    """Yield (walk, sum_log_prob) per seed edge — all candidates walked in
    parallel by the native batch kernel (the reference runs them sequentially
    through a 1-worker pool, inference.py:231-243); yields (None, 0.0) for a
    self-loop seed."""
    src = graph.src[seeds].astype(np.int32)
    dst = graph.dst[seeds].astype(np.int32)
    n_cand = seeds.shape[0]
    if walker.lib is not None:
        import os
        max_walk = walker.n
        out_walks = np.empty((n_cand, max_walk), dtype=np.int32)
        out_lens = np.empty((n_cand, 2), dtype=np.int64)
        out_slp = np.empty((n_cand, 2), dtype=np.float64)
        use_es = 1 if walker.early_stop_logp is not None else 0
        thr = walker.early_stop_logp if use_es else 0.0
        walker.lib.gn_greedy_walk_batch(
            walker.row_ptr, walker.col, walker.eid, walker.log_probs, visited,
            walker.n, np.ascontiguousarray(src), np.ascontiguousarray(dst),
            n_cand, max_walk, use_es, thr,
            min(n_threads, os.cpu_count() or 1), out_walks, out_lens, out_slp)
        for c in range(n_cand):
            if src[c] == dst[c]:
                yield None, 0.0
                continue
            lf, lb = int(out_lens[c, 0]), int(out_lens[c, 1])
            walk_f = out_walks[c, :lf]
            walk_b = (out_walks[c, lf:lf + lb][::-1] ^ 1).astype(np.int32)
            yield np.concatenate([walk_b, walk_f]), float(out_slp[c].sum())
        return
    for c in range(n_cand):
        s, d = int(src[c]), int(dst[c])
        epoch = walker.next_epoch()
        walker.stamp[[s, s ^ 1, d, d ^ 1]] = epoch  # inference.py:161
        walk_f, slp_f = walker.walk(d, visited, epoch)
        walk_b_rc, slp_b = walker.walk(s ^ 1, visited, epoch)
        walk_b = (walk_b_rc[::-1] ^ 1).astype(np.int32)
        if s == d:
            yield None, 0.0
        else:
            yield np.concatenate([walk_b, walk_f]), slp_f + slp_b


def _sample_seed_edges(probs: np.ndarray, eligible: np.ndarray, nb_paths: int,
                       rng: np.random.Generator, random_baseline: bool):
    """Categorical seed sampling (inference.py:54-67)."""
    if eligible.shape[0] > 2 ** 24:          # torch Categorical limit kept
        eligible = eligible[: 2 ** 24]
    if random_baseline:
        return eligible[rng.integers(0, eligible.shape[0], size=nb_paths)]
    p = probs[eligible].astype(np.float64)
    p = np.maximum(p, 1e-9)
    p /= p.sum()
    return rng.choice(eligible, size=nb_paths, replace=True, p=p)


def decode_greedy(graph, scores: np.ndarray, cfg: DecodeConfig | None = None,
                  checkpoint_dir: str | None = None,
                  rng: np.random.Generator | None = None,
                  use_labels: bool = False,
                  verbose: bool = False,
                  checkpoint_name: str = "checkpoint.pkl") -> DecodeResult:
    """Decode contig walks from edge logits (reference inference.py:167-361).

    ``scores`` are raw logits (or labels when ``use_labels``).
    ``checkpoint_name`` keys the resume file inside ``checkpoint_dir`` —
    callers decoding several graphs into one savedir MUST key it per graph
    (run_inference passes ``checkpoint_{idx}.pkl``), or graph i would resume
    from graph i-1's walks.  A completed decode removes its file, so a
    finished run never resumes from a stale snapshot.
    """
    cfg = cfg or DecodeConfig()
    rng = rng or np.random.default_rng(0)
    n = graph.num_nodes

    scores = np.asarray(scores, dtype=np.float32).reshape(-1)
    if use_labels:  # oracle decoding (inference.py:178-181)
        if graph.y is None:
            raise ValueError("decode_with_labels requires a graph parsed with "
                             "training=True (ground-truth labels)")
        probs = np.maximum(np.asarray(graph.y, dtype=np.float64), 1e-9)
        log_probs = np.log(probs).astype(np.float32)
        probs = probs.astype(np.float32)
    else:
        probs = _sigmoid(scores.astype(np.float64)).astype(np.float32)
        log_probs = np.log(_sigmoid(scores.astype(np.float64))).astype(np.float32)

    prefix = np.maximum(np.asarray(graph.prefix_length, dtype=np.int64), 0)  # inference.py:463
    read_len = np.asarray(graph.read_length, dtype=np.int64)

    early = (float(np.log(cfg.p_threshold)) if cfg.early_stopping else None)
    walker = _Walker(graph, log_probs, early_stop_logp=early,
                     random_choice=cfg.random_baseline, rng=rng)
    result = DecodeResult(visited=np.zeros(n, dtype=np.uint8))
    visited = result.visited

    ckpt_file = (os.path.join(checkpoint_dir, checkpoint_name)
                 if checkpoint_dir else None)
    if ckpt_file and cfg.load_checkpoint and os.path.isfile(ckpt_file):
        with open(ckpt_file, "rb") as f:
            ck = pickle.load(f)
        result.walks = ck["walks"]
        result.walks_len = ck["all_walks_len"]
        result.contigs_len = ck["all_contigs_len"]
        ck_vis = ck["visited"]
        if isinstance(ck_vis, np.ndarray):
            visited[ck_vis] = 1
        else:  # legacy checkpoints stored a python set
            for node in ck_vis:
                visited[node] = 1

    # successors of the reversed graph == predecessors; build once for
    # transitive absorption
    csc_ptr, csc_row, _ = graph.csc()
    csr_ptr, csr_col, _ = graph.csr()

    # native fast path: the whole candidate round (parallel walks + contig
    # scoring + first-max selection), the seed sampling and the visited-set
    # absorption each run as ONE C++ call per iteration — no per-candidate
    # ctypes round trips, no [n_cand, N] staging buffer, no O(E) numpy
    # temporaries per iteration (scripts/decode_profile.py: these were ~60%
    # of decode wall time at 0.5M nodes)
    lib = walker.lib
    n_threads = min(cfg.num_threads, os.cpu_count() or 1)
    native_round = lib is not None
    # the reference truncates its eligible list at 2^24 (torch Categorical
    # limit); the one-pass sampler has no such limit, so mirror the quirk by
    # falling back to the numpy path on (absurdly) larger edge counts
    native_sample = native_round and graph.num_edges <= 2 ** 24
    if native_round:
        src32 = np.ascontiguousarray(graph.src, dtype=np.int32)
        dst32 = np.ascontiguousarray(graph.dst, dtype=np.int32)
        prefix64 = np.ascontiguousarray(prefix, dtype=np.int64)
        read_len64 = np.ascontiguousarray(read_len, dtype=np.int64)
        csr_ptr64 = np.ascontiguousarray(csr_ptr, dtype=np.int64)
        csr_col32 = np.ascontiguousarray(csr_col, dtype=np.int32)
        csc_ptr64 = np.ascontiguousarray(csc_ptr, dtype=np.int64)
        csc_row32 = np.ascontiguousarray(csc_row, dtype=np.int32)
        walk_buf = np.empty(n, dtype=np.int32)
        seeds_buf = np.empty(cfg.num_decoding_paths, dtype=np.int64)
        use_es = 1 if walker.early_stop_logp is not None else 0
        es_thr = walker.early_stop_logp if use_es else 0.0
        # absorb scratch: epoch stamps (persistent) + newly-visited out list
        absorb_stamp = np.zeros(n, dtype=np.int32)
        absorb_epoch = 0
        newly_buf = np.empty(n, dtype=np.int32)
        # decode-round scratch: per-thread walk stamps + walk buffers,
        # allocated ONCE (per-call zeroed vectors cost more than the walks
        # themselves once most of the graph is visited)
        round_stamp = np.zeros(n_threads * n, dtype=np.int32)
        round_wbuf = np.empty(n_threads * 2 * n, dtype=np.int32)
        round_epoch = 0
    if native_sample:
        # incremental sampler state: per-1024-block alive-weight sums with
        # edges killed (by subtraction) as their endpoints become visited, so
        # each iteration's sampling is O(touched + n_blocks) instead of O(E)
        # — threshold-0 full-graph decode was sampler-bound (one O(E) pass
        # per contig).  Every sample is guaranteed alive; termination rides
        # the exact integer alive count.
        E = graph.num_edges
        n_blocks = (E + 1023) // 1024
        csr_eid64 = walker.eid                       # already int64
        csc_eid64 = np.ascontiguousarray(graph.csc()[2], dtype=np.int64)
        s_alive = np.empty(E, dtype=np.uint8)
        s_weight = np.empty(E, dtype=np.float64)
        s_bsum = np.empty(n_blocks, dtype=np.float64)
        s_blast = np.empty(n_blocks, dtype=np.int64)
        s_count = np.empty(1, dtype=np.int64)
        lib.gn_sampler_init(src32, dst32, probs, visited, E, n_threads,
                            s_alive, s_weight, s_bsum, s_blast, s_count)

    if native_sample:
        # chunked native driver: up to 10 contigs (the reference's checkpoint
        # cadence, inference.py:346-359) per C++ call — per-phase ctypes and
        # per-iteration thread spawn/join dominated threshold-0 decode
        # (~0.6 ms/round of pure overhead at 131k nodes).  Seed sampling
        # consumes rng.random(chunk * k) row-by-row, the same stream order as
        # the per-iteration path, so sampled CONTIGS are bitwise identical
        # across paths; but the batch draw may over-consume up to
        # (chunk-1)*k uniforms on the terminating chunk, so the CALLER's
        # Generator ends in a different state than the pure-python path —
        # don't rely on ``rng`` state after decode_greedy returns.
        chunk = 10
        k = cfg.num_decoding_paths
        absorb_epoch_a = np.zeros(1, dtype=np.int32)
        round_epoch_a = np.zeros(1, dtype=np.int32)
        status = np.zeros(1, dtype=np.int32)
        walks_flat = np.empty(n + chunk, dtype=np.int32)
        chunk_wlens = np.empty(chunk, dtype=np.int64)
        chunk_clens = np.empty(chunk, dtype=np.int64)
        while True:
            uniforms = rng.random(chunk * k)
            got = lib.gn_decode_chunk(
                walker.row_ptr, walker.col, walker.eid,
                csc_ptr64, csc_row32, csc_eid64, src32, dst32,
                walker.log_probs, prefix64, read_len64, n, E,
                k, use_es, es_thr, cfg.len_threshold, n_threads,
                uniforms, chunk, visited,
                s_alive, s_weight, s_bsum, s_blast, s_count,
                absorb_stamp, absorb_epoch_a,
                round_stamp, round_wbuf, round_epoch_a,
                newly_buf, seeds_buf,
                walks_flat, chunk_wlens, chunk_clens, status)
            if got < 0:
                raise KeyError(f"walk edge missing (candidate {-1 - got})")
            pos = 0
            for i in range(got):
                wl, cl = int(chunk_wlens[i]), int(chunk_clens[i])
                walk_it = walks_flat[pos:pos + wl]
                pos += wl
                if verbose:
                    print(f"contig {len(result.walks)}: len_walk={wl} "
                          f"len_contig={cl}")
                result.walks.append(walk_it.tolist())
                result.walks_len.append(wl)
                result.contigs_len.append(cl)
                # exact reference cadence: every 10 contigs (inference.py:346)
                if ckpt_file and len(result.walks) % 10 == 0:
                    ck = {"walks": result.walks,
                          "visited": np.nonzero(visited)[0].astype(np.int64),
                          "all_walks_len": result.walks_len,
                          "all_contigs_len": result.contigs_len}
                    tmp = ckpt_file + ".tmp"
                    with open(tmp, "wb") as f:
                        pickle.dump(ck, f)
                    os.replace(tmp, ckpt_file)
            if int(status[0]) != 0:
                break
        _remove_completed_ckpt(ckpt_file)
        return result

    # native_sample never reaches here — the chunked gn_decode_chunk driver
    # above returns unconditionally, and it is the only native-sampler path.
    while True:
        ok = (visited == 0)
        eligible = np.nonzero(ok[graph.src] & ok[graph.dst])[0]
        if eligible.size == 0:
            break
        seeds = _sample_seed_edges(probs, eligible,
                                   cfg.num_decoding_paths, rng,
                                   cfg.random_baseline)

        if native_round:
            clen_out = ctypes.c_int64(0)
            slp_out = ctypes.c_double(0.0)
            if round_epoch > 2 ** 31 - len(seeds) - 16:  # int32 wraparound
                round_stamp[:] = 0
                round_epoch = 0
            wlen = lib.gn_decode_round(
                walker.row_ptr, walker.col, walker.eid, walker.log_probs,
                prefix64, read_len64, visited, n,
                np.ascontiguousarray(src32[seeds]),
                np.ascontiguousarray(dst32[seeds]),
                len(seeds), use_es, es_thr, n_threads,
                round_stamp, round_wbuf, round_epoch,
                walk_buf, ctypes.byref(clen_out), ctypes.byref(slp_out))
            round_epoch += len(seeds)
            if wlen < 0:
                raise KeyError(f"walk edge missing (candidate {-1 - wlen})")
            walk_it = walk_buf[:wlen].copy()
            contig_len = int(clen_out.value)
        else:
            best = None  # (contig_len, walk, slp)
            for walk_c, slp in _candidate_walks(walker, graph, seeds, visited,
                                                cfg.num_threads):
                if walk_c is None:  # SELF-LOOP seed (inference.py:289-294)
                    contig_len, walk_c = 0, np.zeros(0, np.int32)
                else:
                    eids = walker.edge_ids(walk_c)
                    contig_len = int(prefix[eids].sum() + read_len[walk_c[-1]])
                if best is None or contig_len > best[0]:
                    best = (contig_len, walk_c, slp)
            contig_len, walk_it, _slp = best

        if verbose:
            print(f"contig {len(result.walks)}: len_walk={len(walk_it)} "
                  f"len_contig={contig_len}")
        if contig_len < cfg.len_threshold:
            break

        if native_round:
            # walk + RC pairs + transitive absorption (inference.py:316-322)
            if absorb_epoch > 2 ** 31 - n - 16:     # int32 epoch wraparound
                absorb_stamp[:] = 0
                absorb_epoch = 0
            n_new = lib.gn_absorb_walk(csr_ptr64, csr_col32, csc_ptr64,
                                       csc_row32, walk_it, len(walk_it),
                                       visited, absorb_stamp,
                                       absorb_epoch + 1, newly_buf)
            absorb_epoch += max(len(walk_it), 1)
            if native_sample and n_new:
                lib.gn_sampler_update(csr_ptr64, csr_col32, csr_eid64,
                                      csc_ptr64, csc_row32, csc_eid64,
                                      newly_buf, n_new, E, s_alive, s_weight,
                                      s_bsum, s_blast, s_count)
        else:
            visited[walk_it] = 1
            visited[walk_it ^ 1] = 1
            for u, v in zip(walk_it[:-1].tolist(), walk_it[1:].tolist()):
                succ_u = csr_col[csr_ptr[u]:csr_ptr[u + 1]]
                pred_v = csc_row[csc_ptr[v]:csc_ptr[v + 1]]
                trans = np.intersect1d(succ_u, pred_v)
                if trans.size:
                    visited[trans] = 1
                    visited[trans ^ 1] = 1

        result.walks.append(walk_it.tolist())
        result.walks_len.append(len(walk_it))
        result.contigs_len.append(contig_len)

        if ckpt_file and len(result.walks) % 10 == 0:
            ck = {"walks": result.walks,
                  "visited": np.nonzero(visited)[0].astype(np.int64),
                  "all_walks_len": result.walks_len,
                  "all_contigs_len": result.contigs_len}
            tmp = ckpt_file + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(ck, f)
            os.replace(tmp, ckpt_file)

    _remove_completed_ckpt(ckpt_file)
    return result


def _remove_completed_ckpt(ckpt_file):
    """A finished decode must not leave its resume snapshot behind — a
    re-run would otherwise 'resume' an already-complete result."""
    if ckpt_file and os.path.isfile(ckpt_file):
        os.remove(ckpt_file)
