"""Synthetic assembly-graph generation for tests and benchmarks.

The reference has no test fixtures at all (SURVEY.md §4); its graphs come from
external assemblers (hifiasm/Raven) over PBSIM-simulated reads.  This module
fabricates the same *shape* of data end-to-end in-process: a random genome,
error-free reads sampled along it on both strands, suffix-prefix overlap edges
derived from the true layout (what a perfect OLC assembler would emit), and
optional GFA/FASTA serialisation so the real parser path can be exercised.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..utils.fastx import FastxRecord, reverse_complement, write_fasta, format_training_header
from .container import AssemblyGraph, ReadStore

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_genome(length: int, rng: np.random.Generator) -> str:
    return _BASES[rng.integers(0, 4, size=length)].tobytes().decode("ascii")


def _apply_read_errors(seq: str, rng: np.random.Generator,
                       error_rate: float) -> str:
    """Substitution errors at the given per-base rate (PBSIM-like HiFi error
    profile, substitutions only — reference generate_data.py:129-134 samples
    a real profile; here a flat rate is enough to spread the
    overlap-similarity feature below 1.0)."""
    arr = np.frombuffer(seq.encode("ascii"), dtype=np.uint8).copy()
    n_err = int(rng.binomial(arr.size, error_rate))
    if n_err == 0:
        return seq
    pos = rng.choice(arr.size, size=n_err, replace=False)
    # substitute with a uniformly-random DIFFERENT base: new = cur + 1..3 mod 4
    cur = np.searchsorted(_BASES, arr[pos])  # ACGT are sorted ascii
    arr[pos] = _BASES[(cur + rng.integers(1, 4, size=n_err)) % 4]
    return arr.tobytes().decode("ascii")


def simulate_reads_from_genome(genome: str, n_reads: int, read_len: int,
                               rng: np.random.Generator, chrom: int = 1,
                               error_rate: float = 0.0,
                               start_gaps=()):
    """Evenly-ish spaced reads with random strands.

    Returns (records, starts, ends, strands): record ``i`` covers
    ``genome[starts[i]:ends[i]]`` (RC'd when ``strands[i] == -1``), with
    training headers in the PBSIM-rewritten convention
    (reference generate_data.py:43-60).

    ``error_rate`` applies substitution errors to the sequences (GT positions
    stay exact, as PBSIM's MAF does).  ``start_gaps`` is a list of genome
    intervals ``(lo, hi)``: no read may start in ``(lo - read_len, hi)``, so
    no read spans the interval and the assembly graph splits there —
    guarantees a multi-contig decode.
    """
    L = len(genome)
    max_start = max(1, L - read_len)
    starts = rng.integers(0, max_start, size=n_reads)
    for lo, hi in start_gaps:
        bad = (starts > lo - read_len) & (starts < hi)
        while bad.any():
            starts[bad] = rng.integers(0, max_start, size=int(bad.sum()))
            bad = (starts > lo - read_len) & (starts < hi)
    starts = np.sort(starts)
    ends = np.minimum(starts + read_len, L)
    strands = rng.choice([1, -1], size=n_reads)
    records = []
    for i in range(n_reads):
        seq = genome[starts[i]:ends[i]]
        if error_rate > 0.0:
            seq = _apply_read_errors(seq, rng, error_rate)
        if strands[i] == -1:
            seq = reverse_complement(seq)
        rid = f"read{i}"
        records.append(FastxRecord(
            id=rid,
            description=format_training_header(rid, int(strands[i]),
                                               int(starts[i]), int(ends[i]), chrom),
            seq=seq))
    return records, starts, ends, strands


def _add_false_edges(src, dst, ol, n_reads: int, n_false: int,
                     rng: np.random.Generator, typical_ol: int):
    """Spurious chimeric/wrong-strand edges (real assembler graphs contain
    them; they are what the GNN learns to score down)."""
    existing = set(zip(src.tolist(), dst.tolist()))
    f_src, f_dst, f_ol = [], [], []
    trials = 0
    while len(f_src) < 2 * n_false and trials < 50 * n_false:
        trials += 1
        u = int(rng.integers(0, 2 * n_reads))
        v = int(rng.integers(0, 2 * n_reads))
        if v in (u, u ^ 1) or (u, v) in existing:
            continue
        L = int(rng.integers(max(1, typical_ol // 4), typical_ol))
        existing.add((u, v)); existing.add((v ^ 1, u ^ 1))
        f_src.extend((u, v ^ 1)); f_dst.extend((v, u ^ 1)); f_ol.extend((L, L))
    return (np.concatenate([src, np.asarray(f_src, dtype=np.int32)]),
            np.concatenate([dst, np.asarray(f_dst, dtype=np.int32)]),
            np.concatenate([ol, np.asarray(f_ol, dtype=np.int64)]))


def _add_wrong_strand_edges(src, dst, ol, n_hard: int,
                            rng: np.random.Generator):
    """Hard negatives: take genuinely-overlapping edges and flip the TARGET
    orientation — the reads DO overlap on the genome (so the overlap-length
    feature is indistinguishable from a true edge) but the strands disagree,
    so the sequences don't align and the GT sweep rejects them.  Real
    assembler graphs are full of these (inverted-repeat artifacts); they are
    what makes the score distributions overlap instead of being separable by
    a single feature."""
    if src.size == 0 or n_hard <= 0:
        return src, dst, ol
    existing = set(zip(src.tolist(), dst.tolist()))
    # true layout edges come in (fwd, twin) pairs at (2k, 2k+1)
    cand = rng.permutation(src.size // 2)
    f_src, f_dst, f_ol = [], [], []
    for k in cand:
        if len(f_src) >= 2 * n_hard:
            break
        u, v, L = int(src[2 * k]), int(dst[2 * k]), int(ol[2 * k])
        if (u, v ^ 1) in existing or (v, u ^ 1) in existing:
            continue
        existing.add((u, v ^ 1)); existing.add((v, u ^ 1))
        f_src.extend((u, v)); f_dst.extend((v ^ 1, u ^ 1)); f_ol.extend((L, L))
    return (np.concatenate([src, np.asarray(f_src, dtype=np.int32)]),
            np.concatenate([dst, np.asarray(f_dst, dtype=np.int32)]),
            np.concatenate([ol, np.asarray(f_ol, dtype=np.int64)]))


def _plant_repeats(genome: str, n_pairs: int, repeat_len: int,
                   rng: np.random.Generator):
    """Copy ``n_pairs`` segments of the genome to distant second locations.

    Returns (genome, pairs) with ``pairs = [(a1, a2, L)]``: ``genome[a1:a1+L]
    == genome[a2:a2+L]``.  This is THE mechanism behind real assembler false
    edges — reads from the two copies overlap in sequence (the assembler
    emits the link, similarity ~1) but not in genome position (GT label 0).
    Band positions keep the pairs disjoint: copy 1 of pair k lives in band k
    of the genome's first half, copy 2 in band k of the second half."""
    G = len(genome)
    arr = list(genome)
    pairs = []
    half = G // 2
    band = half // max(1, n_pairs)
    # a repeat longer than its band would make the list-slice assignment
    # below silently EXTEND the genome and break band-disjointness of the
    # copies (advisor finding, round 4)
    repeat_len = max(1, min(repeat_len, band))
    for k in range(n_pairs):
        lo1, lo2 = k * band, half + k * band
        a1 = int(rng.integers(lo1, max(lo1 + 1, lo1 + band - repeat_len)))
        a2 = int(rng.integers(lo2, max(lo2 + 1, min(lo2 + band, G) - repeat_len)))
        arr[a2:a2 + repeat_len] = arr[a1:a1 + repeat_len]
        pairs.append((a1, a2, repeat_len))
    return "".join(arr), pairs


def _add_repeat_edges(src, dst, ol, starts, ends, strands, pairs,
                      min_overlap: int = 500):
    """Sequence-exact cross-copy edges for each planted repeat pair: read i
    whose suffix lies inside one copy -> read j whose prefix lies inside the
    other, overlap = their repeat-relative interval overlap.  These edges are
    what make AP discriminating: similarity ~1 like a true edge, GT label 0."""
    existing = set(zip(src.tolist(), dst.tolist()))
    f_src, f_dst, f_ol = [], [], []
    for a1, a2, Lr in pairs:
        for sa, sb in ((a1, a2), (a2, a1)):
            I = np.nonzero((ends > sa) & (ends <= sa + Lr))[0]
            J = np.nonzero((starts >= sb) & (starts < sb + Lr))[0]
            for i in I.tolist():
                p = int(ends[i] - sa)
                for j in J.tolist():
                    q = int(starts[j] - sb)
                    o = p - q
                    if (o < min_overlap or o >= ends[i] - starts[i]
                            or o >= ends[j] - starts[j]):
                        continue
                    u = 2 * i if strands[i] == 1 else 2 * i + 1
                    v = 2 * j if strands[j] == 1 else 2 * j + 1
                    if j == i or v in (u, u ^ 1) or (u, v) in existing:
                        continue
                    existing.add((u, v))
                    existing.add((v ^ 1, u ^ 1))
                    f_src.extend((u, v ^ 1))
                    f_dst.extend((v, u ^ 1))
                    f_ol.extend((o, o))
    if not f_src:
        return src, dst, ol
    return (np.concatenate([src, np.asarray(f_src, dtype=np.int32)]),
            np.concatenate([dst, np.asarray(f_dst, dtype=np.int32)]),
            np.concatenate([ol, np.asarray(f_ol, dtype=np.int64)]))


def _layout_edges(starts, ends, strands, min_overlap: int = 1):
    """True suffix-prefix overlaps implied by the genome layout.

    For reads i, j with start_i < start_j < end_i (same genomic interval
    overlap), the forward-strand edge runs i->j; node orientation follows the
    real/virtual convention (real node 2i = sequenced strand).
    """
    n = len(starts)
    e_src, e_dst, e_ol = [], [], []
    order = np.argsort(starts, kind="stable")
    for a_pos in range(n):
        i = order[a_pos]
        for b_pos in range(a_pos + 1, n):
            j = order[b_pos]
            if starts[j] >= ends[i]:
                break
            ol = int(ends[i] - starts[j])
            if ol < min_overlap or ol >= ends[i] - starts[i] or ol >= ends[j] - starts[j]:
                continue
            # genome-forward edge i -> j; express in node space
            u_fwd = 2 * i if strands[i] == 1 else 2 * i + 1
            v_fwd = 2 * j if strands[j] == 1 else 2 * j + 1
            e_src.append(u_fwd); e_dst.append(v_fwd); e_ol.append(ol)
            # RC twin j^rc -> i^rc
            e_src.append(v_fwd ^ 1); e_dst.append(u_fwd ^ 1); e_ol.append(ol)
    return (np.asarray(e_src, dtype=np.int32), np.asarray(e_dst, dtype=np.int32),
            np.asarray(e_ol, dtype=np.int64))


def synthetic_assembly_graph(n_reads: int = 200, genome_len: int = 20_000,
                             read_len: int = 300, seed: int = 0,
                             with_labels: bool = True,
                             with_sequences: bool = True,
                             false_edge_frac: float = 0.15,
                             error_rate: float = 0.0,
                             hard_false_frac: float = 0.0,
                             n_coverage_gaps: int = 0,
                             n_repeat_pairs: int = 0,
                             repeat_len: Optional[int] = None,
                             sim_band_frac: float = 0.0):
    """In-memory synthetic AssemblyGraph (+ReadStore) with GT attributes.

    With the defaults the graph is error-free and its ~15% random false edges
    are trivially separable (the round-3 golden run's AP was degenerately 1.0
    for every score set).  ``error_rate`` (substitutions) spreads true-edge
    overlap similarities below 1, ``hard_false_frac`` adds wrong-strand
    overlaps whose length feature matches true edges, ``n_repeat_pairs``
    plants genome repeats whose cross-copy edges have similarity ~1 but GT
    label 0 (the REAL mechanism behind assembler false edges), and
    ``n_coverage_gaps`` splits the genome so decode must emit >1 contig —
    together they make AP/NG50 comparisons discriminating.
    ``sim_band_frac`` caps the similarity aligner's band (see
    similarity.overlap_similarities) — a pure build-speed knob.
    """
    rng = np.random.default_rng(seed)
    genome = random_genome(genome_len, rng)
    repeat_pairs = []
    if n_repeat_pairs > 0:
        genome, repeat_pairs = _plant_repeats(
            genome, n_repeat_pairs, repeat_len or read_len * 3 // 5, rng)
    gaps = []
    if n_coverage_gaps > 0:
        # evenly-spaced zero-coverage bands, each a read-length wide
        for k in range(1, n_coverage_gaps + 1):
            mid = genome_len * k // (n_coverage_gaps + 1)
            gaps.append((mid, min(genome_len, mid + read_len)))
    records, starts, ends, strands = simulate_reads_from_genome(
        genome, n_reads, read_len, rng, error_rate=error_rate,
        start_gaps=gaps)
    src, dst, ol = _layout_edges(starts, ends, strands)
    if repeat_pairs and src.size:
        src, dst, ol = _add_repeat_edges(src, dst, ol, starts, ends, strands,
                                         repeat_pairs)
    if hard_false_frac > 0 and src.size:
        n_hard = max(1, int(hard_false_frac * src.size / 2))
        src, dst, ol = _add_wrong_strand_edges(src, dst, ol, n_hard, rng)
    if false_edge_frac > 0 and src.size:
        n_false = max(1, int(false_edge_frac * src.size / 2))
        src, dst, ol = _add_false_edges(src, dst, ol, n_reads, n_false, rng,
                                        typical_ol=read_len // 2)

    order = np.argsort(src, kind="stable")
    src, dst, ol = src[order], dst[order], ol[order]

    read_length = np.repeat((ends - starts).astype(np.int64), 2)
    graph = AssemblyGraph(
        num_nodes=2 * n_reads, src=src, dst=dst,
        read_length=read_length,
        prefix_length=read_length[src] - ol,
        overlap_length=ol,
    )
    graph.read_strand = np.repeat(strands.astype(np.int8), 2).copy()
    graph.read_strand[1::2] *= -1
    graph.read_start = np.repeat(starts.astype(np.int64), 2)
    graph.read_end = np.repeat(ends.astype(np.int64), 2)
    graph.read_chr = np.full(2 * n_reads, 1, dtype=np.int16)

    if with_labels:
        from .labels import compute_gt_labels
        graph.y = compute_gt_labels(src, dst, graph.read_strand, graph.read_start,
                                    graph.read_end, graph.read_chr)

    reads = None
    if with_sequences:
        from .similarity import overlap_similarities
        reads = ReadStore.from_sequences([r.seq for r in records])
        graph.overlap_similarity = overlap_similarities(
            src, dst, ol, reads, max_k_frac=sim_band_frac)
    return graph, reads, records, genome


def write_synthetic_gfa(records, starts, ends, strands, gfa_path: str,
                        reads_path: str, dialect: str = "raven",
                        min_overlap: int = 1) -> None:
    """Serialise the synthetic layout as GFA + FASTA to exercise the parser."""
    src, dst, ol = _layout_edges(starts, ends, strands, min_overlap)
    with open(gfa_path, "w") as f:
        for i, r in enumerate(records):
            f.write(f"S\t{r.id}\t{r.seq}\tLN:i:{len(r.seq)}\n")
        for k in range(0, len(src), 2):  # real edges only; twin implied by orientations
            u, v, L = int(src[k]), int(dst[k]), int(ol[k])
            id1, o1 = records[u >> 1].id, "+" if u % 2 == 0 else "-"
            id2, o2 = records[v >> 1].id, "+" if v % 2 == 0 else "-"
            if dialect == "raven":
                f.write(f"L\t{id1}\t{o1}\t{id2}\t{o2}\t{L}M\n")
            else:  # hifiasm 7-column
                f.write(f"L\t{id1}:0-1\t{o1}\t{id2}:0-1\t{o2}\t{L}M\tL1:i:0\n")
    write_fasta(records, reads_path)


def random_bench_graph(num_nodes: int, avg_degree: float, seed: int = 0,
                       locality: int = 64):
    """Banded random digraph shaped like an assembly graph (mostly
    chain-local edges), for kernel benchmarking.  Returns src, dst int32."""
    rng = np.random.default_rng(seed)
    n_edges = int(num_nodes * avg_degree)
    src = rng.integers(0, num_nodes, size=n_edges)
    jump = rng.geometric(1.0 / locality, size=n_edges)
    dst = (src + jump) % num_nodes
    keep = src != dst
    return src[keep].astype(np.int32), dst[keep].astype(np.int32)


def positional_bench_graph(num_nodes: int, avg_degree: float = 6.0,
                           seed: int = 0, read_len: int = 20_000,
                           false_frac: float = 0.15):
    """Assembly-shaped graph WITH positional ground truth (read_start/end/
    strand/chr) at arbitrary scale, fully vectorised — for benchmarking the
    GT-label sweep (reference utils/labels.py:129-179) where
    ``synthetic_assembly_graph``'s per-read Python loop would dominate.

    Returns (src, dst, read_strand, read_start, read_end, read_chr)."""
    n_reads = num_nodes // 2
    k = max(1, int(round(avg_degree / 2)))   # true successor links per read
    genome_len = max(read_len + 1, int(n_reads * read_len / (k + 1)))
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.integers(0, max(1, genome_len - read_len), n_reads))
    ends = np.minimum(starts + read_len, genome_len)
    strands = rng.choice(np.asarray([1, -1], dtype=np.int8), n_reads)
    node_fwd = (2 * np.arange(n_reads, dtype=np.int64)
                + (strands == -1)).astype(np.int64)
    srcs, dsts = [], []
    for j in range(1, 4 * k + 1):
        i = np.arange(n_reads - j, dtype=np.int64)
        m = (starts[i + j] < ends[i]) & (starts[i + j] > starts[i])
        i = i[m]
        if i.size == 0:
            continue
        u, v = node_fwd[i], node_fwd[i + j]
        srcs += [u, v ^ 1]
        dsts += [v, u ^ 1]
    if false_frac > 0:
        n_false = int(false_frac * sum(a.size for a in srcs) / 2)
        u = rng.integers(0, num_nodes, n_false).astype(np.int64)
        v = rng.integers(0, num_nodes, n_false).astype(np.int64)
        keep = (v != u) & (v != (u ^ 1))
        u, v = u[keep], v[keep]
        srcs += [u, v ^ 1]
        dsts += [v, u ^ 1]
    src = np.concatenate(srcs).astype(np.int32)
    dst = np.concatenate(dsts).astype(np.int32)
    read_strand = np.repeat(strands, 2).copy()
    read_strand[1::2] *= -1
    return (src, dst, read_strand,
            np.repeat(starts.astype(np.int64), 2),
            np.repeat(ends.astype(np.int64), 2),
            np.full(num_nodes, 1, dtype=np.int16))


def positional_bench_assembly_graph(num_nodes: int, seed: int = 0,
                                    avg_degree: float = 6.0):
    """``positional_bench_graph`` wrapped into a full labeled AssemblyGraph
    (GT labels from the positional ground truth, read-scale length/prefix/
    overlap heuristics, near-1 similarities) — the shared recipe of the
    product-run and config-4 recorders (scripts/product_train_run.py,
    scripts/config4_route.py), hoisted so both measure the SAME graph."""
    from .container import AssemblyGraph
    from .labels import compute_gt_labels

    src, dst, strand, start, end, chrom = positional_bench_graph(
        num_nodes, avg_degree, seed=seed)
    g = AssemblyGraph(
        num_nodes=num_nodes, src=src, dst=dst,
        read_length=np.repeat(end[::2] - start[::2], 2),
        prefix_length=np.maximum(
            1, (end[src] - start[src]) // 2).astype(np.int64),
        overlap_length=np.maximum(
            1, (end[src] - start[src]) // 3).astype(np.int64))
    g.read_strand, g.read_start, g.read_end, g.read_chr = (
        strand, start, end, chrom)
    g.y = compute_gt_labels(src, dst, strand, start, end, chrom)
    g.overlap_similarity = np.random.default_rng(seed).uniform(
        0.9, 1.0, src.shape[0]).astype(np.float32)
    return g


def random_rc_bench_graph(num_nodes: int, avg_degree: float, seed: int = 0,
                          locality: int = 64):
    """Assembly-shaped AssemblyGraph with the RC-twin invariant (edge u->v
    implies v^1->u^1), for decoder benchmarking: the decode splice walks
    backward through RC space, so plain ``random_bench_graph`` output is not
    decodable.  Node 2i/2i+1 are a strand pair; lengths/prefixes are random
    read-scale values."""
    from .container import AssemblyGraph

    s0, d0 = random_bench_graph(num_nodes // 2, avg_degree, seed=seed,
                                locality=locality)
    src = np.concatenate([2 * s0, 2 * d0 + 1]).astype(np.int32)
    dst = np.concatenate([2 * d0, 2 * s0 + 1]).astype(np.int32)
    e = src.shape[0]
    rng = np.random.default_rng(seed)
    read_len = np.repeat(rng.integers(10_000, 30_000, num_nodes // 2), 2)
    prefix = np.tile(rng.integers(1_000, 15_000, e // 2), 2)
    overlap = np.tile(rng.integers(5_000, 15_000, e // 2), 2)
    return AssemblyGraph(num_nodes=num_nodes, src=src, dst=dst,
                         read_length=read_len.astype(np.int64),
                         prefix_length=prefix.astype(np.int64),
                         overlap_length=overlap.astype(np.int64))
