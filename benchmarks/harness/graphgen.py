"""The traffic's graphs: assembly-shaped overlap graphs with positional
ground truth, made on the host from a seed.

``positional_graph`` is a frozen copy of the port's
``graphs/synthetic.py`` ``positional_bench_graph``: reads of 20 kb at
sorted random positions on one chromosome, each read two nodes (``v`` and
its reverse complement ``v ^ 1``), an edge for each true suffix-prefix
overlap on either strand and about 15% false edges between random reads,
every edge with its twin.  ``labels`` is the candidate test of the port's
``graphs/labels.py`` ``compute_gt_labels`` (the two reads overlap, on the
same strand, in the right order); on this generator's graphs the
coverage sweep that follows it there keeps every candidate (checked at
65,536 nodes, seed 0: no edge differs), so the sweep is left out.

Two departures from the port's recipe
(``positional_bench_assembly_graph``), both in the edge features: the
overlap length is the reads' true overlap where they overlap and a draw
of 1-20 kb for a false edge (there every overlap length was the same
6,666, so its z-score was 0 everywhere), and the similarities are drawn
from the graph's own seed stream.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

READ_LEN = 20_000


def positional_graph(num_nodes: int, seed, avg_degree: float = 6.0,
                     read_len: int = READ_LEN, false_frac: float = 0.15):
    """``(src, dst, read_strand, read_start, read_end)``, the port's
    ``positional_bench_graph`` for one chromosome; ``seed`` an int or a
    list of ints, as ``np.random.default_rng`` takes it."""
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
            np.repeat(ends.astype(np.int64), 2))


def labels(src, dst, strand, start, end) -> np.ndarray:
    """float32 [E]: 1 where the edge is a true overlap on one strand in
    the read order (``compute_gt_labels``'s candidate test)."""
    s, d = src.astype(np.int64), dst.astype(np.int64)
    pos = ((start[d] < end[s]) & (start[d] > start[s])
           & (strand[s] == 1) & (strand[d] == 1))
    neg = ((start[s] < end[d]) & (start[s] > start[d])
           & (strand[s] == -1) & (strand[d] == -1))
    return (pos | neg).astype(np.float32)


@dataclass
class Graph:
    """One traffic graph in host arrays, host edge order."""
    num_nodes: int
    src: np.ndarray                 # int32 [E]
    dst: np.ndarray                 # int32 [E]
    y: np.ndarray                   # float32 [E] labels
    overlap_length: np.ndarray      # int64 [E]
    overlap_similarity: np.ndarray  # float32 [E]
    read_length: np.ndarray         # int64 [N]

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


def make_graph(num_nodes: int, seed, avg_degree: float = 6.0) -> Graph:
    """The positional graph with labels and edge attributes."""
    src, dst, strand, start, end = positional_graph(num_nodes, seed,
                                                    avg_degree)
    s, d = src.astype(np.int64), dst.astype(np.int64)
    rng = np.random.default_rng(np.random.SeedSequence(seed).spawn(1)[0])
    E = src.shape[0]
    true_ov = np.minimum(end[s], end[d]) - np.maximum(start[s], start[d])
    drawn = rng.integers(1_000, READ_LEN, E)
    ol = np.where(true_ov > 0, true_ov, drawn).astype(np.int64)
    sim = rng.uniform(0.9, 1.0, E).astype(np.float32)
    return Graph(num_nodes=num_nodes, src=src, dst=dst,
                 y=labels(src, dst, strand, start, end), overlap_length=ol,
                 overlap_similarity=sim, read_length=end - start)


def graph_seed(run_seed: int, index: int) -> list:
    """The seed words of a run's ``index``-th graph: any whole run seed,
    negative or beyond 64 bits included."""
    return [abs(int(run_seed)), int(run_seed < 0), int(index)]
