"""Graph partitioning for cluster-minibatch training and multi-chip sharding.

Replaces ``dgl.metis_partition(g, k, extra_cached_hops=1)`` (reference
train.py:335,404).  Assembly graphs are near-path-shaped (reads ordered along
the genome), so a contiguous block partition over a BFS/pseudo-genome node
order achieves METIS-quality edge cuts at a fraction of the cost; RC pairs
(``i``, ``i^1``) are always co-assigned, matching the graph's strand symmetry.

Each part is the induced subgraph over its core nodes plus a ``k_hops``
neighbourhood halo (the reference's ``extra_cached_hops``); parent node/edge
id maps are returned exactly like DGL's ``_ID`` fields so features, labels and
gradients can be gathered from the parent graph (train.py:126-135,154).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Partition:
    graph: "object"              # AssemblyGraph of the part (core + halo)
    orig_nodes: np.ndarray       # parent node id per local node (``_ID``)
    orig_edges: np.ndarray       # parent edge id per local edge (``_ID``)
    core_mask: np.ndarray        # bool per local node: core (not halo)


def _bfs_order_pairs(graph) -> np.ndarray:
    """Pair-level BFS order: follows graph connectivity so consecutive pairs
    are topologically close (gives contiguous blocks small boundaries).
    FIFO BFS runs natively (gn_bfs_order; rows 2p and 2p+1 are adjacent in
    the node CSR, so the pair CSR is just every other row pointer) with a
    pure-Python fallback."""
    from ..native import get_lib

    n_pairs = graph.num_nodes // 2
    row_ptr, col, _ = graph.csr()
    lib = get_lib()
    if lib is not None:
        pair_ptr = np.ascontiguousarray(row_ptr[0::2], dtype=np.int64)
        pair_col = np.ascontiguousarray(col >> 1, dtype=np.int32)
        new_of_old = np.empty(n_pairs, dtype=np.int64)
        lib.gn_bfs_order(pair_ptr, pair_col, n_pairs, new_of_old)
        order = np.empty(n_pairs, dtype=np.int64)
        order[new_of_old] = np.arange(n_pairs, dtype=np.int64)
        return order

    from collections import deque

    order = np.empty(n_pairs, dtype=np.int64)
    seen = np.zeros(n_pairs, dtype=bool)
    pos = 0
    for seed in range(n_pairs):
        if seen[seed]:
            continue
        queue = deque([seed])
        seen[seed] = True
        while queue:
            p = queue.popleft()
            order[pos] = p
            pos += 1
            for node in (2 * p, 2 * p + 1):
                for q in col[row_ptr[node]:row_ptr[node + 1]] >> 1:
                    if not seen[q]:
                        seen[q] = True
                        queue.append(int(q))
    return order


def _pair_part_from_order(pair_order: np.ndarray, num_parts: int) -> np.ndarray:
    n_pairs = pair_order.shape[0]
    bounds = np.linspace(0, n_pairs, num_parts + 1).astype(np.int64)
    pair_part = np.empty(n_pairs, dtype=np.int32)
    for p in range(num_parts):
        pair_part[pair_order[bounds[p]:bounds[p + 1]]] = p
    return pair_part


def _cut_fraction(graph, node_part: np.ndarray) -> float:
    if graph.num_edges == 0:
        return 0.0
    return float((node_part[graph.src] != node_part[graph.dst]).mean())


def partition_graph(graph, num_parts: int, k_hops: int = 1,
                    order: str = "auto") -> list[Partition]:
    """Split into ``num_parts`` clusters of contiguous pair blocks + halo.

    ``order``: 'identity' keeps the assembler's node order (genome-coherent
    for hifiasm/raven output — usually the best), 'bfs' orders by graph
    traversal, 'auto' evaluates both and keeps the smaller edge cut.
    """
    if num_parts <= 1:
        sub, nid, eid = graph.node_subgraph(np.ones(graph.num_nodes, dtype=bool))
        return [Partition(sub, nid, eid, np.ones(sub.num_nodes, dtype=bool))]

    n_pairs = graph.num_nodes // 2
    candidates = []
    if order in ("identity", "auto"):
        candidates.append(np.arange(n_pairs, dtype=np.int64))
    if order in ("bfs", "auto"):
        candidates.append(_bfs_order_pairs(graph))
    best = None
    for pair_order in candidates:
        pair_part = _pair_part_from_order(pair_order, num_parts)
        cut = _cut_fraction(graph, np.repeat(pair_part, 2))
        if best is None or cut < best[0]:
            best = (cut, pair_part)
    pair_part = best[1]

    node_part = np.repeat(pair_part, 2)
    parts = []
    csr_ptr, csr_col, _ = graph.csr()
    csc_ptr, csc_row, _ = graph.csc()
    for p in range(num_parts):
        core = node_part == p
        keep = core.copy()
        frontier = core
        for _ in range(k_hops):
            nxt = np.zeros_like(keep)
            idx = np.nonzero(frontier)[0]
            for u in idx:
                nxt[csr_col[csr_ptr[u]:csr_ptr[u + 1]]] = True
                nxt[csc_row[csc_ptr[u]:csc_ptr[u + 1]]] = True
            nxt &= ~keep
            keep |= nxt
            frontier = nxt
        sub, nid, eid = graph.node_subgraph(keep)
        parts.append(Partition(sub, nid, eid, core[nid]))
    return parts


def partition_edge_cut(graph, parts: list[Partition]) -> float:
    """Fraction of parent edges crossing core partitions (diagnostic)."""
    owner = np.full(graph.num_nodes, -1, dtype=np.int32)
    for p, part in enumerate(parts):
        owner[part.orig_nodes[part.core_mask]] = p
    cut = owner[graph.src] != owner[graph.dst]
    return float(cut.mean()) if graph.num_edges else 0.0
