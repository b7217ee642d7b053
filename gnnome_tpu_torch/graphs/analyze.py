"""Walk-validity diagnostics (reference utils/analyze.py:1-56).

Checks decoded walks against ground-truth node attributes (training graphs
only).  Unlike the reference's print-only helpers these return the violation
lists so tests can assert on them; ``verbose=True`` reproduces the prints.
"""
from __future__ import annotations

import numpy as np


def assert_strand(graph, walk, verbose: bool = False) -> list[int]:
    """Positions where the walk changes strand (reference analyze.py:1-9)."""
    walk = np.asarray(walk)
    strands = graph.read_strand[walk]
    bad = np.nonzero(strands != strands[0])[0].tolist()
    if verbose:
        for idx in bad:
            print("-" * 20)
            print(f"walk index: {idx}\nnode index: {walk[idx]}")
    return bad


def assert_chromosome(graph, walk, verbose: bool = False) -> list[int]:
    """Positions where the walk changes chromosome (analyze.py:11-19)."""
    walk = np.asarray(walk)
    chrs = graph.read_chr[walk]
    bad = np.nonzero(chrs != chrs[0])[0].tolist()
    if verbose:
        for idx in bad:
            print("-" * 20)
            print(f"walk index: {idx}\nnode index: {walk[idx]}")
    return bad


def assert_overlap(graph, walk, verbose: bool = False) -> list[int]:
    """Consecutive pairs that do not genuinely overlap (analyze.py:21-38)."""
    walk = np.asarray(walk)
    src, dst = walk[:-1], walk[1:]
    s_start, s_end = graph.read_start[src], graph.read_end[src]
    d_start, d_end = graph.read_start[dst], graph.read_end[dst]
    s_str, d_str = graph.read_strand[src], graph.read_strand[dst]
    bad_pos = (s_str == 1) & (d_str == 1) & (d_start > s_end)
    bad_neg = (s_str == -1) & (d_str == -1) & (d_end < s_start)
    bad = np.nonzero(bad_pos | bad_neg)[0].tolist()
    if verbose:
        for idx in bad:
            print("-" * 20)
            print(f"walk index: {idx}\nnodes not connected: {src[idx]}, {dst[idx]}")
    return bad


def print_graph_info(idx, graph) -> None:
    """reference analyze.py:41-46."""
    print("\n---- GRAPH INFO ----")
    print("Graph index:", idx)
    print("Number of nodes:", graph.num_nodes)
    print("Number of edges:", graph.num_edges)


def interval_union(graph) -> list[list[int]]:
    """Union of forward-strand read intervals (reference utils/labels.py:5-20)
    — the genome coverage achievable from this graph's reads."""
    sel = graph.read_strand == 1
    starts = graph.read_start[sel]
    ends = graph.read_end[sel]
    order = np.argsort(starts, kind="stable")
    result: list[list[int]] = []
    for s, e in zip(starts[order].tolist(), ends[order].tolist()):
        if result and s <= result[-1][1]:
            result[-1][1] = max(result[-1][1], e)
        else:
            result.append([s, e])
    return result


def print_pairwise(graph, path: str) -> None:
    """Graphia-compatible pairwise TXT export (reference graph_parser.py:82-98,
    written during dataset processing, graph_dataset.py:135-136)."""
    with open(path, "w") as f:
        for u, v in zip(graph.src.tolist(), graph.dst.tolist()):
            f.write(f"{u}\t{v}\n")
