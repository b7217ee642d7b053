"""Ground-truth edge labels from simulated-read positions.

Array/CSR reimplementation of reference ``utils/labels.py``:

* an edge is a *candidate true overlap* iff the two reads genuinely overlap on
  the same strand and chromosome (labels.py:80-93);
* per strand (and per chromosome for multi-chromosome graphs), a greedy sweep
  finds DFS-reachable components that extend genome coverage and marks their
  induced edges ``y=1`` (labels.py:23-71,129-179); everything else is 0.

The networkx DiGraph + ``dfs_postorder_nodes`` machinery is replaced by plain
adjacency lists and iterative reachability — same accepted edge sets, orders of
magnitude less memory/time on chromosome-scale graphs.
"""
from __future__ import annotations

import numpy as np


def _build_adj(src: np.ndarray, dst: np.ndarray, nodes: np.ndarray):
    """Forward and reverse adjacency dict-of-arrays for a small subgraph."""
    fwd: dict[int, list[int]] = {int(n): [] for n in nodes}
    rev: dict[int, list[int]] = {int(n): [] for n in nodes}
    for u, v in zip(src.tolist(), dst.tolist()):
        fwd[u].append(v)
        rev[v].append(u)
    return fwd, rev


def _reachable(adj: dict[int, list[int]], source: int, allowed: set[int]) -> set[int]:
    """Nodes reachable from ``source`` through ``allowed`` nodes (source incl.).

    Matches ``set(nx.dfs_postorder_nodes(graph.subgraph(allowed), source))``
    + source (reference labels.py:43-44,51-52): the visited set of a DFS.
    """
    seen = {source}
    stack = [source]
    while stack:
        u = stack.pop()
        for v in adj[u]:
            if v in allowed and v not in seen:
                seen.add(v)
                stack.append(v)
    return seen


def _gt_for_single_strand(src: np.ndarray, dst: np.ndarray,
                          read_start: np.ndarray, read_end: np.ndarray,
                          positive: bool) -> np.ndarray:
    """Boolean mask over the given edges: True where the edge belongs to a
    coverage-extending component (reference labels.py:23-71).

    ``src``/``dst`` are the strand-filtered candidate edges.  The sweep runs
    natively over a relabelled CSR (O(V log V + E), gn_gt_sweep); this
    Python set/DFS loop is the fallback/oracle (tests pin equality).
    """
    keep = np.zeros(src.shape[0], dtype=bool)
    if src.shape[0] == 0:
        return keep

    nodes = np.unique(np.concatenate([src, dst]))
    native = _gt_single_strand_native(src, dst, nodes, read_start, read_end,
                                      positive)
    if native is not None:
        return native
    fwd, rev = _build_adj(src, dst, nodes)
    start_of = {int(n): int(read_start[n]) for n in nodes}
    end_of = {int(n): int(read_end[n]) for n in nodes}

    node_list = nodes.tolist()
    if positive:
        final_node = max(node_list, key=lambda x: end_of[x])
        highest_reached = min(node_list, key=lambda x: end_of[x])
    else:
        final_node = min(node_list, key=lambda x: start_of[x])
        highest_reached = max(node_list, key=lambda x: start_of[x])

    all_nodes = set(node_list)
    accepted: list[set[int]] = []
    # key ties broken by smallest node id, matching the native gn_gt_sweep
    # (set iteration order is arbitrary, so a bare min/max could legitimately
    # diverge from the pinned-equality oracle on equal read_start/read_end)
    while all_nodes:
        if positive:
            start_node = min(all_nodes, key=lambda x: (start_of[x], x))
        else:
            start_node = max(all_nodes, key=lambda x: (end_of[x], -x))

        full_component = _reachable(fwd, start_node, all_nodes)
        if positive:
            highest_in_comp = max(full_component,
                                  key=lambda x: (end_of[x], -x))
        else:
            highest_in_comp = min(full_component,
                                  key=lambda x: (start_of[x], x))

        component = _reachable(rev, highest_in_comp, full_component)

        not_reached_highest = (
            (positive and end_of[highest_in_comp] < end_of[highest_reached])
            or (not positive and start_of[highest_in_comp] > start_of[highest_reached])
        )
        if len(component) < 2 or not_reached_highest:
            all_nodes -= full_component
            continue
        highest_reached = highest_in_comp
        accepted.append(component)
        if highest_reached == final_node:
            break
        all_nodes -= full_component

    for component in accepted:
        in_comp = np.fromiter((u in component for u in src.tolist()), dtype=bool,
                              count=src.shape[0])
        in_comp &= np.fromiter((v in component for v in dst.tolist()), dtype=bool,
                               count=dst.shape[0])
        keep |= in_comp
    return keep


def _gt_single_strand_native(src, dst, nodes, read_start, read_end,
                             positive: bool):
    """Native CSR sweep (gn_gt_sweep): relabel the candidate subgraph to
    0..m-1, run the coverage sweep in C++, keep edges whose endpoints share
    an accepted component.  Returns None when the library is unavailable.

    The negative strand mirrors the positive one under key negation:
    min-by-start / max-by-end become min-by(-end) / max-by(-start)."""
    from ..native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    m = nodes.shape[0]
    s_loc = np.searchsorted(nodes, src).astype(np.int32)
    d_loc = np.searchsorted(nodes, dst).astype(np.int32)

    def _csr(u, v):
        order = np.argsort(u, kind="stable")
        col = np.ascontiguousarray(v[order], dtype=np.int32)
        ptr = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(np.bincount(u, minlength=m), out=ptr[1:])
        return ptr, col

    fptr, fcol = _csr(s_loc, d_loc)
    rptr, rcol = _csr(d_loc, s_loc)
    start = np.ascontiguousarray(read_start[nodes], dtype=np.int64)
    end = np.ascontiguousarray(read_end[nodes], dtype=np.int64)
    if positive:
        key_sweep, key_high = start, end
    else:
        key_sweep, key_high = (np.ascontiguousarray(-end),
                               np.ascontiguousarray(-start))
    comp_id = np.empty(m, dtype=np.int32)
    lib.gn_gt_sweep(fptr, fcol, rptr, rcol, key_sweep, key_high, m, comp_id)
    cs, cd = comp_id[s_loc], comp_id[d_loc]
    return (cs >= 0) & (cs == cd)


def compute_gt_labels(src: np.ndarray, dst: np.ndarray,
                      read_strand: np.ndarray, read_start: np.ndarray,
                      read_end: np.ndarray, read_chr: np.ndarray) -> np.ndarray:
    """Per-edge float32 labels ``y`` (reference labels.py:129-179).

    Candidate filter (labels.py:80-93): positive-strand edges require
    ``start[src] < start[dst] < end[src]`` with both strands +1 and equal chr;
    negative-strand edges the mirrored condition.  Per chromosome, each strand
    is processed independently (``process_graph_combo``, labels.py:152-179;
    single-chromosome graphs reduce to ``process_graph``, labels.py:129-149).
    """
    s, d = src.astype(np.int64), dst.astype(np.int64)
    pos_cand = (
        (read_start[d] < read_end[s]) & (read_start[d] > read_start[s])
        & (read_strand[s] == 1) & (read_strand[d] == 1)
        & (read_chr[s] == read_chr[d])
    )
    neg_cand = (
        (read_start[s] < read_end[d]) & (read_start[s] > read_start[d])
        & (read_strand[s] == -1) & (read_strand[d] == -1)
        & (read_chr[s] == read_chr[d])
    )

    y = np.zeros(src.shape[0], dtype=np.float32)
    for chrom in np.unique(read_chr[np.concatenate([s, d])]):
        for cand, positive in ((pos_cand, True), (neg_cand, False)):
            sel = cand & (read_chr[s] == chrom)
            eids = np.nonzero(sel)[0]
            if eids.size == 0:
                continue
            keep = _gt_for_single_strand(s[eids], d[eids], read_start, read_end,
                                         positive=positive)
            y[eids[keep]] = 1.0

    # Membership in gt_edges is by (u, v) pair, not edge id (reference
    # labels.py:143-148): propagate to duplicate parallel edges if any.
    if y.any():
        n_max = int(max(s.max(), d.max())) + 1
        key = s * n_max + d
        pos_keys = np.unique(key[y > 0])
        y[np.isin(key, pos_keys)] = 1.0
    return y
