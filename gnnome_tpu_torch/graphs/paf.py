"""PAF overlap parsing and per-edge overlap info.

Functional port of the reference's dormant PAF path (graph_parser.py:417-583,
gated off by ``read_paf=False``): when the assembler also emits pairwise
overlaps (hifiasm ``--write-paf``, graph_dataset.py:113-117), each graph edge
can be annotated with the precise overlap coordinates on both reads,
orientation-normalised to the edge's src->dst direction.

Kept as an optional feature-engineering hook, same as in the reference; the
shipped models do not consume it.
"""
from __future__ import annotations

import numpy as np


def parse_paf(paf_path: str) -> dict:
    """(query_id, target_id) -> (q_len, q_start, q_end, strand, t_len,
    t_start, t_end) (reference graph_parser.py:420-428)."""
    paf = {}
    with open(paf_path) as f:
        for line in f:
            p = line.split()
            if len(p) < 9:
                continue
            q, q_len, q_start, q_end = p[0], int(p[1]), int(p[2]), int(p[3])
            strand = p[4]
            t, t_len, t_start, t_end = p[5], int(p[6]), int(p[7]), int(p[8])
            paf[(q, t)] = (q_len, q_start, q_end, strand, t_len, t_start, t_end)
    return paf


def _flip_interval(length, start, end):
    return length, length - end, length - start


def _orient_overlap(overlap, src_strand, dst_strand):
    """Normalise a PAF overlap record to the edge's strand orientation
    (reference graph_parser.py:526-556)."""
    l1, s1, e1, sign, l2, s2, e2 = overlap
    if src_strand == 1 and dst_strand == 1:
        return overlap
    if src_strand == -1 and dst_strand == 1:
        l1, s1, e1 = _flip_interval(l1, s1, e1)
        return (l1, s1, e1, sign, l2, s2, e2)
    if src_strand == 1 and dst_strand == -1:
        l2, s2, e2 = _flip_interval(l2, s2, e2)
        return (l1, s1, e1, sign, l2, s2, e2)
    l1, s1, e1 = _flip_interval(l1, s1, e1)
    l2, s2, e2 = _flip_interval(l2, s2, e2)
    return (l1, s1, e1, sign, l2, s2, e2)


def _reads_of(node_to_read, node):
    r = node_to_read[node]
    if isinstance(r, list):
        return r
    return [(r, "+")]


def edge_paf_info(graph, paf: dict, node_to_read: dict) -> dict:
    """(src, dst) -> (src_len, src_start, src_end, dst_len, dst_start,
    dst_end) for every edge (reference graph_parser.py:430-583).

    Looks up the PAF record for the edge's reads in either direction
    (overlaps are not always symmetric in PAF, graph_parser.py:445-450),
    orientation-normalises it, then applies the suffix-prefix sanity fix:
    records that describe a prefix-suffix overlap are replaced by the
    RC-twin edge's record flipped (graph_parser.py:560-583).
    """
    info = {}
    for src, dst in zip(graph.src.tolist(), graph.dst.tolist()):
        found = None
        so_found = do_found = "+"
        for sr, so in _reads_of(node_to_read, src):
            if found:
                break
            for dr, do in _reads_of(node_to_read, dst):
                if (sr, dr) in paf:
                    found, so_found, do_found = paf[(sr, dr)], so, do
                    break
                if (dr, sr) in paf:
                    o = paf[(dr, sr)]
                    # swap query/target roles (graph_parser.py:448-450)
                    found = o[4:] + o[3:4] + o[:3]
                    so_found, do_found = so, do
                    break
        if found is None:
            continue
        ss = 1 if src % 2 == 0 else -1
        ds = 1 if dst % 2 == 0 else -1
        so_i = 1 if so_found == "+" else -1
        do_i = 1 if do_found == "+" else -1
        ov = _orient_overlap(tuple(found), ss * so_i, ds * do_i)
        info[(src, dst)] = (ov[0], ov[1], ov[2], ov[4], ov[5], ov[6])

    # suffix-prefix sanity fix via the RC twin (graph_parser.py:560-583)
    fixed = {}
    for (src, dst), ov in info.items():
        src_len, src_start, src_end, dst_len, dst_start, dst_end = ov
        if src_end < 0.99 * src_len or dst_start > 0.01 * dst_len:
            twin = info.get((dst ^ 1, src ^ 1))
            if twin is not None:
                tl1, ts1, te1, tl2, ts2, te2 = twin
                fixed[(src, dst)] = (tl2, tl2 - te2, tl2 - ts2,
                                     tl1, tl1 - te1, tl1 - ts1)
                continue
        fixed[(src, dst)] = ov
    return fixed
