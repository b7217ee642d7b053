"""GFA -> AssemblyGraph parser.

Array-based redesign of reference ``graph_parser.only_from_gfa``
(graph_parser.py:120-600): same graph semantics — every read becomes a
real/virtual RC node pair (``i`` / ``i^1``, graph_parser.py:174-181), every GFA
``L`` link becomes a real edge and its RC-twin edge (graph_parser.py:300-326),
with ``prefix_length = src_len - ol_len`` and shared ``overlap_length`` between
twins (graph_parser.py:336-340) — but built directly into numpy COO arrays with
a packed ReadStore, skipping the networkx -> DGL detour entirely.

Supported GFA dialects (graph_parser.py:275-288):
  * raven:    ``L id1 o1 id2 o2 cigar``           (6 fields)
  * hifiasm:  ``L id1 o1 id2 o2 cigar x``          (7 fields, ids carry ranges)
  * hifiasm': ``L id1 o1 id2 o2 cigar x x``        (8 fields)
Unitig ``S`` records followed by ``A`` lines (hifiasm ``utg``) are collapsed
with majority-vote strand/chr and min/max positions (graph_parser.py:189-266).

Edge id order: edges grouped by src node (stable within a node by L-line
order), matching ``dgl.from_networkx`` iteration order so per-edge arrays are
directly comparable with the reference pipeline.

Memory: the file is STREAMED (two sequential passes — S/A records, then L
records), sequences are packed into the byte blob as they arrive, and edges
accumulate in flat ``array`` buffers deduplicated with one vectorised numpy
pass at the end — peak RSS is O(graph), not O(file-as-line-list).  (The
reference slurps the file and builds a networkx DiGraph: graph_parser.py:
139-151.)
"""
from __future__ import annotations

import re
from array import array
from collections import Counter
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..utils.fastx import read_fastx, detect_filetype, parse_training_header
from .container import AssemblyGraph, ReadStore
from .labels import compute_gt_labels
from .similarity import overlap_similarities

_HIFIASM_ID_RE = re.compile(r"(.*):\d-\d*")
_CIGAR_RE = re.compile(r"^(\d+)M$")


class GFAFormatError(ValueError):
    """Malformed/truncated GFA input, with file position context.  The
    reference crashes with bare unpack/KeyError on such input
    (graph_parser.py:153-341); a truncated download or a mid-write snapshot
    should fail with a diagnosable message instead."""


def _fail(path: str, lineno: int, raw: str, msg: str):
    snippet = raw.rstrip("\n")
    if len(snippet) > 120:
        snippet = snippet[:117] + "..."
    raise GFAFormatError(f"{path}:{lineno}: {msg} (line: {snippet!r})")


@dataclass
class ParsedGraph:
    graph: AssemblyGraph
    reads: ReadStore
    read_to_node: dict            # read id -> (real, virt) node pair
    node_to_read: dict            # node -> read id (or list of (id, orient))


def parse_gfa(gfa_path: str, reads_path: Optional[str] = None,
              training: bool = False, get_similarities: bool = False,
              n_threads: Optional[int] = None) -> ParsedGraph:
    if training and reads_path is None:
        raise ValueError("training=True requires reads_path with position annotations "
                         "(reference graph_parser.py:136-138)")

    read_headers: dict[str, str] = {}
    if training:
        read_headers = {r.id: r.description
                        for r in read_fastx(reads_path, detect_filetype(reads_path))}

    blob = bytearray()                    # packed real-node sequences
    offsets = array("q", [0])             # blob offsets, one per read
    missing_seq: list[int] = []           # read indices t with '*' sequence
    node_lengths = array("q")             # per read (pair shares length)
    read_to_node: dict = {}
    read_to_node2: dict = {}
    node_to_read: dict = {}

    strands = array("b")
    starts = array("q")
    ends = array("q")
    chrs = array("h")

    # ------------------------------------------------------- S/A pass (stream)
    # An S record's unitig 'A' lines follow it; training attributes for a
    # record are finalised when the next non-A line (or EOF) arrives.
    pending: Optional[tuple[str, int, list]] = None

    def _finalize():
        nonlocal pending
        if pending is None:
            return
        rid, t, ids = pending
        pending = None
        if ids:
            node_to_read[2 * t] = ids
            node_to_read[2 * t + 1] = ids
        def _header(id_r):
            try:
                return read_headers[id_r]
            except KeyError:
                raise GFAFormatError(
                    f"{gfa_path}: GFA references read {id_r!r} but "
                    f"{reads_path} has no record with that id") from None

        if training:
            if not ids:
                strand, start, end, chrom = parse_training_header(_header(rid))
            else:
                # collapse multi-read unitig (graph_parser.py:231-266)
                c_strands, c_starts, c_ends, c_chrs = [], [], [], []
                for id_r, id_o in ids:
                    s_f, st, en, ch = parse_training_header(_header(id_r))
                    s_g = 1 if id_o == "+" else -1
                    c_strands.append(s_f * s_g)
                    c_starts.append(st)
                    c_ends.append(en)
                    c_chrs.append(ch)
                strand = 1 if sum(c_strands) >= 0 else -1
                start, end = min(c_starts), max(c_ends)
                chrom = Counter(c_chrs).most_common()[0][0]
            strands.extend((strand, -strand))
            starts.extend((start, start))
            ends.extend((end, end))
            chrs.extend((chrom, chrom))

    with open(gfa_path) as f:
        for lineno, raw in enumerate(f, 1):
            head = raw[0] if raw else ""
            if head == "A":
                if pending is not None and pending[2] is not None:
                    aline = raw.split()
                    if len(aline) < 5:
                        _fail(gfa_path, lineno, raw,
                              f"A record needs >=5 fields, got {len(aline)}")
                    utg_to_read, read_orientation = aline[4], aline[3]
                    pending[2].append((utg_to_read, read_orientation))
                    t = pending[1]
                    read_to_node2[utg_to_read] = (2 * t, 2 * t + 1)
                continue
            _finalize()
            if head != "S":
                continue
            line = raw.split()
            if len(line) < 4:
                _fail(gfa_path, lineno, raw,
                      f"S record needs 4 fields (id, seq, LN tag), "
                      f"got {len(line)} — truncated file?")
            _, rid, sequence, length = line[:4]
            if not length.startswith("LN:i:"):
                _fail(gfa_path, lineno, raw,
                      f"S record field 4 must be an LN:i: tag, got {length!r}")
            try:
                length = int(length[5:])
            except ValueError:
                _fail(gfa_path, lineno, raw, f"bad LN tag value {length!r}")

            t = len(node_lengths)
            real_idx, virt_idx = 2 * t, 2 * t + 1
            read_to_node[rid] = (real_idx, virt_idx)
            node_to_read[real_idx] = rid
            node_to_read[virt_idx] = rid
            node_lengths.append(length)
            if sequence == "*":
                missing_seq.append(t)
                offsets.append(offsets[-1])
            else:
                blob += sequence.encode("ascii")
                offsets.append(len(blob))
            # A lines are only attached to unitig records (graph_parser.py:189)
            pending = (rid, t, [] if rid.startswith("utg") else None)
    _finalize()

    num_reads = len(node_lengths)
    num_nodes = 2 * num_reads

    # -------------------------------------------------------- L pass (stream)
    e_src = array("i")
    e_dst = array("i")
    e_ol = array("q")

    with open(gfa_path) as f:
        for lineno, raw in enumerate(f, 1):
            if not raw or raw[0] != "L":
                continue
            line = raw.split()
            if len(line) == 6:                  # raven / GFA-1
                _, id1, o1, id2, o2, cigar = line
            elif len(line) == 7:                # hifiasm (ids carry :start-end)
                _, id1, o1, id2, o2, cigar, _x = line
                m1 = _HIFIASM_ID_RE.findall(id1)
                m2 = _HIFIASM_ID_RE.findall(id2)
                if not m1 or not m2:
                    _fail(gfa_path, lineno, raw,
                          "7-field L record ids must carry ':start-end' "
                          "ranges (hifiasm dialect)")
                id1, id2 = m1[0], m2[0]
            elif len(line) == 8:                # newer hifiasm
                _, id1, o1, id2, o2, cigar, _x, _y = line
            else:
                _fail(gfa_path, lineno, raw,
                      f"L record with {len(line)} fields (expected 6/7/8) "
                      "— unknown dialect or truncated file?")
            if o1 not in ("+", "-") or o2 not in ("+", "-"):
                _fail(gfa_path, lineno, raw,
                      f"L record orientations must be +/-, got {o1!r}/{o2!r}")
            m = _CIGAR_RE.match(cigar)
            if m is None:
                _fail(gfa_path, lineno, raw,
                      f"L record overlap must be a '<n>M' cigar, got {cigar!r}")
            ol_length = int(m.group(1))
            if ol_length == 0:                  # degenerate (graph_parser.py:297)
                continue
            try:
                n1, n2 = read_to_node[id1], read_to_node[id2]
            except KeyError as e:
                _fail(gfa_path, lineno, raw,
                      f"L record references unknown segment {e.args[0]!r} "
                      "(no S record)")
            if o1 == "+":
                if o2 == "+":
                    src_real, dst_real, src_virt, dst_virt = n1[0], n2[0], n2[1], n1[1]
                else:
                    src_real, dst_real, src_virt, dst_virt = n1[0], n2[1], n2[0], n1[1]
            else:
                if o2 == "+":
                    src_real, dst_real, src_virt, dst_virt = n1[1], n2[0], n2[1], n1[0]
                else:
                    src_real, dst_real, src_virt, dst_virt = n1[1], n2[1], n2[0], n1[0]
            e_src.append(src_real)
            e_dst.append(dst_real)
            e_ol.append(ol_length)
            e_src.append(src_virt)
            e_dst.append(dst_virt)
            e_ol.append(ol_length)

    src = np.frombuffer(e_src, dtype=np.int32).copy()
    dst = np.frombuffer(e_dst, dtype=np.int32).copy()
    ol = np.frombuffer(e_ol, dtype=np.int64).copy()
    del e_src, e_dst, e_ol

    # deduplicate repeated (u, v) pairs: first-occurrence order, last-wins
    # attributes — networkx add_edge semantics (graph_parser.py:321-340) —
    # in one vectorised pass instead of a per-edge Python dict
    if src.size:
        keys = src.astype(np.int64) * num_nodes + dst
        uniq, first_idx = np.unique(keys, return_index=True)
        if uniq.shape[0] != keys.shape[0]:
            by_key = np.argsort(keys, kind="stable")
            last_idx = by_key[np.searchsorted(keys[by_key], uniq, side="right") - 1]
            occ = np.argsort(first_idx)
            src, dst, ol = src[first_idx[occ]], dst[first_idx[occ]], ol[last_idx[occ]]

    # canonical edge order: grouped by src (stable), see module docstring
    order = np.argsort(src, kind="stable")
    src, dst, ol = src[order], dst[order], ol[order]

    # ------------------------------------------------------------- sequences
    if missing_seq:
        if reads_path is None:
            raise ValueError("GFA has no sequences ('*') and no reads_path given")
        need: dict[str, int] = {}
        for t in missing_seq:
            rid = node_to_read[2 * t]
            if isinstance(rid, list):
                raise ValueError("'*' sequences with unitig graphs need the "
                                 "GFA to carry unitig sequences")
            need[rid] = t
        seq_of_t: dict[int, str] = {}
        for r in read_fastx(reads_path):
            t = need.pop(r.id, None)
            if t is not None:
                seq_of_t[t] = r.seq
        # splice the fetched sequences into the packed blob in read order
        new_blob = bytearray()
        new_offsets = array("q", [0])
        for t in range(num_reads):
            if t in seq_of_t:
                new_blob += seq_of_t.pop(t).encode("ascii")
            else:
                new_blob += blob[offsets[t]:offsets[t + 1]]
            new_offsets.append(len(new_blob))
        blob, offsets = new_blob, new_offsets
    reads = ReadStore(bytes(blob),
                      np.frombuffer(offsets, dtype=np.int64).copy())
    del blob

    read_length_pairs = np.frombuffer(node_lengths, dtype=np.int64)
    read_length = np.repeat(read_length_pairs, 2)
    prefix_length = read_length[src] - ol

    graph = AssemblyGraph(
        num_nodes=num_nodes, src=src, dst=dst,
        read_length=read_length, prefix_length=prefix_length, overlap_length=ol,
    )

    if training:
        graph.read_strand = np.asarray(strands, dtype=np.int8)
        graph.read_start = np.asarray(starts, dtype=np.int64)
        graph.read_end = np.asarray(ends, dtype=np.int64)
        graph.read_chr = np.asarray(chrs, dtype=np.int16)
        graph.y = compute_gt_labels(src, dst, graph.read_strand,
                                    graph.read_start, graph.read_end,
                                    graph.read_chr)

    if get_similarities:
        graph.overlap_similarity = overlap_similarities(src, dst, ol, reads,
                                                        n_threads=n_threads)

    if read_to_node2:
        read_to_node = read_to_node2

    return ParsedGraph(graph=graph, reads=reads,
                       read_to_node=read_to_node, node_to_read=node_to_read)
