"""Immutable CPU-side assembly-graph container.

Replaces the reference's ``networkx.DiGraph -> dgl.DGLGraph`` detour plus four
pickled aux dicts (reference graph_parser.py:141,407,585-598) with direct
CSR/COO numpy arrays:

* nodes come in real/virtual reverse-complement pairs: node ``i``'s RC partner
  is always ``i ^ 1`` (reference graph_parser.py:174-181);
* edge ``k`` is ``src[k] -> dst[k]``; edge order is preserved from the GFA so
  edge ids match the reference's DGL edge ids (real edge ``2t``, its RC twin
  ``2t+1``, graph_parser.py:324-326);
* successors come for free from the CSR rows, predecessors from the CSC rows
  — no ``succ``/``pred``/``edges`` pickle dicts needed.

Node attrs: ``read_length`` always; ``read_strand/start/end/chr`` in training
mode (graph_parser.py:387-392).  Edge attrs: ``prefix_length``,
``overlap_length`` always; ``overlap_similarity`` optional; label ``y`` in
training mode (graph_parser.py:378-404).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np

from ..utils.fastx import reverse_complement


@dataclass
class AssemblyGraph:
    num_nodes: int
    src: np.ndarray                 # int32 [E]
    dst: np.ndarray                 # int32 [E]
    read_length: np.ndarray         # int64 [N]
    prefix_length: np.ndarray       # int64 [E]  (can be negative; decode clamps)
    overlap_length: np.ndarray      # int64 [E]
    overlap_similarity: Optional[np.ndarray] = None   # float32 [E]
    y: Optional[np.ndarray] = None                    # float32 [E] GT labels
    read_strand: Optional[np.ndarray] = None          # int8  [N] (+1/-1)
    read_start: Optional[np.ndarray] = None           # int64 [N]
    read_end: Optional[np.ndarray] = None             # int64 [N]
    read_chr: Optional[np.ndarray] = None             # int16 [N]
    _csr: Optional[tuple] = field(default=None, repr=False, compare=False)
    _csc: Optional[tuple] = field(default=None, repr=False, compare=False)

    # ------------------------------------------------------------------ basics
    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.num_nodes).astype(np.float32)

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.num_nodes).astype(np.float32)

    # ----------------------------------------------------------- CSR/CSC views
    def csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(row_ptr [N+1], col [E], eid [E]) grouped by src; replaces the
        ``succ`` + ``edges`` pickle dicts (reference graph_parser.py:585-591)."""
        if self._csr is None:
            order = np.argsort(self.src, kind="stable").astype(np.int64)
            col = self.dst[order]
            row_ptr = np.zeros(self.num_nodes + 1, dtype=np.int64)
            np.cumsum(np.bincount(self.src, minlength=self.num_nodes), out=row_ptr[1:])
            object.__setattr__(self, "_csr", (row_ptr, col, order))
        return self._csr

    def csc(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(col_ptr [N+1], row [E], eid [E]) grouped by dst; replaces ``pred``."""
        if self._csc is None:
            order = np.argsort(self.dst, kind="stable").astype(np.int64)
            row = self.src[order]
            col_ptr = np.zeros(self.num_nodes + 1, dtype=np.int64)
            np.cumsum(np.bincount(self.dst, minlength=self.num_nodes), out=col_ptr[1:])
            object.__setattr__(self, "_csc", (col_ptr, row, order))
        return self._csc

    def successors(self, node: int) -> np.ndarray:
        row_ptr, col, _ = self.csr()
        return col[row_ptr[node]:row_ptr[node + 1]]

    def predecessors(self, node: int) -> np.ndarray:
        col_ptr, row, _ = self.csc()
        return row[col_ptr[node]:col_ptr[node + 1]]

    def edge_id(self, u: int, v: int) -> int:
        """Edge id of u->v (first match; reference keeps one id per pair,
        graph_parser.py:75-79)."""
        row_ptr, col, eid = self.csr()
        lo, hi = row_ptr[u], row_ptr[u + 1]
        for k in range(lo, hi):
            if col[k] == v:
                return int(eid[k])
        raise KeyError((u, v))

    # ------------------------------------------------------------- transforms
    def reverse(self) -> "AssemblyGraph":
        """Reversed graph with identical edge ids/data (the reference calls
        ``dgl.reverse`` once per layer, gated_gcn_full.py:99 — here reversal is
        an O(1) view swap; the model handles direction via a flag)."""
        return replace(self, src=self.dst, dst=self.src, _csr=self._csc, _csc=self._csr)

    def node_subgraph(self, keep_nodes: np.ndarray) -> tuple["AssemblyGraph", np.ndarray, np.ndarray]:
        """Induced subgraph on ``keep_nodes`` (bool mask or index array).

        Returns (subgraph, orig_node_ids, orig_edge_ids) — the ``_ID`` maps of
        ``dgl.node_subgraph(store_ids=True)`` (reference train.py:96,
        inference.py:48).
        """
        if keep_nodes.dtype == np.bool_:
            keep_mask = keep_nodes
        else:
            keep_mask = np.zeros(self.num_nodes, dtype=bool)
            keep_mask[keep_nodes] = True
        orig_nodes = np.nonzero(keep_mask)[0]
        new_id = np.full(self.num_nodes, -1, dtype=np.int64)
        new_id[orig_nodes] = np.arange(orig_nodes.shape[0])
        emask = keep_mask[self.src] & keep_mask[self.dst]
        orig_edges = np.nonzero(emask)[0]

        def take_n(a):
            return None if a is None else a[orig_nodes]

        def take_e(a):
            return None if a is None else a[orig_edges]

        sub = AssemblyGraph(
            num_nodes=int(orig_nodes.shape[0]),
            src=new_id[self.src[orig_edges]].astype(np.int32),
            dst=new_id[self.dst[orig_edges]].astype(np.int32),
            read_length=take_n(self.read_length),
            prefix_length=take_e(self.prefix_length),
            overlap_length=take_e(self.overlap_length),
            overlap_similarity=take_e(self.overlap_similarity),
            y=take_e(self.y),
            read_strand=take_n(self.read_strand),
            read_start=take_n(self.read_start),
            read_end=take_n(self.read_end),
            read_chr=take_n(self.read_chr),
        )
        return sub, orig_nodes, orig_edges

    # -------------------------------------------------------------------- I/O
    def save(self, path: str) -> None:
        arrays = {
            "num_nodes": np.int64(self.num_nodes),
            "src": self.src, "dst": self.dst,
            "read_length": self.read_length,
            "prefix_length": self.prefix_length,
            "overlap_length": self.overlap_length,
        }
        for name in ("overlap_similarity", "y", "read_strand", "read_start",
                     "read_end", "read_chr"):
            v = getattr(self, name)
            if v is not None:
                arrays[name] = v
        tmp = path + ".tmp.npz"
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "AssemblyGraph":
        with np.load(path) as z:
            kw = {k: z[k] for k in z.files if k != "num_nodes"}
            return cls(num_nodes=int(z["num_nodes"]), **kw)


class ReadStore:
    """Node-id -> DNA sequence store.

    The reference pickles a dict with both strands' strings (graph_parser.py:
    183-184, 588) — 2x the bases.  Here only real (even) nodes are stored as one
    contiguous byte blob + offsets; virtual (odd) nodes are reverse-complemented
    on access (invariant: node ``i^1`` is the RC of node ``i``).
    """

    def __init__(self, blob: bytes, offsets: np.ndarray):
        self._blob = blob
        self._offsets = offsets  # int64 [num_reads+1]

    @classmethod
    def from_sequences(cls, seqs: list[str]) -> "ReadStore":
        """``seqs[t]`` is the sequence of real node ``2t``."""
        offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
        for i, s in enumerate(seqs):
            offsets[i + 1] = offsets[i] + len(s)
        blob = "".join(seqs).encode("ascii")
        return cls(blob, offsets)

    def __len__(self) -> int:
        return 2 * (len(self._offsets) - 1)

    def get(self, node: int) -> str:
        t = node >> 1
        s = self._blob[self._offsets[t]:self._offsets[t + 1]].decode("ascii")
        return s if node % 2 == 0 else reverse_complement(s)

    def length(self, node: int) -> int:
        t = node >> 1
        return int(self._offsets[t + 1] - self._offsets[t])

    def save(self, path: str) -> None:
        tmp = path + ".tmp.npz"
        np.savez_compressed(tmp, blob=np.frombuffer(self._blob, dtype=np.uint8),
                            offsets=self._offsets)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "ReadStore":
        with np.load(path) as z:
            return cls(z["blob"].tobytes(), z["offsets"])
