"""Device-resident graph for GPU message passing.

The PyTorch counterpart of ``gnnome_tpu/ops/graph_tensors.py`` (``GraphTensors``)
without any of its TPU layout work: no padding, no dummy node, no masks, no
window plans and no shape buckets.  Edges live in *slot order*: a stable sort
by dst (the same order as ``GraphTensors.build``, graph_tensors.py:142-146),
so every per-edge array has exactly E rows and the slots of node i's
incoming edges are the contiguous range ``dst_ptr[i]:dst_ptr[i+1]``.  A
stable src-sorted permutation of the slots with its own row pointers gives
each node's outgoing edges, and ``src_nbr`` the dst of each edge in that
order, so a kernel walking a node's out-edges finds each partner node with
one contiguous load.  Reductions into nodes walk these sorted segments in a
fixed order, so results are bitwise reproducible (no float atomics).

All index arrays are ``int32`` on the chosen device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


class _Permute(torch.autograd.Function):
    """``x[idx]`` for a permutation ``idx`` with inverse ``inverse``; the
    backward is the inverse gather (autograd's own would be an
    ``index_add_``, atomic on the card)."""

    @staticmethod
    def forward(ctx, x, idx, inverse):
        ctx.inverse = inverse
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, d):
        return d.index_select(0, ctx.inverse), None, None


def _row_ptr(keys: np.ndarray, n: int) -> np.ndarray:
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(keys, minlength=n), out=ptr[1:])
    return ptr


@dataclass(frozen=True)
class DeviceGraph:
    src: torch.Tensor           # int32 [E] slot order
    dst: torch.Tensor           # int32 [E] slot order, ascending
    slot_of_eid: torch.Tensor   # int32 [E]: slot holding host edge id k
    eid_of_slot: torch.Tensor   # int32 [E]: host edge id in slot s
    dst_ptr: torch.Tensor       # int32 [N+1]: in-edges of i = slots dst_ptr[i]:dst_ptr[i+1]
    src_perm: torch.Tensor      # int32 [E]: slots stably sorted by src
    src_ptr: torch.Tensor       # int32 [N+1]: out-edges of i = src_perm[src_ptr[i]:src_ptr[i+1]]
    src_nbr: torch.Tensor       # int32 [E]: dst[src_perm], the partner of each out-edge
    n_nodes: int
    n_edges: int

    @classmethod
    def build(cls, src: np.ndarray, dst: np.ndarray, n_nodes: int,
              device="cpu") -> "DeviceGraph":
        """From host COO arrays in host edge-id order."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        E = int(src.shape[0])
        if E >= 2 ** 31 or n_nodes >= 2 ** 31:
            raise ValueError(f"int32 indices: E={E}, N={n_nodes} too large")
        if E and (min(src.min(), dst.min()) < 0
                  or max(src.max(), dst.max()) >= n_nodes):
            raise ValueError("edge endpoint out of range [0, n_nodes)")
        order = np.argsort(dst, kind="stable")            # eid per slot
        slot_of_eid = np.empty(E, dtype=np.int64)
        slot_of_eid[order] = np.arange(E)
        src_s, dst_s = src[order], dst[order]
        src_perm = np.argsort(src_s, kind="stable")

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                                   device=device)

        return cls(src=t(src_s), dst=t(dst_s), slot_of_eid=t(slot_of_eid),
                   eid_of_slot=t(order), dst_ptr=t(_row_ptr(dst_s, n_nodes)),
                   src_perm=t(src_perm), src_ptr=t(_row_ptr(src_s, n_nodes)),
                   src_nbr=t(dst_s[src_perm]),
                   n_nodes=int(n_nodes), n_edges=E)

    @classmethod
    def from_graph(cls, graph, device="cpu") -> "DeviceGraph":
        return cls.build(graph.src, graph.dst, graph.num_nodes, device)

    def roles(self, flip: bool):
        """Endpoint roles ``(u_idx, v_idx, (v_ptr, v_perm, v_nbr),
        (u_ptr, u_perm, u_nbr))``: u = src and v = dst, or swapped under
        ``flip`` (the reversed-graph pass).  ``*_ptr``/``*_perm`` list each
        node's edges in that role, ``perm`` None meaning the identity (the
        dst side: slots are dst-sorted); ``*_nbr`` is the other endpoint of
        each listed edge, in the same order (``v_nbr[k] = u_idx[v_perm[k]]``)."""
        by_dst = (self.dst_ptr, None, self.src)
        by_src = (self.src_ptr, self.src_perm, self.src_nbr)
        if flip:
            return self.dst, self.src, by_src, by_dst
        return self.src, self.dst, by_dst, by_src

    def edges_to_slots(self, x: torch.Tensor) -> torch.Tensor:
        """Host-edge-order [E, ...] -> slot order."""
        return _Permute.apply(x, self.eid_of_slot, self.slot_of_eid)

    def slots_to_edges(self, x: torch.Tensor) -> torch.Tensor:
        """Slot order [E, ...] -> host edge order."""
        return _Permute.apply(x, self.slot_of_eid, self.eid_of_slot)
