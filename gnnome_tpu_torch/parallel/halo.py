"""Halo-exchange graph parallelism over ``torch.distributed``: the
counterpart of ``gnnome_tpu/parallel/halo.py`` for the batch-norm
SymGatedGCN (eval and training, float32 and bfloat16).

One graph is split over the P ranks of a ``parallel.group.Group``:

* **Blocks.** P contiguous node ranges, cut at even ids (an RC pair ``(i,
  i^1)`` stays together), as equal as possible; a graph with fewer pairs
  than ranks leaves some blocks empty.  Each edge lives with the owner of
  its ``dst``.
* **Strips and overflow.** An edge's ``src`` lies in its rank's block, in
  the last K rows of the left neighbour's block or the first K of the
  right neighbour's (K: the JAX rule, the cheapest ``2K + 4·rows`` over
  the reach quantiles 90 to 100, K at most half the smallest block), or,
  farther away, in the **overflow** rows: the unique far ``src`` nodes,
  shared by every rank through a sum over ranks.
* **The shard graph.** Rank r's rows are ``[left strip | block | right
  strip | overflow]`` (a strip only where a neighbour is: no wrap-around),
  and its edges a ``DeviceGraph`` over those rows.  K3's, K8's and K9's
  node sums are sums over edges, so the kernels run on the shard
  unchanged; the sums that land in strip and overflow rows are partials
  that go home to their owners (``halo_return``) before the gated means
  divide.  The batch statistics (K7's, K8's, the node BatchNorm's) and the
  loss are summed over ranks and divided by the whole graph's counts.
* **The exchange.** ``halo_extend`` (local rows -> extended rows: raw
  d-wide strips from the neighbours, the overflow rows from their owners)
  and ``halo_return`` (its adjoint) are ``torch.autograd.Function``s whose
  backward is the other one; a blocking exchange at each layer's head.
* **The fallback.** A graph with no banded plan in the assembler's order
  or after ``band_order`` takes the same plan with the overflow cap lifted
  (route ``overflow-uncapped``): every far ``src`` row travels through the
  overflow sum.  The JAX package sends such graphs to GSPMD instead; the
  results are the same.

Training sums the ranks' parameter gradients (each rank backwards its own
``sum(per-edge loss) / n_edges``; the loss's sum over ranks stays out of
the autograd graph) and every rank steps the same Adam, so the parameters
stay bitwise equal.  Dropout draws from a per-rank generator.  Each rank's
two directional passes launch 8 K7, 8 K3, 8 K8, 1 K6 and 1 K9 each.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import Config, compute_dtype
from ..models.features import edge_features, node_features
from ..models.nn import dropout, mlp2
from ..models.norm import (BN_EPS, batch_norm_eval, batch_norm_rows,
                           update_running_stats)
from ..models.sym_gated_gcn import GATE_EPS, SymGatedGCN, _linear
from ..models.zoo import SYM_NAMES
from ..ops.graph_tensors import DeviceGraph
from ..ops.kernels import wide
from ..ops.message import eval_edge_stage, train_edge_stage
from ..train.loss import _bce_elementwise
from .group import Group, all_reduce

QUANTILES = (90.0, 99.0, 99.9, 99.99, 100.0)
MAX_K_FRAC = 0.5
MAX_OVF_FRAC = 1.0


# ------------------------------------------------------------------ the plan
@dataclass(frozen=True)
class HaloPlan:
    """Host layout of one graph over ``n_parts`` ranks; every array is
    numpy and the same on every rank.  Edges are listed dst-sorted
    (``order``: host edge ids, a stable sort by dst), so rank r's edges are
    ``order[cuts[r]:cuts[r+1]]``, in its shard graph's slot order; their
    rows in r's extended space are ``src_ext``/``dst_ext`` (same order)."""
    n_parts: int
    n_nodes: int
    bounds: np.ndarray      # int64 [P+1]: rank r owns bounds[r]:bounds[r+1]
    K: int                  # strip rows
    ovf: np.ndarray         # int64 [R]: overflow nodes (global ids, ascending)
    order: np.ndarray       # int64 [E]: host edge ids, dst-sorted
    cuts: np.ndarray        # int64 [P+1]
    src_ext: np.ndarray     # int64 [E]
    dst_ext: np.ndarray     # int64 [E]
    route: str

    @property
    def R(self) -> int:
        return int(self.ovf.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.order.shape[0])

    @property
    def cost(self) -> int:
        """Rows on the wire per exchange, weighted as the JAX planner does
        (a strip row moves twice, an overflow row goes to every rank)."""
        return 2 * self.K + 4 * self.R

    def block(self, r: int) -> tuple[int, int]:
        return int(self.bounds[r]), int(self.bounds[r + 1])

    def strips(self, r: int) -> tuple[int, int]:
        """``(k_left, k_right)``: rank r's strip rows (0 at the ring's
        ends)."""
        return (self.K if r > 0 else 0,
                self.K if r < self.n_parts - 1 else 0)

    def n_ext(self, r: int) -> int:
        lo, hi = self.block(r)
        kl, kr = self.strips(r)
        return kl + (hi - lo) + kr + self.R

    def edges(self, r: int) -> np.ndarray:
        """Host edge ids of rank r's edges, in its slot order."""
        return self.order[self.cuts[r]:self.cuts[r + 1]]

    def ext_rows(self, r: int) -> np.ndarray:
        """The global node of each of rank r's extended rows."""
        lo, hi = self.block(r)
        kl, kr = self.strips(r)
        return np.concatenate([np.arange(lo - kl, hi + kr), self.ovf])

    def describe(self) -> str:
        return (f"halo plan P={self.n_parts} K={self.K} R={self.R} "
                f"route={self.route}")


def _blocks(n_nodes: int, P: int) -> np.ndarray:
    """P contiguous ranges cut at even ids, pair counts within one."""
    n_pairs = (n_nodes + 1) // 2
    bounds = np.minimum(2 * ((np.arange(P + 1) * n_pairs) // P), n_nodes)
    bounds[-1] = n_nodes
    return bounds.astype(np.int64)


def build_halo_plan(src, dst, n_nodes: int, n_parts: int,
                    max_k_frac: float = MAX_K_FRAC,
                    max_ovf_frac: float | None = MAX_OVF_FRAC
                    ) -> HaloPlan | None:
    """The plan of graph ``(src, dst)`` (host edge order) over ``n_parts``
    ranks, or None when there is none: (with ``max_ovf_frac``) every K
    within ``max_k_frac`` of the smallest block leaves more than
    ``max_ovf_frac`` of it in overflow rows (JAX ``build_halo_plan``,
    parallel/halo.py:118-243).  ``max_ovf_frac=None`` lifts that cap (route
    ``overflow-uncapped``; K then may also be the cap itself).

    A graph with fewer RC pairs than ranks leaves some blocks empty (JAX
    pads the node count to a multiple of P instead, parallel/halo.py:783,
    827).  The smallest block is then 0 rows, so K is 0: no strips, and
    every edge whose src lies outside its dst's block takes an overflow
    row.  An empty rank holds no rows and no edges; it joins every
    exchange and sum with empty or zero tensors and launches no kernel."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    P = int(n_parts)
    bounds = _blocks(n_nodes, P)
    sizes = np.diff(bounds)
    if P < 1:
        return None
    owner = np.searchsorted(bounds, dst, side="right") - 1
    start, size = bounds[owner], sizes[owner]
    off = src - start
    reach = np.maximum(np.maximum(-off, off - (size - 1)), 0)
    k_cap = int(max_k_frac * sizes.min())
    ovf_cap = np.inf if max_ovf_frac is None else max_ovf_frac * sizes.min()
    K = 0
    if src.size:
        cands = {int(np.percentile(reach, q, method="higher"))
                 for q in QUANTILES}
        if max_ovf_frac is None:
            cands.add(k_cap)
        best = None
        for k in sorted(cands):
            if k > k_cap:
                continue
            n_over = np.unique(src[reach > k]).size
            if n_over > ovf_cap:
                continue
            cost = 2 * k + 4 * n_over
            if best is None or cost < best[0]:
                best = (cost, k)
        if best is None:
            return None
        K = best[1]
    far = reach > K
    ovf = np.unique(src[far])
    kl = np.where(owner > 0, K, 0)
    kr = np.where(owner < P - 1, K, 0)
    src_ext = np.where(far, kl + size + kr + np.searchsorted(ovf, src),
                       kl + off)
    dst_ext = kl + dst - start
    order = np.argsort(dst, kind="stable")
    cuts = np.searchsorted(dst[order], bounds)
    return HaloPlan(n_parts=P, n_nodes=int(n_nodes), bounds=bounds, K=K,
                    ovf=ovf, order=order, cuts=cuts.astype(np.int64),
                    src_ext=src_ext[order], dst_ext=dst_ext[order],
                    route="banded" if max_ovf_frac is not None
                    else "overflow-uncapped")


def band_order(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> np.ndarray:
    """Pair-level BFS relabelling (JAX ``band_order``, parallel/halo.py:
    709-754): the new id of each old node, RC pairs ``(i, i^1)`` kept
    adjacent, pairs numbered in BFS order over the pair graph, so that
    connected pairs get close ids.  ``n_nodes`` must be even."""
    from ..native import get_lib

    if n_nodes % 2:
        raise ValueError(f"band_order: {n_nodes} nodes; RC pairs need an "
                         "even count")
    n_pairs = n_nodes // 2
    pair_u = np.asarray(src, dtype=np.int64) >> 1
    pair_v = np.asarray(dst, dtype=np.int64) >> 1
    order = np.argsort(pair_u, kind="stable")
    nbr = np.ascontiguousarray(pair_v[order], dtype=np.int32)
    ptr = np.zeros(n_pairs + 1, dtype=np.int64)
    np.cumsum(np.bincount(pair_u, minlength=n_pairs), out=ptr[1:])
    lib = get_lib()
    if lib is not None:
        new_pair = np.empty(n_pairs, dtype=np.int64)
        lib.gn_bfs_order(ptr, nbr, n_pairs, new_pair)
    else:
        from collections import deque

        new_pair = np.full(n_pairs, -1, dtype=np.int64)
        pos = 0
        for seed in range(n_pairs):
            if new_pair[seed] >= 0:
                continue
            queue = deque([seed])
            new_pair[seed] = pos
            pos += 1
            while queue:
                p = queue.popleft()
                for q in nbr[ptr[p]:ptr[p + 1]]:
                    if new_pair[q] < 0:
                        new_pair[q] = pos
                        pos += 1
                        queue.append(int(q))
    new_of_old = np.empty(n_nodes, dtype=np.int64)
    new_of_old[0::2] = 2 * new_pair
    new_of_old[1::2] = 2 * new_pair + 1
    return new_of_old


def plan_graph(src, dst, n_nodes: int, n_parts: int):
    """``(plan, new_of_old)``: the banded plan in the assembler's order
    (``new_of_old`` None), else after ``band_order``, else the uncapped
    plan in whichever of the two orders costs less (the assembler's on a
    tie).  The uncapped plan always exists (K 0 at worst)."""
    plan = build_halo_plan(src, dst, n_nodes, n_parts)
    if plan is not None:
        return plan, None
    tries = [(src, dst, None)]
    if n_nodes % 2 == 0:
        nol = band_order(src, dst, n_nodes)
        tries.append((nol[src], nol[dst], nol))
        plan = build_halo_plan(nol[src], nol[dst], n_nodes, n_parts)
        if plan is not None:
            return plan, nol
    best = None
    for s, d, nol in tries:
        plan = build_halo_plan(s, d, n_nodes, n_parts, max_ovf_frac=None)
        if plan is None:
            raise ValueError(f"halo: no plan over {n_parts} ranks")
        if best is None or plan.cost < best[0].cost:
            best = (plan, nol)
    return best


# ----------------------------------------------------------------- the shard
@dataclass
class HaloShard:
    """Rank ``rank``'s part of a graph on its device: the shard graph over
    its extended rows, its block's node features, its edges' features and
    labels in slot order, and the counts of the whole graph."""
    plan: HaloPlan
    rank: int
    g: DeviceGraph
    x: torch.Tensor             # [Nb, F] block rows
    x_rev: torch.Tensor
    e: torch.Tensor             # [E_r, Fe] slot order
    labels: torch.Tensor | None  # [E_r] slot order
    ovf_pos: torch.Tensor       # long: overflow rows this rank owns ...
    ovf_rows: torch.Tensor      # ... and their block rows

    @property
    def K(self) -> int:
        return self.plan.K

    @property
    def strips(self) -> tuple[int, int]:
        return self.plan.strips(self.rank)

    @property
    def n_local(self) -> int:
        lo, hi = self.plan.block(self.rank)
        return hi - lo

    @property
    def n_nodes(self) -> int:
        return self.plan.n_nodes

    @property
    def n_edges(self) -> int:
        return self.plan.n_edges


def shard_graph(plan: HaloPlan, rank: int, x: np.ndarray, x_rev: np.ndarray,
                e_feat: np.ndarray, y: np.ndarray | None,
                device) -> HaloShard:
    """Rank ``rank``'s shard: ``x``/``x_rev`` [N, F] in the plan's node
    order, ``e_feat`` [E, Fe] and ``y`` [E] in host edge order."""
    lo, hi = plan.block(rank)
    a, b = plan.cuts[rank], plan.cuts[rank + 1]
    g = DeviceGraph.build(plan.src_ext[a:b], plan.dst_ext[a:b],
                          plan.n_ext(rank), device)
    own = (plan.ovf >= lo) & (plan.ovf < hi)

    def t(arr, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype,
                               device=device)

    return HaloShard(
        plan=plan, rank=rank, g=g, x=t(x[lo:hi]), x_rev=t(x_rev[lo:hi]),
        e=t(to_device_edges(plan, rank, e_feat)),
        labels=None if y is None else t(to_device_edges(plan, rank, y)),
        ovf_pos=t(np.nonzero(own)[0], torch.long),
        ovf_rows=t(plan.ovf[own] - lo, torch.long))


def to_device_edges(plan: HaloPlan, rank: int, a: np.ndarray) -> np.ndarray:
    """A host-edge-order array [E, ...] as rank ``rank``'s slot order."""
    return np.asarray(a)[plan.edges(rank)]


def halo_scores_to_host(plan: HaloPlan, parts) -> np.ndarray:
    """Every rank's slot-order values (a list in rank order) as one
    host-edge-order array (JAX ``halo_scores_to_host``)."""
    out = np.empty((plan.n_edges,) + np.asarray(parts[0]).shape[1:],
                   dtype=np.asarray(parts[0]).dtype)
    for r, p in enumerate(parts):
        out[plan.edges(r)] = np.asarray(p)
    return out


def gather_edges(sh: HaloShard, group: Group, values: torch.Tensor):
    """Rank 0: the ranks' slot-order ``values`` [E_r] as host-edge-order
    numpy [E] (the role of JAX ``fetch_global``); None elsewhere."""
    counts = np.diff(sh.plan.cuts).tolist()
    parts = group.gather_rows(values, counts)
    if parts is None:
        return None
    return halo_scores_to_host(sh.plan, [p.numpy() for p in parts])


# -------------------------------------------------------------- the exchange
def _extend(sh: HaloShard, group: Group, h: torch.Tensor) -> torch.Tensor:
    """[Nb, w] block rows -> [n_ext, w] extended rows, in ``h``'s dtype
    (on the wire in float32, or float64 for float64 input)."""
    K, (kl, kr) = sh.K, sh.strips
    t = wide(h)
    nb, w = t.shape
    left, right = group.exchange(t[:K], t[nb - K:])
    if sh.plan.R:
        own = t.new_zeros((sh.plan.R, w))
        own.index_copy_(0, sh.ovf_pos, t.index_select(0, sh.ovf_rows))
        buf = group.all_reduce(own)
    else:
        buf = t.new_zeros((0, w))
    return torch.cat([left.to(h.dtype), h, right.to(h.dtype),
                      buf.to(h.dtype)])


def _return(sh: HaloShard, group: Group, s: torch.Tensor) -> torch.Tensor:
    """[n_ext, w] sums over the extended rows -> [Nb, w] block rows (in
    float32, or float64): each row's own sum plus the partials the
    neighbours and the overflow sum hold for it."""
    K, (kl, kr) = sh.K, sh.strips
    nb = sh.n_local
    t = wide(s)
    out = t[kl:kl + nb].clone()
    from_left, from_right = group.exchange(t[:kl], t[kl + nb:kl + nb + kr])
    if from_left.shape[0]:
        out[:K] += from_left
    if from_right.shape[0]:
        out[nb - K:] += from_right
    if sh.plan.R:
        tot = group.all_reduce(t[kl + nb + kr:])
        out.index_add_(0, sh.ovf_rows, tot.index_select(0, sh.ovf_pos))
    return out


class _HaloExtend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, sh, group):
        ctx.sh, ctx.group, ctx.dtype = sh, group, h.dtype
        return _extend(sh, group, h)

    @staticmethod
    def backward(ctx, d):
        return _return(ctx.sh, ctx.group, d).to(ctx.dtype), None, None


class _HaloReturn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, sh, group):
        ctx.sh, ctx.group, ctx.dtype = sh, group, s.dtype
        return _return(sh, group, s)

    @staticmethod
    def backward(ctx, d):
        return _extend(ctx.sh, ctx.group, d).to(ctx.dtype), None, None


def halo_extend(sh: HaloShard, group: Group, h: torch.Tensor) -> torch.Tensor:
    """Block rows ``h`` [Nb, w] -> extended rows [n_ext, w]: the left
    neighbour's last K rows, ``h``, the right neighbour's first K rows and
    the overflow rows from their owners.  The backward is
    ``halo_return``."""
    return _HaloExtend.apply(h, sh, group)


def halo_return(sh: HaloShard, group: Group, s: torch.Tensor) -> torch.Tensor:
    """Sums over the extended rows ``s`` [n_ext, w] -> the block's rows
    [Nb, w] in float32: the partials in strip and overflow rows added to
    their owners' rows (JAX ``_halo_layer``'s ``ppermute`` and ``psum`` of
    ``part_src``, parallel/halo.py:370-389).  The backward is
    ``halo_extend``."""
    return _HaloReturn.apply(s, sh, group)


# ----------------------------------------------------------------- the model
def sync_batch_norm(bn, x: torch.Tensor, group: Group,
                    n_nodes: int) -> torch.Tensor:
    """Training BatchNorm over the rows of every rank (JAX ``_psum_bn``,
    parallel/halo.py:263-286): the mean and the biased variance (two-pass)
    from sums over ranks divided by the whole graph's ``n_nodes``; the
    running statistics take the mean and the unbiased variance.  In
    float32, returned in ``x``'s dtype."""
    in_dtype = x.dtype
    x = wide(x)
    n = float(n_nodes)
    mean = all_reduce(x.sum(0), group) / n
    var = all_reduce(((x - mean) ** 2).sum(0), group) / n
    y = (x - mean) * torch.rsqrt(var + BN_EPS)
    update_running_stats(bn, mean.detach(),
                         var.detach() * (n / (n - 1) if n > 1 else 1.0))
    return (y * bn.weight + bn.bias).to(in_dtype)


def halo_layer(conv, sh: HaloShard, group: Group, h, e, flip: bool,
               drop_rate: float = 0.0, generator=None):
    """One batch-norm ``SymGatedGCNLayer`` on a shard (JAX ``_halo_layer``,
    parallel/halo.py:290-395): ``h`` [Nb, d] block rows, ``e`` [E_r, d]
    the shard's edges.  The edge stage runs on the extended rows (eval: K3;
    training: K7 + K3, K8 backward, statistics summed over ranks); the
    src side's sums go home through ``halo_return`` (the src side is u,
    or v under ``flip``; dst is always local)."""
    d, dt = h.shape[1], h.dtype
    kl, nb = sh.strips[0], sh.n_local
    h_ext = halo_extend(sh, group, h)
    if conv.training:
        lins = (conv.B_1, conv.A_2, conv.B_2, conv.A_3)
        w_uv = torch.cat([m.weight for m in lins]).t()
        b_uv = torch.cat([m.bias for m in lins])
        e_out, sum_v, sum_u, mean, unbiased = train_edge_stage(
            sh.g, flip, h_ext, w_uv.to(dt), b_uv.to(dt),
            conv.B_3.weight.t().to(dt), conv.B_3.bias.to(dt), e,
            conv.bn_e.weight, conv.bn_e.bias,
            reduce=group.all_reduce, n_edges=sh.n_edges)
        update_running_stats(conv.bn_e, mean, unbiased, repeat_updates=2)
        a1 = _linear(conv.A_1, h)
    else:
        proj = conv._projection(h_ext)
        e_out, sum_v, sum_u = eval_edge_stage(
            sh.g, proj[:, :2 * d], proj[:, 2 * d:4 * d],
            _linear(conv.B_3, e), e, batch_norm_rows(conv.bn_e, dt),
            flip=flip)
        a1 = proj[kl:kl + nb, 4 * d:]
    src_sum, dst_sum = (sum_v, sum_u) if flip else (sum_u, sum_v)
    at_src = halo_return(sh, group, src_sum).to(dt)
    at_dst = dst_sum[kl:kl + nb]
    sv, su = (at_src, at_dst) if flip else (at_dst, at_src)
    h_fwd = sv[:, :d] / (sv[:, d:] + GATE_EPS)
    h_bwd = su[:, :d] / (su[:, d:] + GATE_EPS)
    h_new = a1 + h_fwd + h_bwd
    h_new = (sync_batch_norm(conv.bn_h, h_new, group, sh.n_nodes)
             if conv.training else batch_norm_eval(conv.bn_h, h_new))
    h_new = torch.relu(h_new) + h
    if drop_rate > 0.0:
        h_new = dropout(h_new, drop_rate, generator)
    return h_new, e_out


def halo_supported(model_cfg) -> bool:
    """Whether the halo path runs the model a ``config.ModelConfig`` names:
    the batch-norm SymGatedGCN (JAX ``halo_supported``, parallel/halo.py:
    477-481).  ``compute.mesh > 1`` runs the others' eval forward on
    ``parallel/sharded.py``."""
    return (model_cfg.model in SYM_NAMES
            and model_cfg.normalization == "batch")


def check_model(model) -> None:
    if not (isinstance(model, SymGatedGCN) and model.normalization == "batch"):
        raise ValueError("the halo path runs the batch-norm SymGatedGCN only, "
                         f"not {type(model).__name__} with normalization="
                         f"{getattr(model, 'normalization', None)!r}")


def halo_pass(model: SymGatedGCN, sh: HaloShard, group: Group, x, flip: bool,
              generator=None, dtype: torch.dtype = torch.float32):
    """One directional pass on a shard (JAX ``_halo_pass``,
    parallel/halo.py:398-474): encoders, every layer, the predictor (K6 on
    the extended rows; K9 backward into them).  ``x`` the block's node
    features.  Returns the shard's float32 logits [E_r] in slot order."""
    check_model(model)
    drop = model.dropout if model.training else 0.0
    if drop > 0.0 and generator is None:
        raise ValueError("training-mode dropout needs a torch.Generator")
    h = mlp2(model.linear1_node, model.linear2_node, x).to(dtype)
    e = mlp2(model.linear1_edge, model.linear2_edge, sh.e).to(dtype)
    for conv in model.gnn.convs:
        h, e = halo_layer(conv, sh, group, h, e, flip, drop, generator)
    h_ext = halo_extend(sh, group, h)
    return model.predictor(sh.g, h_ext, e, flip).float()[:, 0]


# ----------------------------------------------------------------- the steps
@torch.inference_mode()
def halo_forward(model, sh: HaloShard, group: Group,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The eval forward's logits of the shard's edges [E_r], slot order."""
    model.eval()
    return halo_pass(model, sh, group, sh.x, False, None, dtype)


def _halo_loss(model, sh: HaloShard, group: Group, pos_weight: float,
               cfg: Config, generator):
    """``(sum of the shard's per-edge loss / whole graph's E, org-pass
    logits)``: JAX's halo ``device_loss`` (parallel/halo.py:561-583), the
    symmetry loss over two directional passes, or plain BCE."""
    dtype = compute_dtype(cfg)
    y = sh.labels
    lo = halo_pass(model, sh, group, sh.x, False, generator, dtype)
    per_edge = _bce_elementwise(lo, y, pos_weight)
    if cfg.train.use_symmetry_loss:
        lr = halo_pass(model, sh, group, sh.x_rev, True, generator, dtype)
        per_edge = (per_edge + _bce_elementwise(lr, y, pos_weight)
                    + cfg.train.alpha * (lo - lr).abs())
    return per_edge.sum() / sh.n_edges, lo


def all_reduce_grads(model, group: Group) -> None:
    """Sum every parameter's gradient over the ranks (one message)."""
    params = list(model.parameters())
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1) for p in params])
    total = group.all_reduce(flat)
    i = 0
    for p in params:
        p.grad = total[i:i + p.numel()].view_as(p)
        i += p.numel()


def halo_train_step(model, opt, sh: HaloShard, group: Group,
                    pos_weight: float, cfg: Config, generator):
    """One Adam step on a shard (JAX ``make_halo_train_step``,
    parallel/halo.py:540-606): each rank backwards its own part of the
    loss, the gradients are summed over ranks, every rank steps.  Returns
    ``(loss of the whole graph, org-pass logits [E_r])``."""
    model.train()
    opt.zero_grad(set_to_none=True)
    loss, lo = _halo_loss(model, sh, group, pos_weight, cfg, generator)
    loss.backward()
    all_reduce_grads(model, group)
    opt.step()
    return group.all_reduce(loss.detach().reshape(1))[0], lo.detach()


@torch.no_grad()
def halo_eval_step(model, sh: HaloShard, group: Group, pos_weight: float,
                   cfg: Config):
    """The validation loss and logits with the eval forward (JAX
    ``make_halo_eval_step``)."""
    model.eval()
    loss, lo = _halo_loss(model, sh, group, pos_weight, cfg, None)
    return group.all_reduce(loss.reshape(1))[0], lo


def rank_launches(group: Group) -> list:
    """Every rank's kernel launches since its counters were last reset
    (``ops.kernels.launch_counts``), in rank order, on every rank."""
    from ..ops.kernels import KERNELS, launch_counts

    counts = launch_counts()
    mine = torch.tensor([counts[k] for k in KERNELS], dtype=torch.int64)
    return [dict(zip(KERNELS, t.cpu().tolist()))
            for t in group.all_gather(mine)]


def dropout_generator(seed: int, rank: int, device) -> torch.Generator:
    """Rank ``rank``'s dropout generator, seeded from ``(seed, rank)`` (the
    counterpart of ``fold_in(rng, axis_index)``, parallel/halo.py:446)."""
    s = int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


# ----------------------------------------------------------------- the glue
def _relabelled(a: np.ndarray, new_of_old) -> np.ndarray:
    """Node rows ``a`` [N, ...] in the plan's node order."""
    return a if new_of_old is None else a[np.argsort(new_of_old)]


def halo_example_from_unit(unit, group: Group, device) -> HaloShard:
    """This rank's shard of a ``train.step.HostUnit`` (the degrees z-scored
    as ``make_example`` does), through ``plan_graph`` (JAX
    ``halo_example_from_unit``, parallel/halo.py:757-790)."""
    from ..models.features import _zscore

    plan, nol = plan_graph(unit.src, unit.dst, unit.n_nodes, group.size)
    zi, zo = _zscore(unit.in_deg), _zscore(unit.out_deg)
    x = _relabelled(np.stack([zi, zo], axis=1), nol)
    x_rev = _relabelled(np.stack([zo, zi], axis=1), nol)
    return shard_graph(plan, group.rank, x, x_rev, unit.e_feat, unit.y,
                       device)


def halo_score(model, cfg: Config, group: Group, src, dst, n_nodes: int,
               x: np.ndarray, e: np.ndarray, verbose: bool = False):
    """Every rank scores its shard of the graph ``(src, dst)`` with node
    features ``x`` [N, F] and host-order edge features ``e``.  Returns
    ``(logits, shard)``: host-edge-order float32 logits [E] on rank 0, None
    on the others."""
    plan, nol = plan_graph(src, dst, n_nodes, group.size)
    if verbose and group.rank == 0:
        print(plan.describe(), flush=True)
    x = _relabelled(np.asarray(x, dtype=np.float32), nol)
    sh = shard_graph(plan, group.rank, x, x, e, None, group.device)
    lo = halo_forward(model, sh, group, compute_dtype(cfg))
    return gather_edges(sh, group, lo), sh


def halo_score_graph(graph, model, cfg: Config, group: Group,
                     verbose: bool = False):
    """``halo_score`` of a host graph with its node and edge features (JAX
    ``halo_score_graph``, parallel/halo.py:802-840): logits [E] on rank 0,
    None on the others."""
    logits, _ = halo_score(model, cfg, group, graph.src, graph.dst,
                           graph.num_nodes, node_features(graph),
                           edge_features(graph, cfg.data.use_similarities),
                           verbose)
    return logits
