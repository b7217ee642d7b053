"""Graph-parallel eval forward of every model the halo path does not run:
the layer-norm and norm-free SymGatedGCN and the zoo (GatedGCN, directed
or not, GCN, GAT, SAGE).  The counterpart of ``gnnome_tpu/parallel/
sharded.py``, which runs them over GSPMD (``sharded_score_graph``,
:97-126; ``gnnome_tpu/infer.py:65-77`` sends every config that
``halo_supported`` refuses there).  It does not copy GSPMD's windowed
sharding and padding: it runs on the halo path's layout (``parallel/
halo.py``):

* **The plan and the shard.** ``plan_graph`` chooses the blocks and the
  node order once, on the original graph ``g``; rank r's shard graph is
  ``[left strip | block | right strip | overflow]`` (``shard_graph``).
  Edges live with the owner of their ``dst``, node states ``h`` on block
  rows.
* **SymGatedGCN (layer norm, none).** Each layer extends ``h`` (d wide),
  projects the extended rows, runs K1 (``gate_gather``) and the edge
  chain on the shard, then K2 (``aggregate``) into u and into v over the
  extended rows.  The src side's sums (u: eval has no flip) go home
  through ``halo_return``, the dst side is local, and only then do the
  gated means divide: ``gated_mean_pair`` divides inside and cannot be
  used across a return.  The node LayerNorm is row-wise: no statistics
  cross ranks.  The predictor is the unpacked form on extended rows.  Per
  rank and forward: 8 K1 + 8 K2.
* **The zoo.** Every node sum is into ``dst`` (the one-sided K2 walk,
  ``sum_into``), so it is local: each layer extends ``h`` and returns
  nothing.  The processor runs on ``processor_edges`` (reversed edges for
  ``directed=False``, self-loops for GCN, GAT and SAGE), so a zoo shard
  holds a second shard graph: the processor graph's plan over the same
  blocks and node order, banded or with the overflow cap lifted, as
  ``plan_graph`` does.  The undirected GatedGCN encodes the raw features
  of its own processor edges (``[e; e]`` in host order) locally, and maps
  the processor's first E edge states to ``g``'s slots through host edge
  ids.  GCN's ``c_src`` takes each node's out-degree in the whole
  processor graph, counted on the host; ``c_dst``, SAGE's in-degree and
  GAT's per-dst max and softmax are local.  Per rank and forward: 8 walks
  (GatedGCN, GCN, SAGE) or 16 (GAT).

The layers run on the extended rows, where they read gathered rows, and
keep the block's rows: a row's result needs only its own row and its
in-edges, which its rank holds.  Everything runs in float32, as the JAX
package's sharded forward does: ``make_sharded_forward`` passes no dtype
(gnnome_tpu/parallel/sharded.py:73-77), and the zoo ignores it.  A rank
whose block is empty holds no edges and launches no kernel.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import Config
from ..models.features import edge_features, node_features
from ..models.nn import mlp2
from ..models.norm import apply_norm
from ..models.sym_gated_gcn import GATE_EPS, SymGatedGCN, _linear
from ..models.zoo import ZOO, _degrees, processor_edges
from ..ops.message import aggregate, gate_gather, gather_rows, sum_into
from .group import Group
from .halo import (HaloShard, _relabelled, build_halo_plan, gather_edges,
                   halo_extend, halo_return, plan_graph, shard_graph)

DTYPE_NOTE = ("compute.dtype=bfloat16: the sharded path (compute.mesh > 1) "
              "runs {model} in float32, as the JAX package's does "
              "(gnnome_tpu/parallel/sharded.py:73-77 passes no dtype)")


@dataclass
class ShardedGraph:
    """Rank ``sh.rank``'s part of a graph for the sharded forward: ``sh``
    the shard of ``g`` (its node and edge features; the predictor's graph,
    and the SymGatedGCN's), ``proc`` the shard of the processor graph over
    the same blocks and node order (``sh`` itself where the processor runs
    on ``g``), ``proc_slots`` the processor slot of each of ``g``'s slots
    (the undirected GatedGCN) and ``out_deg`` the block rows' out-degrees
    in the whole processor graph, clipped at 1 ([Nb, 1] float32; GCN)."""
    sh: HaloShard
    proc: HaloShard
    proc_slots: torch.Tensor | None = None
    out_deg: torch.Tensor | None = None

    def describe(self) -> str:
        out = self.sh.plan.describe().replace("halo plan", "sharded plan")
        if self.proc is not self.sh:
            p = self.proc.plan
            out += f"; processor K={p.K} R={p.R} route={p.route}"
        return out


def processor_plan(src, dst, n_nodes: int, n_parts: int):
    """The processor graph's plan in the node order already chosen: banded,
    else with the overflow cap lifted (``plan_graph``'s fallback); its
    blocks are ``g``'s, which depend only on N and P."""
    return (build_halo_plan(src, dst, n_nodes, n_parts)
            or build_halo_plan(src, dst, n_nodes, n_parts, max_ovf_frac=None))


def shard_for_model(model_cfg, group: Group, src, dst, n_nodes: int,
                    x: np.ndarray, e: np.ndarray) -> ShardedGraph:
    """This rank's ``ShardedGraph`` of the graph ``(src, dst)`` (host edge
    order) with node features ``x`` [N, F] and edge features ``e`` [E, Fe],
    for the model ``model_cfg`` names."""
    P, rank, dev = group.size, group.rank, group.device
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    e = np.asarray(e, dtype=np.float32)
    plan, nol = plan_graph(src, dst, n_nodes, P)
    x = _relabelled(np.asarray(x, dtype=np.float32), nol)
    sh = shard_graph(plan, rank, x, x, e, None, dev)
    edges = processor_edges(model_cfg, src, dst, n_nodes)
    if edges is None:
        return ShardedGraph(sh, sh)
    ps, pd = edges if nol is None else (nol[edges[0]], nol[edges[1]])
    pplan = processor_plan(ps, pd, n_nodes, P)
    # only the GatedGCN's processor reads edge features: the original's
    # for each reversed copy
    gated = model_cfg.model == "gatedgcn"
    pe = (np.concatenate([e, e]) if gated
          else np.zeros((ps.shape[0], 0), np.float32))
    proc = shard_graph(pplan, rank, x, x, pe, None, dev)
    proc_slots = None
    if gated:
        pos = np.empty(pplan.n_edges, dtype=np.int64)
        mine = pplan.edges(rank)
        pos[mine] = np.arange(mine.shape[0])
        proc_slots = torch.as_tensor(pos[plan.edges(rank)], device=dev)
    out_deg = None
    if model_cfg.model == "gcn":
        lo, hi = plan.block(rank)
        deg = np.bincount(ps, minlength=n_nodes)[lo:hi]
        out_deg = torch.as_tensor(deg, device=dev).clamp_min(1).to(
            torch.float32)[:, None]
    return ShardedGraph(sh, proc, proc_slots, out_deg)


# ----------------------------------------------------------------- the layers
def _block(sh: HaloShard) -> slice:
    """The block's rows in the extended space."""
    kl = sh.strips[0]
    return slice(kl, kl + sh.n_local)


def unfused_layer(conv, sh: HaloShard, group: Group, h, e):
    """One layer-norm or norm-free ``SymGatedGCNLayer`` (eval) on a shard
    (the single-device ``_forward_unfused``, sym_gated_gcn.py, and the rows
    ``halo_layer`` extends and returns): ``h`` [Nb, d] block rows, ``e``
    [E_r, d] the shard's edges."""
    d = h.shape[1]
    proj = conv._projection(halo_extend(sh, group, h))
    g3 = gate_gather(sh.g, False, proj[:, :2 * d], proj[:, 2 * d:4 * d],
                     _linear(conv.B_3, e))
    e_out = torch.relu(apply_norm(conv.bn_e, g3[:, :d])) + e
    sigma = torch.sigmoid(e_out)
    sum_u, sum_v = aggregate(sh.g, False,
                             torch.cat([sigma * g3[:, 2 * d:], sigma], 1),
                             torch.cat([sigma * g3[:, d:2 * d], sigma], 1))
    su = halo_return(sh, group, sum_u)
    sv = sum_v[_block(sh)]
    h_fwd = sv[:, :d] / (sv[:, d:] + GATE_EPS)
    h_bwd = su[:, :d] / (su[:, d:] + GATE_EPS)
    h_new = proj[_block(sh), 4 * d:] + h_fwd + h_bwd
    return torch.relu(apply_norm(conv.bn_h, h_new)) + h, e_out


def _sym_gated_gcn(model, sg: ShardedGraph, group: Group, h, e):
    for conv in model.gnn.convs:
        h, e = unfused_layer(conv, sg.sh, group, h, e)
    return h, e


def _gatedgcn(model, sg: ShardedGraph, group: Group, h, e):
    """JAX ``gated_gcn_forward``'s processor (zoo.py:137-179)."""
    p = sg.proc
    if p is not sg.sh:
        # the reversed copies start from their originals' features
        e = mlp2(model.linear1_edge, model.linear2_edge, p.e)
    for conv in model.gnn.convs:
        h_ext, e = conv(p.g, halo_extend(p, group, h), e, 0.0, None)
        h = h_ext[_block(p)]
    if p is not sg.sh:
        e = e.index_select(0, sg.proc_slots)
    return h, e


def _gcn(model, sg: ShardedGraph, group: Group, h, e):
    """JAX ``gcn_forward``'s processor (zoo.py:198-220)."""
    p, rows = sg.proc, _block(sg.proc)
    c_src = torch.rsqrt(sg.out_deg)
    c_dst = torch.rsqrt(_degrees(p.g.dst_ptr)[rows])
    last = len(model.gnn.convs) - 1
    for i, conv in enumerate(model.gnn.convs):
        hs = gather_rows(p.g, "src", halo_extend(p, group, h * c_src))
        h = conv(sum_into(p.g, "dst", hs)[rows] * c_dst)
        if i < last:
            h = torch.relu(h)
    return h, e


def _gat(model, sg: ShardedGraph, group: Group, h, e):
    """JAX ``gat_forward``'s processor (zoo.py:285-303): ``fc`` on the
    extended rows of the d-wide ``h``."""
    p, rows = sg.proc, _block(sg.proc)
    last = len(model.gnn.convs) - 1
    for i, (conv, proj) in enumerate(zip(model.gnn.convs, model.proj)):
        h = proj(conv(p.g, halo_extend(p, group, h), 0.0, None)[rows])
        if i < last:
            h = torch.relu(h)
    return h, e


def _sage(model, sg: ShardedGraph, group: Group, h, e):
    """JAX ``sage_forward``'s processor (zoo.py:321-345)."""
    p, rows = sg.proc, _block(sg.proc)
    deg_in = _degrees(p.g.dst_ptr)[rows]
    last = len(model.gnn.convs) - 1
    for i, conv in enumerate(model.gnn.convs):
        hs = gather_rows(p.g, "src", halo_extend(p, group, h))
        h = conv.fc_self(h) + conv.fc_neigh(sum_into(p.g, "dst", hs)[rows]
                                            / deg_in)
        if i < last:
            h = torch.relu(h)
    return h, e


PROCESSORS = {"sym_gatedgcn": _sym_gated_gcn, "gatedgcn": _gatedgcn,
              "gcn": _gcn, "gat": _gat, "sage": _sage}


def check_model(model) -> None:
    """The sharded path runs the layer-norm and norm-free SymGatedGCN and
    the zoo; the batch-norm SymGatedGCN takes the halo path."""
    if isinstance(model, SymGatedGCN):
        if model.normalization == "batch":
            raise ValueError("the batch-norm SymGatedGCN runs on the halo "
                             "path (parallel/halo.py), not the sharded one")
    elif not isinstance(model, tuple(ZOO.values())):
        raise ValueError(f"the sharded path runs the SymGatedGCN and the "
                         f"zoo, not {type(model).__name__}")


@torch.inference_mode()
def sharded_forward(model, sg: ShardedGraph, group: Group) -> torch.Tensor:
    """The eval forward's float32 logits of the shard's edges [E_r], in
    ``sg.sh``'s slot order: encoders on the block's rows and the shard's
    edges, the processor, the unpacked predictor on ``g``'s extended
    rows."""
    check_model(model)
    model.eval()
    sh = sg.sh
    h = mlp2(model.linear1_node, model.linear2_node, sh.x)
    e = mlp2(model.linear1_edge, model.linear2_edge, sh.e)
    h, e = PROCESSORS[model.kind](model, sg, group, h, e)
    return model.predictor(sh.g, halo_extend(sh, group, h), e,
                           False).float()[:, 0]


# ----------------------------------------------------------------- the glue
def sharded_score(model, cfg: Config, group: Group, src, dst, n_nodes: int,
                  x: np.ndarray, e: np.ndarray, verbose: bool = False):
    """Every rank scores its shard of the graph ``(src, dst)`` with node
    features ``x`` [N, F] and host-order edge features ``e``.  Returns
    ``(logits, ShardedGraph)``: host-edge-order float32 logits [E] on rank
    0, None on the others.  ``compute.dtype=bfloat16`` runs float32 and
    says so on rank 0."""
    sg = shard_for_model(cfg.model, group, src, dst, n_nodes, x, e)
    if group.rank == 0:
        if cfg.compute.dtype == "bfloat16":
            m = cfg.model
            print(DTYPE_NOTE.format(model=f"model.model={m.model}" if
                                    m.model in ZOO else "the SymGatedGCN "
                                    f"(model.normalization={m.normalization})"),
                  flush=True)
        if verbose:
            print(sg.describe(), flush=True)
    return gather_edges(sg.sh, group, sharded_forward(model, sg, group)), sg


def sharded_score_graph(graph, model, cfg: Config, group: Group,
                        verbose: bool = False):
    """``sharded_score`` of a host graph with its node and edge features
    (JAX ``sharded_score_graph``, parallel/sharded.py:97-126): logits [E]
    on rank 0, None on the others."""
    logits, _ = sharded_score(model, cfg, group, graph.src, graph.dst,
                              graph.num_nodes, node_features(graph),
                              edge_features(graph, cfg.data.use_similarities),
                              verbose)
    return logits
