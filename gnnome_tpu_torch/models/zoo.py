"""Model zoo: the reference's non-flagship variants as ``nn.Module``s
(reference models/full_graph.py:33-119, layers/processor.py:22-83; the
PyTorch counterpart of ``gnnome_tpu/models/zoo.py``).

All share the encoder -> processor -> score-predictor composition.  The
processor may run on a transformed graph (``processor_graph``: reversed
edges appended for ``directed=False``, one self-loop per node for GCN, GAT
and SAGE), built on the host from the edge arrays; the predictor always
runs on the original graph, in its unpacked form (``ScorePredictor(
fused=False)``: row gathers, K2 in the backward).

Conv semantics follow DGL 0.8, as in the JAX package:

* GatedGCN: the forward-direction half of SymGatedGCN, ``h = norm(A1h +
  h_fwd)`` with the gated mean into dst only (gated_gcn_full.py:182-230);
* GCN: ``GraphConv(norm='both')``, the sum over in-edges scaled by
  ``rsqrt`` of the clipped out- and in-degrees, relu after every layer but
  the last (processor.py:35-46);
* GAT: per-head attention over in-edges, LeakyReLU(0.2) logits, a softmax
  per destination, heads concatenated then projected, relu after every
  layer but the last (processor.py:49-70);
* SAGE: mean aggregator, ``fc_self(h) + fc_neigh(mean_in(h))``
  (processor.py:73-83).

One model more has no JAX counterpart: the Graph Transformer with edge
features (Dwivedi & Bresson, arXiv:2012.09699; github.com/
graphdeeplearning/graphtransformer, layers/graph_transformer_edge_layer.py),
``model.model=graph_transformer``, on the graph as given (no self-loops, no
reversed edges), with a node and an edge stream like GNNome's layers and
its final edge states passed to the predictor (``GraphTransformer``).

Every reduction into nodes is the one-sided K2 walk (``ops.message.sum_into``,
or ``k2_side_sum`` inside ``gat_conv``) and every endpoint gather
``gather_rows`` (its backward is that walk), so training stays bitwise
reproducible on the card.  Each module's
``forward(g, x, e, g_proc=None, generator=None, slot_io=False)`` takes the
original graph ``g``, its processor graph ``g_proc`` (None: ``g`` itself)
and returns logits [E, 1] as ``SymGatedGCN.forward`` does.

A GATConv after its ``fc`` is one autograd Function,
``gat_conv``: hand-written kernels (csrc/gat_edge.cu) around
its six one-sided walks a layer, nothing ``[E', H*d]`` saved for the
backward.

Spans (``utils.timing``): each model's forward is ``model.forward``; in
each GATConv (inside ``gat_conv``), the attention (``el``/``er``, edge
logits, the segment max, ``exp``, denominators) is ``gat.attention`` and
the messages (``alpha``, the gather and weighting of ``feat[src]``, the
sum into nodes, the bias) are ``gat.aggregate``, ``fc`` and ``proj``
outside both.  ``alpha`` is formed in the message kernel, so it lies in
``gat.aggregate``.  In each Graph Transformer layer the attention (the
projections, gathers, scores, ``exp`` and the sums into dst) is
``gt.attention``; ``O_h``, ``O_e``, the residuals, the four norms and the
two feed-forward nets are ``gt.feedforward``.  In training (float32) each
residual and its BatchNorm is one autograd Function, ``residual_batch_norm``
(csrc/bn_residual.cu), nothing ``[n, d]`` saved but the residual sum.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.graph_tensors import DeviceGraph
from ..ops.kernels import (gat_edge_softmax, gat_logit_adjoint,
                           gat_message_adjoint, gat_messages,
                           gat_node_adjoint, gat_node_logits, k2_side_sum)
from ..ops.message import gather_rows, sum_into
from ..utils.timing import span
from .nn import dropout, mlp2
from .norm import apply_norm, residual_batch_norm
from .sym_gated_gcn import (GATE_EPS, NORMALIZATIONS, ScorePredictor,
                            SymGatedGCN)

SYM_NAMES = ("sym_gatedgcn", "sym_gated_gcn")
GT_NAME = "graph_transformer"
SELF_LOOPS = {"gatedgcn": False, "gcn": True, "gat": True, "sage": True}


# ------------------------------------------------------------ graph transforms
def add_reverse_edges(src: np.ndarray, dst: np.ndarray):
    """Append reversed edges (dgl.add_reverse_edges, full_graph.py:48)."""
    return np.concatenate([src, dst]), np.concatenate([dst, src])


def add_self_loop(src: np.ndarray, dst: np.ndarray, n_nodes: int):
    """Append one self-loop per node (dgl.add_self_loop, full_graph.py:69)."""
    loops = np.arange(n_nodes, dtype=src.dtype)
    return np.concatenate([src, loops]), np.concatenate([dst, loops])


def processor_edges(model_cfg, src, dst, n_nodes: int):
    """The host ``(src, dst)`` of the graph a zoo model's processor runs on
    (the original edges first, in host order, then the reversed copies,
    then the self-loops), or None when it runs on the original graph (the
    SymGatedGCN; a directed GatedGCN; the Graph Transformer) (JAX
    ``processor_graph_for``, zoo.py:370-382)."""
    name = model_cfg.model
    if name in SYM_NAMES or name == GT_NAME:
        return None
    self_loops = SELF_LOOPS[name]
    if model_cfg.directed and not self_loops:
        return None
    src, dst = np.asarray(src), np.asarray(dst)
    if not model_cfg.directed:
        src, dst = add_reverse_edges(src, dst)
    if self_loops:
        src, dst = add_self_loop(src, dst, n_nodes)
    return src, dst


def processor_graph(model_cfg, src, dst, n_nodes: int,
                    device="cpu") -> DeviceGraph | None:
    """``processor_edges`` as a ``DeviceGraph`` on ``device``, or None."""
    edges = processor_edges(model_cfg, src, dst, n_nodes)
    return None if edges is None else DeviceGraph.build(*edges, n_nodes,
                                                        device)


def _degrees(ptr: torch.Tensor) -> torch.Tensor:
    """Node degrees ``[N, 1]`` from a slot-list row pointer, clipped at 1
    (zoo.py:190-191,335)."""
    return (ptr[1:] - ptr[:-1]).clamp_min(1).to(torch.float32)[:, None]


# ------------------------------------------------------------ shared plumbing
class _ZooModel(nn.Module):
    """Encoders, the unpacked score predictor, ``num_layers`` processor
    layers from ``_layer``, weight init and the edge plumbing the four
    models share."""

    kind = ""

    def __init__(self, node_features: int = 2, edge_features: int = 2,
                 hidden_features: int = 64, hidden_ne_features: int = 16,
                 num_layers: int = 8, hidden_edge_scores: int = 64,
                 dropout: float = 0.0, normalization: str = "batch",
                 **layer_kw):
        super().__init__()
        self.dropout = dropout
        self.normalization = normalization
        d = hidden_features
        self.linear1_node = nn.Linear(node_features, hidden_ne_features)
        self.linear2_node = nn.Linear(hidden_ne_features, d)
        self.linear1_edge = nn.Linear(edge_features, hidden_ne_features)
        self.linear2_edge = nn.Linear(hidden_ne_features, d)
        self.gnn = nn.Module()
        self.gnn.convs = nn.ModuleList(
            self._layer(d, normalization, **layer_kw)
            for _ in range(num_layers))
        self.predictor = ScorePredictor(d, hidden_edge_scores, fused=False)
        self.eval()

    def _layer(self, d: int, normalization: str) -> nn.Module:
        raise NotImplementedError

    @classmethod
    def from_config(cls, cfg, **layer_kw):
        return cls(cfg.node_features, cfg.edge_features, cfg.dim_latent,
                   cfg.hidden_ne_features, cfg.num_gnn_layers,
                   cfg.hidden_edge_scores, cfg.dropout, cfg.normalization,
                   **layer_kw)

    @torch.no_grad()
    def init_weights(self, seed: int):
        """Fresh weights from a CPU ``torch.Generator`` seeded with
        ``seed``: linear weights and biases ~ U(+-1/sqrt(fan_in)) (JAX
        ``linear_init``), GAT's attention tensors as JAX ``gat_init`` does
        (normal, xavier scale; bias 0), norms at their init values."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / m.in_features ** 0.5
                for t in (m.weight, m.bias):
                    if t is not None:
                        t.copy_(torch.rand(t.shape, generator=gen)
                                * (2 * bound) - bound)
            elif isinstance(m, (nn.BatchNorm1d, nn.LayerNorm)):
                m.reset_parameters()
            elif isinstance(m, _GATConv):
                m.init_weights(gen)
        return self

    def _drop(self, generator) -> float:
        drop = self.dropout if self.training else 0.0
        if drop > 0.0 and generator is None:
            raise ValueError("training-mode dropout needs a torch.Generator")
        return drop

    def _encode(self, g: DeviceGraph, x, e, slot_io: bool):
        """``(h [N, d], e [E, d] in g's slot order)``."""
        h = mlp2(self.linear1_node, self.linear2_node, x)
        e = mlp2(self.linear1_edge, self.linear2_edge, e)
        return h, (e if slot_io else g.edges_to_slots(e))

    def _predict(self, g: DeviceGraph, h, e_slots, slot_io: bool):
        logits = self.predictor(g, h, e_slots, False)
        return logits if slot_io else g.slots_to_edges(logits)


# ==================================================================== GatedGCN
def _norm_module(d: int, normalization: str) -> nn.Module | None:
    """The norm module a layer holds for ``normalization`` (None: none)."""
    if normalization == "batch":
        return nn.BatchNorm1d(d)
    if normalization == "layer":
        return nn.LayerNorm(d)
    if normalization == "none":
        return None
    raise ValueError(f"normalization={normalization!r}: expected one of "
                     f"{NORMALIZATIONS}")


class _GatedGCNLayer(nn.Module):
    def __init__(self, d: int, normalization: str):
        super().__init__()
        for name in ("A_1", "A_2", "B_1", "B_2", "B_3"):
            setattr(self, name, nn.Linear(d, d))
        self.bn_h = _norm_module(d, normalization)
        self.bn_e = _norm_module(d, normalization)

    def forward(self, g: DeviceGraph, h, e, drop_rate: float, generator):
        """JAX ``_gated_gcn_layer`` (zoo.py:113-134)."""
        d = h.shape[1]
        lins = (self.B_1, self.A_2, self.B_2, self.A_1)
        proj = F.linear(h, torch.cat([m.weight for m in lins]),
                        torch.cat([m.bias for m in lins]))
        g_u = gather_rows(g, "src", proj[:, :2 * d])     # [B1h_u | A2h_u]
        b2h_v = gather_rows(g, "dst", proj[:, 2 * d:3 * d])
        gate = g_u[:, :d] + b2h_v + self.B_3(e)
        e_out = torch.relu(apply_norm(self.bn_e, gate)) + e
        sigma = torch.sigmoid(e_out)
        summed = sum_into(g, "dst", torch.cat([sigma * g_u[:, d:], sigma], 1))
        h_new = proj[:, 3 * d:] + summed[:, :d] / (summed[:, d:] + GATE_EPS)
        h_new = torch.relu(apply_norm(self.bn_h, h_new)) + h
        if drop_rate > 0.0:
            h_new = dropout(h_new, drop_rate, generator)
        return h_new, e_out


class GatedGCN(_ZooModel):
    """GatedGCNModel (reference full_graph.py:33-53).  ``directed=False``
    runs the processor on the graph with reversed edges appended, each
    reversed edge starting from its original's encoded features; the
    predictor takes the first E edge states in host order."""

    kind = "gatedgcn"

    def _layer(self, d, normalization):
        return _GatedGCNLayer(d, normalization)

    def forward(self, g: DeviceGraph, x, e, g_proc=None, generator=None,
                slot_io: bool = False):
        """JAX ``gated_gcn_forward`` (zoo.py:137-179)."""
        with span("model.forward"):
            drop = self._drop(generator)
            h, e = self._encode(g, x, e, slot_io)
            if g_proc is not None:
                # the reversed copies start from their originals' features
                e_host = g.slots_to_edges(e)
                e = g_proc.edges_to_slots(torch.cat([e_host, e_host]))
            gp = g if g_proc is None else g_proc
            for conv in self.gnn.convs:
                h, e = conv(gp, h, e, drop, generator)
            if g_proc is not None:
                e = g.edges_to_slots(g_proc.slots_to_edges(e)[:g.n_edges])
            return self._predict(g, h, e, slot_io)


# ========================================================================= GCN
class GCN(_ZooModel):
    """GCNModel (reference full_graph.py:56-75): ``GraphConv(norm='both')``
    layers on the graph with self-loops."""

    kind = "gcn"

    def _layer(self, d, normalization):
        return nn.Linear(d, d)

    def forward(self, g: DeviceGraph, x, e, g_proc=None, generator=None,
                slot_io: bool = False):
        """JAX ``gcn_forward`` (zoo.py:198-220)."""
        with span("model.forward"):
            h, e = self._encode(g, x, e, slot_io)
            gp = g if g_proc is None else g_proc
            c_src = torch.rsqrt(_degrees(gp.src_ptr))
            c_dst = torch.rsqrt(_degrees(gp.dst_ptr))
            n_layers = len(self.gnn.convs)
            for i, conv in enumerate(self.gnn.convs):
                hs = gather_rows(gp, "src", h * c_src)
                h = conv(sum_into(gp, "dst", hs) * c_dst)
                if i < n_layers - 1:
                    h = torch.relu(h)
            return self._predict(g, h, e, slot_io)


# ========================================================================= GAT
class _GATLayer(torch.autograd.Function):
    """See ``gat_conv``.  Saved: ``feat`` [N, H d], the attention vectors,
    ``el``, ``er``, the denominators ([N, H]), ``expv`` and ``alpha`` ([E,
    H]); nothing [E, H d]."""

    @staticmethod
    def forward(ctx, g, feat, attn_l, attn_r, bias):
        _, _, by_dst, _ = g.roles(False)
        with span("gat.attention"):
            el, er = gat_node_logits(feat, attn_l, attn_r)
            expv = gat_edge_softmax(g.src, g.dst, g.dst_ptr, el, er)
            denom = k2_side_sum(g.dst, by_dst, expv)
        with span("gat.aggregate"):
            msg, alpha = gat_messages(g.src, g.dst, feat, expv, denom)
            out = k2_side_sum(g.dst, by_dst, msg) + bias
        ctx.g = g
        ctx.save_for_backward(feat, attn_l, attn_r, el, er, denom, expv,
                              alpha)
        return out

    @staticmethod
    def backward(ctx, d_out):
        feat, attn_l, attn_r, el, er, denom, expv, alpha = ctx.saved_tensors
        g = ctx.g
        _, _, by_dst, by_src = g.roles(False)
        d_out = d_out.contiguous()
        d_rows, d_expv, pay = gat_message_adjoint(g.src, g.dst, d_out, feat,
                                                  alpha, denom)
        d_feat = k2_side_sum(g.src, by_src, d_rows)
        del d_rows                      # the one [E, H d] transient
        d_denom = k2_side_sum(g.dst, by_dst, pay)
        d_x = gat_logit_adjoint(g.src, g.dst, el, er, expv, d_expv, d_denom)
        d_feat, d_attn = gat_node_adjoint(
            feat, attn_l, attn_r, k2_side_sum(g.src, by_src, d_x),
            k2_side_sum(g.dst, by_dst, d_x), d_feat)
        return None, d_feat, d_attn[0], d_attn[1], d_out.sum(0)


def gat_conv(g: DeviceGraph, feat, attn_l, attn_r, bias):
    """One GATConv after its ``fc`` (JAX ``_gat_layer``, zoo.py:258-280):
    ``out [N, H d]``, ``out[v]`` = the sum over v's in-slots of ``alpha *
    feat[src]`` head by head, plus ``bias``, with ``feat`` [N, H d] (heads
    side by side), ``el[n, h] = <feat[n, h], attn_l[h]>`` and ``er`` alike
    (``attn_*`` [H, d]), ``x = leaky_relu(el[src] + er[dst], 0.2)``, ``expv
    = exp(x - max_v x)`` over each dst's in-slots (the max detached: the
    softmax does not change under a shift, so its gradient, which cancels
    exactly, is left out; a node with no in-slot keeps 0), ``denom`` the
    sums of ``expv`` into dst, ``alpha = expv / max(denom[dst], 1e-9)``.

    Forward, under the span ``gat.attention``: ``gat_node_logits``,
    ``gat_edge_softmax`` and the one-sided K2 walk of ``expv`` (width H);
    under ``gat.aggregate``: ``gat_messages`` (alpha and the weighted rows
    ``feat[src]``), the walk of the messages (width H d) and the bias.
    Backward: ``gat_message_adjoint``, the walks of its weighted cotangent
    rows into src (``feat``'s gradient through the messages) and of the
    denominators' payload into dst, ``gat_logit_adjoint``, the walks of its
    result into src (``el``'s gradient) and dst (``er``'s), then
    ``gat_node_adjoint`` (``feat``'s whole gradient and the attention
    vectors'); the bias's is the cotangent's column sum.  Six walks a
    layer; the ``[E, H d]`` rows live only from a kernel to its walk.
    float32 (and float64 on the CPU)."""
    return _GATLayer.apply(g, feat, attn_l, attn_r, bias)


class _GATConv(nn.Module):
    """One GATConv (DGL semantics): ``fc`` without bias ([H*d, d]),
    attention vectors ``attn_l``/``attn_r`` [H, d], output bias [H*d]."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.fc = nn.Linear(d, heads * d, bias=False)
        self.attn_l = nn.Parameter(torch.empty(heads, d))
        self.attn_r = nn.Parameter(torch.empty(heads, d))
        self.bias = nn.Parameter(torch.empty(heads * d))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """Xavier-normal scale for ``fc`` and the attention vectors, bias 0
        (JAX ``gat_init``, zoo.py:229-238)."""
        d = self.attn_l.shape[1]
        std = math.sqrt(2.0 / (d + d * self.heads))
        for t in (self.fc.weight, self.attn_l, self.attn_r):
            t.copy_(torch.randn(t.shape, generator=gen) * std)
        self.bias.zero_()

    def forward(self, g: DeviceGraph, h, drop_rate: float, generator):
        """JAX ``_gat_layer`` (zoo.py:255-282): ``[N, H*d]``."""
        if drop_rate > 0.0:
            h = dropout(h, drop_rate, generator)
        return gat_conv(g, self.fc(h), self.attn_l, self.attn_r, self.bias)


class GAT(_ZooModel):
    """GATModel (reference full_graph.py:78-97): GATConv layers of
    ``heads`` heads on the graph with self-loops, heads concatenated and
    projected back to d by ``proj.{i}``."""

    kind = "gat"

    def __init__(self, *args, heads: int = 3, **kw):
        super().__init__(*args, heads=heads, **kw)
        d = self.linear2_node.out_features
        self.proj = nn.ModuleList(nn.Linear(heads * d, d)
                                  for _ in self.gnn.convs)
        self.eval()

    def _layer(self, d, normalization, heads):
        return _GATConv(d, heads)

    @classmethod
    def from_config(cls, cfg):
        return super().from_config(cfg, heads=cfg.gat_num_heads)

    def forward(self, g: DeviceGraph, x, e, g_proc=None, generator=None,
                slot_io: bool = False):
        """JAX ``gat_forward`` (zoo.py:285-303)."""
        with span("model.forward"):
            drop = self._drop(generator)
            h, e = self._encode(g, x, e, slot_io)
            gp = g if g_proc is None else g_proc
            n_layers = len(self.gnn.convs)
            for i, (conv, proj) in enumerate(zip(self.gnn.convs, self.proj)):
                h = proj(conv(gp, h, drop, generator))
                if i < n_layers - 1:
                    h = torch.relu(h)
            return self._predict(g, h, e, slot_io)


# ======================================================================== SAGE
class _SAGEConv(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.fc_self = nn.Linear(d, d)
        self.fc_neigh = nn.Linear(d, d)


class SAGE(_ZooModel):
    """SAGEModel (reference full_graph.py:100-119): mean-aggregator
    SAGEConv layers on the graph with self-loops."""

    kind = "sage"

    def _layer(self, d, normalization):
        return _SAGEConv(d)

    def forward(self, g: DeviceGraph, x, e, g_proc=None, generator=None,
                slot_io: bool = False):
        """JAX ``sage_forward`` (zoo.py:321-345)."""
        with span("model.forward"):
            drop = self._drop(generator)
            h, e = self._encode(g, x, e, slot_io)
            gp = g if g_proc is None else g_proc
            deg_in = _degrees(gp.dst_ptr)
            n_layers = len(self.gnn.convs)
            for i, conv in enumerate(self.gnn.convs):
                hi = dropout(h, drop, generator) if drop > 0.0 else h
                mean = sum_into(gp, "dst", gather_rows(gp, "src", hi)) / deg_in
                h = conv.fc_self(hi) + conv.fc_neigh(mean)
                if i < n_layers - 1:
                    h = torch.relu(h)
            return self._predict(g, h, e, slot_io)


# =========================================================== Graph Transformer
GT_CLAMP = 5.0      # the per-head scores' clamp before exp
GT_EPS = 1e-6       # added to the sums of the weights before the divide


def _residual_norm(norm: nn.Module | None, a, b):
    """``apply_norm(norm, a + b)``; a training-mode BatchNorm of float32
    rows is one Function over the residual sum (``residual_batch_norm``:
    hand-written kernels on CUDA), the same arithmetic in fewer passes."""
    if (isinstance(norm, nn.BatchNorm1d) and norm.training
            and a.dtype == torch.float32):
        return residual_batch_norm(norm, a, b)
    return apply_norm(norm, a + b)


class _GTLayer(nn.Module):
    """One ``GraphTransformerLayer`` with edge features (residual, FFN of
    width 2d on nodes and edges): the published module names, its
    ``batch_norm{1,2}_{h,e}`` (or ``layer_norm*``) as ``norm{1,2}_{h,e}``."""

    def __init__(self, d: int, normalization: str, heads: int):
        super().__init__()
        if d % heads:
            raise ValueError(f"dim_latent={d} is not a multiple of "
                             f"gt_num_heads={heads}")
        self.heads = heads
        self.attention = nn.Module()
        for name in ("Q", "K", "V", "proj_e"):
            setattr(self.attention, name, nn.Linear(d, d, bias=False))
        self.O_h, self.O_e = nn.Linear(d, d), nn.Linear(d, d)
        for s in ("h", "e"):
            setattr(self, f"FFN_{s}_layer1", nn.Linear(d, 2 * d))
            setattr(self, f"FFN_{s}_layer2", nn.Linear(2 * d, d))
            for k in (1, 2):
                setattr(self, f"norm{k}_{s}", _norm_module(d, normalization))

    def _ffn(self, s: str, x, drop_rate: float, generator):
        z = torch.relu(getattr(self, f"FFN_{s}_layer1")(x))
        if drop_rate > 0.0:
            z = dropout(z, drop_rate, generator)
        return getattr(self, f"FFN_{s}_layer2")(z)

    def forward(self, g: DeviceGraph, h, e, drop_rate: float, generator):
        """``(h', e')`` for edges src j -> dst i, ``H`` heads of ``dk``:
        ``s_ji = K[j] * Q[i] / sqrt(dk) * P_ji`` ([E, d], ``P = e Wp``),
        ``w_ji = exp(clamp(s_ji summed per head, +-5))`` ([E, H]), ``h_att[i]
        = sum_j w_ji V[j] / (sum_j w_ji + 1e-6)`` per head; then ``h1 =
        norm(h + O_h h_att)``, ``e1 = norm(e + O_e s)`` and ``x' = norm(x1 +
        FFN(x1))`` on both streams.  Dropout (published places): on
        ``h_att`` and ``s``, and after each FFN's relu."""
        n, d = h.shape
        heads, att = self.heads, self.attention
        dk = d // heads
        with span("gt.attention"):
            qkv = F.linear(h, torch.cat([att.Q.weight, att.K.weight,
                                         att.V.weight]))
            p = att.proj_e(e)
            q_dst = gather_rows(g, "dst", qkv[:, :d])
            kv_src = gather_rows(g, "src", qkv[:, d:])      # [K[src] | V[src]]
            s = kv_src[:, :d] * q_dst / math.sqrt(dk) * p
            w = torch.exp(s.view(-1, heads, dk).sum(-1).clamp(-GT_CLAMP,
                                                              GT_CLAMP))
            wv = kv_src[:, d:].view(-1, heads, dk) * w[:, :, None]
            z = sum_into(g, "dst", torch.cat([wv.view(-1, d), w], 1))
            h_att = (z[:, :d].view(n, heads, dk)
                     / (z[:, d:, None] + GT_EPS)).view(n, d)
        with span("gt.feedforward"):
            if drop_rate > 0.0:
                h_att = dropout(h_att, drop_rate, generator)
                s = dropout(s, drop_rate, generator)
            h = _residual_norm(self.norm1_h, h, self.O_h(h_att))
            e = _residual_norm(self.norm1_e, e, self.O_e(s))
            h = _residual_norm(self.norm2_h, h,
                               self._ffn("h", h, drop_rate, generator))
            e = _residual_norm(self.norm2_e, e,
                               self._ffn("e", e, drop_rate, generator))
        return h, e


class GraphTransformer(_ZooModel):
    """GNNome's encoders and unpacked predictor around ``num_layers`` Graph
    Transformer layers with edge features (``_GTLayer``; Dwivedi &
    Bresson, ``GraphTransformerLayer`` of graph_transformer_edge_layer.py)
    of ``heads`` heads, on the directed graph as given; the predictor takes
    the last layer's edge states.  No positional encoding: GNNome's node
    features take its place."""

    kind = GT_NAME

    def __init__(self, *args, heads: int = 8, **kw):
        super().__init__(*args, heads=heads, **kw)

    def _layer(self, d, normalization, heads):
        return _GTLayer(d, normalization, heads)

    @classmethod
    def from_config(cls, cfg):
        if not cfg.directed:
            raise ValueError("model.model=graph_transformer runs on the "
                             "directed graph as given; use "
                             "model.directed=true")
        return super().from_config(cfg, heads=cfg.gt_num_heads)

    def forward(self, g: DeviceGraph, x, e, g_proc=None, generator=None,
                slot_io: bool = False):
        """Logits [E, 1]; ``g_proc`` is always None (``processor_edges``)."""
        with span("model.forward"):
            drop = self._drop(generator)
            h, e = self._encode(g, x, e, slot_io)
            for conv in self.gnn.convs:
                h, e = conv(g, h, e, drop, generator)
            return self._predict(g, h, e, slot_io)


# ==================================================================== registry
ZOO = {"gatedgcn": GatedGCN, "gcn": GCN, "gat": GAT, "sage": SAGE,
       GT_NAME: GraphTransformer}


def get_model(cfg) -> nn.Module:
    """The module ``cfg.model`` names, built from a ``config.ModelConfig``
    in eval mode (JAX ``get_model``, zoo.py:357): ``SymGatedGCN`` for
    ``sym_gatedgcn`` (or ``sym_gated_gcn``), else a zoo model."""
    if cfg.model in SYM_NAMES:
        return SymGatedGCN(cfg.node_features, cfg.edge_features,
                           cfg.dim_latent, cfg.hidden_ne_features,
                           cfg.num_gnn_layers, cfg.hidden_edge_scores,
                           cfg.dropout, cfg.normalization)
    if cfg.model in ZOO:
        return ZOO[cfg.model].from_config(cfg)
    raise ValueError(f"Unknown model: {cfg.model!r}; choose from "
                     f"{['sym_gatedgcn', *sorted(ZOO)]}")
