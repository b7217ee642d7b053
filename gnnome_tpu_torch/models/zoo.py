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

Every reduction into nodes is ``ops.message.sum_into`` (the one-sided K2
walk) and every endpoint gather ``gather_rows`` (its backward is that
walk), so training stays bitwise reproducible on the card.  Each module's
``forward(g, x, e, g_proc=None, generator=None, slot_io=False)`` takes the
original graph ``g``, its processor graph ``g_proc`` (None: ``g`` itself)
and returns logits [E, 1] as ``SymGatedGCN.forward`` does.

Spans (``utils.timing``): each model's forward is ``model.forward``; in
each GATConv, the attention (``el``/``er``, edge logits, the segment max,
``exp``, denominators, ``alpha``) is ``gat.attention`` and the messages
(the gather, the weighting, the sum into nodes, the bias) are
``gat.aggregate``, ``fc`` and ``proj`` outside both.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.graph_tensors import DeviceGraph
from ..ops.message import gather_rows, sum_into
from ..utils.timing import span
from .nn import dropout, mlp2
from .norm import apply_norm
from .sym_gated_gcn import (GATE_EPS, NORMALIZATIONS, ScorePredictor,
                            SymGatedGCN)

SYM_NAMES = ("sym_gatedgcn", "sym_gated_gcn")
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
    SymGatedGCN; a directed GatedGCN) (JAX ``processor_graph_for``,
    zoo.py:370-382)."""
    name = model_cfg.model
    if name in SYM_NAMES:
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
class _GatedGCNLayer(nn.Module):
    def __init__(self, d: int, normalization: str):
        super().__init__()
        if normalization not in NORMALIZATIONS:
            raise ValueError(f"normalization={normalization!r}: expected one "
                             f"of {NORMALIZATIONS}")
        for name in ("A_1", "A_2", "B_1", "B_2", "B_3"):
            setattr(self, name, nn.Linear(d, d))
        if normalization == "batch":
            self.bn_h, self.bn_e = nn.BatchNorm1d(d), nn.BatchNorm1d(d)
        elif normalization == "layer":
            self.bn_h, self.bn_e = nn.LayerNorm(d), nn.LayerNorm(d)
        else:
            self.bn_h = self.bn_e = None

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
        n, d = h.shape
        heads = self.heads
        if drop_rate > 0.0:
            h = dropout(h, drop_rate, generator)
        feat = self.fc(h)                                    # [N, H*d]
        with span("gat.attention"):
            f3 = feat.view(n, heads, d)
            el = (f3 * self.attn_l).sum(-1)                  # [N, H]
            er = (f3 * self.attn_r).sum(-1)
            logit = F.leaky_relu(gather_rows(g, "src", el)
                                 + gather_rows(g, "dst", er), 0.2)
            # The per-destination max only shifts the softmax, which does
            # not change under a shift: detached, its gradient (which
            # cancels exactly in the softmax) is left out.  A max is exact
            # in any order, so scatter_reduce's order on the card changes
            # no bit.  Nodes without in-edges keep 0 (zoo.py:266).
            with torch.no_grad():
                idx = g.dst.long()[:, None].expand(-1, heads)
                seg_max = logit.new_zeros(n, heads).scatter_reduce(
                    0, idx, logit, "amax", include_self=False)
            expv = torch.exp(logit - seg_max.index_select(0, g.dst))
            denom = sum_into(g, "dst", expv)                 # [N, H]
            alpha = expv / gather_rows(g, "dst", denom).clamp_min(1e-9)
        with span("gat.aggregate"):
            msg = (gather_rows(g, "src", feat).view(-1, heads, d)
                   * alpha[:, :, None])
            return sum_into(g, "dst", msg.reshape(-1, heads * d)) + self.bias


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


# ==================================================================== registry
ZOO = {"gatedgcn": GatedGCN, "gcn": GCN, "gat": GAT, "sage": SAGE}


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
