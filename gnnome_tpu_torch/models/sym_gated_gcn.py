"""SymGatedGCN edge-scoring model as an ``nn.Module`` (eval forward).

The PyTorch counterpart of ``gnnome_tpu/models/sym_gated_gcn.py``'s fused
eval path (reference models/full_graph.py:9-30, layers/gated_gcn_full.py:
82-142, layers/score_predictor.py:5-24).  Submodule and parameter names are
the reference's (``linear1_node`` ... ``gnn.convs.{i}.A_1`` ... ``bn_h``,
``bn_e``, ``predictor.W1``), so its ``weights.pt`` loads directly and
``weights/weights.npz`` loads through ``models/convert.py``.

Per layer, as in the JAX package:

* one fused node projection ``h @ [B1|A2|B2|A3|A1]`` (a plain matmul);
* ``b3e = e @ B3 + b``, then the whole edge stage in kernel K3 (gate,
  eval BatchNorm, relu, residual, sigmoid, both gated sums);
* the node stage: gated means with ``GATE_EPS``, ``A1h + h_fwd + h_bwd``,
  eval BatchNorm, relu, residual.

The predictor moves the first layer's endpoint matmuls into node space
(``puv = [h @ W1[:d] | h @ W1[d:2d]]``, ``be = e @ W1[2d:] + b1``), gathers
and adds them per edge in kernel K6, then runs the two small matmuls.  Edges
stay in dst-sorted slot order between the encoder and the logits; the
logits come back in host edge order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.graph_tensors import DeviceGraph
from ..ops.message import eval_edge_stage, score_gate
from .nn import mlp2
from .norm import batch_norm_eval, batch_norm_rows

GATE_EPS = 1e-6  # gated-mean denominator epsilon (reference gated_gcn_full.py:114)


class SymGatedGCNLayer(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        for name in ("A_1", "A_2", "A_3", "B_1", "B_2", "B_3"):
            setattr(self, name, nn.Linear(d, d))
        self.bn_h = nn.BatchNorm1d(d)
        self.bn_e = nn.BatchNorm1d(d)

    def forward(self, g: DeviceGraph, h, e, flip: bool):
        d = h.shape[1]
        # column groups: [B1|A2] (u endpoint), [B2|A3] (v endpoint), [A1]
        lins = (self.B_1, self.A_2, self.B_2, self.A_3, self.A_1)
        proj = F.linear(h, torch.cat([m.weight for m in lins]),
                        torch.cat([m.bias for m in lins]))
        e_out, sum_v, sum_u = eval_edge_stage(
            g, proj[:, :2 * d], proj[:, 2 * d:4 * d], self.B_3(e), e,
            batch_norm_rows(self.bn_e), flip=flip)
        h_fwd = sum_v[:, :d] / (sum_v[:, d:] + GATE_EPS)
        h_bwd = sum_u[:, :d] / (sum_u[:, d:] + GATE_EPS)
        h_new = proj[:, 4 * d:] + h_fwd + h_bwd
        h_new = torch.relu(batch_norm_eval(self.bn_h, h_new)) + h
        return h_new, e_out


class _Convs(nn.Module):
    def __init__(self, num_layers: int, d: int):
        super().__init__()
        self.convs = nn.ModuleList(SymGatedGCNLayer(d)
                                   for _ in range(num_layers))


class ScorePredictor(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.W1 = nn.Linear(3 * d, hidden)
        self.W2 = nn.Linear(hidden, 32)
        self.W3 = nn.Linear(32, 1)

    def forward(self, g: DeviceGraph, h, e, flip: bool):
        d = h.shape[1]
        w1 = self.W1.weight                               # [H, 3d]
        puv = torch.cat([F.linear(h, w1[:, :d]),
                         F.linear(h, w1[:, d:2 * d])], dim=1)
        be = F.linear(e, w1[:, 2 * d:], self.W1.bias)
        z = score_gate(g, flip, puv, be)
        return self.W3(torch.relu(self.W2(z)))


class SymGatedGCN(nn.Module):
    """Eval-only SymGatedGCN.  ``forward(g, x, e, flip)`` takes node features
    ``x`` [N, node_features] and host-order edge features ``e``
    [E, edge_features] on ``g``'s device and returns host-order logits
    [E, 1].  Calling it in training mode raises: the training forward is not
    ported yet."""

    def __init__(self, node_features: int = 2, edge_features: int = 2,
                 hidden_features: int = 64, hidden_ne_features: int = 16,
                 num_layers: int = 8, hidden_edge_scores: int = 64):
        super().__init__()
        self.linear1_node = nn.Linear(node_features, hidden_ne_features)
        self.linear2_node = nn.Linear(hidden_ne_features, hidden_features)
        self.linear1_edge = nn.Linear(edge_features, hidden_ne_features)
        self.linear2_edge = nn.Linear(hidden_ne_features, hidden_features)
        self.gnn = _Convs(num_layers, hidden_features)
        self.predictor = ScorePredictor(hidden_features, hidden_edge_scores)
        self.eval()

    @classmethod
    def from_config(cls, cfg) -> "SymGatedGCN":
        """From a ``config.ModelConfig``; only the batch-norm SymGatedGCN
        is ported."""
        if cfg.model != "sym_gatedgcn" or cfg.normalization != "batch":
            raise NotImplementedError(
                f"model={cfg.model!r} normalization={cfg.normalization!r}: "
                "only sym_gatedgcn with batch normalization is ported")
        return cls(cfg.node_features, cfg.edge_features, cfg.dim_latent,
                   cfg.hidden_ne_features, cfg.num_gnn_layers,
                   cfg.hidden_edge_scores)

    def forward(self, g: DeviceGraph, x, e, flip: bool = False):
        if self.training:
            raise NotImplementedError("the SymGatedGCN training forward is "
                                      "not ported yet; call .eval()")
        h = mlp2(self.linear1_node, self.linear2_node, x)
        e = g.edges_to_slots(mlp2(self.linear1_edge, self.linear2_edge, e))
        for conv in self.gnn.convs:
            h, e = conv(g, h, e, flip)
        return g.slots_to_edges(self.predictor(g, h, e, flip))
