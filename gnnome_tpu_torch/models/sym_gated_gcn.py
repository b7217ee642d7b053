"""SymGatedGCN edge-scoring model as an ``nn.Module``.

The PyTorch counterpart of ``gnnome_tpu/models/sym_gated_gcn.py``
(reference models/full_graph.py:9-30, layers/gated_gcn_full.py:82-142,
layers/score_predictor.py:5-24).  Submodule and parameter names are the
reference's (``linear1_node`` ... ``gnn.convs.{i}.A_1`` ... ``bn_h``,
``bn_e``, ``predictor.W1``), so its ``weights.pt`` loads directly and
``weights/weights.npz`` loads through ``models/convert.py``.
``normalization`` is the reference's choice (gated_gcn_full.py:37-42):
``batch`` (``bn_h``/``bn_e`` are ``BatchNorm1d``), ``layer``
(``LayerNorm``) or ``none`` (no norm submodules).

Batch norm, per layer in eval mode (``.eval()``, which ``__init__`` sets),
as in the JAX package's fused path:

* one fused node projection ``h @ [B1|A2|B2|A3|A1]`` (a plain matmul);
* ``b3e = e @ B3 + b``, then the whole edge stage in kernel K3 (gate,
  eval BatchNorm, relu, residual, sigmoid, both gated sums);
* the node stage: gated means with ``GATE_EPS``, ``A1h + h_fwd + h_bwd``,
  eval BatchNorm, relu, residual.

In training mode (``.train()``; sym_gated_gcn.py:185-258) the edge stage is
``ops.message.train_edge_stage`` (K7 batch statistics, K3 with them, K8 in
the backward; ``bn_e``'s running statistics advance twice), ``A1h`` is its
own matmul, the node BatchNorm uses batch statistics, and dropout draws
its mask from the caller's ``torch.Generator``.

Layer norm and none run the JAX package's unfused layer
(sym_gated_gcn.py:149-172,215-258), the same in eval and training: the
fused projection and ``b3e``, the endpoint gathers and gate in K1
(``gate_gather``), the norm, relu, residual, sigmoid, both gated means in
one K2 (``gated_mean_pair``), ``A1h + h_fwd + h_bwd``, the norm, relu,
residual, and dropout in training.

The batch-norm predictor moves the first layer's endpoint matmuls into node
space (``puv = [h @ W1[:d] | h @ W1[d:2d]]``, ``be = e @ W1[2d:] + b1``),
gathers and adds them per edge in kernel K6, then runs the two small
matmuls.  The other normalisations take JAX's unpacked predictor
(sym_gated_gcn.py:572-576): ``gather_uv`` (K2 in its backward), ``[h[u] |
h[v] | e] @ W1 + b1``, relu, W2, relu, W3.  Edges stay in dst-sorted slot
order between the encoder and the logits; the logits come back in host
edge order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.graph_tensors import DeviceGraph
from ..ops.message import (eval_edge_stage, gate_gather, gated_mean_pair,
                           gather_uv, score_gate, train_edge_stage)
from .nn import dropout, mlp2
from .norm import (apply_norm, batch_norm_eval, batch_norm_rows,
                   batch_norm_train, update_running_stats)

GATE_EPS = 1e-6  # gated-mean denominator epsilon (reference gated_gcn_full.py:114)
NORMALIZATIONS = ("batch", "layer", "none")


class SymGatedGCNLayer(nn.Module):
    def __init__(self, d: int, normalization: str = "batch"):
        super().__init__()
        if normalization not in NORMALIZATIONS:
            raise ValueError(f"normalization={normalization!r}: expected one "
                             f"of {NORMALIZATIONS}")
        self.normalization = normalization
        for name in ("A_1", "A_2", "A_3", "B_1", "B_2", "B_3"):
            setattr(self, name, nn.Linear(d, d))
        if normalization == "batch":
            self.bn_h = nn.BatchNorm1d(d)
            self.bn_e = nn.BatchNorm1d(d)
        elif normalization == "layer":
            self.bn_h = nn.LayerNorm(d)
            self.bn_e = nn.LayerNorm(d)
        else:
            self.bn_h = self.bn_e = None

    def _projection(self, h):
        """``h @ [B1|A2|B2|A3|A1] + b``: column groups [B1|A2] (u
        endpoint), [B2|A3] (v endpoint), [A1]."""
        lins = (self.B_1, self.A_2, self.B_2, self.A_3, self.A_1)
        return F.linear(h, torch.cat([m.weight for m in lins]),
                        torch.cat([m.bias for m in lins]))

    def forward(self, g: DeviceGraph, h, e, flip: bool, drop_rate: float = 0.0,
                generator=None):
        if self.normalization != "batch":
            return self._forward_unfused(g, h, e, flip, drop_rate, generator)
        if self.training:
            return self._forward_train(g, h, e, flip, drop_rate, generator)
        d = h.shape[1]
        proj = self._projection(h)
        e_out, sum_v, sum_u = eval_edge_stage(
            g, proj[:, :2 * d], proj[:, 2 * d:4 * d], self.B_3(e), e,
            batch_norm_rows(self.bn_e), flip=flip)
        h_fwd = sum_v[:, :d] / (sum_v[:, d:] + GATE_EPS)
        h_bwd = sum_u[:, :d] / (sum_u[:, d:] + GATE_EPS)
        h_new = proj[:, 4 * d:] + h_fwd + h_bwd
        h_new = torch.relu(batch_norm_eval(self.bn_h, h_new)) + h
        return h_new, e_out

    def _forward_train(self, g: DeviceGraph, h, e, flip: bool,
                       drop_rate: float, generator):
        d = h.shape[1]
        lins = (self.B_1, self.A_2, self.B_2, self.A_3)
        w_uv = torch.cat([m.weight for m in lins]).t()     # [d, 4d], [in, out]
        b_uv = torch.cat([m.bias for m in lins])
        e_out, sum_v, sum_u, mean, unbiased = train_edge_stage(
            g, flip, h, w_uv, b_uv, self.B_3.weight.t(), self.B_3.bias, e,
            self.bn_e.weight, self.bn_e.bias)
        update_running_stats(self.bn_e, mean, unbiased, repeat_updates=2)
        h_fwd = sum_v[:, :d] / (sum_v[:, d:] + GATE_EPS)
        h_bwd = sum_u[:, :d] / (sum_u[:, d:] + GATE_EPS)
        h_new = self.A_1(h) + h_fwd + h_bwd
        h_new = torch.relu(batch_norm_train(self.bn_h, h_new)) + h
        if drop_rate > 0.0:
            h_new = dropout(h_new, drop_rate, generator)
        return h_new, e_out

    def _forward_unfused(self, g: DeviceGraph, h, e, flip: bool,
                         drop_rate: float, generator):
        d = h.shape[1]
        proj = self._projection(h)
        g3 = gate_gather(g, flip, proj[:, :2 * d], proj[:, 2 * d:4 * d],
                         self.B_3(e))
        e_out = torch.relu(apply_norm(self.bn_e, g3[:, :d])) + e
        h_fwd, h_bwd = gated_mean_pair(g, flip, torch.sigmoid(e_out),
                                       g3[:, d:2 * d], g3[:, 2 * d:],
                                       GATE_EPS)
        h_new = proj[:, 4 * d:] + h_fwd + h_bwd
        h_new = torch.relu(apply_norm(self.bn_h, h_new)) + h
        if drop_rate > 0.0:
            h_new = dropout(h_new, drop_rate, generator)
        return h_new, e_out


class _Convs(nn.Module):
    def __init__(self, num_layers: int, d: int, normalization: str):
        super().__init__()
        self.convs = nn.ModuleList(SymGatedGCNLayer(d, normalization)
                                   for _ in range(num_layers))


class ScorePredictor(nn.Module):
    """``fused``: the K6 form (batch norm); else the unpacked form."""

    def __init__(self, d: int, hidden: int, fused: bool = True):
        super().__init__()
        self.fused = fused
        self.W1 = nn.Linear(3 * d, hidden)
        self.W2 = nn.Linear(hidden, 32)
        self.W3 = nn.Linear(32, 1)

    def forward(self, g: DeviceGraph, h, e, flip: bool):
        if not self.fused:
            h_u, h_v = gather_uv(g, flip, h)
            z = torch.relu(self.W1(torch.cat([h_u, h_v, e], dim=1)))
            return self.W3(torch.relu(self.W2(z)))
        d = h.shape[1]
        w1 = self.W1.weight                               # [H, 3d]
        puv = torch.cat([F.linear(h, w1[:, :d]),
                         F.linear(h, w1[:, d:2 * d])], dim=1)
        be = F.linear(e, w1[:, 2 * d:], self.W1.bias)
        z = score_gate(g, flip, puv, be)
        return self.W3(torch.relu(self.W2(z)))


class SymGatedGCN(nn.Module):
    """SymGatedGCN.  ``forward(g, x, e, flip)`` takes node features ``x``
    [N, node_features] and host-order edge features ``e`` [E, edge_features]
    on ``g``'s device and returns host-order logits [E, 1]
    (``slot_io=True``: ``e`` and the logits in ``g``'s slot order).  It is
    built in eval mode; ``.train()`` selects the training forward, whose
    dropout (rate ``dropout``) needs a ``generator``.  ``normalization`` is
    ``batch``, ``layer`` or ``none``."""

    def __init__(self, node_features: int = 2, edge_features: int = 2,
                 hidden_features: int = 64, hidden_ne_features: int = 16,
                 num_layers: int = 8, hidden_edge_scores: int = 64,
                 dropout: float = 0.0, normalization: str = "batch"):
        super().__init__()
        self.dropout = dropout
        self.normalization = normalization
        self.linear1_node = nn.Linear(node_features, hidden_ne_features)
        self.linear2_node = nn.Linear(hidden_ne_features, hidden_features)
        self.linear1_edge = nn.Linear(edge_features, hidden_ne_features)
        self.linear2_edge = nn.Linear(hidden_ne_features, hidden_features)
        self.gnn = _Convs(num_layers, hidden_features, normalization)
        self.predictor = ScorePredictor(hidden_features, hidden_edge_scores,
                                        fused=normalization == "batch")
        self.eval()

    @classmethod
    def from_config(cls, cfg) -> "SymGatedGCN":
        """From a ``config.ModelConfig``; only the SymGatedGCN is ported
        (the zoo models are not)."""
        if cfg.model != "sym_gatedgcn":
            raise NotImplementedError(
                f"model={cfg.model!r}: only sym_gatedgcn is ported")
        return cls(cfg.node_features, cfg.edge_features, cfg.dim_latent,
                   cfg.hidden_ne_features, cfg.num_gnn_layers,
                   cfg.hidden_edge_scores, cfg.dropout, cfg.normalization)

    @torch.no_grad()
    def init_weights(self, seed: int) -> "SymGatedGCN":
        """Fresh weights drawn from a CPU ``torch.Generator`` seeded with
        ``seed``: every linear weight and bias ~ U(+-1/sqrt(fan_in)) (the
        torch ``nn.Linear`` default and JAX ``linear_init``); BatchNorm
        scale 1, shift 0, running mean 0, running var 1, count 0; LayerNorm
        weight 1, bias 0."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / m.in_features ** 0.5
                for t in (m.weight, m.bias):
                    t.copy_(torch.rand(t.shape, generator=gen) * (2 * bound)
                            - bound)
            elif isinstance(m, (nn.BatchNorm1d, nn.LayerNorm)):
                m.reset_parameters()
        return self

    def forward(self, g: DeviceGraph, x, e, flip: bool = False,
                generator=None, slot_io: bool = False):
        drop = self.dropout if self.training else 0.0
        if drop > 0.0 and generator is None:
            raise ValueError("training-mode dropout needs a torch.Generator")
        h = mlp2(self.linear1_node, self.linear2_node, x)
        e = mlp2(self.linear1_edge, self.linear2_edge, e)
        if not slot_io:
            e = g.edges_to_slots(e)
        for conv in self.gnn.convs:
            h, e = conv(g, h, e, flip, drop, generator)
        logits = self.predictor(g, h, e, flip)
        return logits if slot_io else g.slots_to_edges(logits)

    def forward_pair(self, g: DeviceGraph, x, x_rev, e, generator=None,
                     slot_io: bool = False):
        """Both symmetry-loss passes (reference train.py:159-185), one after
        the other: ``flip=False`` on ``x``, then ``flip=True`` on ``x_rev``,
        BatchNorm running statistics chained through the module.  The JAX
        package's ``forward_dual`` documents its fused form as equal to
        these two passes, and runs them for normalisations other than
        batch.  Returns ``(logits_org, logits_rev)``."""
        return (self(g, x, e, False, generator, slot_io),
                self(g, x_rev, e, True, generator, slot_io))
