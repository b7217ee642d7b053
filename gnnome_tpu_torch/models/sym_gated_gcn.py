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
fused projection and ``b3e``, the endpoint gathers and gate in K1, the
norm, relu, residual, sigmoid, both gated means' sums in one K2,
``A1h + h_fwd + h_bwd``, the norm, relu, residual, and dropout in
training.  The edge stage from K1 to K2 takes one of two routes, by the
dtype of K1's operands: float32 runs ``unfused_edge_stage`` (one autograd
Function: K1, the layer-norm edge stage kernel, K2; backward its adjoint
kernel and K2), bf16 the chain of ``gate_gather``, ``apply_norm``, relu,
residual, sigmoid and ``gated_mean_pair``, which keeps the JAX package's
type promotion (the table below).

Both symmetry-loss passes at once (``forward_dual``, batch norm only; JAX
``forward_dual``, sym_gated_gcn.py:290-402): node states ``[N, 2d]`` =
[org | flip] and edge states ``[E, 2d]`` (starting from ``[e | e]``) run
one pass at doubled width with flip=False.  The endpoint projection is
block-diagonal, ``[bd(B1,B2) | bd(A2,A3) | bd(B2,B1) | bd(A3,A2)]``: the
flip pass's u role is the dst endpoint, so its gate takes B2h at src and
B1h at dst.  A weight that both halves share (A1, B3, the predictor's
W1e, W2, W3) runs as one GEMM over the halves stacked as rows, with one
pass's flops: the JAX form's block-diagonal ``bd(W, W)`` doubled them and
measured 3.6 ms slower per golden-graph step on an H100 (PERF.md §6).
The edge stage runs K7/K3 (K8 backward) at width 2d, the node stage
``batch_norm_dual``, and the predictor K6 (K9 backward) at width 2H, so a
step launches half the kernels of two passes.

The batch-norm predictor moves the first layer's endpoint matmuls into node
space (``puv = [h @ W1[:d] | h @ W1[d:2d]]``, ``be = e @ W1[2d:] + b1``),
gathers and adds them per edge in kernel K6, then runs the two small
matmuls.  The other normalisations take JAX's unpacked predictor
(sym_gated_gcn.py:572-576): ``gather_uv`` (K2 in its backward), ``[h[u] |
h[v] | e] @ W1 + b1``, relu, W2, relu, W3.  Edges stay in dst-sorted slot
order between the encoder and the logits; the logits come back in host
edge order.

Compute dtype (``dtype``; JAX ``compute.dtype``, sym_gated_gcn.py:21-22):
float32 or bfloat16, for every normalisation.  In bf16 the parameters stay
float32 (Adam, checkpoints and the converters see float32); where they are
used they are rounded to bf16 and then cast to the activations' dtype, as
the JAX package's ``.astype(dtype)`` and type promotion do; the encoders
run in float32 and their outputs are cast to bf16; the logits are cast to
float32 before they leave the model.  The model hands the compute dtype to
each layer and to the predictor, because the activations' dtype is not it
everywhere:

* batch norm: the layers' matmuls, gathers and gates, K3/K6/K7/K8/K9 and
  the gated means run in bf16; BatchNorm computes in float32 and returns
  bf16 (``models/norm.py``), so ``h`` and ``e`` stay bf16 throughout;
* none: ``h`` and ``e`` stay bf16 too: K1 in bf16, the gated means' K2
  over bf16 payloads (float32 sums, divided in float32, cast to bf16);
* layer norm: the first layer's projections and K1 run in bf16, but
  LayerNorm computes its statistics in bf16 and multiplies by the float32
  weight and bias, so its output, ``e_out``, ``sigma``, the K2 payloads
  and the layer's ``h`` and ``e`` are float32 (the JAX package's type
  promotion, norm.py:111-115); from layer 2 on the layers, K1, K2 and the
  predictor compute in float32 with bf16-rounded weights and biases.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.graph_tensors import DeviceGraph
from ..ops.message import (blocks_linear, eval_edge_stage, gate_gather,
                           gated_mean_pair, gather_uv, score_gate,
                           train_edge_stage, unfused_edge_stage)
from ..utils.timing import span
from .nn import dropout, mlp2
from .norm import (LN_EPS, apply_norm, batch_norm_dual, batch_norm_eval,
                   batch_norm_rows, batch_norm_train, update_running_stats)

GATE_EPS = 1e-6  # gated-mean denominator epsilon (reference gated_gcn_full.py:114)
NORMALIZATIONS = ("batch", "layer", "none")


def _bd_cols(pairs):
    """``[out, 2 in]`` weight whose output groups are ``[x, 0]`` or
    ``[0, x]``: ``pairs`` lists ``(weight, half)``, ``half`` 0 reading the
    org half of the input and 1 the flip half.  The transpose of the JAX
    ``_dual_wuv`` column blocks, built with three concatenations."""
    z = pairs[0][0].new_zeros(pairs[0][0].shape)
    left = torch.cat([w if half == 0 else z for w, half in pairs])
    right = torch.cat([w if half == 1 else z for w, half in pairs])
    return torch.cat([left, right], 1)


def _at(w, x, dtype=None):
    """The float32 parameter ``w`` as ``x``'s operand: rounded to the
    compute dtype ``dtype`` (default ``x``'s), then cast to ``x``'s dtype
    (JAX ``w.astype(dtype)`` promoted against ``x``)."""
    return w.to(dtype or x.dtype).to(x.dtype)


def _linear(m: nn.Linear, x, dtype=None):
    """``m(x)`` in ``x``'s dtype, the parameters as ``_at`` casts them."""
    return F.linear(x, _at(m.weight, x, dtype), _at(m.bias, x, dtype))


def _gated_means(s, d):
    """``[gm(s, org) | gm(s, flip)]`` of a dual sum ``s`` = [m_org | m_flip
    | sig_org | sig_flip] ([N, 4d])."""
    return s[:, :2 * d] / (s[:, 2 * d:] + GATE_EPS)


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

    def _projection(self, h, dtype=None):
        """``h @ [B1|A2|B2|A3|A1] + b``: column groups [B1|A2] (u
        endpoint), [B2|A3] (v endpoint), [A1]."""
        lins = (self.B_1, self.A_2, self.B_2, self.A_3, self.A_1)
        return F.linear(h, _at(torch.cat([m.weight for m in lins]), h, dtype),
                        _at(torch.cat([m.bias for m in lins]), h, dtype))

    def forward(self, g: DeviceGraph, h, e, flip: bool, drop_rate: float = 0.0,
                generator=None, dtype=None):
        """One layer; ``dtype`` the compute dtype (default ``h``'s), which
        the layer-norm model's float32 layers need (module docstring)."""
        if self.normalization != "batch":
            return self._forward_unfused(g, h, e, flip, drop_rate, generator,
                                         dtype)
        if self.training:
            return self._forward_train(g, h, e, flip, drop_rate, generator)
        d = h.shape[1]
        proj = self._projection(h)
        e_out, sum_v, sum_u = eval_edge_stage(
            g, proj[:, :2 * d], proj[:, 2 * d:4 * d], _linear(self.B_3, e), e,
            batch_norm_rows(self.bn_e, h.dtype), flip=flip)
        h_fwd = sum_v[:, :d] / (sum_v[:, d:] + GATE_EPS)
        h_bwd = sum_u[:, :d] / (sum_u[:, d:] + GATE_EPS)
        h_new = proj[:, 4 * d:] + h_fwd + h_bwd
        h_new = torch.relu(batch_norm_eval(self.bn_h, h_new)) + h
        return h_new, e_out

    def _forward_train(self, g: DeviceGraph, h, e, flip: bool,
                       drop_rate: float, generator):
        d, dt = h.shape[1], h.dtype
        lins = (self.B_1, self.A_2, self.B_2, self.A_3)
        w_uv = torch.cat([m.weight for m in lins]).t()     # [d, 4d], [in, out]
        b_uv = torch.cat([m.bias for m in lins])
        e_out, sum_v, sum_u, mean, unbiased = train_edge_stage(
            g, flip, h, w_uv.to(dt), b_uv.to(dt), self.B_3.weight.t().to(dt),
            self.B_3.bias.to(dt), e, self.bn_e.weight, self.bn_e.bias)
        update_running_stats(self.bn_e, mean, unbiased, repeat_updates=2)
        h_fwd = sum_v[:, :d] / (sum_v[:, d:] + GATE_EPS)
        h_bwd = sum_u[:, :d] / (sum_u[:, d:] + GATE_EPS)
        h_new = _linear(self.A_1, h) + h_fwd + h_bwd
        h_new = torch.relu(batch_norm_train(self.bn_h, h_new)) + h
        if drop_rate > 0.0:
            h_new = dropout(h_new, drop_rate, generator)
        return h_new, e_out

    def _dual_uv(self):
        """The dual endpoint projection ``[2d] -> [8d]`` as an ``nn.Linear``
        weight and bias: column groups (u gate, u msg, v gate, v msg), each
        [org | flip] = [B1|B2], [A2|A3], [B2|B1], [A3|A2] (JAX
        ``_dual_wuv``)."""
        B1, A2, B2, A3 = self.B_1, self.A_2, self.B_2, self.A_3
        order = ((B1, 0), (B2, 1), (A2, 0), (A3, 1),
                 (B2, 0), (B1, 1), (A3, 0), (A2, 1))
        return (_bd_cols([(m.weight, half) for m, half in order]),
                torch.cat([m.bias for m, _ in order]))

    def forward_dual(self, g: DeviceGraph, h2, e2, drop_rate: float = 0.0,
                     generator=None):
        """One layer over both symmetry passes (JAX ``_layer_dual``,
        sym_gated_gcn.py:308-378), batch norm only: ``h2`` [N, 2d] and
        ``e2`` [E, 2d], each [org | flip]."""
        d, dt = h2.shape[1] // 2, h2.dtype
        w_uv, b_uv = self._dual_uv()
        w_uv, b_uv = w_uv.to(dt), b_uv.to(dt)
        w3, b3 = self.B_3.weight.t().to(dt), self.B_3.bias.to(dt)
        if self.training:
            e_out, sum_v, sum_u, mean, unbiased = train_edge_stage(
                g, False, h2, w_uv.t(), b_uv, w3, b3, e2,
                torch.cat([self.bn_e.weight, self.bn_e.weight]),
                torch.cat([self.bn_e.bias, self.bn_e.bias]))
            # the org pass's two updates, then the flip pass's two
            update_running_stats(self.bn_e, mean, unbiased, repeat_updates=2,
                                 halves=2)
        else:
            proj = F.linear(h2, w_uv, b_uv)
            e_out, sum_v, sum_u = eval_edge_stage(
                g, proj[:, :4 * d], proj[:, 4 * d:],
                blocks_linear(e2, w3, b3), e2,
                batch_norm_rows(self.bn_e, dt).repeat(1, 2))
        # the flip pass's forward aggregation is keyed by src: its halves
        # come from sum_u
        gv, gu = _gated_means(sum_v, d), _gated_means(sum_u, d)
        h_fwd = torch.cat([gv[:, :d], gu[:, d:]], 1)
        h_bwd = torch.cat([gu[:, :d], gv[:, d:]], 1)
        a1 = blocks_linear(h2, self.A_1.weight.t().to(dt),
                           self.A_1.bias.to(dt))
        h_new = a1 + h_fwd + h_bwd
        h_new = torch.relu(batch_norm_dual(self.bn_h, h_new)) + h2
        if drop_rate > 0.0:
            h_new = dropout(h_new, drop_rate, generator)
        return h_new, e_out

    def _forward_unfused(self, g: DeviceGraph, h, e, flip: bool,
                         drop_rate: float, generator, dtype=None):
        d = h.shape[1]
        proj = self._projection(h, dtype)
        proj_u, proj_v = proj[:, :2 * d], proj[:, 2 * d:4 * d]
        b3e = _linear(self.B_3, e, dtype)
        if proj.dtype == torch.bfloat16:
            g3 = gate_gather(g, flip, proj_u, proj_v, b3e)
            e_out = torch.relu(apply_norm(self.bn_e, g3[:, :d])) + e
            h_fwd, h_bwd = gated_mean_pair(g, flip, torch.sigmoid(e_out),
                                           g3[:, d:2 * d], g3[:, 2 * d:],
                                           GATE_EPS)
        else:
            ln = self.bn_e
            e_out, sum_u, sum_v = unfused_edge_stage(
                g, flip, proj_u, proj_v, b3e, e,
                None if ln is None else ln.weight,
                None if ln is None else ln.bias, LN_EPS)
            h_fwd = sum_v[:, :d] / (sum_v[:, d:] + GATE_EPS)
            h_bwd = sum_u[:, :d] / (sum_u[:, d:] + GATE_EPS)
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

    def forward(self, g: DeviceGraph, h, e, flip: bool, dtype=None):
        """Logits [E, 1] in ``h``'s dtype; ``dtype`` the compute dtype
        (default ``h``'s), whose rounding the unpacked form's weights take
        (JAX score_edges, sym_gated_gcn.py:547-577)."""
        if not self.fused:
            h_u, h_v = gather_uv(g, flip, h)
            z = torch.relu(_linear(self.W1, torch.cat([h_u, h_v, e], dim=1),
                                   dtype))
            return _linear(self.W3, torch.relu(_linear(self.W2, z, dtype)),
                           dtype)
        d, dt = h.shape[1], h.dtype
        w1 = self.W1.weight.to(dt)                        # [H, 3d]
        puv = torch.cat([F.linear(h, w1[:, :d]),
                         F.linear(h, w1[:, d:2 * d])], dim=1)
        be = F.linear(e, w1[:, 2 * d:], self.W1.bias.to(dt))
        z = score_gate(g, flip, puv, be)
        return _linear(self.W3, torch.relu(_linear(self.W2, z)))

    def forward_dual(self, g: DeviceGraph, h2, e2):
        """Both passes' logits ``[E, 2]`` (org, flip) from ``h2``/``e2``
        [*, 2d] (JAX ``score_edges_dual``, sym_gated_gcn.py:381-402): K6
        at width 2H on ``puv = [h_o W1u | h_f W1v | h_o W1v | h_f W1u]``
        (the flip pass's u role is dst), then W2 and W3 on each half."""
        d, dt = h2.shape[1] // 2, h2.dtype
        w1 = self.W1.weight.to(dt)
        w1u, w1v = w1[:, :d], w1[:, d:2 * d]
        h_o, h_f = h2[:, :d], h2[:, d:]
        puv = torch.cat([F.linear(h_o, w1u), F.linear(h_f, w1v),
                         F.linear(h_o, w1v), F.linear(h_f, w1u)], dim=1)
        be = blocks_linear(e2, w1[:, 2 * d:].t(), self.W1.bias.to(dt))
        z = score_gate(g, False, puv, be)
        z = torch.relu(blocks_linear(z, self.W2.weight.t().to(dt),
                                     self.W2.bias.to(dt)))
        return blocks_linear(z, self.W3.weight.t().to(dt),
                             self.W3.bias.to(dt))


class SymGatedGCN(nn.Module):
    """SymGatedGCN.  ``forward(g, x, e, flip)`` takes node features ``x``
    [N, node_features] and host-order edge features ``e`` [E, edge_features]
    on ``g``'s device and returns host-order float32 logits [E, 1]
    (``slot_io=True``: ``e`` and the logits in ``g``'s slot order).  It is
    built in eval mode; ``.train()`` selects the training forward, whose
    dropout (rate ``dropout``) needs a ``generator``.  ``normalization`` is
    ``batch``, ``layer`` or ``none``; ``dtype`` (every forward) the compute
    dtype, float32 or bfloat16.  Each pass (a ``forward``, or a batch-norm
    ``forward_dual``) is the span ``model.forward`` (``utils.timing``)."""

    kind = "sym_gatedgcn"

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
    def from_config(cls, cfg) -> nn.Module:
        """The module a ``config.ModelConfig`` names
        (``models.zoo.get_model``): a ``SymGatedGCN`` for ``sym_gatedgcn``,
        a zoo model for ``gatedgcn``, ``gcn``, ``gat`` or ``sage``; any
        other name raises with the list of valid ones."""
        from .zoo import get_model
        return get_model(cfg)

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

    def _check_dtype(self, dtype) -> None:
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype={dtype}: expected torch.float32 or "
                             "torch.bfloat16")

    def forward(self, g: DeviceGraph, x, e, flip: bool = False,
                generator=None, slot_io: bool = False,
                dtype: torch.dtype = torch.float32):
        self._check_dtype(dtype)
        drop = self.dropout if self.training else 0.0
        if drop > 0.0 and generator is None:
            raise ValueError("training-mode dropout needs a torch.Generator")
        with span("model.forward"):
            # the encoders in float32, their outputs cast
            # (sym_gated_gcn.py:601-602)
            h = mlp2(self.linear1_node, self.linear2_node, x).to(dtype)
            e = mlp2(self.linear1_edge, self.linear2_edge, e).to(dtype)
            if not slot_io:
                e = g.edges_to_slots(e)
            for conv in self.gnn.convs:
                h, e = conv(g, h, e, flip, drop, generator, dtype)
            logits = self.predictor(g, h, e, flip, dtype).float()
            return logits if slot_io else g.slots_to_edges(logits)

    def forward_pair(self, g: DeviceGraph, x, x_rev, e, generator=None,
                     slot_io: bool = False,
                     dtype: torch.dtype = torch.float32):
        """Both symmetry-loss passes (reference train.py:159-185), one after
        the other: ``flip=False`` on ``x``, then ``flip=True`` on ``x_rev``,
        BatchNorm running statistics chained through the module.  The JAX
        package's ``forward_dual`` documents its fused form as equal to
        these two passes, and runs them for normalisations other than
        batch.  Returns ``(logits_org, logits_rev)``."""
        return (self(g, x, e, False, generator, slot_io, dtype),
                self(g, x_rev, e, True, generator, slot_io, dtype))

    def forward_dual(self, g: DeviceGraph, x, x_rev, e, generator=None,
                     slot_io: bool = False,
                     dtype: torch.dtype = torch.float32):
        """Both symmetry-loss passes as one pass at doubled width (JAX
        ``forward_dual``, sym_gated_gcn.py:424-534): ``h = [enc(x) |
        enc(x_rev)]``, ``e2 = [e | e]``, every layer's ``forward_dual``, the
        dual predictor.  Equal to ``forward_pair`` up to float rounding and
        the dropout draw (one ``[N, 2d]`` mask per layer), BatchNorm running
        statistics included.  Layer norm and none run ``forward_pair``, as
        the JAX function declines the dual mode for them.  Returns
        ``(logits_org, logits_rev)``, each [E, 1]."""
        if self.normalization != "batch":
            return self.forward_pair(g, x, x_rev, e, generator, slot_io,
                                     dtype)
        self._check_dtype(dtype)
        drop = self.dropout if self.training else 0.0
        if drop > 0.0 and generator is None:
            raise ValueError("training-mode dropout needs a torch.Generator")
        with span("model.forward"):
            # the encoders in float32, their outputs cast
            # (sym_gated_gcn.py:471-474)
            h = torch.cat([mlp2(self.linear1_node, self.linear2_node, x),
                           mlp2(self.linear1_node, self.linear2_node,
                                x_rev)], 1).to(dtype)
            e = mlp2(self.linear1_edge, self.linear2_edge, e).to(dtype)
            if not slot_io:
                e = g.edges_to_slots(e)
            e = torch.cat([e, e], 1)
            for conv in self.gnn.convs:
                h, e = conv.forward_dual(g, h, e, drop, generator)
            logits = self.predictor.forward_dual(g, h, e).float()
            if not slot_io:
                logits = g.slots_to_edges(logits)
            return logits[:, :1], logits[:, 1:]
