"""Message-passing ops of the SymGatedGCN, over a ``DeviceGraph``.

The PyTorch counterparts of ``gnnome_tpu/ops/message.py``'s fused ops
(``fused_eval_edge_stage``, ``fused_train_stage``, ``fused_score_gate``:
the batch-norm model) and unfused ops (``fused_gate_gather``,
``gated_mean_pair``, ``gather_uv_planned``: the layer-norm and norm-free
model): they resolve the endpoint roles (``flip=True`` is the
reversed-graph pass: u = dst, v = src, as in message.py:88,325,690) and call
the kernel wrappers of ``ops/kernels.py``.  Edge arrays are unpacked
``[E, d]`` in slot order: no padding, no window plans, no overflow
patching.

Every op is differentiable through a ``torch.autograd.Function`` whose
backward is a kernel too, as in the JAX package: ``train_edge_stage``
(forward K7 + K3, backward K8), ``score_gate`` (K6, backward K9),
``gate_gather`` (K1, backward K2), the aggregation under
``gated_mean_pair`` (K2, backward two row gathers) and ``gather_uv`` (row
gathers, backward K2).  Every reduction into nodes walks a sorted segment
inside a kernel, so a training step is bitwise reproducible on the card; no
gather with repeated indices is left to autograd (its backward would be an
atomic ``index_add_``).
"""
from __future__ import annotations

import torch

from .graph_tensors import DeviceGraph
from .kernels import (k1_gather_gate, k2_aggregate, k3_edge_stage,
                      k6_score_gate, k7_gate_stats, k8_train_layer_bwd,
                      k9_aggregate)

BN_EPS = 1e-5


def eval_edge_stage(g: DeviceGraph, proj_u, proj_v, b3e, e_in, bn,
                    flip: bool = False):
    """Eval-mode edge stage (K3): ``(e_out [E, d], sum_v [N, 2d],
    sum_u [N, 2d])`` where ``sum_v[i] = sum over edges with v = i of
    [sigma * A2h[u] | sigma]`` and ``sum_u`` likewise by u with A3h[v].
    ``proj_u`` = [B1h | A2h], ``proj_v`` = [B2h | A3h]; ``bn`` [4, d] the eval
    BatchNorm rows [mean, rsqrt(var + eps), weight, bias]
    (``models/norm.batch_norm_rows``; an affine ``x * a + b`` is
    ``[0, 1, a, b]``)."""
    u_idx, v_idx, v_csr, u_csr = g.roles(flip)
    return k3_edge_stage(u_idx, v_idx, v_csr, u_csr, proj_u, proj_v, b3e,
                         e_in, bn)


# --------------------------------------------------------- training edge stage
def _batch_stats(stats, n_edges: int, dtype):
    """(mean, rsqrt(var + eps), unbiased var) from K7's float64
    ``[sum x | sum x*x]``: the one-pass biased variance ``var`` of
    message.py:432-438, formed in float64 and rounded once to ``dtype``."""
    d = stats.shape[0] // 2
    n = float(n_edges)
    mean64 = stats[:d] / n
    var64 = stats[d:] / n - mean64 * mean64
    mean, var = mean64.to(dtype), var64.to(dtype)
    inv = torch.rsqrt(var + BN_EPS)
    return mean, inv, var * (n / max(n - 1.0, 1.0))


class _TrainEdgeStage(torch.autograd.Function):
    """See ``train_edge_stage``.  Saved state is small, as in the JAX
    package (message.py:449-450): h, e, the weights and the [d] batch
    statistics; the backward recomputes the two projections."""

    @staticmethod
    def forward(ctx, g, flip, h, w_uv, b_uv, w3, b3, e, gamma, beta):
        d = h.shape[1]
        u_idx, v_idx, v_csr, u_csr = g.roles(flip)
        proj = h @ w_uv + b_uv                  # [N, 4d]
        b3e = e @ w3 + b3
        stats = k7_gate_stats(u_idx, v_idx, proj[:, :d], proj[:, 2 * d:3 * d],
                              b3e)
        mean, inv, unbiased = _batch_stats(stats, g.n_edges, h.dtype)
        bn = torch.stack([mean, inv, gamma, beta])
        e_out, sum_v, sum_u = k3_edge_stage(
            u_idx, v_idx, v_csr, u_csr, proj[:, :2 * d], proj[:, 2 * d:],
            b3e, e, bn)
        ctx.g, ctx.flip = g, flip
        ctx.save_for_backward(h, w_uv, b_uv, w3, b3, e, bn)
        ctx.mark_non_differentiable(mean, unbiased)
        return e_out, sum_v, sum_u, mean, unbiased

    @staticmethod
    def backward(ctx, d_e_out, d_sum_v, d_sum_u, _d_mean, _d_var):
        h, w_uv, b_uv, w3, b3, e, bn = ctx.saved_tensors
        g = ctx.g
        d = h.shape[1]
        n = float(g.n_edges)
        u_idx, v_idx, v_csr, u_csr = g.roles(ctx.flip)
        d_e_out = (torch.zeros_like(e) if d_e_out is None
                   else d_e_out.contiguous())
        zero_n = torch.zeros((h.shape[0], 2 * d), dtype=h.dtype,
                             device=h.device)
        d_sum_v = zero_n if d_sum_v is None else d_sum_v.contiguous()
        d_sum_u = zero_n if d_sum_u is None else d_sum_u.contiguous()

        # the forward's projections again: the same inputs and operations,
        # so K8's recomputed gate, relu mask and sigma equal K3's bit for bit
        proj = h @ w_uv + b_uv
        b3e = e @ w3 + b3
        x, d_eo, node_u, node_v, stats = k8_train_layer_bwd(
            u_idx, v_idx, v_csr, u_csr, d_sum_u, d_sum_v, proj[:, :2 * d],
            proj[:, 2 * d:], b3e, e, d_e_out, bn)

        # batch-statistics chain (message.py:549-591), in float64 on [d]
        # vectors: A = sum d_y, B = sum d_y * x
        mean, inv, gamma, beta = bn
        mean64, inv64, gamma64 = mean.double(), inv.double(), gamma.double()
        A, B = stats[:d], stats[d:]
        g_term = B - mean64 * A
        d_gamma = inv64 * g_term
        d_var = -0.5 * inv64 ** 3 * (gamma64 * g_term)
        d_mean = -A * (gamma64 * inv64) - 2.0 * mean64 * d_var
        c1 = (d_mean / n).to(h.dtype)
        c2 = (2.0 * d_var / n).to(h.dtype)

        # per-edge d_b3e = d_y * scale + c1 + c2 * x; the relu mask from x
        # with K3's operations
        y = ((x - mean) * inv) * gamma + beta
        d_y = torch.where(y > 0, d_eo, torch.zeros_like(d_eo))
        d_b3e = d_y * (gamma * inv) + (c1 + c2 * x)
        # the same term summed into each endpoint: c1 * deg + c2 * xsum
        v_ptr, u_ptr = v_csr[0], u_csr[0]
        deg_u = (u_ptr[1:] - u_ptr[:-1]).to(h.dtype)[:, None]
        deg_v = (v_ptr[1:] - v_ptr[:-1]).to(h.dtype)[:, None]
        zu = c2 * node_u[:, 2 * d:] + c1 * deg_u
        zv = c2 * node_v[:, 2 * d:] + c1 * deg_v
        d_proj = torch.cat([node_u[:, :d] + zu, node_u[:, d:2 * d],
                            node_v[:, :d] + zv, node_v[:, d:2 * d]], dim=1)

        # close the projection and B3 matmuls (message.py:593-629)
        d_h = d_proj @ w_uv.t()
        d_w_uv = h.t() @ d_proj
        d_b_uv = d_proj.sum(0)
        d_e = d_eo + d_b3e @ w3.t()
        d_w3 = e.t() @ d_b3e
        d_b3 = d_b3e.sum(0)
        return (None, None, d_h, d_w_uv, d_b_uv, d_w3, d_b3, d_e,
                d_gamma.to(h.dtype), A.to(h.dtype))


def train_edge_stage(g: DeviceGraph, flip: bool, h, w_uv, b_uv, w3, b3, e,
                     gamma, beta):
    """Training-mode edge stage: the counterpart of JAX
    ``fused_train_stage`` (message.py:367-636) on unpacked slot-order edges.

    ``proj = h @ w_uv + b_uv`` with ``w_uv`` = [B1|A2|B2|A3] ([d, 4d], the
    JAX ``[in, out]`` layout), ``b3e = e @ w3 + b3``; K7 sums the gate
    ``x = B1h[u] + B2h[v] + b3e`` into the batch statistics (biased variance
    normalises), K3 runs the edge stage with the rows [mean, inv_std, gamma,
    beta].  Returns ``(e_out [E, d], sum_v [N, 2d], sum_u [N, 2d], mean [d],
    unbiased_var [d])``; the last two carry no gradient (the running-stat
    update happens under no_grad in torch).  The backward runs K8 and closes
    the batch-statistics chain in node space."""
    return _TrainEdgeStage.apply(g, flip, h, w_uv, b_uv, w3, b3, e, gamma,
                                 beta)


# ------------------------------------------------------------------ score gate
class _ScoreGate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, flip, puv, be):
        u_idx, v_idx, _, _ = g.roles(flip)
        z = k6_score_gate(u_idx, v_idx, puv, be)
        ctx.g, ctx.flip = g, flip
        ctx.save_for_backward(z)
        return z

    @staticmethod
    def backward(ctx, dz):
        (z,) = ctx.saved_tensors
        u_idx, v_idx, v_csr, u_csr = ctx.g.roles(ctx.flip)
        dzm = torch.where(z > 0, dz, torch.zeros_like(dz)).contiguous()
        sum_u, sum_v = k9_aggregate(u_idx, v_idx, v_csr, u_csr, dzm)
        return None, None, torch.cat([sum_u, sum_v], dim=1), dzm


def score_gate(g: DeviceGraph, flip: bool, puv, be):
    """First score-predictor layer (K6): ``relu(pu[u] + pv[v] + be)`` with
    ``puv`` = [h @ W1u | h @ W1v] ([N, 2H]) and ``be`` = e @ W1e + b1.
    Differentiable: the backward scatters ``dz * (z > 0)`` into u and v
    with K9 (message.py:713-734)."""
    return _ScoreGate.apply(g, flip, puv, be)


# ------------------------------------------------------------ unfused layer
class _GateGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, flip, proj_u, proj_v, b3e):
        u_idx, v_idx, _, _ = g.roles(flip)
        ctx.g, ctx.flip = g, flip
        return k1_gather_gate(u_idx, v_idx, proj_u, proj_v, b3e)

    @staticmethod
    def backward(ctx, d_g3):
        u_idx, v_idx, v_csr, u_csr = ctx.g.roles(ctx.flip)
        d_g3 = d_g3.contiguous()
        d = d_g3.shape[1] // 3
        # the u-side payload [d_gate | d_a2h] is a column slice of d_g3
        d_pu, d_pv = k2_aggregate(
            u_idx, v_idx, v_csr, u_csr, d_g3[:, :2 * d],
            torch.cat([d_g3[:, :d], d_g3[:, 2 * d:]], dim=1))
        return None, None, d_pu, d_pv, d_g3[:, :d]


def gate_gather(g: DeviceGraph, flip: bool, proj_u, proj_v, b3e):
    """Endpoint gathers and gate of the unfused layer (K1): the counterpart
    of JAX ``fused_gate_gather`` (message.py:78-97,185-225).  Returns
    ``[gate | A2h[u] | A3h[v]]`` ([E, 3d]) with gate = B1h[u] + B2h[v] +
    b3e; ``proj_u`` = [B1h | A2h], ``proj_v`` = [B2h | A3h] ([N, 2d], may be
    column slices).  The backward sums ``[d_gate | d_a2h]`` into u and
    ``[d_gate | d_a3h]`` into v with K2; ``d_b3e = d_gate``."""
    return _GateGather.apply(g, flip, proj_u, proj_v, b3e)


class _Aggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, flip, pay_u, pay_v):
        u_idx, v_idx, v_csr, u_csr = g.roles(flip)
        ctx.g, ctx.flip = g, flip
        return k2_aggregate(u_idx, v_idx, v_csr, u_csr, pay_u, pay_v)

    @staticmethod
    def backward(ctx, d_sum_u, d_sum_v):
        u_idx, v_idx, _, _ = ctx.g.roles(ctx.flip)
        return (None, None, d_sum_u.index_select(0, u_idx),
                d_sum_v.index_select(0, v_idx))


def aggregate(g: DeviceGraph, flip: bool, pay_u, pay_v):
    """``(sum_u, sum_v)`` ([N, Dp]): ``pay_u`` [E, Dp] summed into u and
    ``pay_v`` into v (K2; JAX ``_aggregate_pallas``, message.py:640-679).
    The backward is the two row gathers ``d_sum_u[u]``, ``d_sum_v[v]``."""
    return _Aggregate.apply(g, flip, pay_u, pay_v)


def gated_mean_pair(g: DeviceGraph, flip: bool, sigma, a2h_u, a3h_v,
                    eps: float):
    """Both directions of the gated mean (JAX ``gated_mean_pair``,
    message.py:748-778): ``h_fwd[i]`` = sum over edges with v = i of
    ``sigma * A2h[u]`` over (sum of ``sigma`` + eps), ``h_bwd`` likewise by
    u with ``A3h[v]``.  One K2 over the payloads ``[sigma * a3h_v | sigma]``
    (by u) and ``[sigma * a2h_u | sigma]`` (by v)."""
    d = a2h_u.shape[1]
    pay_v = torch.cat([sigma * a2h_u, sigma], dim=1)
    pay_u = torch.cat([sigma * a3h_v, sigma], dim=1)
    sum_u, sum_v = aggregate(g, flip, pay_u, pay_v)
    h_fwd = sum_v[:, :d] / (sum_v[:, d:] + eps)
    h_bwd = sum_u[:, :d] / (sum_u[:, d:] + eps)
    return h_fwd, h_bwd


class _GatherUV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, flip, h):
        u_idx, v_idx, _, _ = g.roles(flip)
        ctx.g, ctx.flip = g, flip
        return h.index_select(0, u_idx), h.index_select(0, v_idx)

    @staticmethod
    def backward(ctx, d_u, d_v):
        u_idx, v_idx, v_csr, u_csr = ctx.g.roles(ctx.flip)
        sum_u, sum_v = k2_aggregate(u_idx, v_idx, v_csr, u_csr, d_u, d_v)
        return None, None, sum_u + sum_v


def gather_uv(g: DeviceGraph, flip: bool, h):
    """``(h[u], h[v])`` for the unfused score predictor (JAX
    ``gather_uv_planned``, message.py:153-182): row gathers forward, K2
    backward (``d_h = sum_u(d_u) + sum_v(d_v)``)."""
    return _GatherUV.apply(g, flip, h)
