"""Message-passing ops of the SymGatedGCN and the model zoo, over a
``DeviceGraph``.

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
(forward K7 + K3, backward K8 and the batch-norm edge adjoint),
``score_gate`` (K6, backward K9), ``unfused_edge_stage`` (forward K1, the
layer-norm edge stage and K2; backward its adjoint and K2),
``gate_gather`` (K1, backward K2), the aggregation under
``gated_mean_pair`` (K2, backward two row gathers) and ``gather_uv`` (row
gathers, backward K2).  Every reduction into nodes walks
a sorted segment inside a kernel, so a training step is bitwise
reproducible on the card; no gather with repeated indices is left to
autograd (its backward would be an atomic ``index_add_``).

The ops run in the dtype of their node and edge states, float32 or
bfloat16; the casts between the two sit where the JAX package's bf16 mode
casts (message.py:413-448, 468-635, 713-734 for the batch-norm ops;
175-179, 219-222, 668-676, 772-791 for the unfused ones).  K2 sums bf16
payloads into float32 node sums, which each op rounds where JAX does.
"""
from __future__ import annotations

import torch

from .graph_tensors import DeviceGraph
from .kernels import (bn_edge_adjoint, k1_gather_gate, k2_aggregate,
                      k2_side_sum, k3_edge_stage, k6_score_gate,
                      k7_gate_stats, k8_train_layer_bwd, k9_aggregate,
                      ln_edge_adjoint, ln_edge_stage, wide, wide_dtype)

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
    message.py:432-438, formed in float64 and rounded once to
    ``wide_dtype(dtype)``: float32 in the bf16 mode too, as JAX keeps the
    statistics."""
    d = stats.shape[0] // 2
    n = float(n_edges)
    mean64 = stats[:d] / n
    var64 = stats[d:] / n - mean64 * mean64
    mean, var = mean64.to(wide_dtype(dtype)), var64.to(wide_dtype(dtype))
    inv = torch.rsqrt(var + BN_EPS)
    return mean, inv, var * (n / max(n - 1.0, 1.0))


def bn_edge_rows(mean, inv, gamma, beta, dtype):
    """The ``[4, d]`` BatchNorm rows K3 and K8 take for float32 ``mean``,
    ``inv`` = rsqrt(var + eps), ``gamma``, ``beta``.  float32 (and float64):
    unfolded, ``[mean, inv, gamma, beta]`` (see csrc/k3_edge_stage.cu).
    bfloat16:
    the JAX package's folded affine (message.py:440-441), ``scale = gamma *
    inv`` and ``bias = beta - mean * scale`` in float32, each rounded to
    bf16, as ``[0, 1, scale, bias]``: K3 then computes ``x * scale + bias``
    in bf16 exactly as JAX does."""
    if dtype != torch.bfloat16:
        return torch.stack([mean, inv, gamma, beta])
    scale = gamma * inv
    return torch.stack([torch.zeros_like(scale), torch.ones_like(scale),
                        scale, beta - mean * scale]).to(dtype)


def blocks_linear(x, w, b):
    """``x @ w + b`` on each ``w.shape[0]``-wide column block of ``x``
    (``w`` [in, out], the JAX layout): one GEMM over the blocks stacked as
    rows, ``[n, m * in] -> [n, m * out]``.  The dual pass applies a weight
    that both halves share this way, with one pass's flops."""
    n, k = x.shape[0], w.shape[0]
    m = x.shape[1] // k
    return torch.addmm(b, x.reshape(n * m, k), w).view(n, m * w.shape[1])


class _TrainEdgeStage(torch.autograd.Function):
    """See ``train_edge_stage``.  Saved state is small, as in the JAX
    package (message.py:449-450): h, e, the weights and the [d] batch
    statistics; the backward recomputes the two projections."""

    @staticmethod
    def forward(ctx, g, flip, h, w_uv, b_uv, w3, b3, e, gamma, beta,
                reduce, n_edges):
        d = h.shape[1]
        u_idx, v_idx, v_csr, u_csr = g.roles(flip)
        proj = h @ w_uv + b_uv                  # [N, 4d]
        b3e = blocks_linear(e, w3, b3)
        stats = k7_gate_stats(u_idx, v_idx, proj[:, :d], proj[:, 2 * d:3 * d],
                              b3e)
        if reduce is not None:
            stats = reduce(stats)
        n = g.n_edges if n_edges is None else n_edges
        mean, inv, unbiased = _batch_stats(stats, n, h.dtype)
        bn = bn_edge_rows(mean, inv, gamma, beta, h.dtype)
        e_out, sum_v, sum_u = k3_edge_stage(
            u_idx, v_idx, v_csr, u_csr, proj[:, :2 * d], proj[:, 2 * d:],
            b3e, e, bn)
        ctx.g, ctx.flip, ctx.reduce, ctx.n = g, flip, reduce, n
        ctx.save_for_backward(h, w_uv, b_uv, w3, b3, e, bn, mean, inv, gamma)
        ctx.mark_non_differentiable(mean, unbiased)
        return e_out, sum_v, sum_u, mean, unbiased

    @staticmethod
    def backward(ctx, d_e_out, d_sum_v, d_sum_u, _d_mean, _d_var):
        h, w_uv, b_uv, w3, b3, e, bn, mean, inv, gamma = ctx.saved_tensors
        g = ctx.g
        d = h.shape[1]
        dt, wd = h.dtype, wide_dtype(h.dtype)
        n = float(ctx.n)
        u_idx, v_idx, v_csr, u_csr = g.roles(ctx.flip)
        # the cotangents in the compute dtype (message.py:487-490)
        d_e_out = (torch.zeros_like(e) if d_e_out is None
                   else d_e_out.to(dt).contiguous())
        zero_n = torch.zeros((h.shape[0], 2 * d), dtype=dt, device=h.device)
        d_sum_v = zero_n if d_sum_v is None else d_sum_v.to(dt).contiguous()
        d_sum_u = zero_n if d_sum_u is None else d_sum_u.to(dt).contiguous()

        # the forward's projections again: the same inputs and operations,
        # so K8's recomputed gate, relu mask and sigma equal K3's bit for bit
        proj = h @ w_uv + b_uv
        b3e = blocks_linear(e, w3, b3)
        x, d_eo, node_u, node_v, stats = k8_train_layer_bwd(
            u_idx, v_idx, v_csr, u_csr, d_sum_u, d_sum_v, proj[:, :2 * d],
            proj[:, 2 * d:], b3e, e, d_e_out, bn)

        # batch-statistics chain (message.py:549-591), in float64 on [d]
        # vectors: A = sum d_y, B = sum d_y * x.  d_gamma and d_beta are
        # this call's own sums (a caller that reduces sums them with the
        # other parameter gradients); the statistics' adjoints need the
        # reduced A and B
        mean64, inv64, gamma64 = mean.double(), inv.double(), gamma.double()
        d_gamma = inv64 * (stats[d:] - mean64 * stats[:d])
        d_beta = stats[:d]
        if ctx.reduce is not None:
            stats = ctx.reduce(stats)
        A, B = stats[:d], stats[d:]
        g_term = B - mean64 * A
        d_var = -0.5 * inv64 ** 3 * (gamma64 * g_term)
        d_mean = -A * (gamma64 * inv64) - 2.0 * mean64 * d_var
        c1 = (d_mean / n).to(wd)
        c2 = (2.0 * d_var / n).to(wd)

        # per-edge d_b3e = d_y * scale + c1 + c2 * x in float32, rounded to
        # the compute dtype (message.py:578-579); the relu mask from x with
        # K3's operations: one pass (bn_edge_adjoint)
        d_b3e = bn_edge_adjoint(x, d_eo, bn,
                                torch.stack([gamma * inv, c1, c2]))
        # the same term summed into each endpoint: c1 * deg + c2 * xsum
        v_ptr, u_ptr = v_csr[0], u_csr[0]
        deg_u = (u_ptr[1:] - u_ptr[:-1]).to(wd)[:, None]
        deg_v = (v_ptr[1:] - v_ptr[:-1]).to(wd)[:, None]
        zu = c2 * wide(node_u[:, 2 * d:]) + c1 * deg_u
        zv = c2 * wide(node_v[:, 2 * d:]) + c1 * deg_v
        d_proj = torch.cat([(wide(node_u[:, :d]) + zu).to(dt),
                            node_u[:, d:2 * d],
                            (wide(node_v[:, :d]) + zv).to(dt),
                            node_v[:, d:2 * d]], dim=1)

        # close the projection and B3 matmuls (message.py:593-629): products
        # accumulate in float32 and come out in the compute dtype, the bias
        # sums in float32 rounded to the bias's dtype
        d_h = d_proj @ w_uv.t()
        d_w_uv = h.t() @ d_proj
        d_b_uv = wide(d_proj).sum(0).to(b_uv.dtype)
        k = w3.shape[0]
        m = e.shape[1] // k
        rows = d_b3e.reshape(e.shape[0] * m, k)  # one row per column block
        d_e = d_eo + (rows @ w3.t()).view(e.shape)
        d_w3 = e.reshape(e.shape[0] * m, k).t() @ rows
        d_b3 = wide(rows).sum(0).to(b3.dtype)
        return (None, None, d_h, d_w_uv, d_b_uv, d_w3, d_b3, d_e,
                d_gamma.to(gamma.dtype), d_beta.to(gamma.dtype), None, None)


def train_edge_stage(g: DeviceGraph, flip: bool, h, w_uv, b_uv, w3, b3, e,
                     gamma, beta, reduce=None, n_edges: int | None = None):
    """Training-mode edge stage: the counterpart of JAX
    ``fused_train_stage`` (message.py:367-636) on unpacked slot-order edges.

    ``proj = h @ w_uv + b_uv`` with ``w_uv`` = [B1|A2|B2|A3] ([d, 4d], the
    JAX ``[in, out]`` layout), ``b3e = e @ w3 + b3`` (``blocks_linear``: in
    the dual pass ``w3`` [d', d'] acts on each half of ``e`` [E, 2d']); K7 sums the gate
    ``x = B1h[u] + B2h[v] + b3e`` into the batch statistics (biased variance
    normalises), K3 runs the edge stage with the rows [mean, inv_std, gamma,
    beta].  Returns ``(e_out [E, d], sum_v [N, 2d], sum_u [N, 2d], mean [d],
    unbiased_var [d])``; the last two carry no gradient (the running-stat
    update happens under no_grad in torch).  The backward runs K8, closes
    the batch-statistics chain in node space and forms the per-edge
    ``d_b3e`` in one more pass (``bn_edge_adjoint``).

    bfloat16 (JAX ``compute.dtype=bfloat16``): ``h``, ``e`` and the weights
    are bf16, ``gamma``/``beta`` float32; the statistics stay float32, K3
    and K8 take the folded affine (``bn_edge_rows``) and run in bf16, and
    ``e_out``, the sums and the gradients of the bf16 inputs are bf16.

    A shard of a graph split over ranks (``parallel/halo.py``) passes
    ``reduce``, which sums a float64 tensor over the ranks, and ``n_edges``,
    the edge count of the whole graph: K7's sums and K8's ``[A | B]`` are
    reduced before the statistics and their adjoints are formed, so every
    rank normalises with the whole graph's statistics (JAX ``_psum_bn``,
    parallel/halo.py:263-286).  The default, ``g``'s own edges, is the
    single-device stage."""
    return _TrainEdgeStage.apply(g, flip, h, w_uv, b_uv, w3, b3, e, gamma,
                                 beta, reduce, n_edges)


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
        dzm = torch.where(z > 0, dz.to(z.dtype), 0.0)
        # K9 writes [sum_u | sum_v] in float32, the gradient of puv = [pu |
        # pv], rounded to the compute dtype (message.py:733)
        d_puv = k9_aggregate(u_idx, v_idx, v_csr, u_csr, dzm).to(z.dtype)
        return None, None, d_puv, dzm


def score_gate(g: DeviceGraph, flip: bool, puv, be):
    """First score-predictor layer (K6): ``relu(pu[u] + pv[v] + be)`` with
    ``puv`` = [h @ W1u | h @ W1v] ([N, 2H]) and ``be`` = e @ W1e + b1.
    Differentiable: the backward scatters ``dz * (z > 0)`` into u and v
    with K9 (message.py:713-734)."""
    return _ScoreGate.apply(g, flip, puv, be)


# ------------------------------------------------------------ unfused layer
class _UnfusedEdgeStage(torch.autograd.Function):
    """See ``unfused_edge_stage``.  Saved: K1's ``g3``, the rows' LayerNorm
    statistics and ``e_out`` (which the next layer's B3 product keeps
    anyway); nothing else edge-sized."""

    @staticmethod
    def forward(ctx, g, flip, proj_u, proj_v, b3e, e, weight, bias, eps):
        u_idx, v_idx, v_csr, u_csr = g.roles(flip)
        g3 = k1_gather_gate(u_idx, v_idx, proj_u, proj_v, b3e)
        e_out, pay_u, pay_v, stats = ln_edge_stage(g3, e.contiguous(),
                                                   weight, bias, eps)
        sum_u, sum_v = k2_aggregate(u_idx, v_idx, v_csr, u_csr, pay_u, pay_v)
        ctx.g, ctx.flip = g, flip
        ctx.save_for_backward(g3, e_out, stats, weight, bias)
        return e_out, sum_u, sum_v

    @staticmethod
    def backward(ctx, d_e_out, d_sum_u, d_sum_v):
        g3, e_out, stats, weight, bias = ctx.saved_tensors
        u_idx, v_idx, v_csr, u_csr = ctx.g.roles(ctx.flip)
        d = e_out.shape[1]
        zero_n = g3.new_zeros((ctx.g.n_nodes, 2 * d))
        d_e_out = (torch.zeros_like(e_out) if d_e_out is None
                   else d_e_out.contiguous())
        d_sum_u = zero_n if d_sum_u is None else d_sum_u.contiguous()
        d_sum_v = zero_n if d_sum_v is None else d_sum_v.contiguous()
        pay_u, pay_v, d_e, d_wb = ln_edge_adjoint(
            u_idx, v_idx, d_sum_u, d_sum_v, g3, e_out, d_e_out, stats,
            weight, bias)
        # K1's adjoint: [d_gate | d_a2h] into u, [d_gate | d_a3h] into v
        d_pu, d_pv = k2_aggregate(u_idx, v_idx, v_csr, u_csr, pay_u, pay_v)
        d_w, d_b = (None, None) if d_wb is None else (d_wb[0], d_wb[1])
        return (None, None, d_pu, d_pv, pay_u[:, :d], d_e, d_w, d_b, None)


def unfused_edge_stage(g: DeviceGraph, flip: bool, proj_u, proj_v, b3e, e,
                       weight, bias, eps: float):
    """The unfused layer's edge stage from K1 to K2's sums, float32, as one
    autograd Function: K1 (``gate_gather``'s ``g3`` = [gate | A2h[u] |
    A3h[v]]), the layer-norm edge stage (``ln_edge_stage``: LayerNorm of
    the gate with ``weight``, ``bias`` and ``eps``, relu, ``e_out =
    relu(.) + e``, ``sigma = sigmoid(e_out)`` and the payloads), and one K2:
    returns ``(e_out [E, d], sum_u [N, 2d], sum_v [N, 2d])`` with ``sum_u``
    the sums of ``[sigma * A3h[v] | sigma]`` into u and ``sum_v`` of
    ``[sigma * A2h[u] | sigma]`` into v, float32 (the gated means divide
    them).  ``weight`` and ``bias`` None: the norm-free layer.  The
    operations of ``gate_gather``, ``apply_norm``, relu, the residual,
    sigmoid and ``gated_mean_pair``'s sums (JAX sym_gated_gcn.py:149-172).

    The backward runs the stage's adjoint (``ln_edge_adjoint``: the
    cotangent rows of K2's sums gathered, sigmoid, residual, relu and the
    LayerNorm row adjoint, K1's adjoint payloads, the LayerNorm parameters'
    sums) and K2 for K1's adjoint (``d_b3e`` is ``d_gate``).  float32 (and
    float64 on the CPU); bf16 operands take ``gate_gather`` and
    ``gated_mean_pair`` (the layer chooses)."""
    return _UnfusedEdgeStage.apply(g, flip, proj_u, proj_v, b3e, e, weight,
                                   bias, eps)


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
        # the u-side payload [d_gate | d_a2h] is a column slice of d_g3;
        # K2's float32 sums rounded to d_g3's dtype (message.py:219-222)
        d_pu, d_pv = k2_aggregate(
            u_idx, v_idx, v_csr, u_csr, d_g3[:, :2 * d],
            torch.cat([d_g3[:, :d], d_g3[:, 2 * d:]], dim=1))
        return (None, None, d_pu.to(d_g3.dtype), d_pv.to(d_g3.dtype),
                d_g3[:, :d])


def gate_gather(g: DeviceGraph, flip: bool, proj_u, proj_v, b3e):
    """Endpoint gathers and gate of the unfused layer (K1): the counterpart
    of JAX ``fused_gate_gather`` (message.py:78-97,185-225).  Returns
    ``[gate | A2h[u] | A3h[v]]`` ([E, 3d]) with gate = B1h[u] + B2h[v] +
    b3e; ``proj_u`` = [B1h | A2h], ``proj_v`` = [B2h | A3h] ([N, 2d], may be
    column slices).  float32 or bfloat16, every operand of one dtype.  The
    backward sums ``[d_gate | d_a2h]`` into u and ``[d_gate | d_a3h]`` into
    v with K2 (float32 sums, rounded to the operands' dtype); ``d_b3e =
    d_gate``."""
    return _GateGather.apply(g, flip, proj_u, proj_v, b3e)


class _Aggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, flip, pay_u, pay_v):
        u_idx, v_idx, v_csr, u_csr = g.roles(flip)
        ctx.g, ctx.flip, ctx.dtype = g, flip, pay_u.dtype
        return k2_aggregate(u_idx, v_idx, v_csr, u_csr, pay_u, pay_v)

    @staticmethod
    def backward(ctx, d_sum_u, d_sum_v):
        u_idx, v_idx, _, _ = ctx.g.roles(ctx.flip)
        # cast to the payloads' dtype before the row gathers
        # (message.py:668-676)
        return (None, None, d_sum_u.to(ctx.dtype).index_select(0, u_idx),
                d_sum_v.to(ctx.dtype).index_select(0, v_idx))


def aggregate(g: DeviceGraph, flip: bool, pay_u, pay_v):
    """``(sum_u, sum_v)`` ([N, Dp]): ``pay_u`` [E, Dp] summed into u and
    ``pay_v`` into v (K2; JAX ``_aggregate_pallas``, message.py:640-679),
    float32 sums of float32 or bfloat16 payloads.  The backward is the two
    row gathers ``d_sum_u[u]``, ``d_sum_v[v]`` in the payloads' dtype."""
    return _Aggregate.apply(g, flip, pay_u, pay_v)


def gated_mean_pair(g: DeviceGraph, flip: bool, sigma, a2h_u, a3h_v,
                    eps: float):
    """Both directions of the gated mean (JAX ``gated_mean_pair``,
    message.py:748-778): ``h_fwd[i]`` = sum over edges with v = i of
    ``sigma * A2h[u]`` over (sum of ``sigma`` + eps), ``h_bwd`` likewise by
    u with ``A3h[v]``.  One K2 over the payloads ``[sigma * a3h_v | sigma]``
    (by u) and ``[sigma * a2h_u | sigma]`` (by v), formed in the dtype of
    their operands (bfloat16 in the norm-free bf16 model; float32 where a
    float32 ``sigma`` promotes them, as in the layer-norm bf16 model); the
    division in K2's float32, the means returned in ``a2h_u``'s dtype
    (message.py:772-791)."""
    d = a2h_u.shape[1]
    pay_v = torch.cat([sigma * a2h_u, sigma], dim=1)
    pay_u = torch.cat([sigma * a3h_v, sigma], dim=1)
    sum_u, sum_v = aggregate(g, flip, pay_u, pay_v)
    h_fwd = sum_v[:, :d] / (sum_v[:, d:] + eps)
    h_bwd = sum_u[:, :d] / (sum_u[:, d:] + eps)
    return h_fwd.to(a2h_u.dtype), h_bwd.to(a2h_u.dtype)


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
        # added in float32, rounded once to the cotangents' dtype
        # (message.py:175-179)
        return None, None, (sum_u + sum_v).to(d_u.dtype)


def gather_uv(g: DeviceGraph, flip: bool, h):
    """``(h[u], h[v])`` for the unfused score predictor (JAX
    ``gather_uv_planned``, message.py:153-182): row gathers forward, K2
    backward (``d_h = sum_u(d_u) + sum_v(d_v)``)."""
    return _GatherUV.apply(g, flip, h)


# ------------------------------------------------------------ model zoo
def _side(g: DeviceGraph, side: str):
    """``(node of each slot, slot lists (ptr, perm, nbr))`` of one endpoint
    side, ``dst`` or ``src``."""
    _, _, by_dst, by_src = g.roles(False)
    if side == "dst":
        return g.dst, by_dst
    if side == "src":
        return g.src, by_src
    raise ValueError(f"side={side!r}: expected 'dst' or 'src'")


class _SumInto(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, side, pay):
        idx, csr = _side(g, side)
        ctx.idx = idx
        return k2_side_sum(idx, csr, pay)

    @staticmethod
    def backward(ctx, d_out):
        return None, None, d_out.index_select(0, ctx.idx)


def sum_into(g: DeviceGraph, side: str, pay):
    """``out[i]`` = sum of ``pay[s]`` over the slots whose ``side``
    endpoint (``dst`` or ``src``) is i ([N, D]; JAX ``jax.ops.segment_sum``
    of the zoo, zoo.py:64-78): the one-sided K2 walk, in slot order, no
    atomics.  The backward gathers the cotangent's rows."""
    return _SumInto.apply(g, side, pay)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, side, h):
        idx, csr = _side(g, side)
        ctx.idx, ctx.csr = idx, csr
        return h.index_select(0, idx)

    @staticmethod
    def backward(ctx, d_rows):
        return None, None, k2_side_sum(ctx.idx, ctx.csr, d_rows.contiguous())


def gather_rows(g: DeviceGraph, side: str, h):
    """``h[side(s)]`` for every slot s ([E, D]; JAX ``jnp.take`` of the zoo):
    a row gather whose backward sums the cotangent into that side with the
    one-sided K2 walk (autograd's own would be an atomic ``index_add_``)."""
    return _GatherRows.apply(g, side, h)
