"""Normalisation with the JAX package's arithmetic (``gnnome_tpu/models/
norm.py``), over ``nn.BatchNorm1d`` / ``nn.LayerNorm`` modules so the
state-dict names and buffers stay the reference's.

BatchNorm:

* eval: normalise with the running statistics (norm.py:64-68);
* training (norm.py:47-63): normalise with the biased batch variance
  (two-pass), update the running statistics with the unbiased variance at
  momentum 0.1, ``repeat_updates`` times, and advance
  ``num_batches_tracked`` as often (the JAX ``count``).

``batch_norm_dual`` (norm.py:71-108) runs one BatchNorm module over the
feature-concatenated ``[n, 2d]`` halves of the two symmetry-loss passes:
each half normalised with its own statistics, the running statistics
updated as two forwards one after the other would (the org half, then the
flip half).

LayerNorm (norm.py:111-115) is the same in eval and training; ``none``
(norm.py:118-128) is the identity.

``residual_batch_norm`` is the training-mode BatchNorm of a residual sum,
``BN(a + b)``, as one autograd Function over hand-written kernels
(csrc/bn_residual.cu; the Graph Transformer layer's four norms, float32):
``batch_norm_train``'s arithmetic with one ``[n, d]`` tensor saved.

BatchNorm takes bfloat16 input too (the JAX package's bf16 mode,
norm.py:48-68,84-108): the input is cast to float32, the statistics, the
running-statistic updates and the normalisation run in float32, and the
output is cast back to the input's dtype (``ops.kernels.wide``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.kernels import bn_residual_backward, bn_residual_forward, wide

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
LN_EPS = 1e-5


def batch_norm_eval(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` with running stats
    (in float32, returned in ``x``'s dtype)."""
    inv = torch.rsqrt(bn.running_var + BN_EPS)
    y = (wide(x) - bn.running_mean) * inv * bn.weight + bn.bias
    return y.to(x.dtype)


def batch_norm_rows(bn: nn.BatchNorm1d,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Eval BatchNorm as the ``[4, d]`` rows the fused edge-stage kernel
    takes.  float32: ``[mean, rsqrt(var + eps), weight, bias]``, not folded
    into one affine ``x * s + (bias - mean * s)``: that form cancels where x
    is near the mean (see csrc/k3_edge_stage.cu).  bfloat16: the JAX
    package's eval fold (sym_gated_gcn.py:177-180), ``scale = weight *
    rsqrt(var + eps)`` rounded to bf16 and ``bias - mean * scale`` (with
    the rounded scale) rounded to bf16, as ``[0, 1, scale, bias]``."""
    inv = torch.rsqrt(bn.running_var + BN_EPS)
    if dtype != torch.bfloat16:
        return torch.stack([bn.running_mean, inv, bn.weight, bn.bias])
    scale = (bn.weight * inv).to(dtype)
    bias = (bn.bias - bn.running_mean * wide(scale)).to(dtype)
    return torch.stack([torch.zeros_like(scale), torch.ones_like(scale),
                        scale, bias])


@torch.no_grad()
def update_running_stats(bn: nn.BatchNorm1d, mean: torch.Tensor,
                         unbiased_var: torch.Tensor,
                         repeat_updates: int = 1, halves: int = 1) -> None:
    """``running = 0.9 * running + 0.1 * batch``, ``repeat_updates`` times
    (the shared ``bn_e`` of the reference advances twice per layer,
    gated_gcn_full.py:106,119); ``num_batches_tracked`` advances as often.
    ``halves=2``: ``mean``/``unbiased_var`` are ``[2d]``, the org pass's
    statistics then the flip pass's, applied in that order (norm.py:97-101)."""
    d = mean.shape[0] // halves
    rm, rv = bn.running_mean, bn.running_var
    for k in range(halves):
        m, v = mean[k * d:(k + 1) * d], unbiased_var[k * d:(k + 1) * d]
        for _ in range(repeat_updates):
            rm = (1.0 - BN_MOMENTUM) * rm + BN_MOMENTUM * m
            rv = (1.0 - BN_MOMENTUM) * rv + BN_MOMENTUM * v
    bn.running_mean.copy_(rm)
    bn.running_var.copy_(rv)
    bn.num_batches_tracked.add_(halves * repeat_updates)


def batch_norm_train(bn: nn.BatchNorm1d, x: torch.Tensor,
                     repeat_updates: int = 1) -> torch.Tensor:
    """Training-mode BatchNorm over the rows of ``x`` [n, d]: batch mean,
    biased variance (two-pass) normalises, gradients flow through both;
    the running statistics are updated (no gradient).  In float32,
    returned in ``x``'s dtype."""
    in_dtype = x.dtype
    x = wide(x)
    n = x.shape[0]
    mean = x.sum(0) / n
    var = ((x - mean) ** 2).sum(0) / n
    inv = torch.rsqrt(var + BN_EPS)
    y = (x - mean) * inv
    update_running_stats(bn, mean.detach(),
                         var.detach() * (n / (n - 1) if n > 1 else 1.0),
                         repeat_updates)
    return (y * bn.weight + bn.bias).to(in_dtype)


def batch_norm_dual(bn: nn.BatchNorm1d, x2: torch.Tensor) -> torch.Tensor:
    """BatchNorm over ``x2`` [n, 2d] = [org | flip] through one [d]-feature
    module (JAX ``batch_norm_dual``): in training each half normalises with
    its own batch mean and biased variance and the running statistics take
    the org half's update, then the flip half's (``num_batches_tracked``
    advances twice); in eval both halves use the running statistics.  The
    shared weight and bias are tiled, so their gradients sum both halves.
    In float32, returned in ``x2``'s dtype."""
    in_dtype = x2.dtype
    x2 = wide(x2)
    weight = torch.cat([bn.weight, bn.weight])
    bias = torch.cat([bn.bias, bn.bias])
    if bn.training:
        n = x2.shape[0]
        mean = x2.sum(0) / n
        var = ((x2 - mean) ** 2).sum(0) / n
        y = (x2 - mean) * torch.rsqrt(var + BN_EPS)
        update_running_stats(bn, mean.detach(),
                             var.detach() * (n / (n - 1) if n > 1 else 1.0),
                             halves=2)
    else:
        mean = torch.cat([bn.running_mean, bn.running_mean])
        var = torch.cat([bn.running_var, bn.running_var])
        y = (x2 - mean) * torch.rsqrt(var + BN_EPS)
    return (y * weight + bias).to(in_dtype)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """Per-row LayerNorm in the JAX package's explicit form: row mean,
    biased row variance, ``(x - mean) * rsqrt(var + eps) * weight + bias``."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * ln.weight + ln.bias


def apply_norm(norm: nn.Module | None, x: torch.Tensor) -> torch.Tensor:
    """JAX ``apply_norm`` (norm.py:118-128) over the module a layer holds:
    BatchNorm (batch statistics and one running update in training, the
    running statistics in eval), LayerNorm, or the identity for
    ``normalization='none'`` (no norm module)."""
    if norm is None:
        return x
    if isinstance(norm, nn.BatchNorm1d):
        return (batch_norm_train(norm, x) if norm.training
                else batch_norm_eval(norm, x))
    return layer_norm(norm, x)


class _ResidualBatchNorm(torch.autograd.Function):
    """See ``residual_batch_norm``.  Saved: ``x = a + b`` and the [2, d]
    statistics; nothing else row-sized."""

    @staticmethod
    def forward(ctx, a, b, weight, bias, bn):
        y, x, stats = bn_residual_forward(
            a.contiguous(), b.contiguous(), weight, bias, bn.running_mean,
            bn.running_var, bn.num_batches_tracked, BN_EPS, BN_MOMENTUM)
        ctx.save_for_backward(x, stats, weight)
        return y

    @staticmethod
    def backward(ctx, g):
        x, stats, weight = ctx.saved_tensors
        dx, dwb = bn_residual_backward(g.contiguous(), x, stats, weight)
        return dx, dx, dwb[0], dwb[1], None


def residual_batch_norm(bn: nn.BatchNorm1d, a: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """Training-mode ``batch_norm_train(bn, a + b)`` as one autograd
    Function (``ops.kernels.bn_residual_forward`` / ``_backward``: the
    kernels on CUDA, their plain versions on the CPU): the batch mean and
    biased variance normalise, gradients flow through both, the running
    statistics take one update (unbiased variance, momentum 0.1) and
    ``num_batches_tracked`` advances by 1.  ``a``, ``b`` [n, d] float32 on
    CUDA (any float dtype on the CPU); the gradient of ``a`` and of ``b`` is
    one tensor."""
    return _ResidualBatchNorm.apply(a, b, bn.weight, bn.bias, bn)
