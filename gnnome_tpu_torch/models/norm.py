"""Normalisation with the JAX package's arithmetic (``gnnome_tpu/models/
norm.py``), over ``nn.BatchNorm1d`` / ``nn.LayerNorm`` modules so the
state-dict names and buffers stay the reference's.

BatchNorm:

* eval: normalise with the running statistics (norm.py:64-68);
* training (norm.py:47-63): normalise with the biased batch variance
  (two-pass), update the running statistics with the unbiased variance at
  momentum 0.1, ``repeat_updates`` times, and advance
  ``num_batches_tracked`` as often (the JAX ``count``).

LayerNorm (norm.py:111-115) is the same in eval and training; ``none``
(norm.py:118-128) is the identity.
"""
from __future__ import annotations

import torch
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
LN_EPS = 1e-5


def batch_norm_eval(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` with running stats."""
    inv = torch.rsqrt(bn.running_var + BN_EPS)
    return (x - bn.running_mean) * inv * bn.weight + bn.bias


def batch_norm_rows(bn: nn.BatchNorm1d) -> torch.Tensor:
    """Eval BatchNorm as the ``[4, d]`` rows ``[mean, rsqrt(var + eps),
    weight, bias]`` that the fused edge-stage kernel takes.  Not folded into
    one affine ``x * s + (bias - mean * s)``: that form cancels where x is
    near the mean (see csrc/k3_edge_stage.cu)."""
    return torch.stack([bn.running_mean, torch.rsqrt(bn.running_var + BN_EPS),
                        bn.weight, bn.bias])


@torch.no_grad()
def update_running_stats(bn: nn.BatchNorm1d, mean: torch.Tensor,
                         unbiased_var: torch.Tensor,
                         repeat_updates: int = 1) -> None:
    """``running = 0.9 * running + 0.1 * batch``, ``repeat_updates`` times
    (the shared ``bn_e`` of the reference advances twice per layer,
    gated_gcn_full.py:106,119); ``num_batches_tracked`` advances as often."""
    rm, rv = bn.running_mean, bn.running_var
    for _ in range(repeat_updates):
        rm = (1.0 - BN_MOMENTUM) * rm + BN_MOMENTUM * mean
        rv = (1.0 - BN_MOMENTUM) * rv + BN_MOMENTUM * unbiased_var
    bn.running_mean.copy_(rm)
    bn.running_var.copy_(rv)
    bn.num_batches_tracked.add_(repeat_updates)


def batch_norm_train(bn: nn.BatchNorm1d, x: torch.Tensor,
                     repeat_updates: int = 1) -> torch.Tensor:
    """Training-mode BatchNorm over the rows of ``x`` [n, d]: batch mean,
    biased variance (two-pass) normalises, gradients flow through both;
    the running statistics are updated (no gradient)."""
    n = x.shape[0]
    mean = x.sum(0) / n
    var = ((x - mean) ** 2).sum(0) / n
    inv = torch.rsqrt(var + BN_EPS)
    y = (x - mean) * inv
    update_running_stats(bn, mean.detach(),
                         var.detach() * (n / (n - 1) if n > 1 else 1.0),
                         repeat_updates)
    return y * bn.weight + bn.bias


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """Per-row LayerNorm in the JAX package's explicit form: row mean,
    biased row variance, ``(x - mean) * rsqrt(var + eps) * weight + bias``."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * ln.weight + ln.bias


def apply_norm(norm: nn.LayerNorm | None, x: torch.Tensor) -> torch.Tensor:
    """The unfused layer's normalisation: LayerNorm, or the identity for
    ``normalization='none'`` (no norm module)."""
    return x if norm is None else layer_norm(norm, x)
