"""Eval-mode BatchNorm with the JAX package's arithmetic
(``gnnome_tpu/models/norm.py:64-68``), over ``nn.BatchNorm1d`` modules so the
state-dict names and buffers stay the reference's.  Training-mode
statistics are not ported yet."""
from __future__ import annotations

import torch
from torch import nn

BN_EPS = 1e-5


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
