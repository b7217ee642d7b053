"""Small building blocks shared by the model (reference
layers/node_encoder.py:29-34, models/full_graph.py:26-27)."""
from __future__ import annotations

import torch
from torch import nn


def mlp2(lin1: nn.Linear, lin2: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """2-layer MLP with ReLU: ``lin2(relu(lin1(x)))``."""
    return lin2(torch.relu(lin1(x)))


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout (torch ``F.dropout`` semantics, reference
    gated_gcn_full.py:139; JAX ``models/nn.py:40-45``): keep each element
    with probability ``1 - rate`` and scale it by ``1 / (1 - rate)``.  The
    mask comes from ``generator`` (on ``x``'s device), never from the global
    RNG."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
