"""Small building blocks shared by the model (reference
layers/node_encoder.py:29-34, models/full_graph.py:26-27)."""
from __future__ import annotations

import torch
from torch import nn


def mlp2(lin1: nn.Linear, lin2: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """2-layer MLP with ReLU: ``lin2(relu(lin1(x)))``."""
    return lin2(torch.relu(lin1(x)))
