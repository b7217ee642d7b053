"""Deterministic seeding (reference utils/utils.py:10-30).

Seeds Python's and numpy's global RNGs for the CPU-side pipeline (decode
sampling) and returns an explicit numpy Generator plus a ``torch.Generator``
for any tensor randomness, instead of seeding torch's global state.
"""
from __future__ import annotations

import random

import numpy as np


def set_seed(seed: int = 42):
    """Seed host RNGs and return (numpy Generator, CPU torch.Generator)."""
    import torch

    random.seed(seed)
    np.random.seed(seed)
    return np.random.default_rng(seed), torch.Generator().manual_seed(seed)
