"""Flat-npz pytree persistence for model params/state.

The native weight format: one npz with ``/``-joined key paths holding the
numpy pytrees ``params`` and ``state`` (linear weights ``[in, out]``, GNN
layers stacked on axis 0).  ``models/convert.py`` turns them into the
``nn.Module`` state dict.  Also reads the reference's torch
``weights.pt``/``ckpt_*.pt`` (via models/convert.py).
"""
from __future__ import annotations

import os

import numpy as np


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    else:
        out[prefix] = np.asarray(tree)


def flatten_pytree(tree, prefix="") -> dict:
    out: dict[str, np.ndarray] = {}
    _flatten(tree, prefix, out)
    return out


def unflatten_pytree(flat: dict) -> dict:
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def save_pytrees(path: str, **trees) -> None:
    flat = {}
    for name, tree in trees.items():
        flat.update(flatten_pytree(tree, name))
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def load_pytrees(path: str) -> dict:
    with np.load(path) as z:
        return unflatten_pytree({k: z[k] for k in z.files})


def load_model_weights(path: str):
    """(params, state) from either the native npz or a torch checkpoint
    (reference weights/weights.pt or train.py:62-70 ckpt dicts)."""
    if path.endswith(".pt") or path.endswith(".pth"):
        from .convert import numpy_from_module_state
        return numpy_from_module_state(path)
    trees = load_pytrees(path)
    # a stateless model (GCN, GAT, SAGE) saves state {}: no key at all
    return trees["params"], trees.get("state", {})


def save_model_weights(path: str, params, state) -> None:
    save_pytrees(path, params=params, state=state)
