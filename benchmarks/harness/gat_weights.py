"""The GAT configuration's weights, made by the benchmark from the seed on
the device in one draw, as ``weights.make_weights`` makes the
SymGatedGCN's, under the port's GAT names (``models/zoo.py`` ``GAT``:
GNNome's ``GATModel`` with DGL's ``GATConv`` tensors ``fc``, ``attn_l``,
``attn_r`` and ``bias``, and a ``proj`` linear a layer), so the program
loads them with ``load_state_dict`` and the plain reference reads the same
tensors.

Every linear weight and bias (the encoders, ``fc``, ``proj``, the score
predictor) is U(-1/sqrt(fan_in), 1/sqrt(fan_in)); ``attn_l`` and
``attn_r`` are U(+-sqrt(6 / (d + H d))), the variance 2 / (d + H d) of the
port's xavier-normal init; the conv's output bias [H d] is
U(+-1/sqrt(H d)), where DGL starts it at 0, so that its gradient path is
checked from the first step.
"""
from __future__ import annotations

import numpy as np

from .weights import torch_seed


def param_specs(cfg: dict) -> list:
    """``(name, shape, bound)`` of every tensor, in a fixed order: each is
    U(-bound, bound)."""
    d, ne, heads = cfg["dim_latent"], cfg["hidden_ne_features"], cfg["heads"]
    H, H2 = cfg["hidden_edge_scores"], cfg["score_hidden_2"]
    specs = []

    def linear(name, fan_in, fan_out, bias=True):
        specs.append((f"{name}.weight", (fan_out, fan_in), fan_in ** -0.5))
        if bias:
            specs.append((f"{name}.bias", (fan_out,), fan_in ** -0.5))

    linear("linear1_node", cfg["node_features"], ne)
    linear("linear2_node", ne, d)
    linear("linear1_edge", cfg["edge_features"], ne)
    linear("linear2_edge", ne, d)
    attn = (6.0 / (d + heads * d)) ** 0.5
    for i in range(cfg["num_gnn_layers"]):
        p = f"gnn.convs.{i}"
        specs += [(f"{p}.attn_l", (heads, d), attn),
                  (f"{p}.attn_r", (heads, d), attn),
                  (f"{p}.bias", (heads * d,), (heads * d) ** -0.5)]
        linear(f"{p}.fc", d, heads * d, bias=False)
    linear("predictor.W1", 3 * d, H)
    linear("predictor.W2", H, H2)
    linear("predictor.W3", H2, 1)
    for i in range(cfg["num_gnn_layers"]):
        linear(f"proj.{i}", heads * d, d)
    return specs


def make_weights(cfg: dict, run_seed: int, device) -> dict:
    """``{name: tensor}`` on ``device``: one ``torch.rand`` draw from a
    generator on the device (seeded as ``weights.make_weights`` seeds its
    own), cut into the tensors."""
    import torch

    specs = param_specs(cfg)
    sizes = [int(np.prod(shape)) for _, shape, _ in specs]
    gen = torch.Generator(device=device).manual_seed(torch_seed(run_seed, 0))
    u = torch.rand(sum(sizes), generator=gen, device=device,
                   dtype=torch.float32)
    out, at = {}, 0
    for (name, shape, bound), n in zip(specs, sizes):
        out[name] = ((2.0 * u[at:at + n] - 1.0) * bound).reshape(
            shape).contiguous()
        at += n
    return out
