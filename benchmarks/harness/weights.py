"""The model's weights, made by the benchmark from the seed on the device in
one draw, under the published parameter names (GNNome's
``models/full_graph.py`` and ``layers/*``, which the port keeps), so the
program loads them with ``load_state_dict`` and the plain reference reads
the same tensors.

Every linear weight and bias is U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the
init of ``nn.Linear`` and of the port's ``init_weights``.  Normalisation
parameters start as ``init_weights`` leaves them (scale 1, shift 0, running
mean 0, running variance 1) unless ``eval_state`` asks for a state that a
trained model would carry into eval: scales U(0.5, 1.5), shifts
U(-0.5, 0.5), running means U(-0.5, 0.5), running variances U(0.5, 2).
"""
from __future__ import annotations

import numpy as np


def param_specs(cfg: dict) -> list:
    """``(name, shape, kind, fan_in)`` of every tensor, in a fixed order;
    ``kind`` is ``linear``, ``scale``, ``shift``, ``mean``, ``var`` or
    ``count``."""
    d, ne = cfg["dim_latent"], cfg["hidden_ne_features"]
    H, H2 = cfg["hidden_edge_scores"], cfg["score_hidden_2"]
    specs = []

    def linear(name, fan_in, fan_out):
        specs.append((f"{name}.weight", (fan_out, fan_in), "linear", fan_in))
        specs.append((f"{name}.bias", (fan_out,), "linear", fan_in))

    linear("linear1_node", cfg["node_features"], ne)
    linear("linear2_node", ne, d)
    linear("linear1_edge", cfg["edge_features"], ne)
    linear("linear2_edge", ne, d)
    for i in range(cfg["num_gnn_layers"]):
        for m in ("A_1", "A_2", "A_3", "B_1", "B_2", "B_3"):
            linear(f"gnn.convs.{i}.{m}", d, d)
        for norm in ("bn_h", "bn_e"):
            p = f"gnn.convs.{i}.{norm}"
            specs += [(f"{p}.weight", (d,), "scale", 0),
                      (f"{p}.bias", (d,), "shift", 0)]
            if cfg["normalization"] == "batch":
                specs += [(f"{p}.running_mean", (d,), "mean", 0),
                          (f"{p}.running_var", (d,), "var", 0),
                          (f"{p}.num_batches_tracked", (), "count", 0)]
    linear("predictor.W1", 3 * d, H)
    linear("predictor.W2", H, H2)
    linear("predictor.W3", H2, 1)
    return specs


def torch_seed(run_seed: int, purpose: int) -> int:
    """A 63-bit ``torch.Generator`` seed for one purpose of a run (0 the
    weights, 1 the dropout masks)."""
    words = np.random.SeedSequence([abs(int(run_seed)), int(run_seed < 0),
                                    100 + purpose]).generate_state(2)
    return (int(words[0]) << 31 | int(words[1])) & (2 ** 63 - 1)


def make_weights(cfg: dict, run_seed: int, device, eval_state: bool) -> dict:
    """``{name: tensor}`` on ``device``: one ``torch.rand`` draw from a
    generator on the device, cut into the tensors."""
    import torch

    specs = param_specs(cfg)
    sizes = [int(np.prod(shape)) for _, shape, _, _ in specs]
    gen = torch.Generator(device=device).manual_seed(torch_seed(run_seed, 0))
    u = torch.rand(sum(sizes), generator=gen, device=device,
                   dtype=torch.float32)
    out, at = {}, 0
    for (name, shape, kind, fan_in), n in zip(specs, sizes):
        r = u[at:at + n].reshape(shape)
        at += n
        if kind == "linear":
            t = (2.0 * r - 1.0) / fan_in ** 0.5
        elif kind == "count":
            t = torch.zeros((), dtype=torch.long, device=device)
        elif not eval_state:
            t = torch.ones_like(r) if kind in ("scale", "var") else \
                torch.zeros_like(r)
        elif kind == "scale":
            t = 0.5 + r
        elif kind == "var":
            t = 0.5 + 1.5 * r
        else:                                   # shift, mean
            t = r - 0.5
        out[name] = t.contiguous()
    return out
