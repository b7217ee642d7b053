"""Weight conversion between the numpy pytrees of ``weights/weights.npz`` and
the ``nn.Module`` state dict of ``models/sym_gated_gcn.SymGatedGCN``.

The module's state-dict names are the reference SymGatedGCNModel's
(weights/weights.pt; layer shapes per models/full_graph.py:14-19), so a
reference ``.pt`` loads into the module directly.  Key map:

  linear{1,2}_node / linear{1,2}_edge      <-> node_encoder/edge_encoder mlp2
  gnn.convs.{i}.{A_1..B_3}.{weight,bias}   <-> params['gnn'][A1..B3] stacked on axis 0
  gnn.convs.{i}.bn_{h,e}.{weight,bias}     <-> params['gnn']['bn_*'] scale/bias
  gnn.convs.{i}.bn_{h,e}.running_{mean,var}, num_batches_tracked
                                           <-> state['gnn']['bn_*']
  predictor.W{1,2,3}                       <-> params['predictor']

Linear weights are ``[in, out]`` in the pytrees and ``[out, in]`` in
``nn.Linear``; the pytrees stack the GNN layers ``[L, ...]``, the module keeps
one submodule per layer.

The pytrees hold ``bn_*`` leaves whatever the normalisation (the JAX
package's ``init_params`` makes them for every model).  The module has them
as ``BatchNorm1d`` (batch), as ``LayerNorm`` weight and bias (layer: the
running statistics are dropped), or not at all (none).  Going back, the
leaves a module lacks are written with the JAX init values: scale 1,
bias 0, mean 0, var 1, count 0.
"""
from __future__ import annotations

import numpy as np

_LAYER_LINEARS = (("A1", "A_1"), ("A2", "A_2"), ("A3", "A_3"),
                  ("B1", "B_1"), ("B2", "B_2"), ("B3", "B_3"))


def _lin(sd: dict, prefix: str) -> dict:
    return {"w": np.asarray(sd[f"{prefix}.weight"], dtype=np.float32).T.copy(),
            "b": np.asarray(sd[f"{prefix}.bias"], dtype=np.float32)}


def _stack(trees: list):
    """Stack a list of identically-shaped nested dicts leaf-wise on axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees, axis=0)


def _load_state_dict(path: str) -> dict:
    import torch

    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "model_state_dict" in sd:  # full training checkpoint (train.py:62-70)
        sd = sd["model_state_dict"]
    return {k: v.detach().numpy() if hasattr(v, "detach") else v
            for k, v in sd.items()}


def _norm_params(sd: dict, prefix: str, d: int) -> dict:
    """scale/bias of a BatchNorm1d or LayerNorm, or the init values when the
    module has none (normalization='none')."""
    if f"{prefix}.weight" not in sd:
        return {"scale": np.ones(d, np.float32),
                "bias": np.zeros(d, np.float32)}
    return {"scale": np.asarray(sd[f"{prefix}.weight"], np.float32),
            "bias": np.asarray(sd[f"{prefix}.bias"], np.float32)}


def _norm_state(sd: dict, prefix: str, d: int) -> dict:
    """BatchNorm running statistics, or the init values when the module
    keeps none (layer, none)."""
    if f"{prefix}.running_mean" not in sd:
        return {"mean": np.zeros(d, np.float32), "var": np.ones(d, np.float32),
                "count": np.asarray(0, np.int64)}
    return {"mean": np.asarray(sd[f"{prefix}.running_mean"], np.float32),
            "var": np.asarray(sd[f"{prefix}.running_var"], np.float32),
            "count": np.asarray(sd[f"{prefix}.num_batches_tracked"],
                                np.int64)}


def numpy_from_module_state(path_or_sd) -> tuple[dict, dict]:
    """(params, state) numpy pytrees from a module state dict (of any
    normalisation) or a reference ``.pt`` checkpoint path."""
    sd = _load_state_dict(path_or_sd) if isinstance(path_or_sd, str) else {
        k: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
        for k, v in path_or_sd.items()}

    n_layers = 1 + max(int(k.split(".")[2]) for k in sd
                       if k.startswith("gnn.convs."))
    d = np.asarray(sd["gnn.convs.0.A_1.weight"]).shape[0]

    def stack(fn):
        return _stack([fn(i) for i in range(n_layers)])

    params = {
        "node_encoder": {"lin1": _lin(sd, "linear1_node"),
                         "lin2": _lin(sd, "linear2_node")},
        "edge_encoder": {"lin1": _lin(sd, "linear1_edge"),
                         "lin2": _lin(sd, "linear2_edge")},
        "gnn": stack(lambda i: {
            **{name: _lin(sd, f"gnn.convs.{i}.{t}")
               for name, t in _LAYER_LINEARS},
            **{bn: _norm_params(sd, f"gnn.convs.{i}.{bn}", d)
               for bn in ("bn_h", "bn_e")},
        }),
        "predictor": {w: _lin(sd, f"predictor.{w}") for w in ("W1", "W2", "W3")},
    }
    state = {
        "gnn": stack(lambda i: {
            bn: _norm_state(sd, f"gnn.convs.{i}.{bn}", d)
            for bn in ("bn_h", "bn_e")
        }),
    }
    return params, state


def module_state_from_numpy(params: dict, state: dict,
                            normalization: str = "batch") -> dict:
    """``nn.Module`` state dict (CPU tensors) from the numpy pytrees for a
    model of ``normalization``: linear weights transposed to ``[out, in]``,
    stacked GNN leaves split per layer, ``bn_*`` leaves kept as the module
    has them."""
    import torch

    sd = {}

    def put_lin(prefix, p):
        sd[f"{prefix}.weight"] = torch.from_numpy(np.asarray(p["w"]).T.copy())
        sd[f"{prefix}.bias"] = torch.from_numpy(np.asarray(p["b"]).copy())

    put_lin("linear1_node", params["node_encoder"]["lin1"])
    put_lin("linear2_node", params["node_encoder"]["lin2"])
    put_lin("linear1_edge", params["edge_encoder"]["lin1"])
    put_lin("linear2_edge", params["edge_encoder"]["lin2"])

    gnn = params["gnn"]
    n_layers = np.asarray(gnn["A1"]["w"]).shape[0]
    for i in range(n_layers):
        for name, t in _LAYER_LINEARS:
            put_lin(f"gnn.convs.{i}.{t}",
                    {"w": np.asarray(gnn[name]["w"])[i],
                     "b": np.asarray(gnn[name]["b"])[i]})
        if normalization == "none":
            continue
        for bn in ("bn_h", "bn_e"):
            sd[f"gnn.convs.{i}.{bn}.weight"] = torch.from_numpy(
                np.asarray(gnn[bn]["scale"])[i].copy())
            sd[f"gnn.convs.{i}.{bn}.bias"] = torch.from_numpy(
                np.asarray(gnn[bn]["bias"])[i].copy())
            if normalization == "layer":
                continue
            st = state["gnn"][bn]
            sd[f"gnn.convs.{i}.{bn}.running_mean"] = torch.from_numpy(
                np.asarray(st["mean"])[i].copy())
            sd[f"gnn.convs.{i}.{bn}.running_var"] = torch.from_numpy(
                np.asarray(st["var"])[i].copy())
            sd[f"gnn.convs.{i}.{bn}.num_batches_tracked"] = torch.tensor(
                int(np.asarray(st["count"])[i]))
    for w in ("W1", "W2", "W3"):
        put_lin(f"predictor.{w}", params["predictor"][w])
    return sd
