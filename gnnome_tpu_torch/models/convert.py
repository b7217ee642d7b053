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


def numpy_from_module_state(path_or_sd) -> tuple[dict, dict]:
    """(params, state) numpy pytrees from a module state dict or a reference
    ``.pt`` checkpoint path."""
    sd = _load_state_dict(path_or_sd) if isinstance(path_or_sd, str) else {
        k: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
        for k, v in path_or_sd.items()}

    n_layers = 1 + max(int(k.split(".")[2]) for k in sd
                       if k.startswith("gnn.convs."))

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
            **{bn: {"scale": np.asarray(sd[f"gnn.convs.{i}.{bn}.weight"],
                                        np.float32),
                    "bias": np.asarray(sd[f"gnn.convs.{i}.{bn}.bias"],
                                       np.float32)}
               for bn in ("bn_h", "bn_e")},
        }),
        "predictor": {w: _lin(sd, f"predictor.{w}") for w in ("W1", "W2", "W3")},
    }
    state = {
        "gnn": stack(lambda i: {
            bn: {"mean": np.asarray(sd[f"gnn.convs.{i}.{bn}.running_mean"],
                                    np.float32),
                 "var": np.asarray(sd[f"gnn.convs.{i}.{bn}.running_var"],
                                   np.float32),
                 "count": np.asarray(
                     sd[f"gnn.convs.{i}.{bn}.num_batches_tracked"], np.int64)}
            for bn in ("bn_h", "bn_e")
        }),
    }
    return params, state


def module_state_from_numpy(params: dict, state: dict) -> dict:
    """``nn.Module`` state dict (CPU tensors) from the numpy pytrees: linear
    weights transposed to ``[out, in]``, stacked GNN leaves split per layer."""
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
        for bn in ("bn_h", "bn_e"):
            sd[f"gnn.convs.{i}.{bn}.weight"] = torch.from_numpy(
                np.asarray(gnn[bn]["scale"])[i].copy())
            sd[f"gnn.convs.{i}.{bn}.bias"] = torch.from_numpy(
                np.asarray(gnn[bn]["bias"])[i].copy())
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
