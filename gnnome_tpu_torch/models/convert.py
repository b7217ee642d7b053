"""Weight conversion between the numpy pytrees of ``weights/weights.npz`` and
the ``nn.Module`` state dict of ``models/sym_gated_gcn.SymGatedGCN`` and of
the zoo models (``models/zoo.py``; ``pytrees_from_model`` and
``load_model_pytrees`` take any of them).

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

The zoo models' pytrees (JAX ``gated_gcn_init``, ``gcn_init``,
``gat_init``, ``sage_init``) share the encoders and the predictor; per
model the stacked ``gnn`` leaves map as

  gatedgcn  gnn.convs.{i}.{A_1,A_2,B_1,B_2,B_3}  <-> gnn/{A1,A2,B1,B2,B3}
            gnn.convs.{i}.bn_{h,e}              <-> gnn/bn_* and state/gnn/bn_*
  gcn       gnn.convs.{i}                       <-> gnn/{w,b}
  gat       gnn.convs.{i}.fc.weight [H*d, d]    <-> gnn/fc [d, H*d]
            gnn.convs.{i}.{attn_l,attn_r,bias}  <-> gnn/{attn_l,attn_r,bias}
            proj.{i}                            <-> proj/{w,b}
  sage      gnn.convs.{i}.{fc_self,fc_neigh}    <-> gnn/{fc_self,fc_neigh}

and only the GatedGCN has a state (its BatchNorm statistics); the others'
is ``{}``, which an npz stores as no key at all.
"""
from __future__ import annotations

import numpy as np

_LAYER_LINEARS = (("A1", "A_1"), ("A2", "A_2"), ("A3", "A_3"),
                  ("B1", "B_1"), ("B2", "B_2"), ("B3", "B_3"))
_GATED_LINEARS = (("A1", "A_1"), ("A2", "A_2"), ("B1", "B_1"), ("B2", "B_2"),
                  ("B3", "B_3"))


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


def _module_sd(path_or_sd) -> dict:
    if isinstance(path_or_sd, str):
        return _load_state_dict(path_or_sd)
    return {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
                else np.asarray(v)) for k, v in path_or_sd.items()}


def _n_layers(sd: dict) -> int:
    return 1 + max(int(k.split(".")[2]) for k in sd
                   if k.startswith("gnn.convs."))


def _shared_numpy(sd: dict, **processor) -> dict:
    """The params pytree: the encoders and predictor every model shares,
    around the ``processor`` entries (``gnn``, GAT's ``proj``), in the
    JAX ``*_init`` key order."""
    return {
        "node_encoder": {"lin1": _lin(sd, "linear1_node"),
                         "lin2": _lin(sd, "linear2_node")},
        "edge_encoder": {"lin1": _lin(sd, "linear1_edge"),
                         "lin2": _lin(sd, "linear2_edge")},
        **processor,
        "predictor": {w: _lin(sd, f"predictor.{w}") for w in ("W1", "W2", "W3")},
    }


def _gated_numpy(sd: dict, linears) -> tuple[dict, dict]:
    """(params, state) of a (Sym)GatedGCN state dict with layer linears
    ``linears`` (pytree name, module name)."""
    n_layers = _n_layers(sd)
    d = np.asarray(sd["gnn.convs.0.A_1.weight"]).shape[0]

    def stack(fn):
        return _stack([fn(i) for i in range(n_layers)])

    params = _shared_numpy(sd, gnn=stack(lambda i: {
        **{name: _lin(sd, f"gnn.convs.{i}.{t}") for name, t in linears},
        **{bn: _norm_params(sd, f"gnn.convs.{i}.{bn}", d)
           for bn in ("bn_h", "bn_e")},
    }))
    state = {"gnn": stack(lambda i: {
        bn: _norm_state(sd, f"gnn.convs.{i}.{bn}", d)
        for bn in ("bn_h", "bn_e")})}
    return params, state


def numpy_from_module_state(path_or_sd) -> tuple[dict, dict]:
    """(params, state) numpy pytrees from a SymGatedGCN state dict (of any
    normalisation) or a reference ``.pt`` checkpoint path."""
    return _gated_numpy(_module_sd(path_or_sd), _LAYER_LINEARS)


def zoo_numpy_from_module_state(kind: str, sd) -> tuple[dict, dict]:
    """(params, state) numpy pytrees, in the JAX package's layout, from the
    state dict of the zoo model ``kind`` (see the module docstring)."""
    sd = _module_sd(sd)
    if kind == "gatedgcn":
        return _gated_numpy(sd, _GATED_LINEARS)
    n_layers = _n_layers(sd)

    def stack(fn):
        return _stack([fn(i) for i in range(n_layers)])

    if kind == "gcn":
        return _shared_numpy(
            sd, gnn=stack(lambda i: _lin(sd, f"gnn.convs.{i}"))), {}
    if kind == "gat":
        def f32(k):
            return np.asarray(sd[k], dtype=np.float32)
        return _shared_numpy(sd, gnn=stack(lambda i: {
            "fc": f32(f"gnn.convs.{i}.fc.weight").T.copy(),
            **{k: f32(f"gnn.convs.{i}.{k}")
               for k in ("attn_l", "attn_r", "bias")}}),
            proj=stack(lambda i: _lin(sd, f"proj.{i}"))), {}
    if kind == "sage":
        return _shared_numpy(sd, gnn=stack(lambda i: {
            k: _lin(sd, f"gnn.convs.{i}.{k}")
            for k in ("fc_self", "fc_neigh")})), {}
    raise ValueError(f"not a zoo model: {kind!r}")


def _put_lin(sd: dict, prefix: str, p: dict) -> None:
    import torch

    sd[f"{prefix}.weight"] = torch.from_numpy(np.asarray(p["w"]).T.copy())
    sd[f"{prefix}.bias"] = torch.from_numpy(np.asarray(p["b"]).copy())


def _layer(tree, i: int):
    """Layer ``i`` of a stacked pytree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _shared_module_state(params: dict) -> dict:
    sd = {}
    _put_lin(sd, "linear1_node", params["node_encoder"]["lin1"])
    _put_lin(sd, "linear2_node", params["node_encoder"]["lin2"])
    _put_lin(sd, "linear1_edge", params["edge_encoder"]["lin1"])
    _put_lin(sd, "linear2_edge", params["edge_encoder"]["lin2"])
    for w in ("W1", "W2", "W3"):
        _put_lin(sd, f"predictor.{w}", params["predictor"][w])
    return sd


def _gated_module_state(params: dict, state: dict, normalization: str,
                        linears) -> dict:
    import torch

    sd = _shared_module_state(params)
    gnn = params["gnn"]
    n_layers = np.asarray(gnn["A1"]["w"]).shape[0]
    for i in range(n_layers):
        for name, t in linears:
            _put_lin(sd, f"gnn.convs.{i}.{t}", _layer(gnn[name], i))
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
    return sd


def module_state_from_numpy(params: dict, state: dict,
                            normalization: str = "batch") -> dict:
    """``nn.Module`` state dict (CPU tensors) from the numpy pytrees for a
    SymGatedGCN of ``normalization``: linear weights transposed to
    ``[out, in]``, stacked GNN leaves split per layer, ``bn_*`` leaves kept
    as the module has them."""
    return _gated_module_state(params, state, normalization, _LAYER_LINEARS)


def zoo_module_state_from_numpy(kind: str, params: dict, state: dict,
                                normalization: str = "batch") -> dict:
    """``nn.Module`` state dict (CPU tensors) of the zoo model ``kind``
    from the JAX package's numpy pytrees (see the module docstring)."""
    import torch

    if kind == "gatedgcn":
        return _gated_module_state(params, state, normalization,
                                   _GATED_LINEARS)
    sd = _shared_module_state(params)
    gnn = params["gnn"]
    first = gnn
    while isinstance(first, dict):
        first = next(iter(first.values()))
    for i in range(np.asarray(first).shape[0]):
        p = _layer(gnn, i)
        if kind == "gcn":
            _put_lin(sd, f"gnn.convs.{i}", p)
        elif kind == "gat":
            sd[f"gnn.convs.{i}.fc.weight"] = torch.from_numpy(
                np.asarray(p["fc"], np.float32).T.copy())
            for k in ("attn_l", "attn_r", "bias"):
                sd[f"gnn.convs.{i}.{k}"] = torch.from_numpy(
                    np.asarray(p[k], np.float32).copy())
            _put_lin(sd, f"proj.{i}", _layer(params["proj"], i))
        elif kind == "sage":
            for k in ("fc_self", "fc_neigh"):
                _put_lin(sd, f"gnn.convs.{i}.{k}", p[k])
        else:
            raise ValueError(f"not a zoo model: {kind!r}")
    return sd


def pytrees_from_model(model) -> tuple[dict, dict]:
    """(params, state) numpy pytrees of any model of ``models`` (the
    SymGatedGCN or a zoo model), in the JAX package's layout."""
    if model.kind == "sym_gatedgcn":
        return numpy_from_module_state(model.state_dict())
    return zoo_numpy_from_module_state(model.kind, model.state_dict())


def load_model_pytrees(model, params: dict, state: dict) -> None:
    """Load the JAX-layout numpy pytrees into ``model`` (the SymGatedGCN or
    a zoo model), in place."""
    if model.kind == "sym_gatedgcn":
        sd = module_state_from_numpy(params, state, model.normalization)
    else:
        sd = zoo_module_state_from_numpy(model.kind, params, state,
                                         model.normalization)
    model.load_state_dict(sd)
