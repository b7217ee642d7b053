"""Entry points of the port: the counterpart of the repository's
``__graft_entry__.py`` (which imports the JAX package and stays as it is).

``entry(device)``              -> ``(fn, args)``: ``fn(*args)`` is the eval
                                  forward of the batch-norm SymGatedGCN at
                                  full width (d = 64, 8 layers, the K6
                                  predictor) on a small synthetic assembly
                                  graph: 8 K3 and 1 K6 launches on the card.
``dryrun_multichip(n, device)`` -> one halo train step (symmetry loss, two
                                  directional passes, Adam) over ``n`` ranks
                                  (``parallel.group.spawn``): NCCL with a GPU
                                  per rank, else gloo ranks sharing the card;
                                  ``device="cpu"``: gloo CPU ranks (where
                                  JAX falls back to a virtual CPU mesh).

    python -m gnnome_tpu_torch.entry

runs ``fn(*args)`` once, prints the output's shape, then runs
``dryrun_multichip(max(2, torch.cuda.device_count()))``.  Both entry
points run on the card unless the caller passes ``device="cpu"``; without
a GPU they raise.  The port's ``DeviceGraph`` is unpadded, so the JAX
entry's edge and node padding (256, 64) and its slot-order inputs have no
counterpart: the arguments and the logits are in host edge order.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import Config, resolve_device
from .graphs import synthetic_assembly_graph
from .models.convert import load_model_pytrees, pytrees_from_model
from .models.features import _zscore
from .models.zoo import get_model
from .ops.graph_tensors import DeviceGraph
from .train.step import host_units

ENTRY_GRAPH = dict(n_reads=60, genome_len=5000, read_len=300, seed=0,
                   with_sequences=True)
DRYRUN_DEADLINE_S = 900.0


def dryrun_graph(n: int) -> dict:
    """The dry run's graph at ``n`` ranks (``__graft_entry__.py:123-125``):
    large enough that each rank's block exceeds the graph's reach."""
    return dict(n_reads=40 * n, genome_len=3000 * n, read_len=300, seed=0,
                with_sequences=True, false_edge_frac=0.01)


def _config(device: str) -> Config:
    cfg = Config()
    cfg.compute.device = device
    cfg.train.masking = False
    return cfg


def _unit(graph_kw: dict, cfg: Config):
    g, _, _, _ = synthetic_assembly_graph(**graph_kw)
    (unit,) = host_units(g, cfg, np.random.default_rng(0))
    return unit


def entry(device: str = "cuda", weights=None):
    """``(fn, (x, e))``: ``fn(x, e)`` is the eval forward's logits [E]
    (host edge order) of the default batch-norm SymGatedGCN on
    ``synthetic_assembly_graph(n_reads=60, genome_len=5000, read_len=300,
    seed=0)`` as one unit (masking off), its ``DeviceGraph`` and weights
    bound in; ``x`` the z-scored (in, out) degrees [N, 2], ``e`` the edge
    features [E, 2], on ``device``.  The weights are ``init_weights(0)``,
    or ``weights``: numpy pytrees ``(params, state)`` in the JAX package's
    layout."""
    dev = resolve_device(device)
    cfg = _config(device)
    unit = _unit(ENTRY_GRAPH, cfg)
    model = get_model(cfg.model)
    if weights is None:
        model.init_weights(0)
    else:
        load_model_pytrees(model, *weights)
    model = model.to(dev).eval()
    g = DeviceGraph.build(unit.src, unit.dst, unit.n_nodes, dev)
    x = torch.as_tensor(np.stack([_zscore(unit.in_deg),
                                  _zscore(unit.out_deg)], axis=1),
                        device=dev)
    e = torch.as_tensor(np.ascontiguousarray(unit.e_feat, dtype=np.float32),
                        device=dev)

    @torch.inference_mode()
    def fn(x, e):
        return model(g, x, e)[:, 0]

    return fn, (x, e)


def dryrun_inputs(n: int, device: str = "cuda",
                  dropout: float | None = None):
    """``(unit, params, state, cfg)`` of the dry run at ``n`` ranks: the
    ``dryrun_graph(n)`` unit (masking off), ``init_weights(0)`` of the
    default model, ``compute.mesh = n``; ``dropout`` replaces the model's
    default rate."""
    cfg = _config(device)
    cfg.compute.mesh = n
    if dropout is not None:
        cfg.model.dropout = dropout
    unit = _unit(dryrun_graph(n), cfg)
    params, state = pytrees_from_model(get_model(cfg.model).init_weights(0))
    return unit, params, state, cfg


def dryrun_multichip(n: int, device: str = "cuda",
                     dropout: float | None = None) -> dict:
    """One halo train step of ``dryrun_inputs(n, device, dropout)`` over
    ``n`` ranks (``parallel.checks.train_step_job``, pos_weight 1; the
    ranks fail after ``DRYRUN_DEADLINE_S``).
    Raises unless the loss is finite and the same on every rank and the
    parameters after Adam are bitwise equal on every rank.  Prints one
    line (n, the plan's K and R, edges per rank, loss) and returns rank
    0's result with ``launches_per_rank`` and ``edges_per_rank``.

    JAX's GSPMD fallback for a graph with no halo plan
    (``__graft_entry__.py:152-165``) has no counterpart: the port's
    ``plan_graph`` always returns a plan, lifting the overflow cap where
    no banded one exists (``parallel/halo.py`` ``plan_graph``)."""
    from .parallel.checks import train_step_job
    from .parallel.group import spawn

    unit, params, state, cfg = dryrun_inputs(n, device, dropout)
    res = spawn(train_step_job, n, unit, params, state, cfg, 1.0,
                device=device, deadline_s=DRYRUN_DEADLINE_S)
    r0 = res[0]
    loss = r0["loss"]
    if not np.isfinite(loss) or any(r["loss"] != loss for r in res):
        raise RuntimeError(f"dryrun_multichip({n}): losses per rank "
                           f"{[r['loss'] for r in res]}")
    for r in res[1:]:
        _same_tree(r["params"], r0["params"], f"rank {r['rank']}")
    edges = [r["n_edges"] for r in res]
    print(f"dryrun_multichip({n}): halo train step OK (K={r0['K']}, "
          f"R={r0['R']}, route={r0['route']}, edges per rank={edges}), "
          f"loss={loss:.4f}", flush=True)
    return {**r0, "n": n, "edges_per_rank": edges,
            "launches_per_rank": [r["launches"] for r in res],
            "launches_bf16_per_rank": [r["launches_bf16"] for r in res]}


def _same_tree(got: dict, want: dict, what: str, prefix: str = "") -> None:
    for k, v in want.items():
        if isinstance(v, dict):
            _same_tree(got[k], v, what, f"{prefix}{k}/")
        elif not np.array_equal(got[k], v):
            raise RuntimeError(f"dryrun_multichip: {what}'s {prefix}{k} "
                               "differs from rank 0's after the step")


def main() -> None:
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry() forward OK:", tuple(out.shape), flush=True)
    dryrun_multichip(max(2, torch.cuda.device_count()))


if __name__ == "__main__":
    main()
