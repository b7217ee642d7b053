#!/usr/bin/env python
"""The cluster route at chromosome scale on the port (the counterpart of
``scripts/config4_route.py``): what the reference's own route above its
cluster threshold (cluster-minibatch training, reference
train.py:335,404) costs, on one card.

  A. config-4 scale: ``positional_bench_assembly_graph(1,048,576, seed=4)``
     (about 4.8M edges) trained in clusters of ``--cluster-nodes`` (65,536)
     for ``--epochs-a`` (2) epochs: units per epoch, edges/s, launches per
     unit.
  B. at a size where both routes fit (``positional_bench_assembly_graph(
     458,752, seed=5)``, about 2.1M edges): ``--epochs-b`` (10) epochs of
     full-graph training against as many in clusters, from the same
     initial weights, each evaluated every epoch on the same full graph;
     the per-epoch eval-loss gap is the cluster route's cost.

``run_units`` is the JAX script's minimal deterministic trainer on the
port's pieces: ``train.step.host_units(..., shuffle_parts=False)``,
``make_example`` (every example built once before the epochs, timed as
``prep_s``), ``train_step`` and ``eval_step`` with ``pos_weight`` from the
graph, initial weights from ``init_weights(1)`` unless the caller passes
numpy pytrees.  Dropout masks come from a ``torch.Generator`` seeded with
the epoch (the JAX script's ``PRNGKey(epoch)``).

Settings: ``compute.dtype=bfloat16`` (``--set compute.dtype=float32`` for
float32), masking off.  The JAX
script's ``matmul_precision='default'`` is what the port's bf16 mode does
(bf16 operands, float32 accumulation); its ``remat`` (``True`` / ``'full'``)
and ``bucket_growth`` are dropped (the training edge stage keeps small
residuals; no shape buckets).  The port sets ``compute.dtype`` and
``compute.device`` and nothing else of ``compute``.  The port compiles
nothing per shape: the output holds launches per unit instead of a compile
count, and ``kernel_builds``.

Stages (``--stage a|b|all``) add to ``--out`` (``CONFIG4_ROUTE_torch.json``
at the repository root) and rewrite it after each, with the card's name and
power limit, ``peak_mb`` per run and ``steady_edges_per_s`` (epoch 1 on).

    python scripts/torch_config4_route.py --stage a
    python scripts/torch_config4_route.py --stage b
    python scripts/torch_config4_route.py --config4-nodes 65536 \\
        --both-nodes 32768 --cluster-nodes 16384 --epochs-a 1 --epochs-b 2
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "CONFIG4_ROUTE_torch.json")
FULL_GRAPH = 10 ** 12            # a cluster size no graph reaches: one unit

def build_graph(n_nodes: int, seed: int):
    from gnnome_tpu_torch.graphs.synthetic import (
        positional_bench_assembly_graph)

    return positional_bench_assembly_graph(n_nodes, seed)


def make_cfg(cluster: int, epochs: int, device: str, overrides=()):
    from gnnome_tpu_torch.config import Config

    cfg = Config()
    cfg.train.num_epochs = epochs
    cfg.train.seed = 1
    cfg.train.masking = False
    cfg.train.num_nodes_per_cluster = cluster
    cfg.compute.dtype = "bfloat16"
    cfg.compute.device = device
    return cfg.apply_overrides(list(overrides))


def _examples(units, cfg, device):
    from gnnome_tpu_torch.train.step import make_example

    return [make_example(u.in_deg, u.out_deg, u.e_feat, u.y, u.src, u.dst,
                         u.n_nodes, device) for u in units]


def run_units(g, cfg, epochs: int, eval_graph=None, label: str = "",
              init=None) -> dict:
    """Train ``cfg.model`` on ``g``'s host units (masking and clusters as
    ``cfg`` says, parts unshuffled) for ``epochs`` epochs, one Adam step
    per unit; per epoch the mean train loss, the wall time and, with
    ``eval_graph``, its full-graph eval loss and AP.  ``init``: numpy
    pytrees ``(params, state)`` of the initial weights."""
    import dataclasses

    import numpy as np
    import torch

    from gnnome_tpu_torch.config import resolve_device
    from gnnome_tpu_torch.models.convert import load_model_pytrees
    from gnnome_tpu_torch.models.zoo import get_model
    from gnnome_tpu_torch.train.metrics import get_aps
    from gnnome_tpu_torch.train.step import (eval_step, host_units,
                                             make_optimizer, train_step)
    from gnnome_tpu_torch.utils import record

    dev = resolve_device(cfg.compute.device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    record.reset_peak(dev)
    model = get_model(cfg.model)
    if init is None:
        model.init_weights(1)
    else:
        load_model_pytrees(model, *init)
    model.to(dev)
    opt = make_optimizer(model, cfg.train.lr)
    generator = torch.Generator(device=dev)

    pos = float((g.y == 1).sum())
    neg = float((g.y == 0).sum())
    pw = neg / max(pos, 1.0)

    t0 = time.perf_counter()
    units = host_units(g, cfg, np.random.default_rng(0), shuffle_parts=False)
    exs = _examples(units, cfg, dev)
    sync()
    t_prep = time.perf_counter() - t0
    ex_ev = None
    if eval_graph is not None:
        cfg_ev = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, num_nodes_per_cluster=FULL_GRAPH))
        (ex_ev,) = _examples(host_units(eval_graph, cfg_ev,
                                        np.random.default_rng(0),
                                        shuffle_parts=False), cfg_ev, dev)

    rows, total_edges = [], 0
    unit_edges = [int(ex.labels.shape[0]) for ex in exs]
    t_train0 = time.perf_counter()
    for ep in range(epochs):
        t_ep = time.perf_counter()
        generator.manual_seed(ep)
        start = record.launches()
        losses = [train_step(model, opt, ex, pw, cfg, generator)[0]
                  for ex in exs]
        train_loss = float(np.mean(                          # syncs
            torch.stack(losses).cpu().numpy().astype(np.float64)))
        launched = record.launches_since(start)["all"]
        total_edges += sum(unit_edges)
        row = {"epoch": ep, "train_loss": train_loss,
               "epoch_wall_s": time.perf_counter() - t_ep,
               "launches": launched}
        if ex_ev is not None:
            start = record.launches()
            ev_loss, ev_logits = eval_step(model, ex_ev, pw, cfg)
            row["eval_loss"] = float(ev_loss)
            row["eval_ap"] = get_aps(ev_logits.cpu().numpy().astype(
                np.float64), ex_ev.labels_host.astype(np.int32))
            row["eval_launches"] = record.launches_since(start)["all"]
        rows.append(row)
        print(f"  [{label}] {row}", flush=True)
    sync()
    wall = time.perf_counter() - t_train0
    steady = rows[1:]
    steady_wall = sum(r["epoch_wall_s"] for r in steady)
    layers = cfg.model.num_gnn_layers
    expected = record.expected_launches(len(exs), layers=layers)
    expected_eval = record.expected_launches(0, 1, layers=layers)
    return {"units_per_epoch": len(exs), "unit_edges": unit_edges,
            "prep_s": t_prep, "train_wall_s": wall,
            "edges_per_s": total_edges / wall,
            "steady_epoch_wall_s": (steady_wall / len(steady)
                                    if steady else None),
            "steady_edges_per_s": (sum(unit_edges) * len(steady) / steady_wall
                                   if steady else None),
            "launches_per_unit": record.unit_launches(layers)[0],
            "launches_match_units": (all(
                r["launches"] == expected
                and r.get("eval_launches", expected_eval) == expected_eval
                for r in rows) if on_card else None),
            "peak_mb": record.peak_mb(dev),
            "epochs": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stage", default="all", choices=["a", "b", "all"])
    ap.add_argument("--config4-nodes", type=int, default=1_048_576)
    ap.add_argument("--both-nodes", type=int, default=458_752)
    ap.add_argument("--cluster-nodes", type=int, default=65_536)
    ap.add_argument("--epochs-a", type=int, default=2)
    ap.add_argument("--epochs-b", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="SECTION.KEY=VALUE", help="config override")
    args = ap.parse_args(argv)

    from gnnome_tpu_torch.config import resolve_device
    from gnnome_tpu_torch.utils import record

    dev = resolve_device(args.device)
    out = record.read_json(args.out)
    out.update(record.device_record(dev))

    def cfg(cluster, epochs):
        return make_cfg(cluster, epochs, args.device, args.overrides)

    out["dtype"] = cfg(1, 1).compute.dtype

    if args.stage in ("a", "all"):
        print("=== A: config-4 scale, cluster-minibatch route ===", flush=True)
        t0 = time.perf_counter()
        g4 = build_graph(args.config4_nodes, seed=4)
        build_s = time.perf_counter() - t0
        print(f"graph: {g4.num_nodes} nodes / {g4.num_edges} edges",
              flush=True)
        res = run_units(g4, cfg(args.cluster_nodes, args.epochs_a),
                        args.epochs_a, label="A-cluster")
        res.update(n_nodes=g4.num_nodes, n_edges=g4.num_edges,
                   cluster_nodes=args.cluster_nodes, graph_build_s=build_s,
                   kernel_builds=record.kernel_builds())
        out["A_config4_cluster_route"] = res
        record.write_json(args.out, out)

    if args.stage in ("b", "all"):
        print("=== B: cluster-vs-full convergence at a size fitting both ===",
              flush=True)
        gb = build_graph(args.both_nodes, seed=5)
        print(f"graph: {gb.num_nodes} nodes / {gb.num_edges} edges",
              flush=True)
        res_full = run_units(gb, cfg(FULL_GRAPH, args.epochs_b),
                             args.epochs_b, eval_graph=gb, label="B-full")
        res_clu = run_units(gb, cfg(args.cluster_nodes, args.epochs_b),
                            args.epochs_b, eval_graph=gb, label="B-cluster")
        gap = [a["eval_loss"] - b["eval_loss"]
               for a, b in zip(res_clu["epochs"], res_full["epochs"])]
        out["B_convergence"] = {
            "n_nodes": gb.num_nodes, "n_edges": gb.num_edges,
            "cluster_nodes": args.cluster_nodes,
            "full_graph": res_full, "cluster": res_clu,
            "eval_loss_gap_cluster_minus_full_per_epoch": gap,
            "kernel_builds": record.kernel_builds()}
        record.write_json(args.out, out)
    print(json.dumps(out, default=float)[:2000], flush=True)
    print(f"wrote {args.out}", flush=True)
    return out


if __name__ == "__main__":
    main()
