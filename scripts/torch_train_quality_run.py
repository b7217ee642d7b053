#!/usr/bin/env python
"""The from-scratch training-quality gate on the port (the counterpart of
``scripts/train_quality_run.py``): training the model from scratch gives
one that assembles.  Four stages, each its own command if need be:

1. ``build``: a multi-graph discriminating synthetic dataset (real
   sequences, 2% read errors, wrong-strand hard negatives, planted repeats
   at varied lengths, coverage gaps): the JAX script's ``TRAIN_SPEC``,
   ``REPEAT_FRACS`` and seeds, 8 training and 2 validation graphs of 2,400
   nodes, on the host.
2. ``train``: ``gnnome_tpu_torch.train.loop.train`` on ``--device``
   (default ``cuda``) with the JAX run's settings (per-epoch shuffle,
   strandwise masking, clusters of 1,000 nodes, symmetry loss,
   ``pos_weight``, plateau scheduler, validation-driven model selection):
   ``--epochs`` (20), and with ``--resume`` on to ``--epochs`` from the
   checkpoint (the JAX record ran 20, then resumed to 55).
3. ``parity``: the port (``--device``, float32, TF32 off) against the
   torch oracle (``tests/torch_ref.py``, CPU, ``torch.use_deterministic_
   algorithms(True)``), from identical initial weights (the port's
   ``init_weights(1)``, or numpy pytrees a caller passes, carried into the
   oracle through the shared state-dict names), on training graph 0 with
   validation graph 0: full graph, symmetry loss, Adam 1e-4, dropout 0,
   ``pos_weight`` from graph 0, ``--parity-epochs`` (8); both trajectories
   and their divergence.
4. ``golden``: the tracked golden fixture (``tests/fixtures/
   golden_ecoli_v1.npz``) scored on ``--device`` with the self-trained
   weights, the shipped ``weights/weights.npz`` and the JAX run's
   ``weights/self_trained_r05.npz``: AP and the greedy decode of each, and
   of the labels.  The self-trained weights are copied to
   ``--save-weights`` (``weights/self_trained_torch.npz``).

The JAX script's settings the port does not have: ``compute.bucket_growth``
(no shape buckets) and ``compute.backend='xla'`` (the tensor's device
chooses kernel or plain version) are dropped.  The port sets
``compute.device`` and nothing else of ``compute`` (float32).

Every stage adds its results to ``--out`` (``TRAIN_QUALITY_torch.json`` at
the repository root) and rewrites it, so the file parses after any stage;
``complete`` turns true when all four are in.  Each result holds the
device (card name and power limit), peak device memory and kernel
launches.

    python scripts/torch_train_quality_run.py --stage build train
    python scripts/torch_train_quality_run.py --stage train --resume \\
        --epochs 55
    python scripts/torch_train_quality_run.py --stage parity golden
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

GOLDEN_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "golden_ecoli_v1.npz")
OUT_JSON = os.path.join(ROOT, "TRAIN_QUALITY_torch.json")
ECOLI_BP = 4_641_652
RUN_NAME = "quality_torch"
GOLDEN_WEIGHTS = {
    "shipped": os.path.join(ROOT, "weights", "weights.npz"),
    "jax_self_trained_r05": os.path.join(ROOT, "weights",
                                         "self_trained_r05.npz")}
# the JAX package's golden AP with the shipped weights (GOLDEN_ECOLI_r05.json)
JAX_GOLDEN_AP = 0.9992885985330671

# the JAX script's training-graph spec: the golden recipe at ~1/13 scale,
# several planted repeat pairs at varied length fractions of the read length
TRAIN_SPEC = dict(genome_len=360_000, read_len=6_000, n_reads=1_200,
                  error_rate=0.02, hard_false_frac=0.10, false_edge_frac=0.15,
                  n_coverage_gaps=1, n_repeat_pairs=5, sim_band_frac=0.15)
REPEAT_FRACS = [0.5, 0.6, 0.7, 0.8]      # repeat_len = frac * read_len
TRAIN_SEEDS = [100, 101, 102, 103, 104, 105, 106, 107]
VALID_SEEDS = [200, 201]


def _build_graph(seed: int, spec: dict | None = None):
    from gnnome_tpu_torch.graphs.synthetic import synthetic_assembly_graph

    spec = dict(TRAIN_SPEC if spec is None else spec)
    spec["repeat_len"] = int(
        spec["read_len"] * REPEAT_FRACS[seed % len(REPEAT_FRACS)])
    g, _, _, _ = synthetic_assembly_graph(
        seed=seed, with_labels=True, with_sequences=True, **spec)
    return g


def stage_build(root: str, train_seeds=TRAIN_SEEDS, valid_seeds=VALID_SEEDS,
                spec: dict | None = None) -> dict:
    """The dataset under ``root/train`` and ``root/valid`` (the similarity
    aligner already uses every host core)."""
    t0 = time.perf_counter()
    rows = []
    for split, seeds in (("train", train_seeds), ("valid", valid_seeds)):
        pdir = os.path.join(root, split, "hifiasm", "processed")
        os.makedirs(pdir, exist_ok=True)
        for i, seed in enumerate(seeds):
            t1 = time.perf_counter()
            g = _build_graph(seed, spec)
            g.save(os.path.join(pdir, f"{i}.npz"))
            row = {"split": split, "seed": seed, "nodes": g.num_nodes,
                   "edges": g.num_edges, "pos_frac": float(g.y.mean()),
                   "build_s": time.perf_counter() - t1}
            rows.append(row)
            print(f"  built {row}", flush=True)
    return {"spec": TRAIN_SPEC if spec is None else spec,
            "train_seeds": list(train_seeds), "valid_seeds": list(valid_seeds),
            "graphs": rows, "build_total_s": time.perf_counter() - t0}


def train_cfg(root: str, epochs: int, device: str, overrides=()):
    from gnnome_tpu_torch.config import Config

    cfg = Config()
    cfg.paths.models_path = os.path.join(root, "models")
    cfg.paths.checkpoints_path = os.path.join(root, "checkpoints")
    cfg.train.num_epochs = epochs
    cfg.train.seed = 1
    cfg.train.masking = True
    cfg.train.num_nodes_per_cluster = 1000      # reference default
    cfg.compute.device = device
    return cfg.apply_overrides(list(overrides))


def rel(path: str) -> str:
    """``path`` relative to the repository root where it lies inside it."""
    path = os.path.abspath(path)
    return os.path.relpath(path, ROOT) if path.startswith(ROOT + os.sep) \
        else path


def best_model(models_dir: str, returned: str) -> str:
    """The best model a training run left: the path ``train`` returned,
    or, when a resumed run improved on nothing (and so wrote no model of
    its own), the newest model file before it."""
    if os.path.isfile(returned):
        return returned
    cands = [os.path.join(models_dir, f) for f in os.listdir(models_dir)
             if f.endswith(".npz")]
    return max(cands, key=os.path.getmtime)


def stage_train(root: str, epochs: int, device: str, resume: bool = False,
                overrides=()) -> dict:
    import torch

    from gnnome_tpu_torch.config import resolve_device
    from gnnome_tpu_torch.train.loop import train
    from gnnome_tpu_torch.utils import record

    cfg = train_cfg(root, epochs, device, overrides)
    dev = resolve_device(cfg.compute.device)
    record.reset_peak(dev)
    t0 = time.perf_counter()
    returned = train(os.path.join(root, "train"), os.path.join(root, "valid"),
                     "hifiasm", out_name=RUN_NAME, resume=resume, cfg=cfg)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    with open(os.path.join(cfg.paths.checkpoints_path,
                           f"log_{RUN_NAME}_seed1.jsonl")) as f:
        log = [json.loads(line) for line in f]
    best = max(log, key=lambda r: r.get("valid/ap", 0.0))
    return {"model_path": rel(best_model(cfg.paths.models_path, returned)),
            "epochs": epochs, "resumed": resume, "total_wall_s": wall,
            **record.device_record(dev),
            "peak_mb": record.peak_mb(dev),
            "kernel_builds": record.kernel_builds(),
            "best_valid_ap_epoch": best.get("epoch"),
            "best_valid_ap": best.get("valid/ap"),
            "epoch_metrics": log}


# --------------------------------------------------------------- parity arm
def _features(g):
    """The oracle's inputs: z-scored (in, out) degrees, reversed, and the
    edge features (the JAX script's ``_features``)."""
    import numpy as np

    from gnnome_tpu_torch.models.features import edge_features

    def z(v):
        v = v.astype(np.float32)
        s = v.std(ddof=1) if v.size > 1 else 1.0
        return (v - v.mean()) / (s if s > 0 else 1.0)

    zi, zo = z(g.in_degrees()), z(g.out_degrees())
    return (np.stack([zi, zo], axis=1), np.stack([zo, zi], axis=1),
            edge_features(g))


def _metrics_row(logits, y) -> dict:
    import numpy as np

    from gnnome_tpu_torch.train.metrics import (calculate_metrics,
                                                calculate_tfpn, get_aps)

    tp, tn, fp, fn = calculate_tfpn(logits, y)
    _, _, recall, f1 = calculate_metrics(tp, tn, fp, fn)
    return {"recall@0.5": round(recall, 4), "f1@0.5": round(f1, 4),
            "ap": round(get_aps(np.asarray(logits, np.float64), y), 6)}


def parity_cfg(device: str, overrides=()):
    from gnnome_tpu_torch.config import Config

    cfg = Config()
    cfg.model.dropout = 0.0          # removes RNG as a divergence source
    cfg.train.masking = False
    cfg.train.num_nodes_per_cluster = 10 ** 9
    cfg.train.lr = 1e-4
    cfg.compute.device = device
    return cfg.apply_overrides(list(overrides))


def copy_tree(tree):
    import numpy as np

    if isinstance(tree, dict):
        return {k: copy_tree(v) for k, v in tree.items()}
    return np.array(tree, copy=True)


def port_arm(cfg, g_tr, g_va, pos_weight: float, init=None):
    """The port's trajectory on ``cfg.compute.device``; returns (rows, the
    initial weights as numpy pytrees, launches)."""
    import numpy as np

    from gnnome_tpu_torch.config import resolve_device
    from gnnome_tpu_torch.models.convert import (load_model_pytrees,
                                                 pytrees_from_model)
    from gnnome_tpu_torch.models.features import edge_features
    from gnnome_tpu_torch.models.zoo import get_model
    from gnnome_tpu_torch.train.step import (eval_step, make_example,
                                             make_optimizer, train_step)
    from gnnome_tpu_torch.utils import record

    dev = resolve_device(cfg.compute.device)
    model = get_model(cfg.model)
    if init is None:
        model.init_weights(1)
    else:
        load_model_pytrees(model, *init)
    # copies: on the CPU the pytrees' arrays would share the parameters'
    # memory, which the port's Adam steps update in place
    init_trees = tuple(copy_tree(t) for t in pytrees_from_model(model))
    model.to(dev)
    opt = make_optimizer(model, cfg.train.lr)

    def example(g):
        return make_example(g.in_degrees(), g.out_degrees(),
                            edge_features(g, cfg.data.use_similarities), g.y,
                            g.src, g.dst, g.num_nodes, dev)

    ex_tr, ex_va = example(g_tr), example(g_va)
    rows = []
    start = record.launches()
    for ep in range(cfg.train.num_epochs):
        loss, _ = train_step(model, opt, ex_tr, pos_weight, cfg, None)
        va_loss, va_logits = eval_step(model, ex_va, pos_weight, cfg)
        row = {"epoch": ep, "train_loss": float(loss),
               "valid_loss": float(va_loss),
               **_metrics_row(va_logits.cpu().numpy(),
                              ex_va.labels_host.astype(np.int32))}
        rows.append(row)
        print(f"  port   {row}", flush=True)
    return rows, init_trees, record.launches_since(start)


def oracle_arm(cfg, g_tr, g_va, pos_weight: float, init_trees) -> list:
    """The torch oracle's trajectory on the CPU (the JAX script's torch
    arm), deterministic algorithms on for its duration."""
    import numpy as np
    import torch

    from torch_ref import RefSymGatedGCNModel

    from gnnome_tpu_torch.models.convert import module_state_from_numpy

    m = cfg.model
    was = torch.are_deterministic_algorithms_enabled()
    torch.manual_seed(0)
    torch.use_deterministic_algorithms(True)
    try:
        model = RefSymGatedGCNModel(
            node_features=m.node_features, edge_features=m.edge_features,
            hidden_features=m.dim_latent,
            hidden_ne_features=m.hidden_ne_features,
            num_layers=m.num_gnn_layers,
            hidden_edge_scores=m.hidden_edge_scores,
            normalization=m.normalization, dropout=0.0)
        model.load_state_dict(module_state_from_numpy(*init_trees,
                                                      m.normalization))
        opt = torch.optim.Adam(model.parameters(), lr=cfg.train.lr)
        pw = torch.tensor([pos_weight])
        alpha = cfg.train.alpha

        def tensors(g):
            x, x_rev, e = _features(g)
            return (torch.from_numpy(g.src.astype(np.int64)),
                    torch.from_numpy(g.dst.astype(np.int64)),
                    torch.from_numpy(x), torch.from_numpy(x_rev),
                    torch.from_numpy(e),
                    torch.from_numpy(g.y.astype(np.float32)).unsqueeze(1))

        def sym_loss(t):
            src, dst, x, x_rev, e, y = t
            lo = model(src, dst, x, e)
            lr = model.forward_flipped(src, dst, x_rev, e)
            bce = torch.nn.functional.binary_cross_entropy_with_logits
            loss = (bce(lo, y, pos_weight=pw, reduction="none")
                    + bce(lr, y, pos_weight=pw, reduction="none")
                    + alpha * torch.abs(lo - lr)).mean()
            return loss, lo

        tr, va = tensors(g_tr), tensors(g_va)
        rows = []
        for ep in range(cfg.train.num_epochs):
            model.train()
            opt.zero_grad()
            loss, _ = sym_loss(tr)
            loss.backward()
            opt.step()
            model.eval()
            with torch.no_grad():
                va_loss, va_logits = sym_loss(va)
            row = {"epoch": ep, "train_loss": float(loss.detach()),
                   "valid_loss": float(va_loss),
                   **_metrics_row(va_logits.numpy().reshape(-1),
                                  g_va.y.astype(np.int32))}
            rows.append(row)
            print(f"  oracle {row}", flush=True)
        return rows
    finally:
        torch.use_deterministic_algorithms(was)


def stage_parity(root: str, epochs: int, device: str, init=None,
                 overrides=()) -> dict:
    """Identical initial weights, identical data, deterministic full-graph
    training in the port and in the oracle; both trajectories."""
    from gnnome_tpu_torch.config import resolve_device
    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.utils import record

    g_tr = AssemblyGraph.load(
        os.path.join(root, "train", "hifiasm", "processed", "0.npz"))
    g_va = AssemblyGraph.load(
        os.path.join(root, "valid", "hifiasm", "processed", "0.npz"))
    pos = float((g_tr.y == 1).sum())
    neg = float((g_tr.y == 0).sum())
    pos_weight = neg / pos
    cfg = parity_cfg(device, overrides)
    cfg.train.num_epochs = epochs
    dev = resolve_device(cfg.compute.device)
    record.reset_peak(dev)
    port_rows, init_trees, launched = port_arm(cfg, g_tr, g_va, pos_weight,
                                               init)
    peak = record.peak_mb(dev)
    oracle_rows = oracle_arm(cfg, g_tr, g_va, pos_weight, init_trees)
    pairs = list(zip(port_rows, oracle_rows))
    return {"protocol": ("identical init ("
                         + ("init_weights(1)" if init is None else
                            "caller's numpy pytrees")
                         + "), full-graph symmetry loss, Adam 1e-4, dropout "
                         f"0, pos_weight {pos_weight:.4f}, {epochs} epochs; "
                         f"port on {dev} (float32, TF32 off), oracle on the "
                         "CPU with deterministic algorithms"),
            "graphs": {"train": [g_tr.num_nodes, g_tr.num_edges],
                       "valid": [g_va.num_nodes, g_va.num_edges]},
            **record.device_record(dev),
            "peak_mb": peak, "launches": launched,
            "port": port_rows, "torch_oracle": oracle_rows,
            "divergence": {
                "max_abs_valid_loss_diff": max(
                    abs(a["valid_loss"] - b["valid_loss"]) for a, b in pairs),
                "max_abs_train_loss_diff": max(
                    abs(a["train_loss"] - b["train_loss"]) for a, b in pairs),
                "max_abs_valid_ap_diff": max(
                    abs(a["ap"] - b["ap"]) for a, b in pairs)}}


# --------------------------------------------------------------- golden arm
def stage_golden(model_path: str, device: str, save_weights: str | None,
                 fixture: str = GOLDEN_FIXTURE, overrides=()) -> dict:
    import numpy as np

    from gnnome_tpu_torch.config import Config, resolve_device
    from gnnome_tpu_torch.graphs.container import AssemblyGraph
    from gnnome_tpu_torch.infer import score_graph
    from gnnome_tpu_torch.models.checkpoint import load_model_weights
    from gnnome_tpu_torch.train.metrics import average_precision
    from gnnome_tpu_torch.utils import record
    from torch_golden_ecoli_run import decode_summary

    model_path = os.path.join(ROOT, model_path)   # as is when absolute
    g = AssemblyGraph.load(fixture)
    y = g.y.astype(np.int32)
    cfg = Config()
    cfg.compute.device = device
    cfg.apply_overrides(list(overrides))
    dev = resolve_device(cfg.compute.device)
    out = {"fixture": rel(fixture),
           "graph": {"nodes": g.num_nodes, "edges": g.num_edges,
                     "positives": int(y.sum())},
           "jax_golden_ap_shipped": JAX_GOLDEN_AP,
           **record.device_record(dev), "models": {}}
    record.reset_peak(dev)
    start = record.launches()
    weights = {"self_trained": model_path, **GOLDEN_WEIGHTS}
    decode = {}
    for name, path in weights.items():
        t0 = time.perf_counter()
        s = score_graph(g, *load_model_weights(path), cfg)
        score_s = time.perf_counter() - t0
        ap = float(average_precision(1.0 / (1.0 + np.exp(-s.astype(
            np.float64))), y))
        decode[name] = decode_summary(g, s, ECOLI_BP, 7)
        out["models"][name] = {"weights": rel(path),
                               "ap": ap, "score_s": score_s,
                               "decode": decode[name]}
        print(f"  AP[{name}] = {ap:.7f}  decode {decode[name]}", flush=True)
    out["launches"] = record.launches_since(start)
    out["peak_mb"] = record.peak_mb(dev)
    out["decode_labels"] = decode_summary(g, y.astype(np.float32), ECOLI_BP,
                                          7, use_labels=True)
    out["ap_gap_shipped_minus_self_trained"] = (
        out["models"]["shipped"]["ap"] - out["models"]["self_trained"]["ap"])
    out["self_trained_at_or_above_jax_golden_ap"] = (
        out["models"]["self_trained"]["ap"] >= JAX_GOLDEN_AP)
    if save_weights:
        os.makedirs(os.path.dirname(os.path.abspath(save_weights)),
                    exist_ok=True)
        shutil.copyfile(model_path, save_weights)
        out["self_trained_weights_artifact"] = rel(save_weights)
    return out


STAGES = ("build", "train", "parity", "golden")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stage", nargs="+", default=["all"],
                    choices=[*STAGES, "all"])
    ap.add_argument("--root", default=os.path.join(ROOT, "build",
                                                   "train_quality_torch"),
                    help="the dataset, checkpoints and models")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--resume", action="store_true",
                    help="train stage: continue from the checkpoint")
    ap.add_argument("--parity-epochs", type=int, default=8)
    ap.add_argument("--model", default=None,
                    help="golden stage: the self-trained model npz")
    ap.add_argument("--spec", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="build stage: a TRAIN_SPEC entry to change")
    ap.add_argument("--train-seeds", type=int, nargs="+", default=TRAIN_SEEDS)
    ap.add_argument("--valid-seeds", type=int, nargs="+", default=VALID_SEEDS)
    ap.add_argument("--save-weights", default=os.path.join(
        ROOT, "weights", "self_trained_torch.npz"))
    ap.add_argument("--out", default=OUT_JSON)
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="SECTION.KEY=VALUE",
                    help="config override of the train and parity stages")
    args = ap.parse_args(argv)

    from gnnome_tpu_torch.utils import record

    spec = None
    if args.spec:
        spec = dict(TRAIN_SPEC)
        for kv in args.spec:
            k, _, v = kv.partition("=")
            if k not in spec:
                ap.error(f"--spec {kv}: not a TRAIN_SPEC key {sorted(spec)}")
            spec[k] = type(spec[k])(v)
    os.makedirs(args.root, exist_ok=True)
    out = record.read_json(args.out)
    stages = STAGES if "all" in args.stage else [
        s for s in STAGES if s in args.stage]
    for st in stages:
        print(f"==== stage {st} ====", flush=True)
        t0 = time.perf_counter()
        if st == "build":
            out["dataset"] = stage_build(args.root, args.train_seeds,
                                         args.valid_seeds, spec)
        elif st == "train":
            res = stage_train(args.root, args.epochs, args.device,
                              args.resume, args.overrides)
            runs = out.get("training", {}).get("runs", []) if args.resume \
                else []
            runs.append({k: res[k] for k in (
                "epochs", "resumed", "total_wall_s", "peak_mb",
                "kernel_builds", "device") if k in res})
            res["runs"] = runs
            out["training"] = res
        elif st == "parity":
            out["collapse_parity"] = stage_parity(
                args.root, args.parity_epochs, args.device,
                overrides=args.overrides)
        elif st == "golden":
            mp = args.model or (out.get("training") or {}).get("model_path")
            if not mp:
                ap.error("golden stage: no trained model (run the train "
                         "stage first or pass --model)")
            out["golden_heldout"] = stage_golden(mp, args.device,
                                                 args.save_weights)
        print(f"==== stage {st} done in {time.perf_counter() - t0:.0f}s "
              "====", flush=True)
        out["complete"] = all(k in out for k in (
            "dataset", "training", "collapse_parity", "golden_heldout"))
        record.write_json(args.out, out)
    print(f"wrote {args.out}", flush=True)
    return out


if __name__ == "__main__":
    main()
