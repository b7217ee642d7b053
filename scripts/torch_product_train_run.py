#!/usr/bin/env python
"""The recorded multi-epoch product-surface training run of the port
(the counterpart of ``scripts/product_train_run.py``).

Drives ``gnnome_tpu_torch.train.loop.train``, the path ``cli train``
takes, over a multi-graph masked and clustered dataset with the reference
protocol (per-epoch shuffle, strandwise masking, clusters of 1,000 nodes,
symmetry loss, plateau scheduler, a checkpoint per epoch), and records:

* each epoch's metrics, wall time and units from the loop's JSONL log, and
  its kernel launches (``kernel_launches``; ``halo_launches`` per rank at
  ``--mesh``), held against units x 8/8/8/8/1/1 K7/K3/K8/edge
  adjoint/K6/K9 per training unit plus 0/8/0/0/1/0 per validation unit
  (twice that per rank on the halo path, whose ranks run the two symmetry
  passes one after the other);
* the resume gate: the same checkpoint continued twice for one epoch, every
  array of the two resumed checkpoints compared bitwise
  (``resume_bit_identical``), and a run of ``epochs + 1`` never
  interrupted against the resumed one (``resume_equals_uninterrupted``:
  the port writes its checkpoint after the scheduler step and stores every
  RNG state, so a resume continues the uninterrupted run exactly);
* the card's name and power limit (``nvidia-smi``), peak device memory
  (``peak_mb``) and whether the kernel library was built in this process
  (``kernel_builds``).  The port compiles nothing per shape, so there is
  no compile count (the JAX script counts XLA compiles).

Modes:
  cpu        the three-graph dataset (600, 900 and 1,400 reads, straddling
             the 1,000-node cluster threshold) on the CPU (the kernels'
             plain versions), 3 epochs; for tests.
  card       the same dataset on ``--device`` (default ``cuda``), 3 epochs.
  card-full  one ``positional_bench_assembly_graph(786,432)`` graph
             (about 3.6M edges) and a held-out graph of 131,072 nodes,
             ``compute.dtype=bfloat16``, masking and clusters off, 2
             epochs.
``--mesh P`` runs the dataset through the halo path (``compute.mesh=P``);
on one card its ranks share it over gloo, and the output says so.  The
JAX script's ``cpu-mesh`` mode is ``--mode cpu --mesh 8``.

The JAX script's settings the port does not have: ``compute.remat='full'``
(card-full) is dropped (the port's training edge stage keeps only small
residuals; the step fits the card without it), ``compute.bucket_growth``
is dropped (no shape buckets), ``compute.backend`` is dropped (the
tensor's device chooses kernel or plain version).  The port sets
``compute.dtype`` and ``compute.device`` (and ``compute.mesh`` with
``--mesh``), nothing else of ``compute``.

Writes ``TRAIN_RUN_torch_<mode>.json`` (``..._<mode>-mesh<P>.json`` with
``--mesh``) at the repository root, or ``--out``.

    python scripts/torch_product_train_run.py --mode card
    python scripts/torch_product_train_run.py --mode card-full
    python scripts/torch_product_train_run.py --mode cpu --epochs 1 \\
        --set model.num_gnn_layers=2 --set model.dim_latent=16
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SEED = 20260820
# (reads, genome length) of the three graphs of the cpu and card modes
SPECS = [(600, 60_000), (900, 90_000), (1400, 140_000)]
FULL_NODES, FULL_VALID_NODES = 786_432, 131_072
RUN_NAME = "torch"

def build_dataset(root: str, mode: str, seed: int = SEED) -> None:
    """The multi-graph training dataset in the on-disk layout (the JAX
    script's ``build_dataset``, the same graphs from the same seeds)."""
    import numpy as np

    from gnnome_tpu_torch.graphs.synthetic import (
        positional_bench_assembly_graph, synthetic_assembly_graph)

    pdir = os.path.join(root, "hifiasm", "processed")
    os.makedirs(pdir, exist_ok=True)
    os.makedirs(os.path.join(root, "hifiasm", "info"), exist_ok=True)
    have_train = os.path.isfile(os.path.join(pdir, "0.npz"))
    have_valid = os.path.isdir(os.path.join(root, "valid"))
    if have_train and (mode != "card-full" or have_valid):
        return
    if mode == "card-full":
        positional_bench_assembly_graph(FULL_NODES, seed).save(
            os.path.join(pdir, "0.npz"))
        vdir = os.path.join(root, "valid", "hifiasm", "processed")
        os.makedirs(vdir, exist_ok=True)
        positional_bench_assembly_graph(FULL_VALID_NODES, seed + 1).save(
            os.path.join(vdir, "0.npz"))
        return
    for i, (n_reads, genome) in enumerate(SPECS):
        g, _, _, _ = synthetic_assembly_graph(
            n_reads=n_reads, genome_len=genome, read_len=900,
            seed=seed + i, with_sequences=False, false_edge_frac=0.15)
        g.overlap_similarity = np.random.default_rng(seed + i).uniform(
            0.95, 1.0, g.num_edges).astype(np.float32)
        g.save(os.path.join(pdir, f"{i}.npz"))


def make_cfg(root: str, mode: str, epochs: int, device: str, mesh: int,
             overrides=()):
    from gnnome_tpu_torch.config import Config

    cfg = Config()
    cfg.paths.models_path = os.path.join(root, "models")
    cfg.paths.checkpoints_path = os.path.join(root, "checkpoints")
    cfg.train.num_epochs = epochs
    cfg.train.seed = 1
    cfg.compute.device = device
    if mode == "card-full":
        cfg.compute.dtype = "bfloat16"
        cfg.train.masking = False          # a full-graph unit each epoch
        cfg.train.num_nodes_per_cluster = 10 ** 9
    else:
        cfg.train.masking = True
        cfg.train.num_nodes_per_cluster = 1000   # reference default
    cfg.compute.mesh = mesh
    return cfg.apply_overrides(list(overrides))


def run_training(root: str, cfg, resume: bool, name: str = RUN_NAME) -> str:
    """``train`` on the dataset, validating on ``root/valid`` where it
    exists (card-full's held-out graph), else on the training graphs."""
    from gnnome_tpu_torch.train.loop import train

    valid = os.path.join(root, "valid")
    return train(root, valid if os.path.isdir(valid) else root, "hifiasm",
                 out_name=name, overfit=False, resume=resume, cfg=cfg)


def read_log(ck: str, name: str = RUN_NAME) -> list[dict]:
    with open(os.path.join(ck, f"log_{name}_seed1.jsonl")) as f:
        return [json.loads(line) for line in f]


def load_arrays(path: str) -> dict:
    import numpy as np

    with np.load(path) as z:
        return {k: z[k].copy() for k in z.files}


def same_arrays(a: dict, b: dict) -> bool:
    import numpy as np

    return sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k])
                                          for k in a)


def epoch_launches(row: dict) -> dict:
    """One epoch's launches by kernel (rank 0's at ``--mesh``)."""
    return (row["halo_launches"][0] if "halo_launches" in row
            else row["kernel_launches"]["all"])


def resume_gate(root: str, cfg, epochs: int) -> dict:
    """Continue the ``epochs``-epoch checkpoint twice for one epoch and
    compare every array of the two resumed checkpoints; then run
    ``epochs + 1`` epochs uninterrupted and compare its checkpoint with
    the resumed one."""
    ck, models = cfg.paths.checkpoints_path, cfg.paths.models_path
    cfg.train.num_epochs = epochs + 1
    finals, walls = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        run_training(root, cfg, resume=True)
        walls.append(time.perf_counter() - t0)
        finals.append(load_arrays(os.path.join(
            ck, f"ckpt_{RUN_NAME}_seed1_resumed-{epochs + 1}.npz")))
        for d in (ck, models):          # the second continuation starts clean
            for f in os.listdir(d):
                if "resumed" in f:
                    os.remove(os.path.join(d, f))
    t0 = time.perf_counter()
    run_training(root, cfg, resume=False, name=f"{RUN_NAME}_whole")
    wall_whole = time.perf_counter() - t0
    whole = load_arrays(os.path.join(ck, f"ckpt_{RUN_NAME}_whole_seed1.npz"))
    return {"resume_bit_identical": same_arrays(*finals),
            "resume_equals_uninterrupted": same_arrays(finals[0], whole),
            "checkpoint_arrays": len(whole),
            "resume_wall_s": walls, "uninterrupted_wall_s": wall_whole,
            "uninterrupted_epochs": epochs + 1}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="card",
                    choices=["cpu", "card", "card-full"])
    ap.add_argument("--epochs", type=int, default=None,
                    help="default 3 (cpu, card) or 2 (card-full)")
    ap.add_argument("--device", default=None,
                    help="default cuda (cpu with --mode cpu)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="ranks of the halo path (compute.mesh)")
    ap.add_argument("--root", default="",
                    help="dataset root (default: a new temp dir)")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="SECTION.KEY=VALUE",
                    help="config override, as cli train's --set")
    args = ap.parse_args(argv)

    import torch

    from gnnome_tpu_torch.config import resolve_device
    from gnnome_tpu_torch.utils import record

    if args.mode == "cpu" and args.device not in (None, "cpu"):
        ap.error("--mode cpu runs on the CPU; use --mode card for a card")
    device = args.device or ("cpu" if args.mode == "cpu" else "cuda")
    dev = resolve_device(device)
    epochs = args.epochs or (2 if args.mode == "card-full" else 3)
    tag = args.mode + (f"-mesh{args.mesh}" if args.mesh > 1 else "")
    out_path = args.out or os.path.join(ROOT, f"TRAIN_RUN_torch_{tag}.json")
    root = args.root or tempfile.mkdtemp(prefix=f"train_run_torch_{tag}_")
    print(f"dataset root: {root}", flush=True)
    t0 = time.perf_counter()
    build_dataset(root, args.mode)
    build_s = time.perf_counter() - t0

    cfg = make_cfg(root, args.mode, epochs, device, args.mesh, args.overrides)
    record.reset_peak(dev)
    t0 = time.perf_counter()
    run_training(root, cfg, resume=False)
    wall = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    # at --mesh the ranks, not this process, hold the device memory
    peak = record.peak_mb(dev) if args.mesh <= 1 else None
    rows = read_log(cfg.paths.checkpoints_path)
    per_epoch = [{"epoch": r["epoch"], "train_units": r["train/units"],
                  "valid_units": r["valid/units"],
                  "launches": epoch_launches(r),
                  "expected": record.expected_launches(
                      r["train/units"], r["valid/units"],
                      2 if args.mesh > 1 else 1, cfg.model.num_gnn_layers)}
                 for r in rows]
    gate = resume_gate(root, cfg, epochs)

    on_card = dev.type == "cuda"
    out = {
        "mode": args.mode, "epochs": epochs, "mesh": args.mesh,
        "transport": ("shared card, gloo" if on_card and args.mesh > 1
                      else "gloo, CPU ranks" if args.mesh > 1 else None),
        **record.device_record(dev),
        "config": {"compute.dtype": cfg.compute.dtype,
                   "train.masking": cfg.train.masking,
                   "train.num_nodes_per_cluster":
                       cfg.train.num_nodes_per_cluster,
                   "overrides": args.overrides},
        "dataset_build_s": build_s,
        "total_wall_s": wall,
        "peak_mb": peak,        # not measured at --mesh
        "kernel_builds": record.kernel_builds(),
        "launches_per_epoch": per_epoch,
        "launches_match_units": (all(e["launches"] == e["expected"]
                                     for e in per_epoch)
                                 if on_card else None),
        "epoch_metrics": rows,
        **gate,
        "dataset_root": root if args.keep else "(removed)",
    }
    record.write_json(out_path, out)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("epoch_metrics", "launches_per_epoch")},
                     default=float), flush=True)
    print(f"wrote {out_path}", flush=True)
    if not args.keep and not args.root:
        shutil.rmtree(root, ignore_errors=True)
    return out


if __name__ == "__main__":
    main()
