#!/usr/bin/env python3
"""The port on the card in one command: its card suite, the launches of
its main paths, and every kernel timed alone.

    python3 chip_smoke.py [--seed N]

1. The card suite, ``python3 -m pytest --noconftest -p no:cacheprovider
   tests/test_torch_cuda*.py``, in a process of its own: every card check
   of the port (each kernel against its plain version, the model, train
   step, CLI, recorded-run and parallel paths against the CPU and against
   one device; the files' docstrings list them).
2. The main paths, the launch counters set to 0 just before each: ``cli
   train --overfit`` of the overfit recipe (tests/torch_recipes.py: 12
   epochs, which must learn) with the batch-norm model in float32
   (``train``) and bf16 (``train_bf16``), the layer-norm model in float32
   (``train_layer``) and the norm-free one in bf16 (``train_none_bf16``);
   and ``cli train`` for 2 epochs on the same dataset of the GAT
   (``train_gat``) and of the Graph Transformer (``train_gt``).
3. Every kernel row of scripts/torch_kernel_times.py, timed alone beside
   its bound.

Then one JSON line ``{"kernels": rows}``: each timing row with
``launches``, the kernel's launches at the row's dtype on its main path
(the first path of ``PATHS`` that launches it at that dtype), ``path``,
that path's name, and ``launches_by_path``, every path's; and the last
line ``{"ok": ..., "suite_rc": ..., "device": ...}``.  Exits non-zero when
the suite fails, a path fails or a kernel of the table launches on no
main path; without a CUDA device at once.
"""
from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

# the main paths in the order that picks a kernel's main path:
# (name, model.model, normalization, compute.dtype)
PATHS = [("train", "sym_gatedgcn", "batch", "float32"),
         ("train_layer", "sym_gatedgcn", "layer", "float32"),
         ("train_gat", "gat", "batch", "float32"),
         ("train_gt", "graph_transformer", "batch", "float32"),
         ("train_bf16", "sym_gatedgcn", "batch", "bfloat16"),
         ("train_none_bf16", "sym_gatedgcn", "none", "bfloat16")]


def run_suite() -> int:
    """The card suite's exit code."""
    files = sorted(glob.glob(os.path.join(ROOT, "tests",
                                          "test_torch_cuda*.py")))
    return subprocess.run([sys.executable, "-m", "pytest", "--noconftest",
                           "-p", "no:cacheprovider", "-q", *files],
                          cwd=ROOT).returncode


def path_launches(root: str, model: str, norm: str, dtype: str):
    """The launches of one main path, run under ``root``:
    ``{dtype: counts}``."""
    import torch

    from gnnome_tpu_torch import cli
    from gnnome_tpu_torch.graphs import synthetic_assembly_graph
    from gnnome_tpu_torch.ops import kernels as K
    from torch_recipes import OVERFIT_GRAPH, overfit_run, write_dataset

    if model == "sym_gatedgcn":
        _, (every, bf16) = overfit_run(root, norm, dtype)
    else:
        g, reads, _, _ = synthetic_assembly_graph(**OVERFIT_GRAPH)
        small = write_dataset(os.path.join(root, "small"), g, reads)
        K.reset_launch_counts()
        cli.main(["train", "--train", small, "--valid", small, "--asm",
                  "hifiasm", "--name", model, "--set", f"model.model={model}",
                  "--set", "train.num_epochs=2",
                  "--set", f"paths.checkpoints_path={root}/ckpt",
                  "--set", f"paths.models_path={root}/models"])
        every, bf16 = K.launch_counts(), K.launch_counts(torch.bfloat16)
    return {"float32": {k: n - bf16[k] for k, n in every.items()},
            "bfloat16": bf16}


def timing_script():
    spec = importlib.util.spec_from_file_location(
        "torch_kernel_times",
        os.path.join(ROOT, "scripts", "torch_kernel_times.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    suite_rc = run_suite()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, model, norm, dtype in PATHS:
            launches[name] = path_launches(os.path.join(tmp, name), model,
                                           norm, dtype)
    times = timing_script()
    rows, missing = [], set()
    for row in times.measure(args.seed):
        by_path = {p: c[row["dtype"]][row["kernel"]]
                   for p, c in launches.items()}
        main_path = next((p for p, n in by_path.items() if n), None)
        if main_path is None:
            missing.add((row["kernel"], row["dtype"]))
        rows.append({**row, "launches": by_path.get(main_path, 0),
                     "path": main_path, "launches_by_path": by_path})
    print(json.dumps({"kernels": rows}), flush=True)
    ok = suite_rc == 0 and not missing
    print(json.dumps({"ok": ok, "suite_rc": suite_rc,
                      "on_no_path": sorted(missing), **times.card()}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
