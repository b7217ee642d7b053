"""What a recorded run writes beside its results: the device it ran on
(for a card, its name and power limit as ``nvidia-smi`` reports them), its
peak device memory, its kernel launches and whether it built the kernel
library; and a JSON writer whose file always parses.

Used by the recorded-run scripts (``scripts/torch_*_run.py``,
``scripts/torch_config4_route.py``).  Nothing here imports the CUDA
toolkit; a CPU run records ``None`` where a card number would stand.
"""
from __future__ import annotations

import json
import os
import subprocess


def nvidia_smi() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


def device_record(device) -> dict:
    """The device a run used: for a card its name, ``nvidia-smi``'s name
    and power limit, and the torch and CUDA versions."""
    import torch

    device = torch.device(device)
    rec = {"device": str(device), "torch": torch.__version__}
    if device.type == "cuda":
        rec.update(platform="gpu",
                   kind=torch.cuda.get_device_name(device),
                   nvidia_smi=nvidia_smi(), cuda=torch.version.cuda)
    else:
        rec.update(platform="cpu", kind=None, nvidia_smi=None, cuda=None)
    return rec


def reset_peak(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_mb(device) -> float | None:
    """``torch.cuda.max_memory_allocated`` in MB (2^20 bytes) since the
    last ``reset_peak``; ``None`` on the CPU."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 20


def launches() -> dict:
    """Every kernel's launches so far in this process, all and bfloat16."""
    import torch

    from ..ops.kernels import launch_counts

    return {"all": launch_counts(), "bfloat16": launch_counts(torch.bfloat16)}


def launches_since(start: dict) -> dict:
    """The launches made since ``start``, an earlier ``launches()``."""
    now = launches()
    return {k: {name: n - start[k][name] for name, n in now[k].items()}
            for k in now}


def unit_launches(layers: int = 8) -> tuple[dict, dict]:
    """The batch-norm SymGatedGCN's launches for one unit of the symmetry
    loss, ``(train step, eval step)``: a train step runs one dual-width
    pass (a K7 and a K3 per layer, one K6) and its backward (a K8 and a
    batch-norm edge adjoint per layer, one K9), an eval step one
    dual-width pass."""
    return ({"k7_gate_stats": layers, "k3_edge_stage": layers,
             "k8_train_layer_bwd": layers, "bn_edge_adjoint": layers,
             "k6_score_gate": 1, "k9_aggregate": 1},
            {"k3_edge_stage": layers, "k6_score_gate": 1})


def expected_launches(train_units: int, eval_units: int = 0,
                      passes: int = 1, layers: int = 8) -> dict:
    """Every kernel's launches for ``train_units`` train steps and
    ``eval_units`` eval steps of the batch-norm model of ``layers``
    layers, each pass run ``passes`` times (2 per rank on the halo path,
    whose ranks run the two symmetry passes one after the other); every
    other kernel none."""
    from ..ops.kernels import KERNELS

    train, ev = unit_launches(layers)
    return {k: passes * (train.get(k, 0) * train_units
                         + ev.get(k, 0) * eval_units)
            for k in KERNELS}


def kernel_builds() -> int:
    """How many times this process built the kernel library (0 when it
    found one up to date, or ran on the CPU)."""
    from ..ops.kernels import LIB_PATH, build_library

    return build_library.builds.get(LIB_PATH, 0)


def write_json(path: str, obj) -> None:
    """Write ``obj`` to ``path`` through a temporary file, so the file is
    whole whenever a reader opens it."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, default=float)
        f.write("\n")
    os.replace(tmp, path)


def read_json(path: str) -> dict:
    """``path``'s object, or ``{}`` when the file does not exist."""
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)
