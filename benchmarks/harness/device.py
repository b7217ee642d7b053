"""The card a run used: a frozen copy of the port's ``utils/record.py``
``nvidia_smi`` (the card's name and power limit) and the run's ``device``
record."""
from __future__ import annotations

import subprocess


def nvidia_smi() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    of the first card, or what went wrong."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.splitlines()[0] if out else ""


def device_record(device, chips: int, peak_bytes: int) -> dict:
    """The contract's ``device`` object of a run on ``device``."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": chips, "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


def reset_peak(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    """``torch.cuda.max_memory_allocated`` since the last ``reset_peak``;
    0 on the CPU, which has no such counter."""
    import torch

    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
