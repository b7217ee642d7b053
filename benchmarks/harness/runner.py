"""One run of one cell: set-up, the measured window, on ``--trace 1`` a
traced segment, the check of ``correct``, and the result line.

Order matters: the window closes and the modules loaded are checked for
JAX; the traced segment (if any) follows; the device memory peak is read;
only then does the driver free the program's state and run the plain
reference, so the reference never sets the peak.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass

from . import compare, manifest, profile
from .device import device_record, nvidia_smi, peak_bytes, reset_peak

FORBIDDEN = ("jax", "jaxlib", "flax", "gnnome_tpu")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``gnnome_tpu_torch`` is not
    ``gnnome_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class ForbiddenModules(RuntimeError):
    pass


@dataclass
class LayerContext:
    """What a per-layer metric's reader reads: the cell's configuration
    and traffic, the measured window (``seconds``; ``units``, one
    ``(nodes, edges)`` per step or request), and the traced segment's
    units and ``profile.Trace`` (None in a run with no device trace)."""
    config: dict
    traffic: dict
    kind: str
    window: dict
    traced_units: list
    trace: object

    def device_trace(self):
        """The trace if it saw the device at work, else None."""
        if self.trace is None or self.trace.busy_s <= 0:
            return None
        return self.trace


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float | None = None,
             traffic_override: dict | None = None) -> dict:
    """The result object of one run (``checks`` its last key); tests pass
    ``traffic_override`` to run a cell at a tiny size on the CPU."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = manifest.cell(name)
    config = cell.config
    traffic = {**cell.traffic, **(traffic_override or {})}
    drv = manifest.load_module("drivers", traffic["driver"] + ".py").Driver(
        config, traffic, seed, device)
    reset_peak(device)
    drv.setup()
    setup_s = time.perf_counter() - t0
    win = drv.window(seconds)
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(f"loaded after the window: {bad}")
    tr, traced_units = None, []
    if trace:
        traced_units, tr = profile.traced(drv.traced, device)
    peak = peak_bytes(device)
    correct, checks = compare.verdict(drv.check(), cell.limits)

    metrics = {}
    if not trace:
        values = dict(win["metrics"], setup_s=setup_s,
                      peak_mem_gib=peak / 2 ** 30)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = LayerContext(config, traffic, drv.kind, win, traced_units, tr)
        for m in cell.per_layer:
            value = manifest.load_module("metrics", m["name"] + ".py").read(
                ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = device_record(device, cell.chips, peak)
    result = {"correct": correct, "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops,
                               "idle_gaps": tr.idle_gaps}
    result["window"] = {"seconds": win["seconds"], "units": len(win["units"]),
                        "setup_s": setup_s, **drv.setup_split,
                        **{k: v for k, v in win.items() if k.startswith(
                            "latency")}}
    if dev["platform"] == "gpu":
        result["card"] = nvidia_smi()
    result["checks"] = checks
    return result
