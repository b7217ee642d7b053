"""The numbers the check of ``correct`` compares, each against its limit.

Training (the first steps of the run's own training object against the
plain reference's from the same weights, graph and dropout masks):

* ``loss_gap``: the largest relative gap between the program's and the
  reference's loss over the checked steps;
* ``grad_gap``: the worst tensor's gap between the norms of the first
  step's gradient (the program's worked out from Adam's first moment after
  one step), over the larger of that tensor's reference norm and the
  median tensor's;
* ``change_gap``: the same for the norm of the parameters' change over the
  checked steps, over the tensors whose reference gradient is at least a
  thousandth of the median tensor's (below that a tensor moves under Adam
  by round-off alone: a bias in front of a BatchNorm).

Scoring: ``logit_gap``, the largest gap between a served logit and the
reference's, over the root mean square of the reference's logits of that
graph, worst over the graphs of the mix.
"""
from __future__ import annotations

import math
import statistics

SMALL_GRAD = 1e-3


def _worst_norm_gap(prog: dict, ref: dict, names) -> float:
    names = list(names)
    if not names:
        return 0.0
    med = statistics.median(ref[k] for k in names)
    worst = 0.0
    for k in names:
        den = max(ref[k], med)
        p = prog.get(k, math.nan)        # a tensor the program lacks fails
        gap = abs(p - ref[k]) / den if den > 0 else (
            0.0 if p == ref[k] else math.inf)
        worst = max(worst, gap) if math.isfinite(gap) else math.inf
    return worst


def train_gaps(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: ``losses`` [steps], ``grad1`` and ``change``
    {tensor: norm}."""
    gaps = [abs(p - r) / abs(r) if r else abs(p)
            for p, r in zip(prog["losses"], ref["losses"])]
    loss_gap = (max(gaps) if len(prog["losses"]) == len(ref["losses"])
                and all(math.isfinite(g) for g in gaps) else math.inf)
    g_med = statistics.median(ref["grad1"].values())
    moving = [k for k, g in ref["grad1"].items() if g >= SMALL_GRAD * g_med]
    return {"loss_gap": loss_gap,
            "grad_gap": _worst_norm_gap(prog["grad1"], ref["grad1"],
                                        ref["grad1"]),
            "change_gap": _worst_norm_gap(prog["change"], ref["change"],
                                          moving)}


def logit_gap(prog, ref) -> float:
    """One graph's ``logit_gap`` (torch tensors of the same length)."""
    if prog.shape != ref.shape:
        return math.inf
    ref = ref.double()
    diff = (prog.double() - ref).abs().max()
    rms = ref.square().mean().sqrt()
    out = float(diff / rms) if float(rms) > 0 else float(diff)
    return out if math.isfinite(out) else math.inf


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: correct when every
    reading is at most its limit; a name without a limit fails."""
    checks, ok = {}, True
    for name, value in readings.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not value <= limit:
            ok = False
    missing = set(limits) - set(readings)
    for name in sorted(missing):
        checks[name] = {"value": None, "limit": limits[name]}
        ok = False
    return ok, checks
