"""What the per-layer metric files (``benchmarks/metrics/<name>.py``)
share: a kernel's roofline share, the whole step's or request's share of
the float32 peak, the device's idle share and the launches per unit.

Each returns None where it finds nothing to read (no device trace, no
kernel of the pattern), and the harness then leaves the metric out."""
from __future__ import annotations

from .costs import F32_FLOPS_PER_S, bound_seconds


def roofline(ctx, pattern: str, least_seconds_per_unit) -> float | None:
    """100 x the least time of the traced units' work for one kernel
    (``least_seconds_per_unit(nodes, edges)``) over the device time of
    the kernels whose name matches ``pattern``."""
    tr = ctx.device_trace()
    if tr is None:
        return None
    seconds, launches = tr.kernel_seconds(pattern)
    if not launches or seconds <= 0:
        return None
    least = sum(least_seconds_per_unit(n, e) for n, e in ctx.traced_units)
    return 100.0 * least / seconds


def calls(count: int, cost) -> float:
    """The least seconds of ``count`` calls of one kernel of cost ``cost``
    (``(bytes, flops, flops64)``)."""
    return count * bound_seconds(*cost)


def mfu(ctx, flops_per_unit) -> float | None:
    """100 x the matrix-product operations of the window's units over the
    window's seconds and the float32 peak; from the unprofiled window, so
    only a run on the card reads it."""
    if ctx.device_trace() is None or ctx.window["seconds"] <= 0:
        return None
    flops = sum(flops_per_unit(ctx.config, n, e) for n, e in
                ctx.window["units"])
    return 100.0 * flops / ctx.window["seconds"] / F32_FLOPS_PER_S


def idle_share(ctx) -> float | None:
    """100 x (1 - device busy / the traced segment's length)."""
    tr = ctx.device_trace()
    if tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def launches_per_unit(ctx) -> float | None:
    """Device operations (kernels, copies, fills) per traced step or
    request."""
    tr = ctx.device_trace()
    if tr is None or not ctx.traced_units:
        return None
    return tr.launches / len(ctx.traced_units)
