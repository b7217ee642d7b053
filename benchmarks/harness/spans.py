"""What the program's own spans say (``gnnome_tpu_torch.utils.timing``):
the per-layer metrics that time a part of each traced step or request
from inside the program.  The program keeps spans exactly while
``torch.profiler`` runs on an initialised CUDA device, so what it holds
when the metrics are read is the traced segment's.

Each function returns None where it finds nothing to read, and the
harness then leaves the metric out: no device trace (so a CPU run never
writes a device number), a program without the recorder, no span of the
name, or a segment whose spans are not one root span per traced unit."""
from __future__ import annotations

_SEEN: list = [None, None]   # [the trace read last, its spans]


def records(ctx) -> list | None:
    """The spans of ``ctx``'s traced segment: taken from the program's
    recorder (which is then emptied) at the first read of a segment."""
    tr = ctx.device_trace()
    if tr is None:
        return None
    if _SEEN[0] is not tr:
        try:
            from gnnome_tpu_torch.utils import timing
            recs = timing.spans()
            timing.clear()
        except (ImportError, AttributeError):
            recs = None
        _SEEN[:] = [tr, recs]
    return _SEEN[1]


def per_unit_ms(ctx, name: str, recs: list | None = None) -> float | None:
    """The summed device time of the spans named ``name`` over the traced
    units (steps or requests); ``recs`` the spans (else
    ``records(ctx)``)."""
    if ctx.device_trace() is None or not ctx.traced_units:
        return None
    recs = records(ctx) if recs is None else recs
    if not recs:
        return None
    if sum(r["root"] for r in recs) != len(ctx.traced_units):
        return None
    vals = [r["device_ms"] for r in recs if r["name"] == name]
    if not vals:
        return None
    return sum(vals) / len(ctx.traced_units)
