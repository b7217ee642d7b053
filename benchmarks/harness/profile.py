"""The traced segment: ``torch.profiler`` over a fixed stretch of the
cell's work, reduced to the device's busy time, each kernel name's device
time and count, and the breakdown the result line carries (the device
operations that took most time; the idle gaps, summed by the host
operation that was running when each began).

The arithmetic is that of the port's ``scripts/torch_train_profile.py``
(device time from the profiler's CUDA events, user annotations left out),
taken over each event's own interval so that overlapping events are
counted once in the busy time.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

TOP = 10


@dataclass
class Trace:
    """A traced segment: ``window_s`` its host-clock length, ``busy_s`` the
    union of device intervals, ``kernels`` name -> [seconds, count]."""
    window_s: float
    busy_s: float
    kernels: dict
    launches: int
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def kernel_seconds(self, pattern: str) -> tuple[float, int]:
        """Device seconds and launches of the kernels whose name matches
        ``pattern`` (``re.search``)."""
        rx = re.compile(pattern)
        hits = [v for k, v in self.kernels.items() if rx.search(k)]
        return sum(v[0] for v in hits), sum(v[1] for v in hits)


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    argument list."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            return name[:i].strip()[:160]
    return name[:160]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(device, host, t_start, t_end) -> Trace:
    """``device``: ``(name, start_s, end_s)`` of every device operation;
    ``host``: ``(name, start_s, end_s, depth)`` of host operations; the
    segment runs from ``t_start`` to ``t_end`` on the same clock."""
    kernels = {}
    for name, s, e in device:
        k = kernels.setdefault(short_name(name), [0.0, 0])
        k[0] += e - s
        k[1] += 1
    busy = _union([(s, e) for _, s, e in device])
    gaps, prev = [], t_start
    for s, e in busy + [[t_end, t_end]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    # sweep the gaps in time order beside the host operations sorted by
    # start; the open ones nest, so the list stays short
    ops = sorted((h for h in host if not h[0].startswith("cu")),
                 key=lambda h: h[1])
    by_host, open_ops, k = {}, [], 0
    for g0, g1 in gaps:
        while k < len(ops) and ops[k][1] <= g0:
            open_ops.append(ops[k])
            k += 1
        open_ops = [h for h in open_ops if h[2] > g0]
        label = (max(open_ops, key=lambda h: h[3])[0] if open_ops
                 else "host idle")
        by_host[label] = by_host.get(label, 0.0) + (g1 - g0)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    return Trace(window_s=t_end - t_start,
                 busy_s=sum(e - s for s, e in busy),
                 kernels=kernels,
                 launches=sum(v[1] for v in kernels.values()),
                 device_ops=[[k, v[0]] for k, v in top],
                 idle_gaps=sorted(([k, v] for k, v in by_host.items()),
                                  key=lambda kv: -kv[1])[:TOP])


def _depth(ev) -> int:
    d, p = 0, ev.cpu_parent
    while p is not None:
        d, p = d + 1, p.cpu_parent
    return d


def traced(fn, device):
    """Run ``fn()`` under ``torch.profiler`` (host and, on a card, CUDA
    activities) and return ``(fn's result, Trace)``; the segment ends with
    a synchronize.  On the CPU the trace holds no device operation."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .device import synchronize

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    synchronize(device)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function("benchmark_segment"):
            out = fn()
            synchronize(device)
    dev, host, seg = [], [], None
    for ev in prof.events():
        s, e = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.device_type == DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", False):
                dev.append((ev.name, s, e))
        elif ev.name == "benchmark_segment":
            seg = (s, e)
        else:
            host.append((ev.name, s, e, _depth(ev)))
    if seg is None:
        raise RuntimeError("the profiler recorded no benchmark_segment")
    return out, summarize(dev, host, *seg)
