"""The port's spans, and wall-clock phase timing.

``span(name)`` marks the work of one layer: a training step and its
forward, backward and optimizer parts, a model forward, a scoring request
and its graph build, features and copy, a CLI phase.  It acts only while
a ``torch.profiler`` (or the autograd profiler) runs: with no profiler
running a span is one flag check.  While one runs, a span

* opens ``torch.profiler.record_function(name)``, which puts it in the
  profiler's trace on the clock of the device operations (``cli infer
  --profile``'s ``trace.json``; the benchmark's idle-gap labels);
* once CUDA is initialised, and outside ``trace_only()``, also records a
  CUDA event on the current stream when it opens and one when it closes
  (no synchronize), and keeps ``(name, root, the two events)``: ``root``
  when no recorded span is open around it on its thread.

``spans()`` returns the kept spans with their ``device_ms`` (the time
between the two events); ``clear()`` forgets them.  The benchmark's span
metrics (``benchmarks/harness/spans.py``) read them.

``Timer`` sums the host seconds of named phases for the CLI's printout and
summaries (``infer``'s score, decode and assemble; ``build-graph``'s
parse, similarities and save); each phase is also a span named
``prefix + name``.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager, nullcontext

import torch
from torch.autograd import _profiler_enabled

_OFF = nullcontext()
_KEPT: list = []                  # (name, root, start, end) of each span
_OPEN = threading.local()         # .depth: kept spans open on this thread
_TRACE_ONLY = [False]


@contextmanager
def _on(name: str):
    with torch.profiler.record_function(name):
        if _TRACE_ONLY[0] or not torch.cuda.is_initialized():
            yield
            return
        depth = getattr(_OPEN, "depth", 0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        _OPEN.depth = depth + 1
        start.record()
        try:
            yield
        finally:
            end.record()
            _OPEN.depth = depth
            _KEPT.append((name, depth == 0, start, end))


def span(name: str):
    """A context manager that marks ``name`` while a profiler runs, and
    does nothing otherwise."""
    return _on(name) if _profiler_enabled() else _OFF


@contextmanager
def trace_only():
    """Inside, spans go to the profiler's trace alone: no CUDA event and
    nothing kept (for a profiler whose owner reads only its trace)."""
    _TRACE_ONLY[0] = True
    try:
        yield
    finally:
        _TRACE_ONLY[0] = False


def spans() -> list[dict]:
    """The kept spans in the order they closed: ``name``, ``root`` and
    ``device_ms``; synchronizes once."""
    if _KEPT:
        torch.cuda.synchronize()
    return [{"name": n, "root": r, "device_ms": s.elapsed_time(e)}
            for n, r, s, e in _KEPT]


def clear() -> None:
    """Forget every kept span."""
    _KEPT.clear()


class Timer:
    """Host seconds per named phase (``phases``), summed over repeats; each
    phase is also the span ``prefix + name``."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self.phases: dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(self.prefix + name):
                yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def summary(self) -> str:
        total = sum(self.phases.values())
        lines = [f"{name}: {dt:.2f}s" for name, dt in self.phases.items()]
        lines.append(f"total: {total:.2f}s")
        return "\n".join(lines)
