"""Wall-clock phase timing (reference utils/utils.py:33-36 + ad-hoc prints).

The reference scatters ``datetime.now()`` deltas through the code; here a small
Timer collects named phases so the CLI can print a structured summary and the
benchmark can report per-phase costs.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from datetime import timedelta


def timedelta_to_str(delta: timedelta) -> str:
    hours, remainder = divmod(delta.seconds, 3600)
    minutes, seconds = divmod(remainder, 60)
    return f"{hours}h {minutes}m {seconds}s"


class Timer:
    def __init__(self):
        self.phases: dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def summary(self) -> str:
        total = sum(self.phases.values())
        lines = [f"{name}: {dt:.2f}s" for name, dt in self.phases.items()]
        lines.append(f"total: {total:.2f}s")
        return "\n".join(lines)
