"""Phase wall-clock timers and the time-study report
(vch_tpu/utils/timers.py).

The reference accumulates per-phase perf_counter totals and prints a
"COMPUTATIONAL TIME STUDY" block (GD_1D.py:323-331, :563-576;
GD2_configured.py:279-287, :402-415); this keeps that report, with a
context-manager API and phases per second. A phase that times device work
must synchronize the device before it closes.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict


class PhaseTimers:
    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def rate(self, name: str) -> float:
        """Completed phases per second."""
        t = self.totals.get(name, 0.0)
        return self.counts.get(name, 0) / t if t > 0 else 0.0

    def report(self, title: str = "COMPUTATIONAL TIME STUDY (wall-clock)"):
        lines = ["=" * 60, title, "=" * 60]
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<32}: {total:9.3f} s"
                         f"  ({n} calls, {self.rate(name):8.2f}/s)")
        lines.append("=" * 60)
        text = "\n".join(lines)
        print(text)
        return text
