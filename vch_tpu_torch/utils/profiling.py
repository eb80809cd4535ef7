"""Profiler integration and solver throughput counters
(vch_tpu/utils/profiling.py).

  - `trace(logdir)`: a context manager around `torch.profiler` (CPU
    activity, and CUDA activity where a card is present) that writes a
    Chrome trace, `trace.json`, into `logdir`; the counterpart of vch_tpu's
    `jax.profiler` trace.
  - `SolveCounters`: the north-star counters (Newton solves/s, PGD
    scenario-iterations/s) from phase timings and the measured Newton
    solves.
"""
from __future__ import annotations

import os
import tempfile
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional


@contextmanager
def trace(logdir: Optional[str] = None):
    """Profile the block and write its Chrome trace to logdir/trace.json
    (default logdir: `vch_tpu_torch_trace` in the temporary directory).
    Yields logdir."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "vch_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@dataclass
class SolveCounters:
    """Throughput accounting for a batched PGD run.

    newton_solves is measured: the batched runner returns the Newton solves
    of every forward solve it ran (`BatchedProblem2D.run`'s
    "newton_solves"), so newton_solves_per_s is real work over real wall
    time.
    """

    time_steps: int
    batch: int
    pgd_iters: int = 0
    elapsed_s: float = 0.0
    newton_solves: int = 0

    def record(self, pgd_iters: int, elapsed_s: float, newton_solves: int):
        self.pgd_iters += pgd_iters
        self.elapsed_s += elapsed_s
        self.newton_solves += newton_solves

    @property
    def scenario_iters_per_s(self) -> float:
        return (self.batch * self.pgd_iters / self.elapsed_s
                if self.elapsed_s > 0 else 0.0)

    @property
    def newton_solves_per_s(self) -> float:
        return (self.newton_solves / self.elapsed_s
                if self.elapsed_s > 0 else 0.0)

    def summary(self) -> dict:
        return {
            "pgd_scenario_iters_per_s": round(self.scenario_iters_per_s, 4),
            "newton_solves_per_s": round(self.newton_solves_per_s, 1),
            "newton_solves_measured": self.newton_solves,
            "batch": self.batch,
            "pgd_iters": self.pgd_iters,
            "elapsed_s": round(self.elapsed_s, 3),
        }
