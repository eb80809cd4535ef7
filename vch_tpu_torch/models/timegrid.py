"""Static time-step schedule (host numpy; vch_tpu/models/timegrid.py).

The reference marches `while t < T - 1e-10` with dt capped to the remaining
time; the schedule is precomputed so the kernels get a fixed step count.
"""
from __future__ import annotations

import numpy as np

from vch_tpu_torch.device import to_numpy


def build_dt_schedule(T: float, dt: float, time_tol: float = 1e-10) -> np.ndarray:
    """Per-step dt values the reference while-loop takes."""
    dts = []
    current = 0.0
    while current < T - time_tol:
        step = min(dt, T - current)
        dts.append(step)
        current += step
    return np.asarray(dts, dtype=np.float64)


def t_history(dts: np.ndarray, T: float) -> np.ndarray:
    """Time stamps [0, t1, ..., ~T] with the reference's min(t, T) clamp."""
    t = np.concatenate([[0.0], np.cumsum(to_numpy(dts))])
    return np.minimum(t, T)
