"""The pieces of vch_tpu/models/forward1d.py that the 2D marcher shares:
the control-filter update and the marcher's counters."""
from __future__ import annotations

from typing import NamedTuple


def solve_w(w_old, dt, gamma, u_n, u_np1):
    """Closed-form CN update of the control filter gamma*w_t + w = u."""
    gamma_dt = gamma / dt
    return ((gamma_dt - 0.5) * w_old + 0.5 * (u_np1 + u_n)) / (gamma_dt + 0.5)


class MarchStats(NamedTuple):
    """Counters of one march (vch_tpu/models/forward1d.py:48).

    newton_solves: Newton linear solves over all time steps, counted from
        the Newton loops' trips.
    first_bad_step: the first time step whose mass defect was not finite,
        or -1 (the reference's runtime sanitizer; `simulate` raises on it).
    """

    newton_solves: int
    first_bad_step: int
