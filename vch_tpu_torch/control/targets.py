"""Terminal target phi_T and tracking path phi_Q (host numpy; the same
constructions as vch_tpu/control/targets.py).

1D, choice_t=1: A_T sin(2 pi x/Lx); 2: A_T cos(2 pi x/Lx); otherwise a tan
profile normalized to amplitude A_T. 2D, choice_t=1: 0.7 sin(2 pi x/Lx)
cos(pi y/Ly); otherwise a centred circle of radius Lx/3.5. choice_q=1: linear
time ramp phi(0) -> phi_T; otherwise zeros. The grids and phi_initial may
be numpy arrays or tensors on any device (read to the host).
"""
from __future__ import annotations

import numpy as np

from vch_tpu_torch.device import to_numpy


def build_targets_1d(x, t_hist, phi_initial, Lx, T, choice_t: int = 1,
                     choice_q: int = 1, A_T: float = 0.7,
                     k_tan: float = 0.45):
    """Return (phi_T_target (N+1,), phi_Q_target (len(t_hist), N+1)); the
    ramp runs over t_hist / t_hist[-1], in either layout."""
    x, t_hist, phi_initial = (to_numpy(a) for a in (x, t_hist, phi_initial))
    if choice_t == 1:
        phi_T = A_T * np.sin(2.0 * np.pi * x / Lx)
    elif choice_t == 2:
        phi_T = A_T * np.cos(2.0 * np.pi * x / Lx)
    else:   # poles excluded for k_tan < 0.5
        tan_raw = np.tan(2.0 * np.pi * k_tan * (x / Lx - 0.5))
        scale = np.max(np.abs(tan_raw))
        phi_T = A_T * tan_raw / (scale if scale > 1e-12 else 1.0)

    if choice_q == 1:
        tp = (t_hist / (t_hist[-1] if t_hist[-1] > 0 else 1.0))[:, None]
        phi_Q = (1.0 - tp) * phi_initial + tp * phi_T
    else:
        phi_Q = np.zeros((len(t_hist), len(x)))
    return phi_T, phi_Q


def build_targets_2d(x, y, t_hist, phi_initial, Lx, Ly, T,
                     choice_t: int = 1, choice_q: int = 1):
    """Return (phi_T_target (Nx+1, Ny+1), phi_Q_target (M+1, Nx+1, Ny+1))."""
    x, y, t_hist, phi_initial = (to_numpy(a)
                                 for a in (x, y, t_hist, phi_initial))
    xx, yy = np.meshgrid(x, y, indexing="ij")
    if choice_t == 1:
        phi_T = 0.7 * np.sin(2.0 * np.pi * xx / Lx) * np.cos(np.pi * yy / Ly)
    else:
        radius_sq = (Lx / 3.5) ** 2
        phi_T = -np.ones_like(xx)
        phi_T[(xx - Lx / 2) ** 2 + (yy - Ly / 2) ** 2 < radius_sq] = 1.0

    if choice_q == 1:
        tp = (t_hist / T)[:, None, None]
        phi_Q = (1.0 - tp) * phi_initial + tp * phi_T
    else:
        phi_Q = np.zeros((len(t_hist), len(x), len(y)))
    return phi_T, phi_Q
