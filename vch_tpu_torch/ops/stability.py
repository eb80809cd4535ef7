"""Linear stability of the homogeneous state (vch_tpu/ops/stability.py).

The dispersion relation of perturbations about phi ~ 0 with curvature
a = 2(c1 - c2) (ref: Forward_solver.py:48-55, Forward2_solver.py:53-83):

    lambda(k) = (-kappa q^2 - a q) / (1 + tau q),   q = k^2, k = pi n / Lx.

A positive lambda marks an unstable (spinodal) mode. Host numpy only: a
tensor k, on any device, is read to the host.
"""
from __future__ import annotations

import numpy as np

from vch_tpu_torch.device import to_numpy


def dispersion_relation(c1: float, c2: float, kappa: float, tau: float,
                        k: np.ndarray) -> np.ndarray:
    """Growth rate lambda(k) for wavenumbers k."""
    a = 2.0 * (c1 - c2)
    q = to_numpy(k) ** 2
    return (-kappa * q ** 2 - a * q) / (1.0 + tau * q)


def instability_report(c1: float, c2: float, kappa: float, tau: float,
                       Lx: float, Nmodes: int = 12,
                       verbose: bool = True) -> np.ndarray:
    """Growth rates of the first Nmodes Fourier modes; prints a summary."""
    ks = np.pi * np.arange(1, Nmodes + 1) / Lx
    lam = dispersion_relation(c1, c2, kappa, tau, ks)
    if verbose:
        a = 2.0 * (c1 - c2)
        print(f"a={a:.3g},  max lambda={lam.max():.3g} at mode "
              f"n={lam.argmax() + 1},  unstable modes={(lam > 0).sum()}")
    return lam
