"""Uniform grids and trapezoidal weights (host numpy; vch_tpu/ops/grids.py)."""
from __future__ import annotations

import numpy as np


def trapz_weights(n_nodes: int) -> np.ndarray:
    """1D trapezoidal-rule weights: [1/2, 1, ..., 1, 1/2]."""
    w = np.ones(n_nodes)
    w[0] = 0.5
    w[-1] = 0.5
    return w


def grid_1d(N: int, Lx: float):
    """Uniform 1D grid: nodes x, spacing h, quadrature weights h*w_i."""
    h = Lx / N
    x = np.linspace(0.0, Lx, N + 1)
    return x, h, h * trapz_weights(N + 1)


def grid_2d(Nx: int, Ny: int, Lx: float, Ly: float):
    """Uniform 2D tensor grid: (x, y), spacings (hx, hy), 2D quadrature
    weights hx*hy*w_i*w_j."""
    hx, hy = Lx / Nx, Ly / Ny
    x = np.linspace(0.0, Lx, Nx + 1)
    y = np.linspace(0.0, Ly, Ny + 1)
    wts_h = hx * hy * np.outer(trapz_weights(Nx + 1), trapz_weights(Ny + 1))
    return (x, y), (hx, hy), wts_h
