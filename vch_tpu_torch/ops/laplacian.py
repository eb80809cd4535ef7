"""Neumann Laplacian: dense matrix and exact cosine eigenbasis (host numpy,
float64), the 1D and 2D applies and the matrix-free stencils on tensors
(vch_tpu/ops/laplacian.py).

The (N+1)x(N+1) mirrored-ghost Neumann FD Laplacian diagonalizes exactly in
the cosine basis v_k[j] = cos(pi k j / N) with
lambda_k = -(4/h^2) sin^2(pi k / (2N)); V^{-1} follows from DCT-I
orthogonality under trapezoidal weights.
"""
from __future__ import annotations

import numpy as np
import torch

from vch_tpu_torch.ops.grids import trapz_weights


def laplacian_matrix_neumann(N: int, h: float) -> np.ndarray:
    """Dense (N+1)x(N+1) Neumann FD Laplacian."""
    a = 1.0 / (h * h)
    L = np.zeros((N + 1, N + 1))
    idx = np.arange(1, N)
    L[idx, idx - 1] = a
    L[idx, idx] = -2.0 * a
    L[idx, idx + 1] = a
    L[0, 0], L[0, 1] = -2.0 * a, 2.0 * a
    L[N, N - 1], L[N, N] = 2.0 * a, -2.0 * a
    return L


def neumann_eigendecomposition(N: int, h: float):
    """Exact L = V diag(lam) V^{-1}; returns (lam, V, Vinv), float64."""
    j = np.arange(N + 1)[:, None]
    k = np.arange(N + 1)[None, :]
    V = np.cos(np.pi * j * k / N)
    lam = -(4.0 / (h * h)) * np.sin(np.pi * np.arange(N + 1) / (2.0 * N)) ** 2
    c = np.ones(N + 1)
    c[0] = 2.0
    c[N] = 2.0
    w = trapz_weights(N + 1)
    Vinv = (2.0 / (N * c))[:, None] * (w[None, :] * V.T)
    return lam, V, Vinv


def apply_laplacian_1d(L: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """L @ v along the last axis (any leading batch axes)."""
    return torch.matmul(v, L.T)


def apply_laplacian_2d(Lx: torch.Tensor, Ly: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """2D Neumann Laplacian of v[..., i, j]: Lx along axis -2, Ly along -1,
    as the two products Lx @ v + v @ Ly^T (vch_tpu/ops/laplacian.py:78).
    The Neumann Ly is not symmetric (2/h^2 in its first and last rows), so
    passing it transposed gives another field."""
    return apply_laplacian_2d_t(Lx, Ly.T, v)


def apply_laplacian_2d_t(Lx: torch.Tensor, LyT: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """apply_laplacian_2d with Ly given transposed, as the solvers hold it
    (`LyT`, contiguous): Lx @ v + v @ LyT."""
    return torch.matmul(Lx, v) + torch.matmul(v, LyT)


def stencil_laplacian_1d(v: torch.Tensor, h: float) -> torch.Tensor:
    """Matrix-free mirrored-ghost Neumann Laplacian along the last axis."""
    pad = torch.cat([v[..., 1:2], v, v[..., -2:-1]], dim=-1)
    return (pad[..., :-2] - 2.0 * v + pad[..., 2:]) / (h * h)


def stencil_laplacian_2d(v: torch.Tensor, hx: float, hy: float) -> torch.Tensor:
    """Matrix-free 2D Neumann Laplacian of v[..., i, j]."""
    padx = torch.cat([v[..., 1:2, :], v, v[..., -2:-1, :]], dim=-2)
    lap_x = (padx[..., :-2, :] - 2.0 * v + padx[..., 2:, :]) / (hx * hx)
    pady = torch.cat([v[..., 1:2], v, v[..., -2:-1]], dim=-1)
    lap_y = (pady[..., :-2] - 2.0 * v + pady[..., 2:]) / (hy * hy)
    return lap_x + lap_y
