"""Cosine-basis operator tensors for the 2D Newton and adjoint solves
(vch_tpu/ops/linsolve.py:46-78).

On the uniform Neumann grid the Laplacian is exactly diagonal in the cosine
basis, so the constant-coefficient part of every implicit operator is a
pointwise divide between the analysis transform Vx^{-1} v Vy^{-T} and the
synthesis transform Vx vhat Vy^T. The matrices are built in float64 numpy
and cast once to the solver dtype on the solver's device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vch_tpu_torch.ops.laplacian import (laplacian_matrix_neumann,
                                         neumann_eigendecomposition)


class SpectralOp2D(NamedTuple):
    """Operator constants on a (Nx+1)x(Ny+1) grid."""

    Lx: torch.Tensor      # (Nx+1, Nx+1) Neumann Laplacian, x direction
    Ly: torch.Tensor      # (Ny+1, Ny+1)
    Vx: torch.Tensor      # cosine modes as columns
    Vy: torch.Tensor
    Vx_inv: torch.Tensor
    Vy_inv: torch.Tensor
    lam: torch.Tensor     # (Nx+1, Ny+1) eigenvalue grid lam_x[i] + lam_y[j]


def make_spectral_op_2d(Nx: int, Ny: int, hx: float, hy: float,
                        dtype=torch.float64, device=None) -> SpectralOp2D:
    Lx = laplacian_matrix_neumann(Nx, hx)
    Ly = laplacian_matrix_neumann(Ny, hy)
    lamx, Vx, Vx_inv = neumann_eigendecomposition(Nx, hx)
    lamy, Vy, Vy_inv = neumann_eigendecomposition(Ny, hy)
    lam = lamx[:, None] + lamy[None, :]
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                     device=device)
    return SpectralOp2D(as_t(Lx), as_t(Ly), as_t(Vx), as_t(Vy),
                        as_t(Vx_inv), as_t(Vy_inv), as_t(lam))


def to_spectral(op: SpectralOp2D, v: torch.Tensor) -> torch.Tensor:
    """Analysis transform: vhat = Vx^{-1} v Vy^{-T}."""
    return torch.matmul(torch.matmul(op.Vx_inv, v), op.Vy_inv.T)


def from_spectral(op: SpectralOp2D, vhat: torch.Tensor) -> torch.Tensor:
    """Synthesis transform: v = Vx vhat Vy^T."""
    return torch.matmul(torch.matmul(op.Vx, vhat), op.Vy.T)
