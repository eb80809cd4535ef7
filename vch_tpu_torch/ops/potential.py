"""Flory–Huggins potential terms, the 1D and 2D free energies and the seeded
random initial conditions (vch_tpu/ops/potential.py).

The initial conditions are built host-side with numpy's default_rng so it is
bit-identical to vch_tpu's (and to the reference solver's).
"""
from __future__ import annotations

import numpy as np
import torch

from vch_tpu_torch.ops.grids import trapz_weights


def regularized_log(phi: torch.Tensor, delta_sep: float) -> torch.Tensor:
    """log((1+phi)/(1-phi)) with phi clipped to +/-(1 - max(1e-8, delta/2))."""
    eps = max(1e-8, 0.5 * delta_sep)
    phi_s = torch.clamp(phi, -1.0 + eps, 1.0 - eps)
    return torch.log((1.0 + phi_s) / (1.0 - phi_s))


def f_prime(phi: torch.Tensor, c1: float, c2: float,
            delta_sep: float) -> torch.Tensor:
    """f'(phi) = c1 log((1+phi)/(1-phi)) - 2 c2 phi."""
    return c1 * regularized_log(phi, delta_sep) - 2.0 * c2 * phi


def fpp_log(phi: torch.Tensor, c1: float, c2: float,
            eps: float = 1e-8) -> torch.Tensor:
    """f''(phi) = 2 c1/(1-phi^2) - 2 c2, phi clipped into (-1+eps, 1-eps)."""
    ph = torch.clamp(phi, -1.0 + eps, 1.0 - eps)
    return 2.0 * c1 / (1.0 - ph * ph) - 2.0 * c2


def free_energy_1d(phi: torch.Tensor, kappa: float, c1: float, c2: float,
                   h: float, w: torch.Tensor | None = None,
                   eps: float = 1e-8) -> torch.Tensor:
    """1D free energy E = int (kappa/2)|phi_x|^2 + psi(phi) [- w phi] dx of
    phi[..., N+1] (vch_tpu/ops/potential.py:44)."""
    wts = torch.as_tensor(trapz_weights(phi.shape[-1]), dtype=phi.dtype,
                          device=phi.device)
    dphi = torch.diff(phi, dim=-1)
    E_grad = (kappa / (2.0 * h)) * torch.sum(dphi ** 2, dim=-1)
    phi_s = torch.clamp(phi, -1.0 + eps, 1.0 - eps)
    psi = (c1 * ((1.0 + phi_s) * torch.log(1.0 + phi_s)
                 + (1.0 - phi_s) * torch.log(1.0 - phi_s)) - c2 * phi_s ** 2)
    E = E_grad + h * torch.sum(wts * psi, dim=-1)
    if w is not None:
        E = E - h * torch.sum(wts * w * phi, dim=-1)
    return E


def free_energy_2d(phi: torch.Tensor, kappa: float, c1: float, c2: float,
                   hx: float, hy: float, w: torch.Tensor | None = None,
                   eps: float = 1e-8) -> torch.Tensor:
    """2D free energy of phi[..., Nx+1, Ny+1] with forward-difference
    gradient terms (vch_tpu/ops/potential.py:61): axis -2 is x (spacing
    hx), -1 is y (hy); w adds the control coupling -hx hy sum(wts w phi)."""
    Nx1, Ny1 = phi.shape[-2], phi.shape[-1]
    wts = torch.as_tensor(np.outer(trapz_weights(Nx1), trapz_weights(Ny1)),
                          dtype=phi.dtype, device=phi.device)
    dphi_x = torch.diff(phi, dim=-2)
    dphi_y = torch.diff(phi, dim=-1)
    E_grad = ((kappa / (2.0 * hx)) * torch.sum(dphi_x ** 2, dim=(-2, -1)) * hy
              + (kappa / (2.0 * hy)) * torch.sum(dphi_y ** 2, dim=(-2, -1))
              * hx)
    phi_s = torch.clamp(phi, -1.0 + eps, 1.0 - eps)
    psi = (c1 * ((1.0 + phi_s) * torch.log(1.0 + phi_s)
                 + (1.0 - phi_s) * torch.log(1.0 - phi_s)) - c2 * phi_s ** 2)
    E = E_grad + hx * hy * torch.sum(wts * psi, dim=(-2, -1))
    if w is not None:
        E = E - hx * hy * torch.sum(wts * w * phi, dim=(-2, -1))
    return E


def init_phi_random_1d(N: int, delta_sep: float, amp: float = 0.01,
                       seed: int = 42,
                       enforce_zero_mean: bool = True) -> np.ndarray:
    """1D seeded Gaussian IC with trapz zero-mean projection, clipped
    (float64 numpy; vch_tpu/ops/potential.py:85)."""
    rng = np.random.default_rng(seed)
    phi0 = amp * rng.standard_normal(N + 1)
    if enforce_zero_mean:
        wts = trapz_weights(N + 1)
        phi0 -= np.dot(wts, phi0) / wts.sum()
    return np.clip(phi0, -1.0 + delta_sep, 1.0 - delta_sep)


def init_phi_random_2d(Nx: int, Ny: int, delta_sep: float, amp: float = 0.1,
                       seed: int = 42,
                       enforce_zero_mean: bool = True) -> np.ndarray:
    """2D seeded Gaussian IC with trapz zero-mean projection, clip, and up to
    eight rounds of mass-preserving interior correction (float64 numpy)."""
    rng = np.random.default_rng(seed)
    phi0 = amp * rng.standard_normal((Nx + 1, Ny + 1))
    wts = np.outer(trapz_weights(Nx + 1), trapz_weights(Ny + 1))
    Wtot = np.sum(wts)
    if enforce_zero_mean:
        phi0 -= np.sum(wts * phi0) / Wtot
    lo, hi = -1.0 + delta_sep, 1.0 - delta_sep
    phi0 = np.clip(phi0, lo, hi)
    if enforce_zero_mean:
        margin = 5e-3
        for _ in range(8):
            M = np.sum(wts * phi0)
            if abs(M) <= 1e-14 * Wtot:
                break
            interior = np.abs(phi0) < (hi - margin)
            Wint = float(np.sum(wts[interior]))
            if Wint <= 0:
                phi0 -= M / Wtot
                phi0 = np.clip(phi0, lo, hi)
                break
            phi0[interior] -= M / Wint
    return phi0
