"""Discrete cost J = J1 + J2 + J3 + J4 by nested trapezoid quadrature
(vch_tpu/control/cost.py:19-65): space (2D: y then x), then time.

J = (b1/2)||phi-phi_Q||^2_Q + (b2/2)||phi(T)-phi_Omega||^2
  + (b3/2)||u||^2_Q + kappa_spar ||u||_{L1(Q)}

Fields carry any leading batch axes; b1..kappa_spar broadcast against them.
The grids x, y and t_hist may be numpy arrays or tensors on any device: they
are taken in phi_hist's dtype onto its device, as vch_tpu takes them
(vch_tpu/control/cost.py:22-23, 44-46); grids that already are, as the
problems pass them, are used as they are, with no copy.
"""
from __future__ import annotations

import torch

from vch_tpu_torch.device import as_tensor


def _trapz(y, x, dim):
    return torch.trapezoid(y, x=x, dim=dim)


def _grids(phi_hist, *grids):
    return tuple(as_tensor(g, phi_hist.dtype, phi_hist.device)
                 for g in grids)


def cost_breakdown_1d(phi_hist, u, phi_Q_target, phi_T_target, x, t_hist,
                      b1, b2, b3, kappa_spar):
    """(J1, J2, J3, J4) for 1D histories [..., K, N+1] on the time stamps
    t_hist (K,), in either layout."""
    x, t_hist = _grids(phi_hist, x, t_hist)
    J1 = (b1 / 2.0) * _trapz(_trapz((phi_hist - phi_Q_target) ** 2, x, -1),
                             t_hist, -1)
    J2 = (b2 / 2.0) * _trapz((phi_hist[..., -1, :] - phi_T_target) ** 2, x,
                             -1)
    J3 = (b3 / 2.0) * _trapz(_trapz(u ** 2, x, -1), t_hist, -1)
    J4 = kappa_spar * _trapz(_trapz(torch.abs(u), x, -1), t_hist, -1)
    return J1, J2, J3, J4


def calculate_cost_1d(phi_hist, u, phi_Q_target, phi_T_target, x, t_hist,
                      b1, b2, b3, kappa_spar, verbose: bool = False):
    J1, J2, J3, J4 = cost_breakdown_1d(phi_hist, u, phi_Q_target,
                                       phi_T_target, x, t_hist, b1, b2, b3,
                                       kappa_spar)
    total = J1 + J2 + J3 + J4
    if verbose:
        _print_breakdown(J1, J2, J3, J4, total)
    return total


def cost_breakdown_2d(phi_hist, u, phi_Q_target, phi_T_target, x, y, t_hist,
                      b1, b2, b3, kappa_spar):
    """(J1, J2, J3, J4) for 2D histories [..., M+1, Nx+1, Ny+1]."""
    x, y, t_hist = _grids(phi_hist, x, y, t_hist)

    def sp(a):
        return _trapz(_trapz(a, y, -1), x, -1)

    J1 = (b1 / 2.0) * _trapz(sp((phi_hist - phi_Q_target) ** 2), t_hist, -1)
    J2 = (b2 / 2.0) * sp((phi_hist[..., -1, :, :] - phi_T_target) ** 2)
    J3 = (b3 / 2.0) * _trapz(sp(u ** 2), t_hist, -1)
    J4 = kappa_spar * _trapz(sp(torch.abs(u)), t_hist, -1)
    return J1, J2, J3, J4


def calculate_cost_2d(phi_hist, u, phi_Q_target, phi_T_target, x, y, t_hist,
                      b1, b2, b3, kappa_spar, verbose: bool = False):
    J1, J2, J3, J4 = cost_breakdown_2d(phi_hist, u, phi_Q_target,
                                       phi_T_target, x, y, t_hist,
                                       b1, b2, b3, kappa_spar)
    total = J1 + J2 + J3 + J4
    if verbose:
        _print_breakdown(J1, J2, J3, J4, total)
    return total


def _print_breakdown(J1, J2, J3, J4, total):
    """vch_tpu's five lines (vch_tpu/control/cost.py:68-73); one member."""
    print(f"  Tracking Cost (J1): {float(J1):.6g}")
    print(f"  Terminal Cost (J2): {float(J2):.6g}")
    print(f"  Control Energy (J3): {float(J3):.6g}")
    print(f"  Sparsity Cost (J4): {float(J4):.6g}")
    print("-----------------------------")
    print(f"  Total Cost: {float(total):.6g}")
