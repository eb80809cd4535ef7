"""Optimality diagnostics: the KKT sparsity check (Theorem 4.7) and the
finite-difference second-order coercivity probe (Theorem 4.8)
(vch_tpu/control/diagnostics.py).

The probe's perturbed forward solves run as one batch over the directions:
the caller's `forward_batch` takes them with a leading axis, which is what
vmap of the single forward computes in vch_tpu (on the card, one launch of
the whole-march kernel over the directions).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch


def verify_sparsity_condition(u_optimal: np.ndarray, r_optimal: np.ndarray,
                              kappa: float, tol: float = 1e-6,
                              verbose: bool = True) -> dict:
    """Check u*(x,t)=0 <=> |r*(x,t)| <= kappa; returns overlap statistics."""
    u = np.asarray(u_optimal)
    r = np.asarray(r_optimal)
    is_u_zero = np.abs(u) < tol
    is_r_small = np.abs(r) <= kappa
    match = is_u_zero == is_r_small
    total = u.size
    stats = {
        "sparsity_percentage": 100.0 * is_u_zero.sum() / total,
        "r_small_percentage": 100.0 * is_r_small.sum() / total,
        "match_percentage": 100.0 * match.sum() / total,
        "u_zero_count": int(is_u_zero.sum()),
        "total_points": int(total),
        "satisfied": bool(100.0 * match.sum() / total > 99.0),
    }
    if verbose:
        print("=" * 60)
        print("VERIFYING SPARSITY CONDITION (Theorem 4.7)")
        print("Condition: u*(x,t) = 0  <=>  |r*(x,t)| <= kappa")
        print(f"Sparsity of final control (u* ~ 0): "
              f"{stats['sparsity_percentage']:.2f}% "
              f"({stats['u_zero_count']}/{total} points)")
        print(f"Region where |r*| <= kappa:         "
              f"{stats['r_small_percentage']:.2f}%")
        print(f"Conditions match:                   "
              f"{stats['match_percentage']:.2f}%")
        print("PASS" if stats["satisfied"] else "NOT fully satisfied")
        print("=" * 60)
    return stats


def generate_critical_cone_direction(u_star, r_star, u_min, u_max, kappa, b3,
                                     rng, tol=1e-8, tol_s=1e-9,
                                     handle_kink: bool = True):
    """Random unit direction in the critical cone at u* (host numpy).

    handle_kink=True is the 1D generator (zero/sign constraints at the L1
    kink, second_order_conditions.py:33-55); False the 2D one (bound
    activity only, second_order_conditions_2d.py:35-88).
    """
    v = rng.standard_normal(size=u_star.shape)
    s_star = r_star + b3 * u_star
    lower = u_star <= (u_min + tol)
    upper = u_star >= (u_max - tol)
    v[lower] = np.abs(v[lower])
    v[upper] = -np.abs(v[upper])
    if handle_kink:
        at_zero = np.abs(u_star) <= tol
        kink_interior = at_zero & (np.abs(s_star) < (kappa - tol_s))
        kink_plus = at_zero & (s_star >= (kappa - tol_s))
        kink_minus = at_zero & (s_star <= (-kappa + tol_s))
        v[kink_interior] = 0.0
        v[kink_plus] = -np.abs(v[kink_plus])
        v[kink_minus] = np.abs(v[kink_minus])
    nrm = np.linalg.norm(v)
    if nrm == 0:
        idx = np.unravel_index(np.argmax(np.abs(s_star)), s_star.shape)
        v[idx] = 1.0
        nrm = 1.0
    return v / nrm


def approximate_second_order_condition(
        forward_batch: Callable, cost: Callable, u_star, r_star, phi_star,
        b3: float, kappa: float, u_min: float, u_max: float,
        num_directions: int = 3, epsilon: float = 1e-4,
        seed: Optional[int] = 42, handle_kink: bool = True,
        dtype=torch.float64, device=None) -> List[float]:
    """FD estimate of J''(u*)[h,h] along critical-cone directions:
    (J(u* + eps h) - J(u*) - eps <grad J, h>) / (eps^2 / 2).

    forward_batch: u (D, ...) -> phi_hist (D, ...), all directions in one
    call; cost: (phi_hist, u) -> J, over any leading axes. u_star, r_star,
    phi_star are host arrays; the perturbed controls go to `device` in
    `dtype` (the problem's; device None is the CUDA card, as every entry
    point resolves it). Positive values evidence coercivity (4.54).
    """
    from vch_tpu_torch.device import resolve_device
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    u_star = np.asarray(u_star)
    r_star = np.asarray(r_star)
    as_t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    cost_star = float(cost(as_t(phi_star), as_t(u_star)))
    grad_star = r_star + b3 * u_star
    hs = np.stack([
        generate_critical_cone_direction(u_star, r_star, u_min, u_max, kappa,
                                         b3, rng, handle_kink=handle_kink)
        for _ in range(num_directions)])
    u_pert = as_t(u_star[None] + epsilon * hs)
    costs = cost(forward_batch(u_pert), u_pert).cpu().numpy()
    d2s = []
    for i in range(num_directions):
        inner = float(np.sum(grad_star * hs[i]))
        d2s.append((costs[i] - cost_star - epsilon * inner)
                   / (0.5 * epsilon ** 2))
    return d2s
