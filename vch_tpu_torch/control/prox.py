"""Proximal-gradient primitives (vch_tpu/control/prox.py): grad = r + b3 u,
gradient step, soft-threshold by alpha*kappa_spar, box clip."""
from __future__ import annotations

import torch


def calculate_gradient(r, u, b3):
    return r + b3 * u


def perform_gradient_step(u, grad_smooth, alpha):
    return u - alpha * grad_smooth


def soft_threshold(u, threshold):
    return torch.sign(u) * torch.clamp(torch.abs(u) - threshold, min=0.0)


def proximal_step(u, grad_smooth, alpha, kappa_spar, u_min: float,
                  u_max: float):
    """One ISTA step: gradient step, soft-threshold, box projection."""
    u_temp = u - alpha * grad_smooth
    return torch.clamp(soft_threshold(u_temp, alpha * kappa_spar),
                       u_min, u_max)
