"""Batched 2D viscous Cahn–Hilliard forward solver (vch_tpu/models/forward2d.py).

`ForwardSolver2D` holds the operator matrices as buffers on one device and
runs the whole batched march through `ops.march.march_fused_2d`: the CUDA
kernel for CUDA tensors, its plain PyTorch version for CPU tensors. Trip
counts and Newton exits resolve as vch_tpu's do (forward2d.py:180-194,
:337): the fused Krylov trip count is `fused_krylov_fixed_iters` (falling
back to `krylov_fixed_iters`), `newton_rtol` is 0 in float64, and the
stagnation exit is on only in float32.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from vch_tpu_torch.config import DELTA_SEP, ForwardSolverConfig2D
from vch_tpu_torch.models.timegrid import build_dt_schedule, t_history
from vch_tpu_torch.ops.grids import grid_2d
from vch_tpu_torch.ops.linsolve import make_spectral_op_2d
from vch_tpu_torch.ops.march import march_fused_2d
from vch_tpu_torch.ops.potential import init_phi_random_2d


def torch_dtype(name: str) -> torch.dtype:
    return torch.float64 if name == "float64" else torch.float32


class ForwardSolver2D(nn.Module):
    """Batched forward march on a (Nx+1)x(Ny+1) grid."""

    def __init__(self, config: Optional[ForwardSolverConfig2D] = None,
                 device=None):
        super().__init__()
        self.config = cfg = config or ForwardSolverConfig2D()
        self.dtype = torch_dtype(cfg.dtype)
        (self.x, self.y), (self.hx, self.hy), wts_h = grid_2d(
            cfg.Nx, cfg.Ny, cfg.Lx, cfg.Ly)
        self.dts_np = build_dt_schedule(cfg.T, cfg.dt_initial)
        self.t_hist = t_history(self.dts_np, cfg.T)
        self.M = len(self.dts_np)
        op = make_spectral_op_2d(cfg.Nx, cfg.Ny, self.hx, self.hy,
                                 dtype=self.dtype, device=device)
        as_t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=device)
        for name, t in (("Lx", op.Lx), ("LyT", op.Ly.T.contiguous()),
                        ("Vx_inv", op.Vx_inv),
                        ("Vy_inv_T", op.Vy_inv.T.contiguous()),
                        ("Vx", op.Vx), ("VyT", op.Vy.T.contiguous()),
                        ("lam", op.lam), ("wts", as_t(wts_h)),
                        ("dts", as_t(self.dts_np))):
            self.register_buffer(name, t)
        self.rtol = 0.0 if self.dtype == torch.float64 else cfg.newton_rtol
        self.stagnation = self.dtype != torch.float64
        self.n_trips = cfg.fused_krylov_fixed_iters or cfg.krylov_fixed_iters
        # the march entry point; chip_smoke.py sets march_fused_2d_plain here
        # to hold the kernel path against the plain path on the card
        self.march = march_fused_2d

    def default_initial_phi(self) -> np.ndarray:
        """Seed-42 Gaussian IC with interior mass fix (amp 0.1)."""
        return init_phi_random_2d(self.config.Nx, self.config.Ny, DELTA_SEP,
                                  amp=0.1, seed=42)

    def march_fused_batch(self, u: torch.Tensor, phi0: torch.Tensor):
        """u (B, M+1, Nx+1, Ny+1), phi0 (B, Nx+1, Ny+1) on this solver's
        device. Returns (phi_hist (B, M+1, ...), newton_solves (B,) int32,
        first_bad (B,) int32)."""
        cfg = self.config
        return self.march(
            self.dts, phi0, u, self.Lx, self.LyT, self.Vx_inv, self.Vy_inv_T,
            self.Vx, self.VyT, self.lam, self.wts, tau=cfg.tau, c1=cfg.c1,
            c2=cfg.c2, kappa=cfg.kappa, gamma=cfg.gamma, delta_sep=DELTA_SEP,
            area=cfg.Lx * cfg.Ly, newton_tol=cfg.newton_tol,
            newton_rtol=self.rtol, newton_max_iter=cfg.newton_max_iter,
            n_trips=self.n_trips, stagnation_exit=self.stagnation)
