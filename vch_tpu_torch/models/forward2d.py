"""Batched 2D viscous Cahn–Hilliard forward solver (vch_tpu/models/forward2d.py).

`ForwardSolver2D` holds the operator matrices as buffers on one device and
runs the whole batched march through `ops.march`: the member-blocked kernel
when the batch divides by `config.resolved_fused_block()`, else the
one-member-per-CTA kernel (vch_tpu/models/forward2d.py:338-353), and K-step
segments for the low-memory path; each is the CUDA kernel for CUDA tensors
and its plain PyTorch version for CPU tensors. Trip counts and Newton exits
resolve as vch_tpu's do (forward2d.py:180-194, :337): the fused Krylov trip
count is `fused_krylov_fixed_iters` (falling back to `krylov_fixed_iters`),
`newton_rtol` is 0 in float64, and the stagnation exit is on only in
float32.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from vch_tpu_torch.config import DELTA_SEP, ForwardSolverConfig2D
from vch_tpu_torch.models.timegrid import build_dt_schedule, t_history
from vch_tpu_torch.ops import march as km
from vch_tpu_torch.ops.grids import grid_2d
from vch_tpu_torch.ops.laplacian import apply_laplacian_2d
from vch_tpu_torch.ops.linsolve import make_spectral_op_2d
from vch_tpu_torch.ops.potential import f_prime, init_phi_random_2d


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
        # the kernel entry points; chip_smoke.py sets km.PLAIN here to hold
        # the kernel path against the plain path on the card
        self.entries = km.KERNELS

    def default_initial_phi(self) -> np.ndarray:
        """Seed-42 Gaussian IC with interior mass fix (amp 0.1)."""
        return init_phi_random_2d(self.config.Nx, self.config.Ny, DELTA_SEP,
                                  amp=0.1, seed=42)

    def initialize_mu(self, phi: torch.Tensor, w: torch.Tensor):
        """mu = -kappa L phi + f'(phi) - w, batched over leading axes
        (vch_tpu/models/forward2d.py:220)."""
        cfg = self.config
        lap = apply_laplacian_2d(self.Lx, self.LyT, phi)
        return (-cfg.kappa * lap + f_prime(phi, cfg.c1, cfg.c2, DELTA_SEP)
                - w)

    def _ops(self):
        return (self.Lx, self.LyT, self.Vx_inv, self.Vy_inv_T, self.Vx,
                self.VyT, self.lam, self.wts)

    def _march_kw(self):
        cfg = self.config
        return dict(tau=cfg.tau, c1=cfg.c1, c2=cfg.c2, kappa=cfg.kappa,
                    gamma=cfg.gamma, delta_sep=DELTA_SEP, area=cfg.Lx * cfg.Ly,
                    newton_tol=cfg.newton_tol, newton_rtol=self.rtol,
                    newton_max_iter=cfg.newton_max_iter, n_trips=self.n_trips,
                    stagnation_exit=self.stagnation)

    def march_fused_batch(self, u: torch.Tensor, phi0: torch.Tensor):
        """u (B, M+1, Nx+1, Ny+1), phi0 (B, Nx+1, Ny+1) on this solver's
        device. Returns (phi_hist (B, M+1, ...), newton_solves (B,) int32,
        first_bad (B,) int32). Blocked kernel when B divides by the
        resolved block size, else one member per CTA."""
        bb = self.config.resolved_fused_block()
        args = (self.dts, phi0, u) + self._ops()
        if bb and phi0.shape[0] % bb == 0:
            return self.entries.march_blocked(*args, block_b=bb,
                                              **self._march_kw())
        return self.entries.march(*args, **self._march_kw())

    def march_segment(self, start: int, length: int, phi, mu, w, m0, u_seg):
        """Steps start .. start+length-1 from the carry (phi, mu, w) with the
        global initial mass m0 (B,); u_seg (B, length+1, ...). Returns
        (hist (B, length, ...) of the post-step states, phi_f, mu_f, w_f,
        newton_solves (B,), first_bad (B,))."""
        dts = self.dts[start:start + length]
        return self.entries.march_segment(dts, phi, mu, w, m0, u_seg,
                                          *self._ops(), **self._march_kw())
