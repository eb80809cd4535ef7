"""Batched 2D adjoint (p, q, r) sweep (vch_tpu/models/adjoint2d.py).

    A(phi_n)   = I - tau L + (dt/2) L^2 - (dt/2) diag(f''(phi_n)) L
    B(phi_np1) = I - tau L - (dt/2) L^2 + (dt/2) diag(f''(phi_np1)) L
    terminal: (I - tau L) p_T = b2 (phi_T - phi_Omega);  q = -L p;  r_T = 0.

`AdjointSolver2D.adjoint_fused_batch` runs the whole sweep through
`ops.march.adjoint_fused_2d` with `adjoint_krylov_fixed_iters` trips (5 by
default; vch_tpu/models/adjoint2d.py:48-50).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vch_tpu_torch.config import ForwardSolverConfig2D
from vch_tpu_torch.models.forward2d import torch_dtype
from vch_tpu_torch.models.timegrid import build_dt_schedule
from vch_tpu_torch.ops.linsolve import make_spectral_op_2d
from vch_tpu_torch.ops.march import adjoint_fused_2d


class AdjointSolver2D(nn.Module):
    """Batched backward sweep producing the gradient channel r."""

    def __init__(self, config: Optional[ForwardSolverConfig2D] = None,
                 device=None):
        super().__init__()
        self.config = cfg = config or ForwardSolverConfig2D()
        self.dtype = torch_dtype(cfg.dtype)
        hx, hy = cfg.Lx / cfg.Nx, cfg.Ly / cfg.Ny
        op = make_spectral_op_2d(cfg.Nx, cfg.Ny, hx, hy, dtype=self.dtype,
                                 device=device)
        for name, t in (("Lx", op.Lx), ("LyT", op.Ly.T.contiguous()),
                        ("Vx_inv", op.Vx_inv),
                        ("Vy_inv_T", op.Vy_inv.T.contiguous()),
                        ("Vx", op.Vx), ("VyT", op.Vy.T.contiguous()),
                        ("lam", op.lam),
                        ("dts", torch.as_tensor(
                            build_dt_schedule(cfg.T, cfg.dt_initial),
                            dtype=self.dtype, device=device))):
            self.register_buffer(name, t)
        self.n_trips = cfg.adjoint_krylov_fixed_iters or cfg.krylov_fixed_iters
        # the sweep entry point (adjoint_fused_2d_plain in chip_smoke.py's
        # plain-path run)
        self.sweep = adjoint_fused_2d

    def adjoint_fused_batch(self, phi_hist, b1, b2, phi_Q, phi_T):
        """phi_hist, phi_Q (B, M+1, ...), phi_T (B, ...), b1/b2 (B,).
        Returns r (B, M+1, ...) with r_T = 0."""
        cfg = self.config
        return self.sweep(
            self.dts, phi_hist, phi_Q, phi_T, b1, b2, self.Lx, self.LyT,
            self.Vx_inv, self.Vy_inv_T, self.Vx, self.VyT, self.lam,
            tau=cfg.tau, gamma=cfg.gamma, c1=cfg.c1, c2=cfg.c2,
            n_trips=self.n_trips)
