"""Batched 2D adjoint (p, q, r) sweep (vch_tpu/models/adjoint2d.py).

    A(phi_n)   = I - tau L + (dt/2) L^2 - (dt/2) diag(f''(phi_n)) L
    B(phi_np1) = I - tau L - (dt/2) L^2 + (dt/2) diag(f''(phi_np1)) L
    terminal: (I - tau L) p_T = b2 (phi_T - phi_Omega);  q = -L p;  r_T = 0.

`AdjointSolver2D.adjoint_fused_batch` runs the whole sweep through
`ops.march` with `adjoint_krylov_fixed_iters` trips (5 by default;
vch_tpu/models/adjoint2d.py:48-50): the member-blocked kernel when the batch
divides by `config.resolved_fused_block()`, else one member per CTA
(adjoint2d.py:184-195). `adjoint_segment` runs a K-step segment from an
explicit (p, q, r) carry for the low-memory path, and `terminal` the
terminal solve it starts from.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vch_tpu_torch.config import ForwardSolverConfig2D
from vch_tpu_torch.models.forward2d import torch_dtype
from vch_tpu_torch.models.timegrid import build_dt_schedule
from vch_tpu_torch.ops import march as km
from vch_tpu_torch.ops.laplacian import apply_laplacian_2d
from vch_tpu_torch.ops.linsolve import make_spectral_op_2d


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
        # the kernel entry points (km.PLAIN in chip_smoke.py's plain-path run)
        self.entries = km.KERNELS

    def _ops(self):
        return (self.Lx, self.LyT, self.Vx_inv, self.Vy_inv_T, self.Vx,
                self.VyT, self.lam)

    def _kw(self):
        cfg = self.config
        return dict(tau=cfg.tau, gamma=cfg.gamma, c1=cfg.c1, c2=cfg.c2,
                    n_trips=self.n_trips)

    def adjoint_fused_batch(self, phi_hist, b1, b2, phi_Q, phi_T):
        """phi_hist, phi_Q (B, M+1, ...), phi_T (B, ...), b1/b2 (B,).
        Returns r (B, M+1, ...) with r_T = 0."""
        bb = self.config.resolved_fused_block()
        args = (self.dts, phi_hist, phi_Q, phi_T, b1, b2) + self._ops()
        if bb and phi_T.shape[0] % bb == 0:
            return self.entries.adjoint_blocked(*args, block_b=bb,
                                                **self._kw())
        return self.entries.adjoint(*args, **self._kw())

    def terminal(self, phi_T_state, phi_T_target, b2):
        """(p_T, q_T, r_T) for (B, ...) states and targets and b2 (B,):
        (I - tau L) p_T = b2 (phi(T) - phi_Omega) exact in the cosine basis,
        q_T = -L p_T, r_T = 0 (vch_tpu/models/lowmem.py:612-617)."""
        mm = torch.matmul
        rhs = b2.reshape(-1, 1, 1) * (phi_T_state - phi_T_target)
        sh = mm(mm(self.Vx_inv, rhs), self.Vy_inv_T)
        p = mm(mm(self.Vx, sh / (1.0 - self.config.tau * self.lam)), self.VyT)
        return p, -apply_laplacian_2d(self.Lx, self.LyT, p), torch.zeros_like(p)

    def adjoint_segment(self, start: int, length: int, phi_seg, phi_Q_seg, p,
                        q, r, b1):
        """Levels start+length-1 .. start of the sweep from the carry
        (p, q, r) at level start+length; phi_seg, phi_Q_seg (B, length+1,
        ...). Returns (r (B, length, ...) in forward order, and (p, q, r) at
        level start)."""
        dts = self.dts[start:start + length]
        return self.entries.adjoint_segment(dts, phi_seg, phi_Q_seg, p, q, r,
                                            b1, *self._ops(), **self._kw())
