"""Exact discrete adjoint of the 2D forward solver by implicit
differentiation (vch_tpu/models/adjoint_exact2d.py).

The 2D counterpart of models/adjoint_exact1d.py (its docstring gives the
derivation), by hand, step for step as vch_tpu does. Differences:
  - the transposed Schur solve S^T lam2 = rhs is matrix-free:
    S^T v = (1/dt) v - (tau/dt + d) (L^T v) + (kappa/2) L^T (L^T v), with
    L^T v = Lx^T v + v Ly, through the port's BiCGStab (`bicgstab_fixed`
    with the forward solver's fixed trips in float32, `bicgstab` to its
    Krylov tolerance in float64), preconditioned by the transposed cosine
    solve Vinv^T diag(1/denom) V^T;
  - the Jacobian's diagonal takes the reference's clip
    phi^2 <= 1 - delta_sep^2 (Forward2_solver.py:243-244);
  - the interior-masked mass correction (Forward2_solver.py:564-577) pulls
    back as lam_j -> lam_j - wts_j / Wint * sum_{i interior} lam_i, the mask
    held constant.

The forward march that stores every step is a Python loop over the
forward solver's own step at B = 1 (`ForwardSolver2D._step`: Newton, the
clip, the mass correction) with no per-solve kernel (`kernels=False`:
vch_tpu passes no use_pallas there); the reverse sweep is a Python loop
too. Plain PyTorch
throughout, as vch_tpu's is XLA: no kernel.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from vch_tpu_torch.config import DELTA_SEP, ForwardSolverConfig2D
from vch_tpu_torch.device import as_tensor
from vch_tpu_torch.models.adjoint_exact1d import time_weights
from vch_tpu_torch.models.forward2d import ForwardSolver2D
from vch_tpu_torch.ops.grids import trapz_weights
from vch_tpu_torch.ops.linsolve import bicgstab, bicgstab_fixed


class ExactAdjoint2D(nn.Module):
    """Exact reduced-cost gradient dJ_smooth/du (an L2(Q) density) on one
    device (device=None: the CUDA card), in the forward solver's dtype."""

    def __init__(self, config: Optional[ForwardSolverConfig2D] = None,
                 device=None):
        super().__init__()
        self.solver = ForwardSolver2D(config, device=device)
        self.config = cfg = self.solver.config
        self.dtype = self.solver.dtype
        self.device = self.solver.dts.device
        self._wt_t = time_weights(self.solver.t_hist)
        self._wxy = np.outer(trapz_weights(cfg.Nx + 1),
                             trapz_weights(cfg.Ny + 1)) * (
            self.solver.hx * self.solver.hy)
        as_t = lambda a: torch.as_tensor(a, dtype=self.dtype,
                                         device=self.device)
        self.register_buffer("wt_t", as_t(self._wt_t))
        self.register_buffer("wxy", as_t(self._wxy))

    def _forward_full(self, u, phi0):
        """The march from phi0 (Nx+1, Ny+1) under u (M+1, Nx+1, Ny+1),
        keeping per step what the reverse sweep reads: the corrected state,
        the Newton solution before the clip and the interior mask of the
        mass correction, each step the forward solver's own off the
        per-solve kernel route (vch_tpu/models/adjoint_exact2d.py:52-88).
        Returns (phis, phi_stars, interiors), each (M, Nx+1, Ny+1)."""
        s = self.solver
        w = torch.zeros_like(phi0)[None]
        phi, mu = phi0[None], s.initialize_mu(phi0[None], w)
        m0 = torch.sum(s.wts * phi, dim=(-2, -1), keepdim=True)
        out = []
        for n in range(s.M):
            phi, mu, w, _, _, phi_star, interior = s._step(
                phi, mu, w, u[n][None], u[n + 1][None], s.dts[n], m0,
                kernels=False)
            out.append((phi[0], phi_star[0], interior[0]))
        return tuple(torch.stack(a) for a in zip(*out))

    def _grad(self, u, phi0, b1, b2, b3, phi_Q, phi_T):
        """u (M+1, Nx+1, Ny+1). Returns (grad_density (M+1, Nx+1, Ny+1),
        J_smooth 0-d) (vch_tpu/models/adjoint_exact2d.py:90-204)."""
        cfg, s = self.config, self.solver
        tau, c1, c2, kappa, gamma = (cfg.tau, cfg.c1, cfg.c2, cfg.kappa,
                                     cfg.gamma)
        op = s.op
        mm = torch.matmul
        LxT, Ly = op.Lx.T, op.LyT.T
        VxT, Vy = op.Vx.T, op.VyT.T
        VxiT, Vyi = op.Vx_inv.T, op.Vy_inv_T.T
        wts = s.wts
        zero = torch.zeros_like(wts)

        def lapT(v):
            return mm(LxT, v) + mm(v, Ly)

        W = self.wt_t[:, None, None] * self.wxy[None]
        phis, phi_stars, interiors = self._forward_full(u, phi0)
        phi_all = torch.cat([phi0[None], phis])

        diff = phi_all - phi_Q
        term = phi_all[-1] - phi_T
        J = (0.5 * b1 * torch.sum(W * diff * diff)
             + 0.5 * b2 * torch.sum(self.wxy * term ** 2)
             + 0.5 * b3 * torch.sum(W * u * u))
        dJdphi = b1 * W * diff
        dJdphi[-1] += b2 * self.wxy * term

        fixed = s._krylov_fixed
        phibar, mubar, wbar = dJdphi[-1], torch.zeros_like(phi0), \
            torch.zeros_like(phi0)
        ubar = torch.zeros_like(u)
        for k in reversed(range(s.M)):
            dt, phi_star, interior = s.dts[k], phi_stars[k], interiors[k]
            # the mass correction's pull-back (the forward's interior mask)
            Wint = torch.sum(torch.where(interior, wts, zero))
            inner = torch.sum(torch.where(interior, phibar, zero))
            lam_phi_c = phibar - (inner / Wint) * wts
            mask = (torch.abs(phi_star) < 1.0 - DELTA_SEP).to(self.dtype)
            lam_phi_star = mask * lam_phi_c

            phi_sq = torch.clamp(phi_star * phi_star, 0.0,
                                 1.0 - DELTA_SEP * DELTA_SEP)
            d = 2.0 * c1 / (1.0 - phi_sq)
            dbar = torch.mean(d)

            def apply_ST(v):
                w = lapT(v)
                return ((1.0 / dt) * v - (tau / dt + d) * w
                        + 0.5 * kappa * lapT(w))

            denom = ((1.0 / dt) + 0.5 * kappa * op.lam ** 2
                     - (tau / dt + dbar) * op.lam)

            def apply_MT(v):
                # the transpose of V diag(1/denom) Vinv
                return mm(mm(VxiT, mm(mm(VxT, v), Vy) / denom), Vyi)

            # rhs = lam_phi* + 2 Kpp^T mubar,
            # Kpp^T v = -(kappa/2) L^T v + (tau/dt + d) v
            KppT_mubar = (-(0.5 * kappa) * lapT(mubar)
                          + (tau / dt + d) * mubar)
            rhs = lam_phi_star + 2.0 * KppT_mubar
            if fixed is not None:
                lam2 = bicgstab_fixed(apply_ST, rhs, apply_MT, n_iter=fixed)
            else:
                lam2 = bicgstab(apply_ST, rhs, apply_MT, tol=s.krylov_tol,
                                max_iter=cfg.krylov_max_iter)
            lam1 = -2.0 * mubar - lapT(lam2)

            phibar = ((tau / dt + 2.0 * c2) * lam1
                      + 0.5 * kappa * lapT(lam1) + (1.0 / dt) * lam2
                      + dJdphi[k])
            mubar = 0.5 * lam1 + 0.5 * lapT(lam2)
            wbar_total = wbar + 0.5 * lam1

            gamma_dt = gamma / dt
            a_w = (gamma_dt - 0.5) / (gamma_dt + 0.5)
            b_w = 0.5 / (gamma_dt + 0.5)
            ubar[k] += b_w * wbar_total
            ubar[k + 1] += b_w * wbar_total
            wbar = a_w * wbar_total + 0.5 * lam1

        ubar = ubar + b3 * W * u
        return ubar / torch.clamp(W, min=1e-300), J

    def gradient(self, u, initial_phi: Optional[np.ndarray] = None,
                 b1: float = 5.0, b2: float = 10.0, b3: float = 1e-4,
                 phi_Q: Optional[np.ndarray] = None,
                 phi_T: Optional[np.ndarray] = None):
        """Exact smooth-cost gradient density for u (M+1, Nx+1, Ny+1).

        Returns (grad_density (M+1, Nx+1, Ny+1) tensor, J_smooth float)."""
        s, cfg = self.solver, self.config
        as_t = lambda a: as_tensor(a, self.dtype, self.device)
        shape = (cfg.Nx + 1, cfg.Ny + 1)
        phi0 = as_t(s.default_initial_phi() if initial_phi is None
                    else initial_phi)
        u = as_t(u)
        if tuple(u.shape) != (s.M + 1,) + shape:
            raise ValueError(f"u must be (M+1, Nx+1, Ny+1) = "
                             f"{(s.M + 1,) + shape}, got {tuple(u.shape)}")
        phi_Q = (torch.zeros((s.M + 1,) + shape, dtype=self.dtype,
                             device=self.device)
                 if phi_Q is None else as_t(phi_Q))
        phi_T = (torch.zeros(shape, dtype=self.dtype, device=self.device)
                 if phi_T is None else as_t(phi_T))
        g, J = self._grad(u, phi0, float(b1), float(b2), float(b3),
                          phi_Q, phi_T)
        return g, float(J)
