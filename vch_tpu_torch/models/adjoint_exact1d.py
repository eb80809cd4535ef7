"""Exact discrete adjoint of the 1D forward solver by implicit
differentiation (vch_tpu/models/adjoint_exact1d.py).

The reference's adjoint (models/adjoint1d.py) discretizes the continuous
adjoint system on its own, so its r is an approximate gradient. This model
computes the exact gradient of the discrete reduced cost instead
(discretize-then-optimize), by hand, step for step as vch_tpu does: each
Crank-Nicolson step solves R(y; x) = 0 for y = (phi*, mu_{k+1}) given
x = (phi_k, mu_k, w_k, w_{k+1}) by Newton, and by the implicit function
theorem the reverse-mode pull-back through the step is

    J^T lam = ybar,     xbar = -(dR/dx)^T lam,

with J the Newton Jacobian [[Kpp, -I/2], [I/dt, -L/2]] at the solution, so
the transposed solve reduces by the same Schur elimination to one dense
system with S^T (`torch.linalg.solve`, where vch_tpu calls
`jnp.linalg.solve` outside any kernel). The clip and the uniform mass
projection phi_{k+1} = P clip(phi*), P = I - (1/Lx) 1 wts^T, pull back
elementwise and linearly, and the w recurrence is linear. Nothing here
differentiates the Newton iterations (no autograd).

The forward march that stores every step's phi and phi* is a Python loop
over the forward solver's own step (`ForwardSolver1D._step`: Newton, the
clip, the projection); the reverse sweep is a Python loop too. The gradient comes back as a
density with respect to the trapezoidal L2(Q) inner product (the discrete
gradient divided by the time x space quadrature weights), so it stands in
for the reference's r in grad = r + b3 u. Plain PyTorch throughout, as
vch_tpu's is XLA: no kernel.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from vch_tpu_torch.config import DELTA_SEP, ForwardSolverConfig1D
from vch_tpu_torch.device import as_tensor
from vch_tpu_torch.models.forward1d import ForwardSolver1D
from vch_tpu_torch.ops.grids import trapz_weights


def time_weights(t: np.ndarray) -> np.ndarray:
    """Trapezoidal weights of the (non-uniform) time grid t."""
    wt = np.zeros(len(t))
    for i in range(len(t) - 1):
        dt = t[i + 1] - t[i]
        wt[i] += dt / 2
        wt[i + 1] += dt / 2
    return wt


class ExactAdjoint1D(nn.Module):
    """Exact reduced-cost gradient dJ_smooth/du (an L2(Q) density) on one
    device (device=None: the CUDA card), in the forward solver's dtype."""

    def __init__(self, config: Optional[ForwardSolverConfig1D] = None,
                 device=None):
        super().__init__()
        self.solver = ForwardSolver1D(config, device=device)
        self.config = self.solver.config
        self.dtype = self.solver.dtype
        self.device = self.solver.dts.device
        # time-trapz weights on the core grid [0, t1, ..., T]
        self._wt_t = time_weights(self.solver.t_hist)
        self._wx = trapz_weights(self.config.N + 1) * self.solver.h
        as_t = lambda a: torch.as_tensor(a, dtype=self.dtype,
                                         device=self.device)
        self.register_buffer("wt_t", as_t(self._wt_t))
        self.register_buffer("wx", as_t(self._wx))

    def _forward_full(self, u, phi0):
        """The march from phi0 (N+1,) under u (M+1, N+1), keeping per step
        what the reverse sweep reads: the projected state and the Newton
        solution before the clip, each step the forward solver's own
        (vch_tpu/models/adjoint_exact1d.py:62-92). Returns (phis,
        phi_stars), each (M, N+1)."""
        s = self.solver
        w = torch.zeros_like(phi0)[None]
        phi, mu = phi0[None], s.initialize_mu(phi0[None], w)
        m0 = torch.sum(s.wts * phi, dim=-1, keepdim=True)
        out = []
        for n in range(s.M):
            phi, mu, w, _, _, phi_star = s._step(phi, mu, w, u[n][None],
                                                 u[n + 1][None], s.dts[n], m0)
            out.append((phi[0], phi_star[0]))
        phis, phi_stars = (torch.stack(a) for a in zip(*out))
        return phis, phi_stars

    def _grad(self, u, phi0, b1, b2, b3, phi_Q, phi_T):
        """u: core layout (M+1, N+1). Returns (grad_density (M+1, N+1),
        J_smooth 0-d) (vch_tpu/models/adjoint_exact1d.py:95-179)."""
        cfg, s = self.config, self.solver
        tau, c1, c2, kappa, gamma = (cfg.tau, cfg.c1, cfg.c2, cfg.kappa,
                                     cfg.gamma)
        L = s.L
        LT = L.T
        n = cfg.N + 1
        eye = torch.eye(n, dtype=self.dtype, device=self.device)
        W = self.wt_t[:, None] * self.wx[None, :]

        phis, phi_stars = self._forward_full(u, phi0)
        phi_all = torch.cat([phi0[None], phis])                 # (M+1, n)

        # the smooth cost (tracking, terminal, control energy), trapz
        diff = phi_all - phi_Q
        term = phi_all[-1] - phi_T
        J = (0.5 * b1 * torch.sum(W * diff * diff)
             + 0.5 * b2 * torch.sum(self.wx * term ** 2)
             + 0.5 * b3 * torch.sum(W * u * u))

        # dJ/dphi_k (levels 1..M; phi_0 is fixed data)
        dJdphi = b1 * W * diff
        dJdphi[-1] += b2 * self.wx * term

        # the reverse sweep over steps k = M-1 .. 0
        phibar, mubar, wbar = dJdphi[-1], torch.zeros_like(phi0), \
            torch.zeros_like(phi0)
        ubar = torch.zeros_like(u)
        for k in reversed(range(s.M)):
            dt, phi_star = s.dts[k], phi_stars[k]
            # the projection's transpose, then the clip's mask
            lam_phi_c = phibar - (torch.sum(phibar) / cfg.Lx) * s.wts
            mask = (torch.abs(phi_star) < 1.0 - DELTA_SEP).to(self.dtype)
            lam_phi_star = mask * lam_phi_c

            # the transposed Newton-Jacobian solve:
            # S^T lam2 = lam_phi* + 2 Kpp^T mubar
            d = 2.0 * c1 / (1.0 - phi_star * phi_star)
            KppT = -(0.5 * kappa) * LT + torch.diag(tau / dt + d)
            ST = (1.0 / dt) * eye - KppT @ LT
            rhs = lam_phi_star + 2.0 * (KppT @ mubar)
            lam2 = torch.linalg.solve(ST, rhs)
            lam1 = -2.0 * mubar - LT @ lam2

            # x-bar = -(dR/dx)^T lam
            phibar_k = ((tau / dt + 2.0 * c2) * lam1
                        + 0.5 * kappa * (LT @ lam1) + (1.0 / dt) * lam2)
            mubar = 0.5 * lam1 + 0.5 * (LT @ lam2)
            wbar_total = wbar + 0.5 * lam1

            gamma_dt = gamma / dt
            a_w = (gamma_dt - 0.5) / (gamma_dt + 0.5)
            b_w = 0.5 / (gamma_dt + 0.5)
            # each step's control pull-back lands on rows k and k + 1
            ubar[k] += b_w * wbar_total
            ubar[k + 1] += b_w * wbar_total
            wbar = a_w * wbar_total + 0.5 * lam1
            phibar = phibar_k + dJdphi[k]     # the cost term at level k

        ubar = ubar + b3 * W * u              # the control-energy term
        # the L2(Q) density (end weights guarded as vch_tpu does)
        return ubar / torch.clamp(W, min=1e-300), J

    def gradient(self, u, initial_phi: Optional[np.ndarray] = None,
                 b1: float = 0.3, b2: float = 13.0, b3: float = 0.0019,
                 phi_Q: Optional[np.ndarray] = None,
                 phi_T: Optional[np.ndarray] = None):
        """Exact smooth-cost gradient density for core-layout u (M+1, N+1).

        Returns (grad_density (M+1, N+1) tensor, J_smooth float)."""
        s = self.solver
        as_t = lambda a: as_tensor(a, self.dtype, self.device)
        phi0 = as_t(s.default_initial_phi() if initial_phi is None
                    else initial_phi)
        u = as_t(u)
        shape = (s.M + 1, self.config.N + 1)
        if tuple(u.shape) != shape:
            raise ValueError(f"u must be (M+1, N+1) = {shape}, got "
                             f"{tuple(u.shape)}")
        phi_Q = (torch.zeros(shape, dtype=self.dtype, device=self.device)
                 if phi_Q is None else as_t(phi_Q))
        phi_T = (torch.zeros(shape[1], dtype=self.dtype, device=self.device)
                 if phi_T is None else as_t(phi_T))
        g, J = self._grad(u, phi0, float(b1), float(b2), float(b3),
                          phi_Q, phi_T)
        return g, float(J)
