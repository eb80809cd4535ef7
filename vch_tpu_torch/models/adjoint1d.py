"""1D adjoint (p, q, r) backward sweep (vch_tpu/models/adjoint1d.py): the
reference's optimize-then-discretize scheme (backward_solver.py:48-125),
quirks included:

    A(phi_n)   = I - tau L + (dt/2) L^2 - (dt/2) diag(f''(phi_n)) L
    B(phi_np1) = I - tau L - (dt/2) L^2 + (dt/2) diag(f''(phi_np1)) L
    terminal: (I - tau L) p_T = b2 (phi_T - phi_Omega);  q = -L p;  r_T = 0
    r_n = [(gamma - dt/2) r_{n+1} + (dt/2)(q_n + q_{n+1})] / (gamma + dt/2)

(L^2 carries no kappa factor), and a step with dt <= 0 leaves p, q, r at
zero and the carry frozen: that is the duplicated t = 0 row of the reference
layout.

The sweep is a Python loop over the steps in reverse with a leading member
axis. Each step is one linear solve per member: the dense solve
(`torch.linalg.solve`) on the float64 parity path, else the adaptive
split-preconditioned `bicgstab_split` (tolerance max(krylov_tol, 1e-6) in
float32, at most 200 trips, warm started from p_{n+1}; one host sync per
trip) with the terminal solve exact in the cosine basis. As in vch_tpu the 1D
sweep has no fixed-trip solve and no kernel; `_krylov_fixed` serves the
float32 step of the low-memory scan arm (models/lowmem.py's _Adapter1D),
which vch_tpu solves in fixed trips.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from vch_tpu_torch.config import ForwardSolverConfig1D
from vch_tpu_torch.device import as_tensor, resolve_device, to_numpy
from vch_tpu_torch.ops.linsolve import (bicgstab_split, bicgstab_split_fixed,
                                        make_spectral_op_1d, member_dot_1d)
from vch_tpu_torch.ops.potential import fpp_log


class AdjointSolver1D(nn.Module):
    """Backward sweep producing (p, q, r) on the forward grid, on one device
    (device=None: the CUDA card)."""

    def __init__(self, config: Optional[ForwardSolverConfig1D] = None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg = config or ForwardSolverConfig1D()
        f64 = cfg.dtype == "float64"
        self.dtype = torch.float64 if f64 else torch.float32
        self.h = cfg.Lx / cfg.N
        # the same rule as ForwardSolver1D
        self._use_spectral = (cfg.linsolve_1d == "spectral"
                              or (cfg.linsolve_1d == "auto"
                                  and (not f64 or cfg.N > 256)))
        op = make_spectral_op_1d(cfg.N, self.h, dtype=self.dtype,
                                 device=device)
        for name, t in zip(op._fields, op):
            self.register_buffer(name, t)
        self._krylov_fixed = (None if f64
                              else (cfg.adjoint_krylov_fixed_iters
                                    or cfg.krylov_fixed_iters))
        self._krylov_tol = cfg.krylov_tol if f64 else max(cfg.krylov_tol,
                                                          1e-6)

    def terminal(self, phi_T_state, phi_T_target, b2):
        """(p_T, q_T, r_T) of the members of phi_T_state (B, N+1), b2 a
        number or (B, 1): (I - tau L) p_T = b2 (phi(T) - phi_Omega), exact in
        the cosine basis on the spectral path, dense otherwise; q_T = -L p_T;
        r_T = 0."""
        L, lam = self.L, self.lam
        tau = self.config.tau
        mm = torch.matmul
        rhs_T = b2 * (phi_T_state - phi_T_target)
        if self._use_spectral:
            p_T = mm(mm(rhs_T, self.Vinv.T) / (1.0 - tau * lam), self.V.T)
        else:
            I = torch.eye(L.shape[0], dtype=self.dtype, device=L.device)
            p_T = torch.linalg.solve_ex(I - tau * L,
                                        rhs_T[..., None])[0][..., 0]
        return p_T, -mm(p_T, L.T), torch.zeros_like(p_T)

    def _sweep_step(self, p_next, q_next, r_next, phi_n, phi_np1, src_n,
                    src_np1, dt, b1, krylov_fixed: Optional[int] = None):
        """One step of the sweep of the members of phi_n (B, N+1) from the
        carry (p, q, r) at level n+1, with src = phi - phi_Q at both levels
        and b1 a number or (B, 1). The solve of A(phi_n) p_n = rhs: dense on
        the parity path, else split-preconditioned Krylov warm started from
        p_{n+1}, adaptive, or krylov_fixed fixed trips. Returns (p_n, q_n,
        r_n) (vch_tpu/models/adjoint1d.py:82-125)."""
        cfg = self.config
        L, V, Vinv, lam = self.L, self.V, self.Vinv, self.lam
        LT, VT, VinvT = L.T, V.T, Vinv.T
        mm = torch.matmul
        tau, gamma, c1, c2 = cfg.tau, cfg.gamma, cfg.c1, cfg.c2
        fpp_n = fpp_log(phi_n, c1, c2)
        fpp_np1 = fpp_log(phi_np1, c1, c2)
        # rhs = B(phi_{n+1}) p_{n+1} + src
        w1 = mm(p_next, LT)
        Bp = (p_next - tau * w1 - 0.5 * dt * mm(w1, LT)
              + 0.5 * dt * fpp_np1 * w1)
        rhs = Bp + 0.5 * dt * b1 * (src_n + src_np1)
        if self._use_spectral:
            fbar = torch.mean(fpp_n, dim=-1, keepdim=True)

            def apply_A(v):
                w = mm(v, LT)
                return v - tau * w + 0.5 * dt * (mm(w, LT) - fpp_n * w)

            denom = (1.0 - tau * lam + 0.5 * dt * lam ** 2
                     - 0.5 * dt * fbar * lam)
            isd = torch.rsqrt(torch.abs(denom))
            phalf = lambda v: mm(mm(v, VinvT) * isd, VT)
            phalf_inv = lambda v: mm(mm(v, VinvT) / isd, VT)
            if krylov_fixed is not None:
                p_n = bicgstab_split_fixed(apply_A, rhs, phalf, phalf_inv,
                                           n_iter=krylov_fixed, x0=p_next,
                                           dot_fn=member_dot_1d)
            else:
                p_n = bicgstab_split(apply_A, rhs, phalf, phalf_inv,
                                     tol=self._krylov_tol, max_iter=200,
                                     x0=p_next, dot_fn=member_dot_1d)
        else:
            I = torch.eye(L.shape[0], dtype=self.dtype, device=L.device)
            A = (I - tau * L + 0.5 * dt * (L @ L)
                 - 0.5 * dt * (fpp_n[..., :, None] * L))
            p_n = torch.linalg.solve_ex(A, rhs[..., None])[0][..., 0]
        q_n = -mm(p_n, LT)
        den = gamma + 0.5 * dt
        r_n = ((gamma - 0.5 * dt) / den * r_next
               + 0.5 * dt / den * (q_n + q_next))
        return p_n, q_n, r_n

    def _run_batch(self, phi_hist, dts, b1, b2, phi_Q, phi_T_target):
        """The sweep of B members: phi_hist, phi_Q (B, K, N+1) in either
        layout, dts (K-1,), phi_T_target (B, N+1); b1, b2 numbers or (B, 1)
        tensors. Returns (p, q, r), each (B, K, N+1), with r_T = 0 last
        (vmap of vch_tpu/models/adjoint1d.py:61)."""
        p, q, r = self.terminal(phi_hist[:, -1], phi_T_target, b2)
        src_all = phi_hist - phi_Q
        dts_host = dts.cpu().numpy()
        zero = torch.zeros_like(p)
        ps, qs, rs = [p], [q], [r]
        for k in range(dts.shape[0] - 1, -1, -1):
            if dts_host[k] <= 0:        # duplicated row: zeros, carry frozen
                ps.append(zero)
                qs.append(zero)
                rs.append(zero)
                continue
            p, q, r = self._sweep_step(p, q, r, phi_hist[:, k],
                                       phi_hist[:, k + 1], src_all[:, k],
                                       src_all[:, k + 1], dts[k], b1)
            ps.append(p)
            qs.append(q)
            rs.append(r)
        rev = lambda fs: torch.stack(fs[::-1], dim=1)
        return rev(ps), rev(qs), rev(rs)

    def _run_impl(self, phi_hist, dts, b1, b2, phi_Q, phi_T_target):
        """The sweep of one member: phi_hist, phi_Q (K, N+1), phi_T_target
        (N+1,), b1 and b2 numbers. Returns (p, q, r), each (K, N+1)."""
        p, q, r = self._run_batch(phi_hist[None], dts, b1, b2, phi_Q[None],
                                  phi_T_target[None])
        return p[0], q[0], r[0]

    def run(self, phi_hist, t_hist, b1: float, b2: float, phi_Q=None,
            phi_T_target=None):
        """(p, q, r) of the trajectory phi_hist on the time stamps t_hist,
        in core layout (M+1 rows) or reference layout (duplicated t = 0
        row); the output has the input's layout. phi_Q and phi_T_target
        default to zero (vch_tpu/models/adjoint1d.py:145)."""
        as_t = lambda a: as_tensor(a, self.dtype, self.L.device)
        phi_hist = as_t(phi_hist)
        dts = as_t(np.diff(to_numpy(t_hist).astype(np.float64)))
        phi_Q = (torch.zeros_like(phi_hist) if phi_Q is None
                 else as_t(phi_Q))
        phi_T_target = (torch.zeros_like(phi_hist[-1]) if phi_T_target is None
                        else as_t(phi_T_target))
        return self._run_impl(phi_hist, dts, float(b1), float(b2), phi_Q,
                              phi_T_target)
