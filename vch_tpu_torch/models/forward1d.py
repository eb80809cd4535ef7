"""1D viscous Cahn–Hilliard forward solver (vch_tpu/models/forward1d.py):
Crank–Nicolson in time, Newton with convex–concave split residuals, a
per-component step ceiling and Armijo backtracking on the residual norm
(eta 1e-3, at most 12 halvings, no best-trial fallback: a failed line search
ends that member's Newton loop), the exact Schur elimination of dmu, and per
step the clip into (-1 + delta_sep, 1 - delta_sep) and the uniform mass
projection phi -= mass_error / Lx.

`ForwardSolver1D` holds the operators as buffers on one device and marches in
two ways:

  - the per-step marcher (`_march_batch`, and `_march_impl` / `simulate` for
    one member): a Python loop over the time steps with a leading member
    axis. Newton and Armijo run in masked lockstep: a member's state
    freezes once its own exit fires, which is what `jax.vmap` of vch_tpu's
    `while_loop`s computes; one member is B = 1. The loops read their
    predicates on the host (one sync per Newton round and per Armijo
    trial). The linear solve is the dense Schur solve
    (`torch.linalg.solve`) on the float64 parity path, else the raw-basis
    BiCGStab with the cosine-diagonal preconditioner (`linsolve_1d`): fixed
    `krylov_fixed_iters` trips in float32, adaptive in float64;
  - the whole batched march in one kernel launch (`march_fused_batch`,
    through `ops.march.march_fused_1d`), available on the float32 spectral
    fixed-trip path. The kernel solves in the spectral basis and the
    per-step marcher preconditions in the raw basis, so the two agree at the
    Newton tolerance, not bitwise.

`simulate(..., ref_layout=True)` reproduces the reference's duplicated t = 0
history row (Forward_solver.py:329-337).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from vch_tpu_torch.config import DELTA_SEP, ForwardSolverConfig1D
from vch_tpu_torch.device import as_tensor, resolve_device
from vch_tpu_torch.models.timegrid import build_dt_schedule, t_history
from vch_tpu_torch.ops import march as km
from vch_tpu_torch.ops.grids import grid_1d
from vch_tpu_torch.ops.linsolve import (SpectralOp1D, make_spectral_op_1d,
                                        newton_schur_solve_1d,
                                        newton_schur_solve_1d_spectral)
from vch_tpu_torch.ops.potential import (f_prime, free_energy_1d,
                                         init_phi_random_1d, regularized_log)
from vch_tpu_torch.ops.solve_kernels import per_solve_kernels_fit


def solve_w(w_old, dt, gamma, u_n, u_np1):
    """Closed-form CN update of the control filter gamma*w_t + w = u."""
    gamma_dt = gamma / dt
    return ((gamma_dt - 0.5) * w_old + 0.5 * (u_np1 + u_n)) / (gamma_dt + 0.5)


class MarchStats(NamedTuple):
    """Counters of one march (vch_tpu/models/forward1d.py:48).

    newton_solves: Newton linear solves over all time steps, counted from
        the Newton loops' trips.
    first_bad_step: the first time step whose mass defect was not finite,
        or -1 (the reference's runtime sanitizer; `simulate` raises on it).
    """

    newton_solves: int
    first_bad_step: int


def mu_residual(L, phi_new, phi_old, mu_new, mu_old, dt):
    """CN residual of phi_t - Lap(mu) = 0, over fields [..., N+1]."""
    return ((phi_new - phi_old) / dt
            - 0.5 * torch.matmul(mu_new + mu_old, L.T))


def phi_residual(L, phi_new, phi_old, mu_new, mu_old, w_new, w_old,
                 dt, tau, c1, c2, kappa, delta_sep):
    """CN residual of tau*phi_t - kappa*Lap(phi) + f'(phi) = mu + w with the
    convex (log, implicit) / concave (-2 c2 phi, explicit) splitting."""
    lap_avg = 0.5 * torch.matmul(phi_new + phi_old, L.T)
    f_cvx = c1 * regularized_log(phi_new, delta_sep)
    f_ccv = -2.0 * c2 * phi_old
    return (tau * (phi_new - phi_old) / dt - kappa * lap_avg
            + f_cvx + f_ccv - 0.5 * (mu_new + mu_old) - 0.5 * (w_new + w_old))


def _step_ceiling_1d(phi, dphi, delta_sep):
    """Largest alpha keeping phi + alpha dphi inside the open phase box, per
    member of phi[..., N+1], kept as (..., 1): the per-sign minimum ratios,
    1 when that is not finite or not positive, then min(1, 0.9 alpha_max)
    (vch_tpu/models/forward1d.py:80)."""
    big = torch.full_like(phi, math.inf)
    ratio_pos = torch.where(dphi > 0, (1.0 - delta_sep - phi) / dphi, big)
    ratio_neg = torch.where(dphi < 0, (-1.0 + delta_sep - phi) / dphi, big)
    amax = torch.minimum(torch.amin(ratio_pos, dim=-1, keepdim=True),
                         torch.amin(ratio_neg, dim=-1, keepdim=True))
    bad = ~torch.isfinite(amax) | (amax <= 0)
    amax = torch.where(bad, torch.ones_like(amax), amax)
    return torch.clamp(0.9 * amax, max=1.0)


def newton_1d(L, phi_old, mu_old, w_old, w_new, dt, tau, c1, c2, kappa,
              delta_sep, tol, max_iter, record_history: bool = False,
              rtol: float = 0.0, stagnation_exit: bool = False,
              spectral_op=None, krylov_fixed=None, krylov_tol: float = 1e-9,
              return_iters: bool = False, active=None):
    """Newton on (phi, mu) for one step of the members of phi_old (B, N+1),
    in masked lockstep (vch_tpu/models/forward1d.py:95 under vmap).

    Each member tests convergence at the top of its round (the absolute
    tolerance; rtol times its first residual when rtol > 0; with
    stagnation_exit a residual that did not fall), takes the Schur step with
    the 1D Armijo, and ends on convergence, on a failed line search or at
    max_iter; a member that has ended keeps its state while the others go
    on. `active` (B,) bool: the members that start; the others take no
    round and keep phi_old, mu_old. Returns (phi, mu), then with record_history the residual norms
    (B, max_iter + 1), NaN where a member ran no round, then with
    return_iters the Newton solves per member (B,) int64. Fields of one
    member (N+1,), vch_tpu's call form, are solved as a batch of one and
    returned without the batch axis: the norms (max_iter + 1,), the solves
    a 0-d count."""
    eta = 1e-3
    one = phi_old.dim() == 1
    if one:
        phi_old, mu_old, w_old, w_new = (
            a[None] if torch.is_tensor(a) and a.dim() == 1 else a
            for a in (phi_old, mu_old, w_old, w_new))
    msum = lambda a: torch.sum(a, dim=-1, keepdim=True)

    def resid(phi, mu):
        Rphi = phi_residual(L, phi, phi_old, mu, mu_old, w_new, w_old, dt,
                            tau, c1, c2, kappa, delta_sep)
        Rmu = mu_residual(L, phi, phi_old, mu, mu_old, dt)
        return torch.sqrt(msum(Rphi * Rphi) + msum(Rmu * Rmu)), Rphi, Rmu

    def armijo(phi, mu, dphi, dmu, norm_R, act):
        alpha = _step_ceiling_1d(phi, dphi, delta_sep)
        phi_a, mu_a = phi, mu
        accepted = torch.zeros_like(act)
        live = act
        for _ in range(12):
            if not bool(live.any()):
                break
            phi_t = phi + alpha * dphi
            mu_t = mu + alpha * dmu
            in_bounds = torch.all(torch.abs(phi_t) < 1.0 - delta_sep, dim=-1,
                                  keepdim=True)
            norm_t, _, _ = resid(phi_t, mu_t)
            accept = live & in_bounds & (norm_t <= (1.0 - eta * alpha) * norm_R)
            phi_a = torch.where(accept, phi_t, phi_a)
            mu_a = torch.where(accept, mu_t, mu_a)
            accepted = accepted | accept
            alpha = torch.where(accept, alpha, alpha * 0.5)
            live = live & ~accept
        return phi_a, mu_a, accepted

    B = phi_old.shape[0]
    dev = phi_old.device
    phi, mu = phi_old, mu_old
    done = (torch.zeros((B, 1), dtype=torch.bool, device=dev)
            if active is None else ~active.view(B, 1))
    norm0 = prev = torch.full((B, 1), math.inf, dtype=phi.dtype, device=dev)
    nsolve = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    hist = (torch.full((B, max_iter + 1), math.nan, dtype=phi.dtype,
                       device=dev) if record_history else None)
    for k in range(max_iter):
        if bool(done.all()):
            break
        live = ~done
        norm_R, Rphi, Rmu = resid(phi, mu)
        if record_history:
            hist[:, k] = torch.where(live[:, 0], norm_R[:, 0], hist[:, k])
        if k == 0:
            norm0 = norm_R
        conv = norm_R < tol
        if rtol > 0:
            conv = conv | (norm_R < rtol * norm0)
        if stagnation_exit and k > 0:
            conv = conv | (norm_R >= prev)
        act = live & ~conv
        if bool(act.any()):     # else every live member has just converged
            if spectral_op is None:
                dphi, dmu = newton_schur_solve_1d(L, phi, Rphi, Rmu, dt, tau,
                                                  c1, kappa, delta_sep)
            else:
                dphi, dmu = newton_schur_solve_1d_spectral(
                    spectral_op, phi, Rphi, Rmu, dt, tau, c1, kappa,
                    delta_sep, tol=krylov_tol, fixed_iters=krylov_fixed)
            phi_a, mu_a, accepted = armijo(phi, mu, dphi, dmu, norm_R, act)
            take = act & accepted
            phi = torch.where(take, phi_a, phi)
            mu = torch.where(take, mu_a, mu)
            nsolve = nsolve + act
            # a failed line search ends that member's Newton loop
            done = done | (act & ~accepted)
        done = done | (live & conv)
        prev = torch.where(live, norm_R, prev)
    out = (phi, mu)
    if record_history:
        out = out + (hist,)
    if return_iters:
        out = out + (nsolve[:, 0],)
    return tuple(a[0] for a in out) if one else out


class ForwardSolver1D(nn.Module):
    """Forward march on an (N+1) grid on one device (device=None: the CUDA
    card)."""

    def __init__(self, config: Optional[ForwardSolverConfig1D] = None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg = config or ForwardSolverConfig1D()
        f64 = cfg.dtype == "float64"
        self.dtype = torch.float64 if f64 else torch.float32
        self.x, self.h, self._wts_h = grid_1d(cfg.N, cfg.Lx)
        self.dts_np = build_dt_schedule(cfg.T, cfg.dt_initial)
        self.t_hist = t_history(self.dts_np, cfg.T)
        self.M = len(self.dts_np)
        # float32: relative tolerance and stagnation exit (see newton_1d)
        self._rtol = 0.0 if f64 else cfg.newton_rtol
        self._stagnation = not f64
        # the exact dense Schur solve for float64 runs at parity scale, the
        # matrix-free spectral BiCGStab in float32 or at large N
        self._use_spectral = (cfg.linsolve_1d == "spectral"
                              or (cfg.linsolve_1d == "auto"
                                  and (not f64 or cfg.N > 256)))
        self._krylov_fixed = None if f64 else cfg.krylov_fixed_iters
        self._krylov_tol = cfg.krylov_tol if f64 else max(cfg.krylov_tol,
                                                          1e-6)
        op = make_spectral_op_1d(cfg.N, self.h, dtype=self.dtype,
                                 device=device)
        as_t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=device)
        for name, t in zip(op._fields, op):
            self.register_buffer(name, t)
        # the transposes as the fused march takes them, each contiguous
        for name, t in (("LT", op.L), ("VinvT", op.Vinv), ("VT", op.V)):
            self.register_buffer(name, t.T.contiguous())
        self.register_buffer("wts", as_t(self._wts_h))
        self.register_buffer("dts", as_t(self.dts_np))
        # the kernel entry points; chip_smoke.py sets ops.march.PLAIN here to
        # hold the kernel path against the plain path on the card
        self.entries = km.KERNELS
        self.last_stats: Optional[MarchStats] = None

    @property
    def _op1d(self):
        """The SpectralOp1D of the spectral path, None on the dense path."""
        if not self._use_spectral:
            return None
        return SpectralOp1D(self.L, self.V, self.Vinv, self.lam)

    def default_initial_phi(self) -> np.ndarray:
        """Seed-42 Gaussian IC, bit-identical to Forward_solver.py:316."""
        return init_phi_random_1d(self.config.N, DELTA_SEP, amp=0.01, seed=42)

    def initialize_mu(self, phi, w):
        """mu = -kappa L phi + f'(phi) - w over fields [..., N+1], numpy or
        tensors, on this solver's device and dtype."""
        cfg = self.config
        phi = as_tensor(phi, self.dtype, self.L.device)
        w = as_tensor(w, self.dtype, self.L.device)
        return (-cfg.kappa * torch.matmul(phi, self.L.T)
                + f_prime(phi, cfg.c1, cfg.c2, DELTA_SEP) - w)

    def _newton_kw(self):
        cfg = self.config
        return dict(tau=cfg.tau, c1=cfg.c1, c2=cfg.c2, kappa=cfg.kappa,
                    delta_sep=DELTA_SEP, tol=cfg.newton_tol,
                    max_iter=cfg.newton_max_iter, rtol=self._rtol,
                    stagnation_exit=self._stagnation,
                    spectral_op=self._op1d, krylov_fixed=self._krylov_fixed,
                    krylov_tol=self._krylov_tol)

    def _step(self, phi, mu, w, u_n, u_np1, dt, m0, active=None):
        """One time step of the members of phi (B, N+1) from the carry
        (phi, mu, w) under the control frames u_n, u_np1, with the initial
        masses m0 (B, 1): the Newton solve (`active` (B,) bool: the members
        that solve, as newton_1d's), the clip and the uniform mass
        projection. Returns (phi, mu, w, newton_solves (B,), bad (B,): the
        mass defect is not finite, the Newton solution before the clip)
        (vch_tpu/models/forward1d.py:255-280)."""
        cfg = self.config
        w_new = solve_w(w, dt, cfg.gamma, u_n, u_np1)
        phi_new, mu_new, k = newton_1d(self.L, phi, mu, w, w_new, dt,
                                       return_iters=True, active=active,
                                       **self._newton_kw())
        phi_c = torch.clamp(phi_new, -1.0 + DELTA_SEP, 1.0 - DELTA_SEP)
        mass_error = torch.sum(self.wts * phi_c, dim=-1, keepdim=True) - m0
        return (phi_c - mass_error / cfg.Lx, mu_new, w_new, k,
                ~torch.isfinite(mass_error[:, 0]), phi_new)

    def _march_batch(self, u, phi0, active=None):
        """The per-step march of B members: u (B, M+1, N+1) in core layout,
        phi0 (B, N+1), on this solver's device. Returns (phi_hist
        (B, M+1, N+1), newton_solves (B,) int64, first_bad (B,) int64, -1:
        none) (vmap of vch_tpu/models/forward1d.py:248). `active` (B,)
        bool: the members that march; the others solve nothing
        (newton_solves 0, first_bad -1) and their histories are
        unspecified."""
        w = torch.zeros_like(phi0)
        phi, mu = phi0, self.initialize_mu(phi0, w)
        m0 = torch.sum(self.wts * phi0, dim=-1, keepdim=True)
        nsolve = torch.zeros(phi0.shape[0], dtype=torch.int64,
                             device=phi0.device)
        first_bad = torch.full_like(nsolve, -1)
        frames = [phi0]
        for n in range(self.M):
            phi, mu, w, k, bad = self._step(phi, mu, w, u[:, n], u[:, n + 1],
                                            self.dts[n], m0, active)[:5]
            if active is not None:
                bad = bad & active
            first_bad = torch.where((first_bad < 0) & bad,
                                    torch.full_like(first_bad, n), first_bad)
            nsolve = nsolve + k
            frames.append(phi)
        return torch.stack(frames, dim=1), nsolve, first_bad

    def _march_impl(self, u, phi0):
        """One member: u (M+1, N+1), phi0 (N+1,). Returns (phi_hist
        (M+1, N+1), MarchStats)."""
        phi_hist, ns, bad = self._march_batch(u[None], phi0[None])
        return phi_hist[0], MarchStats(int(ns[0]), int(bad[0]))

    def _simulate_impl(self, u, phi0):
        """The trajectory only."""
        return self._march_impl(u, phi0)[0]

    def fused_march_available(self, batch: int) -> bool:
        """Whether the fused whole-march 1D kernel carries a batch of this
        size: vch_tpu's rule (forward1d.py:291), the float32 spectral
        fixed-trip path and its VMEM model of the (B, N+1) working set. The
        CUDA kernel has no such limit; the rule is kept so that a config
        takes the same path in both packages."""
        return (self._use_spectral and self._krylov_fixed is not None
                and per_solve_kernels_fit(batch, self.config.N + 1))

    def march_fused_batch(self, u, phi0):
        """The whole batched march in one kernel launch: u (B, M+1, N+1) in
        core layout, phi0 (B, N+1), both contiguous on this solver's device.
        Returns (phi_hist (B, M+1, N+1), newton_solves (B,) float32,
        first_bad (B,) float32, -1: none) (vch_tpu/models/forward1d.py:298).
        Runs `krylov_fixed_iters` trips per solve."""
        if not (self._use_spectral and self._krylov_fixed is not None):
            raise ValueError("the fused 1D march needs the float32 spectral "
                             "fixed-trip path")
        cfg = self.config
        return self.entries.march_1d(
            self.dts, phi0, u, self.LT, self.VinvT, self.VT, self.lam[None],
            self.wts[None], tau=cfg.tau, c1=cfg.c1, c2=cfg.c2,
            kappa=cfg.kappa, gamma=cfg.gamma, delta_sep=DELTA_SEP,
            Lx_len=float(cfg.Lx), newton_tol=cfg.newton_tol,
            newton_rtol=self._rtol, newton_max_iter=cfg.newton_max_iter,
            n_trips=self._krylov_fixed, stagnation_exit=self._stagnation)

    def simulate(self, control: Optional[np.ndarray] = None,
                 initial_phi: Optional[np.ndarray] = None,
                 ref_layout: bool = False):
        """The per-step march from initial_phi (default: the seed-42 IC)
        under control: step-aligned (M+1, N+1), or reference layout
        (M+2, N+1), or None for zero. Returns (phi_hist, x, t_hist); with
        ref_layout=True phi_hist and t_hist carry the reference's duplicated
        t = 0 entry (M+2 rows). Keeps the counters in `last_stats` and raises
        on a non-finite mass defect (vch_tpu/models/forward1d.py:324)."""
        n = self.config.N + 1
        dev = self.dts.device
        as_t = lambda a: as_tensor(a, self.dtype, dev)
        phi0 = as_t(self.default_initial_phi() if initial_phi is None
                    else initial_phi)
        if control is None:
            u = torch.zeros((self.M + 1, n), dtype=self.dtype, device=dev)
        else:
            u = as_t(control)
            if u.shape[0] == self.M + 2:      # reference layout: drop dup row
                u = u[: self.M + 1]
            if tuple(u.shape) != (self.M + 1, n):
                raise ValueError(f"control must be (M+1, N+1) = "
                                 f"({self.M + 1}, {n}); got {tuple(u.shape)}")
        phi_hist, stats = self._march_impl(u, phi0)
        self.last_stats = stats
        if stats.first_bad_step >= 0:
            raise RuntimeError(
                f"Non-finite mass defect at time step {stats.first_bad_step}"
                " — solution diverged (see Forward_solver.py:166-172 "
                "semantics).")
        t_hist = self.t_hist
        if ref_layout:
            phi_hist = torch.cat([phi_hist[:1], phi_hist], dim=0)
            t_hist = np.concatenate([[0.0], t_hist])
        return phi_hist, self.x, t_hist

    def energy_history(self, phi_hist, w_hist=None, eps=None):
        """Free energy of every frame (vch_tpu/models/forward1d.py:363)."""
        cfg = self.config
        as_t = lambda a: as_tensor(a, self.dtype, self.dts.device)
        return free_energy_1d(as_t(phi_hist), cfg.kappa, cfg.c1, cfg.c2,
                              self.h,
                              w=None if w_hist is None else as_t(w_hist),
                              eps=1e-8 if eps is None else eps)

    def newton_residual_history(self, phi_old, mu_old, w_old, w_new, dt):
        """One Newton solve of a step from the given state; returns (phi,
        mu, [residual norm per iteration])
        (vch_tpu/models/forward1d.py:373)."""
        as_t = lambda a: as_tensor(a, self.dtype, self.dts.device)
        phi, mu, hist = newton_1d(self.L, as_t(phi_old), as_t(mu_old),
                                  as_t(w_old), as_t(w_new), dt,
                                  record_history=True, **self._newton_kw())
        hist = hist.cpu().numpy()
        return phi, mu, list(hist[~np.isnan(hist)])
