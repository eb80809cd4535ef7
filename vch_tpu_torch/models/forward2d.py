"""2D viscous Cahn–Hilliard forward solver (vch_tpu/models/forward2d.py).

`ForwardSolver2D` holds the operator matrices as buffers on one device and
marches in two ways:

  - the per-step marcher (`ForwardStep2D._march_batch`, and `_march_impl` /
    `simulate` for one member): a Python loop over the time steps with a
    leading member axis, each step a Newton loop (`newton_2d`) whose linear
    solve is `ops.linsolve.newton_schur_solve_2d`, with the interior-only
    mass correction and the non-finite sanitizer. Every grid operation goes
    through a grid (ops.linsolve.LocalGrid here), so the grid-sharded
    forward (parallel/spatial.py) runs the same step with collectives. Newton and Armijo run in masked
    lockstep: a member's state freezes once its own exit fires, which is what
    `jax.vmap` of vch_tpu's `while_loop`s computes; one member is B = 1. The
    loops read their predicates on the host (one sync per Newton round and
    per Armijo trial). Float64 takes the adaptive Krylov solve; float32 the
    fixed-trip one, through the per-solve Schur kernel (one CTA per member)
    when `use_pallas` resolves on (by default: float32 on a CUDA device on a
    grid whose solve vch_tpu's rule keeps on its kernel, ops.solve_kernels);
  - the whole batched march in one kernel launch (`march_fused_batch`,
    `march_segment`) through `ops.march`: the member-blocked kernel when the
    batch divides by `config.resolved_fused_block()`, else one member per CTA
    (vch_tpu/models/forward2d.py:322-367), K-step segments for the
    low-memory path; available where `fused_kernels_fit` holds.

Every kernel entry goes through `self.entries` (ops.march.KERNELS: the CUDA
kernels on CUDA tensors, the plain versions on CPU tensors; ops.march.PLAIN
runs the plain versions on any device). Trip counts and Newton exits resolve
as vch_tpu's do (forward2d.py:178-194, :337): float32 clamps the Krylov
tolerance to 1e-6, `newton_rtol` is 0 in float64, the stagnation exit is on
only in float32, the per-step marcher takes `krylov_fixed_iters` and the
fused march `fused_krylov_fixed_iters`. The fused march's Krylov operator
runs at `fused_solve_precision` (default "bf16x3"), as vch_tpu's
(forward2d.py:350, :361). vch_tpu's float32 per-step march runs its products
at matmul precision "high"; the port computes those in full float32
(`forward_matmul_precision` is accepted, not honored).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from vch_tpu_torch.config import DELTA_SEP, ForwardSolverConfig2D
from vch_tpu_torch.device import as_tensor, resolve_device
from vch_tpu_torch.models.forward1d import MarchStats, solve_w
from vch_tpu_torch.models.timegrid import build_dt_schedule, t_history
from vch_tpu_torch.ops import march as km
from vch_tpu_torch.ops.grids import grid_2d
from vch_tpu_torch.ops.linsolve import (LocalGrid, Ops2D, as_grid,
                                        make_spectral_op_2d,
                                        newton_schur_solve_2d, ops_2d)
from vch_tpu_torch.ops.potential import (f_prime, free_energy_2d,
                                         init_phi_random_2d, regularized_log)
from vch_tpu_torch.ops.solve_kernels import per_solve_kernels_fit


def torch_dtype(name: str) -> torch.dtype:
    return torch.float64 if name == "float64" else torch.float32


def mu_residual_2d(op, phi_new, phi_old, mu_new, mu_old, dt):
    """`op`: vch_tpu's SpectralOp2D, an Ops2D or a grid
    (ops.linsolve.as_grid)."""
    return ((phi_new - phi_old) / dt
            - 0.5 * as_grid(op).lap(mu_new + mu_old))


def phi_residual_2d(op, phi_new, phi_old, mu_new, mu_old, w_new, w_old,
                    dt, tau, c1, c2, kappa, delta_sep):
    lap_avg = 0.5 * as_grid(op).lap(phi_new + phi_old)
    f_cvx = c1 * regularized_log(phi_new, delta_sep)
    f_ccv = -2.0 * c2 * phi_old
    return (tau * (phi_new - phi_old) / dt - kappa * lap_avg
            + f_cvx + f_ccv - 0.5 * (mu_new + mu_old) - 0.5 * (w_new + w_old))


def _step_ceiling_2d(phi, dphi, delta_sep, grid):
    """Largest Armijo start keeping phi + alpha dphi inside the bounds, per
    member of phi (..., n, m), kept as (..., 1, 1): 0.9 of the per-sign
    minima over the grid, capped at 2, 1 when that is not finite or not
    positive, then at most 1 (vch_tpu/models/forward2d.py:51)."""
    big = torch.full_like(phi, math.inf)
    ratio_pos = torch.where(dphi > 0, (1.0 - delta_sep - phi) / dphi, big)
    ratio_neg = torch.where(dphi < 0, (-1.0 + delta_sep - phi) / dphi, big)
    m_pos, m_neg = grid.mins(ratio_pos, ratio_neg)
    amax = torch.clamp(torch.minimum(0.9 * m_pos, 0.9 * m_neg), max=2.0)
    bad = ~torch.isfinite(amax) | (amax <= 0)
    amax = torch.where(bad, torch.ones_like(amax), amax)
    return torch.clamp(amax, max=1.0)


def newton_2d(op, phi_old, mu_old, w_old, w_new, dt, tau, c1, c2, kappa,
              delta_sep, tol, max_iter, krylov_tol, krylov_max_iter,
              mu_init, record_history: bool = False, rtol: float = 0.0,
              stagnation_exit: bool = False,
              krylov_fixed: Optional[int] = None,
              return_iters: bool = False, use_pallas: bool = False,
              pallas_variant: str = "spectral", entries=km.KERNELS,
              active: Optional[torch.Tensor] = None):
    """Newton with the best-trial-fallback Armijo (at most 12 trials) for
    one step of the members of phi_old (B, n, m), in masked lockstep
    (vch_tpu/models/forward2d.py:65 under vmap). `op`: vch_tpu's
    SpectralOp2D, an Ops2D, or a grid whose reductions are collective (a
    grid-sharded solver; its host decisions then read values that every
    rank of its group shares). Fields of one member (n, m), vch_tpu's call
    form, are marched as a batch of one and returned without the batch
    axis.

    Each member tests convergence at the top of its round (the absolute
    tolerance; rtol times its first residual when rtol > 0; with
    stagnation_exit a residual that did not fall) and otherwise takes the
    Schur step and the Armijo search; a member that has converged keeps its
    state while the others go on, for at most max_iter rounds. A member that
    takes no step in a round solves a zero system, which leaves its Krylov
    loop at once. `active` (B,) bool: the members that start; the others
    take no round and keep phi_old, mu_old. Returns (phi, mu), then with
    record_history the residual norms (B, max_iter + 1), NaN where a member
    ran no round, then with return_iters the Newton solves (B,) int64, as
    vch_tpu orders them."""
    eta = 1e-4
    grid = as_grid(op)
    one = phi_old.dim() == 2
    if one:
        phi_old, mu_old, w_old, w_new, mu_init = (
            a[None] if torch.is_tensor(a) and a.dim() == 2 else a
            for a in (phi_old, mu_old, w_old, w_new, mu_init))

    def resid(phi, mu):
        Rphi = phi_residual_2d(grid, phi, phi_old, mu, mu_old, w_new, w_old,
                               dt, tau, c1, c2, kappa, delta_sep)
        Rmu = mu_residual_2d(grid, phi, phi_old, mu, mu_old, dt)
        s_phi, s_mu = grid.sums(Rphi * Rphi, Rmu * Rmu)
        return torch.sqrt(s_phi + s_mu), Rphi, Rmu

    def armijo(phi, mu, dphi, dmu, norm_R, act):
        """Per member of act: the first accepted trial, else the best trial
        if it improved on norm_R, else (phi, mu)."""
        alpha = _step_ceiling_2d(phi, dphi, delta_sep, grid)
        best_norm = torch.full_like(norm_R, math.inf)
        best_phi, best_mu, phi_a, mu_a = phi, mu, phi, mu
        accepted = torch.zeros_like(act)
        live = act
        for _ in range(12):
            if not bool(live.any()):
                break
            phi_t = phi + alpha * dphi
            mu_t = mu + alpha * dmu
            norm_t = resid(phi_t, mu_t)[0]
            better = live & (norm_t < best_norm)
            best_norm = torch.where(better, norm_t, best_norm)
            best_phi = torch.where(better, phi_t, best_phi)
            best_mu = torch.where(better, mu_t, best_mu)
            accept = live & (norm_t <= (1.0 - eta * alpha) * norm_R)
            phi_a = torch.where(accept, phi_t, phi_a)
            mu_a = torch.where(accept, mu_t, mu_a)
            accepted = accepted | accept
            alpha = torch.where(accept, alpha, alpha * 0.5)
            live = live & ~accept
        use_best = ~accepted & (best_norm < norm_R)
        return (torch.where(accepted, phi_a,
                            torch.where(use_best, best_phi, phi)),
                torch.where(accepted, mu_a, torch.where(use_best, best_mu, mu)))

    B = phi_old.shape[0]
    dev = phi_old.device
    phi, mu = phi_old, mu_init
    done = (torch.zeros((B, 1, 1), dtype=torch.bool, device=dev)
            if active is None else ~active.view(B, 1, 1))
    norm0 = prev = torch.full((B, 1, 1), math.inf, dtype=phi.dtype,
                              device=dev)
    nsolve = torch.zeros(B, dtype=torch.int64, device=dev)
    hist = (torch.full((B, max_iter + 1), math.nan, dtype=phi.dtype,
                       device=dev) if record_history else None)
    for k in range(max_iter):
        if bool(done.all()):
            break
        live = ~done
        norm_R, Rphi, Rmu = resid(phi, mu)
        if record_history:
            hist[:, k] = torch.where(live.view(B), norm_R.view(B), hist[:, k])
        if k == 0:
            norm0 = norm_R
        conv = norm_R < tol
        if rtol > 0:
            conv = conv | (norm_R < rtol * norm0)
        if stagnation_exit and k > 0:
            conv = conv | (norm_R >= prev)
        act = live & ~conv
        if bool(act.any()):     # else every live member has just converged
            zero = torch.zeros_like(Rphi)
            dphi, dmu = newton_schur_solve_2d(
                grid, phi, torch.where(act, Rphi, zero),
                torch.where(act, Rmu, zero), dt, tau, c1, kappa, delta_sep,
                tol=krylov_tol, max_iter=krylov_max_iter,
                fixed_iters=krylov_fixed, use_pallas=use_pallas,
                pallas_variant=pallas_variant, entries=entries)
            phi_n, mu_n = armijo(phi, mu, dphi, dmu, norm_R, act)
            phi = torch.where(act, phi_n, phi)
            mu = torch.where(act, mu_n, mu)
            nsolve = nsolve + act.view(B)
        done = done | (live & conv)
        prev = torch.where(live, norm_R, prev)
    out = (phi, mu)
    if record_history:
        out = out + (hist,)
    if return_iters:
        out = out + (nsolve,)
    return tuple(a[0] for a in out) if one else out


def fused_kernels_fit(cfg: ForwardSolverConfig2D) -> bool:
    """vch_tpu's availability rule of the whole-march and whole-sweep
    kernels (vch_tpu/models/forward2d.py:315, adjoint2d.py:163): the float32
    fixed-trip path, on a grid whose solve vch_tpu keeps on its kernel
    (ops.solve_kernels.per_solve_kernels_fit). A float64 config never takes
    them."""
    return (cfg.dtype == "float32"
            and per_solve_kernels_fit(cfg.Nx + 1, cfg.Ny + 1))


class ForwardStep2D:
    """The per-step 2D march, shared by ForwardSolver2D and the grid-sharded
    forward (parallel/spatial.py). It reads `config`, `grid` (the grid
    operations: ops.linsolve.LocalGrid, or the sharded solver itself),
    `wts` (the trapezoid weights of the grid it holds), `M`, `dts` (on its
    device), `dtype` and `_newton_kw(kernels)`."""

    def initialize_mu(self, phi, w):
        """mu = -kappa L phi + f'(phi) - w, batched over leading axes; phi
        and w numpy or tensors, on this solver's device and dtype
        (vch_tpu/models/forward2d.py:220)."""
        cfg = self.config
        phi = as_tensor(phi, self.dtype, self.dts.device)
        w = as_tensor(w, self.dtype, self.dts.device)
        lap = self.grid.lap(phi)
        return (-cfg.kappa * lap + f_prime(phi, cfg.c1, cfg.c2, DELTA_SEP)
                - w)

    def _step(self, phi, mu, w, u_n, u_np1, dt, m0, kernels: bool = True,
              active=None):
        """One time step of the members of phi (B, Nx+1, Ny+1) from the
        carry (phi, mu, w) under the control frames u_n, u_np1, with the
        initial masses m0 (B, 1, 1): the Newton solve (kernels=False: never
        on the per-solve kernel route; `active` (B,) bool: the members that
        solve, as newton_2d's), the clip, and the interior-only mass
        correction with its uniform fallback. Returns (phi, mu, w,
        newton_solves (B,), bad (B,): the mass defect is not finite, the
        Newton solution before the clip, the correction's interior mask)
        (vch_tpu/models/forward2d.py:250-278)."""
        cfg = self.config
        lo, hi = -1.0 + DELTA_SEP, 1.0 - DELTA_SEP
        wts, grid = self.wts, self.grid
        w_new = solve_w(w, dt, cfg.gamma, u_n, u_np1)
        mu_init = self.initialize_mu(phi, w_new)
        phi_new, mu_new, k = newton_2d(grid, phi, mu, w, w_new, dt,
                                       mu_init=mu_init, return_iters=True,
                                       active=active,
                                       **self._newton_kw(kernels))
        phi_c = torch.clamp(phi_new, lo, hi)
        interior = torch.abs(phi_c) < (1.0 - DELTA_SEP - 5e-3)
        mass, Wint = grid.sums(wts * phi_c,
                               torch.where(interior, wts,
                                           torch.zeros_like(wts)))
        mass_error = mass - m0
        corrected = torch.where(interior, phi_c - mass_error / Wint, phi_c)
        fallback = torch.clamp(phi_c - mass_error / (cfg.Lx * cfg.Ly), lo, hi)
        phi_c = torch.where(torch.abs(mass_error) > 1e-16,
                            torch.where(Wint > 0, corrected, fallback), phi_c)
        return (phi_c, mu_new, w_new, k, ~torch.isfinite(mass_error).view(-1),
                phi_new, interior)

    def _march_batch(self, u, phi0, active=None):
        """The per-step march of B members: u (B, M+1, Nx+1, Ny+1), phi0
        (B, Nx+1, Ny+1) on this solver's device (on a grid-sharded solver,
        its row blocks). Returns (phi_hist (B, M+1, ...), newton_solves (B,)
        int64, first_bad (B,) int64, -1: none) (vmap of
        vch_tpu/models/forward2d.py:230-286). `active` (B,) bool: the
        members that march; the others solve nothing (newton_solves 0,
        first_bad -1) and their histories are unspecified."""
        w = torch.zeros_like(phi0)
        phi, mu = phi0, self.initialize_mu(phi0, w)
        m0 = self.grid.sums(self.wts * phi0)[0]
        nsolve = torch.zeros(phi0.shape[0], dtype=torch.int64,
                             device=phi0.device)
        first_bad = torch.full_like(nsolve, -1)
        frames = [phi0]
        for n in range(self.M):
            phi, mu, w, k, bad = self._step(phi, mu, w, u[:, n], u[:, n + 1],
                                            self.dts[n], m0,
                                            active=active)[:5]
            if active is not None:
                bad = bad & active
            first_bad = torch.where((first_bad < 0) & bad,
                                    torch.full_like(first_bad, n), first_bad)
            nsolve = nsolve + k
            frames.append(phi)
        return torch.stack(frames, dim=1), nsolve, first_bad


class ForwardSolver2D(ForwardStep2D, nn.Module):
    """Forward march on a (Nx+1)x(Ny+1) grid on one device (device=None:
    the CUDA card)."""

    def __init__(self, config: Optional[ForwardSolverConfig2D] = None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg = config or ForwardSolverConfig2D()
        self.dtype = torch_dtype(cfg.dtype)
        (self.x, self.y), (self.hx, self.hy), self._wts_h = grid_2d(
            cfg.Nx, cfg.Ny, cfg.Lx, cfg.Ly)
        self.dts_np = build_dt_schedule(cfg.T, cfg.dt_initial)
        self.t_hist = t_history(self.dts_np, cfg.T)
        self.M = len(self.dts_np)
        op = ops_2d(make_spectral_op_2d(cfg.Nx, cfg.Ny, self.hx, self.hy,
                                        dtype=self.dtype, device=device))
        as_t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=device)
        for name, t in zip(op._fields, op):
            self.register_buffer(name, t)
        self.register_buffer("wts", as_t(self._wts_h))
        self.register_buffer("dts", as_t(self.dts_np))
        f64 = self.dtype == torch.float64
        self.rtol = 0.0 if f64 else cfg.newton_rtol
        self.stagnation = not f64
        self.n_trips = cfg.fused_krylov_fixed_iters or cfg.krylov_fixed_iters
        # the per-step marcher's Krylov solve: adaptive in float64 (the
        # tolerance clamped to what float32 resolves otherwise), fixed-trip
        # in float32, on the per-solve kernel by vch_tpu's auto rule with
        # "the TPU" read as "a CUDA device" (forward2d.py:198-210)
        self.krylov_tol = cfg.krylov_tol if f64 else max(cfg.krylov_tol, 1e-6)
        self._krylov_fixed = None if f64 else cfg.krylov_fixed_iters
        self._use_pallas = (cfg.use_pallas if cfg.use_pallas is not None
                            else (self._krylov_fixed is not None
                                  and device.type == "cuda"
                                  and per_solve_kernels_fit(cfg.Nx + 1,
                                                            cfg.Ny + 1)))
        self._pallas_variant = cfg.pallas_variant
        # the kernel entry points; chip_smoke.py sets km.PLAIN here to hold
        # the kernel path against the plain path on the card
        self.entries = km.KERNELS
        self.last_stats = None

    @property
    def op(self) -> Ops2D:
        return Ops2D(self.Lx, self.LyT, self.Vx_inv, self.Vy_inv_T, self.Vx,
                     self.VyT, self.lam)

    def default_initial_phi(self) -> np.ndarray:
        """Seed-42 Gaussian IC with interior mass fix (amp 0.1)."""
        return init_phi_random_2d(self.config.Nx, self.config.Ny, DELTA_SEP,
                                  amp=0.1, seed=42)

    @property
    def grid(self) -> LocalGrid:
        return LocalGrid(self.op)

    def _ops(self):
        return tuple(self.op) + (self.wts,)

    def _newton_kw(self, kernels: bool = True):
        """newton_2d's arguments; kernels=False leaves out the per-solve
        kernel route (use_pallas and its variant and entries)."""
        cfg = self.config
        kw = dict(tau=cfg.tau, c1=cfg.c1, c2=cfg.c2, kappa=cfg.kappa,
                  delta_sep=DELTA_SEP, tol=cfg.newton_tol,
                  max_iter=cfg.newton_max_iter, krylov_tol=self.krylov_tol,
                  krylov_max_iter=cfg.krylov_max_iter, rtol=self.rtol,
                  stagnation_exit=self.stagnation,
                  krylov_fixed=self._krylov_fixed)
        if kernels:
            kw.update(use_pallas=self._use_pallas,
                      pallas_variant=self._pallas_variant,
                      entries=self.entries)
        return kw

    def _march_impl(self, u, phi0):
        """One member: u (M+1, Nx+1, Ny+1), phi0 (Nx+1, Ny+1). Returns
        (phi_hist (M+1, ...), MarchStats)."""
        phi_hist, ns, bad = self._march_batch(u[None], phi0[None])
        return phi_hist[0], MarchStats(int(ns[0]), int(bad[0]))

    def _simulate_impl(self, u, phi0):
        """The trajectory only."""
        return self._march_impl(u, phi0)[0]

    def simulate(self, control: Optional[np.ndarray] = None,
                 initial_phi: Optional[np.ndarray] = None):
        """The per-step march from initial_phi (default: the seed-42 IC)
        under control (M+1, Nx+1, Ny+1) (default: zero); returns (phi_hist,
        (x, y), t_hist) and keeps the counters in `last_stats`. Raises on a
        non-finite mass defect (vch_tpu/models/forward2d.py:288)."""
        cfg = self.config
        shape = (self.M + 1, cfg.Nx + 1, cfg.Ny + 1)
        as_t = lambda a: as_tensor(a, self.dtype, self.dts.device)
        phi0 = as_t(self.default_initial_phi() if initial_phi is None
                    else initial_phi)
        if control is None:
            u = torch.zeros(shape, dtype=self.dtype, device=self.dts.device)
        else:
            u = as_t(control)
            if tuple(u.shape) != shape:
                raise ValueError(f"control must be (M+1, Nx+1, Ny+1) = "
                                 f"{shape}; got {tuple(u.shape)}")
        phi_hist, stats = self._march_impl(u, phi0)
        self.last_stats = stats
        if stats.first_bad_step >= 0:
            raise RuntimeError(
                f"Non-finite mass defect at time step {stats.first_bad_step}"
                " — solution diverged (see Forward_solver.py:166-172 "
                "semantics).")
        return phi_hist, (self.x, self.y), self.t_hist

    def energy_history(self, phi_hist, w_hist=None, eps=None):
        """Free energy of every frame (vch_tpu/models/forward2d.py:369)."""
        cfg = self.config
        as_t = lambda a: as_tensor(a, self.dtype, self.dts.device)
        return free_energy_2d(as_t(phi_hist), cfg.kappa, cfg.c1, cfg.c2,
                              self.hx, self.hy,
                              w=None if w_hist is None else as_t(w_hist),
                              eps=0.5 * DELTA_SEP if eps is None else eps)

    def newton_residual_history(self, phi_old, mu_old, w_old, w_new, dt):
        """One Newton solve of a step from the given state; returns (phi,
        mu, [residual norm per iteration])
        (vch_tpu/models/forward2d.py:381)."""
        as_t = lambda a: as_tensor(a, self.dtype, self.dts.device)
        phi_old, w_new = as_t(phi_old)[None], as_t(w_new)[None]
        mu_init = self.initialize_mu(phi_old, w_new)
        phi, mu, hist = newton_2d(
            self.grid, phi_old, as_t(mu_old)[None], as_t(w_old)[None], w_new,
            dt, mu_init=mu_init, record_history=True, **self._newton_kw())
        hist = hist[0].cpu().numpy()
        return phi[0], mu[0], list(hist[~np.isnan(hist)])

    def fused_march_available(self) -> bool:
        """Whether the whole-march kernel can carry the batched forward
        solve: vch_tpu's rule (forward2d.py:315), `fused_kernels_fit`."""
        return fused_kernels_fit(self.config)

    def _march_kw(self):
        cfg = self.config
        return dict(tau=cfg.tau, c1=cfg.c1, c2=cfg.c2, kappa=cfg.kappa,
                    gamma=cfg.gamma, delta_sep=DELTA_SEP, area=cfg.Lx * cfg.Ly,
                    newton_tol=cfg.newton_tol, newton_rtol=self.rtol,
                    newton_max_iter=cfg.newton_max_iter, n_trips=self.n_trips,
                    stagnation_exit=self.stagnation,
                    solve_prec=cfg.fused_solve_precision or "highest")

    def march_fused_batch(self, u: torch.Tensor, phi0: torch.Tensor,
                          active: Optional[torch.Tensor] = None):
        """u (B, M+1, Nx+1, Ny+1), phi0 (B, Nx+1, Ny+1) on this solver's
        device. Returns (phi_hist (B, M+1, ...), newton_solves (B,) int32,
        first_bad (B,) int32). Blocked kernel when B divides by the
        resolved block size, else one member per CTA. `active`: None or
        (B,) int32 flags, which only the one-member march takes (the blocked
        march raises)."""
        bb = self.config.resolved_fused_block()
        args = (self.dts, phi0, u) + self._ops()
        kw = self._march_kw() if active is None else dict(self._march_kw(),
                                                           active=active)
        if bb and phi0.shape[0] % bb == 0:
            return self.entries.march_blocked(*args, block_b=bb, **kw)
        return self.entries.march(*args, **kw)

    def march_segment(self, start: int, length: int, phi, mu, w, m0, u_seg):
        """Steps start .. start+length-1 from the carry (phi, mu, w) with the
        global initial mass m0 (B,); u_seg (B, length+1, ...). Returns
        (hist (B, length, ...) of the post-step states, phi_f, mu_f, w_f,
        newton_solves (B,), first_bad (B,))."""
        dts = self.dts[start:start + length]
        return self.entries.march_segment(dts, phi, mu, w, m0, u_seg,
                                          *self._ops(), **self._march_kw())
