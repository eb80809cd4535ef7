"""Batched 2D adjoint (p, q, r) sweep (vch_tpu/models/adjoint2d.py).

    A(phi_n)   = I - tau L + (dt/2) L^2 - (dt/2) diag(f''(phi_n)) L
    B(phi_np1) = I - tau L - (dt/2) L^2 + (dt/2) diag(f''(phi_np1)) L
    terminal: (I - tau L) p_T = b2 (phi_T - phi_Omega);  q = -L p;  r_T = 0.

`AdjointSolver2D._run_batch` is the per-step sweep with a leading member
axis (`run` / `_run_impl`: one member; vch_tpu/models/adjoint2d.py:66-161,
:205): the exact terminal solve, then a Python loop over the steps in
reverse, each with the forward-ordered operators (A at n, B at n+1), the
split-preconditioned solve of A p_n = rhs warm started from p_{n+1}, q_n =
-L p_n and the r recursion; dt <= 1e-14 copies the next level. Every
reduction is per member (the mean of f'' in the preconditioner, the Krylov
dot products), so B members compute what vmap of vch_tpu's sweep does. The
solve routes as vch_tpu's (:114-142): with `use_pallas` on (by default:
float32 on a CUDA device on a grid vch_tpu keeps on its kernel), the
per-solve adjoint kernel of `self.entries` (spectral, or raw for
pallas_variant "raw"; one CTA per member); else the composed fixed-trip
`bicgstab_split_fixed` in float32 and the adaptive `bicgstab_split` in
float64.

`adjoint_fused_batch` runs the whole batched sweep through `ops.march` with
`adjoint_krylov_fixed_iters` trips (5 by default; adjoint2d.py:48-50): the
member-blocked kernel when the batch divides by
`config.resolved_fused_block()`, else one member per CTA (adjoint2d.py:
184-195), its Krylov operator at `adjoint_solve_precision` (None:
"highest"; adjoint2d.py:195, :202). `adjoint_segment` runs a K-step segment
from an explicit (p, q, r) carry for the low-memory path, and `terminal`
the terminal solve it starts from; the segment runs at "highest", as
vch_tpu's low-memory path passes no precision (lowmem.py:541).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from vch_tpu_torch.config import ForwardSolverConfig2D
from vch_tpu_torch.device import as_tensor, resolve_device, to_numpy
from vch_tpu_torch.models.forward2d import fused_kernels_fit, torch_dtype
from vch_tpu_torch.models.timegrid import build_dt_schedule
from vch_tpu_torch.ops import march as km
from vch_tpu_torch.ops.linsolve import (LocalGrid, Ops2D, bicgstab_split,
                                        bicgstab_split_fixed,
                                        make_spectral_op_2d, ops_2d)
from vch_tpu_torch.ops.potential import fpp_log
from vch_tpu_torch.ops.solve_kernels import per_solve_kernels_fit


class AdjointSweep2D:
    """The per-step 2D sweep, shared by AdjointSolver2D and the grid-sharded
    adjoint (parallel/spatial.py). It reads `config`, `grid` (the grid
    operations: ops.linsolve.LocalGrid, or the sharded solver itself) and
    the solve's settings `_use_pallas`, `_pallas_variant`, `entries`,
    `_krylov_fixed` and `krylov_tol`."""

    def _sweep_step(self, p_next, q_next, r_next, phi_n, phi_np1, src_n,
                    src_np1, dt, b1):
        """One step of the sweep of the members of phi_n (B, Nx+1, Ny+1)
        from the carry (p, q, r) at level n+1, with src = phi - phi_Q at
        both levels and b1 (B, 1, 1): the rhs B(phi_{n+1}) p_{n+1} + src,
        the solve of A(phi_n) p_n = rhs warm started from p_{n+1} (f''
        replaced by each member's mean in the preconditioner), q_n = -L p_n
        and the r recursion. Returns (p_n, q_n, r_n)
        (vch_tpu/models/adjoint2d.py:81-147)."""
        cfg = self.config
        grid = self.grid
        tau, gamma, c1, c2 = cfg.tau, cfg.gamma, cfg.c1, cfg.c2
        lap, lam = grid.lap, grid.lam
        to_s, from_s = grid.to_spec, grid.from_spec
        fpp_n = fpp_log(phi_n, c1, c2)
        fpp_np1 = fpp_log(phi_np1, c1, c2)
        fbar = grid.mean(fpp_n)
        w1 = lap(p_next)
        Bp = (p_next - tau * w1 - 0.5 * dt * lap(w1)
              + 0.5 * dt * fpp_np1 * w1)
        rhs = Bp + 0.5 * dt * b1 * (src_n + src_np1)

        def apply_A(v):
            w = lap(v)
            return v - tau * w + 0.5 * dt * (lap(w) - fpp_n * w)

        denom = (1.0 - tau * lam + 0.5 * dt * lam ** 2
                 - 0.5 * dt * fbar * lam)
        isd = torch.rsqrt(torch.abs(denom))
        if self._use_pallas and self._krylov_fixed is not None:
            op = grid.ops
            spectral = self._pallas_variant == "spectral"
            solve = (self.entries.adjoint_spectral if spectral
                     else self.entries.adjoint_raw)
            mats = ((op.Vx_inv, op.Vy_inv_T, op.Vx, op.VyT, op.lam) if spectral
                    else (op.Lx, op.LyT, op.Vx_inv, op.Vy_inv_T, op.Vx,
                          op.VyT))
            p_n = solve(*mats, isd, fpp_n, rhs, p_next, tau, 0.5 * dt,
                        n_iter=self._krylov_fixed)
        elif self._krylov_fixed is not None:
            p_n = bicgstab_split_fixed(
                apply_A, rhs, lambda v: from_s(to_s(v) * isd),
                lambda v: from_s(to_s(v) / isd), n_iter=self._krylov_fixed,
                x0=p_next, dot_fn=grid.dot)
        else:
            p_n = bicgstab_split(
                apply_A, rhs, lambda v: from_s(to_s(v) * isd),
                lambda v: from_s(to_s(v) / isd), tol=self.krylov_tol,
                max_iter=cfg.krylov_max_iter, x0=p_next, dot_fn=grid.dot)
        q_n = -lap(p_n)
        den = gamma + 0.5 * dt
        r_n = ((gamma - 0.5 * dt) / den * r_next
               + 0.5 * dt / den * (q_n + q_next))
        return p_n, q_n, r_n

    def _run_batch(self, phi_hist, dts, b1, b2, phi_Q, phi_T_target):
        """The sweep of B members: phi_hist, phi_Q (B, M+1, Nx+1, Ny+1),
        dts (M,), b1 and b2 (B,), phi_T_target (B, Nx+1, Ny+1). Returns
        (p, q, r), each (B, M+1, ...), with r_T = 0 last; a step with
        dt <= 1e-14 copies the next level (vmap of
        vch_tpu/models/adjoint2d.py:66-161)."""
        p, q, r = self.terminal(phi_hist[:, -1], phi_T_target, b2)
        b1 = b1.reshape(-1, 1, 1)
        src_all = phi_hist - phi_Q
        dts_host = self._dts_host(dts)
        ps, qs, rs = [p], [q], [r]
        for n in range(dts.shape[0] - 1, -1, -1):
            if not dts_host[n] <= 1e-14:        # else copy the next level
                p, q, r = self._sweep_step(p, q, r, phi_hist[:, n],
                                           phi_hist[:, n + 1], src_all[:, n],
                                           src_all[:, n + 1], dts[n], b1)
            ps.append(p)
            qs.append(q)
            rs.append(r)
        rev = lambda fs: torch.stack(fs[::-1], dim=1)
        return rev(ps), rev(qs), rev(rs)

    def _dts_host(self, dts):
        """The host copy of the schedule dts, on which the sweep branches
        every step: read from the device once per solver and schedule
        tensor, not once per sweep."""
        cached = getattr(self, "_dts_cache", None)
        if cached is None or cached[0] is not dts:
            cached = self._dts_cache = (dts, dts.cpu().numpy())
        return cached[1]

    def terminal(self, phi_T_state, phi_T_target, b2):
        """(p_T, q_T, r_T) for (B, ...) states and targets and b2 (B,):
        (I - tau L) p_T = b2 (phi(T) - phi_Omega) exact in the cosine basis,
        q_T = -L p_T, r_T = 0 (vch_tpu/models/lowmem.py:612-617)."""
        grid = self.grid
        rhs = b2.reshape(-1, 1, 1) * (phi_T_state - phi_T_target)
        p = grid.from_spec(grid.to_spec(rhs)
                           / (1.0 - self.config.tau * grid.lam))
        return p, -grid.lap(p), torch.zeros_like(p)


class AdjointSolver2D(AdjointSweep2D, nn.Module):
    """Backward sweep producing (p, q, r), on one device (device=None: the
    CUDA card)."""

    def __init__(self, config: Optional[ForwardSolverConfig2D] = None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg = config or ForwardSolverConfig2D()
        self.dtype = torch_dtype(cfg.dtype)
        hx, hy = cfg.Lx / cfg.Nx, cfg.Ly / cfg.Ny
        op = ops_2d(make_spectral_op_2d(cfg.Nx, cfg.Ny, hx, hy,
                                        dtype=self.dtype, device=device))
        for name, t in zip(op._fields, op):
            self.register_buffer(name, t)
        self.register_buffer("dts", torch.as_tensor(
            build_dt_schedule(cfg.T, cfg.dt_initial), dtype=self.dtype,
            device=device))
        self.n_trips = cfg.adjoint_krylov_fixed_iters or cfg.krylov_fixed_iters
        # the per-step sweep's solve (adjoint2d.py:46-63): adaptive in
        # float64, fixed-trip in float32, on the per-solve kernel by the
        # auto rule of ForwardSolver2D
        f64 = self.dtype == torch.float64
        self.krylov_tol = cfg.krylov_tol if f64 else max(cfg.krylov_tol, 1e-6)
        self._krylov_fixed = None if f64 else self.n_trips
        self._use_pallas = (cfg.use_pallas if cfg.use_pallas is not None
                            else (self._krylov_fixed is not None
                                  and device.type == "cuda"
                                  and per_solve_kernels_fit(cfg.Nx + 1,
                                                            cfg.Ny + 1)))
        self._pallas_variant = cfg.pallas_variant
        # the kernel entry points (km.PLAIN in chip_smoke.py's plain-path run)
        self.entries = km.KERNELS

    @property
    def op(self) -> Ops2D:
        return Ops2D(self.Lx, self.LyT, self.Vx_inv, self.Vy_inv_T, self.Vx,
                     self.VyT, self.lam)

    @property
    def grid(self) -> LocalGrid:
        return LocalGrid(self.op)

    def _ops(self):
        return tuple(self.op)

    def _run_impl(self, phi_hist, dts, b1, b2, phi_Q, phi_T_target):
        """The sweep of one member: phi_hist, phi_Q (M+1, Nx+1, Ny+1),
        dts (M,), phi_T_target (Nx+1, Ny+1), b1 and b2 numbers. Returns
        (p, q, r), each (M+1, Nx+1, Ny+1)."""
        as_b = lambda v: torch.as_tensor(v, dtype=self.dtype,
                                         device=phi_hist.device).reshape(1)
        p, q, r = self._run_batch(phi_hist[None], dts, as_b(b1), as_b(b2),
                                  phi_Q[None], phi_T_target[None])
        return p[0], q[0], r[0]

    def run(self, phi_hist, t_hist, b1: float, b2: float, phi_Q=None,
            phi_T_target=None):
        """(p, q, r) of the trajectory phi_hist (M+1, Nx+1, Ny+1) on the
        time stamps t_hist, with tracking target phi_Q (default 0) and
        terminal target phi_T_target (default 0)
        (vch_tpu/models/adjoint2d.py:205)."""
        as_t = lambda a: as_tensor(a, self.dtype, self.dts.device)
        phi_hist = as_t(phi_hist)
        dts = as_t(np.diff(to_numpy(t_hist).astype(np.float64)))
        phi_Q = (torch.zeros_like(phi_hist) if phi_Q is None
                 else as_t(phi_Q))
        phi_T_target = (torch.zeros_like(phi_hist[-1]) if phi_T_target is None
                        else as_t(phi_T_target))
        return self._run_impl(phi_hist, dts, float(b1), float(b2), phi_Q,
                              phi_T_target)

    def fused_march_available(self) -> bool:
        """Whether the whole-sweep kernel can carry the batched adjoint:
        vch_tpu's rule (adjoint2d.py:163), forward2d.fused_kernels_fit."""
        return fused_kernels_fit(self.config)

    def _kw(self):
        cfg = self.config
        return dict(tau=cfg.tau, gamma=cfg.gamma, c1=cfg.c1, c2=cfg.c2,
                    n_trips=self.n_trips)

    def adjoint_fused_batch(self, phi_hist, b1, b2, phi_Q, phi_T):
        """phi_hist, phi_Q (B, M+1, ...), phi_T (B, ...), b1/b2 (B,).
        Returns r (B, M+1, ...) with r_T = 0."""
        bb = self.config.resolved_fused_block()
        args = (self.dts, phi_hist, phi_Q, phi_T, b1, b2) + self._ops()
        kw = dict(self._kw(),
                  solve_prec=self.config.adjoint_solve_precision or "highest")
        if bb and phi_T.shape[0] % bb == 0:
            return self.entries.adjoint_blocked(*args, block_b=bb, **kw)
        return self.entries.adjoint(*args, **kw)

    def adjoint_segment(self, start: int, length: int, phi_seg, phi_Q_seg, p,
                        q, r, b1):
        """Levels start+length-1 .. start of the sweep from the carry
        (p, q, r) at level start+length; phi_seg, phi_Q_seg (B, length+1,
        ...). Returns (r (B, length, ...) in forward order, and (p, q, r) at
        level start)."""
        dts = self.dts[start:start + length]
        return self.entries.adjoint_segment(dts, phi_seg, phi_Q_seg, p, q, r,
                                            b1, *self._ops(), **self._kw())
