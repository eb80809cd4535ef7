"""Cosine-basis operators, the Krylov solvers of the Newton and adjoint
systems, and the 1D and 2D Newton steps (vch_tpu/ops/linsolve.py).

On the uniform Neumann grid the Laplacian is exactly diagonal in the cosine
basis, so the constant-coefficient part of every implicit operator is a
pointwise divide between the analysis transform Vx^{-1} v Vy^{-T} and the
synthesis transform Vx vhat Vy^T. The matrices are built in float64 numpy
and cast once to the solver dtype on the solver's device.

Newton system (exact Schur elimination of dmu):
    S dphi = L Rphi - Rmu,   S = (1/dt) I + (kappa/2) L^2 - (tau/dt) L - L D,
    dmu = 2 (Kpp dphi + Rphi),  Kpp = -(kappa/2) L + (tau/dt + D) I,
with D = diag(2 c1 / (1 - phi^2)). The BiCGStab solvers below are the
composed ones vch_tpu runs when its fused kernels are off: `bicgstab`
(adaptive: float64, host-checked residual), `bicgstab_fixed` (fixed trip
count with the noise-floor freeze, non-finite rejection and best-iterate
return), and their split-preconditioned forms for the adjoint. They take
fields with any leading batch axes when `dot_fn` reduces per member; the
masked updates are then what `jax.vmap` of the vch_tpu solver computes.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from vch_tpu_torch.ops.laplacian import (apply_laplacian_2d_t,
                                         laplacian_matrix_neumann,
                                         neumann_eigendecomposition)


class SpectralOp2D(NamedTuple):
    """Operator constants on a (Nx+1)x(Ny+1) grid."""

    Lx: torch.Tensor      # (Nx+1, Nx+1) Neumann Laplacian, x direction
    Ly: torch.Tensor      # (Ny+1, Ny+1)
    Vx: torch.Tensor      # cosine modes as columns
    Vy: torch.Tensor
    Vx_inv: torch.Tensor
    Vy_inv: torch.Tensor
    lam: torch.Tensor     # (Nx+1, Ny+1) eigenvalue grid lam_x[i] + lam_y[j]


class Ops2D(NamedTuple):
    """The operators as the solvers and kernels take them: the y-direction
    matrices transposed, every one contiguous."""

    Lx: torch.Tensor
    LyT: torch.Tensor
    Vx_inv: torch.Tensor
    Vy_inv_T: torch.Tensor
    Vx: torch.Tensor
    VyT: torch.Tensor
    lam: torch.Tensor


class LocalGrid:
    """The grid operations of a 2D solver that holds the whole grid, per
    member of any leading batch axes: the Laplacian, sums, minima and means
    over the grid (kept as (..., 1, 1)), the inner product, and the cosine
    transforms with their eigenvalue grid `lam`. The grid-sharded solvers
    (parallel/spatial.py) provide the same methods with collectives over a
    row block, so the 2D Newton step, the Schur solve and the adjoint step
    serve both. `ops` is the Ops2D the per-solve kernels take."""

    def __init__(self, ops: Ops2D):
        self.ops = ops
        self.lam = ops.lam

    def lap(self, v):
        return apply_laplacian_2d_t(self.ops.Lx, self.ops.LyT, v)

    def sums(self, *parts):
        return tuple(torch.sum(a, dim=(-2, -1), keepdim=True) for a in parts)

    def mins(self, *parts):
        return tuple(torch.amin(a, dim=(-2, -1), keepdim=True)
                     for a in parts)

    def mean(self, a):
        return torch.mean(a, dim=(-2, -1), keepdim=True)

    def dot(self, a, c):
        return member_dot(a, c)

    def to_spec(self, v):
        """vhat = Vx^{-1} v Vy^{-T}."""
        return torch.matmul(torch.matmul(self.ops.Vx_inv, v),
                            self.ops.Vy_inv_T)

    def from_spec(self, vh):
        """v = Vx vhat Vy^T."""
        return torch.matmul(torch.matmul(self.ops.Vx, vh), self.ops.VyT)


def make_spectral_op_2d(Nx: int, Ny: int, hx: float, hy: float,
                        dtype=torch.float64, device=None) -> SpectralOp2D:
    Lx = laplacian_matrix_neumann(Nx, hx)
    Ly = laplacian_matrix_neumann(Ny, hy)
    lamx, Vx, Vx_inv = neumann_eigendecomposition(Nx, hx)
    lamy, Vy, Vy_inv = neumann_eigendecomposition(Ny, hy)
    lam = lamx[:, None] + lamy[None, :]
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                     device=device)
    return SpectralOp2D(as_t(Lx), as_t(Ly), as_t(Vx), as_t(Vy),
                        as_t(Vx_inv), as_t(Vy_inv), as_t(lam))


def ops_2d(op: SpectralOp2D) -> Ops2D:
    c = lambda t: t.T.contiguous()
    return Ops2D(op.Lx, c(op.Ly), op.Vx_inv, c(op.Vy_inv), op.Vx, c(op.Vy),
                 op.lam)


def as_grid(op):
    """The grid of `op`: `op` itself where it is a grid (it has `lap`), the
    LocalGrid of an Ops2D, or of vch_tpu's SpectralOp2D through ops_2d."""
    if hasattr(op, "lap"):
        return op
    if isinstance(op, Ops2D):
        return LocalGrid(op)
    if isinstance(op, SpectralOp2D):
        return LocalGrid(ops_2d(op))
    raise TypeError(f"expected a SpectralOp2D, an Ops2D or a grid, got "
                    f"{type(op).__name__}")


def to_spectral(op: SpectralOp2D, v: torch.Tensor) -> torch.Tensor:
    """Analysis transform: vhat = Vx^{-1} v Vy^{-T}."""
    return torch.matmul(torch.matmul(op.Vx_inv, v), op.Vy_inv.T)


def from_spectral(op: SpectralOp2D, vhat: torch.Tensor) -> torch.Tensor:
    """Synthesis transform: v = Vx vhat Vy^T."""
    return torch.matmul(torch.matmul(op.Vx, vhat), op.Vy.T)


def spectral_poly_solve(op: SpectralOp2D, denom_of_lam: Callable,
                        rhs: torch.Tensor) -> torch.Tensor:
    """Exactly solve P v = rhs where P = poly(L) is diagonal in the cosine
    basis; denom_of_lam maps the eigenvalue grid lam to the symbol of P."""
    return from_spectral(op, to_spectral(op, rhs) / denom_of_lam(op.lam))


def _full_dot(a, c):
    return torch.sum(a * c)


def member_dot(a, c):
    """Inner product over the last two axes, kept as (..., 1, 1): one value
    per member of a batch of fields."""
    return torch.sum(a * c, dim=(-2, -1), keepdim=True)


def member_dot_1d(a, c):
    """Inner product over the last axis, kept as (..., 1): one value per
    member of a batch of 1D fields."""
    return torch.sum(a * c, dim=-1, keepdim=True)


def _eps_div(dtype) -> float:
    return 1e-300 if dtype == torch.float64 else 1e-30


def _eps_mach(dtype) -> float:
    return 2.2e-16 if dtype == torch.float64 else 1.2e-7


def bicgstab(apply_A: Callable, b: torch.Tensor, apply_M: Callable,
             tol: float, max_iter: int, x0: Optional[torch.Tensor] = None,
             dot_fn: Optional[Callable] = None) -> torch.Tensor:
    """Right-preconditioned BiCGStab to ||r|| <= tol ||b|| or max_iter trips
    (vch_tpu/ops/linsolve.py:88). The loop test runs on the host, one sync
    per trip. With a per-member dot_fn, members that reach the tolerance
    freeze while the others go on, as vmap of vch_tpu's while_loop does."""
    dot = dot_fn or _full_dot
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - apply_A(x)
    rhat = r
    atol2 = (tol * torch.clamp(torch.sqrt(dot(b, b)), min=1e-300)) ** 2
    eps_div = _eps_div(b.dtype)
    p = v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    rr = dot(r, r)
    for _ in range(max_iter):
        active = rr > atol2
        if not bool(active.any()):
            break
        rho_new = dot(rhat, r)
        beta = (rho_new / (rho + eps_div)) * (alpha / (omega + eps_div))
        p_n = r + beta * (p - omega * v)
        phat = apply_M(p_n)
        v_n = apply_A(phat)
        alpha_n = rho_new / (dot(rhat, v_n) + eps_div)
        s = r - alpha_n * v_n
        shat = apply_M(s)
        t = apply_A(shat)
        omega_n = dot(t, s) / (dot(t, t) + eps_div)
        x_n = x + alpha_n * phat + omega_n * shat
        r_n = s - omega_n * t
        rr_n = dot(r_n, r_n)
        sel = lambda new, old: torch.where(active, new, old)
        x, r, p, v = sel(x_n, x), sel(r_n, r), sel(p_n, p), sel(v_n, v)
        rho, alpha = sel(rho_new, rho), sel(alpha_n, alpha)
        omega, rr = sel(omega_n, omega), sel(rr_n, rr)
    return x


def bicgstab_fixed(apply_A: Callable, b: torch.Tensor, apply_M: Callable,
                   n_iter: int, x0: Optional[torch.Tensor] = None,
                   dot_fn: Optional[Callable] = None,
                   eps_div: Optional[float] = None) -> torch.Tensor:
    """Fixed-trip BiCGStab without host syncs (vch_tpu/ops/linsolve.py:161):
    a trip whose residual is at the noise floor (50 eps)^2 max(||b||^2,
    eps_div) or whose new residual is not finite changes nothing, and the
    best iterate is returned. eps_div defaults to vch_tpu's per-dtype value;
    the per-solve kernels' plain versions pass the Pallas kernels' 1e-30."""
    return bicgstab_fixed_trips(apply_A, b, apply_M, n_iter, x0, dot_fn,
                                eps_div)[0]


def bicgstab_fixed_trips(apply_A: Callable, b: torch.Tensor,
                         apply_M: Callable, n_iter: int,
                         x0: Optional[torch.Tensor] = None,
                         dot_fn: Optional[Callable] = None,
                         eps_div: Optional[float] = None):
    """bicgstab_fixed, also returning the trips run, one count per dot_fn
    value, by a solver that leaves the loop at a frozen trip or after a
    rejected one, as the CUDA kernels do: such a trip repeats unchanged
    until the trip budget ends."""
    dot = dot_fn or _full_dot
    eps_div = _eps_div(b.dtype) if eps_div is None else eps_div
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - apply_A(x)
    rhat = r
    floor2 = (50.0 * _eps_mach(b.dtype)) ** 2 * torch.clamp(dot(b, b),
                                                            min=eps_div)
    p = v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    best_x, best_r2 = x, dot(r, r)
    running = torch.ones_like(best_r2, dtype=torch.bool)
    trips = torch.zeros_like(best_r2, dtype=torch.int32)
    for _ in range(n_iter):
        active = dot(r, r) > floor2
        running = running & active
        trips = trips + running.to(torch.int32)
        rho_new = dot(rhat, r)
        beta = (rho_new / (rho + eps_div)) * (alpha / (omega + eps_div))
        p_n = r + beta * (p - omega * v)
        phat = apply_M(p_n)
        v_n = apply_A(phat)
        alpha_n = rho_new / (dot(rhat, v_n) + eps_div)
        s = r - alpha_n * v_n
        shat = apply_M(s)
        t = apply_A(shat)
        omega_n = dot(t, s) / (dot(t, t) + eps_div)
        x_n = x + alpha_n * phat + omega_n * shat
        r_n = s - omega_n * t
        r2_n = dot(r_n, r_n)
        ok = active & torch.isfinite(r2_n)
        running = running & ok
        better = ok & (r2_n < best_r2)
        best_x = torch.where(better, x_n, best_x)
        best_r2 = torch.where(better, r2_n, best_r2)
        sel = lambda new, old: torch.where(ok, new, old)
        x, r, p, v = sel(x_n, x), sel(r_n, r), sel(p_n, p), sel(v_n, v)
        rho, alpha, omega = sel(rho_new, rho), sel(alpha_n, alpha), \
            sel(omega_n, omega)
    return best_x, trips


def bicgstab_split(apply_A: Callable, b: torch.Tensor, apply_Phalf: Callable,
                   apply_Phalf_inv: Callable, tol: float, max_iter: int,
                   x0: Optional[torch.Tensor] = None,
                   dot_fn: Optional[Callable] = None) -> torch.Tensor:
    """BiCGStab on the split-preconditioned system P^-1/2 A P^-1/2
    (vch_tpu/ops/linsolve.py:223): the raw adjoint operator has condition
    ~1e6, and conditioning it before Krylov sees it keeps float32 iterates
    O(1). apply_Phalf ~ P^{-1/2}, apply_Phalf_inv ~ P^{1/2} (for the warm
    start). Solves A x = b; returns x = P^{-1/2} y."""
    bt = apply_Phalf(b)
    y0 = None if x0 is None else apply_Phalf_inv(x0)
    apply_At = lambda v: apply_Phalf(apply_A(apply_Phalf(v)))
    y = bicgstab(apply_At, bt, lambda v: v, tol=tol, max_iter=max_iter,
                 x0=y0, dot_fn=dot_fn)
    return apply_Phalf(y)


def bicgstab_split_fixed(apply_A: Callable, b: torch.Tensor,
                         apply_Phalf: Callable, apply_Phalf_inv: Callable,
                         n_iter: int, x0: Optional[torch.Tensor] = None,
                         dot_fn: Optional[Callable] = None,
                         eps_div: Optional[float] = None) -> torch.Tensor:
    """Fixed-trip form of bicgstab_split (vch_tpu/ops/linsolve.py:253)."""
    bt = apply_Phalf(b)
    y0 = None if x0 is None else apply_Phalf_inv(x0)
    apply_At = lambda v: apply_Phalf(apply_A(apply_Phalf(v)))
    y = bicgstab_fixed(apply_At, bt, lambda v: v, n_iter=n_iter, x0=y0,
                       dot_fn=dot_fn, eps_div=eps_div)
    return apply_Phalf(y)


class SpectralOp1D(NamedTuple):
    """Operator constants on an (N+1) grid."""

    L: torch.Tensor       # (N+1, N+1) Neumann Laplacian
    V: torch.Tensor       # cosine modes as columns
    Vinv: torch.Tensor
    lam: torch.Tensor     # (N+1,) eigenvalues


def make_spectral_op_1d(N: int, h: float, dtype=torch.float64,
                        device=None) -> SpectralOp1D:
    L = laplacian_matrix_neumann(N, h)
    lam, V, Vinv = neumann_eigendecomposition(N, h)
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                     device=device)
    return SpectralOp1D(as_t(L), as_t(V), as_t(Vinv), as_t(lam))


def newton_schur_solve_1d(L, phi, Rphi, Rmu, dt, tau: float, c1: float,
                          kappa: float, delta_sep: float):
    """The 1D Newton step (dphi, dmu) by the exact dense Schur solve
    (vch_tpu/ops/linsolve.py:278), one (N+1) system per member of
    phi[..., N+1]: S dphi = L Rphi - Rmu. A singular or non-finite system
    gives a non-finite step, not an error, as jnp.linalg.solve does."""
    n = phi.shape[-1]
    d = 2.0 * c1 / (1.0 - phi * phi)
    I = torch.eye(n, dtype=phi.dtype, device=phi.device)
    S = ((1.0 / dt) * I + (0.5 * kappa) * (L @ L) - (tau / dt) * L
         - L * d[..., None, :])
    rhs = torch.matmul(Rphi, L.T) - Rmu
    dphi = torch.linalg.solve_ex(S, rhs[..., None])[0][..., 0]
    Kpp_dphi = (-(0.5 * kappa) * torch.matmul(dphi, L.T)
                + (tau / dt + d) * dphi)
    dmu = 2.0 * (Kpp_dphi + Rphi)
    return dphi, dmu


def newton_schur_solve_1d_spectral(op: SpectralOp1D, phi, Rphi, Rmu, dt,
                                   tau: float, c1: float, kappa: float,
                                   delta_sep: float, tol: float = 1e-9,
                                   max_iter: int = 100,
                                   fixed_iters: Optional[int] = None):
    """The same step by raw-basis BiCGStab with the cosine-diagonal
    preconditioner (d replaced by its mean), per member of phi[..., N+1]
    (vch_tpu/ops/linsolve.py:317): fixed_iters trips of `bicgstab_fixed`,
    or the adaptive `bicgstab`."""
    LT, VinvT, VT = op.L.T, op.Vinv.T, op.V.T
    mm = torch.matmul
    d = 2.0 * c1 / (1.0 - phi * phi)
    dbar = torch.mean(d, dim=-1, keepdim=True)
    lap = lambda v: mm(v, LT)

    def apply_S(v):
        u = (tau / dt + d) * v - 0.5 * kappa * lap(v)
        return (1.0 / dt) * v - lap(u)

    denom = (1.0 / dt) + 0.5 * kappa * op.lam ** 2 - (tau / dt + dbar) * op.lam

    def apply_M(v):
        return mm(mm(v, VinvT) / denom, VT)

    rhs = lap(Rphi) - Rmu
    if fixed_iters is not None:
        dphi = bicgstab_fixed(apply_S, rhs, apply_M, n_iter=fixed_iters,
                              dot_fn=member_dot_1d)
    else:
        dphi = bicgstab(apply_S, rhs, apply_M, tol=tol, max_iter=max_iter,
                        dot_fn=member_dot_1d)
    Kpp_dphi = -(0.5 * kappa) * lap(dphi) + (tau / dt + d) * dphi
    dmu = 2.0 * (Kpp_dphi + Rphi)
    return dphi, dmu


def newton_schur_solve_2d(op, phi, Rphi, Rmu, dt, tau: float,
                          c1: float, kappa: float, delta_sep: float,
                          tol: float = 1e-9, max_iter: int = 200,
                          fixed_iters: Optional[int] = None,
                          use_pallas: bool = False,
                          pallas_variant: str = "spectral", entries=None):
    """The 2D Newton step (dphi, dmu) by the exact Schur solve
    (vch_tpu/ops/linsolve.py:361), with the reference's Jacobian clip
    phi^2 <= 1 - delta_sep^2, per member of phi (n, m) or (B, n, m).
    `op`: vch_tpu's SpectralOp2D, an Ops2D, or a grid (LocalGrid, or a
    grid-sharded solver, whose reductions and transforms are collective). Routing as vch_tpu's
    (:395-422): with use_pallas and fixed_iters, one per-solve kernel entry
    of `entries` (`schur_spectral` or, for pallas_variant "raw",
    `schur_raw`; an ops.march.Entries), which launches the CUDA kernel on
    CUDA tensors and runs its plain version on CPU tensors; else the
    composed fixed-trip or adaptive BiCGStab with the cosine-diagonal
    preconditioner (d replaced by each member's mean)."""
    grid = as_grid(op)
    lam = grid.lam
    phi_sq = torch.clamp(phi * phi, 0.0, 1.0 - delta_sep * delta_sep)
    d = 2.0 * c1 / (1.0 - phi_sq)
    dbar = grid.mean(d)
    lap = grid.lap

    def apply_S(v):
        u = (tau / dt + d) * v - 0.5 * kappa * lap(v)
        return (1.0 / dt) * v - lap(u)

    denom = (1.0 / dt) + 0.5 * kappa * lam ** 2 - (tau / dt + dbar) * lam

    def apply_M(v):
        return grid.from_spec(grid.to_spec(v) / denom)

    rhs = lap(Rphi) - Rmu
    if use_pallas and fixed_iters is not None:
        Lx, LyT, Vxi, VyiT, Vx, VyT, _ = grid.ops
        if pallas_variant == "spectral":
            dphi = entries.schur_spectral(
                Vxi, VyiT, Vx, VyT, lam, denom, d, rhs, 1.0 / dt, tau / dt,
                0.5 * kappa, n_iter=fixed_iters)
        else:
            dphi = entries.schur_raw(
                Lx, LyT, Vxi, VyiT, Vx, VyT, denom, d, rhs, 1.0 / dt,
                tau / dt, 0.5 * kappa, n_iter=fixed_iters)
    elif fixed_iters is not None:
        dphi = bicgstab_fixed(apply_S, rhs, apply_M, n_iter=fixed_iters,
                              dot_fn=grid.dot)
    else:
        dphi = bicgstab(apply_S, rhs, apply_M, tol=tol, max_iter=max_iter,
                        dot_fn=grid.dot)
    Kpp_dphi = -(0.5 * kappa) * lap(dphi) + (tau / dt + d) * dphi
    dmu = 2.0 * (Kpp_dphi + Rphi)
    return dphi, dmu
