"""The kernels of the batched PGD paths: the whole 2D forward march and the
whole 2D adjoint sweep, their member-blocked forms and their K-step segment
forms, and the whole batched 1D forward march (counterpart of
vch_tpu/ops/pallas_march.py); and `Entries`, the table of every kernel
entry point a solver calls, per-solve kernels of ops.solve_kernels included.

Each wrapper routes by the tensors' device: on CUDA tensors it launches the
hand-written kernels of `csrc/march2d_blocked.cu`,
`csrc/adjoint2d_cluster.cu` and `csrc/march1d.cu` (float32 only; anything
else raises), on CPU tensors it runs its plain PyTorch version
`<name>_plain` of this module. There is no fallback from one to the other.
Each wrapper counts its kernel launches in `.launches`. The whole, blocked
and segment marches run on the cluster kernel of `csrc/march2d_blocked.cu`;
`_march_fused_2d_cta` and `_march_fused_2d_segment_cta` keep the one-CTA
kernels of `csrc/march2d.cu` as their bit oracles. The whole, blocked and
segment sweeps run on the cluster kernel of `csrc/adjoint2d_cluster.cu`;
`_adjoint_fused_2d_cta` and `_adjoint_fused_2d_segment_cta` keep the one-CTA
kernels of `csrc/adjoint2d.cu` as their bit oracles. Only the card tests and
chip_smoke.py call the oracles.

The plain versions walk each member's time loop in Python with that
member's own Newton / Armijo / Krylov trip counts, statement for statement
as the Pallas kernel bodies (`_march_kernel_factory`, pallas_march.py:79-390;
`_adjoint_kernel_factory`, :567-748) compute them, so they are the oracle
for both the JAX reference (tests) and the CUDA kernels (chip_smoke.py).
Scalar arithmetic stays in the field dtype (0-d tensors); Python control
flow reads the CTA-uniform predicates the kernels branch on. The blocked
plain versions run the per-member ones: the blocked TPU kernels compute each
member exactly as the per-member kernels do (masked lockstep,
pallas_march.py:1292-1296), which the tests hold against them.

The forward march's Krylov operator (apply_S's four products) runs at the
`solve_prec` it is given (the config's `fused_solve_precision`), as
pallas_march.py:207-214 does: "bf16x3" three single bf16 passes on the
(hi, lo) split, "default" one, anything else full precision (`_make_mm`);
on CUDA tensors the bf16 modes launch the kernel's bf16 form
(`march_bf16_kernel`, its products on mma.sync), counted in the wrapper's
`bf16_launches` too. Every other product of the march (the Laplacians,
the right-hand side's transform to_s and dphi's from_s) runs at the
`fwd_mm` it is given, as pallas_march.py:132 `mm = _make_mm(dt_, fwd_mm)`
does: "bf16x3" the three passes, anything else ("default" included) full
precision (`fwd_passes`); at "bf16x3" apply_S inherits the three passes
where its own solve precision has none (`krylov_passes`). No vch_tpu path
sets fwd_mm, so no solver passes it. On CUDA tensors "bf16x3" launches the
kernel's fwd_mm form (`march_fwd16_kernel`, every product on mma.sync),
counted in `bf16_launches` and `fwd16_launches`.
The adjoint sweep's Krylov operator (apply_At's four products) runs at the
`solve_prec` it is given (the config's `adjoint_solve_precision`), as
pallas_march.py:677 does: "bf16x3" the three passes, anything else full
precision (`sweep_passes`: there is no one-pass sweep); on CUDA tensors
"bf16x3" launches the sweep kernel's bf16 form (`adjoint_bf16_kernel`),
counted in `bf16_launches` too. bt, y0, p_n, the Laplacians and the
terminal solve stay full precision.

One exactness-preserving change to the fixed-trip BiCGStab: the Pallas body
masks a trip whose residual is at the noise floor or non-finite, and such a
trip repeats identically until the trip budget ends, so both the plain
versions and the kernels leave the loop there instead.
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Callable, NamedTuple

import torch

from vch_tpu_torch.ops import _build
from vch_tpu_torch.ops import probe_kernels as pk
from vch_tpu_torch.ops import solve_kernels as sk
from vch_tpu_torch.ops.laplacian import apply_laplacian_2d_t
from vch_tpu_torch.ops.potential import fpp_log, regularized_log

EPS_DIV = 1e-30
_ARMIJO_ETA = 1e-4
_ARMIJO_MAX = 12
_FPP_EPS = 1e-8


def _eps_mach(dtype) -> float:
    # pallas_march.py:421 — the noise-floor freeze is (50 eps)^2 ||b||^2
    return 2.2e-16 if dtype == torch.float64 else 1.2e-7


def _dot(a, b):
    return torch.sum(a * b)


# products per element of the Krylov solve's operator (apply_S) by
# `fused_solve_precision`: three bf16 passes, one, or (0) full precision
SOLVE_PASSES = {"bf16x3": 3, "default": 1}


def solve_passes(solve_prec) -> int:
    """bf16 passes of apply_S's products for a `fused_solve_precision`
    (pallas_march.py:207-214): 3 for "bf16x3", 1 for "default", 0 (full
    precision) for None, "highest" or any other string."""
    return SOLVE_PASSES.get(solve_prec, 0)


def fwd_passes(fwd_mm) -> int:
    """bf16 passes of the march's other products (the Laplacians, the
    right-hand side's transform and its inverse) for a `fwd_mm`
    (pallas_march.py:54 `_make_mm`): 3 for "bf16x3", 0 (full precision)
    for anything else, "default" and None included: vch_tpu's `_make_mm`
    knows no one-pass product. The plain march and the fwd_mm kernel also
    take one pass, which only a test reaches, by replacing this function: a
    control that their accuracy gates must fail."""
    return 3 if fwd_mm == "bf16x3" else 0


def krylov_passes(solve_prec, fwd_mm) -> int:
    """bf16 passes of apply_S's products: `solve_passes(solve_prec)`, or
    where that is 0 the march's own (`fwd_passes(fwd_mm)`), as
    pallas_march.py:207-214 sets `mm_s = mm` for any other solve
    precision."""
    return solve_passes(solve_prec) or fwd_passes(fwd_mm)


def sweep_passes(solve_prec) -> int:
    """bf16 passes of the adjoint sweep's apply_At products for an
    `adjoint_solve_precision` (pallas_march.py:677): 3 for "bf16x3", 0
    (full precision) for anything else, "default" included: vch_tpu offers
    no one-pass sweep (its docstring, :581-589). The bf16 kernel also takes
    one pass, which only a test reaches, by replacing this function: a
    control that its accuracy gates must fail."""
    return 3 if solve_prec == "bf16x3" else 0


def _bf16_split(a):
    """a's round-to-nearest-even bf16 (hi, lo) split, a - hi rounded,
    both as a's dtype."""
    hi = a.to(torch.bfloat16).to(a.dtype)
    return hi, (a - hi).to(torch.bfloat16).to(a.dtype)


def _make_mm(dtype, mode):
    """The product of apply_S at `mode` (pallas_march.py:47-75 `_make_mm`):
    "bf16x3" splits both operands into round-to-nearest-even bf16 (hi, lo)
    and returns d0 + (d1 + d2) of the three single-pass products hi hi,
    lo hi, hi lo, each accumulated in `dtype`; "default" the one pass
    bf16(a) bf16(c); any other mode torch.matmul in `dtype`."""
    return _passes_mm(dtype, solve_passes(mode))


def _passes_mm(dtype, passes):
    """`_make_mm`'s product at 3, 1 or 0 bf16 passes. A bf16 product is
    exact in float32, so `dtype` products of bf16 values are the single
    passes. An operand may come split already (`_bf16_split`'s pair): the
    march splits its constant operators once."""
    if passes == 0:
        return torch.matmul

    def split(a):
        return a if isinstance(a, tuple) else _bf16_split(a.to(dtype))

    def mm(a, c):
        a16, ar = split(a)
        c16, cr = split(c)
        d0 = torch.matmul(a16, c16)
        if passes == 1:
            return d0
        return d0 + (torch.matmul(ar, c16) + torch.matmul(a16, cr))
    return mm


def _bicgstab_fixed(apply_A, prec, r0, x0, best_x0, floor2, n_trips):
    """Fixed-trip BiCGStab with best-iterate return and the noise-floor
    freeze (pallas_march.py:228-256 and :698-724). `prec` is the spectral
    right preconditioner of the forward Schur solve (identity for the
    split-preconditioned adjoint, whose operator is already conditioned)."""
    one = torch.ones((), dtype=r0.dtype, device=r0.device)
    x, r = x0, r0
    p = v = torch.zeros_like(r0)
    rho = alpha = omega = one
    best_x, best_r2 = best_x0, _dot(r0, r0)
    for _ in range(n_trips):
        if not bool(_dot(r, r) > floor2):
            break
        rho_new = _dot(r0, r)
        beta = (rho_new / (rho + EPS_DIV)) * (alpha / (omega + EPS_DIV))
        p = r + beta * (p - omega * v)
        phat = prec(p)
        v = apply_A(phat)
        alpha_n = rho_new / (_dot(r0, v) + EPS_DIV)
        s = r - alpha_n * v
        shat = prec(s)
        t = apply_A(shat)
        omega_n = _dot(t, s) / (_dot(t, t) + EPS_DIV)
        x = x + alpha_n * phat + omega_n * shat
        r = s - omega_n * t
        r2_n = _dot(r, r)
        if not bool(torch.isfinite(r2_n)):
            break
        rho, alpha, omega = rho_new, alpha_n, omega_n
        if bool(r2_n < best_r2):
            best_x, best_r2 = x, r2_n
    return best_x


# --------------------------------------------------------------------------
# forward march


def _march_member(dts, phi0, u, ops, k, carry=None):
    """One member's march over len(dts) steps. `carry` is the segment
    carry (mu0, w0, m0); None starts from phi0 (w0 = 0, mu0 from phi0, m0
    its mass). Returns (post-step frames, nsolve, first_bad, (phi, mu, w)
    after the last step)."""
    Lx, LyT, Vxi, VyiT, Vx, VyT, lam, wts = ops
    fwd = fwd_passes(k.get("fwd_mm", "highest"))
    krylov = krylov_passes(k.get("solve_prec", "highest"),
                           k.get("fwd_mm", "highest"))
    mm, mm_s = _passes_mm(phi0.dtype, fwd), _passes_mm(phi0.dtype, krylov)
    # the constant operators, split once where their products run in bf16
    cut = lambda o, passes: _bf16_split(o) if passes else o
    Sx, SyT, Sxi, SyiT = (cut(o, krylov) for o in (Vx, VyT, Vxi, VyiT))
    Fx, FyT, Fxi, FyiT, FLx, FLyT = (cut(o, fwd) for o in (
        Vx, VyT, Vxi, VyiT, Lx, LyT))
    tau, c1, c2, kappa, gamma = k["tau"], k["c1"], k["c2"], k["kappa"], k["gamma"]
    delta_sep = k["delta_sep"]
    lo, hi = -1.0 + delta_sep, 1.0 - delta_sep
    dsep2 = 1.0 - delta_sep * delta_sep
    eps_mach = _eps_mach(phi0.dtype)

    def to_s(v):
        return mm(mm(Fxi, v), FyiT)

    def from_s(vh):
        return mm(mm(Fx, vh), FyT)

    def lap(v):
        # at fwd_mm "bf16x3" each product rounded, then added
        # (pallas_march.py:140-144)
        if fwd:
            return mm(FLx, v) + mm(v, FLyT)
        return apply_laplacian_2d_t(Lx, LyT, v)

    def f_log(phi):
        return regularized_log(phi, delta_sep)

    phi_old = phi0
    if carry is None:
        w_old = torch.zeros_like(phi0)
        mu_old = -kappa * lap(phi0) + c1 * f_log(phi0) - 2.0 * c2 * phi0
        m0 = torch.sum(wts * phi0)
    else:
        mu_old, w_old, m0 = carry
    frames, nsolve, first_bad = [], 0, -1

    for step in range(dts.shape[0]):
        dt = dts[step]
        inv_dt = 1.0 / dt
        tau_dt = tau * inv_dt
        gamma_dt = gamma * inv_dt
        w_new = (((gamma_dt - 0.5) * w_old + 0.5 * (u[step + 1] + u[step]))
                 / (gamma_dt + 0.5))
        lap_mu_old = lap(mu_old)
        lap_phi_old = lap(phi_old)
        mu_init = (-kappa * lap_phi_old + c1 * f_log(phi_old)
                   - 2.0 * c2 * phi_old - w_new)
        f_ccv = -2.0 * c2 * phi_old
        w_avg = 0.5 * (w_new + w_old)

        def resid(phi, mu):
            lap_mu = lap(mu)
            lap_phi = lap(phi)
            Rmu = (phi - phi_old) * inv_dt - 0.5 * (lap_mu + lap_mu_old)
            Rphi = (tau * inv_dt * (phi - phi_old)
                    - 0.5 * kappa * (lap_phi + lap_phi_old)
                    + c1 * f_log(phi) + f_ccv
                    - 0.5 * (mu + mu_old) - w_avg)
            norm = torch.sqrt(torch.sum(Rphi * Rphi) + torch.sum(Rmu * Rmu))
            return norm, Rphi, Rmu

        def schur_solve(phi, Rphi, Rmu):
            phi_sq = torch.clamp(phi * phi, 0.0, dsep2)
            d = 2.0 * c1 / (1.0 - phi_sq)
            dbar = torch.mean(d)
            poly = inv_dt - tau_dt * lam + 0.5 * kappa * lam * lam
            denom = poly - dbar * lam

            def apply_S(yh):
                return poly * yh - lam * mm_s(
                    mm_s(Sxi, d * mm_s(mm_s(Sx, yh), SyT)), SyiT)

            bvec = to_s(lap(Rphi) - Rmu)
            floor2 = ((50.0 * eps_mach) ** 2
                      * torch.clamp(_dot(bvec, bvec), min=EPS_DIV))
            z = torch.zeros_like(bvec)
            best_x = _bicgstab_fixed(apply_S, lambda v: v / denom, bvec, z, z,
                                     floor2, k["n_trips"])
            dphi = from_s(best_x)
            Kpp_dphi = -(0.5 * kappa) * lap(dphi) + (tau_dt + d) * dphi
            dmu = 2.0 * (Kpp_dphi + Rphi)
            return dphi, dmu

        def step_ceiling(phi, dphi):
            inf = torch.full_like(phi, math.inf)
            ratio_pos = torch.where(dphi > 0, (hi - phi) / dphi, inf)
            ratio_neg = torch.where(dphi < 0, (lo - phi) / dphi, inf)
            amax = torch.clamp(torch.minimum(0.9 * torch.min(ratio_pos),
                                             0.9 * torch.min(ratio_neg)),
                               max=2.0)
            if not bool(torch.isfinite(amax)) or bool(amax <= 0):
                amax = torch.ones_like(amax)
            return torch.clamp(amax, max=1.0)

        def armijo(phi, mu, dphi, dmu, norm_R, Rphi, Rmu):
            # accept / best-trial fallback / unchanged; every exit hands the
            # residual of the returned iterate to the next Newton iteration
            alpha = step_ceiling(phi, dphi)
            best, best_norm = None, math.inf
            for _ in range(_ARMIJO_MAX):
                phi_t = phi + alpha * dphi
                mu_t = mu + alpha * dmu
                norm_t, Rp_t, Rm_t = resid(phi_t, mu_t)
                trial = (phi_t, mu_t, norm_t, Rp_t, Rm_t)
                if bool(norm_t < best_norm):
                    best, best_norm = trial, norm_t
                if bool(norm_t <= (1.0 - _ARMIJO_ETA * alpha) * norm_R):
                    return trial
                alpha = alpha * 0.5
            if best is not None and bool(best_norm < norm_R):
                return best
            return phi, mu, norm_R, Rphi, Rmu

        # Newton: this member's own trip count (pallas_march.py:322-360)
        phi, mu = phi_old, mu_init
        norm0 = prev_norm = None
        carried = None
        it = 0
        while it < k["newton_max_iter"]:
            if it == 0:
                norm_R, Rphi, Rmu = resid(phi, mu)
                norm0 = norm_R
            else:
                norm_R, Rphi, Rmu = carried
            conv = bool(norm_R < k["newton_tol"])
            if k["newton_rtol"] > 0:
                conv = conv or bool(norm_R < k["newton_rtol"] * norm0)
            if k["stagnation_exit"] and it > 0:
                conv = conv or bool(norm_R >= prev_norm)
            if conv:
                break
            dphi, dmu = schur_solve(phi, Rphi, Rmu)
            phi, mu, nR, Rp, Rm = armijo(phi, mu, dphi, dmu, norm_R, Rphi,
                                         Rmu)
            carried = (nR, Rp, Rm)
            prev_norm = norm_R
            nsolve += 1
            it += 1

        # clip + interior mass correction + sanitizer (pallas_march.py:362-388)
        phi_c = torch.clamp(phi, lo, hi)
        mass_error = torch.sum(wts * phi_c) - m0
        interior = torch.abs(phi_c) < (1.0 - delta_sep - 5e-3)
        Wint = torch.sum(torch.where(interior, wts, torch.zeros_like(wts)))
        if bool(torch.abs(mass_error) > 1e-16):
            if bool(Wint > 0):
                phi_c = torch.where(interior, phi_c - mass_error / Wint, phi_c)
            else:
                phi_c = torch.clamp(phi_c - mass_error / k["area"], lo, hi)
        if not bool(torch.isfinite(mass_error)) and first_bad < 0:
            first_bad = step
        frames.append(phi_c)
        phi_old, mu_old, w_old = phi_c, mu, w_new
    return frames, nsolve, first_bad, (phi_old, mu_old, w_old)


def _int32(values, device):
    return torch.tensor(values, dtype=torch.int32, device=device)


def march_fused_2d_plain(dts, phi0, u, Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT,
                         lam, wts, active=None, **k):
    """Plain PyTorch version of the forward-march kernel (any device,
    float32 or float64). Arguments as `march_fused_2d`; an inactive member
    gets a hist of zeros, nsolve 0 and first_bad -1."""
    ops = (Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, lam, wts)
    flags = ([True] * phi0.shape[0] if active is None
             else [bool(f) for f in active.tolist()])
    hist, ns, bad = [], [], []
    for b in range(phi0.shape[0]):
        if not flags[b]:
            hist.append(torch.zeros_like(u[b]))
            ns.append(0)
            bad.append(-1)
            continue
        frames, nsolve, first_bad, _ = _march_member(dts, phi0[b], u[b], ops,
                                                     k)
        hist.append(torch.stack([phi0[b]] + frames))
        ns.append(nsolve)
        bad.append(first_bad)
    return torch.stack(hist), _int32(ns, phi0.device), _int32(bad, phi0.device)


def _check_block(B: int, block_b: int):
    if block_b <= 0 or B % block_b:
        raise ValueError(f"the member-blocked kernels need B % block_b == 0 "
                         f"(B={B}, block_b={block_b})")


def _refuse_prec(name: str, k):
    """The one-CTA oracles of the march and the sweep compute every product
    in full float32: any other solve precision, and any fwd_mm with bf16
    passes, raises, never falls back."""
    if k["solve_prec"] not in (None, "highest"):
        raise ValueError(f"{name} computes its Krylov operator in full "
                         f"float32 only (solve_prec 'highest'), got "
                         f"{k['solve_prec']!r}")
    if fwd_passes(k.get("fwd_mm")):
        raise ValueError(f"{name} computes the march's products in full "
                         f"float32 only (fwd_mm 'highest'), got "
                         f"{k['fwd_mm']!r}")


def _refuse_active(name: str, active):
    """Only the one-member whole march skips members: every other march
    raises when given the flag, never ignores it."""
    if active is not None:
        raise ValueError(f"{name} takes no active flag: only the one-member "
                         f"whole march (march_fused_2d) skips members")


def march_fused_2d_blocked_plain(dts, phi0, u, Lx, LyT, Vx_inv, Vy_inv_T, Vx,
                                 VyT, lam, wts, *, block_b: int, active=None,
                                 **k):
    """Plain PyTorch version of the member-blocked march: per member, the
    same computation as `march_fused_2d_plain`."""
    _refuse_active("march_fused_2d_blocked_plain", active)
    _check_block(phi0.shape[0], block_b)
    return march_fused_2d_plain(dts, phi0, u, Lx, LyT, Vx_inv, Vy_inv_T, Vx,
                                VyT, lam, wts, **k)


def march_fused_2d_segment_plain(dts, phi0, mu0, w0, m0, u, Lx, LyT, Vx_inv,
                                 Vy_inv_T, Vx, VyT, lam, wts, active=None,
                                 **k):
    """Plain PyTorch version of the segment march. Arguments as
    `march_fused_2d_segment`."""
    _refuse_active("march_fused_2d_segment_plain", active)
    ops = (Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, lam, wts)
    hist, fin, ns, bad = [], [], [], []
    for b in range(phi0.shape[0]):
        frames, nsolve, first_bad, last = _march_member(
            dts, phi0[b], u[b], ops, k, carry=(mu0[b], w0[b], m0[b]))
        hist.append(torch.stack(frames))
        fin.append(last)
        ns.append(nsolve)
        bad.append(first_bad)
    phi_f, mu_f, w_f = (torch.stack([f[i] for f in fin]) for i in range(3))
    return (torch.stack(hist), phi_f, mu_f, w_f, _int32(ns, phi0.device),
            _int32(bad, phi0.device))


def _fwd_consts(k):
    """Kernel constants, each formed in double precision the way the Pallas
    kernel forms it from Python floats, then rounded to float32."""
    ds = k["delta_sep"]
    log_eps = max(1e-8, 0.5 * ds)
    vals = [k["tau"], k["c1"], 2.0 * k["c1"], 2.0 * k["c2"], -k["kappa"],
            0.5 * k["kappa"], k["gamma"], -1.0 + log_eps, 1.0 - log_eps,
            -1.0 + ds, 1.0 - ds, 1.0 - ds * ds, 1.0 - ds - 5e-3, k["area"],
            k["newton_tol"], k["newton_rtol"],
            (50.0 * _eps_mach(torch.float32)) ** 2]
    return (ctypes.c_float * len(vals))(*vals), len(vals)


def _op_shapes(n, m, with_wts=True):
    names = ("Lx", "LyT", "Vx_inv", "Vy_inv_T", "Vx", "VyT", "lam", "wts")
    shapes = ((n, n), (m, m), (n, n), (m, m), (n, n), (m, m), (n, m), (n, m))
    k = 8 if with_wts else 7
    return names[:k], shapes[:k]


def _march_kw(tau, c1, c2, kappa, gamma, delta_sep, area, newton_tol,
              newton_rtol, newton_max_iter, n_trips, stagnation_exit=True,
              solve_prec="highest", fwd_mm="highest"):
    return dict(tau=tau, c1=c1, c2=c2, kappa=kappa, gamma=gamma,
                delta_sep=delta_sep, area=area, newton_tol=newton_tol,
                newton_rtol=newton_rtol, newton_max_iter=int(newton_max_iter),
                n_trips=int(n_trips), stagnation_exit=bool(stagnation_exit),
                solve_prec=solve_prec, fwd_mm=fwd_mm)


def _bf16_operators(Vx, Vx_inv, VyT, Vy_inv_T, Lx=None, LyT=None):
    """apply_S's four operators as the bf16 march's fragment copies, one
    buffer (csrc/march2d_blocked.cu `with_ops16`, cluster.cuh
    `product16`): Vx and Vx_inv (the LEFT products' B operands, their rows)
    then Vy and Vy_inv (the RIGHT products', the rows of VyT^T and
    Vy_inv_T^T); with Lx and LyT (the march at fwd_mm "bf16x3") then Lx
    and Ly = LyT^T, after the four so that the sweep's offsets stay; each
    padded with zeros to rows + 8 and to whole k tiles of
    16, split into round-to-nearest-even bf16 hi and lo, and laid out
    (row, k tile, t, [hi, lo], k + 8 half, pair): lane t's 16 bytes of a
    row and k tile hold hi(k 2t, 2t+1), hi(2t+8, 2t+9), lo(..), lo(..)."""
    def frag(P):
        rows, K = P.shape
        KT = -(-K // 16)
        Pp = P.new_zeros((rows + 8, 16 * KT))
        Pp[:rows, :K] = P
        hi = Pp.to(torch.bfloat16)
        lo = (Pp - hi.float()).to(torch.bfloat16)
        return (torch.stack((hi, lo)).view(2, rows + 8, KT, 2, 4, 2)
                .permute(1, 2, 4, 0, 3, 5).reshape(-1))
    laps = () if Lx is None else (frag(Lx), frag(LyT.T))
    return torch.cat((frag(Vx), frag(Vx_inv), frag(VyT.T),
                      frag(Vy_inv_T.T)) + laps)


def _solve_operands(passes, ops, fwd=0):
    """(the fragment buffer or None, the bf16 passes) of a cluster march
    or sweep launch at `passes` (`krylov_passes` or `sweep_passes` of its
    precisions); ops from Lx on; fwd: the march's `fwd_passes`, whose
    products take Lx and LyT too. The caller holds the buffer until the
    launch is enqueued (the caching allocator then reuses it only in stream
    order)."""
    if not passes:
        return None, 0
    Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT = ops[:6]
    laps = (Lx, LyT) if fwd else ()
    return _bf16_operators(Vx, Vx_inv, VyT, Vy_inv_T, *laps), passes


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_march(wrapper, args, k, members=None, active=None):
    """Check and launch the whole march: on the cluster kernel with
    `members` members per cluster (1, or 2, 4, 8: the member-blocked march)
    on the geometry of `launch_geometry`, or (None) on the one-CTA kernel of
    csrc/march2d.cu, the bit oracle. `active`: the one-member march's
    (B,) int32 flags on the device (the other wrappers refuse it). At a
    bf16 solve precision the cluster kernel's bf16 form takes apply_S's
    operators as `_bf16_operators` makes them, once per launch."""
    dts, phi0, u, *ops = args
    B, n, m = phi0.shape
    M = dts.shape[0]
    names, shapes = _op_shapes(n, m)
    _build.check_cuda([("dts", dts, (M,)), ("phi0", phi0, (B, n, m)),
                       ("u", u, (B, M + 1, n, m))]
                      + list(zip(names, ops, shapes)), phi0.device)
    dev = phi0.device
    if active is not None:
        if (active.device != dev or active.dtype != torch.int32
                or tuple(active.shape) != (B,) or not active.is_contiguous()):
            raise ValueError(f"active must be a contiguous ({B},) int32 "
                             f"tensor on {dev}, got {tuple(active.shape)} "
                             f"{active.dtype} on {active.device}")
    fwd = fwd_passes(k["fwd_mm"])
    ops16, passes = _solve_operands(
        krylov_passes(k["solve_prec"], k["fwd_mm"]), ops, fwd)
    geo = (None if members is None
           else launch_geometry(n, m, B, dev, members=members,
                                solve_passes=passes, fwd_passes=fwd))
    lib = _build.load()
    hist = torch.empty((B, M + 1, n, m), dtype=torch.float32, device=dev)
    nsolve = torch.empty((B,), dtype=torch.int32, device=dev)
    first_bad = torch.empty((B,), dtype=torch.int32, device=dev)
    work = torch.empty((B, lib.vch_workspace_fields(0), n, m),
                       dtype=torch.float32, device=dev)
    consts, nc = _fwd_consts(k)
    stream = torch.cuda.current_stream(dev).cuda_stream
    common = ([t.data_ptr() for t in args]
              + [hist.data_ptr(), nsolve.data_ptr(), first_bad.data_ptr(),
                 work.data_ptr(), B, M, n, m, consts, nc,
                 k["newton_max_iter"], k["n_trips"],
                 int(k["stagnation_exit"])])
    if geo is None:
        err = lib.vch_march_fused_2d(*common, 1, stream)
    elif members == 1:
        err = lib.vch_march_fused_2d_cluster(
            *common, geo.cluster, geo.kc, geo.smem_bytes,
            _ptr(active), _ptr(ops16), passes, fwd, stream)
    else:
        err = lib.vch_march_fused_2d_blocked(*common, members, geo.cluster,
                                             geo.kc, geo.smem_bytes,
                                             _ptr(ops16), passes, fwd,
                                             stream)
    wrapper.launches += 1
    if passes:
        wrapper.bf16_launches += 1
    if fwd:
        wrapper.fwd16_launches += 1
    _build.raise_on(lib, err, wrapper.__name__)
    return hist, nsolve, first_bad


def march_fused_2d(dts, phi0, u, Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, lam,
                   wts, *, tau: float, c1: float, c2: float, kappa: float,
                   gamma: float, delta_sep: float, area: float,
                   newton_tol: float, newton_rtol: float,
                   newton_max_iter: int, n_trips: int,
                   stagnation_exit: bool = True, solve_prec: str = "highest",
                   fwd_mm: str = "highest", active=None):
    """The whole batched 2D forward march (pallas_march.py:393). On CUDA
    tensors each member runs on a thread-block cluster (`launch_geometry`
    with one member per cluster), bit for bit what the one-CTA kernel
    `_march_fused_2d_cta` computes.

    Args:
      dts (M,), phi0 (B, n, m), u (B, M+1, n, m); Lx (n, n), LyT (m, m)
      (Ly transposed); Vx_inv, Vy_inv_T, Vx, VyT: cosine transforms;
      lam (n, m) eigenvalue grid; wts (n, m) quadrature weights * hx * hy;
      area = Lx * Ly (uniform mass-fix fallback).
      solve_prec: apply_S's precision (`solve_passes`); fwd_mm: every other
      product's (`fwd_passes`), vch_tpu's names and defaults.
      active: None (every member marches) or a (B,) int32 tensor on the
      members' device: a member whose flag is 0 is skipped, its cluster
      leaving at once (the line search's idle trial slots).
    Returns phi_hist (B, M+1, n, m) with phi0 prepended, nsolve (B,) int32
    Newton linear solves per member, first_bad (B,) int32 first step whose
    mass defect was non-finite (-1: none); an inactive member has nsolve 0,
    first_bad -1 and an unspecified history (zeros in the plain version).
    """
    k = _march_kw(tau, c1, c2, kappa, gamma, delta_sep, area, newton_tol,
                  newton_rtol, newton_max_iter, n_trips, stagnation_exit,
                  solve_prec, fwd_mm)
    args = (dts, phi0, u, Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, lam, wts)
    if not _build.on_cuda("march_fused_2d", phi0):
        return march_fused_2d_plain(*args, active=active, **k)
    return _launch_march(march_fused_2d, args, k, members=1, active=active)


march_fused_2d.launches = march_fused_2d.bf16_launches = 0
march_fused_2d.fwd16_launches = 0


def _march_fused_2d_cta(*args, active=None, **kw):
    """The one-CTA march of csrc/march2d.cu (one member per CTA; two CTAs
    per SM with field pointers formed at use where B exceeds the SMs): the
    bit oracle of `march_fused_2d` and of the blocked march, which the card
    tests and chip_smoke.py hold the cluster kernel against; no solver
    calls it. Arguments and results as `march_fused_2d`, without the flag."""
    _refuse_active("_march_fused_2d_cta", active)
    k = _march_kw(**kw)
    _refuse_prec("_march_fused_2d_cta", k)
    if not _build.on_cuda("_march_fused_2d_cta", args[1]):
        return march_fused_2d_plain(*args, **k)
    return _launch_march(_march_fused_2d_cta, args, k)


_march_fused_2d_cta.launches = 0


# The cluster march and sweep (csrc/march2d_blocked.cu,
# csrc/adjoint2d_cluster.cu): the kernels check these
# numbers against their own.
BLOCK_MEMBERS = 8          # members per block of the blocked march by default
BLOCK_SIZES = (2, 4, 8)    # the blocks the blocked march and sweep are
                           # built for
SEGMENT_MEMBERS = 1        # members per cluster of the segment march
BLOCKED_SMEM_LIMIT = 232_448 - 4096   # dynamic shared memory per CTA: an
                                      # H100's 232,448 bytes less the
                                      # kernel's static control block
_BLOCKED_UNITS = 3 * 256   # 4 x 4 output units of one pass: 3 per thread
_BLOCKED_KC = (32, 16, 8, 4)   # k rows per ring stage, the largest that fits


class BlockedGeometry(NamedTuple):
    """How a block of `members` members (8, 4 or 2 for the blocked march, 1
    for the whole and the segment march) is split over a thread-block
    cluster: `bands` holds each rank's (first row, rows) of every member's
    field, in rank order; bands
    are stored `rows_pad` rows of `m_pad` floats apart in the ring; a
    product of the block has `units` 4 x 4 output units, run in `passes` of
    at most 768; its operands stream through a two-stage ring of `kc` k
    rows; `smem_bytes` is the dynamic shared memory of one CTA, with
    `solve_passes` (the march at "bf16x3": 3, "default": 1) the larger of
    the ring and the bf16 staging of its Krylov operator's products
    (`bf16_staging`), at the larger pass count where `fwd_passes` (the
    march at fwd_mm "bf16x3": 3) runs its other products on bf16 too."""
    members: int
    cluster: int
    bands: tuple
    rows_max: int
    rows_pad: int
    m_pad: int
    units: int
    passes: int
    kc: int
    smem_bytes: int
    solve_passes: int = 0
    fwd_passes: int = 0


def blocked_cluster_size(n: int, B: int, sms: int, max_cluster: int = 16,
                         members: int = BLOCK_MEMBERS) -> int:
    """CTAs per block of `members` members: the largest power of two up to
    max_cluster (16, the non-portable size; 8 is the portable one) and up to
    n whose B / members clusters fit in the card's `sms` SMs at once, at
    least 1."""
    blocks = B // members
    C = 1
    while 2 * C <= min(max_cluster, n) and blocks * 2 * C <= sms:
        C *= 2
    return C


_MARCH_NAMES = {8: "the blocked march", 4: "the blocked march",
                2: "the blocked march",
                1: "the one-member march (whole or segment march)"}
_SWEEP_NAMES = {8: "the blocked sweep", 4: "the blocked sweep",
                2: "the blocked sweep",
                1: "the one-member sweep (whole or segment sweep)"}
# the cluster kernels launch_geometry fits, each with its own register
# count, so its own residency: the march (csrc/march2d_blocked.cu) and the
# sweep (csrc/adjoint2d_cluster.cu), each with its bf16 form ("16": the
# kernel at a bf16 solve precision, its geometry the float32 form's with
# solve_passes), the march also with its fwd_mm form ("16f": every product
# on bf16, its geometry with fwd_passes too), the four per-solve kernels of
# csrc/solve2d_cluster.cu (the spectral and the raw adjoint step solve, the
# spectral and the raw Schur solve, and the raw Schur solve's two cost
# probes, which share one geometry), the float32 chain probe of
# csrc/chain_cluster.cu and the microbench probe of csrc/micro_cluster.cu;
# their names by members per cluster, and their occupancy queries
CLUSTER_KERNELS = {
    "march": (_MARCH_NAMES, "vch_march_blocked_max_clusters"),
    "march16": (_MARCH_NAMES, "vch_march16_max_clusters"),
    "march16f": (_MARCH_NAMES, "vch_march16f_max_clusters"),
    "sweep": (_SWEEP_NAMES, "vch_adjoint_cluster_max_clusters"),
    "sweep16": (_SWEEP_NAMES, "vch_adjoint16_max_clusters"),
    "solve": ({1: "the adjoint step solve"},
              "vch_solve_cluster_max_clusters"),
    "raw_solve": ({1: "the raw adjoint step solve"},
                  "vch_adjoint_raw_cluster_max_clusters"),
    "schur_solve": ({1: "the Schur solve"},
                    "vch_schur_cluster_max_clusters"),
    "raw_schur_solve": ({1: "the raw Schur solve"},
                        "vch_schur_raw_cluster_max_clusters"),
    "schur_probe": ({1: "the raw Schur solve's cost probes"},
                    "vch_schur_probe_cluster_max_clusters"),
    "chain": ({k: f"the float32 chain of {k} member{'s' * (k > 1)} per "
                  f"cluster" for k in (8, 4, 2, 1)},
              "vch_chain_cluster_max_clusters"),
    "micro": ({k: f"the microbench of {k} member{'s' * (k > 1)} per "
                  f"cluster" for k in (8, 4, 2, 1)},
              "vch_micro_cluster_max_clusters")}


def _kernel_names(kernel: str) -> dict:
    """The names of a cluster kernel's forms, by members per cluster."""
    if kernel not in CLUSTER_KERNELS:
        raise ValueError(f"kernel must be one of {tuple(CLUSTER_KERNELS)}, "
                         f"got {kernel!r}")
    return CLUSTER_KERNELS[kernel][0]


def _slab_tiles(tiles: int, most: int) -> int:
    slabs = -(-tiles // most)
    return -(-tiles // slabs)


def bf16_staging(n: int, m: int, members: int, rows_max: int,
                 passes: int) -> tuple:
    """The shared memory of the bf16 march's products (csrc/cluster.cuh
    `staging16`, which the kernel checks): the field operand staged as
    bf16 (hi, lo) at 3 passes, hi alone at 1, in slabs of 16-row M tiles
    with every k (rows 8 elements longer than a multiple of 16): a LEFT slab
    of jt_left tiles of the members' stacked columns, (16 jt_left + 8)
    mma_np(n) elements an array, a RIGHT slab of jt_right tiles of their
    stacked band rows, 16 jt_right (mma_np(m) + 8); each as wide as fits in
    BLOCKED_SMEM_LIMIT, its tiles spread evenly over the slabs. Returns
    (jt_left, jt_right, bytes of the larger), or None where not even one
    tile fits (n past 2,378 or m past 3,560 at 3 passes)."""
    arr = 2 if passes == 3 else 1
    kpn, kpm = -(-n // 16) * 16, -(-m // 16) * 16
    most_l = (BLOCKED_SMEM_LIMIT // (2 * arr * kpn) - 8) // 16
    most_r = BLOCKED_SMEM_LIMIT // (2 * arr * 16 * (kpm + 8))
    if most_l < 1 or most_r < 1:
        return None
    jl = _slab_tiles(-(-members * m // 16), most_l)
    jr = _slab_tiles(-(-members * rows_max // 16), most_r)
    return jl, jr, max(2 * arr * kpn * (16 * jl + 8),
                       2 * arr * 16 * jr * (kpm + 8))


@lru_cache(maxsize=64)
def blocked_geometry(n: int, m: int, B: int, sms: int,
                     max_cluster: int = 16, cluster: int | None = None,
                     members: int = BLOCK_MEMBERS,
                     kernel: str = "march",
                     solve_passes: int = 0,
                     fwd_passes: int = 0) -> BlockedGeometry:
    """The cluster geometry of a cluster kernel (`kernel`, one of
    CLUSTER_KERNELS, which split a block alike) for B members on an (n, m)
    grid on a card of `sms` SMs, `members` per cluster: 8, 4 or 2 for
    `march_fused_2d_blocked` and `adjoint_fused_2d_blocked`, 1 for
    `march_fused_2d`, `march_fused_2d_segment`, `adjoint_fused_2d`,
    `adjoint_fused_2d_segment`, the four cluster solves and the two cost
    probes of the raw Schur solve, 8, 4, 2 or 1
    for the float32 chain probe (`ops.probe_kernels.matmul_chain`) and the
    microbench probe (`ops.probe_kernels.blocked_microbench`, B = members:
    one cluster) (`blocked_cluster_size`; `cluster` overrides it);
    `solve_passes` (the march: `solve_passes(fused_solve_precision)`; the
    sweep: `sweep_passes(adjoint_solve_precision)`; no other kernel) adds
    the bf16 staging of its Krylov operator's products; `fwd_passes` (the
    march only: `fwd_passes(fwd_mm)`, 3) sizes that staging for the larger
    of apply_S's passes and the march's other products'.
    Raises ValueError when B is not a positive multiple of `members`, or
    when no ring, or no bf16 staging, fits in BLOCKED_SMEM_LIMIT bytes per
    CTA."""
    names = _kernel_names(kernel)
    if members not in names:
        raise ValueError(f"the cluster {kernel} is built for "
                         f"{tuple(names)} members per cluster, got "
                         f"{members}")
    what = names[members]
    if B <= 0 or B % members:
        raise ValueError(f"{what} takes B % {members} == 0, got B = {B}")
    C = blocked_cluster_size(n, B, sms, max_cluster, members) \
        if cluster is None else cluster
    if not 1 <= C <= min(16, n):
        raise ValueError(f"cluster size {C} for n = {n}")
    q, rem = divmod(n, C)
    bands = tuple((p * q + min(p, rem), q + (p < rem)) for p in range(C))
    rmax = q + (rem > 0)
    rpad, mpad = -(-rmax // 4) * 4, -(-m // 4) * 4
    units = members * (rpad // 4) * (mpad // 4)
    staging = 0
    if fwd_passes and (kernel != "march" or fwd_passes not in (1, 3)):
        raise ValueError(f"only the cluster march takes fwd passes, 3 or "
                         f"1, not the {kernel} at {fwd_passes}")
    staged = max(solve_passes, fwd_passes)
    if staged:
        if kernel + "16" not in CLUSTER_KERNELS:
            raise ValueError(f"only the cluster march and sweep take solve "
                             f"passes, not the {kernel}")
        fit = bf16_staging(n, m, members, rmax, staged)
        if fit is None:
            arr = 2 if staged == 3 else 1
            need = max(2 * arr * -(-n // 16) * 16 * 24,
                       2 * arr * 16 * (-(-m // 16) * 16 + 8))
            raise ValueError(
                f"{what} at {staged} bf16 pass(es) on an ({n}, {m}) "
                f"grid needs {need} bytes of shared memory per CTA for one "
                f"M tile of its staging (at most {BLOCKED_SMEM_LIMIT})")
        staging = fit[2]
    for kc in _BLOCKED_KC:
        smem = 4 * 2 * kc * (members * (rpad + mpad) + 4)
        if smem <= BLOCKED_SMEM_LIMIT:
            return BlockedGeometry(members, C, bands, rmax, rpad, mpad,
                                   units, -(-units // _BLOCKED_UNITS), kc,
                                   max(smem, staging), solve_passes,
                                   fwd_passes)
    raise ValueError(
        f"{what} on an ({n}, {m}) grid in clusters of {C} needs {smem} bytes "
        f"of shared memory per CTA (at most {BLOCKED_SMEM_LIMIT})")


@lru_cache(maxsize=64)
def resident_clusters(device_index, n, m, C, kc, smem,
                      members=BLOCK_MEMBERS, segment=False, kernel="march"):
    """How many clusters of a cluster kernel (`kernel`, one of
    CLUSTER_KERNELS; `members` per cluster; with segment, the segment
    march or sweep) with this geometry the card holds at once
    (cudaOccupancyMaxActiveClusters on that kernel; negative: a CUDA
    error)."""
    _kernel_names(kernel)
    with torch.cuda.device(device_index):
        query = getattr(_build.load(), CLUSTER_KERNELS[kernel][1])
        return query(members, int(segment), n, m, C, kc, smem)


def fitted_geometry(n: int, m: int, B: int, sms: int, resident,
                    members: int = BLOCK_MEMBERS,
                    kernel: str = "march",
                    solve_passes: int = 0,
                    fwd_passes: int = 0) -> BlockedGeometry:
    """`blocked_geometry` on `sms` SMs, made smaller where the card cannot
    hold all B / members clusters at once (`resident(geo)`: how many
    clusters of that geometry it holds): eight members per cluster first
    take clusters of 8 in place of 16; then the cluster shrinks one CTA at a
    time down to the largest whose clusters are all resident at once (or
    1). On the H100 at 257 x 257 with one member that is 3 CTAs at B = 32:
    it holds only 30 clusters of 4, which then ran in two waves (58.6
    against 35.8 ms a segment); with eight members at 65 x 65, B = 128 it
    is 6 (161.7 against 97.5 ms a march), at B = 256 3 (224.3 against
    187.4; PERF.md)."""
    passes = dict(kernel=kernel, solve_passes=solve_passes,
                  fwd_passes=fwd_passes)
    geo = blocked_geometry(n, m, B, sms, members=members, **passes)
    clusters = B // members
    if (members == BLOCK_MEMBERS and geo.cluster > 8
            and resident(geo) < clusters):
        geo = blocked_geometry(n, m, B, sms, max_cluster=8, members=members,
                               **passes)
    while geo.cluster > 1 and resident(geo) < clusters:
        geo = blocked_geometry(n, m, B, sms, cluster=geo.cluster - 1,
                               members=members, **passes)
    return geo


def launch_geometry(n: int, m: int, B: int, device,
                    members: int = BLOCK_MEMBERS, segment: bool = False,
                    kernel: str = "march", solve_passes: int = 0,
                    fwd_passes: int = 0) -> BlockedGeometry:
    """The geometry the cluster march, sweep or solve (`kernel`; with
    segment, the segment march or sweep; the march or sweep with
    solve_passes, its bf16 kernel; the march with fwd_passes too, its
    fwd_mm kernel) launches on this card for B members,
    `members` per cluster: `fitted_geometry` on its SM count and on
    cudaOccupancyMaxActiveClusters of that kernel (the kernels take their
    own registers, so a geometry fitted to one would over-commit another).
    Raises RuntimeError if no cluster of it fits on the card."""
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(idx).multi_processor_count
    # whose occupancy
    held = kernel + ("16f" if fwd_passes else "16" if solve_passes else "")
    resident = lambda g: resident_clusters(idx, n, m, g.cluster, g.kc,
                                           g.smem_bytes, members, segment,
                                           held)
    geo = fitted_geometry(n, m, B, sms, resident, members, kernel,
                          solve_passes, fwd_passes)
    fit = resident(geo)
    if fit <= 0:
        raise RuntimeError(
            f"{_kernel_names(kernel)[members]}: a cluster of {geo.cluster} "
            f"CTAs with {geo.smem_bytes} bytes of dynamic shared memory each "
            f"does not fit on this card (cudaOccupancyMaxActiveClusters: "
            f"{fit})")
    return geo


def march_fused_2d_blocked(dts, phi0, u, Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT,
                           lam, wts, *, tau: float, c1: float, c2: float,
                           kappa: float, gamma: float, delta_sep: float,
                           area: float, newton_tol: float,
                           newton_rtol: float, newton_max_iter: int,
                           n_trips: int, stagnation_exit: bool = True,
                           solve_prec: str = "highest", block_b: int = 8,
                           fwd_mm: str = "highest", active=None):
    """The member-blocked march: block_b members (8, 4 or 2 on CUDA
    tensors, BLOCK_SIZES) in masked lockstep (pallas_march.py:1649), each
    block on a thread-block cluster (`launch_geometry`). Same contract as
    `march_fused_2d`, and each member's history, Newton count and first_bad
    are bit for bit those of `march_fused_2d`; B must divide by block_b.
    It takes no active flag (ValueError)."""
    _refuse_active("march_fused_2d_blocked", active)
    k = _march_kw(tau, c1, c2, kappa, gamma, delta_sep, area, newton_tol,
                  newton_rtol, newton_max_iter, n_trips, stagnation_exit,
                  solve_prec, fwd_mm)
    args = (dts, phi0, u, Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, lam, wts)
    if not _build.on_cuda("march_fused_2d_blocked", phi0):
        return march_fused_2d_blocked_plain(*args, block_b=block_b, **k)
    _check_block(phi0.shape[0], block_b)
    if block_b not in BLOCK_SIZES:
        raise ValueError(f"the CUDA blocked march is built for block_b in "
                         f"{BLOCK_SIZES}, got {block_b}")
    return _launch_march(march_fused_2d_blocked, args, k, members=block_b)


march_fused_2d_blocked.launches = march_fused_2d_blocked.bf16_launches = 0
march_fused_2d_blocked.fwd16_launches = 0


def march_fused_2d_segment(dts, phi0, mu0, w0, m0, u, Lx, LyT, Vx_inv,
                           Vy_inv_T, Vx, VyT, lam, wts, *, tau: float,
                           c1: float, c2: float, kappa: float, gamma: float,
                           delta_sep: float, area: float, newton_tol: float,
                           newton_rtol: float, newton_max_iter: int,
                           n_trips: int, stagnation_exit: bool = True,
                           solve_prec: str = "highest",
                           fwd_mm: str = "highest", active=None):
    """One K-step segment of the march with the (phi, mu, w) state carried
    explicitly (pallas_march.py:479): mu0, w0 are the segment-start values
    and m0 (B,) the GLOBAL initial mass that the mass correction targets.
    On CUDA tensors each member runs on a thread-block cluster
    (`launch_geometry` with one member per cluster), bit for bit what the
    one-CTA kernel `_march_fused_2d_segment_cta` computes.

    Args: dts (K,), phi0, mu0, w0 (B, n, m), m0 (B,), u (B, K+1, n, m);
    operators as `march_fused_2d`.
    Returns (hist (B, K, n, m), the K post-step states without phi0;
    phi_f, mu_f, w_f (B, n, m); nsolve (B,); first_bad (B,)). It takes
    no active flag (ValueError).
    """
    _refuse_active("march_fused_2d_segment", active)
    k = _march_kw(tau, c1, c2, kappa, gamma, delta_sep, area, newton_tol,
                  newton_rtol, newton_max_iter, n_trips, stagnation_exit,
                  solve_prec, fwd_mm)
    args = (dts, phi0, mu0, w0, m0, u, Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT,
            lam, wts)
    if not _build.on_cuda("march_fused_2d_segment", phi0):
        return march_fused_2d_segment_plain(*args, **k)
    return _launch_segment(march_fused_2d_segment, args, k, cluster=True)


march_fused_2d_segment.launches = march_fused_2d_segment.bf16_launches = 0
march_fused_2d_segment.fwd16_launches = 0


def _march_fused_2d_segment_cta(*args, active=None, **kw):
    """The one-CTA segment kernel of csrc/march2d.cu (one member per CTA):
    the bit oracle of `march_fused_2d_segment`, which the card tests and
    chip_smoke.py hold the cluster kernel against; no solver calls it.
    Arguments and results as `march_fused_2d_segment`."""
    _refuse_active("_march_fused_2d_segment_cta", active)
    k = _march_kw(**kw)
    _refuse_prec("_march_fused_2d_segment_cta", k)
    if not _build.on_cuda("_march_fused_2d_segment_cta", args[1]):
        return march_fused_2d_segment_plain(*args, **k)
    return _launch_segment(_march_fused_2d_segment_cta, args, k,
                           cluster=False)


_march_fused_2d_segment_cta.launches = 0


def _launch_segment(wrapper, args, k, cluster: bool):
    """Check and launch a segment march: on the cluster kernel (cluster),
    one member per cluster on the geometry of `launch_geometry`, else on
    the one-CTA kernel."""
    dts, phi0, mu0, w0, m0, u = args[:6]
    B, n, m = phi0.shape
    K = dts.shape[0]
    names, shapes = _op_shapes(n, m)
    _build.check_cuda([("dts", dts, (K,)), ("phi0", phi0, (B, n, m)),
                       ("mu0", mu0, (B, n, m)), ("w0", w0, (B, n, m)),
                       ("m0", m0, (B,)), ("u", u, (B, K + 1, n, m))]
                      + list(zip(names, args[6:], shapes)), phi0.device)
    dev = phi0.device
    fwd = fwd_passes(k["fwd_mm"])
    ops16, passes = _solve_operands(
        krylov_passes(k["solve_prec"], k["fwd_mm"]), args[6:], fwd)
    geo = (launch_geometry(n, m, B, dev, members=SEGMENT_MEMBERS,
                           segment=True, solve_passes=passes,
                           fwd_passes=fwd)
           if cluster else None)
    lib = _build.load()
    out = lambda shape: torch.empty(shape, dtype=torch.float32, device=dev)
    hist = out((B, K, n, m))
    phi_f, mu_f, w_f = out((B, n, m)), out((B, n, m)), out((B, n, m))
    nsolve = torch.empty((B,), dtype=torch.int32, device=dev)
    first_bad = torch.empty((B,), dtype=torch.int32, device=dev)
    work = out((B, lib.vch_workspace_fields(0), n, m))
    consts, nc = _fwd_consts(k)
    stream = torch.cuda.current_stream(dev).cuda_stream
    common = ([t.data_ptr() for t in args]
              + [hist.data_ptr(), phi_f.data_ptr(), mu_f.data_ptr(),
                 w_f.data_ptr(), nsolve.data_ptr(), first_bad.data_ptr(),
                 work.data_ptr(), B, K, n, m, consts, nc,
                 k["newton_max_iter"], k["n_trips"],
                 int(k["stagnation_exit"])])
    if geo is None:
        err = lib.vch_march_fused_2d_segment(*common, stream)
    else:
        err = lib.vch_march_fused_2d_segment_cluster(
            *common, geo.cluster, geo.kc, geo.smem_bytes, _ptr(ops16),
            passes, fwd, stream)
    wrapper.launches += 1
    if passes:
        wrapper.bf16_launches += 1
    if fwd:
        wrapper.fwd16_launches += 1
    _build.raise_on(lib, err, wrapper.__name__)
    return hist, phi_f, mu_f, w_f, nsolve, first_bad


# --------------------------------------------------------------------------
# adjoint sweep


def _adjoint_terminal(phi_T_state, phi_T_target, b2, ops, tau):
    """(I - tau L) p_T = b2 (phi(T) - phi_Omega), exact in the cosine basis;
    q_T = -L p_T; r_T = 0."""
    Lx, LyT, Vxi, VyiT, Vx, VyT, lam = ops
    mm = torch.matmul
    rhs_T = b2 * (phi_T_state - phi_T_target)
    p = mm(mm(Vx, mm(mm(Vxi, rhs_T), VyiT) / (1.0 - tau * lam)), VyT)
    return p, -apply_laplacian_2d_t(Lx, LyT, p), torch.zeros_like(p)


def _adjoint_member(dts, hist, phiQ, b1, carry, ops, k):
    """One member's reverse (p, q, r) sweep over len(dts) steps from the
    carry (p, q, r) at the last level of hist. Returns (r at the first
    len(dts) levels, in forward order; (p, q, r) at the first level)."""
    Lx, LyT, Vxi, VyiT, Vx, VyT, lam = ops
    mm = torch.matmul
    # apply_At's products: "bf16x3" on its operators split once, else mm
    mm_s = _make_mm(hist.dtype, "bf16x3" if sweep_passes(
        k.get("solve_prec", "highest")) else "highest")
    Sx, SyT, Sxi, SyiT = ((Vx, VyT, Vxi, VyiT) if mm_s is mm else
                          (_bf16_split(o) for o in (Vx, VyT, Vxi, VyiT)))
    tau, gamma, c1, c2 = k["tau"], k["gamma"], k["c1"], k["c2"]
    eps_mach = _eps_mach(hist.dtype)
    M = dts.shape[0]

    def to_s(v):
        return mm(mm(Vxi, v), VyiT)

    def from_s(vh):
        return mm(mm(Vx, vh), VyT)

    def to_s_k(v):
        return mm_s(mm_s(Sxi, v), SyiT)

    def from_s_k(vh):
        return mm_s(mm_s(Sx, vh), SyT)

    def lap(v):
        return apply_laplacian_2d_t(Lx, LyT, v)

    def fpp(phi):
        return fpp_log(phi, c1, c2, _FPP_EPS)

    p_next, q_next, r_next = carry
    r_out = [None] * M

    for n in range(M - 1, -1, -1):
        dt = dts[n]
        half_dt = 0.5 * dt
        phi_n, phi_np1 = hist[n], hist[n + 1]
        src_sum = (phi_n - phiQ[n]) + (phi_np1 - phiQ[n + 1])
        fpp_n = fpp(phi_n)
        fpp_np1 = fpp(phi_np1)
        fbar = torch.mean(fpp_n)

        w1 = lap(p_next)
        Bp = p_next - tau * w1 - half_dt * lap(w1) + half_dt * fpp_np1 * w1
        rhs = Bp + half_dt * b1 * src_sum

        poly = 1.0 - tau * lam + half_dt * lam * lam
        denom = poly - half_dt * fbar * lam
        isd = torch.rsqrt(torch.abs(denom))

        def apply_At(yh):
            z = isd * yh
            w = to_s_k(fpp_n * from_s_k(lam * z))
            return isd * (poly * z - half_dt * w)

        bt = isd * to_s(rhs)
        y0 = to_s(p_next) / isd
        r0 = bt - apply_At(y0)
        floor2 = ((50.0 * eps_mach) ** 2
                  * torch.clamp(_dot(bt, bt), min=EPS_DIV))
        best = _bicgstab_fixed(apply_At, lambda v: v, r0, y0, y0, floor2,
                               k["n_trips"])
        p_n = from_s(isd * best)
        q_n = -lap(p_n)
        den = gamma + half_dt
        r_n = ((gamma - half_dt) / den * r_next
               + half_dt / den * (q_n + q_next))
        if not bool(dt <= 1e-14):   # dt <= 1e-14 copies the next level
            p_next, q_next, r_next = p_n, q_n, r_n
        r_out[n] = r_next
    return r_out, (p_next, q_next, r_next)


def adjoint_fused_2d_plain(dts, phi_hist, phi_Q, phi_T, b1, b2, Lx, LyT,
                           Vx_inv, Vy_inv_T, Vx, VyT, lam, **k):
    """Plain PyTorch version of the adjoint-sweep kernel. Arguments as
    `adjoint_fused_2d`."""
    ops = (Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, lam)
    M = dts.shape[0]
    rs = []
    for b in range(phi_T.shape[0]):
        carry = _adjoint_terminal(phi_hist[b, M], phi_T[b], b2[b], ops,
                                  k["tau"])
        r_out, _ = _adjoint_member(dts, phi_hist[b], phi_Q[b], b1[b], carry,
                                   ops, k)
        rs.append(torch.stack(r_out + [carry[2]]))
    return torch.stack(rs)


def adjoint_fused_2d_blocked_plain(dts, phi_hist, phi_Q, phi_T, b1, b2, Lx,
                                   LyT, Vx_inv, Vy_inv_T, Vx, VyT, lam, *,
                                   block_b: int, **k):
    """Plain PyTorch version of the member-blocked sweep: per member, the
    same computation as `adjoint_fused_2d_plain`."""
    _check_block(phi_T.shape[0], block_b)
    return adjoint_fused_2d_plain(dts, phi_hist, phi_Q, phi_T, b1, b2, Lx,
                                  LyT, Vx_inv, Vy_inv_T, Vx, VyT, lam, **k)


def adjoint_fused_2d_segment_plain(dts, phi_seg, phi_Q_seg, p0, q0, r0, b1,
                                   Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, lam,
                                   **k):
    """Plain PyTorch version of the segment sweep. Arguments as
    `adjoint_fused_2d_segment`."""
    ops = (Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, lam)
    rs, fin = [], []
    for b in range(p0.shape[0]):
        r_out, last = _adjoint_member(dts, phi_seg[b], phi_Q_seg[b], b1[b],
                                      (p0[b], q0[b], r0[b]), ops, k)
        rs.append(torch.stack(r_out))
        fin.append(last)
    p_f, q_f, r_f = (torch.stack([f[i] for f in fin]) for i in range(3))
    return torch.stack(rs), p_f, q_f, r_f


def _adj_consts(k):
    vals = [k["tau"], k["gamma"], 2.0 * k["c1"], 2.0 * k["c2"],
            -1.0 + _FPP_EPS, 1.0 - _FPP_EPS,
            (50.0 * _eps_mach(torch.float32)) ** 2]
    return (ctypes.c_float * len(vals))(*vals), len(vals)


def _adjoint_kw(tau, gamma, c1, c2, n_trips, solve_prec="highest"):
    return dict(tau=tau, gamma=gamma, c1=c1, c2=c2, n_trips=int(n_trips),
                solve_prec=solve_prec)



def _launch_adjoint(wrapper, args, k, members=None):
    """Check and launch the whole sweep: on the cluster kernel with
    `members` members per cluster (1, or 2, 4, 8: the member-blocked sweep)
    on the geometry of `launch_geometry`, or (None) on the one-CTA kernel of
    csrc/adjoint2d.cu, the bit oracle. At "bf16x3" the cluster kernel's
    bf16 form takes apply_At's operators as `_bf16_operators` makes them,
    once per launch."""
    dts, phi_hist, phi_Q, phi_T, b1, b2, *ops = args
    B, n, m = phi_T.shape
    M = dts.shape[0]
    names, shapes = _op_shapes(n, m, with_wts=False)
    _build.check_cuda([("dts", dts, (M,)),
                       ("phi_hist", phi_hist, (B, M + 1, n, m)),
                       ("phi_Q", phi_Q, (B, M + 1, n, m)),
                       ("phi_T", phi_T, (B, n, m)), ("b1", b1, (B,)),
                       ("b2", b2, (B,))]
                      + list(zip(names, ops, shapes)), phi_T.device)
    dev = phi_T.device
    ops16, passes = _solve_operands(sweep_passes(k["solve_prec"]), ops)
    geo = (None if members is None
           else launch_geometry(n, m, B, dev, members=members,
                                kernel="sweep", solve_passes=passes))
    lib = _build.load()
    r = torch.empty((B, M + 1, n, m), dtype=torch.float32, device=dev)
    work = torch.empty((B, lib.vch_workspace_fields(1), n, m),
                       dtype=torch.float32, device=dev)
    consts, nc = _adj_consts(k)
    stream = torch.cuda.current_stream(dev).cuda_stream
    common = ([t.data_ptr() for t in args] + [r.data_ptr(), work.data_ptr(),
                                              B, M, n, m, consts, nc,
                                              k["n_trips"]])
    if geo is None:
        err = lib.vch_adjoint_fused_2d(*common, stream)
    elif members == 1:
        err = lib.vch_adjoint_fused_2d_cluster(*common, geo.cluster, geo.kc,
                                               geo.smem_bytes, _ptr(ops16),
                                               passes, stream)
    else:
        err = lib.vch_adjoint_fused_2d_blocked(*common, members, geo.cluster,
                                               geo.kc, geo.smem_bytes,
                                               _ptr(ops16), passes, stream)
    wrapper.launches += 1
    if passes:
        wrapper.bf16_launches += 1
    _build.raise_on(lib, err, wrapper.__name__)
    return r


def adjoint_fused_2d(dts, phi_hist, phi_Q, phi_T, b1, b2, Lx, LyT, Vx_inv,
                     Vy_inv_T, Vx, VyT, lam, *, tau: float, gamma: float,
                     c1: float, c2: float, n_trips: int,
                     solve_prec: str = "highest"):
    """The whole batched 2D adjoint sweep (pallas_march.py:751). On CUDA
    tensors each member runs on a thread-block cluster (`launch_geometry`
    of the sweep with one member per cluster), bit for bit what the one-CTA
    kernel `_adjoint_fused_2d_cta` computes; at solve_prec "bf16x3" on the
    bf16 form (apply_At on mma.sync; `sweep_passes`).

    Args: dts (M,); phi_hist, phi_Q (B, M+1, n, m); phi_T (B, n, m) terminal
    targets; b1, b2 (B,) weights; operators as `march_fused_2d`.
    Returns r (B, M+1, n, m), with r_T = 0 in the last frame.
    """
    k = _adjoint_kw(tau, gamma, c1, c2, n_trips, solve_prec)
    args = (dts, phi_hist, phi_Q, phi_T, b1, b2, Lx, LyT, Vx_inv, Vy_inv_T,
            Vx, VyT, lam)
    if not _build.on_cuda("adjoint_fused_2d", phi_T):
        return adjoint_fused_2d_plain(*args, **k)
    return _launch_adjoint(adjoint_fused_2d, args, k, members=1)


adjoint_fused_2d.launches = adjoint_fused_2d.bf16_launches = 0


def _adjoint_fused_2d_cta(*args, **kw):
    """The one-CTA sweep of csrc/adjoint2d.cu (one member per CTA): the bit
    oracle of `adjoint_fused_2d` and of the blocked sweep, which the card
    tests and chip_smoke.py hold the cluster kernel against; no solver
    calls it. Arguments and results as `adjoint_fused_2d`."""
    k = _adjoint_kw(**kw)
    _refuse_prec("_adjoint_fused_2d_cta", k)
    if not _build.on_cuda("_adjoint_fused_2d_cta", args[3]):
        return adjoint_fused_2d_plain(*args, **k)
    return _launch_adjoint(_adjoint_fused_2d_cta, args, k)


_adjoint_fused_2d_cta.launches = 0


def adjoint_fused_2d_blocked(dts, phi_hist, phi_Q, phi_T, b1, b2, Lx, LyT,
                             Vx_inv, Vy_inv_T, Vx, VyT, lam, *, tau: float,
                             gamma: float, c1: float, c2: float,
                             n_trips: int, solve_prec: str = "highest",
                             block_b: int = 8):
    """The member-blocked sweep: block_b members (8, 4 or 2 on CUDA
    tensors, BLOCK_SIZES) in masked lockstep (pallas_march.py:1905), each
    block on a thread-block cluster (`launch_geometry` of the sweep). Same
    contract as `adjoint_fused_2d`, and each member's r is bit for bit the
    one-CTA sweep's (`_adjoint_fused_2d_cta`; at "bf16x3" the one-member
    bf16 form's); B must divide by block_b."""
    k = _adjoint_kw(tau, gamma, c1, c2, n_trips, solve_prec)
    args = (dts, phi_hist, phi_Q, phi_T, b1, b2, Lx, LyT, Vx_inv, Vy_inv_T,
            Vx, VyT, lam)
    if not _build.on_cuda("adjoint_fused_2d_blocked", phi_T):
        return adjoint_fused_2d_blocked_plain(*args, block_b=block_b, **k)
    _check_block(phi_T.shape[0], block_b)
    if block_b not in BLOCK_SIZES:
        raise ValueError(f"the CUDA blocked sweep is built for block_b in "
                         f"{BLOCK_SIZES}, got {block_b}")
    return _launch_adjoint(adjoint_fused_2d_blocked, args, k, members=block_b)


adjoint_fused_2d_blocked.launches = adjoint_fused_2d_blocked.bf16_launches = 0


def adjoint_fused_2d_segment(dts, phi_seg, phi_Q_seg, p0, q0, r0, b1, Lx,
                             LyT, Vx_inv, Vy_inv_T, Vx, VyT, lam, *,
                             tau: float, gamma: float, c1: float, c2: float,
                             n_trips: int, solve_prec: str = "highest"):
    """One K-step segment of the sweep with the (p, q, r) carry explicit
    (pallas_march.py:819): p0, q0, r0 are the adjoint state at the segment's
    LAST level, phi_seg / phi_Q_seg (B, K+1, n, m) its state and target
    frames. On CUDA tensors each member runs on a thread-block cluster
    (`launch_geometry` of the segment sweep), bit for bit what the one-CTA
    kernel `_adjoint_fused_2d_segment_cta` computes; at solve_prec "bf16x3"
    on the bf16 form.

    Returns (r (B, K, n, m), the segment's first K levels in forward order;
    p_f, q_f, r_f (B, n, m) at its first level).
    """
    k = _adjoint_kw(tau, gamma, c1, c2, n_trips, solve_prec)
    args = (dts, phi_seg, phi_Q_seg, p0, q0, r0, b1, Lx, LyT, Vx_inv,
            Vy_inv_T, Vx, VyT, lam)
    if not _build.on_cuda("adjoint_fused_2d_segment", p0):
        return adjoint_fused_2d_segment_plain(*args, **k)
    return _launch_adjoint_segment(adjoint_fused_2d_segment, args, k,
                                   cluster=True)


adjoint_fused_2d_segment.launches = adjoint_fused_2d_segment.bf16_launches = 0


def _adjoint_fused_2d_segment_cta(*args, **kw):
    """The one-CTA segment sweep of csrc/adjoint2d.cu (one member per CTA):
    the bit oracle of `adjoint_fused_2d_segment`, which the card tests and
    chip_smoke.py hold the cluster kernel against; no solver calls it.
    Arguments and results as `adjoint_fused_2d_segment`."""
    k = _adjoint_kw(**kw)
    _refuse_prec("_adjoint_fused_2d_segment_cta", k)
    if not _build.on_cuda("_adjoint_fused_2d_segment_cta", args[3]):
        return adjoint_fused_2d_segment_plain(*args, **k)
    return _launch_adjoint_segment(_adjoint_fused_2d_segment_cta, args, k,
                                   cluster=False)


_adjoint_fused_2d_segment_cta.launches = 0


def _launch_adjoint_segment(wrapper, args, k, cluster: bool):
    """Check and launch a segment sweep: on the cluster kernel (cluster),
    one member per cluster on the geometry of `launch_geometry`, else on
    the one-CTA kernel."""
    dts, phi_seg, phi_Q_seg, p0, q0, r0, b1 = args[:7]
    B, n, m = p0.shape
    K = dts.shape[0]
    names, shapes = _op_shapes(n, m, with_wts=False)
    _build.check_cuda([("dts", dts, (K,)),
                       ("phi_seg", phi_seg, (B, K + 1, n, m)),
                       ("phi_Q_seg", phi_Q_seg, (B, K + 1, n, m)),
                       ("p0", p0, (B, n, m)), ("q0", q0, (B, n, m)),
                       ("r0", r0, (B, n, m)), ("b1", b1, (B,))]
                      + list(zip(names, args[7:], shapes)), p0.device)
    dev = p0.device
    ops16, passes = _solve_operands(sweep_passes(k["solve_prec"]),
                                    args[7:])
    geo = (launch_geometry(n, m, B, dev, members=SEGMENT_MEMBERS,
                           segment=True, kernel="sweep", solve_passes=passes)
           if cluster else None)
    lib = _build.load()
    out = lambda shape: torch.empty(shape, dtype=torch.float32, device=dev)
    r = out((B, K, n, m))
    p_f, q_f, r_f = out((B, n, m)), out((B, n, m)), out((B, n, m))
    work = out((B, lib.vch_workspace_fields(1), n, m))
    consts, nc = _adj_consts(k)
    stream = torch.cuda.current_stream(dev).cuda_stream
    common = ([t.data_ptr() for t in args]
              + [r.data_ptr(), p_f.data_ptr(), q_f.data_ptr(), r_f.data_ptr(),
                 work.data_ptr(), B, K, n, m, consts, nc, k["n_trips"]])
    if geo is None:
        err = lib.vch_adjoint_fused_2d_segment(*common, stream)
    else:
        err = lib.vch_adjoint_fused_2d_segment_cluster(
            *common, geo.cluster, geo.kc, geo.smem_bytes, _ptr(ops16),
            passes, stream)
    wrapper.launches += 1
    if passes:
        wrapper.bf16_launches += 1
    _build.raise_on(lib, err, wrapper.__name__)
    return r, p_f, q_f, r_f


# --------------------------------------------------------------------------
# 1D forward march

_ARMIJO_ETA_1D = 1e-3


def _march1d_member(dts, phi0, u, LT, VinvT, VT, lam, wts, k):
    """One member's 1D march: phi0, lam, wts (n,), u (M+1, n) in core
    layout. What the Pallas body (`_march1d_kernel_factory`,
    pallas_march.py:897-1180) computes for a member: its masked lockstep
    gives each member its own Newton, Armijo and Krylov trip counts.
    Returns (post-step frames, nsolve, first_bad)."""
    mm = torch.matmul
    tau, c1, c2, kappa, gamma = k["tau"], k["c1"], k["c2"], k["kappa"], k["gamma"]
    delta_sep = k["delta_sep"]
    lo, hi = -1.0 + delta_sep, 1.0 - delta_sep
    n = phi0.shape[0]
    eps_mach = _eps_mach(phi0.dtype)
    lap = lambda v: mm(v, LT)
    to_s = lambda v: mm(v, VinvT)
    from_s = lambda vh: mm(vh, VT)
    f_log = lambda phi: regularized_log(phi, delta_sep)

    phi_old = phi0
    w_old = torch.zeros_like(phi0)
    mu_old = -kappa * lap(phi0) + c1 * f_log(phi0) - 2.0 * c2 * phi0
    m0 = torch.sum(wts * phi0)
    frames, nsolve, first_bad = [], 0, -1

    for step in range(dts.shape[0]):
        dt = dts[step]
        inv_dt = 1.0 / dt
        tau_dt = tau * inv_dt
        gamma_dt = gamma * inv_dt
        w_new = (((gamma_dt - 0.5) * w_old + 0.5 * (u[step + 1] + u[step]))
                 / (gamma_dt + 0.5))
        lap_mu_old = lap(mu_old)
        lap_phi_old = lap(phi_old)
        f_ccv = -2.0 * c2 * phi_old
        w_avg = 0.5 * (w_new + w_old)

        def resid(phi, mu):
            lap_mu = lap(mu)
            lap_phi = lap(phi)
            Rmu = (phi - phi_old) * inv_dt - 0.5 * (lap_mu + lap_mu_old)
            Rphi = (tau * inv_dt * (phi - phi_old)
                    - 0.5 * kappa * (lap_phi + lap_phi_old)
                    + c1 * f_log(phi) + f_ccv
                    - 0.5 * (mu + mu_old) - w_avg)
            norm = torch.sqrt(torch.sum(Rphi * Rphi) + torch.sum(Rmu * Rmu))
            return norm, Rphi, Rmu

        def schur_solve(phi, Rphi, Rmu):
            d = 2.0 * c1 / (1.0 - phi * phi)
            dbar = torch.sum(d) / n
            poly = inv_dt - tau_dt * lam + 0.5 * kappa * lam * lam
            denom = poly - dbar * lam

            def apply_S(yh):
                return poly * yh - lam * to_s(d * from_s(yh))

            bvec = to_s(lap(Rphi) - Rmu)
            floor2 = ((50.0 * eps_mach) ** 2
                      * torch.clamp(_dot(bvec, bvec), min=EPS_DIV))
            z = torch.zeros_like(bvec)
            best_x = _bicgstab_fixed(apply_S, lambda v: v / denom, bvec, z, z,
                                     floor2, k["n_trips"])
            dphi = from_s(best_x)
            Kpp_dphi = -(0.5 * kappa) * lap(dphi) + (tau_dt + d) * dphi
            dmu = 2.0 * (Kpp_dphi + Rphi)
            return dphi, dmu

        def step_ceiling(phi, dphi):
            inf = torch.full_like(phi, math.inf)
            ratio_pos = torch.where(dphi > 0, (hi - phi) / dphi, inf)
            ratio_neg = torch.where(dphi < 0, (lo - phi) / dphi, inf)
            amax = torch.minimum(torch.min(ratio_pos), torch.min(ratio_neg))
            if not bool(torch.isfinite(amax)) or bool(amax <= 0):
                amax = torch.ones_like(amax)
            return torch.clamp(0.9 * amax, max=1.0)

        def armijo(phi, mu, dphi, dmu, norm_R):
            # in-bounds guard, no best-trial fallback; the trial step is
            # alpha0 * 0.5^j; an accepted trial hands its residual on
            alpha0 = step_ceiling(phi, dphi)
            fac = 1.0
            for _ in range(_ARMIJO_MAX):
                alpha = alpha0 * fac
                phi_t = phi + alpha * dphi
                mu_t = mu + alpha * dmu
                norm_t, Rp_t, Rm_t = resid(phi_t, mu_t)
                if (bool(torch.all(torch.abs(phi_t) < 1.0 - delta_sep))
                        and bool(norm_t <= (1.0 - _ARMIJO_ETA_1D * alpha)
                                 * norm_R)):
                    return phi_t, mu_t, norm_t, Rp_t, Rm_t
                fac *= 0.5
            return None

        # Newton from (phi_old, mu_old): this member's own trip count; the
        # residual of an accepted trial is the next round's residual
        phi, mu = phi_old, mu_old
        norm_R, Rphi, Rmu = resid(phi, mu)
        norm0, prev_norm = norm_R, None
        for it in range(k["newton_max_iter"]):
            conv = bool(norm_R < k["newton_tol"])
            if k["newton_rtol"] > 0:
                conv = conv or bool(norm_R < k["newton_rtol"] * norm0)
            if k["stagnation_exit"] and it > 0:
                conv = conv or bool(norm_R >= prev_norm)
            if conv:
                break
            dphi, dmu = schur_solve(phi, Rphi, Rmu)
            nsolve += 1
            trial = armijo(phi, mu, dphi, dmu, norm_R)
            if trial is None:       # a failed line search ends the loop
                break
            prev_norm = norm_R
            phi, mu, norm_R, Rphi, Rmu = trial

        # clip + uniform mass projection + sanitizer
        phi_c = torch.clamp(phi, lo, hi)
        mass_error = torch.sum(wts * phi_c) - m0
        if not bool(torch.isfinite(mass_error)) and first_bad < 0:
            first_bad = step
        phi_c = phi_c - mass_error / k["Lx_len"]
        frames.append(phi_c)
        phi_old, mu_old, w_old = phi_c, mu, w_new
    return frames, nsolve, first_bad


def march_fused_1d_plain(dts, phi0, u, LT, VinvT, VT, lam, wts, **k):
    """Plain PyTorch version of the 1D forward-march kernel (any device,
    float32 or float64). Arguments as `march_fused_1d`."""
    hist, ns, bad = [], [], []
    for b in range(phi0.shape[0]):
        frames, nsolve, first_bad = _march1d_member(
            dts, phi0[b], u[b], LT, VinvT, VT, lam[0], wts[0], k)
        hist.append(torch.stack([phi0[b]] + frames))
        ns.append(nsolve)
        bad.append(first_bad)
    as_f = lambda v: torch.tensor(v, dtype=torch.float32, device=phi0.device)
    return torch.stack(hist), as_f(ns), as_f(bad)


def _fwd1d_consts(k):
    """The 1D kernel's constants, formed in double precision the way the
    Pallas kernel forms them from Python floats, then rounded to float32."""
    ds = k["delta_sep"]
    log_eps = max(1e-8, 0.5 * ds)
    vals = [k["tau"], k["c1"], 2.0 * k["c1"], 2.0 * k["c2"], -k["kappa"],
            0.5 * k["kappa"], k["gamma"], -1.0 + log_eps, 1.0 - log_eps,
            -1.0 + ds, 1.0 - ds, k["Lx_len"], k["newton_tol"],
            k["newton_rtol"], (50.0 * _eps_mach(torch.float32)) ** 2]
    return (ctypes.c_float * len(vals))(*vals), len(vals)


# The 1D march on thread-block clusters (csrc/march1d.cu): the kernel
# checks these numbers against its own.
MARCH_1D_CHUNK = 32          # columns per chunk (the last takes the rest):
                             # bands are whole chunks
MARCH_1D_UNIT = 8            # members per product unit
MARCH_1D_MEMBERS_MAX = 64    # members per cluster, at most
MARCH_1D_SMEM_LIMIT = 232_448 - 8192   # dynamic shared memory per CTA: an
                                       # H100's 232,448 bytes less the
                                       # kernel's static control block
_M1D_KC = (32, 16, 8, 4)     # k rows per ring stage, the most that fit
_M1D_NV = 2                  # values per reduction, at most


class March1dGeometry(NamedTuple):
    """How the 1D march splits B members over thread-block clusters:
    `clusters` clusters of `cluster` CTAs, `members` members each (the last
    cluster the rest); rank p owns `chunks[p]` = (first chunk, chunks) of
    32 columns and so `bands[p]` = (first column, columns), `width` the
    widest; `resident`: the operator bands stay in shared memory for the
    launch (else they stream through the ring); the ring has two stages of
    `kc` k rows; `smem_bytes` the dynamic shared memory of one CTA."""
    cluster: int
    chunks: tuple
    bands: tuple
    width: int
    members: int
    clusters: int
    resident: bool
    kc: int
    smem_bytes: int


def _m1d_chunks(n: int) -> int:
    """Chunks of 32 columns, the last with the n % 32 columns past them."""
    return max(1, n // MARCH_1D_CHUNK)


def _m1d_split(n: int, C: int):
    """(chunks, bands) of every rank: the last (chunk count % C) ranks take
    one chunk more."""
    nch = _m1d_chunks(n)
    q, rem = divmod(nch, C)
    chunks = tuple((p * q + max(0, p - (C - rem)), q + (p >= C - rem))
                   for p in range(C))
    end = lambda f, k: n if f + k == nch else MARCH_1D_CHUNK * (f + k)
    bands = tuple((MARCH_1D_CHUNK * f, end(f, k) - MARCH_1D_CHUNK * f)
                  for f, k in chunks)
    return chunks, bands


def _m1d_smem(n: int, C: int, members: int, kc: int, resident: bool) -> int:
    """Dynamic shared-memory bytes of one CTA: the input ring, the two
    buffers of the reduction exchange and the operator bands (or their
    ring)."""
    _, bands = _m1d_split(n, C)
    w = max(c for _, c in bands)
    mbp = -(-members // MARCH_1D_UNIT) * MARCH_1D_UNIT
    ops = 3 * n * w if resident else 2 * kc * w
    return 4 * (2 * mbp * kc + 2 * _M1D_NV * members * _m1d_chunks(n) + ops)


def march1d_geometry(n: int, B: int, resident, cluster: int | None = None,
                     members: int | None = None) -> March1dGeometry:
    """The 1D march's geometry for B members of length n. The cluster is
    the smallest C (at most 16 and the chunk count) whose operator bands fit
    in MARCH_1D_SMEM_LIMIT bytes per CTA, held for the launch (n = 129: 1;
    257: 4; 513: 16); where none fits, C = 16 (or the chunk count) and the
    operator rows stream. A ring stage takes 32 k rows where two stages fit
    (else 16, 8, 4): each stage costs a CTA barrier, which at n = 513,
    B = 256 costs more than the loads' latency (chip_smoke.py phase 9 times
    rings of 16 and 8 rows; PERF.md).
    The members per cluster follow from how many
    clusters the card holds at once (`resident(geo)`, e.g. 7 clusters of
    16 on the H100): ceil(B / that), at most MARCH_1D_MEMBERS_MAX (fewer
    where their ring and exchange do not fit); `cluster` and `members`
    override. Raises ValueError for a shape no geometry fits."""
    if n < 2 or B < 1:
        raise ValueError(f"the 1D march needs n >= 2 and B >= 1 (n={n}, "
                         f"B={B})")
    need = min(MARCH_1D_MEMBERS_MAX, B)
    fits = lambda C, mb, kc, res: (_m1d_smem(n, C, mb, kc, res)
                                   <= MARCH_1D_SMEM_LIMIT)
    least = lambda C, mb, res: fits(C, mb, 4, res)
    top = min(16, _m1d_chunks(n))
    if cluster is None:
        C = next((c for c in range(1, top + 1) if least(c, need, True)),
                 None)
        res = C is not None
        C = C if res else top
    else:
        if not 1 <= cluster <= top:
            raise ValueError(f"cluster size {cluster} for n = {n}")
        C, res = cluster, least(cluster, need, True)
    cap = next((mb for mb in range(need, 0, -1) if least(C, mb, res)),
               None)
    if cap is None:
        raise ValueError(f"the 1D march at n = {n} needs "
                         f"{_m1d_smem(n, C, 1, 4, res)} bytes of shared "
                         f"memory per CTA (at most {MARCH_1D_SMEM_LIMIT})")
    chunks, bands = _m1d_split(n, C)
    width = max(c for _, c in bands)

    def geo(mb):
        kc = next(k for k in _M1D_KC if fits(C, mb, k, res))
        return March1dGeometry(C, chunks, bands, width, mb, -(-B // mb), res,
                               kc, _m1d_smem(n, C, mb, kc, res))

    if members is not None:
        if not 1 <= members <= MARCH_1D_MEMBERS_MAX:
            raise ValueError(f"members per cluster must be 1 .. "
                             f"{MARCH_1D_MEMBERS_MAX}, got {members}")
        if not least(C, members, res):
            raise ValueError(f"{members} members per cluster do not fit at "
                             f"n = {n}")
        return geo(members)
    held = resident(geo(cap))
    if held <= 0:
        return geo(cap)
    return geo(min(cap, -(-B // min(held, B))))


@lru_cache(maxsize=64)
def march1d_resident_clusters(device_index, n, C, members, kc, resident,
                              smem):
    """How many clusters of the 1D march with this geometry the card holds
    at once (cudaOccupancyMaxActiveClusters; negative: a CUDA error)."""
    with torch.cuda.device(device_index):
        return _build.load().vch_march1d_max_clusters(
            n, C, members, kc, int(resident), smem)


def march1d_launch_geometry(n: int, B: int, device,
                            members: int | None = None) -> March1dGeometry:
    """The geometry the 1D march launches on this card: `march1d_geometry`
    on cudaOccupancyMaxActiveClusters. Raises RuntimeError if no cluster of
    it fits on the card."""
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    resident = lambda g: march1d_resident_clusters(
        idx, n, g.cluster, g.members, g.kc, g.resident, g.smem_bytes)
    geo = march1d_geometry(n, B, resident, members=members)
    fit = resident(geo)
    if fit <= 0:
        raise RuntimeError(
            f"the 1D march: a cluster of {geo.cluster} CTAs with "
            f"{geo.smem_bytes} bytes of dynamic shared memory each does not "
            f"fit on this card (cudaOccupancyMaxActiveClusters: {fit})")
    return geo


def march_fused_1d(dts, phi0, u, LT, VinvT, VT, lam, wts, *, tau: float,
                   c1: float, c2: float, kappa: float, gamma: float,
                   delta_sep: float, Lx_len: float, newton_tol: float,
                   newton_rtol: float, newton_max_iter: int, n_trips: int,
                   stagnation_exit: bool = True, group: int = 0):
    """The whole batched 1D forward march in one launch
    (pallas_march.py:1183), on CUDA tensors on thread-block clusters
    (`march1d_launch_geometry`).

    Args:
      dts (M,), phi0 (B, n), u (B, M+1, n) in core layout (no duplicated
      t = 0 row: that is the caller's); LT, VinvT, VT (n, n): the Laplacian
      and the cosine analysis and synthesis transforms, transposed; lam
      (1, n) eigenvalues; wts (1, n) quadrature weights * h; Lx_len the
      domain length of the uniform mass projection.
      group: members per cluster on CUDA tensors, 1 ..
      MARCH_1D_MEMBERS_MAX, or 0: the geometry's choice. A member's result
      does not depend on it.
    Returns phi_hist (B, M+1, n) with phi0 first, newton_solves (B,)
    float32, first_bad (B,) float32: the first step whose mass defect was
    not finite, -1 for none.
    """
    k = dict(tau=tau, c1=c1, c2=c2, kappa=kappa, gamma=gamma,
             delta_sep=delta_sep, Lx_len=Lx_len, newton_tol=newton_tol,
             newton_rtol=newton_rtol, newton_max_iter=int(newton_max_iter),
             n_trips=int(n_trips), stagnation_exit=bool(stagnation_exit))
    args = (dts, phi0, u, LT, VinvT, VT, lam, wts)
    if not _build.on_cuda("march_fused_1d", phi0):
        return march_fused_1d_plain(*args, **k)
    if not 0 <= group <= MARCH_1D_MEMBERS_MAX:
        raise ValueError(f"group must be 0 .. {MARCH_1D_MEMBERS_MAX}, got "
                         f"{group}")
    B, n = phi0.shape
    M = dts.shape[0]
    dev = phi0.device
    _build.check_cuda([("dts", dts, (M,)), ("phi0", phi0, (B, n)),
                       ("u", u, (B, M + 1, n)), ("LT", LT, (n, n)),
                       ("VinvT", VinvT, (n, n)), ("VT", VT, (n, n)),
                       ("lam", lam, (1, n)), ("wts", wts, (1, n))], dev)
    geo = march1d_launch_geometry(n, B, dev, members=group or None)
    lib = _build.load()
    hist = torch.empty((B, M + 1, n), dtype=torch.float32, device=dev)
    nsolve = torch.empty((B,), dtype=torch.float32, device=dev)
    first_bad = torch.empty((B,), dtype=torch.float32, device=dev)
    npad = -(-n // MARCH_1D_CHUNK) * MARCH_1D_CHUNK
    work = torch.empty((B, lib.vch_march_1d_workspace_fields(), npad),
                       dtype=torch.float32, device=dev)
    consts, nc = _fwd1d_consts(k)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.vch_march_fused_1d(
        *[t.data_ptr() for t in args], hist.data_ptr(), nsolve.data_ptr(),
        first_bad.data_ptr(), work.data_ptr(), B, M, n, consts, nc,
        k["newton_max_iter"], k["n_trips"], int(k["stagnation_exit"]),
        geo.cluster, geo.members, geo.kc, int(geo.resident), geo.smem_bytes,
        stream)
    march_fused_1d.launches += 1
    _build.raise_on(lib, err, "march_fused_1d")
    return hist, nsolve, first_bad


march_fused_1d.launches = 0


class Entries(NamedTuple):
    """The entry points a solver calls: the six 2D whole-march and
    whole-sweep kernels, the four per-solve kernels of ops.solve_kernels and
    the whole 1D march. KERNELS
    routes by device (the CUDA kernels on CUDA tensors); PLAIN runs the
    plain versions on any device, which chip_smoke.py uses to hold the
    kernel path against the plain path on the card."""

    march: Callable
    march_blocked: Callable
    march_segment: Callable
    adjoint: Callable
    adjoint_blocked: Callable
    adjoint_segment: Callable
    schur_spectral: Callable
    adjoint_spectral: Callable
    schur_raw: Callable
    adjoint_raw: Callable
    march_1d: Callable


KERNELS = Entries(march_fused_2d, march_fused_2d_blocked,
                  march_fused_2d_segment, adjoint_fused_2d,
                  adjoint_fused_2d_blocked, adjoint_fused_2d_segment,
                  sk.bicgstab_schur_spectral, sk.bicgstab_adjoint_spectral,
                  sk.bicgstab_schur, sk.bicgstab_adjoint, march_fused_1d)
PLAIN = Entries(march_fused_2d_plain, march_fused_2d_blocked_plain,
                march_fused_2d_segment_plain, adjoint_fused_2d_plain,
                adjoint_fused_2d_blocked_plain, adjoint_fused_2d_segment_plain,
                sk.bicgstab_schur_spectral_plain,
                sk.bicgstab_adjoint_spectral_plain, sk.bicgstab_schur_plain,
                sk.bicgstab_adjoint_plain, march_fused_1d_plain)
# every kernel wrapper of the port: the solvers' entries, the one-CTA
# oracles, and the three operator applies and the six cost probes, which no
# solver calls, with their oracles
WRAPPERS = tuple(KERNELS) + (_march_fused_2d_cta, _march_fused_2d_segment_cta,
                             _adjoint_fused_2d_cta,
                             _adjoint_fused_2d_segment_cta,
                             sk._bicgstab_schur_spectral_cta,
                             sk._bicgstab_schur_cta,
                             sk._bicgstab_adjoint_spectral_cta,
                             sk._bicgstab_adjoint_cta, sk.schur_apply,
                             sk.adjoint_apply, sk.spectral_solve,
                             sk.schur_nodots, sk.schur_mmonly,
                             sk._schur_nodots_cta, sk._schur_mmonly_cta,
                             pk.matmul_chain,
                             pk._matmul_chain_cta, pk.matmul_chain_bf16,
                             pk._matmul_chain_bf16_cta, pk.blocked_microbench,
                             pk._blocked_microbench_cta, pk.while_probe,
                             pk._while_probe_cta)


# the cluster march's and sweep's wrappers: besides `launches` (every
# launch) each counts in `bf16_launches` those of its bf16 forms
# (march_bf16_kernel, the march's Krylov operator at fused_solve_precision
# "bf16x3" or "default"; march_fwd16_kernel, every product of the march at
# fwd_mm "bf16x3"; adjoint_bf16_kernel, the sweep's at
# adjoint_solve_precision "bf16x3"), and the march's in `fwd16_launches`
# those of march_fwd16_kernel
BF16_WRAPPERS = (march_fused_2d, march_fused_2d_blocked,
                 march_fused_2d_segment, adjoint_fused_2d,
                 adjoint_fused_2d_blocked, adjoint_fused_2d_segment)
FWD16_WRAPPERS = BF16_WRAPPERS[:3]


def reset_launches():
    """Set every kernel wrapper's launch counts to 0."""
    for fn in WRAPPERS:
        fn.launches = 0
    for fn in BF16_WRAPPERS:
        fn.bf16_launches = 0
    for fn in FWD16_WRAPPERS:
        fn.fwd16_launches = 0


def fwd16_launch_counts() -> dict:
    """The cluster march wrappers' launches of their fwd_mm form, by
    name."""
    return {fn.__name__: fn.fwd16_launches for fn in FWD16_WRAPPERS}


def bf16_launch_counts() -> dict:
    """The cluster march and sweep wrappers' launches of their bf16 form,
    by name."""
    return {fn.__name__: fn.bf16_launches for fn in BF16_WRAPPERS}


def launch_counts() -> dict:
    """Each kernel wrapper's launch count, by name."""
    return {fn.__name__: fn.launches for fn in WRAPPERS}
