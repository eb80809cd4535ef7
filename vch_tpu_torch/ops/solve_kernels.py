"""The per-solve kernels of the 2D scan path: one whole fixed-trip BiCGStab
solve per launch, and the three operator applies those solves are built
from, each as a kernel of its own (counterpart of
vch_tpu/ops/pallas_kernels.py).

  bicgstab_schur_spectral   the Newton Schur solve S dphi = rhs in the
                            cosine basis (pallas_kernels.py:691): the
                            preconditioner is a pointwise divide, 8
                            products per trip;
  bicgstab_adjoint_spectral the split-preconditioned adjoint step solve
                            A(phi_n) p = rhs in the cosine basis, warm
                            started from x0 (:798), 8 products per trip;
  bicgstab_schur            the Schur solve in the raw basis (:233), 16
                            products per trip (pallas_variant "raw");
  bicgstab_adjoint          the adjoint solve in the raw basis (:581), 24
                            products per trip;
  schur_apply               S v = v/dt - L[(tau/dt + d) v - (kappa/2) L v]
                            (:101), 4 products;
  adjoint_apply             A v = v - tau L v + (dt/2)(L L v - f'' L v)
                            (:133), 4 products;
  spectral_solve            Vx ((Vx^-1 v Vy^-T) / denom) Vy^T, the exact
                            solve of a polynomial in L (:478), 4 products.
`bicgstab_schur` on a (B, n, m) batch is also the counterpart of the
member-tiled `bicgstab_schur_pallas_batched` (:394): B thread-block
clusters, one member each, take the place of its block_b members per
program and its padding.
Two cost probes of the raw Schur solve (`bicgstab_schur`;
scripts/diag_kernel_cost.py:131, :176) split its time between products and
block reductions:
  schur_nodots              its trips with every dot product the constant
                            0.5 (no freeze, no best iterate);
  schur_mmonly              the chain v <- M(S(M(S(v)))) n_iter times, its
                            16 products per trip alone.

Each takes its per-member fields as (n, m) or with a leading batch axis
(B, n, m) (what vmap of the Pallas kernel takes) and the operators shared.
Each wrapper routes by the tensors' device: on CUDA tensors it launches the
hand-written kernel of `csrc/solve2d_cluster.cu` or `csrc/apply2d.cu`
(float32; one member per thread-block cluster for the four solves and the
two probes, `solve_geometry`, and for the three operator applies,
`apply_geometry`; a failed build, fit or launch raises, with no fallback),
on CPU tensors it runs its plain PyTorch version `<name>_plain` of this
module, which computes what the Pallas kernel body computes (fixed trip
count, noise-floor freeze, non-finite rejection, best iterate; eps_div
1e-30 in both dtypes, as the kernels) in float32 or float64 without host
syncs. Each wrapper counts its launches in `.launches`.
`_bicgstab_schur_spectral_cta`, `_bicgstab_schur_cta`,
`_bicgstab_adjoint_spectral_cta`, `_bicgstab_adjoint_cta`,
`_schur_nodots_cta` and `_schur_mmonly_cta` keep the one-CTA kernels of
`csrc/solve2d.cu` as the cluster kernels' bit oracles, which only the card
tests and chip_smoke.py call.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import torch

from vch_tpu_torch.ops import _build
from vch_tpu_torch.ops.linsolve import bicgstab_fixed_trips, member_dot
from vch_tpu_torch.ops.laplacian import apply_laplacian_2d_t

_EPS_DIV = 1e-30
# (50 eps_f32)^2: the noise-floor freeze factor of the float32 kernels
_FLOOR_F32 = (50.0 * 1.2e-7) ** 2
# variant numbers of vch_bicgstab_2d
(_SCHUR_SPECTRAL, _SCHUR_RAW, _ADJOINT_SPECTRAL, _ADJOINT_RAW,
 _SCHUR_NODOTS, _SCHUR_MMONLY) = range(6)


def per_solve_kernels_fit(n: int, m: int, dtype_bytes: int = 4,
                          vmem_limit: int = 100 * 2**20) -> bool:
    """Whether vch_tpu's auto rule takes the per-solve kernels on an
    (n, m) grid: its VMEM model of the whole solve (48 field buffers after
    (8, 128) tiling pads, against 95% of the 100 MB scoped limit;
    vch_tpu/ops/pallas_kernels.py:34 kernel_vmem_fits). The CUDA kernels
    have no such limit; the port keeps the rule so that a config takes the
    same Krylov path in both packages."""
    pad = lambda a, k: -(-a // k) * k
    field = pad(n, 8) * pad(m, 128) * dtype_bytes
    return 48 * field <= int(0.95 * vmem_limit)


def _transforms(Vx_inv, Vy_inv_T, Vx, VyT):
    mm = torch.matmul
    return (lambda v: mm(mm(Vx_inv, v), Vy_inv_T),
            lambda vh: mm(mm(Vx, vh), VyT))


# Each solve as the system its Krylov loop iterates on: (apply_A, b,
# apply_M, x0, finish), the solution being finish(best iterate).

def _schur_spectral_system(Vx_inv, Vy_inv_T, Vx, VyT, lam, denom, d, rhs,
                           inv_dt, tau_dt, half_kappa):
    to_s, from_s = _transforms(Vx_inv, Vy_inv_T, Vx, VyT)
    poly = inv_dt - tau_dt * lam + half_kappa * lam * lam
    apply_S = lambda yh: poly * yh - lam * to_s(d * from_s(yh))
    return apply_S, to_s(rhs), lambda yh: yh / denom, None, from_s


def _adjoint_spectral_system(Vx_inv, Vy_inv_T, Vx, VyT, lam, inv_sqrt_denom,
                             fpp, rhs, x0, tau, half_dt):
    to_s, from_s = _transforms(Vx_inv, Vy_inv_T, Vx, VyT)
    isd = inv_sqrt_denom
    poly = 1.0 - tau * lam + half_dt * lam * lam

    def apply_At(yh):
        z = isd * yh
        w = to_s(fpp * from_s(lam * z))
        return isd * (poly * z - half_dt * w)

    return (apply_At, isd * to_s(rhs), lambda v: v, to_s(x0) / isd,
            lambda y: from_s(isd * y))


def _schur_system(Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, denom, d, rhs, inv_dt,
                  tau_dt, half_kappa):
    to_s, from_s = _transforms(Vx_inv, Vy_inv_T, Vx, VyT)
    lap = lambda v: apply_laplacian_2d_t(Lx, LyT, v)

    def apply_S(v):
        u = (tau_dt + d) * v - half_kappa * lap(v)
        return inv_dt * v - lap(u)

    return (apply_S, rhs, lambda v: from_s(to_s(v) / denom), None,
            lambda x: x)


def _adjoint_system(Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, inv_sqrt_denom, fpp,
                    rhs, x0, tau, half_dt):
    # vch_tpu's bicgstab_split_fixed: P^-1/2 A P^-1/2 on P^-1/2 rhs
    to_s, from_s = _transforms(Vx_inv, Vy_inv_T, Vx, VyT)
    lap = lambda v: apply_laplacian_2d_t(Lx, LyT, v)
    isd = inv_sqrt_denom
    phalf = lambda v: from_s(to_s(v) * isd)

    def apply_At(v):
        z = phalf(v)
        w = lap(z)
        return phalf(z - tau * w + half_dt * (lap(w) - fpp * w))

    return (apply_At, phalf(rhs), lambda v: v, from_s(to_s(x0) / isd),
            phalf)


_SYSTEMS = {"bicgstab_schur_spectral": _schur_spectral_system,
            "bicgstab_adjoint_spectral": _adjoint_spectral_system,
            "bicgstab_schur": _schur_system,
            "bicgstab_adjoint": _adjoint_system}


def _solve(name, args, n_iter):
    apply_A, b, apply_M, x0, finish = _SYSTEMS[name](*args)
    best, trips = bicgstab_fixed_trips(apply_A, b, apply_M, n_iter, x0=x0,
                                       dot_fn=member_dot, eps_div=_EPS_DIV)
    return finish(best), trips


def solve_trips(name: str, *args, n_iter: int) -> torch.Tensor:
    """The trips each member of the solve `name` (a wrapper's name, with its
    arguments) runs in the CUDA kernel, which leaves the loop at a frozen
    or rejected trip; counted on the plain version's arithmetic, so a count
    at the float32 noise floor may differ by one from the kernel's."""
    return _solve(name, args, n_iter)[1]


def bicgstab_schur_spectral_plain(Vx_inv, Vy_inv_T, Vx, VyT, lam, denom, d,
                                  rhs, inv_dt, tau_dt, half_kappa,
                                  n_iter: int):
    """Plain PyTorch version of `bicgstab_schur_spectral`."""
    return _solve("bicgstab_schur_spectral",
                  (Vx_inv, Vy_inv_T, Vx, VyT, lam, denom, d, rhs, inv_dt,
                   tau_dt, half_kappa), n_iter)[0]


def bicgstab_adjoint_spectral_plain(Vx_inv, Vy_inv_T, Vx, VyT, lam,
                                    inv_sqrt_denom, fpp, rhs, x0, tau,
                                    half_dt, n_iter: int):
    """Plain PyTorch version of `bicgstab_adjoint_spectral`."""
    return _solve("bicgstab_adjoint_spectral",
                  (Vx_inv, Vy_inv_T, Vx, VyT, lam, inv_sqrt_denom, fpp, rhs,
                   x0, tau, half_dt), n_iter)[0]


def bicgstab_schur_plain(Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, denom, d, rhs,
                         inv_dt, tau_dt, half_kappa, n_iter: int):
    """Plain PyTorch version of `bicgstab_schur`."""
    return _solve("bicgstab_schur",
                  (Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, denom, d, rhs, inv_dt,
                   tau_dt, half_kappa), n_iter)[0]


def bicgstab_adjoint_plain(Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT,
                           inv_sqrt_denom, fpp, rhs, x0, tau, half_dt,
                           n_iter: int):
    """Plain PyTorch version of `bicgstab_adjoint`."""
    return _solve("bicgstab_adjoint",
                  (Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, inv_sqrt_denom, fpp,
                   rhs, x0, tau, half_dt), n_iter)[0]


def _named_shapes(mats, fields):
    """Each tensor of one batch of solves with its name and expected shape:
    `mats` the seven operator slots (Lx, LyT, Vxi, VyiT, Vx, VyT, lam; None
    where the variant takes none), `fields` the four per-member slots (f1,
    f2, rhs, x0; x0 None for the Schur solves), each (n, m) or (B, n, m)."""
    rhs = fields[2]
    if rhs.dim() not in (2, 3) or rhs.numel() == 0:
        raise ValueError(f"rhs must be (n, m) or (B, n, m), got "
                         f"{tuple(rhs.shape)}")
    n, m = rhs.shape[-2:]
    shapes = ((n, n), (m, m), (n, n), (m, m), (n, n), (m, m), (n, m))
    names = ("Lx", "LyT", "Vx_inv", "Vy_inv_T", "Vx", "VyT", "lam")
    fnames = ("f1", "f2", "rhs", "x0")
    return ([(nm, t, s) for nm, t, s in zip(names, mats, shapes)
             if t is not None]
            + [(nm, t, tuple(rhs.shape)) for nm, t in zip(fnames, fields)
               if t is not None])


def _check(mats, fields):
    """Check one batch of solves' tensors for a launch (`_named_shapes`'
    arguments). Returns (n, m, B)."""
    rhs = fields[2]
    _build.check_cuda(_named_shapes(mats, fields), rhs.device)
    n, m = rhs.shape[-2:]
    return n, m, rhs.shape[0] if rhs.dim() == 3 else 1


def _launch(wrapper, variant, scalars, mats, fields, n_iter):
    """Check and launch one batch of solves on the one-CTA kernel of
    csrc/solve2d.cu (`_check`'s arguments)."""
    n, m, B = _check(mats, fields)
    rhs = fields[2]
    dev = rhs.device
    lib = _build.load()
    scal = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                        device=dev).reshape(())
                        for v in scalars])
    out = torch.empty_like(rhs)
    work = torch.empty((B, lib.vch_solve_workspace_fields(), n, m),
                       dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.vch_bicgstab_2d(variant, scal.data_ptr(),
                              *[ptr(t) for t in mats],
                              *[ptr(t) for t in fields], out.data_ptr(),
                              work.data_ptr(), B, n, m, int(n_iter),
                              _FLOOR_F32, stream)
    wrapper.launches += 1
    _build.raise_on(lib, err, wrapper.__name__)
    return out


def bicgstab_schur_spectral(Vx_inv, Vy_inv_T, Vx, VyT, lam, denom, d, rhs,
                            inv_dt, tau_dt, half_kappa, n_iter: int):
    """One fixed-trip Newton Schur solve S dphi = rhs per member in the
    cosine basis, x0 = 0 (vch_tpu/ops/pallas_kernels.py:691). On CUDA
    tensors each member runs on a thread-block cluster (`solve_geometry`),
    bit for bit what the one-CTA kernel `_bicgstab_schur_spectral_cta`
    computes.

    Args: Vx_inv, Vx (n, n); Vy_inv_T, VyT (m, m); lam (n, m) eigenvalue
    grid; denom (the preconditioner symbol), d (the Jacobian diagonal) and
    rhs (n, m) or (B, n, m); inv_dt, tau_dt, half_kappa scalars (numbers,
    or tensors of one element, read on the card without a host sync).
    Returns dphi shaped as rhs. The residual is measured in the spectral
    metric, so the Krylov path differs from the raw-basis solve's; the
    Newton tolerance gates the result either way.
    """
    args = (Vx_inv, Vy_inv_T, Vx, VyT, lam, denom, d, rhs, inv_dt, tau_dt,
            half_kappa)
    if not _build.on_cuda("bicgstab_schur_spectral", rhs):
        return bicgstab_schur_spectral_plain(*args, n_iter=n_iter)
    return _launch_cluster(bicgstab_schur_spectral,
                           (None, None, Vx_inv, Vy_inv_T, Vx, VyT, lam),
                           (denom, d, rhs, None),
                           (inv_dt, tau_dt, half_kappa), n_iter)


bicgstab_schur_spectral.launches = 0


def _bicgstab_schur_spectral_cta(*args, n_iter: int):
    """The one-CTA spectral Schur solve of csrc/solve2d.cu (one member per
    CTA): the bit oracle of `bicgstab_schur_spectral`, which the card tests
    and chip_smoke.py hold the cluster kernel against; no solver calls it.
    Arguments and results as `bicgstab_schur_spectral`."""
    if not _build.on_cuda("_bicgstab_schur_spectral_cta", args[7]):
        return bicgstab_schur_spectral_plain(*args, n_iter=n_iter)
    Vx_inv, Vy_inv_T, Vx, VyT, lam, denom, d, rhs = args[:8]
    return _launch(_bicgstab_schur_spectral_cta, _SCHUR_SPECTRAL, args[8:],
                   (None, None, Vx_inv, Vy_inv_T, Vx, VyT, lam),
                   (denom, d, rhs, None), n_iter)


_bicgstab_schur_spectral_cta.launches = 0


@lru_cache(maxsize=64)
def solve_geometry(n: int, m: int, B: int, device_index: int,
                   kernel: str = "solve", cluster: int | None = None):
    """The cluster geometry of a cluster solve for B members of an (n, m)
    grid on CUDA device `device_index` (`kernel`: "solve" for
    `bicgstab_adjoint_spectral`, "raw_solve" for `bicgstab_adjoint`,
    "schur_solve" for `bicgstab_schur_spectral`, "raw_schur_solve" for
    `bicgstab_schur`, "schur_probe" for `schur_nodots` and
    `schur_mmonly`): one member per
    thread-block cluster, `ops.march.launch_geometry` fitted to that
    kernel's own residency (at n = 65 up to 16 CTAs for one member, one at
    a batch above the SMs), or with `cluster` CTAs
    (`ops.march.blocked_geometry`'s override, for measurement). Cached: the
    per-step sweep and marcher call a solve once per step or Newton round,
    and its wrapper must cost less host time than the kernel. A member
    whose ring does not fit raises ValueError with its bytes."""
    from vch_tpu_torch.ops import march   # ops.march imports this module
    if cluster is not None:   # the SM count sizes no cluster here
        return march.blocked_geometry(n, m, B, 1, cluster=cluster, members=1,
                                      kernel=kernel)
    return march.launch_geometry(n, m, B, torch.device("cuda", device_index),
                                 members=1, kernel=kernel)


def _device_scalar(x, dev):
    """(pointer, value) of a scalar argument: a tensor of one element is
    read on the card from its float32 copy on `dev` (none is made where it
    is one already), a number goes by value."""
    if not torch.is_tensor(x):
        return None, float(x)
    t = x.reshape(())
    if t.dtype != torch.float32 or t.device != dev:
        t = t.to(device=dev, dtype=torch.float32)
    return t, 0.0


# each cluster solve of csrc/solve2d_cluster.cu by wrapper: its kernel in
# ops.march.CLUSTER_KERNELS, its C entry and its workspace query
_CLUSTER_SOLVES = {
    "bicgstab_schur_spectral": ("schur_solve",
                                "vch_bicgstab_schur_spectral_cluster",
                                "vch_schur_cluster_workspace_fields"),
    "bicgstab_schur": ("raw_schur_solve", "vch_bicgstab_schur_raw_cluster",
                       "vch_schur_raw_cluster_workspace_fields"),
    "bicgstab_adjoint_spectral": ("solve",
                                  "vch_bicgstab_adjoint_spectral_cluster",
                                  "vch_solve_cluster_workspace_fields"),
    "bicgstab_adjoint": ("raw_solve", "vch_bicgstab_adjoint_raw_cluster",
                         "vch_adjoint_raw_cluster_workspace_fields"),
    "schur_nodots": ("schur_probe", "vch_schur_nodots_cluster",
                     "vch_schur_probe_cluster_workspace_fields"),
    "schur_mmonly": ("schur_probe", "vch_schur_mmonly_cluster",
                     "vch_schur_probe_cluster_workspace_fields")}


def _launch_cluster(wrapper, mats, fields, scalars, n_iter, cluster=None):
    """Check and launch one batch of solves on the cluster kernel of
    `wrapper` (`_check`'s arguments; the scalars as `_device_scalar` passes
    them: no host sync, no stack of fresh copies; `cluster`: that many CTAs
    a member, as `solve_geometry`'s override)."""
    name = wrapper.__name__
    kernel, entry, nfields = _CLUSTER_SOLVES[name]
    n, m, B = _check(mats, fields)
    rhs = fields[2]
    dev = rhs.device
    geo = (solve_geometry(n, m, B, dev.index, kernel) if cluster is None
           else solve_geometry(n, m, B, dev.index, kernel, cluster))
    lib = _build.load()
    scal = [_device_scalar(x, dev) for x in scalars]
    out = torch.empty_like(rhs)
    work = torch.empty((B, getattr(lib, nfields)(), n, m),
                       dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = getattr(lib, entry)(
        *[t.data_ptr() for t in mats + fields if t is not None],
        *[ptr(t) for t, _ in scal], *[v for _, v in scal], out.data_ptr(),
        work.data_ptr(), B, n, m, int(n_iter), _FLOOR_F32, geo.cluster,
        geo.kc, geo.smem_bytes, torch.cuda.current_stream(dev).cuda_stream)
    wrapper.launches += 1
    _build.raise_on(lib, err, name)
    return out


def bicgstab_adjoint_spectral(Vx_inv, Vy_inv_T, Vx, VyT, lam, inv_sqrt_denom,
                              fpp, rhs, x0, tau, half_dt, n_iter: int):
    """One fixed-trip split-preconditioned adjoint step solve A(phi_n) p =
    rhs per member in the cosine basis, warm started from x0
    (vch_tpu/ops/pallas_kernels.py:798). On CUDA tensors each member runs
    on a thread-block cluster (`solve_geometry`), bit for bit what the
    one-CTA kernel `_bicgstab_adjoint_spectral_cta` computes.

    Args: operators as `bicgstab_schur_spectral`; inv_sqrt_denom
    1/sqrt|denom| on the eigenvalue grid, fpp f''(phi_n), rhs and x0, each
    (n, m) or (B, n, m); tau, half_dt scalars (numbers, or tensors of one
    element, read on the card without a host sync). Returns p shaped as
    rhs.
    """
    args = (Vx_inv, Vy_inv_T, Vx, VyT, lam, inv_sqrt_denom, fpp, rhs, x0, tau,
            half_dt)
    if not _build.on_cuda("bicgstab_adjoint_spectral", rhs):
        return bicgstab_adjoint_spectral_plain(*args, n_iter=n_iter)
    return _launch_cluster(bicgstab_adjoint_spectral,
                           (None, None, Vx_inv, Vy_inv_T, Vx, VyT, lam),
                           (inv_sqrt_denom, fpp, rhs, x0), (tau, half_dt),
                           n_iter)


bicgstab_adjoint_spectral.launches = 0


def _bicgstab_adjoint_spectral_cta(*args, n_iter: int):
    """The one-CTA spectral adjoint solve of csrc/solve2d.cu (one member per
    CTA): the bit oracle of `bicgstab_adjoint_spectral`, which the card
    tests and chip_smoke.py hold the cluster kernel against; no solver
    calls it. Arguments and results as `bicgstab_adjoint_spectral`."""
    if not _build.on_cuda("_bicgstab_adjoint_spectral_cta", args[7]):
        return bicgstab_adjoint_spectral_plain(*args, n_iter=n_iter)
    Vx_inv, Vy_inv_T, Vx, VyT, lam, isd, fpp, rhs, x0, tau, half_dt = args
    return _launch(_bicgstab_adjoint_spectral_cta, _ADJOINT_SPECTRAL,
                   (tau, half_dt),
                   (None, None, Vx_inv, Vy_inv_T, Vx, VyT, lam),
                   (isd, fpp, rhs, x0), n_iter)


_bicgstab_adjoint_spectral_cta.launches = 0


def bicgstab_schur(Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, denom, d, rhs, inv_dt,
                   tau_dt, half_kappa, n_iter: int):
    """`bicgstab_schur_spectral` in the raw basis, with the preconditioner
    applied through the transforms (vch_tpu/ops/pallas_kernels.py:233; on a
    (B, n, m) batch also :394, the member-tiled form): the iteration of
    vch_tpu's composed bicgstab_fixed. Lx (n, n) and LyT (m, m) are the
    Laplacian factors. On CUDA tensors each member runs on a thread-block
    cluster (`solve_geometry`), bit for bit what the one-CTA kernel
    `_bicgstab_schur_cta` computes."""
    args = (Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, denom, d, rhs, inv_dt, tau_dt,
            half_kappa)
    if not _build.on_cuda("bicgstab_schur", rhs):
        return bicgstab_schur_plain(*args, n_iter=n_iter)
    return _launch_cluster(bicgstab_schur,
                           (Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, None),
                           (denom, d, rhs, None),
                           (inv_dt, tau_dt, half_kappa), n_iter)


bicgstab_schur.launches = 0


def _bicgstab_schur_cta(*args, n_iter: int):
    """The one-CTA raw Schur solve of csrc/solve2d.cu (one member per
    CTA): the bit oracle of `bicgstab_schur`, which the card tests and
    chip_smoke.py hold the cluster kernel against, and the cost probe's
    `full`, timed beside `schur_nodots` and `schur_mmonly`, its parts; no
    solver calls it. Arguments and results as `bicgstab_schur`."""
    if not _build.on_cuda("_bicgstab_schur_cta", args[8]):
        return bicgstab_schur_plain(*args, n_iter=n_iter)
    Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, denom, d, rhs = args[:9]
    return _launch(_bicgstab_schur_cta, _SCHUR_RAW, args[9:],
                   (Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, None),
                   (denom, d, rhs, None), n_iter)


_bicgstab_schur_cta.launches = 0


def bicgstab_adjoint(Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, inv_sqrt_denom, fpp,
                     rhs, x0, tau, half_dt, n_iter: int):
    """`bicgstab_adjoint_spectral` in the raw basis: the split
    preconditioner P^-1/2 v = from_s(isd to_s(v)) wraps the raw operator
    (vch_tpu/ops/pallas_kernels.py:581), the iteration of vch_tpu's
    composed bicgstab_split_fixed. Lx (n, n) and LyT (m, m) are the
    Laplacian factors. On CUDA tensors each member runs on a thread-block
    cluster (`solve_geometry`), bit for bit what the one-CTA kernel
    `_bicgstab_adjoint_cta` computes."""
    args = (Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, inv_sqrt_denom, fpp, rhs, x0,
            tau, half_dt)
    if not _build.on_cuda("bicgstab_adjoint", rhs):
        return bicgstab_adjoint_plain(*args, n_iter=n_iter)
    return _launch_cluster(bicgstab_adjoint,
                           (Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, None),
                           (inv_sqrt_denom, fpp, rhs, x0), (tau, half_dt),
                           n_iter)


bicgstab_adjoint.launches = 0


def _bicgstab_adjoint_cta(*args, n_iter: int):
    """The one-CTA raw adjoint solve of csrc/solve2d.cu (one member per
    CTA): the bit oracle of `bicgstab_adjoint`, which the card tests and
    chip_smoke.py hold the cluster kernel against; no solver calls it.
    Arguments and results as `bicgstab_adjoint`."""
    if not _build.on_cuda("_bicgstab_adjoint_cta", args[8]):
        return bicgstab_adjoint_plain(*args, n_iter=n_iter)
    Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, isd, fpp, rhs, x0 = args[:10]
    return _launch(_bicgstab_adjoint_cta, _ADJOINT_RAW, args[10:],
                   (Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, None),
                   (isd, fpp, rhs, x0), n_iter)


_bicgstab_adjoint_cta.launches = 0


# --------------------------------------------------------------------------
# the cost probes of the raw Schur solve (scripts/diag_kernel_cost.py)

def schur_nodots_plain(Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, denom, d, rhs,
                       inv_dt, tau_dt, half_kappa, n_iter: int):
    """Plain PyTorch version of `schur_nodots`."""
    apply_S, r, apply_M, _, _ = _schur_system(
        Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, denom, d, rhs, inv_dt, tau_dt,
        half_kappa)
    dot = 0.5
    x = p = v = torch.zeros_like(rhs)
    rho = alpha = omega = 1.0
    for _ in range(n_iter):
        rho_new = dot
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = apply_M(p)
        v = apply_S(phat)
        alpha_n = rho_new / dot
        s = r - alpha_n * v
        shat = apply_M(s)
        t = apply_S(shat)
        omega_n = dot / dot
        x = x + alpha_n * phat + omega_n * shat
        r = s - omega_n * t
        rho, alpha, omega = rho_new, alpha_n, omega_n
    return x


def schur_mmonly_plain(Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, denom, d, rhs,
                       inv_dt, tau_dt, half_kappa, n_iter: int):
    """Plain PyTorch version of `schur_mmonly`."""
    apply_S, _, apply_M, _, _ = _schur_system(
        Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, denom, d, rhs, inv_dt, tau_dt,
        half_kappa)
    v = rhs
    for _ in range(n_iter):
        v = apply_M(apply_S(apply_M(apply_S(v))))
    return v


def _probe(wrapper, plain, args, n_iter, cluster=None, oracle=None):
    """One probe call (`wrapper`: `schur_nodots` or `schur_mmonly`, or with
    `oracle`, the variant of vch_bicgstab_2d, their one-CTA oracle) on the
    raw Schur solve's arguments: the shapes checked on either route, then
    the plain version `plain` on CPU tensors, else the kernel."""
    mats, fields = args[:6] + (None,), args[6:9] + (None,)
    for name, t, shape in _named_shapes(mats, fields):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    if not _build.on_cuda(wrapper.__name__, args[8]):
        return plain(*args, n_iter=n_iter)
    if oracle is not None:
        return _launch(wrapper, oracle, args[9:], mats, fields, n_iter)
    return _launch_cluster(wrapper, mats, fields, args[9:], n_iter, cluster)


def schur_nodots(Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, denom, d, rhs, inv_dt,
                 tau_dt, half_kappa, n_iter: int, cluster: int | None = None):
    """The probe `nodots` (scripts/diag_kernel_cost.py:131): the trips of
    the raw Schur solve `bicgstab_schur` on the same arguments with every
    block dot product replaced by the constant 0.5, no noise-floor freeze
    and no best iterate; returns the last iterate. Its time is that of the
    solve's products and elementwise passes without its reductions; its
    result is no solve. On CUDA tensors each member runs on a thread-block
    cluster (`solve_geometry` of kernel "schur_probe"; `cluster`: that many
    CTAs), bit for bit what the one-CTA kernel `_schur_nodots_cta`
    computes."""
    args = (Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, denom, d, rhs, inv_dt, tau_dt,
            half_kappa)
    return _probe(schur_nodots, schur_nodots_plain, args, n_iter, cluster)


schur_nodots.launches = 0


def _schur_nodots_cta(*args, n_iter: int):
    """The one-CTA nodots probe of csrc/solve2d.cu (variant 4, one member
    per CTA): the bit oracle of `schur_nodots`, which the card tests and
    chip_smoke.py hold the cluster kernel against; no entry point calls it.
    Arguments and result as `schur_nodots`."""
    return _probe(_schur_nodots_cta, schur_nodots_plain, args, n_iter,
                  oracle=_SCHUR_NODOTS)


_schur_nodots_cta.launches = 0


def schur_mmonly(Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, denom, d, rhs, inv_dt,
                 tau_dt, half_kappa, n_iter: int, cluster: int | None = None):
    """The probe `mmonly` (scripts/diag_kernel_cost.py:176): v <- M(S(M(S(
    v)))) n_iter times from v = rhs, S the raw Schur operator and M the
    spectral preconditioner of `bicgstab_schur` on the same arguments: the
    16 products of each of its trips with nothing between them. On CUDA
    tensors as `schur_nodots`, bit for bit `_schur_mmonly_cta`."""
    args = (Lx, LyT, Vx_inv, Vy_inv_T, Vx, VyT, denom, d, rhs, inv_dt, tau_dt,
            half_kappa)
    return _probe(schur_mmonly, schur_mmonly_plain, args, n_iter, cluster)


schur_mmonly.launches = 0


def _schur_mmonly_cta(*args, n_iter: int):
    """The one-CTA mmonly probe of csrc/solve2d.cu (variant 5): the bit
    oracle of `schur_mmonly`, as `_schur_nodots_cta` is of `schur_nodots`.
    Arguments and result as `schur_mmonly`."""
    return _probe(_schur_mmonly_cta, schur_mmonly_plain, args, n_iter,
                  oracle=_SCHUR_MMONLY)


_schur_mmonly_cta.launches = 0


# --------------------------------------------------------------------------
# the operator applies
# variant numbers of vch_apply_2d
_SCHUR_APPLY, _ADJOINT_APPLY, _SPECTRAL_SOLVE = range(3)


def schur_apply_plain(Lx, LyT, d, v, inv_dt, tau_dt, half_kappa):
    """Plain PyTorch version of `schur_apply`."""
    lap = lambda f: apply_laplacian_2d_t(Lx, LyT, f)
    u = (tau_dt + d) * v - half_kappa * lap(v)
    return inv_dt * v - lap(u)


def adjoint_apply_plain(Lx, LyT, fpp, v, tau, half_dt):
    """Plain PyTorch version of `adjoint_apply`."""
    lap = lambda f: apply_laplacian_2d_t(Lx, LyT, f)
    w = lap(v)
    return v - tau * w + half_dt * (lap(w) - fpp * w)


def spectral_solve_plain(Vx_inv, Vy_inv_T, Vx, VyT, denom, v):
    """Plain PyTorch version of `spectral_solve`."""
    to_s, from_s = _transforms(Vx_inv, Vy_inv_T, Vx, VyT)
    return from_s(to_s(v) / denom)


# The cluster kernel of the three operator applies (csrc/apply2d.cu): the
# kernel checks these numbers against its own.
SMEM_LIMIT = 232_448     # shared-memory bytes one CTA may use on an H100
_NT = 256                # threads per CTA
_MAX_UNITS = 4           # 4 x 4 output units per thread, at most
_PF_MAX = 12             # float4s of a peer band per thread in flight
_MAX_CHUNK = 4           # bands' worth of operator rows per chunk, at most


@dataclass(frozen=True)
class ApplyGeometry:
    """How one (n, m) member is split over a thread-block cluster: `bands`
    holds each rank's (first row, rows), in rank order; every band is stored
    with `rows_max` rows of `m_pad` floats; `per_thread` is the 4 x 4 output
    units a thread accumulates; a right product streams the operator in
    chunks of `chunk` bands' worth of rows (the largest of 4, 3, 2, 1 whose
    ring fits), a left product one peer band at a time; `smem_bytes` is the
    dynamic shared memory of one CTA."""
    cluster: int
    bands: tuple
    rows_max: int
    m_pad: int
    per_thread: int
    chunk: int
    smem_bytes: int


def cluster_size(n: int) -> int:
    """CTAs per member: 4 at n <= 96, 8 (the portable maximum) at n <= 192,
    else 16 (non-portable; at n = 257 it ran faster than 8 on an H100); never
    more than n, so that every band has a row. It depends on n alone, so a
    batch is just more clusters."""
    return min(4, n) if n <= 96 else 8 if n <= 192 else 16


@lru_cache(maxsize=64)
def apply_geometry(name: str, n: int, m: int,
                   cluster: int | None = None) -> ApplyGeometry:
    """The cluster geometry of `schur_apply` or `adjoint_apply` (two fields
    per CTA) or `spectral_solve` (three) on an (n, m) grid; `cluster`
    overrides `cluster_size(n)` (up to 16, the non-portable maximum) for
    measurement. Raises ValueError for a shape whose CTA would need more
    shared memory than SMEM_LIMIT, or more than the kernel holds in
    registers."""
    if name not in ("schur_apply", "adjoint_apply", "spectral_solve"):
        raise ValueError(f"no cluster geometry for {name!r}")
    C = cluster_size(n) if cluster is None else cluster
    if not 1 <= C <= min(16, n):
        raise ValueError(f"cluster size {C} for n = {n}")
    q, rem = divmod(n, C)
    bands = tuple((p * q + min(p, rem), q + (p < rem)) for p in range(C))
    rmax = q + (rem > 0)
    rpad, mpad = -(-rmax // 4) * 4, -(-m // 4) * 4
    units = (rpad // 4) * (mpad // 4)
    fields = 3 if name == "spectral_solve" else 2
    band = rmax * mpad
    budget = 4 * _PF_MAX * _NT
    if units > _MAX_UNITS * _NT or band > budget:
        raise ValueError(
            f"{name} on an ({n}, {m}) grid needs bands of {rmax} x {mpad} "
            f"floats ({4 * band} bytes, at most {4 * budget} in flight) and "
            f"{units} output units (at most {_MAX_UNITS * _NT}) per CTA in "
            f"clusters of {C}")
    for f in range(_MAX_CHUNK, 0, -1):
        stage = max(min(m, f * rmax), rmax)
        smem = 4 * (fields * band + 2 * stage * (mpad + rpad))
        if smem <= SMEM_LIMIT:
            return ApplyGeometry(C, bands, rmax, mpad, -(-units // _NT), f,
                                 smem)
    raise ValueError(
        f"{name} on an ({n}, {m}) grid needs {smem} bytes of shared memory "
        f"per CTA in clusters of {C} (at most {SMEM_LIMIT})")


def _launch_apply(wrapper, variant, scalars, mats, f1, v, cluster=None):
    """Check and launch one batch of applies: `mats` the six operator slots
    (Lx, LyT, Vxi, VyiT, Vx, VyT; None where the variant takes none), f1 the
    coefficient field (d, f'' or denom), shaped as v, (n, m) or (B, n, m),
    or (n, m) shared by the members of a (B, n, m) v. Scalars that are all
    numbers reach the kernel by value; 0-d tensors through one device
    array."""
    n, m = v.shape[-2:]
    if v.dim() not in (2, 3):
        raise ValueError(f"v must be (n, m) or (B, n, m), got "
                         f"{tuple(v.shape)}")
    B = v.shape[0] if v.dim() == 3 else 1
    dev = v.device
    shapes = ((n, n), (m, m), (n, n), (m, m), (n, n), (m, m))
    names = ("Lx", "LyT", "Vx_inv", "Vy_inv_T", "Vx", "VyT")
    shared = f1.dim() == 2 and v.dim() == 3
    _build.check_cuda(
        [(nm, t, sh) for nm, t, sh in zip(names, mats, shapes)
         if t is not None]
        + [("v", v, tuple(v.shape)),
           ("coefficient", f1, (n, m) if shared else tuple(v.shape))], dev)
    geo = apply_geometry(wrapper.__name__, n, m, cluster)
    lib = _build.load()
    vals, scal = [0.0] * 3, None
    if any(torch.is_tensor(x) for x in scalars):
        scal = torch.stack([torch.as_tensor(x, dtype=torch.float32,
                                            device=dev).reshape(())
                            for x in scalars])
    else:
        vals[:len(scalars)] = map(float, scalars)
    out = torch.empty_like(v)
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.vch_apply_2d(variant, ptr(scal), *vals,
                           *[ptr(t) for t in mats], f1.data_ptr(),
                           v.data_ptr(), out.data_ptr(), B, n, m,
                           int(shared), geo.cluster, geo.per_thread,
                           geo.chunk, geo.smem_bytes, stream)
    wrapper.launches += 1
    _build.raise_on(lib, err, wrapper.__name__)
    return out


def schur_apply(Lx, LyT, d, v, inv_dt, tau_dt, half_kappa):
    """The Newton Schur operator S v = inv_dt v - L[(tau_dt + d) v -
    half_kappa L v], L v = Lx v + v LyT, per member
    (vch_tpu/ops/pallas_kernels.py:101). Lx (n, n), LyT (m, m); d and v
    (n, m) or (B, n, m); the scalars numbers or 0-d tensors. Returns S v
    shaped as v."""
    if not _build.on_cuda("schur_apply", v):
        return schur_apply_plain(Lx, LyT, d, v, inv_dt, tau_dt, half_kappa)
    return _launch_apply(schur_apply, _SCHUR_APPLY,
                         (inv_dt, tau_dt, half_kappa),
                         (Lx, LyT, None, None, None, None), d, v)


schur_apply.launches = 0


def adjoint_apply(Lx, LyT, fpp, v, tau, half_dt):
    """The adjoint step operator A v = v - tau L v + half_dt (L L v -
    fpp L v) per member (vch_tpu/ops/pallas_kernels.py:133). Shapes as
    `schur_apply`, fpp = f''(phi_n) in d's place."""
    if not _build.on_cuda("adjoint_apply", v):
        return adjoint_apply_plain(Lx, LyT, fpp, v, tau, half_dt)
    return _launch_apply(adjoint_apply, _ADJOINT_APPLY, (tau, half_dt),
                         (Lx, LyT, None, None, None, None), fpp, v)


adjoint_apply.launches = 0


def spectral_solve(Vx_inv, Vy_inv_T, Vx, VyT, denom, v):
    """The cosine-diagonal solve Vx ((Vx^-1 v Vy^-T) / denom) Vy^T per
    member: exact for a polynomial in L with symbol denom on the eigenvalue
    grid, and the preconditioner apply of the raw-basis solves
    (vch_tpu/ops/pallas_kernels.py:478). v (n, m) or (B, n, m); denom shaped
    as v, or (n, m) shared by the members."""
    if not _build.on_cuda("spectral_solve", v):
        return spectral_solve_plain(Vx_inv, Vy_inv_T, Vx, VyT, denom, v)
    return _launch_apply(spectral_solve, _SPECTRAL_SOLVE, (),
                         (None, None, Vx_inv, Vy_inv_T, Vx, VyT), denom, v)


spectral_solve.launches = 0
