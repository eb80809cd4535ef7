"""Port parity for the per-solve kernels and the Krylov solvers of the 2D
scan path: the plain PyTorch versions of vch_tpu_torch/ops/solve_kernels.py
against vch_tpu's Pallas kernels in interpret mode, and the composed
solvers and Newton step of vch_tpu_torch/ops/linsolve.py against vch_tpu's,
on the same numpy inputs. The CUDA kernels are held against the plain
versions in tests/test_torch_cuda.py and chip_smoke.py. Also: the entry
points' default device.

Tolerances: float64 1e-10 relative (the same recurrences; only summation
order differs). Float32, against the Pallas kernel in float32: 1e-5 for the
Schur solves (measured 2-5e-7), 1e-4 for the spectral adjoint solve
(measured 1e-5), 5e-3 for the raw adjoint solve, whose operator has
condition ~1e6 (measured 1.1-1.4e-3: any two float32 implementations of it
differ there); and each no farther from the float64 Pallas result than
twice the float32 Pallas result is, plus 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vch_tpu.ops import pallas_kernels as pk
from vch_tpu.ops import linsolve as jls
from vch_tpu.ops.laplacian import apply_laplacian_2d as jax_lap

from vch_tpu_torch.ops import linsolve as tls
from vch_tpu_torch.ops import march as km
from vch_tpu_torch.ops import solve_kernels as sk
from vch_tpu_torch.utils.convert import spectral_op_from_numpy

torch.set_num_threads(2)

N = 20
DT, TAU, C1, C2, KAPPA = 1e-2, 0.05, 0.75, 1.0, 1e-4
NP = {"float64": np.float64, "float32": np.float32}
TD = {"float64": torch.float64, "float32": torch.float32}
TOL32 = {"schur_spectral": 1e-5, "schur": 1e-5, "adjoint_spectral": 1e-4,
         "adjoint": 5e-3}


def _op_np():
    op = jls.make_spectral_op_2d(N, N, 1.0 / N, 1.0 / N, dtype=jnp.float64)
    return {k: np.asarray(v) for k, v in op._asdict().items()}


def _fields(B, seed=0):
    """A Newton state and an adjoint step of B members: the Schur solve's
    (denom, d, rhs) and the adjoint solve's (isd, fpp, rhs, x0)."""
    rng = np.random.default_rng(seed)
    lam = _op_np()["lam"]
    sh = (B, N + 1, N + 1)
    phi = np.clip(0.5 * rng.standard_normal(sh), -0.95, 0.95)
    d = 2 * C1 / (1 - np.clip(phi * phi, 0, 1 - 1e-4))
    dbar = d.mean(axis=(1, 2), keepdims=True)
    denom = 1 / DT + 0.5 * KAPPA * lam ** 2 - (TAU / DT + dbar) * lam
    fpp = 2 * C1 / (1 - phi * phi) - 2 * C2
    half = 0.5 * DT
    dena = (1 - TAU * lam + half * lam ** 2
            - half * fpp.mean(axis=(1, 2), keepdims=True) * lam)
    isd = 1 / np.sqrt(np.abs(dena))
    return dict(schur=(denom, d, rng.standard_normal(sh)),
                adjoint=(isd, fpp, rng.standard_normal(sh),
                         rng.standard_normal(sh)))


def _mats(kind, conv):
    o = _op_np()
    spectral = (o["Vx_inv"], o["Vy_inv"].T, o["Vx"], o["Vy"].T, o["lam"])
    raw = (o["Lx"], o["Ly"].T, o["Vx_inv"], o["Vy_inv"].T, o["Vx"],
           o["Vy"].T)
    return tuple(conv(m) for m in (spectral if "spectral" in kind else raw))


def _pallas(kind):
    fn = {"schur_spectral": pk.bicgstab_schur_spectral_pallas,
          "schur": pk.bicgstab_schur_pallas,
          "adjoint_spectral": pk.bicgstab_adjoint_spectral_pallas,
          "adjoint": pk.bicgstab_adjoint_pallas}[kind]
    return fn


def _scalars(kind):
    if kind.startswith("schur"):
        return (1 / DT, TAU / DT, 0.5 * KAPPA), 4
    return (TAU, 0.5 * DT), 5


def _run_pallas(kind, dtype_name, fields, batched):
    j = lambda a: jnp.asarray(a, NP[dtype_name])
    mats = _mats(kind, j)
    scal, n_iter = _scalars(kind)
    f = lambda *fs: _pallas(kind)(*mats, *fs, *scal, n_iter=n_iter,
                                  interpret=True)
    if batched:
        return np.asarray(jax.vmap(f)(*map(j, fields)))
    return np.asarray(f(*[j(a[0]) for a in fields]))


def _run_plain(kind, dtype_name, fields, batched):
    t = lambda a: torch.as_tensor(np.array(a), dtype=TD[dtype_name])
    plain = getattr(sk, f"bicgstab_{kind}_plain")
    scal, n_iter = _scalars(kind)
    args = [t(a) if batched else t(a[0]) for a in fields]
    return plain(*_mats(kind, t), *args, *scal, n_iter=n_iter).numpy()


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / np.abs(b).max())


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("kind", ["schur_spectral", "schur",
                                  "adjoint_spectral", "adjoint"])
def test_plain_solve_matches_pallas_kernel(kind, B):
    """Each per-solve kernel's plain version against the Pallas kernel in
    interpret mode: B = 1 as one (n, m) solve, B = 3 against vmap of the
    kernel over a (B, n, m) batch; float64 and float32."""
    fields = _fields(B)["schur" if kind.startswith("schur") else "adjoint"]
    batched = B > 1
    ref64 = _run_pallas(kind, "float64", fields, batched)
    got64 = _run_plain(kind, "float64", fields, batched)
    assert got64.shape == ref64.shape == ((B,) if batched else ()) + (
        N + 1, N + 1)
    assert _rel(got64, ref64) <= 1e-10
    ref32 = _run_pallas(kind, "float32", fields, batched)
    got32 = _run_plain(kind, "float32", fields, batched)
    assert got32.dtype == np.float32 and np.isfinite(got32).all()
    assert _rel(got32, ref32) <= TOL32[kind], _rel(got32, ref32)
    assert _rel(got32, ref64) <= 2 * _rel(ref32, ref64) + 1e-6


def test_wrappers_on_cpu_tensors_run_the_plain_versions():
    fields = _fields(2)["adjoint"]
    t = lambda a: torch.as_tensor(np.array(a))
    km.reset_launches()
    out = sk.bicgstab_adjoint_spectral(*_mats("adjoint_spectral", t),
                                       *map(t, fields), TAU, 0.5 * DT,
                                       n_iter=5)
    ref = sk.bicgstab_adjoint_spectral_plain(
        *_mats("adjoint_spectral", t), *map(t, fields), TAU, 0.5 * DT,
        n_iter=5)
    assert torch.equal(out, ref)
    assert all(v == 0 for v in km.launch_counts().values())
    assert set(km.launch_counts()) >= {
        "bicgstab_schur_spectral", "bicgstab_adjoint_spectral",
        "bicgstab_schur", "bicgstab_adjoint"}
    assert km.PLAIN.adjoint_raw is sk.bicgstab_adjoint_plain


def _solve_case(kind, n, m, B, seed=2):
    """A solve's numpy arguments on an (n, m) grid (operators from vch_tpu's
    make_spectral_op_2d, fields as `_fields`), B members: the spectral
    operators for the spectral kinds, the raw ones (Laplacian factors
    first) for "adjoint"."""
    op = jls.make_spectral_op_2d(n - 1, m - 1, 1.0 / (n - 1), 1.0 / (m - 1),
                                 dtype=jnp.float64)
    o = {k: np.asarray(v) for k, v in op._asdict().items()}
    mats = ((o["Vx_inv"], o["Vy_inv"].T, o["Vx"], o["Vy"].T, o["lam"])
            if "spectral" in kind else
            (o["Lx"], o["Ly"].T, o["Vx_inv"], o["Vy_inv"].T, o["Vx"],
             o["Vy"].T))
    rng = np.random.default_rng(seed)
    sh = (B, n, m)
    lam = o["lam"]
    mean = lambda a: a.mean(axis=(1, 2), keepdims=True)
    phi = np.clip(0.5 * rng.standard_normal(sh), -0.95, 0.95)
    if kind.startswith("schur"):
        d = 2 * C1 / (1 - np.clip(phi * phi, 0, 1 - 1e-4))
        denom = 1 / DT + 0.5 * KAPPA * lam ** 2 - (TAU / DT + mean(d)) * lam
        return mats, (denom, d, rng.standard_normal(sh))
    fpp = 2 * C1 / (1 - phi * phi) - 2 * C2
    half = 0.5 * DT
    dena = 1 - TAU * lam + half * lam ** 2 - half * mean(fpp) * lam
    return mats, (1 / np.sqrt(np.abs(dena)), fpp, rng.standard_normal(sh),
                  rng.standard_normal(sh))


# the cluster solves' wrappers (one member per thread-block cluster on the
# card) and their one-CTA oracles
CLUSTER_SOLVES = [(kind, fn) for kind in ("adjoint_spectral",
                                          "schur_spectral", "adjoint")
                  for fn in (f"bicgstab_{kind}", f"_bicgstab_{kind}_cta")]


@pytest.mark.parametrize("kind,fn", CLUSTER_SOLVES)
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("n,m", [(N + 1, N + 1), (17, 13)])
def test_adjoint_spectral_wrapper_on_cpu_matches_pallas_kernel(n, m,
                                                               batched, kind,
                                                               fn):
    """Each cluster solve's wrapper (`bicgstab_adjoint_spectral`,
    `bicgstab_schur_spectral`, `bicgstab_adjoint`: the cluster kernels on
    the card) and its one-CTA oracle on CPU tensors run the plain version,
    with no launch counted, and match the Pallas kernel in interpret mode as
    one (n, m) solve and, vmapped, on a (3, n, m) batch, on a square and a
    rectangular grid: float64 1e-10, float32 TOL32 and no farther from the
    float64 kernel than twice the float32 kernel plus 1e-6; the scalars the
    per-step solvers pass as 0-d tensors (the sweep's dt/2, the marcher's
    1/dt and tau/dt) passed so."""
    mats, fields = _solve_case(kind, n, m, 3 if batched else 1)
    pick = (lambda a: a) if batched else (lambda a: a[0])
    scal, n_iter = _scalars(kind)
    wrapper = getattr(sk, fn)
    outs = {}
    for name in ("float64", "float32"):
        j = lambda a: jnp.asarray(a, NP[name])
        f = lambda *fs: _pallas(kind)(*map(j, mats), *fs, *scal,
                                      n_iter=n_iter, interpret=True)
        ref = np.asarray(jax.vmap(f)(*map(j, fields)) if batched
                         else f(*[j(a[0]) for a in fields]))
        t = lambda a: torch.as_tensor(np.array(a), dtype=TD[name])
        on_card = tuple(t(v) if i < 2 else v for i, v in enumerate(scal)) \
            if kind.startswith("schur") else (scal[0], t(scal[1]))
        km.reset_launches()
        got = wrapper(*map(t, mats), *[t(pick(a)) for a in fields],
                      *on_card, n_iter=n_iter)
        assert all(v == 0 for v in km.launch_counts().values())
        assert got.shape == ref.shape == ((3,) if batched else ()) + (n, m)
        outs[name] = (got.numpy(), ref)
    got64, ref64 = outs["float64"]
    got32, ref32 = outs["float32"]
    assert _rel(got64, ref64) <= 1e-10
    assert got32.dtype == np.float32 and np.isfinite(got32).all()
    assert _rel(got32, ref32) <= TOL32[kind], _rel(got32, ref32)
    assert _rel(got32, ref64) <= 2 * _rel(ref32, ref64) + 1e-6


@pytest.mark.parametrize("n,m", [(17, 17), (65, 65), (129, 129), (257, 257),
                                 (513, 513), (769, 769), (65, 257)])
def test_kernel_routing_rule_matches_vch_tpu(n, m):
    assert sk.per_solve_kernels_fit(n, m) == pk.kernel_vmem_fits(n, m)


def _schur_problem(dtype_name, seed=1):
    """The Schur operator S and its cosine-diagonal preconditioner on one
    member, in both packages, with a right-hand side."""
    o = _op_np()
    rng = np.random.default_rng(seed)
    phi = np.clip(0.4 * rng.standard_normal((N + 1, N + 1)), -0.9, 0.9)
    rhs = rng.standard_normal((N + 1, N + 1))
    d = 2 * C1 / (1 - np.clip(phi * phi, 0, 1 - 1e-4))
    denom = 1 / DT + 0.5 * KAPPA * o["lam"] ** 2 - (TAU / DT + d.mean()) \
        * o["lam"]
    jop = jls.SpectralOp2D(*[jnp.asarray(o[k], NP[dtype_name])
                             for k in jls.SpectralOp2D._fields])
    top = spectral_op_from_numpy(o, dtype=TD[dtype_name])
    tops = tls.ops_2d(top)

    def pair(mod_lap, conv, op_, to_s, from_s, lap_args):
        dd, den = conv(d), conv(denom)
        lap = lambda v: mod_lap(*lap_args, v)
        S = lambda v: (1 / DT) * v - lap((TAU / DT + dd) * v
                                         - 0.5 * KAPPA * lap(v))
        M = lambda v: from_s(op_, to_s(op_, v) / den)
        return S, M, conv(rhs)

    j = lambda a: jnp.asarray(a, NP[dtype_name])
    t = lambda a: torch.as_tensor(a, dtype=TD[dtype_name])
    jS, jM, jb = pair(jax_lap, j, jop, jls.to_spectral, jls.from_spectral,
                      (jop.Lx, jop.Ly))
    tS, tM, tb = pair(tls.apply_laplacian_2d_t, t, top, tls.to_spectral,
                      tls.from_spectral, (tops.Lx, tops.LyT))
    return (jS, jM, jb), (tS, tM, tb), (jop, top, tops), phi


@pytest.mark.parametrize("solver", ["bicgstab", "bicgstab_fixed",
                                    "bicgstab_split", "bicgstab_split_fixed"])
def test_composed_krylov_solvers_match_vch_tpu(solver):
    """The composed solvers on the Schur system (the split ones with the
    cosine-diagonal preconditioner's square root, warm started), float64:
    adaptive to tol 1e-9, fixed-trip with 6 trips."""
    (jS, jM, jb), (tS, tM, tb), (jop, top, _), _ = _schur_problem("float64")
    if solver in ("bicgstab", "bicgstab_fixed"):
        kw = (dict(tol=1e-9, max_iter=200) if solver == "bicgstab"
              else dict(n_iter=6))
        ref = getattr(jls, solver)(jS, jb, jM, **kw)
        got = getattr(tls, solver)(tS, tb, tM, **kw)
    else:
        o = _op_np()
        den = np.abs(1 / DT + 0.5 * KAPPA * o["lam"] ** 2
                     - (TAU / DT) * o["lam"])
        isd = 1 / np.sqrt(den)
        x0 = np.random.default_rng(5).standard_normal(isd.shape)
        kw = (dict(tol=1e-9, max_iter=200) if solver == "bicgstab_split"
              else dict(n_iter=6))
        ji, ti = jnp.asarray(isd), torch.as_tensor(isd)
        jP = lambda v: jls.from_spectral(jop, jls.to_spectral(jop, v) * ji)
        jPi = lambda v: jls.from_spectral(jop, jls.to_spectral(jop, v) / ji)
        tP = lambda v: tls.from_spectral(top, tls.to_spectral(top, v) * ti)
        tPi = lambda v: tls.from_spectral(top, tls.to_spectral(top, v) / ti)
        ref = getattr(jls, solver)(jS, jb, jP, jPi, x0=jnp.asarray(x0), **kw)
        got = getattr(tls, solver)(tS, tb, tP, tPi, x0=torch.as_tensor(x0),
                                   **kw)
    assert _rel(got.numpy(), np.asarray(ref)) <= 1e-10


@pytest.mark.parametrize("dtype_name,route", [
    ("float64", "adaptive"), ("float32", "fixed"),
    ("float32", "spectral"), ("float32", "raw")])
def test_newton_schur_solve_matches_vch_tpu(dtype_name, route):
    """newton_schur_solve_2d on one Newton state: the adaptive solve
    (float64), the composed fixed-trip solve, and the two per-solve kernels
    (use_pallas; vch_tpu's in interpret mode, the port's plain versions on
    CPU tensors). dphi and dmu to 1e-10 in float64; in float32 to 1e-5 of
    their largest entry (measured 1e-7 to 1e-6)."""
    _, _, (jop, _, tops), phi = _schur_problem(dtype_name)
    rng = np.random.default_rng(7)
    Rphi, Rmu = rng.standard_normal((2, N + 1, N + 1))
    j = lambda a: jnp.asarray(a, NP[dtype_name])
    t = lambda a: torch.as_tensor(a, dtype=TD[dtype_name])
    kw = dict(tol=1e-9, max_iter=200,
              fixed_iters=None if route == "adaptive" else 4,
              use_pallas=route in ("spectral", "raw"),
              pallas_variant="raw" if route == "raw" else "spectral")
    jd = jls.newton_schur_solve_2d(jop, j(phi), j(Rphi), j(Rmu), DT, TAU, C1,
                                   KAPPA, 1e-2, pallas_interpret=True, **kw)
    km.reset_launches()
    td = tls.newton_schur_solve_2d(tops, t(phi), t(Rphi), t(Rmu), DT, TAU, C1,
                                   KAPPA, 1e-2, entries=km.KERNELS, **kw)
    assert all(v == 0 for v in km.launch_counts().values())
    tol = 1e-10 if dtype_name == "float64" else 1e-5
    for a, b in zip(td, jd):
        assert _rel(a.numpy(), np.asarray(b)) <= tol


ENTRY_POINTS = ["ForwardSolver2D", "AdjointSolver2D", "LowMemPipeline2D",
                "BatchedProblem2D", "LowMemBatchedProblem2D",
                "make_batched_problem_2d", "ControlProblem2D"]


def _construct(name, **kw):
    from vch_tpu_torch.config import ForwardSolverConfig2D
    from vch_tpu_torch.control.problems import ControlProblem2D
    from vch_tpu_torch.models.adjoint2d import AdjointSolver2D
    from vch_tpu_torch.models.forward2d import ForwardSolver2D
    from vch_tpu_torch.models.lowmem import LowMemPipeline2D
    from vch_tpu_torch.parallel import batch
    cfg = ForwardSolverConfig2D(Nx=12, Ny=12, T=0.02)
    ctor = {"ForwardSolver2D": ForwardSolver2D,
            "AdjointSolver2D": AdjointSolver2D,
            "LowMemPipeline2D": LowMemPipeline2D,
            "BatchedProblem2D": batch.BatchedProblem2D,
            "LowMemBatchedProblem2D": batch.LowMemBatchedProblem2D,
            "make_batched_problem_2d": batch.make_batched_problem_2d,
            "ControlProblem2D": ControlProblem2D}[name]
    return ctor(cfg, **kw)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_default_to_the_card(name, monkeypatch):
    """With no device given an entry point runs on CUDA: on a machine
    without it, constructing raises instead of running on the CPU; with
    device="cpu" it runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _construct(name)
    obj = _construct(name, device="cpu")
    solver = getattr(obj, "solver", obj)
    assert solver.dts.device.type == "cpu"


# --------------------------------------------------------------------------
# the three operator applies and the member-tiled Schur solve

APPLY_TOL32 = 1e-5      # float32 against the Pallas kernel, of |out|max


def _apply_case(name, B, dtype_name, seed=2):
    """(Pallas function, plain function, arguments as numpy) of one apply on
    B members; the operators first, then the per-member fields."""
    o = _op_np()
    rng = np.random.default_rng(seed)
    sh = (B, N + 1, N + 1)
    v = rng.standard_normal(sh)
    d = 1.5 + rng.random(sh)
    if name == "schur_apply":
        return (pk.schur_apply_pallas, sk.schur_apply_plain,
                (o["Lx"], o["Ly"].T), (d, v), (1 / DT, TAU / DT, 0.5 * KAPPA))
    if name == "adjoint_apply":
        return (pk.adjoint_apply_pallas, sk.adjoint_apply_plain,
                (o["Lx"], o["Ly"].T), (rng.standard_normal(sh), v),
                (TAU, 0.5 * DT))
    denom = (1.0 + np.abs(o["lam"])) * d
    return (pk.spectral_solve_pallas, sk.spectral_solve_plain,
            (o["Vx_inv"], o["Vy_inv"].T, o["Vx"], o["Vy"].T), (denom, v), ())


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("name", ["schur_apply", "adjoint_apply",
                                  "spectral_solve"])
def test_plain_apply_matches_pallas_kernel(name, B):
    """Each operator apply's plain version against the Pallas kernel in
    interpret mode: one (n, m) field, and vmap over a (B, n, m) batch;
    float64 1e-10 and float32 1e-5 of |out|max."""
    results = {}
    for dtype_name in ("float64", "float32"):
        pallas, plain, mats, fields, scal = _apply_case(name, B, dtype_name)
        j = lambda a: jnp.asarray(a, NP[dtype_name])
        t = lambda a: torch.as_tensor(np.array(a), dtype=TD[dtype_name])
        f = lambda *fs: pallas(*map(j, mats), *fs, *scal, interpret=True)
        if B > 1:
            ref = np.asarray(jax.vmap(f)(*map(j, fields)))
            got = plain(*map(t, mats), *map(t, fields), *scal).numpy()
        else:
            ref = np.asarray(f(*[j(a[0]) for a in fields]))
            got = plain(*map(t, mats), *[t(a[0]) for a in fields],
                        *scal).numpy()
        assert got.shape == ref.shape and got.dtype == NP[dtype_name]
        results[dtype_name] = (got, ref)
    got64, ref64 = results["float64"]
    got32, ref32 = results["float32"]
    assert _rel(got64, ref64) <= 1e-10
    assert _rel(got32, ref32.astype(np.float64)) <= APPLY_TOL32
    assert _rel(got32, ref64) <= 2 * _rel(ref32, ref64) + 1e-6


def test_apply_wrappers_on_cpu_tensors_run_the_plain_versions():
    t = lambda a: torch.as_tensor(np.array(a))
    km.reset_launches()
    for name in ("schur_apply", "adjoint_apply", "spectral_solve"):
        _, plain, mats, fields, scal = _apply_case(name, 2, "float64")
        args = [*map(t, mats), *map(t, fields), *scal]
        assert torch.equal(getattr(sk, name)(*args), plain(*args))
    # a denom shared by the members broadcasts
    _, plain, mats, (denom, v), _ = _apply_case("spectral_solve", 2,
                                                "float64")
    shared = sk.spectral_solve(*map(t, mats), t(denom[0]), t(v))
    assert torch.equal(shared[0], plain(*map(t, mats), t(denom[0]), t(v[0])))
    counts = km.launch_counts()
    assert {"schur_apply", "adjoint_apply", "spectral_solve",
            "march_fused_1d"} <= set(counts)
    assert not any(counts.values())


@pytest.mark.parametrize("block_b", [2, None])
@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
def test_batched_schur_solve_matches_member_tiled_pallas_kernel(dtype_name,
                                                                block_b):
    """`bicgstab_schur` on a (B, n, m) batch against vch_tpu's member-tiled
    `bicgstab_schur_pallas_batched` in interpret mode, with block_b = 2 on
    B = 5 (a batch its tiling has to pad) and its automatic block: the
    batched launch of the per-member solve is that kernel's counterpart.
    float64 1e-10; float32 1e-5, and no farther from float64 than twice the
    Pallas float32 result plus 1e-6."""
    B = 5
    fields = _fields(B, seed=4)["schur"]
    scal, n_iter = _scalars("schur")
    out = {}
    for name in ("float64", dtype_name):
        j = lambda a: jnp.asarray(a, NP[name])
        t = lambda a: torch.as_tensor(np.array(a), dtype=TD[name])
        ref = np.asarray(pk.bicgstab_schur_pallas_batched(
            *_mats("schur", j), *map(j, fields), *scal, n_iter=n_iter,
            block_b=block_b, interpret=True))
        got = sk.bicgstab_schur(*_mats("schur", t), *map(t, fields), *scal,
                                n_iter=n_iter).numpy()
        assert got.shape == ref.shape == (B, N + 1, N + 1)
        out[name] = (got, ref)
    got64, ref64 = out["float64"]
    assert _rel(got64, ref64) <= 1e-10
    if dtype_name == "float32":
        got32, ref32 = out["float32"]
        assert _rel(got32, ref32.astype(np.float64)) <= TOL32["schur"]
        assert _rel(got32, ref64) <= 2 * _rel(ref32, ref64) + 1e-6
