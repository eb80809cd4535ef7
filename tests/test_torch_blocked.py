"""Port parity for the member-blocked and segment kernels: their plain
PyTorch versions (vch_tpu_torch/ops/march.py) against vch_tpu's Pallas
kernels run in interpret mode on the same numpy inputs, and the solvers'
routing between the blocked and the per-member kernels. The CUDA kernels
are held against the plain versions in tests/test_torch_cuda.py and
chip_smoke.py.

Tolerances: float64 to 1e-10 (the same recurrences; only summation order
differs); float32 phi to 1e-5 absolute with Newton counts equal, and r to
1e-4 relative, as tests/test_torch_march.py gates the whole sweep: these
float32 sweeps, run by PyTorch on the CPU and by JAX in interpret mode,
differ by 1.7e-5 to 4.0e-5 relative on these inputs (the condition-1e6
operator amplifies the float32 roundoff of sums taken in another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from vch_tpu.config import DELTA_SEP
from vch_tpu.config import ForwardSolverConfig2D as JaxConfig2D
from vch_tpu.models.timegrid import build_dt_schedule
from vch_tpu.ops import pallas_march as pm
from vch_tpu.ops.grids import grid_2d
from vch_tpu.ops.linsolve import make_spectral_op_2d
from vch_tpu.ops.potential import init_phi_random_2d

from vch_tpu_torch.config import ForwardSolverConfig2D
from vch_tpu_torch.models.adjoint2d import AdjointSolver2D
from vch_tpu_torch.models.forward2d import ForwardSolver2D
from vch_tpu_torch.ops import march as tm
from vch_tpu_torch.utils.convert import spectral_op_from_numpy

torch.set_num_threads(2)

N, T, B, BB, K = 16, 0.06, 4, 2, 4
PHYS = dict(tau=0.05, c1=0.75, c2=1.0, kappa=0.01 ** 2, gamma=10.0)
TOL = {"float64": 1e-10, "float32": 1e-5}       # phi, absolute
TOL_R = {"float64": 1e-10, "float32": 1e-4}     # r, relative


def _np_dt(name):
    return np.float64 if name == "float64" else np.float32


def _t_dt(name):
    return torch.float64 if name == "float64" else torch.float32


def _inputs(batch=B, useed=0):
    op = make_spectral_op_2d(N, N, 1.0 / N, 1.0 / N, dtype=jnp.float64)
    op_np = {k: np.asarray(v) for k, v in op._asdict().items()}
    _, _, wts = grid_2d(N, N, 1.0, 1.0)
    dts = build_dt_schedule(T, 1e-2)
    rng = np.random.default_rng(useed)
    phi0 = np.stack([init_phi_random_2d(N, N, DELTA_SEP, amp=0.1, seed=42 + i)
                     for i in range(batch)])
    u = 0.1 * rng.standard_normal((batch, len(dts) + 1, N + 1, N + 1))
    return op_np, wts, dts, phi0, u


def _jax_ops(op_np, name, with_wts=None):
    j = lambda a: jnp.asarray(a, _np_dt(name))
    ops = (j(op_np["Lx"]), j(op_np["Ly"].T), j(op_np["Vx_inv"]),
           j(op_np["Vy_inv"].T), j(op_np["Vx"]), j(op_np["Vy"].T),
           j(op_np["lam"]))
    return ops if with_wts is None else ops + (j(with_wts),)


def _torch_ops(op_np, name, with_wts=None):
    op = spectral_op_from_numpy(op_np, dtype=_t_dt(name))
    c = lambda t: t.contiguous()
    ops = (op.Lx, c(op.Ly.T), op.Vx_inv, c(op.Vy_inv.T), op.Vx, c(op.Vy.T),
           op.lam)
    if with_wts is None:
        return ops
    return ops + (torch.as_tensor(with_wts, dtype=_t_dt(name)),)


def _march_kw(name):
    f64 = name == "float64"
    return dict(PHYS, delta_sep=DELTA_SEP, area=1.0,
                newton_tol=1e-6 if f64 else 2e-4,
                newton_rtol=0.0 if f64 else 1e-5, newton_max_iter=500,
                n_trips=3, stagnation_exit=not f64)


def _adj_kw():
    return dict(tau=PHYS["tau"], gamma=PHYS["gamma"], c1=PHYS["c1"],
                c2=PHYS["c2"], n_trips=5)


@pytest.mark.parametrize("name", ["float64", "float32"])
def test_blocked_march_plain_matches_pallas_blocked(name):
    _blocked_march_case(name, BB)


def _blocked_march_case(name, bb):
    op_np, wts, dts, phi0, u = _inputs()
    kw = _march_kw(name)
    j = lambda a: jnp.asarray(a, _np_dt(name))
    jh, jns, jbad = pm.march_fused_2d_blocked(
        j(dts), j(phi0), j(u), *_jax_ops(op_np, name, wts), interpret=True,
        solve_prec="highest", fwd_mm="highest", block_b=bb, **kw)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=_t_dt(name))
    before = tm.march_fused_2d_blocked.launches
    th, tns, tbad = tm.march_fused_2d_blocked(
        t(dts), t(phi0), t(u), *_torch_ops(op_np, name, wts), block_b=bb,
        **kw)
    assert tm.march_fused_2d_blocked.launches == before  # CPU: plain path
    assert th.shape == jh.shape
    diff = np.abs(th.numpy() - np.asarray(jh)).max()
    assert diff <= TOL[name], diff
    np.testing.assert_array_equal(tns.numpy(), np.asarray(jns))
    np.testing.assert_array_equal(tbad.numpy(), np.asarray(jbad))
    assert (tns.numpy() > 0).all()


def _adjoint_inputs(name):
    op_np, _, dts, phi0, _ = _inputs(useed=1)
    M = len(dts)
    rng = np.random.default_rng(7)
    hist = np.clip(phi0[:, None] + 0.05 * rng.standard_normal(
        (B, M + 1, N + 1, N + 1)), -0.9, 0.9)
    phi_Q = 0.3 * rng.standard_normal((B, M + 1, N + 1, N + 1))
    phi_T = 0.7 * rng.standard_normal((B, N + 1, N + 1))
    b1 = np.array([5.0, 2.0, 7.5, 4.0])
    b2 = np.array([10.0, 12.0, 8.0, 9.0])
    return op_np, dts, hist, phi_Q, phi_T, b1, b2


@pytest.mark.parametrize("name", ["float64", "float32"])
def test_blocked_adjoint_plain_matches_pallas_blocked(name):
    _blocked_adjoint_case(name, BB)


def _blocked_adjoint_case(name, bb):
    op_np, dts, hist, phi_Q, phi_T, b1, b2 = _adjoint_inputs(name)
    j = lambda a: jnp.asarray(a, _np_dt(name))
    jr = np.asarray(pm.adjoint_fused_2d_blocked(
        j(dts), j(hist), j(phi_Q), j(phi_T), j(b1), j(b2),
        *_jax_ops(op_np, name), interpret=True, solve_prec="highest",
        block_b=bb, **_adj_kw()))
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=_t_dt(name))
    tr = tm.adjoint_fused_2d_blocked(
        t(dts), t(hist), t(phi_Q), t(phi_T), t(b1), t(b2),
        *_torch_ops(op_np, name), block_b=bb, **_adj_kw()).numpy()
    assert tr.shape == jr.shape
    assert (tr[:, -1] == 0).all()
    rel = np.abs(tr - jr).max() / np.abs(jr).max()
    assert rel <= TOL_R[name], rel


@pytest.mark.parametrize("name", ["float64", "float32"])
@pytest.mark.parametrize("case", [_blocked_march_case, _blocked_adjoint_case],
                         ids=["march", "adjoint"])
def test_blocked_plain_matches_pallas_at_block_4(case, name):
    """The blocks of 4 that the CUDA kernels are built for beside 2 and 8
    (one block of the four members)."""
    case(name, 4)


class _Spy:
    """Records which entry point a solver called."""

    def __init__(self):
        self.calls = []

    def entries(self):
        def wrap(fn):
            def call(*a, **k):
                self.calls.append(fn.__name__)
                return fn(*a, **k)
            return call
        return tm.Entries(*[wrap(fn) for fn in tm.KERNELS])


@pytest.mark.parametrize("batch,expect", [
    (4, ("march_fused_2d_blocked", "adjoint_fused_2d_blocked")),
    (3, ("march_fused_2d", "adjoint_fused_2d"))])
def test_solvers_route_blocked_only_when_the_batch_divides(batch, expect):
    """B % Bb == 0 takes the blocked kernels, anything else the per-member
    ones (vch_tpu/models/forward2d.py:338-353), and the results agree with
    vch_tpu's solvers on the same route (B=3 with Bb=2 is its fallback)."""
    from vch_tpu.models.adjoint2d import AdjointSolver2D as JaxAdjoint2D
    from vch_tpu.models.forward2d import ForwardSolver2D as JaxForward2D

    jcfg = JaxConfig2D(Nx=N, Ny=N, T=T, dtype="float32", newton_tol=2e-4,
                       fused_march_block=BB, fused_solve_precision="highest")
    cfg = ForwardSolverConfig2D(Nx=N, Ny=N, T=T, dtype="float32",
                                newton_tol=2e-4, fused_march_block=BB,
                                fused_solve_precision="highest")
    _, _, dts, phi0, u = _inputs(batch=batch, useed=4)
    jfwd = JaxForward2D(jcfg)
    jh, jns, _ = jfwd.march_fused_batch(jnp.asarray(u, jnp.float32),
                                        jnp.asarray(phi0, jnp.float32),
                                        interpret=True)
    jadj = JaxAdjoint2D(jcfg)
    b1 = np.linspace(2.0, 6.0, batch)
    b2 = np.linspace(12.0, 9.0, batch)
    phi_T = 0.1 * phi0
    f = lambda a: jnp.asarray(a, jnp.float32)
    jr = np.asarray(jadj.adjoint_fused_batch(
        jh, f(dts), f(b1), f(b2), jnp.zeros_like(jh), f(phi_T),
        interpret=True))

    spy = _Spy()
    fwd = ForwardSolver2D(cfg, device="cpu")
    adj = AdjointSolver2D(cfg, device="cpu")
    fwd.entries = adj.entries = spy.entries()
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    th, tns, _ = fwd.march_fused_batch(t(u), t(phi0))
    tr = adj.adjoint_fused_batch(th, t(b1), t(b2), torch.zeros_like(th),
                                 t(phi_T)).numpy()
    assert tuple(spy.calls) == expect
    assert np.abs(th.numpy() - np.asarray(jh)).max() <= 1e-5
    np.testing.assert_array_equal(tns.numpy(), np.asarray(jns))
    assert np.abs(tr - jr).max() / np.abs(jr).max() <= TOL_R["float32"]


@pytest.mark.parametrize("kw,expect", [
    (dict(Nx=64, Ny=64), 8), (dict(Nx=96, Ny=64), 8),
    (dict(Nx=128, Ny=128), 0), (dict(Nx=64, Ny=128), 0),
    (dict(Nx=64, Ny=64, fused_march_block=0), 0),
    (dict(Nx=128, Ny=128, fused_march_block=4), 4)])
def test_resolved_fused_block_matches_vch_tpu(kw, expect):
    assert ForwardSolverConfig2D(**kw).resolved_fused_block() == expect
    assert JaxConfig2D(**kw).resolved_fused_block() == expect


def test_blocked_wrappers_reject_indivisible_batches():
    op_np, wts, dts, phi0, u = _inputs(batch=3)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    with pytest.raises(ValueError, match="block_b"):
        tm.march_fused_2d_blocked(t(dts), t(phi0), t(u),
                                  *_torch_ops(op_np, "float32", wts),
                                  block_b=2, **_march_kw("float32"))


def _segments(M):
    return [(s, min(K, M - s)) for s in range(0, M, K)]


@pytest.mark.parametrize("name", ["float64", "float32"])
def test_segment_march_chain_matches_pallas_segment(name):
    """The segment march chained over M = 6 steps in segments of K = 4 and 2
    (K does not divide M), against vch_tpu's segment kernel chained the same
    way: histories, carries and Newton counts."""
    op_np, wts, dts, phi0, u = _inputs(useed=2)
    kw = _march_kw(name)
    M = len(dts)
    assert M % K != 0
    j = lambda a: jnp.asarray(a, _np_dt(name))
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=_t_dt(name))
    jops, tops = _jax_ops(op_np, name, wts), _torch_ops(op_np, name, wts)
    # the carry at t = 0 as the low-memory forward builds it
    fwd = ForwardSolver2D(ForwardSolverConfig2D(Nx=N, Ny=N, T=T, dtype=name),
                          device="cpu")
    tphi = t(phi0)
    tmu = fwd.initialize_mu(tphi, torch.zeros_like(tphi))
    tw = torch.zeros_like(tphi)
    m0 = torch.sum(t(wts) * tphi, dim=(-2, -1))
    jphi, jmu, jw, jm0 = j(phi0), j(tmu.numpy()), j(tw.numpy()), j(m0.numpy())
    for start, length in _segments(M):
        jh, jphi, jmu, jw, jns, jbad = pm.march_fused_2d_segment(
            j(dts[start:start + length]), jphi, jmu, jw, jm0,
            j(u[:, start:start + length + 1]), *jops, interpret=True,
            solve_prec="highest", fwd_mm="highest", **kw)
        th, tphi, tmu, tw, tns, tbad = tm.march_fused_2d_segment(
            t(dts[start:start + length]), tphi, tmu, tw, m0,
            t(u[:, start:start + length + 1]), *tops, **kw)
        assert th.shape == (B, length, N + 1, N + 1)
        for a, b in ((th, jh), (tphi, jphi), (tmu, jmu), (tw, jw)):
            scale = max(1.0, float(np.abs(np.asarray(b)).max()))
            assert np.abs(a.numpy() - np.asarray(b)).max() <= TOL[name] * scale
        np.testing.assert_array_equal(tns.numpy(), np.asarray(jns))
        np.testing.assert_array_equal(tbad.numpy(), np.asarray(jbad))
        assert (tns.numpy() > 0).all()


@pytest.mark.parametrize("name", ["float64", "float32"])
def test_segment_adjoint_chain_matches_pallas_segment(name):
    """The segment sweep chained backward over M = 6 levels in segments of
    2 and 4 from a (p, q, r) carry, against vch_tpu's segment kernel, and
    against the whole-sweep plain version it must reproduce."""
    op_np, dts, hist, phi_Q, phi_T, b1, b2 = _adjoint_inputs(name)
    M = len(dts)
    j = lambda a: jnp.asarray(a, _np_dt(name))
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=_t_dt(name))
    jops, tops = _jax_ops(op_np, name), _torch_ops(op_np, name)
    adj = AdjointSolver2D(ForwardSolverConfig2D(Nx=N, Ny=N, T=T, dtype=name),
                          device="cpu")
    p, q, r = adj.terminal(t(hist[:, M]), t(phi_T), t(b2))
    jp, jq, jr_ = j(p.numpy()), j(q.numpy()), j(r.numpy())
    parts = []
    for start, length in reversed(_segments(M)):
        sl = slice(start, start + length + 1)
        jseg, jp, jq, jr_ = pm.adjoint_fused_2d_segment(
            j(dts[start:start + length]), j(hist[:, sl]), j(phi_Q[:, sl]),
            jp, jq, jr_, j(b1), *jops, interpret=True, solve_prec="highest",
            **_adj_kw())
        tseg, p, q, r = tm.adjoint_fused_2d_segment(
            t(dts[start:start + length]), t(hist[:, sl]), t(phi_Q[:, sl]),
            p, q, r, t(b1), *tops, **_adj_kw())
        assert tseg.shape == (B, length, N + 1, N + 1)
        for a, b in ((tseg, jseg), (p, jp), (q, jq), (r, jr_)):
            b = np.asarray(b)
            rel = np.abs(a.numpy() - b).max() / max(np.abs(b).max(), 1e-30)
            assert rel <= TOL_R[name], rel
        parts.insert(0, tseg)
    whole = tm.adjoint_fused_2d_plain(t(dts), t(hist), t(phi_Q), t(phi_T),
                                      t(b1), t(b2), *tops, **_adj_kw())
    chained = torch.cat(parts + [torch.zeros_like(whole[:, :1])], dim=1)
    rel = (chained - whole).abs().max() / whole.abs().max()
    assert rel <= TOL_R[name], rel
