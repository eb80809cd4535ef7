"""Port parity for the exact-gradient mode (vch_tpu's implicit adjoint,
models/adjoint_exact{1,2}d.py): `vch_tpu_torch.models.adjoint_exact1d/2d`
and `ControlProblem1D/2D(gradient_mode="exact")` against vch_tpu on the CPU,
both in float64 on the same seeded inputs.

Tolerances:
  - the exact gradient density and J against vch_tpu's: 1e-9 relative in
    1D (N = 16, T = 0.05, M = 5), 1e-8 in 2D (12 x 12, T = 0.05, Newton
    1e-11, Krylov 1e-12); both measured at ~1e-15;
  - central finite differences of the port's own J (eps 1e-5) against
    g W at three entries in 1D and two in 2D, at vch_tpu's own gates
    (tests/test_exact_adjoint.py): 1e-5 relative in 1D, 1e-4 in 2D;
  - three PGD iterations of the control problems against vch_tpu's: cost
    histories 1e-9 relative (measured ~4e-16), trials per iteration equal,
    costs never rising (defaults_exact keeps no ascent step);
  - the float32 exact gradient of the problem's first iterate (u = 0, its
    targets) against the float64 one with Newton at 1e-10, max |g32 - g64|
    / max |g64|: in 1D at config 1's shape (N = 128, T = 1, M = 100)
    measured 1.23e-2 on the CPU, in 2D at 32 x 32, T = 1 (M = 100)
    2.87e-3; each gated at 10x its figure (EXACT_F32_REL), which
    chip_smoke.py's phases 10x (config 1) and 8x (config 3's 64 x 64) take
    on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from vch_tpu.config import ForwardSolverConfig1D as JaxConfig1D
from vch_tpu.config import ForwardSolverConfig2D as JaxConfig2D
from vch_tpu.config import OptimizationConfig as JaxOptConfig
from vch_tpu.control.pgd import PGDSettings as JaxPGDSettings
from vch_tpu.control.problems import ControlProblem1D as JaxProblem1D
from vch_tpu.control.problems import ControlProblem2D as JaxProblem2D
from vch_tpu.models.adjoint_exact1d import ExactAdjoint1D as JaxExact1D
from vch_tpu.models.adjoint_exact2d import ExactAdjoint2D as JaxExact2D

from vch_tpu_torch.config import (ForwardSolverConfig1D,
                                  ForwardSolverConfig2D, OptimizationConfig,
                                  PGDSettings)
from vch_tpu_torch.control.problems import ControlProblem1D, ControlProblem2D
from vch_tpu_torch.models.adjoint_exact1d import ExactAdjoint1D
from vch_tpu_torch.models.adjoint_exact2d import ExactAdjoint2D
from vch_tpu_torch.ops import march as km

torch.set_num_threads(2)

EXACT_F32_REL = {"1d": 0.123, "2d": 2.87e-2}
KW1 = dict(N=16, T=0.05)
KW2 = dict(Nx=12, Ny=12, T=0.05, newton_tol=1e-11, krylov_tol=1e-12)
B1D = dict(b1=0.3, b2=13.0, b3=0.0019)
B2D = dict(b1=5.0, b2=10.0, b3=1e-4)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(
        np.asarray(b)).max()


def _u(M, shape):
    return 0.1 * np.random.default_rng(0).standard_normal((M + 1,) + shape)


def test_defaults_exact_are_vch_tpus():
    port, ref = PGDSettings.defaults_exact(), JaxPGDSettings.defaults_exact()
    fields = dataclasses.fields(PGDSettings)
    assert [f.name for f in fields] == [
        f.name for f in dataclasses.fields(JaxPGDSettings)]
    for f in fields:
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert not port.keep_failed_step and port.ls_max_trials == 15


def test_exact_gradient_1d_matches_vch_tpu():
    port = ExactAdjoint1D(ForwardSolverConfig1D(**KW1), device="cpu")
    ref = JaxExact1D(JaxConfig1D(**KW1))
    M = port.solver.M
    assert M == 5
    u = _u(M, (17,))
    phi_Q = 0.2 * np.random.default_rng(1).standard_normal((M + 1, 17))
    g, J = port.gradient(u, phi_Q=phi_Q, **B1D)
    gj, Jj = ref.gradient(u, phi_Q=phi_Q, **B1D)
    assert g.dtype == torch.float64 and g.shape == (M + 1, 17)
    assert _rel(g.numpy(), gj) < 1e-9
    assert abs(J / Jj - 1) < 1e-9
    assert np.allclose(port._wt_t, ref._wt_t, rtol=0, atol=1e-15)
    assert np.allclose(port._wx, ref._wx, rtol=0, atol=1e-15)


def test_exact_gradient_2d_matches_vch_tpu():
    port = ExactAdjoint2D(ForwardSolverConfig2D(**KW2), device="cpu")
    ref = JaxExact2D(JaxConfig2D(**KW2))
    M = port.solver.M
    u = _u(M, (13, 13))
    g, J = port.gradient(u, **B2D)
    gj, Jj = ref.gradient(u, **B2D)
    assert g.shape == (M + 1, 13, 13)
    assert _rel(g.numpy(), gj) < 1e-8
    assert abs(J / Jj - 1) < 1e-8
    assert np.allclose(port._wxy, ref._wxy, rtol=0, atol=1e-15)


def _fd(ea, u, idx, b):
    eps = 1e-5
    up, um = u.copy(), u.copy()
    up[idx] += eps
    um[idx] -= eps
    return (ea.gradient(up, **b)[1] - ea.gradient(um, **b)[1]) / (2 * eps)


def test_exact_gradient_1d_matches_finite_differences():
    ea = ExactAdjoint1D(ForwardSolverConfig1D(newton_tol=1e-10, **KW1),
                        device="cpu")
    M = ea.solver.M
    u = _u(M, (17,))
    g = ea.gradient(u, **B1D)[0].numpy()
    for i, j in [(0, 4), (2, 9), (M, 13)]:
        fd = _fd(ea, u, (i, j), B1D)
        pred = g[i, j] * ea._wt_t[i] * ea._wx[j]
        assert abs(fd - pred) < 1e-5 * max(abs(fd), 1e-8), (i, j, fd, pred)


def test_exact_gradient_2d_matches_finite_differences():
    ea = ExactAdjoint2D(ForwardSolverConfig2D(**KW2), device="cpu")
    M = ea.solver.M
    u = _u(M, (13, 13))
    g = ea.gradient(u, **B2D)[0].numpy()
    for i, j, k in [(1, 5, 7), (M, 8, 3)]:
        fd = _fd(ea, u, (i, j, k), B2D)
        pred = g[i, j, k] * ea._wt_t[i] * ea._wxy[j, k]
        assert abs(fd - pred) < 1e-4 * max(abs(fd), 1e-8), (i, j, k, fd,
                                                           pred)


def _check_pgd(res, jres):
    c, jc = np.asarray(res.cost_history), np.asarray(jres.cost_history)
    assert np.abs(c / jc - 1).max() < 1e-9, (c, jc)
    assert res.ls_trials_per_iter == [int(n) for n in jres.ls_trials_per_iter]
    assert (np.diff(c) <= 0).all() and c[-1] < c[0]


@pytest.mark.parametrize("alpha_max", [100.0, 1000.0])
def test_exact_pgd_1d_matches_vch_tpu(alpha_max):
    """At alpha_max 1000 the second iteration backtracks (three trials)."""
    prob = ControlProblem1D(ForwardSolverConfig1D(**KW1),
                            OptimizationConfig(alpha_max=alpha_max),
                            gradient_mode="exact", device="cpu")
    jprob = JaxProblem1D(JaxConfig1D(**KW1), JaxOptConfig(alpha_max=alpha_max),
                         gradient_mode="exact")
    M = prob.solver.M
    # the core layout: M + 1 rows, the targets on the core time grid
    assert prob.phi_hist0.shape == (M + 1, 17)
    assert np.abs(prob.phi_hist0.numpy()
                  - np.asarray(jprob.phi_hist0)).max() < 1e-12
    assert np.abs(prob.phi_Q_target.numpy()
                  - np.asarray(jprob.phi_Q_target)).max() < 1e-12
    assert np.array_equal(prob.t_hist, jprob.t_hist)
    km.reset_launches()
    res = prob.optimize(max_iter=3, verbose=False)
    assert not any(km.launch_counts().values())
    _check_pgd(res, jprob.optimize(max_iter=3, verbose=False))
    assert res.u_optimal.shape == (M + 1, 17)
    d2 = prob.second_order_check(res, num_directions=2)
    assert len(d2) == 2 and np.isfinite(d2).all()


def test_exact_pgd_2d_matches_vch_tpu():
    kw = dict(Nx=12, Ny=12, T=0.05)
    prob = ControlProblem2D(ForwardSolverConfig2D(**kw),
                            OptimizationConfig.defaults_2d(),
                            gradient_mode="exact", device="cpu")
    jprob = JaxProblem2D(JaxConfig2D(**kw), JaxOptConfig.defaults_2d(),
                         gradient_mode="exact")
    assert prob.loop.adjoint == prob._adjoint_exact
    assert not prob.loop.s.keep_failed_step
    res = prob.optimize(max_iter=3, verbose=False)
    _check_pgd(res, jprob.optimize(max_iter=3, verbose=False))


@pytest.mark.parametrize("dim", ["1d", "2d"])
def test_exact_gradient_float32_against_float64(dim):
    """The problem's first-iterate gradient in float32 against float64 with
    Newton at 1e-10: in 1D at config 1's N = 128, T = 1, in 2D at 32 x 32,
    T = 1 (M = 100 both); the figures phases 10x and 8x gate on the card."""
    if dim == "1d":
        kw, tight = dict(N=128, T=1.0), dict(newton_tol=1e-10)
        prob = ControlProblem1D(ForwardSolverConfig1D(dtype="float32", **kw),
                                gradient_mode="exact", device="cpu")
        twin = ExactAdjoint1D(ForwardSolverConfig1D(**kw, **tight),
                              device="cpu")
    else:
        kw, tight = dict(Nx=32, Ny=32, T=1.0), dict(newton_tol=1e-10)
        prob = ControlProblem2D(ForwardSolverConfig2D(
            dtype="float32", newton_tol=2e-4, **kw),
            OptimizationConfig.defaults_2d(), gradient_mode="exact",
            device="cpu")
        twin = ExactAdjoint2D(ForwardSolverConfig2D(**kw, **tight),
                              device="cpu")
    opt = prob.opt_config
    u0 = prob.initial_control()
    g32, J32 = prob._exact._grad(u0, prob._phi0_dev, opt.b1, opt.b2, opt.b3,
                                 prob.phi_Q_target, prob.phi_T_target)
    d = lambda t: t.double()
    g64, J64 = twin._grad(d(u0), torch.as_tensor(prob.phi0), opt.b1, opt.b2,
                          opt.b3, d(prob.phi_Q_target), d(prob.phi_T_target))
    assert g32.dtype == torch.float32 and prob.solver.M == 100
    assert torch.isfinite(g32).all()
    rel = float((d(g32) - g64).abs().max() / g64.abs().max())
    assert rel < EXACT_F32_REL[dim], rel
    assert abs(float(J32) / float(J64) - 1) < 1e-3
