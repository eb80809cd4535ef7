"""Port parity for the single-scenario 2D control path: the per-step
marcher (ForwardSolver2D.simulate), the per-step adjoint sweep
(AdjointSolver2D.run), ControlProblem2D with its PGD loop and the two
diagnostics, on the CPU, against the reference's golden file
tests/golden/ref_2d_n32.npz (32x32, T = 0.25) in float64 and against
vch_tpu on the same inputs.

Tolerances: the golden gates of vch_tpu's own tests (phi_hist 1e-9,
tests/test_forward_2d.py; p, q, r 1e-8 relative, tests/test_backward_2d.py;
cost_traj 1e-6 relative and u_final 1e-5, tests/test_pgd_2d.py), the
discrete-adjoint gate (residual below 5e-7, the swapped operator ordering
more than 100x worse), Newton counts equal. Float32 against vch_tpu: cost
history 2e-5 relative (measured 1e-7 to 1e-6: float32 sums in another
order) and equal line-search trials; the float32 sweeps against float64 as
vch_tpu's float32 sweep is held (cosine above 0.9999, max error below 5e-3
of |r|).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vch_tpu.config import ForwardSolverConfig2D as JaxConfig2D
from vch_tpu.config import OptimizationConfig as JaxOpt
from vch_tpu.control.problems import ControlProblem2D as JaxProblem
from vch_tpu.models.forward2d import ForwardSolver2D as JaxForward

from vch_tpu_torch.config import ForwardSolverConfig2D, OptimizationConfig
from vch_tpu_torch.control.pgd import ProximalGradientLoop
from vch_tpu_torch.control.problems import ControlProblem2D
from vch_tpu_torch.control.targets import build_targets_2d
from vch_tpu_torch.models.adjoint2d import AdjointSolver2D
from vch_tpu_torch.models.forward2d import ForwardSolver2D
from vch_tpu_torch.ops import march as km
from vch_tpu_torch.ops.laplacian import laplacian_matrix_neumann
from vch_tpu_torch.ops.potential import fpp_log
from vch_tpu_torch.utils.convert import (config_from_vch_tpu,
                                         control_arrays_from_vch_tpu)

torch.set_num_threads(2)

CFG32 = dict(Nx=32, Ny=32, T=0.25)


@pytest.fixture(scope="module")
def golden():
    import os
    return np.load(os.path.join(os.path.dirname(__file__), "golden",
                                "ref_2d_n32.npz"))


def test_per_step_march_matches_golden_and_vch_tpu(golden):
    """float64 march at 32x32, T = 0.25 (adaptive Krylov): the reference's
    trajectory to 1e-9 and vch_tpu's Newton count."""
    s = ForwardSolver2D(ForwardSolverConfig2D(**CFG32), device="cpu")
    phi_hist, _, t_hist = s.simulate()
    assert np.abs(t_hist - golden["t_hist"]).max() == 0.0
    err = np.abs(phi_hist.numpy() - golden["phi_hist"]).max()
    assert err < 1e-9, err
    js = JaxForward(JaxConfig2D(**CFG32))
    js.simulate()
    assert s.last_stats.newton_solves == int(js.last_stats.newton_solves)
    assert s.last_stats.first_bad_step == -1
    # the free energy of every frame, against vch_tpu's, and its decrease
    E = s.energy_history(phi_hist).numpy()
    jE = np.asarray(js.energy_history(golden["phi_hist"]))
    assert np.abs(E - jE).max() <= 1e-12 * np.abs(jE).max()
    assert np.diff(E).max() <= 1e-9


def test_newton_residual_history_matches_vch_tpu():
    cfg = dict(Nx=16, Ny=16, T=0.1)
    s = ForwardSolver2D(ForwardSolverConfig2D(**cfg), device="cpu")
    js = JaxForward(JaxConfig2D(**cfg))
    phi0 = s.default_initial_phi()
    w0 = np.zeros_like(phi0)
    mu0 = s.initialize_mu(torch.as_tensor(phi0), torch.as_tensor(w0)).numpy()
    _, _, hist = s.newton_residual_history(phi0, mu0, w0, w0, 1e-2)
    _, _, jhist = js.newton_residual_history(phi0, mu0, w0, w0, 1e-2)
    assert len(hist) == len(jhist) >= 2
    # to 1e-8 relative above the float64 noise floor of the last residual
    np.testing.assert_allclose(hist, jhist, rtol=1e-8, atol=1e-12 * jhist[0])


def test_simulate_raises_on_a_non_finite_mass_defect():
    s = ForwardSolver2D(ForwardSolverConfig2D(Nx=12, Ny=12, T=0.03,
                                              newton_max_iter=3),
                        device="cpu")
    phi0 = s.default_initial_phi()
    phi0[3, 3] = np.nan
    with pytest.raises(RuntimeError, match="time step 0"):
        s.simulate(initial_phi=phi0)


def test_adjoint_run_matches_golden(golden):
    g = golden
    phi_T, phi_Q = build_targets_2d(g["x"], g["y"], g["t_hist"],
                                    g["phi_hist"][0], 1.0, 1.0, 0.25)
    adj = AdjointSolver2D(ForwardSolverConfig2D(**CFG32), device="cpu")
    p, q, r = (a.numpy() for a in adj.run(g["phi_hist"], g["t_hist"], 5.0,
                                          10.0, phi_Q, phi_T))
    assert np.abs(p[:2] - g["p"]).max() < 1e-8 * np.abs(g["p"]).max()
    assert np.abs(p[-1] - g["p_last"]).max() < 1e-10
    assert np.abs(q[:2] - g["q"]).max() < 1e-8 * np.abs(g["q"]).max()
    assert np.abs(r - g["r"]).max() < 1e-8 * np.abs(g["r"]).max()
    assert np.all(r[-1] == 0.0)


@pytest.mark.parametrize("use_pallas,variant", [
    (None, "spectral"), (True, "spectral"), (True, "raw")])
def test_float32_adjoint_run_against_golden(golden, use_pallas, variant):
    """The float32 sweep on the CPU: the composed split-preconditioned
    fixed-trip solve (default route), and the per-solve kernels' plain
    versions (use_pallas), held to the float64 reference r as vch_tpu's
    float32 sweep is (tests/test_backward_2d.py:175-195)."""
    g = golden
    phi_T, phi_Q = build_targets_2d(g["x"], g["y"], g["t_hist"],
                                    g["phi_hist"][0], 1.0, 1.0, 0.25)
    cfg = ForwardSolverConfig2D(**CFG32, dtype="float32",
                                use_pallas=use_pallas, pallas_variant=variant)
    adj = AdjointSolver2D(cfg, device="cpu")
    assert adj._use_pallas == bool(use_pallas)
    _, _, r32 = adj.run(g["phi_hist"].astype(np.float32), g["t_hist"], 5.0,
                        10.0, phi_Q, phi_T)
    r32, r64 = r32.numpy().astype(np.float64), g["r"]
    assert np.all(np.isfinite(r32))
    cos = np.sum(r64 * r32) / (np.linalg.norm(r64) * np.linalg.norm(r32))
    assert cos > 0.9999, cos
    assert np.abs(r32 - r64).max() < 5e-3 * np.abs(r64).max()


def test_adjoint_operator_ordering_on_a_real_forward():
    """On a real float64 forward trajectory (32x32, dt = 1e-3, kappa =
    0.03^2, the last 10 frames) the sweep satisfies A(phi_n) p_n =
    B(phi_{n+1}) p_{n+1} + src to 5e-7 relative, and the swapped ordering
    (A at n+1, B at n) is more than 100x worse
    (tests/test_backward_2d.py:246-307)."""
    cfg = ForwardSolverConfig2D(Nx=32, Ny=32, T=0.10, dt_initial=1e-3,
                                kappa=0.03 ** 2)
    fwd = ForwardSolver2D(cfg, device="cpu")
    phi_hist, (x, _), t_hist = fwd.simulate()
    phi10, t10 = phi_hist.numpy()[-10:], t_hist[-10:]
    b1, b2 = 1.0, 0.7
    phi_Q = np.zeros_like(phi10)
    adj = AdjointSolver2D(cfg, device="cpu")
    p = adj.run(phi10, t10, b1, b2, phi_Q, np.zeros((33, 33)))[0].numpy()
    L1 = laplacian_matrix_neumann(32, x[1] - x[0])
    I1 = np.eye(33)
    L = np.kron(L1, I1) + np.kron(I1, L1)
    L2 = L @ L
    I = np.eye(L.shape[0])

    def op(phi_2d, dt, sign):
        fpp = fpp_log(torch.as_tensor(phi_2d), cfg.c1, cfg.c2).numpy().ravel()
        return (I - cfg.tau * L + sign * 0.5 * dt * L2
                - sign * 0.5 * dt * (fpp[:, None] * L))

    rel = lambda a, b: np.linalg.norm(a - b) / (np.linalg.norm(a)
                                                + np.linalg.norm(b) + 1e-30)
    for i in range(len(t10) - 1):
        dt = float(t10[i + 1] - t10[i])
        src = 0.5 * dt * b1 * (phi10[i] + phi10[i + 1]).ravel()
        right = op(phi10[i + 1], dt, -1) @ p[i + 1].ravel() + src
        correct = rel(op(phi10[i], dt, 1) @ p[i].ravel(), right)
        right_s = op(phi10[i], dt, -1) @ p[i + 1].ravel() + src
        swapped = rel(op(phi10[i + 1], dt, 1) @ p[i].ravel(), right_s)
        assert correct < 5e-7, (i, correct)
        assert swapped / (correct + 1e-30) > 1e2, (i, swapped / correct)


def test_control_problem_matches_golden(golden):
    """ControlProblem2D in float64 at the golden config: three PGD
    iterations of the reference program's cost trajectory and final control,
    then the KKT check and the coercivity probe against vch_tpu's on the
    same result."""
    prob = ControlProblem2D(ForwardSolverConfig2D(**CFG32),
                            OptimizationConfig.defaults_2d(), device="cpu")
    res = prob.optimize(max_iter=3, verbose=False)
    ours, ref = np.asarray(res.cost_history), golden["cost_traj"]
    assert (np.abs(ours - ref) / np.abs(ref)).max() < 1e-6, (ours, ref)
    assert np.abs(res.u_optimal - golden["u_final"]).max() < 1e-5
    assert res.iterations == 3 and not res.converged
    assert set(res.timers) >= {"backward_total", "optimistic_eval_total",
                               "line_search_total", "successful_step_total"}
    assert prob.newton_solves > 0


@pytest.fixture(scope="module")
def small_runs_f64():
    """vch_tpu's and the port's float64 problem at 16x16, T = 0.1, two PGD
    iterations each."""
    cfg = dict(Nx=16, Ny=16, T=0.1)
    jprob = JaxProblem(JaxConfig2D(**cfg), JaxOpt.defaults_2d())
    jres = jprob.optimize(max_iter=2, verbose=False)
    prob = ControlProblem2D(config_from_vch_tpu(JaxConfig2D(**cfg)
                                                .model_dump()),
                            OptimizationConfig.defaults_2d(), device="cpu")
    res = prob.optimize(max_iter=2, verbose=False)
    return jprob, jres, prob, res


def test_control_problem_inputs_match_vch_tpu(small_runs_f64):
    jprob, jres, prob, res = small_runs_f64
    arrays = control_arrays_from_vch_tpu(jprob)
    np.testing.assert_array_equal(prob.phi0, arrays["phi0"])
    for name in ("phi_T_target", "phi_Q_target", "phi_hist0"):
        np.testing.assert_allclose(getattr(prob, name).numpy(),
                                   arrays[name], rtol=0, atol=1e-12)
    np.testing.assert_allclose(res.cost_history, jres.cost_history,
                               rtol=1e-10)
    assert res.ls_trials_per_iter == [int(n) for n in jres.ls_trials_per_iter]
    np.testing.assert_allclose(res.tracking_err_history,
                               jres.tracking_err_history, rtol=1e-9)
    np.testing.assert_allclose(res.terminal_err_history,
                               jres.terminal_err_history, rtol=1e-9)


def test_diagnostics_match_vch_tpu(small_runs_f64):
    """verify_sparsity and second_order_check of both problems on vch_tpu's
    result: equal statistics, and the five curvature estimates to 1e-6
    relative (finite differences at epsilon = 1e-4 in float64)."""
    jprob, jres, prob, _ = small_runs_f64
    stats = prob.verify_sparsity(jres, verbose=False)
    assert stats == jprob.verify_sparsity(jres, verbose=False)
    d2 = prob.second_order_check(jres, num_directions=5)
    jd2 = jprob.second_order_check(jres, num_directions=5)
    assert len(d2) == 5 and np.isfinite(d2).all()
    np.testing.assert_allclose(d2, jd2, rtol=1e-6)


@pytest.mark.parametrize("variant", [None, "spectral", "raw"])
def test_float32_control_problem_matches_vch_tpu(variant):
    """float32 at 16x16, T = 0.1, three PGD iterations: the default route
    (composed fixed-trip solves on the CPU; variant None), and use_pallas
    with each variant (the port's plain kernel versions; vch_tpu's Pallas
    kernels in interpret mode, switched on after its constructor, whose
    baseline is then recomputed on them)."""
    cfg = dict(Nx=16, Ny=16, T=0.1, dtype="float32", newton_tol=2e-4)
    if variant is not None:
        cfg.update(pallas_variant=variant)
    jprob = JaxProblem(JaxConfig2D(**cfg), JaxOpt.defaults_2d())
    if variant is not None:
        for s in (jprob.solver, jprob.adjoint):
            s._use_pallas, s._pallas_interpret = True, True
        jprob.phi_hist0 = jax.jit(jprob.solver._simulate_impl)(
            jnp.zeros_like(jprob.phi_hist0), jprob._phi0_dev)
    jres = jprob.optimize(max_iter=3, verbose=False)
    tcfg = config_from_vch_tpu(JaxConfig2D(**cfg).model_dump())
    if variant is not None:
        tcfg.use_pallas = True
    prob = ControlProblem2D(tcfg, OptimizationConfig.defaults_2d(),
                            device="cpu")
    assert prob.solver._use_pallas == prob.adjoint._use_pallas == (
        variant is not None)
    km.reset_launches()
    res = prob.optimize(max_iter=3, verbose=False)
    assert all(v == 0 for v in km.launch_counts().values())
    c, jc = np.asarray(res.cost_history), np.asarray(jres.cost_history)
    assert np.isfinite(c).all() and c[-1] < c[0]
    assert (np.abs(c - jc) / np.abs(jc)).max() <= 2e-5, (c, jc)
    assert res.ls_trials_per_iter == [int(n) for n in jres.ls_trials_per_iter]


def test_unported_modes_raise():
    prob = ControlProblem2D(ForwardSolverConfig2D(Nx=12, Ny=12, T=0.02),
                            gradient_mode="exact", device="cpu")
    assert prob.loop.adjoint == prob._adjoint_exact
    assert prob.loop.s.ls_beta == 0.5
    with pytest.raises(ValueError, match="gradient_mode"):
        ControlProblem2D(ForwardSolverConfig2D(Nx=12, Ny=12, T=0.02),
                         gradient_mode="other", device="cpu")
    with pytest.raises(ValueError, match="search_mode"):
        ProximalGradientLoop(None, None, None, OptimizationConfig(),
                             search_mode="other")


def test_config_dump_carries_the_routing_knobs():
    """vch_tpu's dump loads with the four knobs the port now honors, and
    they route the solvers: krylov_tol and krylov_max_iter reach the
    float64 adaptive solves, use_pallas and pallas_variant the float32
    per-solve entries."""
    knobs = dict(use_pallas=True, pallas_variant="raw", krylov_tol=1e-8,
                 krylov_max_iter=77)
    cfg = config_from_vch_tpu(JaxConfig2D(Nx=12, Ny=12, T=0.02, **knobs)
                              .model_dump())
    assert {k: getattr(cfg, k) for k in knobs} == knobs
    s = ForwardSolver2D(cfg, device="cpu")
    assert s._use_pallas and s._pallas_variant == "raw"
    assert s._newton_kw()["krylov_tol"] == 1e-8
    assert s._newton_kw()["krylov_max_iter"] == 77
    f32 = ForwardSolver2D(ForwardSolverConfig2D(Nx=12, Ny=12, T=0.02,
                                                dtype="float32"),
                          device="cpu")
    assert f32._use_pallas is False          # the auto rule off the card
    assert f32.krylov_tol == 1e-6            # clamped in float32
