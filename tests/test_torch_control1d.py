"""Port parity for the single-scenario 1D control problem (BASELINE config
1): `vch_tpu_torch.control.problems.ControlProblem1D` in float64 against the
reference program's golden run tests/golden/ref_1d.npz, and in float32
against vch_tpu's ControlProblem1D on the CPU.

Tolerances: float64 baseline cost 1e-12 relative; the 8-iteration cost
trajectory 5e-9 relative (measured 1.0e-9; vch_tpu records ~1e-10 for
itself: PGD amplifies the 5e-12 trajectory difference through eight adjoint
sweeps and line searches), u after 8 iterations 1e-8 absolute (measured
2.7e-10) and r 1e-9 (measured 1.8e-11); float32 against vch_tpu's float32
cost trajectory 1e-4 relative, line-search trials equal.
"""
import numpy as np
import pytest
import torch

from vch_tpu.config import ForwardSolverConfig1D as JaxConfig1D
from vch_tpu.control.problems import ControlProblem1D as JaxProblem1D

from vch_tpu_torch.config import (ForwardSolverConfig1D, OptimizationConfig,
                                  PGDSettings)
from vch_tpu_torch.control.problems import ControlProblem1D
from vch_tpu_torch.ops import march as km
from vch_tpu_torch.utils.convert import control_arrays_from_vch_tpu

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def golden_run():
    prob = ControlProblem1D(device="cpu")
    km.reset_launches()
    res = prob.optimize(max_iter=8, verbose=False)
    return prob, res


def test_control_1d_baseline_and_targets_are_the_golden_ones(golden_run,
                                                             golden_1d):
    prob, _ = golden_run
    g = golden_1d
    assert prob.phi_hist0.shape == (102, 129)        # reference layout
    assert np.abs(prob.phi_hist0.numpy() - g["phi_hist"]).max() < 1e-9
    assert np.abs(prob.t_hist - g["t_hist"]).max() == 0.0
    assert np.abs(prob.phi_T_target.numpy() - g["phi_T_target"]).max() < 1e-14
    assert np.abs(prob.phi_Q_target.numpy() - g["phi_Q_target"]).max() < 1e-9
    assert isinstance(prob.opt_config, OptimizationConfig)
    assert prob.opt_config.b2 == 13.0 and prob.loop.s.ls_max_trials == 5


def test_control_1d_cost_trajectory_matches_golden(golden_run, golden_1d):
    _, res = golden_run
    g = golden_1d
    hist = np.asarray(res.cost_history)
    assert abs(hist[0] / g["cost0"] - 1) < 1e-12
    assert np.abs(hist / g["cost_traj"] - 1).max() < 5e-9
    # iteration 3 fails all six trials and keeps the last (worse) iterate,
    # as the reference does
    assert res.ls_trials_per_iter[2] == 6 and hist[3] > hist[2]
    assert hist[-1] < 0.1 * hist[0]
    assert np.abs(res.u_optimal - g["u_final"]).max() < 1e-8
    assert np.abs(res.r_optimal - g["r_final"]).max() < 1e-9
    assert res.iterations == 8 and not res.converged
    assert res.timers["backward_total"] > 0


def test_control_1d_runs_no_kernel_and_counts_its_solves(golden_run):
    prob, res = golden_run
    assert not any(km.launch_counts().values())
    # the baseline and one march per trial, each at least one solve a step
    assert prob.newton_solves >= 100 * (1 + sum(res.ls_trials_per_iter))


def test_control_1d_diagnostics(golden_run):
    prob, res = golden_run
    stats = prob.verify_sparsity(res, verbose=False)
    assert 0.0 <= stats["match_percentage"] <= 100.0
    assert stats["total_points"] == 102 * 129
    d2 = prob.second_order_check(res, num_directions=2)
    assert len(d2) == 2 and np.isfinite(d2).all()
    e_track, e_term = prob.error_norms(torch.as_tensor(res.phi_final))
    assert 0 < float(e_track) < 10 and 0 < float(e_term) < 10
    assert res.tracking_err_history[-1] == pytest.approx(float(e_track))


def test_control_1d_float32_matches_vch_tpu():
    kw = dict(N=48, T=0.1, dtype="float32", newton_tol=2e-4)
    jp = JaxProblem1D(JaxConfig1D(**kw))
    tp = ControlProblem1D(ForwardSolverConfig1D(**kw), device="cpu")
    arrays = control_arrays_from_vch_tpu(jp)
    assert arrays["phi_hist0"].shape == tuple(tp.phi_hist0.shape)
    assert np.abs(tp.phi_hist0.numpy() - arrays["phi_hist0"]).max() < 2e-5
    assert np.abs(tp.phi_Q_target.numpy()
                  - arrays["phi_Q_target"]).max() < 1e-6
    jr = jp.optimize(max_iter=3, verbose=False)
    tr = tp.optimize(max_iter=3, verbose=False)
    jh, th = np.asarray(jr.cost_history), np.asarray(tr.cost_history)
    assert np.abs(th / jh - 1).max() < 1e-4
    assert tr.ls_trials_per_iter == jr.ls_trials_per_iter


def test_control_1d_choices_and_initial_phi():
    phi0 = 0.1 * np.cos(np.pi * np.linspace(0, 1, 33))
    prob = ControlProblem1D(ForwardSolverConfig1D(N=32, T=0.03), choice_t=2,
                            choice_q=2, initial_phi=phi0, device="cpu")
    assert not prob.phi_Q_target.any()
    assert np.array_equal(prob.phi_hist0[0].numpy(), phi0)
    assert prob.phi_T_target[0] == pytest.approx(0.7)


def test_control_1d_exact_mode_and_default_device():
    cfg = ForwardSolverConfig1D(N=32, T=0.03)
    prob = ControlProblem1D(cfg, gradient_mode="exact", device="cpu")
    assert prob.loop.s == PGDSettings.defaults_exact()
    assert prob.loop.adjoint == prob._adjoint_exact
    assert prob.phi_hist0.shape == (prob.solver.M + 1, 33)   # core layout
    with pytest.raises(ValueError, match="gradient_mode"):
        ControlProblem1D(gradient_mode="other", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            ControlProblem1D()
