"""Port parity for the batched 1D PGD slice (BASELINE config 2 at a small
size): `sweep_1d` and `BatchedProblem1D` of vch_tpu_torch against vch_tpu's
on the same sweep, on both forward paths: the fused 1D march (the plain
version of the kernel here; vch_tpu's Pallas kernel in interpret mode) and
the batched per-step marcher.

Tolerances: float64 (per-step marcher, dense solves) cost history 1e-9
relative; float32 cost history 2e-4 relative on either path (two float32
implementations of the march, and an adaptive float32 Krylov adjoint);
Newton solves and straggler rounds equal.
"""
import numpy as np
import pytest
import torch

from vch_tpu.config import ForwardSolverConfig1D as JaxConfig1D
from vch_tpu.parallel.batch import BatchedProblem1D as JaxBatched1D
from vch_tpu.parallel.batch import sweep_1d as jax_sweep_1d

from vch_tpu_torch.config import ForwardSolverConfig1D
from vch_tpu_torch.ops import march as km
from vch_tpu_torch.parallel.batch import BatchedProblem1D, sweep_1d
from vch_tpu_torch.utils.convert import scenario_batch_from_numpy

torch.set_num_threads(2)

KW32 = dict(N=64, T=0.06, dtype="float32", newton_tol=2e-4,
            linsolve_1d="spectral")
SWEEP = dict(b3_values=[1e-3, 5e-3], kappa_values=[5e-5, 2e-4])


def test_sweep_1d_equals_vch_tpu():
    js = jax_sweep_1d(JaxConfig1D(N=64, T=0.06), **SWEEP, choice_t=2)
    ts = sweep_1d(ForwardSolverConfig1D(N=64, T=0.06), **SWEEP, choice_t=2)
    assert ts.batch == 4 and ts.phi_Q.shape == (4, 7, 65)    # core layout
    for name in ("phi0", "phi_T", "phi_Q", "b1", "b2", "b3", "kappa_spar"):
        assert np.array_equal(getattr(ts, name), np.asarray(getattr(js, name)))
    assert (ts.u_min, ts.u_max, ts.phi_Q_mode) == (js.u_min, js.u_max, None)
    conv = scenario_batch_from_numpy(js)
    assert torch.equal(conv.phi_Q, torch.as_tensor(ts.phi_Q))


@pytest.fixture(scope="module")
def jax_runs():
    """vch_tpu's float32 runs on both forward paths."""
    cfg = JaxConfig1D(**KW32)
    sc = jax_sweep_1d(cfg, **SWEEP)
    out = {}
    for fused in (True, False):
        prob = JaxBatched1D(cfg, fused_march=fused)
        out[fused] = (prob.run(sc, max_iter=3, verbose=False),
                      prob.straggler_rounds)
    return out


@pytest.mark.parametrize("fused", [True, False])
def test_batched_1d_float32_matches_vch_tpu(jax_runs, fused):
    cfg = ForwardSolverConfig1D(**KW32)
    sc = sweep_1d(cfg, **SWEEP)
    prob = BatchedProblem1D(cfg, device="cpu", fused_march=fused)
    assert prob._use_fused_march == fused
    assert prob.straggler_batch == ("auto" if fused else None)
    out = prob.run(sc, max_iter=3, verbose=False)
    ref, ref_rounds = jax_runs[fused]
    rel = np.abs(out["cost_history"] - ref["cost_history"]) / np.abs(
        ref["cost_history"])
    assert out["cost_history"].shape == (4, 4) and rel.max() < 2e-4
    assert out["newton_solves"] == ref["newton_solves"]
    assert prob.straggler_rounds == ref_rounds
    assert out["ls_trials"].tolist() == ref["ls_trials"].tolist()
    assert out["u"].shape == (4, 8, 65)                  # reference layout
    assert np.all(out["cost_history"][-1] < out["cost_history"][0])


def test_batched_1d_float64_scan_path_matches_vch_tpu():
    kw = dict(N=48, T=0.05)
    jcfg, tcfg = JaxConfig1D(**kw), ForwardSolverConfig1D(**kw)
    ref = JaxBatched1D(jcfg).run(jax_sweep_1d(jcfg, **SWEEP), max_iter=3,
                                 verbose=False)
    prob = BatchedProblem1D(tcfg, device="cpu")
    assert not prob._use_fused_march        # float64: the dense parity path
    out = prob.run(sweep_1d(tcfg, **SWEEP), max_iter=3, verbose=False)
    rel = np.abs(out["cost_history"] / ref["cost_history"] - 1)
    assert rel.max() < 1e-9
    assert out["newton_solves"] == ref["newton_solves"]
    assert np.abs(out["u"] - ref["u"]).max() < 1e-8
    assert np.isnan(out["advisor_alpha"]).all()


def test_second_run_does_not_double_convert_the_layout():
    cfg = ForwardSolverConfig1D(N=32, T=0.05)
    prob = BatchedProblem1D(cfg, device="cpu")
    sc = sweep_1d(cfg, b3_values=[1e-3, 2e-3])
    shape = sc.phi_Q.shape
    out1 = prob.run(sc, max_iter=2, verbose=False)
    assert sc.phi_Q.shape == shape == (2, 6, 33)
    out2 = prob.run(sc, max_iter=2, verbose=False)
    assert np.array_equal(out1["cost_history"], out2["cost_history"])
    # a batch already in the reference layout, as tensors, is taken as is
    ref = scenario_batch_from_numpy(prob._to_ref_layout(sc))
    assert ref.phi_Q.shape == (2, 7, 33)
    out3 = prob.run(ref, max_iter=2, verbose=False)
    assert np.array_equal(out1["cost_history"], out3["cost_history"])


def test_fused_forward_falls_back_where_the_kernel_is_not_available():
    cfg = ForwardSolverConfig1D(**KW32)
    prob = BatchedProblem1D(cfg, device="cpu", fused_march=True)
    sc = sweep_1d(cfg, b3_values=[1e-3, 5e-3])
    calls = []
    plain = km.PLAIN.march_1d
    prob.solver.entries = km.PLAIN._replace(
        march_1d=lambda *a, **k: calls.append(1) or plain(*a, **k))
    prob.run(sc, max_iter=1, verbose=False)
    assert len(calls) >= 2                   # the baseline and each trial
    calls.clear()
    prob.solver.fused_march_available = lambda batch: False
    out = prob.run(sc, max_iter=1, verbose=False)
    assert not calls and np.isfinite(out["cost_history"]).all()


def test_default_device_is_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            BatchedProblem1D(ForwardSolverConfig1D(N=32, T=0.05))
