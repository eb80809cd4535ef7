"""Port parity for the segment-checkpointed low-memory path: the port's
FusedLowMemBatch2D and LowMemBatchedProblem2D (CPU, plain segment kernels)
against vch_tpu's (Pallas segment kernels in interpret mode) on the same
inputs, with stored, ramp and zero tracking targets; and the
make_batched_problem_2d chooser.

Tolerances (float32): states and J1 to 1e-5 relative with Newton counts
equal (the segment kernels march the same recurrences); r to 1e-4 relative,
the float32 floor of the adjoint between the two frameworks (see
tests/test_torch_blocked.py); the PGD cost history to 2e-4 relative and u
to 2e-3 of its scale, as tests/test_torch_batch.py gates the full-memory
slice, with Newton solves equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from vch_tpu.config import ForwardSolverConfig2D as JaxConfig2D
from vch_tpu.models.lowmem import FusedLowMemBatch2D as JaxFused
from vch_tpu.models.lowmem import LowMemPipeline2D as JaxPipeline
from vch_tpu.parallel.batch import LowMemBatchedProblem2D as JaxLowMem2D
from vch_tpu.parallel.batch import sweep_2d as jax_sweep_2d

from vch_tpu_torch.models.lowmem import (FusedLowMemBatch2D, LowMemPipeline2D,
                                         LowMemState)
from vch_tpu_torch.parallel.batch import (BatchedProblem2D,
                                          FULL_MEMORY_PEAK_PER_S,
                                          MARCH_WORKSPACE_FIELDS,
                                          LowMemBatchedProblem2D,
                                          full_memory_estimate_bytes,
                                          make_batched_problem_2d, sweep_2d)
from vch_tpu_torch.utils.convert import (config_from_vch_tpu,
                                         scenario_batch_from_numpy)

torch.set_num_threads(2)

N, K = 16, 4
B3 = [1e-4, 2e-4]
KS = [1e-5, 1e-4]


def _jax_cfg(T=0.06):
    return JaxConfig2D(Nx=N, Ny=N, T=T, dtype="float32", newton_tol=2e-4,
                       fused_solve_precision="highest")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("mode", ["stored", "ramp", "zeros"])
def test_fused_lowmem_forward_and_adjoint_match_vch_tpu(mode):
    """forward (checkpoints, final state, J1, Newton solves) and adjoint_r
    over M = 6 steps in segments of 4 and 2, member by member."""
    jcfg = _jax_cfg()
    choice_q = 2 if mode == "zeros" else 1
    jsc = jax_sweep_2d(jcfg, b3_values=B3, kappa_values=KS, choice_q=choice_q,
                       materialize_phi_Q=mode == "stored")
    Bn = jsc.batch
    rng = np.random.default_rng(0)
    jpipe = JaxPipeline(jcfg, K=K)
    M = jpipe.solver.M
    u = 0.2 * rng.standard_normal((Bn, M + 1, N + 1, N + 1))
    b1 = np.linspace(2.0, 6.0, Bn)
    b2 = np.linspace(12.0, 9.0, Bn)
    if mode != "stored":
        jpipe.core.phi_Q_mode = mode
    jfb = JaxFused(jpipe, interpret=True)
    f = lambda a: None if a is None else jnp.asarray(a, jnp.float32)
    jst, jns = jfb.forward(f(u), f(jsc.phi0), f(jsc.phi_Q), f(jsc.phi_T))
    jr = jfb.adjoint_r(jst, f(u), f(jsc.phi_Q), f(b1), f(b2), f(jsc.phi_T))

    pipe = LowMemPipeline2D(config_from_vch_tpu(jcfg.model_dump()), K=K,
                            device="cpu")
    if mode != "stored":
        pipe.core.phi_Q_mode = mode
    fb = FusedLowMemBatch2D(pipe)
    t = lambda a: None if a is None else torch.as_tensor(np.asarray(a),
                                                          dtype=torch.float32)
    st, ns = fb.forward(t(u), t(jsc.phi0), t(jsc.phi_Q), t(jsc.phi_T))
    r = fb.adjoint_r(st, t(u), t(jsc.phi_Q), t(b1), t(b2), t(jsc.phi_T))

    assert pipe.S == jpipe.S == 2
    assert st.ck_phi.shape == (Bn, 2, N + 1, N + 1)
    for name in ("ck_phi", "ck_mu", "ck_w", "phi_T", "j1_raw"):
        a, b = getattr(st, name), getattr(jst, name)
        assert a.shape == b.shape, name
        assert _rel(a.numpy(), b) <= 1e-5, (name, _rel(a.numpy(), b))
    np.testing.assert_array_equal(ns.numpy(), np.asarray(jns))
    np.testing.assert_array_equal(st.newton_solves.numpy(), np.asarray(jns))
    assert (ns.numpy() > 0).all()
    assert r.shape == (Bn, M + 1, N + 1, N + 1)
    assert (r[:, -1] == 0).all()
    assert _rel(r.numpy(), jr) <= 1e-4, _rel(r.numpy(), jr)


@pytest.fixture(scope="module")
def lowmem_runs():
    jcfg = _jax_cfg()
    mk = lambda: jax_sweep_2d(jcfg, b3_values=B3, kappa_values=KS,
                              materialize_phi_Q=False)
    jout = JaxLowMem2D(jcfg, K=K, fused_march=True).run(mk(), max_iter=3,
                                                        verbose=False)
    prob = LowMemBatchedProblem2D(config_from_vch_tpu(jcfg.model_dump()), K=K,
                                  device="cpu", fused_march=True)
    out = prob.run(scenario_batch_from_numpy(mk(), dtype=torch.float32),
                   max_iter=3, verbose=False)
    return jout, prob, out


def test_lowmem_run_matches_vch_tpu(lowmem_runs):
    """Three PGD iterations on procedural ramp targets: cost history, u,
    Newton solves and the search's counters member for member."""
    jout, prob, out = lowmem_runs
    c0, c1 = jout["cost_history"], out["cost_history"]
    assert c1.shape == c0.shape == (4, 4)
    assert np.isfinite(c1).all()
    assert np.abs(c1 - c0).max() / np.abs(c0).min() <= 2e-4
    assert c1[-1].mean() < c1[0].mean()
    assert out["newton_solves"] == jout["newton_solves"]
    np.testing.assert_array_equal(out["ls_trials"], jout["ls_trials"])
    assert _rel(out["u"], jout["u"]) <= 2e-3
    assert _rel(out["r"], jout["r"]) <= 2e-3
    assert isinstance(out["phi"], LowMemState)
    assert out["phi"].ck_phi.shape[:2] == (4, prob.pipe.S)


def test_lowmem_run_matches_full_memory_run():
    """The low-memory problem on stored targets takes the same PGD path as
    the full-memory problem: the same forward march, cut into segments."""
    cfg = config_from_vch_tpu(_jax_cfg().model_dump())
    sc = sweep_2d(cfg, b3_values=B3, kappa_values=KS)
    full = BatchedProblem2D(cfg, device="cpu", fused_march=True).run(
        sc, max_iter=2, verbose=False)
    low = LowMemBatchedProblem2D(cfg, K=K, device="cpu", fused_march=True).run(
        sc, max_iter=2, verbose=False)
    np.testing.assert_allclose(low["cost_history"], full["cost_history"],
                               rtol=1e-5)
    assert low["newton_solves"] == full["newton_solves"]
    assert _rel(low["r"], full["r"]) <= 1e-4


def test_sweep_2d_procedural_matches_vch_tpu():
    for choice_q, mode in ((1, "ramp"), (2, "zeros")):
        jsc = jax_sweep_2d(_jax_cfg(), b3_values=B3, choice_q=choice_q,
                           materialize_phi_Q=False)
        sc = sweep_2d(config_from_vch_tpu(_jax_cfg().model_dump()),
                      b3_values=B3, choice_q=choice_q,
                      materialize_phi_Q=False)
        assert sc.phi_Q is None and jsc.phi_Q is None
        assert sc.phi_Q_mode == jsc.phi_Q_mode == mode
        np.testing.assert_array_equal(sc.phi0, jsc.phi0)


def test_full_memory_problem_refuses_procedural_targets():
    cfg = config_from_vch_tpu(_jax_cfg().model_dump())
    sc = sweep_2d(cfg, b3_values=[1e-4], materialize_phi_Q=False)
    with pytest.raises(ValueError, match="LowMemBatchedProblem2D"):
        BatchedProblem2D(cfg, device="cpu", fused_march=True).run(
            sc, max_iter=1, verbose=False)
    with pytest.raises(ValueError, match="phi_Q_mode"):
        LowMemBatchedProblem2D(cfg, K=K, device="cpu", fused_march=True).run(
            dataclasses.replace(sc, phi_Q_mode="bogus"), max_iter=1,
            verbose=False)


@pytest.mark.parametrize("materialized", [True, False])
def test_chooser_routes_by_estimated_peak(materialized):
    """make_batched_problem_2d: full memory while the port's measured
    multiple of S plus the march workspace fits within safety * limit, low
    memory beyond; without stored targets the estimate is one S less."""
    cfg = config_from_vch_tpu(_jax_cfg(T=0.2).model_dump())
    Bn = 4
    M = 20
    field = Bn * (N + 1) ** 2 * 4
    est = int((FULL_MEMORY_PEAK_PER_S - (0 if materialized else 1))
              * (M + 1) * field + MARCH_WORKSPACE_FIELDS * field)
    assert full_memory_estimate_bytes(cfg, Bn, materialized) == est
    pick = lambda limit: make_batched_problem_2d(
        cfg, batch=Bn, materialized_phi_Q=materialized, hbm_limit_bytes=limit,
        K=K, device="cpu")
    assert type(pick(100 * est)) is BatchedProblem2D
    assert type(pick(est)) is LowMemBatchedProblem2D   # est > 0.75 * est
    assert type(pick(int(est / 0.75) + 1)) is BatchedProblem2D
    low = pick(est)
    assert low.pipe.K == K and low.pipe.S == 5
    # a CPU problem with no limit given uses 16 GiB
    assert type(make_batched_problem_2d(cfg, batch=Bn, device="cpu")) \
        is BatchedProblem2D
    assert FULL_MEMORY_PEAK_PER_S > 8      # not vch_tpu's TPU multiple
