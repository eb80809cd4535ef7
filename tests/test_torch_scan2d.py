"""Port parity for the batched 2D scan path: the batched per-step marcher
(ForwardSolver2D._march_batch), the batched per-step sweep
(AdjointSolver2D._run_batch) and BatchedProblem2D(fused_march=False), on
the CPU, against vmap of vch_tpu's per-member marcher and sweep and
vch_tpu's BatchedProblem2D(fused_march=False) on the same numpy inputs, and
the routing rule (`fused_march_rule`).

Tolerances: float64 trajectories and r to 1e-10 of their scale and costs to
1e-10 relative, with Newton solves equal member for member (the adaptive
Krylov path: the same recurrences, sums in another order); float32 (the
composed fixed-trip solve) to 1e-5; a batched member against the golden
32x32, T = 0.25 cost trajectory to 1e-6 relative, the gate of
tests/test_parallel.py:104.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vch_tpu.config import ForwardSolverConfig2D as JaxConfig2D
from vch_tpu.models.adjoint2d import AdjointSolver2D as JaxAdjoint
from vch_tpu.models.forward2d import ForwardSolver2D as JaxForward
from vch_tpu.parallel.batch import BatchedProblem2D as JaxBatched2D
from vch_tpu.parallel.batch import sweep_2d as jax_sweep_2d

from vch_tpu_torch.config import (DELTA_SEP, ForwardSolverConfig2D,
                                  OptimizationConfig)
from vch_tpu_torch.models.adjoint2d import AdjointSolver2D
from vch_tpu_torch.models.forward2d import ForwardSolver2D
from vch_tpu_torch.ops.potential import init_phi_random_2d
from vch_tpu_torch.parallel.batch import (BatchedProblem2D,
                                          LowMemBatchedProblem2D,
                                          fused_march_rule,
                                          make_batched_problem_2d, sweep_2d)
from vch_tpu_torch.utils.convert import scenario_batch_from_numpy

torch.set_num_threads(2)

N = 16
B = 3


def _inputs(M, seed=0):
    """Per-member ICs and controls of distinct size, so that the members
    take different Newton counts."""
    rng = np.random.default_rng(seed)
    phi0 = np.stack([init_phi_random_2d(N, N, DELTA_SEP, amp=a, seed=42 + i)
                     for i, a in enumerate((0.1, 0.5, 0.5))])
    u = np.stack([a * rng.standard_normal((M + 1, N + 1, N + 1))
                  for a in (0.0, 2.0, 200.0)])
    return phi0, u


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-10), ("float32", 1e-5)])
def test_march_batch_is_vmap_of_the_scan(dtype, tol):
    kw = dict(Nx=N, Ny=N, T=0.05, dtype=dtype)
    if dtype == "float32":
        kw["newton_tol"] = 2e-4
    js = JaxForward(JaxConfig2D(**kw))
    ts = ForwardSolver2D(ForwardSolverConfig2D(**kw), device="cpu")
    assert (ts._krylov_fixed is None) == (dtype == "float64")
    assert not ts._use_pallas           # the composed solve on the CPU
    phi0, u = _inputs(ts.M)
    jp, st = jax.vmap(js._march_impl)(jnp.asarray(u, js.dtype),
                                      jnp.asarray(phi0, js.dtype))
    t = lambda a: torch.as_tensor(a, dtype=ts.dtype)
    tp, ns, bad = ts._march_batch(t(u), t(phi0))
    assert tp.shape == (B, ts.M + 1, N + 1, N + 1)
    assert _rel(tp.numpy(), jp) <= tol, _rel(tp.numpy(), jp)
    assert ns.tolist() == np.asarray(st.newton_solves).tolist()
    assert len(set(ns.tolist())) > 1            # members exit on their own
    assert bad.tolist() == np.asarray(st.first_bad_step).tolist() == [-1] * B
    # one member through the B = 1 case is the same march
    p1, s1 = ts._march_impl(t(u[2]), t(phi0[2]))
    assert torch.equal(p1, tp[2]) and s1.newton_solves == int(ns[2])


def test_run_batch_is_vmap_of_the_sweep():
    kw = dict(Nx=N, Ny=N, T=0.05)
    ts = ForwardSolver2D(ForwardSolverConfig2D(**kw), device="cpu")
    ta = AdjointSolver2D(ForwardSolverConfig2D(**kw), device="cpu")
    ja = JaxAdjoint(JaxConfig2D(**kw))
    phi0, u = _inputs(ts.M, seed=1)
    hist = ts._march_batch(torch.as_tensor(u), torch.as_tensor(phi0))[0]
    hist = hist.numpy()
    rng = np.random.default_rng(2)
    phiQ = 0.3 * rng.standard_normal(hist.shape)
    phiT = 0.3 * rng.standard_normal((B, N + 1, N + 1))
    b1, b2 = np.array([5.0, 1.0, 0.3]), np.array([10.0, 13.0, 2.0])
    dts = ts.dts_np
    jp, jq, jr = jax.vmap(ja._run_impl, in_axes=(0, None, 0, 0, 0, 0))(
        *map(jnp.asarray, (hist, dts, b1, b2, phiQ, phiT)))
    T = torch.as_tensor
    p, q, r = ta._run_batch(T(hist), T(dts), T(b1), T(b2), T(phiQ), T(phiT))
    for mine, ref in ((p, jp), (q, jq), (r, jr)):
        assert _rel(mine.numpy(), ref) <= 1e-10, _rel(mine.numpy(), ref)
    assert (r[:, -1] == 0).all()
    # one member through the B = 1 case
    p1, q1, r1 = ta._run_impl(T(hist[1]), T(dts), 1.0, 13.0, T(phiQ[1]),
                              T(phiT[1]))
    assert _rel(r1.numpy(), r[1].numpy()) <= 1e-13


@pytest.fixture(scope="module")
def scan_runs():
    kw = dict(Nx=N, Ny=N, T=0.05)
    jcfg = JaxConfig2D(**kw)
    jsc = jax_sweep_2d(jcfg, b3_values=[1e-4, 1e-2], kappa_values=[1e-4, 1e-2])
    jprob = JaxBatched2D(jcfg, fused_march=False)
    jout = jprob.run(jsc, max_iter=3, verbose=False)
    prob = BatchedProblem2D(ForwardSolverConfig2D(**kw), device="cpu")
    out = prob.run(scenario_batch_from_numpy(jsc), max_iter=3, verbose=False)
    return jprob, jout, prob, out


def test_scan_problem_costs_match_vch_tpu(scan_runs):
    _, jout, prob, out = scan_runs
    assert not prob._use_fused_march and prob.straggler_batch is None
    c0, c1 = jout["cost_history"], out["cost_history"]
    assert c1.shape == c0.shape == (4, 4)
    assert (np.abs(c1 - c0) / np.abs(c0)).max() <= 1e-10
    assert c1[-1].mean() < c1[0].mean()


def test_scan_problem_counters_match_vch_tpu(scan_runs):
    jprob, jout, prob, out = scan_runs
    assert out["newton_solves"] == jout["newton_solves"]
    assert prob.straggler_rounds == jprob.straggler_rounds == 0
    np.testing.assert_array_equal(out["ls_trials"], jout["ls_trials"])
    for key in ("u", "r"):
        assert _rel(out[key], jout[key]) <= 1e-9, key


def test_batched_member_matches_golden_2d(golden_2d):
    """Two members of the default 32x32, T = 0.25 scenario through the scan
    path reproduce the reference's cost trajectory (tests/test_parallel.py:
    104)."""
    cfg = ForwardSolverConfig2D(Nx=32, Ny=32, T=0.25)
    prob = BatchedProblem2D(cfg, device="cpu")
    assert not prob._use_fused_march
    sc = sweep_2d(cfg, OptimizationConfig.defaults_2d(),
                  b3_values=[1e-4, 1e-4], kappa_values=[1e-4])
    out = prob.run(sc, max_iter=3, verbose=False)
    ref = golden_2d["cost_traj"]
    for b in range(2):
        rel = np.abs(out["cost_history"][:, b] - ref) / np.abs(ref)
        assert rel.max() < 1e-6, rel


@pytest.mark.parametrize("dtype,device,asked,expect", [
    ("float64", "cpu", None, False), ("float64", "cuda", None, False),
    ("float32", "cpu", None, False), ("float32", "cuda", None, True),
    ("float32", "cuda", False, False), ("float32", "cpu", True, True),
    ("float64", "cpu", False, False)])
def test_fused_march_rule(dtype, device, asked, expect):
    """vch_tpu's rule as a pure function of the config and the device
    type: no tensor is made on the card."""
    cfg = ForwardSolverConfig2D(Nx=N, Ny=N, T=0.05, dtype=dtype)
    assert fused_march_rule(cfg, device, asked) is expect


def test_float64_never_reaches_a_float32_kernel():
    cfg = ForwardSolverConfig2D(Nx=N, Ny=N, T=0.05)
    for dev in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="float32"):
            fused_march_rule(cfg, dev, True)
    # the CPU defaults of both problems and of the chooser take the scan
    # path, as vch_tpu's do off the accelerator
    assert not BatchedProblem2D(cfg, device="cpu")._use_fused_march
    low = LowMemBatchedProblem2D(cfg, K=2, device="cpu")
    assert not low._use_fused_march and low._fused is None
    assert not make_batched_problem_2d(cfg, batch=2,
                                       device="cpu")._use_fused_march
    cfg32 = ForwardSolverConfig2D(Nx=N, Ny=N, T=0.05, dtype="float32")
    assert make_batched_problem_2d(cfg32, batch=2, device="cpu",
                                   fused_march=True)._use_fused_march
