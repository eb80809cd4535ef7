"""Port parity for the slice as a whole: the port's BatchedProblem2D (CPU,
float32, plain kernel versions) against vch_tpu's fused-march
BatchedProblem2D (Pallas kernels in interpret mode) on the same
heterogeneous (b3, kappa_spar) sweep, which engages the straggler buckets.

Gates: cost history to 2e-4 relative (float32 reductions in another order),
and Newton solves and straggler rounds equal — the search takes the same
path member for member.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vch_tpu.config import ForwardSolverConfig2D as JaxConfig2D
from vch_tpu.parallel.batch import BatchedProblem2D as JaxBatched2D
from vch_tpu.parallel.batch import sweep_2d as jax_sweep_2d

from vch_tpu_torch.config import ForwardSolverConfig2D, OptimizationConfig
from vch_tpu_torch.parallel.batch import (BatchedProblem2D, straggler_bucket,
                                          sweep_2d, tile_batch)
from vch_tpu_torch.utils.convert import (config_from_vch_tpu,
                                         scenario_batch_from_numpy)

torch.set_num_threads(2)

B3 = np.logspace(-6, 0, 4)
KS = np.logspace(-6, -1, 4)


def _jax_cfg():
    return JaxConfig2D(Nx=16, Ny=16, T=0.06, dtype="float32",
                       newton_tol=2e-4, fused_march_block=0,
                       fused_solve_precision="highest")


@pytest.fixture(scope="module")
def slice_runs():
    jcfg = _jax_cfg()
    jsc = jax_sweep_2d(jcfg, b3_values=B3, kappa_values=KS)
    jprob = JaxBatched2D(jcfg, fused_march=True)
    jout = jprob.run(jsc, max_iter=4, verbose=False)
    cfg = config_from_vch_tpu(jcfg.model_dump())
    prob = BatchedProblem2D(cfg, device="cpu", fused_march=True)
    out = prob.run(scenario_batch_from_numpy(jsc, dtype=torch.float32),
                   max_iter=4, verbose=False)
    return jprob, jout, prob, out


def test_slice_cost_history_matches_vch_tpu(slice_runs):
    _, jout, _, out = slice_runs
    c0, c1 = jout["cost_history"], out["cost_history"]
    assert c1.shape == c0.shape == (5, 16)
    assert np.isfinite(c1).all()
    rel = np.abs(c1 - c0) / np.abs(c0)
    assert rel.max() <= 2e-4, rel.max()
    assert c1[-1].mean() < c1[0].mean()


def test_slice_counters_match_vch_tpu(slice_runs):
    jprob, jout, prob, out = slice_runs
    assert out["newton_solves"] == jout["newton_solves"]
    assert prob.straggler_rounds == jprob.straggler_rounds
    assert prob.straggler_rounds > 0        # the buckets were exercised
    np.testing.assert_array_equal(out["ls_trials"], jout["ls_trials"])
    np.testing.assert_allclose(out["alpha"], jout["alpha"], rtol=1e-12)


def test_slice_outputs_match_vch_tpu(slice_runs):
    _, jout, _, out = slice_runs
    for key in ("u", "phi", "r"):
        a, b = np.asarray(jout[key]), out[key]
        assert a.shape == b.shape, key
        scale = max(np.abs(a).max(), 1e-30)
        assert np.abs(a - b).max() / scale <= 2e-3, key
    np.testing.assert_array_equal(out["converged"], jout["converged"])
    np.testing.assert_array_equal(out["iterations"], jout["iterations"])
    assert set(out["timers"]) == set(jout["timers"])


def test_sweep_2d_matches_vch_tpu():
    jcfg = JaxConfig2D(Nx=16, Ny=16, T=0.06)
    jsc = jax_sweep_2d(jcfg, b3_values=B3, kappa_values=KS)
    sc = sweep_2d(ForwardSolverConfig2D(Nx=16, Ny=16, T=0.06),
                  b3_values=B3, kappa_values=KS)
    for f in ("phi0", "phi_T", "phi_Q", "b1", "b2", "b3", "kappa_spar"):
        np.testing.assert_array_equal(getattr(sc, f), getattr(jsc, f), f)
    assert (sc.u_min, sc.u_max) == (jsc.u_min, jsc.u_max)


def test_tile_batch_repeats_members():
    sc = sweep_2d(ForwardSolverConfig2D(Nx=16, Ny=16, T=0.06),
                  b3_values=[1e-4, 2e-4, 3e-4])
    t = tile_batch(sc, 7)
    assert t.batch == 7
    np.testing.assert_array_equal(t.b3, np.tile(sc.b3, 3)[:7])


@pytest.mark.parametrize("n_search,B,expect", [
    (1, 16, 8), (8, 16, 8), (9, 16, None), (9, 32, 16), (17, 128, 32),
    (100, 128, None), (3, 8, None)])
def test_straggler_bucket_ladder(n_search, B, expect):
    assert straggler_bucket(n_search, B) == expect


def test_config_roundtrip_from_vch_tpu_dump():
    d = JaxConfig2D(Nx=32, Ny=24, T=0.5, dtype="float32",
                    newton_tol=2e-4).model_dump()
    cfg = config_from_vch_tpu(d)
    for k, v in dataclasses.asdict(cfg).items():
        assert d[k] == v, k
    defaults = dataclasses.asdict(ForwardSolverConfig2D())
    assert defaults == {k: v for k, v in JaxConfig2D().model_dump().items()
                        if k in defaults}


@pytest.mark.parametrize("bad", [dict(c1=1.0, c2=1.0), dict(dtype="bf16"),
                                 dict(Nx=8), dict(T=0.0)])
def test_config_validation_rejects(bad):
    with pytest.raises(ValueError):
        ForwardSolverConfig2D(**bad)


def test_optimization_config_defaults_and_validation():
    from vch_tpu.config import OptimizationConfig as JaxOpt
    assert dataclasses.asdict(OptimizationConfig.defaults_2d()) == \
        JaxOpt.defaults_2d().model_dump()
    with pytest.raises(ValueError):
        OptimizationConfig(u_min=1.0, u_max=0.5)


def test_package_imports_no_jax_vch_tpu_or_pydantic():
    code = ("import sys, vch_tpu_torch, vch_tpu_torch.parallel.batch, "
            "vch_tpu_torch.utils.convert, vch_tpu_torch.ops._build; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'vch_tpu', 'pydantic', 'jaxlib')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stdout + proc.stderr
