"""Port parity for the batch runner's search modes (vch_tpu/parallel/
batch.py:168-275, :401-684): a numeric `straggler_batch`, the speculative
search and chunked execution, each run through vch_tpu's BatchedProblem1D/2D
(float64, its scan path, on the CPU) and the port's (float64, device="cpu")
on the same sweeps as tests/test_parallel.py:188, :215 and :248.

Tolerances: against vch_tpu in the same mode, the cost history, u and alpha
within 1e-10 relative, ls_trials, Newton solves and the mode's counter
equal. Within the port, vch_tpu's own gates between a mode and the plain
search: cost history 1e-11 and u 1e-12 (chunked: 1e-9 and 1e-8), trial
counts equal.
"""
import numpy as np
import pytest
import torch

from vch_tpu.config import ForwardSolverConfig1D as JaxConfig1D
from vch_tpu.config import ForwardSolverConfig2D as JaxConfig2D
from vch_tpu.parallel.batch import BatchedProblem1D as JaxBatched1D
from vch_tpu.parallel.batch import BatchedProblem2D as JaxBatched2D
from vch_tpu.parallel.batch import sweep_1d as jax_sweep_1d
from vch_tpu.parallel.batch import sweep_2d as jax_sweep_2d

from vch_tpu_torch.config import ForwardSolverConfig1D, ForwardSolverConfig2D
from vch_tpu_torch.parallel.batch import (BatchedProblem1D, BatchedProblem2D,
                                          sweep_1d, sweep_2d)

torch.set_num_threads(2)

# tests/test_parallel.py:200-202: 6 members, alpha_max raised so that
# members backtrack
KW2 = dict(Nx=16, Ny=16, T=0.15)
SWEEP2 = dict(b3_values=[5e-5, 1e-4, 2e-4], kappa_values=[5e-5, 2e-4])
ITERS2 = 8
# the modes of the 2D parity cases: (problem keywords, its counter)
MODES = {"plain": ({}, None),
         "straggler": ({"straggler_batch": 4}, "straggler_rounds"),
         "speculative": ({"speculative": True}, "speculative_rounds"),
         "chunked": ({"chunk_size": 3}, "chunk_calls")}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def runs2d():
    """Each mode through vch_tpu and through the port: {mode: (vch_tpu's
    (out, counter), the port's (out, counter))}."""
    jcfg, cfg = JaxConfig2D(**KW2), ForwardSolverConfig2D(**KW2)
    out = {}
    for mode, (kw, counter) in MODES.items():
        jp = JaxBatched2D(jcfg, alpha_max=2000.0, **kw)
        jo = jp.run(jax_sweep_2d(jcfg, **SWEEP2), max_iter=ITERS2,
                    verbose=False)
        tp = BatchedProblem2D(cfg, alpha_max=2000.0, device="cpu", **kw)
        assert not tp._use_fused_march and tp.straggler_batch == kw.get(
            "straggler_batch")
        to = tp.run(sweep_2d(cfg, **SWEEP2), max_iter=ITERS2, verbose=False)
        cnt = lambda p: getattr(p, counter) if counter else None
        out[mode] = ((jo, cnt(jp)), (to, cnt(tp)))
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_matches_vch_tpu(runs2d, mode):
    (jo, jc), (to, tc) = runs2d[mode]
    assert to["cost_history"].shape == (ITERS2 + 1, 6)
    assert _rel(to["cost_history"], jo["cost_history"]) <= 1e-10
    assert _rel(to["u"], jo["u"]) <= 1e-10
    assert _rel(to["alpha"], jo["alpha"]) <= 1e-10
    np.testing.assert_array_equal(to["ls_trials"], jo["ls_trials"])
    assert to["newton_solves"] == jo["newton_solves"]
    assert tc == jc
    if tc is not None:
        assert tc > 0, f"{mode} never engaged"


@pytest.mark.parametrize("mode", ["straggler", "speculative", "chunked"])
def test_mode_matches_plain_search(runs2d, mode):
    """vch_tpu's own gates between a mode and the plain search
    (tests/test_parallel.py:188, :215, :248), on the port."""
    plain, out = runs2d["plain"][1][0], runs2d[mode][1][0]
    rtol, atol = (1e-9, 1e-8) if mode == "chunked" else (1e-11, 1e-12)
    np.testing.assert_allclose(out["cost_history"], plain["cost_history"],
                               rtol=rtol)
    np.testing.assert_allclose(out["u"], plain["u"], rtol=0, atol=atol)
    np.testing.assert_allclose(out["alpha"], plain["alpha"], rtol=1e-12)
    np.testing.assert_array_equal(out["ls_trials"], plain["ls_trials"])
    if mode == "straggler":
        assert out["newton_solves"] < plain["newton_solves"]
    if mode == "chunked":
        assert out["newton_solves"] == plain["newton_solves"]


def test_speculative_1d_matches_vch_tpu_and_sequential():
    """tests/test_parallel.py:215's 1D case: the speculative search gives the
    sequential search's iterates, alphas and trial counts, in both
    packages."""
    kw = dict(N=32, T=0.2)
    sweep = dict(b3_values=[1e-4, 5e-4, 2e-3], kappa_values=[1e-4, 1e-3])
    jcfg, cfg = JaxConfig1D(**kw), ForwardSolverConfig1D(**kw)
    jp = JaxBatched1D(jcfg, alpha_max=100.0, speculative=True)
    jo = jp.run(jax_sweep_1d(jcfg, **sweep), max_iter=10, verbose=False)
    outs = {}
    for spec in (False, True):
        tp = BatchedProblem1D(cfg, alpha_max=100.0, speculative=spec,
                              device="cpu")
        outs[spec] = (tp.run(sweep_1d(cfg, **sweep), max_iter=10,
                             verbose=False), tp.speculative_rounds)
    (seq, _), (spec, rounds) = outs[False], outs[True]
    assert rounds == jp.speculative_rounds > 0
    assert _rel(spec["cost_history"], jo["cost_history"]) <= 1e-10
    assert _rel(spec["u"], jo["u"]) <= 1e-10
    np.testing.assert_array_equal(spec["ls_trials"], jo["ls_trials"])
    assert spec["newton_solves"] == jo["newton_solves"]
    np.testing.assert_allclose(spec["cost_history"], seq["cost_history"],
                               rtol=1e-11)
    np.testing.assert_allclose(spec["u"], seq["u"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(spec["alpha"], seq["alpha"], rtol=1e-12)
    np.testing.assert_array_equal(spec["ls_trials"], seq["ls_trials"])
