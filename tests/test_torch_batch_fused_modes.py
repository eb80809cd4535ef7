"""The batch runner's search modes on the port alone (vch_tpu/parallel/
batch.py:168-275, :401-684): on the fused route (float32, the plain kernel
versions on the CPU; the one-member and the blocked kernels' routes) and on
the low-memory problem, whose LowMemState goes through the gathers, the
speculative scatter and the chunker, a numeric `straggler_batch`, the
speculative search and chunked execution take the plain search's accept
decisions exactly: ls_trials equal, alpha within 1e-12 (the speculative
ladder multiplies in another order), cost history within 1e-6 (float32
fused route) or 1e-9 (float64), each mode's counter above 0.
"""
import numpy as np
import pytest
import torch

from vch_tpu_torch.config import ForwardSolverConfig2D
from vch_tpu_torch.parallel.batch import (BatchedProblem2D,
                                          LowMemBatchedProblem2D, sweep_2d)

torch.set_num_threads(2)

# the fused route on the CPU (plain kernel versions), float32: the
# heterogeneous sweep of tests/test_torch_batch.py, 16 members, which
# backtrack into the "auto" buckets
FUSED = dict(Nx=16, Ny=16, T=0.06, dtype="float32", newton_tol=2e-4,
             fused_march_block=8)
FUSED_MODES = {"auto": {}, "whole batch": {"straggler_batch": 0},
               "numeric 5": {"straggler_batch": 5},
               "speculative": {"speculative": True},
               "chunked 8": {"chunk_size": 8}}


@pytest.fixture(scope="module")
def fused_runs():
    cfg = ForwardSolverConfig2D(**FUSED)
    sc = sweep_2d(cfg, b3_values=np.logspace(-6, 0, 4),
                  kappa_values=np.logspace(-6, -1, 4))
    out = {}
    for mode, kw in FUSED_MODES.items():
        p = BatchedProblem2D(cfg, device="cpu", fused_march=True, **kw)
        out[mode] = (p, p.run(sc, max_iter=3, verbose=False))
    return out


@pytest.mark.parametrize("mode", [m for m in FUSED_MODES if m != "auto"])
def test_fused_route_modes_take_the_same_decisions(fused_runs, mode):
    ref_p, ref = fused_runs["auto"]
    p, out = fused_runs[mode]
    assert ref_p.straggler_batch == "auto" and ref_p.straggler_rounds > 0
    np.testing.assert_array_equal(out["ls_trials"], ref["ls_trials"])
    np.testing.assert_allclose(out["alpha"], ref["alpha"], rtol=1e-12)
    np.testing.assert_allclose(out["cost_history"], ref["cost_history"],
                               rtol=1e-6)
    assert np.isfinite(out["cost_history"]).all()
    counter = {"numeric 5": p.straggler_rounds,
               "speculative": p.speculative_rounds,
               "chunked 8": p.chunk_calls,
               "whole batch": 1}[mode]
    assert counter > 0
    if mode == "whole batch":
        assert p.straggler_batch is None and p.straggler_rounds == 0


def test_lowmem_modes_take_the_same_decisions():
    """The low-memory problem's LowMemState goes through the gathers, the
    speculative scatter and the chunker (its scan arm, float64)."""
    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.06)
    sc = sweep_2d(cfg, b3_values=np.logspace(-6, 0, 4),
                  kappa_values=np.logspace(-6, -1, 2))
    runs = {}
    for mode, kw in (("plain", {}), ("straggler", {"straggler_batch": 4}),
                     ("speculative", {"speculative": True}),
                     ("chunked", {"chunk_size": 2})):
        p = LowMemBatchedProblem2D(cfg, K=4, device="cpu", **kw)
        runs[mode] = (p, p.run(sc, max_iter=3, verbose=False))
    plain = runs["plain"][1]
    for mode in ("straggler", "speculative", "chunked"):
        p, out = runs[mode]
        np.testing.assert_array_equal(out["ls_trials"], plain["ls_trials"])
        np.testing.assert_allclose(out["cost_history"], plain["cost_history"],
                                   rtol=1e-9)
        np.testing.assert_allclose(out["u"], plain["u"], rtol=0, atol=1e-8)
    assert runs["straggler"][0].straggler_rounds > 0
    assert runs["speculative"][0].speculative_rounds > 0
    assert runs["chunked"][0].chunk_calls > 0
