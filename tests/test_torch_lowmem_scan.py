"""Port parity for the scan arm of the segment-checkpointed (low-memory)
path, the cases of tests/test_lowmem.py through the port on the CPU: the
recomputing adjoint against the full-memory adjoint in 2D and 1D (also
with non-divisible segments and a partial final dt), the cost from the J1
accumulator, the batched PGD against the full-memory PGD, the float32
fixed-trip adjoint, and the fused arm against the scan arm; and the port's
low-memory adjoint against vch_tpu's on the same numpy inputs.

Tolerances are those of tests/test_lowmem.py: float64 r to 1e-12 absolute
against full memory (the same recurrences: segment recomputation repeats
the forward exactly), the cost to 1e-10 relative, the PGD costs to 1e-9
relative and u to 1e-10; float32 r to 1e-4 of its scale, and fused against
scan costs to 2e-5 relative and u to 1e-4. Against vch_tpu, float64 r to
1e-10 of its scale (sums in another order).
"""
import numpy as np
import torch

from vch_tpu.config import ForwardSolverConfig1D as JaxConfig1D
from vch_tpu.config import ForwardSolverConfig2D as JaxConfig2D
from vch_tpu.models.lowmem import LowMemPipeline1D as JaxPipeline1D
from vch_tpu.models.lowmem import LowMemPipeline2D as JaxPipeline2D

from vch_tpu_torch.config import ForwardSolverConfig1D, ForwardSolverConfig2D
from vch_tpu_torch.control.cost import calculate_cost_2d
from vch_tpu_torch.control.targets import build_targets_1d, build_targets_2d
from vch_tpu_torch.models.adjoint1d import AdjointSolver1D
from vch_tpu_torch.models.adjoint2d import AdjointSolver2D
from vch_tpu_torch.models.forward1d import ForwardSolver1D
from vch_tpu_torch.models.forward2d import ForwardSolver2D
from vch_tpu_torch.models.lowmem import LowMemPipeline1D, LowMemPipeline2D
from vch_tpu_torch.parallel.batch import (BatchedProblem2D,
                                          LowMemBatchedProblem2D, sweep_2d)

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _full_and_low_2d(kw, K, seed):
    """r of the full-memory sweep on the simulated trajectory and of the
    low-memory pipeline, on one seeded control, with the ramp targets."""
    cfg = ForwardSolverConfig2D(**kw)
    s = ForwardSolver2D(cfg, device="cpu")
    n = cfg.Nx + 1
    rng = np.random.default_rng(seed)
    u = 0.05 * rng.standard_normal((s.M + 1, n, n))
    if cfg.dtype == "float32":
        u = u.astype(np.float32)
    phi_hist, (x, y), t = s.simulate(control=u)
    phi_T, phi_Q = build_targets_2d(x, y, t, phi_hist[0].numpy(), 1.0, 1.0,
                                    cfg.T)
    _, _, r_full = AdjointSolver2D(cfg, device="cpu").run(
        phi_hist, t, 5.0, 10.0, phi_Q, phi_T)
    lp = LowMemPipeline2D(cfg, K=K, device="cpu")
    r_low = lp.adjoint_r(u, b1=5.0, b2=10.0, phi_Q=phi_Q, phi_T_target=phi_T)
    return lp, u, phi_Q, phi_T, r_full.numpy(), r_low.numpy()


def test_lowmem_adjoint_matches_full_memory():
    """tests/test_lowmem.py:21 at 16x16 (10 steps, K = 5)."""
    _, _, _, _, r_full, r_low = _full_and_low_2d(
        dict(Nx=16, Ny=16, T=0.1, dt_initial=1e-2), K=5, seed=0)
    assert r_low.shape == r_full.shape
    assert np.abs(r_low - r_full).max() < 1e-12


def test_lowmem_nondivisible_segments_and_partial_dt():
    """T = 0.13 with dt = 2e-2: 7 steps, the last 1e-2; K = 3 gives two full
    segments and a 1-step tail (tests/test_lowmem.py:41); and vch_tpu's
    low-memory r on the same inputs."""
    kw = dict(Nx=16, Ny=16, T=0.13, dt_initial=2e-2)
    lp, u, phi_Q, phi_T, r_full, r_low = _full_and_low_2d(kw, K=3, seed=1)
    s = lp.solver
    assert s.M % 3 != 0 and not np.allclose(s.dts_np, s.dts_np[0])
    assert lp.core.bounds == [(0, 3), (3, 3), (6, 1)] and lp.S == 3
    assert np.abs(r_low - r_full).max() < 1e-12
    jr = JaxPipeline2D(JaxConfig2D(**kw), K=3).adjoint_r(
        u, b1=5.0, b2=10.0, phi_Q=phi_Q, phi_T_target=phi_T)
    assert _rel(r_low, jr) < 1e-10, _rel(r_low, jr)


def test_lowmem_1d_matches_full_memory():
    """tests/test_lowmem.py:64: 10 steps in 2 segments of 4 and a 2-step
    tail; and vch_tpu's 1D low-memory r on the same inputs."""
    kw = dict(N=48, T=0.1, dt_initial=1e-2)
    cfg = ForwardSolverConfig1D(**kw)
    s = ForwardSolver1D(cfg, device="cpu")
    lp = LowMemPipeline1D(cfg, K=4, device="cpu")
    assert lp.core.bounds == [(0, 4), (4, 4), (8, 2)]
    rng = np.random.default_rng(2)
    u = 0.05 * rng.standard_normal((s.M + 1, 49))
    phi_hist, x, t = s.simulate(control=u)                   # core layout
    phi_T, phi_Q = build_targets_1d(x, t, phi_hist[0].numpy(), 1.0, cfg.T)
    _, _, r_full = AdjointSolver1D(cfg, device="cpu").run(
        phi_hist, t, 0.3, 13.0, phi_Q, phi_T)
    r_low = lp.adjoint_r(u, b1=0.3, b2=13.0, phi_Q=phi_Q, phi_T_target=phi_T)
    assert r_low.shape == r_full.shape == (s.M + 1, 49)
    assert np.abs(r_low.numpy() - r_full.numpy()).max() < 1e-12
    jr = JaxPipeline1D(JaxConfig1D(**kw), K=4).adjoint_r(
        u, b1=0.3, b2=13.0, phi_Q=phi_Q, phi_T_target=phi_T)
    assert _rel(r_low.numpy(), jr) < 1e-10, _rel(r_low.numpy(), jr)


def test_lowmem_cost_matches_full_cost():
    """J1 accumulated during the forward equals the trapz cost on the
    materialized trajectory (tests/test_lowmem.py:83)."""
    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.13, dt_initial=2e-2)
    lp = LowMemPipeline2D(cfg, K=3, device="cpu")
    s = lp.solver
    rng = np.random.default_rng(3)
    u = torch.as_tensor(0.05 * rng.standard_normal((s.M + 1, 17, 17)))
    phi_hist, (x, y), t = s.simulate(control=u.numpy())
    phi_T, phi_Q = build_targets_2d(x, y, t, phi_hist[0].numpy(), 1.0, 1.0,
                                    cfg.T)
    phi_T, phi_Q = torch.as_tensor(phi_T), torch.as_tensor(phi_Q)
    state = lp.core.forward_ckpt(u[None], phi_hist[:1], phi_Q[None])
    assert state.ck_phi.shape == (1, 3, 17, 17)
    assert torch.equal(state.phi_T[0], phi_hist[-1])
    assert int(state.newton_solves[0]) == s.last_stats.newton_solves
    one = torch.ones(1, dtype=torch.float64)
    c_low = float(lp.core.cost(state, u[None], phi_T[None], 5.0 * one,
                               10.0 * one, 1e-4 * one, 1e-4 * one)[0])
    T = lambda a: torch.as_tensor(a, dtype=torch.float64)
    c_full = float(calculate_cost_2d(phi_hist, u, phi_Q, phi_T, T(x), T(y),
                                     T(t), 5.0, 10.0, 1e-4, 1e-4))
    assert abs(c_low - c_full) < 1e-10 * max(abs(c_full), 1.0)


def test_lowmem_batched_pgd_matches_full_memory_pgd():
    """Three low-memory PGD iterations on the scan arm equal three
    full-memory ones on the scan path (tests/test_lowmem.py:109): 10 steps
    in 2 segments and a 2-step tail."""
    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.1, dt_initial=1e-2)
    sc = sweep_2d(cfg, b3_values=[1e-4, 2e-4])
    full = BatchedProblem2D(cfg, device="cpu")
    low = LowMemBatchedProblem2D(cfg, K=4, device="cpu")
    assert not full._use_fused_march and not low._use_fused_march
    out_f = full.run(sc, max_iter=3, verbose=False)
    out_l = low.run(sc, max_iter=3, verbose=False)
    np.testing.assert_allclose(out_l["cost_history"], out_f["cost_history"],
                               rtol=1e-9)
    np.testing.assert_allclose(out_l["u"], out_f["u"],
                               atol=1e-10)
    assert out_l["newton_solves"] == out_f["newton_solves"]


def test_lowmem_f32_fixed_trip_adjoint_matches_full_memory():
    """The float32 scan arm solves each adjoint step in fixed trips, as the
    full-memory float32 sweep does (tests/test_lowmem.py:127)."""
    kw = dict(Nx=16, Ny=16, T=0.1, dt_initial=1e-2, dtype="float32",
              newton_tol=2e-4)
    lp, _, _, _, r_full, r_low = _full_and_low_2d(kw, K=4, seed=3)
    assert lp.solver._krylov_fixed is not None
    assert lp.adjoint._krylov_fixed == 5 and not lp.adjoint._use_pallas
    assert np.all(np.isfinite(r_low))
    scale = np.abs(r_full).max()
    assert np.abs(r_low - r_full).max() < 1e-4 * max(scale, 1e-30)


def test_lowmem_fused_batched_matches_scan_lowmem():
    """LowMemBatchedProblem2D(fused_march=True) (the plain segment kernels
    on the CPU) reproduces the scan arm, with the forward's trips pinned to
    the scan path's (tests/test_lowmem.py:204)."""
    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.1, dt_initial=1e-2,
                                dtype="float32", newton_tol=2e-4,
                                fused_krylov_fixed_iters=4,
                                fused_solve_precision="highest")
    mk = lambda: sweep_2d(cfg, b3_values=[1e-4, 2e-4])
    scan = LowMemBatchedProblem2D(cfg, K=4, device="cpu")
    assert not scan._use_fused_march
    out_scan = scan.run(mk(), max_iter=3, verbose=False)
    low = LowMemBatchedProblem2D(cfg, K=4, device="cpu", fused_march=True)
    assert low._use_fused_march and low.straggler_batch == "auto"
    out_fused = low.run(mk(), max_iter=3, verbose=False)
    np.testing.assert_allclose(out_fused["cost_history"],
                               out_scan["cost_history"], rtol=2e-5)
    np.testing.assert_allclose(out_fused["u"], out_scan["u"],
                               rtol=0, atol=1e-4)
