"""The port's grid-sharded solvers (vch_tpu_torch/parallel/spatial.py) under
gloo on the CPU, at world sizes 2 and 4, against vch_tpu on meshes of the
same size (tests/test_spatial_sharding.py:12-236 and its two slow cases).

The port's ranks run as processes of their own
(tests/test_torch_dist_cases.py, no JAX there), every collective with a 60 s
timeout and the world joined with a deadline; the references run here, in
float64.

Tolerances (vch_tpu's own gates): the halo Laplacian 1e-12 relative and
exactly 0 on a constant; the forward 1e-8, its Newton counts equal; the
adjoint 1e-7 times the field's scale; the combined (scenarios, gx) mesh's
forward and adjoint 1e-10 times the scale per member; a resume 1e-12; PGD
costs rtol 1e-8 with trials and plateau boosts equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import test_torch_dist_cases as cases

WORLDS = (2, 4)
SPATIAL = ("laplacian", "forward", "rows_rejected", "adjoint", "combined",
           "resume", "pgd_small")


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, tmp_path_factory):
    """(world size, {case: rank 0's arrays}) of one gloo world."""
    w = request.param
    return w, cases.run_ranks(w, SPATIAL, tmp_path_factory.mktemp("spatial"),
                              timeout=300)


def _jmesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _cfg(**kw):
    from vch_tpu.config import ForwardSolverConfig2D
    return ForwardSolverConfig2D(**kw)


@functools.lru_cache(maxsize=None)
def _jax_forward(world):
    from vch_tpu.models.forward2d import ForwardSolver2D
    from vch_tpu.parallel.spatial import GridShardedForward2D
    cfg = _cfg(Nx=31, Ny=24, T=0.05, dt_initial=1e-2)
    u = 0.05 * np.random.default_rng(0).standard_normal((6, 32, 25))
    gs = GridShardedForward2D(cfg, mesh=_jmesh((world,), ("gx",)))
    phi, _, _ = gs.simulate(control=u)
    ref = ForwardSolver2D(_cfg(Nx=31, Ny=24, T=0.04, dt_initial=1e-2))
    ref.simulate()
    return (np.asarray(phi), int(gs.last_stats.newton_solves),
            int(ref.last_stats.newton_solves))


def test_halo_laplacian_matches_the_stencil(ranks):
    from vch_tpu.ops.laplacian import stencil_laplacian_2d
    _, res = ranks
    c = res["laplacian"]
    ref = np.asarray(stencil_laplacian_2d(jnp.asarray(c["v"]), 1 / 127,
                                          1 / 127))
    assert np.abs(c["lap"] - ref).max() < 1e-12 * np.abs(ref).max()


def test_halo_laplacian_neumann_nullspace(ranks):
    _, res = ranks
    assert np.abs(res["laplacian"]["const"]).max() == 0.0


def test_grid_sharded_forward_matches_vch_tpu(ranks):
    """vch_tpu spatial's marcher on a mesh of the same size: 1e-8."""
    w, res = ranks
    c = res["forward"]
    phi, newton, _ = _jax_forward(w)
    assert np.abs(c["phi"] - phi).max() < 1e-8
    assert int(c["newton"]) == newton > 0


def test_grid_sharded_forward_counters_and_sanitizer(ranks):
    """Newton counts of the default march equal the unsharded
    ForwardSolver2D's (test_spatial_sharding.py:86)."""
    w, res = ranks
    c = res["forward"]
    assert int(c["newton_default"]) == _jax_forward(w)[2] > 0
    assert int(c["first_bad"]) == -1
    all_reduce, reduce_scatter, halo, p2p = c["counts"]
    assert min(all_reduce, reduce_scatter, halo) > 0
    # one send and one receive per neighbour and exchange: 2 on the end
    # ranks, 4 inside; rank 0 has one neighbour
    assert p2p == 2 * halo


def test_grid_sharded_rejects_indivisible_rows(ranks):
    _, res = ranks
    assert "must divide" in str(res["rows_rejected"]["raised"])


def test_grid_sharded_adjoint_matches_vch_tpu(ranks):
    """The (p, q, r) sweep on the port's float64 trajectory against vch_tpu
    spatial's on a mesh of the same size: 1e-7 times the scale."""
    from vch_tpu.parallel.spatial import GridShardedAdjoint2D
    w, res = ranks
    c = res["adjoint"]
    cfg = _cfg(Nx=31, Ny=24, T=0.05, dt_initial=1e-2)
    gadj = GridShardedAdjoint2D(cfg, mesh=_jmesh((w,), ("gx",)))
    ref = map(np.asarray, gadj.run(c["phi"], c["t"], 5.0, 10.0,
                                   np.zeros_like(c["phi"]), c["phi_T"]))
    for a, nm in zip(ref, "pqr"):
        scale = max(np.abs(a).max(), 1e-30)
        assert np.abs(a - c[nm]).max() < 1e-7 * scale, nm


def test_combined_mesh_forward_adjoint_match_vch_tpu(ranks):
    """The batched march and sweep on the combined mesh ((1, 2) at world 2,
    (2, 2) at 4) against vch_tpu's on the same mesh shape: 1e-10 times the
    scale per member, Newton solves per member equal."""
    from vch_tpu.parallel.spatial import (GridShardedAdjoint2D,
                                          GridShardedForward2D)
    w, res = ranks
    c = res["combined"]
    cfg = _cfg(Nx=31, Ny=24, T=0.04, dt_initial=1e-2)
    mesh = _jmesh((w // 2, 2), ("scenarios", "gx"))
    fwd = GridShardedForward2D(cfg, mesh=mesh, batch_axis="scenarios")
    u = jnp.zeros((4, fwd.M + 1, 32, 25))
    phi, ns, bad = fwd.march(u, jnp.asarray(c["phi0"]))
    adj = GridShardedAdjoint2D(cfg, mesh=mesh, batch_axis="scenarios")
    _, _, r = adj.run_impl(phi, jnp.asarray(fwd.dts), jnp.asarray(c["b1"]),
                           jnp.asarray(c["b2"]), jnp.zeros_like(phi),
                           jnp.asarray(c["phiT"]))
    phi, r = np.asarray(phi), np.asarray(r)
    assert np.all(c["bad"] == -1)
    np.testing.assert_array_equal(c["newton"], np.asarray(ns))
    for i in range(4):
        for a, b in ((c["phi"][i], phi[i]), (c["r"][i], r[i])):
            assert np.abs(a - b).max() < 1e-10 * max(np.abs(b).max(), 1e-30)


def test_combined_mesh_checkpoint_resume(ranks):
    """Checkpoint at 2 and resume to 3 on the combined mesh lands on the
    uninterrupted run (test_spatial_sharding.py:210); host_results=False
    gives this rank's members' row blocks."""
    w, res = ranks
    c = res["resume"]
    assert np.allclose(c["u_resumed"], c["u_full"], atol=1e-12)
    np.testing.assert_allclose(c["cost_resumed"][-1], c["cost_full"][-1],
                               rtol=1e-12)
    assert tuple(c["local_shape"]) == (4 // (w // 2), 4, 8, 17)


def test_grid_sharded_pgd_matches_vch_tpu(ranks):
    """GridShardedProblem2D, 2 iterations at 16 x 17, against vch_tpu's
    ControlProblem2D: costs rtol 1e-8, trials equal; the coercivity probe
    within 1e-5 (its 1e-4 step amplifies roundoff)."""
    _, res = ranks
    c = res["pgd_small"]
    ref = _jax_pgd_small()
    np.testing.assert_allclose(c["cost"], ref["cost"], rtol=1e-8)
    np.testing.assert_array_equal(c["trials"], ref["trials"])
    np.testing.assert_allclose(c["u"], ref["u"], atol=1e-8)
    np.testing.assert_allclose(c["d2"], ref["d2"], rtol=1e-5)
    assert int(c["newton"]) == ref["newton"] > 0


@functools.lru_cache(maxsize=None)
def _jax_pgd_small():
    from vch_tpu.control.problems import ControlProblem2D
    prob = ControlProblem2D(_cfg(Nx=15, Ny=16, T=0.05, dt_initial=1e-2))
    res = prob.optimize(max_iter=2, verbose=False)
    d2 = prob.second_order_check(res, num_directions=2)
    return dict(cost=np.asarray(res.cost_history),
                trials=np.asarray(res.ls_trials_per_iter),
                u=np.asarray(res.u_optimal), d2=np.asarray(d2),
                newton=int(prob.solver.last_stats.newton_solves))


@pytest.mark.slow
def test_batched_grid_sharded_pgd_matches_unsharded_batched(tmp_path):
    """test_spatial_sharding.py:255 through the port at world size 4, the
    (2, 2) mesh: costs 1e-8 of the port's BatchedProblem2D and of vch_tpu's,
    u 1e-8, Newton solves equal."""
    from vch_tpu.parallel.batch import BatchedProblem2D
    c = cases.run_ranks(4, ["pgd_batched_slow"], tmp_path,
                        timeout=600)["pgd_batched_slow"]
    ch, ch_ref = c["cost"], c["cost_ref"]
    assert np.unique(ch_ref[-1].round(4)).size == 4
    assert np.abs(ch - ch_ref).max() < 1e-8 * np.abs(ch_ref).max()
    assert np.abs(c["u"] - c["u_ref"]).max() < 1e-8
    assert int(c["newton"]) == int(c["newton_ref"]) > 0
    import dataclasses
    from vch_tpu.config import DELTA_SEP
    from vch_tpu.ops.potential import init_phi_random_2d
    from vch_tpu.parallel.batch import sweep_2d
    cfg = _cfg(Nx=31, Ny=24, T=0.04, dt_initial=1e-2)
    sc = sweep_2d(cfg, b3_values=[1e-4, 2e-4], kappa_values=[5e-5, 1e-4])
    phi0 = np.stack([init_phi_random_2d(cfg.Nx, cfg.Ny, DELTA_SEP, amp=0.1,
                                        seed=50 + i) for i in range(4)])
    scale = np.linspace(0.6, 1.4, 4)
    sc = dataclasses.replace(
        sc, phi0=phi0, phi_T=sc.phi_T * scale[:, None, None],
        phi_Q=sc.phi_Q * scale[:, None, None, None],
        b1=sc.b1 * np.linspace(0.5, 2.0, 4),
        b2=sc.b2 * np.linspace(1.5, 0.75, 4))
    jref = BatchedProblem2D(cfg).run(sc, max_iter=2, verbose=False)
    assert np.abs(ch - jref["cost_history"]).max() < 1e-8 * np.abs(ch).max()
    assert int(c["newton"]) == int(jref["newton_solves"])


@pytest.mark.slow
def test_grid_sharded_pgd_six_iterations_matches_vch_tpu(tmp_path):
    """test_spatial_sharding.py:285 through the port at world size 4: six
    iterations with a backtracking episode and a plateau boost, decision
    for decision against vch_tpu's ControlProblem2D (costs and alphas
    rtol 1e-8, u 1e-8, trials and boosts equal)."""
    import dataclasses
    from vch_tpu.config import OptimizationConfig
    from vch_tpu.control.problems import ControlProblem2D
    c = cases.run_ranks(4, ["pgd_grid_slow"], tmp_path,
                        timeout=900)["pgd_grid_slow"]
    opt = OptimizationConfig.defaults_2d().model_copy(
        update=dict(alpha_max=400.0))
    ref = ControlProblem2D(_cfg(Nx=31, Ny=31, T=0.05, dt_initial=1e-2),
                           opt_config=opt)
    ref.loop.s = dataclasses.replace(ref.loop.s, plateau_length=2,
                                     plateau_tolerance=1e-2)
    r = ref.optimize(max_iter=6, verbose=False)
    assert max(r.ls_trials_per_iter) > 1 and r.plateau_boosts >= 1
    np.testing.assert_array_equal(c["trials"], r.ls_trials_per_iter)
    assert int(c["boosts"]) == r.plateau_boosts
    np.testing.assert_allclose(c["cost"], r.cost_history, rtol=1e-8)
    np.testing.assert_allclose(c["u"], np.asarray(r.u_optimal), atol=1e-8)
    np.testing.assert_allclose(c["alpha"], r.alpha_history, rtol=1e-8)
