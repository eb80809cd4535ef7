"""The port's scenario mesh (vch_tpu_torch/parallel/mesh.py and the mesh
arms of parallel/batch.py) under gloo on the CPU, at world sizes 2 and 4
(tests/test_parallel.py:49, 74, 157, 274-363).

The port's ranks run as processes of their own
(tests/test_torch_dist_cases.py, no JAX there), every collective with a 60 s
timeout and the world joined with a deadline. Each sharded run is held
against the same problem run unsharded in the same world and, where vch_tpu
has the test, against vch_tpu on a mesh of the same size (float64, the 8
virtual CPU devices).

Tolerances: float64 costs 1e-10 relative, u 1e-10, trials, Newton solves and
straggler rounds equal; float32 runs equal to the unsharded run to the last
bit where the members' batch does not change the arithmetic, the 1D march
within vch_tpu's own 1e-5 (costs) and 1e-3 (u), as its CPU matmuls block by
the local batch.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import test_torch_dist_cases as cases

WORLDS = (2, 4)
MESH = ("shard", "batched_1d", "straggler", "fused_2d", "fused_1d",
        "indivisible", "blocked", "lowmem", "checkpoint", "factoring")


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, tmp_path_factory):
    w = request.param
    return w, cases.run_ranks(w, MESH, tmp_path_factory.mktemp("mesh"),
                              timeout=300)


def _jmesh(n):
    from vch_tpu.parallel.mesh import make_mesh
    return make_mesh(n_devices=n)


def _same_run(c, cost_rtol=0.0, u_atol=0.0):
    np.testing.assert_allclose(c["cost"], c["cost_ref"], rtol=cost_rtol,
                               atol=0)
    np.testing.assert_allclose(c["u"], c["u_ref"], rtol=0, atol=u_atol)
    np.testing.assert_array_equal(c["trials"], c["trials_ref"])
    np.testing.assert_allclose(c["alpha"], c["alpha_ref"], rtol=1e-12)


def test_shard_batch_gives_each_rank_its_block(ranks):
    """Rank r of D holds rows [r B/D, (r+1) B/D) (test_parallel.py:74)."""
    w, res = ranks
    blocks = res["shard"]["blocks"]
    np.testing.assert_array_equal(blocks.reshape(8, 4),
                                  np.arange(32).reshape(8, 4))
    assert blocks.shape[0] == w


def test_shard_fused_runs_a_block_per_rank(ranks):
    """shard_fused: each rank calls fn on its own block and every rank gets
    the whole result; a batch the mesh does not divide runs whole."""
    w, res = ranks
    c = res["shard"]
    np.testing.assert_array_equal(c["even0"], 2.0 * np.arange(8))
    np.testing.assert_array_equal(c["even1"], np.full((8, 3), 2.0))
    np.testing.assert_array_equal(c["odd0"], 2.0 * np.arange(3))
    np.testing.assert_array_equal(c["calls"], [8 // w, 3])


@pytest.fixture
def own_world():
    """Destroys the process group the test makes."""
    with cases.own_world():
        yield


@functools.lru_cache(maxsize=None)
def _jax_batched_1d(w):
    from vch_tpu.config import ForwardSolverConfig1D, OptimizationConfig
    from vch_tpu.parallel.batch import BatchedProblem1D, sweep_1d
    cfg = ForwardSolverConfig1D(N=64, T=0.2)
    sc = sweep_1d(cfg, OptimizationConfig(),
                  b3_values=[1e-3, 2e-3, 3e-3, 4e-3],
                  kappa_values=[1e-5, 1e-4])
    return BatchedProblem1D(cfg, mesh=_jmesh(w)).run(sc, max_iter=3,
                                                     verbose=False)


def test_batched_1d_sharded_matches_unsharded_and_vch_tpu(ranks):
    """BatchedProblem1D on the mesh (test_parallel.py:49): equal to the
    unsharded run and to vch_tpu's on a mesh of the same size, 1e-10."""
    w, res = ranks
    c = res["batched_1d"]
    _same_run(c, cost_rtol=1e-10, u_atol=1e-10)
    assert int(c["newton"]) == int(c["newton_ref"])
    ref = _jax_batched_1d(w)
    np.testing.assert_allclose(c["cost"], ref["cost_history"], rtol=1e-10)
    np.testing.assert_allclose(c["u"], ref["u"], rtol=0, atol=1e-10)
    np.testing.assert_array_equal(c["trials"], ref["ls_trials"])
    assert int(c["newton"]) == int(ref["newton_solves"])


@functools.lru_cache(maxsize=None)
def _jax_straggler(w):
    from vch_tpu.config import ForwardSolverConfig2D
    from vch_tpu.parallel.batch import BatchedProblem2D, sweep_2d
    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.15)
    sc = sweep_2d(cfg, b3_values=[5e-5, 1e-4, 2e-4, 4e-4],
                  kappa_values=[5e-5, 1e-4, 1.5e-4, 2e-4, 3e-4, 4e-4])
    prob = BatchedProblem2D(cfg, alpha_max=2000.0, mesh=_jmesh(w),
                            straggler_batch=1)
    out = prob.run(sc, max_iter=cases.STRAGGLER_ITERS, verbose=False)
    return out, prob.straggler_rounds


def test_mesh_straggler_buckets_match_full_and_vch_tpu(ranks):
    """Per-rank straggler compaction (test_parallel.py:157): each rank
    gathers its own stragglers; costs and u equal to the full-batch masked
    run, fewer Newton solves; trials, straggler rounds and Newton solves
    equal to vch_tpu's per-device compaction on a mesh of the same size
    (costs 1e-10)."""
    w, res = ranks
    c = res["straggler"]
    assert int(c["rounds"]) > 0
    np.testing.assert_allclose(c["cost"], c["cost_full"], rtol=1e-11)
    np.testing.assert_allclose(c["u"], c["u_full"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(c["alpha"], c["alpha_full"], rtol=1e-12)
    assert int(c["newton"]) < int(c["newton_full"])
    np.testing.assert_array_equal(c["buckets"], [w])    # 1 per rank
    ref, rounds = _jax_straggler(w)
    np.testing.assert_allclose(c["cost"], ref["cost_history"], rtol=1e-10)
    np.testing.assert_array_equal(c["trials"], ref["ls_trials"])
    assert int(c["rounds"]) == rounds
    assert int(c["newton"]) == int(ref["newton_solves"])


def _f32_2d(**kw):
    from vch_tpu.config import ForwardSolverConfig2D
    return ForwardSolverConfig2D(**{**dict(
        Nx=16, Ny=16, T=0.06, dtype="float32", newton_tol=2e-4,
        fused_krylov_fixed_iters=4, fused_solve_precision="highest"), **kw})


@functools.lru_cache(maxsize=None)
def _jax_mesh_run(name, w):
    """vch_tpu's run of the port's case `name` (test_torch_dist_cases) on a
    mesh of w of the virtual devices: the same configuration, sweep and
    iteration count."""
    from vch_tpu.config import (ForwardSolverConfig1D, ForwardSolverConfig2D,
                                OptimizationConfig)
    from vch_tpu.parallel.batch import (BatchedProblem1D, BatchedProblem2D,
                                        LowMemBatchedProblem2D, sweep_1d,
                                        sweep_2d)
    mesh = _jmesh(w)
    if name == "fused_1d":
        cfg = ForwardSolverConfig1D(N=64, T=0.2, dtype="float32",
                                    newton_tol=2e-4, linsolve_1d="spectral")
        sc = sweep_1d(cfg, OptimizationConfig(),
                      b3_values=[1e-3, 2e-3, 3e-3, 4e-3],
                      kappa_values=[1e-5, 1e-4])
        prob, iters = BatchedProblem1D(cfg, mesh=mesh, fused_march=True), 2
    elif name == "lowmem":
        cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.05)
        sc = sweep_2d(cfg, b3_values=[1e-4, 2e-4], kappa_values=[5e-5, 1e-4],
                      materialize_phi_Q=False)
        prob, iters = LowMemBatchedProblem2D(cfg, K=2, mesh=mesh), 2
    else:
        cfg = (_f32_2d(fused_march_block=4, T=0.05) if name == "blocked"
               else _f32_2d())
        b3, iters = (([1e-4, 2e-4, 3e-4], 1) if name == "indivisible"
                     else ([1e-4, 2e-4, 3e-4, 4e-4], 2))
        ks = [1e-4] if name == "indivisible" else [1e-5, 1e-4]
        sc = sweep_2d(cfg, b3_values=b3, kappa_values=ks)
        prob = BatchedProblem2D(cfg, mesh=mesh, fused_march=True)
    return prob.run(sc, max_iter=iters, verbose=False)


# vch_tpu's gates for a sharded run against an unsharded one
# (tests/test_parallel.py:274-363): costs relative, u absolute; float64 as
# the 1D scenario mesh above
VCH_GATES = {"fused_2d": (1e-5, 1e-4), "indivisible": (1e-5, 1e-4),
             "blocked": (1e-5, 1e-4), "fused_1d": (1e-5, 1e-3),
             "lowmem": (1e-10, 1e-10)}


@pytest.mark.parametrize("name", ["fused_2d", "indivisible", "blocked",
                                  "lowmem"])
def test_mesh_run_equals_unsharded_run(ranks, name):
    """The fused 2D route (test_parallel.py:274), a batch of 3 the mesh
    does not divide, run whole on every rank (:326), the blocked route
    (:351) and the low-memory problem: each bit for bit the unsharded run
    (a member's arithmetic does not depend on its batch), and within
    vch_tpu's own gates of vch_tpu on a mesh of the same size, its trials
    and Newton solves equal."""
    w, res = ranks
    c = res[name]
    _same_run(c)
    assert int(c["newton"]) == int(c["newton_ref"])
    _holds_to_vch_tpu(c, _jax_mesh_run(name, w), *VCH_GATES[name])


def _holds_to_vch_tpu(c, ref, cost_rtol, u_atol):
    np.testing.assert_allclose(c["cost"], ref["cost_history"],
                               rtol=cost_rtol, atol=0)
    np.testing.assert_allclose(c["u"], ref["u"], rtol=0, atol=u_atol)
    np.testing.assert_array_equal(c["trials"], ref["ls_trials"])
    assert int(c["newton"]) == int(ref["newton_solves"])


def test_fused_1d_sharded_matches_unsharded(ranks):
    """The fused 1D route on the mesh (test_parallel.py:301): against the
    unsharded run and vch_tpu on a mesh of the same size, within vch_tpu's
    tolerances for it."""
    w, res = ranks
    c = res["fused_1d"]
    np.testing.assert_allclose(c["cost"], c["cost_ref"], rtol=1e-5)
    np.testing.assert_allclose(c["u"], c["u_ref"], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(c["trials"], c["trials_ref"])
    _holds_to_vch_tpu(c, _jax_mesh_run("fused_1d", w), *VCH_GATES["fused_1d"])


def test_mesh_checkpoint_resume_and_metrics(ranks):
    """Under the mesh the first rank writes the checkpoint and the metrics
    (one file each), every rank resumes from it and lands on the
    uninterrupted run (u 1e-12); host_results=False is the rank's block."""
    w, res = ranks
    c = res["checkpoint"]
    assert np.allclose(c["u_resumed"], c["u_full"], atol=1e-12)
    np.testing.assert_allclose(c["cost_resumed"][-1], c["cost_full"][-1],
                               rtol=1e-12)
    assert list(c["events"]) == ["pgd_iter", "pgd_iter", "run_done"]
    assert int(c["local_rows"]) == 4 // w


def test_make_batched_problem_remeshes_when_a_member_does_not_fit(ranks):
    """The automatic combined arm (vch_tpu batch.py:1262-1284): a 1D mesh
    whose device limit one member's low-memory working set exceeds becomes
    (scenarios, gx) with gx = 2 on 16 rows."""
    w, res = ranks
    c = res["factoring"]
    assert bool(c["combined"])
    np.testing.assert_array_equal(c["shape"], [w // 2, 2])
    assert list(c["names"]) == ["scenarios", "gx"]


@pytest.mark.parametrize("n_devices, rows, expect", [
    (3, 129, 3), (6, 129, 3), (4, 129, None), (8, 257, None),
    (4, 16, 2), (8, 16, 2)])
def test_grid_factor_iterates_over_divisors(n_devices, rows, expect):
    """The port's gx factoring: the smallest divisor of the device count
    that divides the rows (ROADMAP C). At 129 rows on 3 devices vch_tpu,
    which doubles gx from 2, raises; the port takes gx = 3."""
    from vch_tpu_torch.parallel.batch import grid_factor
    member, limit = 3.0, 2.0        # any gx >= 2 fits
    if expect is None:
        with pytest.raises(ValueError, match="cannot"):
            grid_factor(n_devices, rows, member, limit)
    else:
        assert grid_factor(n_devices, rows, member, limit) == expect


def test_vch_tpu_cannot_factor_129_rows_on_3_devices():
    """The divergence's other side: vch_tpu's chooser on a 3-device mesh at
    129 rows, where one member does not fit the limit, raises."""
    from vch_tpu.config import ForwardSolverConfig2D
    from vch_tpu.parallel.batch import make_batched_problem_2d
    from vch_tpu.parallel.mesh import make_mesh
    assert len(jax.devices()) >= 3
    with pytest.raises(ValueError, match="cannot be factored"):
        make_batched_problem_2d(ForwardSolverConfig2D(Nx=128, Ny=128,
                                                      T=0.05),
                                batch=3, hbm_limit_bytes=1000,
                                mesh=make_mesh(n_devices=3))


def test_make_mesh_one_process_per_device(own_world):
    """n_devices other than the world's size raises: the port runs one
    process per device (torchrun), where vch_tpu takes a slice of
    jax.devices()."""
    from vch_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("scenarios",)
    assert mesh.size() == torch.distributed.get_world_size()
    with pytest.raises(ValueError, match="one process per device"):
        make_mesh(n_devices=mesh.size() + 1, device="cpu")
