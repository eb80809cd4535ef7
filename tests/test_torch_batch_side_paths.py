"""Port parity for the batch runner's side paths (vch_tpu/parallel/batch.py:
717-1006): checkpoint/resume, the JSONL metrics, host_results, prewarm,
trial_memory_analysis and the mesh keywords, through vch_tpu's
BatchedProblem1D (float64, on the CPU) and the port's (float64,
device="cpu") on the sweeps of tests/test_parallel.py:81 and :121 and
tests/test_stats_sanitizer.py:69.

Tolerances: the port's cost history, u and alpha within 1e-10 relative of
vch_tpu's; ls_trials and Newton solves equal; a resumed run within vch_tpu's
own gates of an uninterrupted one (u 1e-12, last costs 1e-12). The
checkpoint file is one layout for both packages, so a checkpoint written by
either resumes in the other.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from vch_tpu.config import ForwardSolverConfig1D as JaxConfig1D
from vch_tpu.control.pgd import PGDSettings as JaxPGDSettings
from vch_tpu.parallel.batch import BatchedProblem1D as JaxBatched1D
from vch_tpu.parallel.batch import sweep_1d as jax_sweep_1d

import test_torch_dist_cases as cases
from vch_tpu_torch.config import (ForwardSolverConfig1D,
                                  ForwardSolverConfig2D, OptimizationConfig,
                                  PGDSettings)
from vch_tpu_torch.models.lowmem import LowMemState
from vch_tpu_torch.parallel.batch import (BatchedProblem1D, BatchedProblem2D,
                                          LowMemBatchedProblem2D,
                                          make_batched_problem_2d, sweep_1d,
                                          sweep_2d)

torch.set_num_threads(2)

KW = dict(N=48, T=0.2)
SWEEP = dict(b3_values=[1e-3, 2e-3], kappa_values=[1e-4])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _jax_run(max_iter, **kw):
    cfg = JaxConfig1D(**KW)
    return JaxBatched1D(cfg).run(jax_sweep_1d(cfg, OptimizationConfig(),
                                              **SWEEP),
                                 max_iter=max_iter, verbose=False, **kw)


def _port_run(max_iter, **kw):
    cfg = ForwardSolverConfig1D(**KW)
    return BatchedProblem1D(cfg, device="cpu").run(
        sweep_1d(cfg, OptimizationConfig(), **SWEEP), max_iter=max_iter,
        verbose=False, **kw)


@pytest.fixture(scope="module")
def full_runs():
    """Four uninterrupted iterations in each package."""
    return _jax_run(4), _port_run(4)


def _same_run(out, ref):
    assert _rel(out["cost_history"], ref["cost_history"]) <= 1e-10
    assert _rel(out["u"], ref["u"]) <= 1e-10
    assert _rel(out["alpha"], ref["alpha"]) <= 1e-10


def test_uninterrupted_run_matches_vch_tpu(full_runs):
    jout, out = full_runs
    _same_run(out, jout)
    np.testing.assert_array_equal(out["ls_trials"], jout["ls_trials"])
    assert out["newton_solves"] == jout["newton_solves"]


@pytest.mark.parametrize("writer, reader", [("port", "port"),
                                            ("vch_tpu", "port"),
                                            ("port", "vch_tpu")])
def test_checkpoint_at_2_resumes_to_4(full_runs, tmp_path, writer, reader):
    """tests/test_parallel.py:81: checkpoint at iteration 2, resume to 4,
    and land on the uninterrupted run; across the two packages too."""
    jfull, full = full_runs
    ckpt = str(tmp_path / "pgd.npz")
    (_port_run if writer == "port" else _jax_run)(
        2, checkpoint_path=ckpt, checkpoint_every=2)
    resumed = (_port_run if reader == "port" else _jax_run)(
        4, checkpoint_path=ckpt, resume=True)
    ref = full if reader == "port" else jfull
    assert np.allclose(resumed["u"], ref["u"], atol=1e-12)
    assert np.allclose(resumed["cost_history"][-1], ref["cost_history"][-1],
                       rtol=1e-12)
    _same_run(resumed, jfull)
    assert resumed["cost_history"].shape == (5, 2)


def test_resume_counts_the_forward_and_matches_vch_tpu(tmp_path):
    """A resumed run counts the Newton solves of its recomputed forward, as
    vch_tpu's does; resuming at max_iter runs no iteration and still
    returns r."""
    outs = {}
    for name, run in (("vch_tpu", _jax_run), ("port", _port_run)):
        ckpt = str(tmp_path / f"{name}.npz")
        run(2, checkpoint_path=ckpt, checkpoint_every=1)
        outs[name] = (run(3, checkpoint_path=ckpt, resume=True),
                      run(2, checkpoint_path=ckpt, resume=True))
    (j3, j2), (t3, t2) = outs["vch_tpu"], outs["port"]
    assert t3["newton_solves"] == j3["newton_solves"] > 0
    np.testing.assert_array_equal(t3["ls_trials"], j3["ls_trials"])
    assert t2["newton_solves"] == j2["newton_solves"] > 0
    assert t2["ls_trials"].sum() == 0 and t2["r"].shape == t2["u"].shape
    assert _rel(t2["r"], j2["r"]) <= 1e-10
    _same_run(t3, j3)


def test_metrics_jsonl_and_advisor_match_vch_tpu(tmp_path):
    """tests/test_parallel.py:121: one pgd_iter record an iteration and a
    run_done record with the run's timers and Newton solves; the advisor
    pulled forward to iteration 1."""
    recs, outs = {}, {}
    for name in ("vch_tpu", "port"):
        path = str(tmp_path / f"{name}.jsonl")
        if name == "vch_tpu":
            cfg = JaxConfig1D(**KW)
            st = dataclasses.replace(JaxPGDSettings.defaults_1d(),
                                     advisor_start_iter=1)
            outs[name] = JaxBatched1D(cfg, settings=st).run(
                jax_sweep_1d(cfg, OptimizationConfig(), **SWEEP),
                max_iter=3, verbose=False, metrics_path=path)
        else:
            cfg = ForwardSolverConfig1D(**KW)
            st = dataclasses.replace(PGDSettings.defaults_1d(),
                                     advisor_start_iter=1)
            outs[name] = BatchedProblem1D(cfg, settings=st, device="cpu").run(
                sweep_1d(cfg, OptimizationConfig(), **SWEEP), max_iter=3,
                verbose=False, metrics_path=path)
        with open(path) as f:
            recs[name] = [json.loads(line) for line in f]
    out, jout = outs["port"], outs["vch_tpu"]
    iters = [r for r in recs["port"] if r["event"] == "pgd_iter"]
    done = [r for r in recs["port"] if r["event"] == "run_done"]
    assert len(iters) == 3 and len(done) == 1
    assert recs["port"][-1]["event"] == "run_done"
    assert [set(r) for r in recs["port"]] == [set(r) for r in recs["vch_tpu"]]
    for mine, ref in zip(iters, recs["vch_tpu"]):
        for key in ("k", "converged", "max_trials", "newton_solves"):
            assert mine[key] == ref[key], key
        for key in ("mean_cost", "max_cost", "mean_alpha"):
            assert abs(mine[key] - ref[key]) <= 1e-10 * abs(ref[key]), key
    assert done[0]["newton_solves"] == out["newton_solves"] > 0
    assert set(done[0]["timers"]) == set(out["timers"]) == set(
        recs["vch_tpu"][-1]["timers"])
    adv = out["advisor_alpha"]
    assert adv.shape == (2,) and np.isfinite(adv).all() and (adv > 0).all()
    assert _rel(adv, jout["advisor_alpha"]) <= 1e-10


def test_metrics_count_the_iterations_of_a_short_run(tmp_path):
    """tests/test_stats_sanitizer.py:69."""
    cfg = ForwardSolverConfig1D(N=32, T=0.05)
    path = str(tmp_path / "metrics.jsonl")
    BatchedProblem1D(cfg, device="cpu").run(
        sweep_1d(cfg, b3_values=[1e-3]), max_iter=2, verbose=False,
        metrics_path=path)
    lines = [json.loads(line) for line in open(path)]
    events = [line["event"] for line in lines]
    assert events.count("pgd_iter") == 2
    assert events[-1] == "run_done"
    assert lines[0]["newton_solves"] > 0


def test_host_results_full_memory():
    cfg = ForwardSolverConfig1D(N=32, T=0.05)
    prob = BatchedProblem1D(cfg, device="cpu")
    sc = sweep_1d(cfg, b3_values=[1e-3, 2e-3])
    host = prob.run(sc, max_iter=1, verbose=False)
    dev = prob.run(sc, max_iter=1, verbose=False, host_results=False)
    for key in ("u", "r", "phi"):
        assert isinstance(host[key], np.ndarray), key
        assert isinstance(dev[key], torch.Tensor), key
        np.testing.assert_array_equal(host[key], dev[key].numpy())
    assert host["u"].dtype == np.float64


def test_host_results_lowmem_state_is_tree_mapped():
    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.05)
    prob = LowMemBatchedProblem2D(cfg, K=2, device="cpu")
    sc = sweep_2d(cfg, b3_values=[1e-4, 2e-4], materialize_phi_Q=False)
    host = prob.run(sc, max_iter=1, verbose=False)
    dev = prob.run(sc, max_iter=1, verbose=False, host_results=False)
    assert isinstance(host["phi"], LowMemState)
    assert isinstance(dev["phi"], LowMemState)
    for a, b in zip(host["phi"], dev["phi"]):
        assert isinstance(a, np.ndarray) and isinstance(b, torch.Tensor)
        np.testing.assert_array_equal(a, b.numpy())
    assert isinstance(host["r"], np.ndarray)


def test_dtype_casts_the_inputs():
    cfg = ForwardSolverConfig1D(N=32, T=0.05)
    prob = BatchedProblem1D(cfg, device="cpu")
    sc = sweep_1d(cfg, b3_values=[1e-3])
    a = prob.run(sc, max_iter=1, verbose=False)
    for dtype in ("float64", np.float64, torch.float64):
        b = prob.run(sc, max_iter=1, verbose=False, dtype=dtype)
        np.testing.assert_array_equal(a["cost_history"], b["cost_history"])


def test_prewarm_and_trial_memory_analysis_on_the_cpu():
    """prewarm builds and launches nothing on a CPU device, and
    trial_memory_analysis returns None there (no allocator statistics)."""
    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.05, dtype="float32",
                                newton_tol=2e-4)
    prob = BatchedProblem2D(cfg, device="cpu", fused_march=True)
    sc = sweep_2d(cfg, b3_values=np.logspace(-6, 0, 4),
                  kappa_values=np.logspace(-6, -1, 4))
    assert prob._straggler_buckets(sc.batch) == [8]
    calls = []
    prob._trial = lambda *a: calls.append(a)
    assert prob.prewarm(sc) is None and not calls
    assert prob.trial_memory_analysis(sc) is None and not calls
    p1 = BatchedProblem1D(ForwardSolverConfig1D(N=32, T=0.05), device="cpu")
    sc1 = sweep_1d(p1.fwd_config, b3_values=[1e-3])
    assert p1.prewarm(sc1) is None
    assert p1.trial_memory_analysis(sc1) is None


@pytest.mark.parametrize("sb, B, expect", [
    (None, 64, []), ("auto", 64, [8, 16, 32]), ("auto", 8, []),
    (12, 512, [12]), (12, 12, []), (0, 64, [])])
def test_straggler_buckets(sb, B, expect):
    """vch_tpu :686-715's single-device arms."""
    cfg = ForwardSolverConfig1D(N=32, T=0.05)
    prob = BatchedProblem1D(cfg, device="cpu", straggler_batch=sb)
    assert prob._straggler_buckets(B) == expect


def test_straggler_batch_default_follows_the_route():
    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.05, dtype="float32",
                                newton_tol=2e-4)
    assert BatchedProblem2D(cfg, device="cpu",
                            fused_march=True).straggler_batch == "auto"
    assert BatchedProblem2D(cfg, device="cpu").straggler_batch is None
    assert BatchedProblem2D(cfg, device="cpu", fused_march=True,
                            straggler_batch=12).straggler_batch == 12
    low = LowMemBatchedProblem2D(cfg, K=2, device="cpu", speculative=True,
                                 chunk_size=4)
    assert (low.speculative, low.chunk_size, low.speculative_rounds,
            low.chunk_calls) == (True, 4, 0, 0)


def _mesh_makers(kw):
    c1 = ForwardSolverConfig1D(N=32, T=0.05)
    c2 = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.05)
    return (lambda: BatchedProblem1D(c1, device="cpu", **kw),
            lambda: BatchedProblem2D(c2, device="cpu", **kw),
            lambda: LowMemBatchedProblem2D(c2, K=2, device="cpu", **kw),
            lambda: make_batched_problem_2d(c2, batch=2, device="cpu",
                                            **kw))


@pytest.fixture
def own_world():
    """Destroys the process group the test makes (test_torch_dist_cases)."""
    with cases.own_world():
        yield


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"use_mesh": True}])
def test_a_mesh_raises_naming_a7(kw, own_world):
    """The mesh keywords, once refused naming ROADMAP A7, now work (the
    test keeps its name): mesh= takes a torch.distributed DeviceMesh and
    raises TypeError for anything else; use_mesh=True meshes every rank of
    the world (here one process, a world of size 1 on gloo), and a run on
    it equals the run without a mesh."""
    if "mesh" in kw:
        for make in _mesh_makers(kw):
            with pytest.raises(TypeError, match="DeviceMesh"):
                make()
        return
    probs = [make() for make in _mesh_makers(kw)]
    for p in probs:
        assert p.mesh.mesh_dim_names == ("scenarios",)
        assert p.mesh.size() == torch.distributed.get_world_size() == 1
    cfg = ForwardSolverConfig1D(N=32, T=0.05)
    sc = sweep_1d(cfg, OptimizationConfig(), **SWEEP)
    out = probs[0].run(sc, max_iter=2, verbose=False)
    ref = BatchedProblem1D(cfg, device="cpu").run(sc, max_iter=2,
                                                  verbose=False)
    np.testing.assert_array_equal(out["cost_history"], ref["cost_history"])
    np.testing.assert_array_equal(out["u"], ref["u"])
