"""Cases of the port's multi-device paths, each run by every rank of a gloo
world on the CPU (tests/test_torch_mesh.py, tests/test_torch_spatial.py);
it holds no test of its own.

This module imports torch, numpy and vch_tpu_torch only: the ranks run it as
processes of their own, and the JAX references stay in the test process.

    python tests/test_torch_dist_cases.py --world W --rank R --store FILE \\
        --out DIR case [case ...]

Each rank joins the world through a FileStore at FILE (collectives time out
after 60 s), runs the cases in order and, on rank 0, writes DIR/<case>.npz;
a case's own files (checkpoints, metrics) go under DIR too. `run_ranks`
starts the W processes and joins them with a deadline; `own_world` destroys
a process group that a test in the pytest process made.
"""
import argparse
import contextlib
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CASES = {}
OUT = None          # the ranks' shared output directory (--out)


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def run_ranks(world, cases, tmp_path, timeout=300.0):
    """Run `cases` in a gloo world of `world` processes; returns {case:
    dict of arrays} from rank 0. Fails (after killing every rank) when a
    rank exits non-zero or the world outlives `timeout` seconds."""
    out = os.path.join(str(tmp_path), f"w{world}")
    os.makedirs(out, exist_ok=True)
    store = os.path.join(out, "store")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        OMP_NUM_THREADS="1")
    logs = [open(os.path.join(out, f"rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--world", str(world),
         "--rank", str(r), "--store", store, "--out", out] + list(cases),
        env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        text = []
        for r, f in enumerate(logs):
            f.seek(0)
            text.append(f"--- rank {r} ---\n" + f.read()[-4000:])
        raise AssertionError(f"ranks {bad} of {world} failed or timed out "
                             f"({timeout} s):\n" + "\n".join(text))
    for f in logs:
        f.close()
    return {c: dict(np.load(os.path.join(out, f"{c}.npz")))
            for c in cases}


@contextlib.contextmanager
def own_world():
    """Destroy on exit the default process group made inside the block, so
    that no later test in the same process finds one."""
    import torch.distributed as dist
    made = not dist.is_initialized()
    try:
        yield
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


# -- helpers ------------------------------------------------------------------

def _mesh(shape=None, names=("scenarios",)):
    from vch_tpu_torch.parallel.mesh import _world_mesh
    import torch.distributed as dist
    return _world_mesh("cpu", shape or (dist.get_world_size(),), names)


def _combined():
    """(world / 2, 2) over ("scenarios", "gx")."""
    import torch.distributed as dist
    w = dist.get_world_size()
    return _mesh((w // 2, 2), ("scenarios", "gx"))


def diversified_sweep_2d(cfg, B, seed0=50):
    """tests/test_spatial_sharding.py's _diversified_sweep_2d through the
    port: distinct ICs, targets and weights per member."""
    from vch_tpu_torch.config import DELTA_SEP
    from vch_tpu_torch.ops.potential import init_phi_random_2d
    from vch_tpu_torch.parallel.batch import sweep_2d
    sc = sweep_2d(cfg, b3_values=[1e-4, 2e-4], kappa_values=[5e-5, 1e-4])
    assert sc.batch == B
    phi0 = np.stack([init_phi_random_2d(cfg.Nx, cfg.Ny, DELTA_SEP, amp=0.1,
                                        seed=seed0 + i) for i in range(B)])
    scale = np.linspace(0.6, 1.4, B)
    return dataclasses.replace(
        sc, phi0=phi0, phi_T=sc.phi_T * scale[:, None, None],
        phi_Q=sc.phi_Q * scale[:, None, None, None],
        b1=sc.b1 * np.linspace(0.5, 2.0, B),
        b2=sc.b2 * np.linspace(1.5, 0.75, B))


def _run_out(out):
    return dict(cost=out["cost_history"], u=out["u"],
                trials=out["ls_trials"], alpha=out["alpha"],
                newton=np.asarray(out["newton_solves"]))


def _is_lead():
    import torch.distributed as dist
    return dist.get_rank() == 0


# -- the grid-sharded solvers (tests/test_torch_spatial.py) -------------------

@case
def laplacian():
    import torch
    from vch_tpu_torch.parallel.spatial import sharded_laplacian_2d
    mesh = _mesh(names=("gx",))
    N = 127
    v = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (N + 1, N + 1)))
    f = sharded_laplacian_2d(mesh, "gx", 1.0 / N, 1.0 / N)
    g = sharded_laplacian_2d(mesh, "gx", 1 / 63, 1 / 63)
    from vch_tpu_torch.parallel.spatial import GridComm
    comm = GridComm(mesh, "gx")
    from vch_tpu_torch.parallel.mesh import all_gather_dim
    lap = all_gather_dim(f(v), comm.group)
    const = all_gather_dim(g(torch.ones(64, 64, dtype=torch.float64)),
                           comm.group)
    return dict(v=v.numpy(), lap=lap.numpy(), const=const.numpy())


def _forward_cfg(T=0.05):
    from vch_tpu_torch.config import ForwardSolverConfig2D
    return ForwardSolverConfig2D(Nx=31, Ny=24, T=T, dt_initial=1e-2)


@case
def forward():
    from vch_tpu_torch.parallel.spatial import GridShardedForward2D
    cfg = _forward_cfg()
    u = 0.05 * np.random.default_rng(0).standard_normal((6, 32, 25))
    gs = GridShardedForward2D(cfg, mesh=_mesh(names=("gx",)))
    phi, _, _ = gs.simulate(control=u)
    gs2 = GridShardedForward2D(_forward_cfg(0.04), mesh=gs.mesh)
    gs2.simulate()
    return dict(u=u, phi=gs.gather(phi).numpy(),
                newton=np.asarray(gs.last_stats.newton_solves),
                newton_default=np.asarray(gs2.last_stats.newton_solves),
                first_bad=np.asarray(gs2.last_stats.first_bad_step),
                counts=np.asarray([gs.comm.counts[k] for k in (
                    "all_reduce", "reduce_scatter", "halo", "p2p")]))


@case
def rows_rejected():
    from vch_tpu_torch.config import ForwardSolverConfig2D
    from vch_tpu_torch.parallel.spatial import GridShardedForward2D
    try:
        GridShardedForward2D(ForwardSolverConfig2D(Nx=30, Ny=30, T=0.05),
                             mesh=_mesh(names=("gx",)))
        raised = ""
    except ValueError as e:
        raised = str(e)
    return dict(raised=np.asarray(raised))


@case
def adjoint():
    from vch_tpu_torch.models.forward2d import ForwardSolver2D
    from vch_tpu_torch.parallel.spatial import GridShardedAdjoint2D
    cfg = _forward_cfg()
    s = ForwardSolver2D(cfg, device="cpu")
    u = 0.05 * np.random.default_rng(0).standard_normal((s.M + 1, 32, 25))
    phi_hist, (x, y), t = s.simulate(control=u)
    phi_hist = phi_hist.numpy()
    phi_T = 0.5 * np.cos(np.pi * x)[:, None] * np.ones(25)[None, :]
    phi_Q = np.zeros_like(phi_hist)
    adj = GridShardedAdjoint2D(cfg, mesh=_mesh(names=("gx",)))
    p, q, r = (adj.gather(a).numpy()
               for a in adj.run(phi_hist, t, 5.0, 10.0, phi_Q, phi_T))
    return dict(phi=phi_hist, t=t, phi_T=phi_T, p=p, q=q, r=r)


@case
def combined():
    import torch
    from vch_tpu_torch.config import DELTA_SEP
    from vch_tpu_torch.ops.potential import init_phi_random_2d
    from vch_tpu_torch.parallel.mesh import BATCH_AXIS, shard_batch
    from vch_tpu_torch.parallel.spatial import (GridShardedAdjoint2D,
                                                GridShardedForward2D)
    cfg = _forward_cfg(0.04)
    B = 4
    mesh = _combined()
    fwd = GridShardedForward2D(cfg, mesh=mesh, batch_axis=BATCH_AXIS)
    adj = GridShardedAdjoint2D(cfg, mesh=mesh, batch_axis=BATCH_AXIS)
    phi0 = np.stack([init_phi_random_2d(cfg.Nx, cfg.Ny, DELTA_SEP, amp=0.1,
                                        seed=50 + i) for i in range(B)])
    t = lambda a: torch.as_tensor(shard_batch(a, mesh))
    u = torch.zeros((B // mesh.size(0), fwd.M + 1,
                     fwd.rows.stop - fwd.rows.start, cfg.Ny + 1),
                    dtype=torch.float64)
    phi, ns, bad = fwd.march(u, fwd.local(t(phi0)))
    b1, b2 = np.linspace(2.0, 8.0, B), np.linspace(12.0, 6.0, B)
    phiT = 0.1 * np.random.default_rng(0).standard_normal(
        (B, cfg.Nx + 1, cfg.Ny + 1))
    _, _, r = adj.run_impl(phi, fwd.dts_np, t(b1), t(b2),
                           torch.zeros_like(phi), fwd.local(t(phiT)))
    from vch_tpu_torch.parallel.mesh import all_gather_dim
    whole = lambda a: all_gather_dim(fwd.gather(a),
                                     mesh.get_group(BATCH_AXIS)).numpy()
    return dict(phi0=phi0, phi=whole(phi), r=whole(r), b1=b1, b2=b2,
                phiT=phiT,
                newton=all_gather_dim(ns, mesh.get_group(BATCH_AXIS)).numpy(),
                bad=all_gather_dim(bad, mesh.get_group(BATCH_AXIS)).numpy())


@case
def resume():
    from vch_tpu_torch.config import ForwardSolverConfig2D
    from vch_tpu_torch.parallel.spatial import GridShardedBatchedProblem2D
    cfg = ForwardSolverConfig2D(Nx=15, Ny=16, T=0.03, dt_initial=1e-2)
    sc = diversified_sweep_2d(cfg, 4)
    mesh = _combined()
    full = GridShardedBatchedProblem2D(cfg, mesh=mesh).run(
        sc, max_iter=3, verbose=False)
    ckpt = os.path.join(OUT, "pgd_gs.npz")
    prob = GridShardedBatchedProblem2D(cfg, mesh=mesh)
    prob.run(sc, max_iter=2, verbose=False, checkpoint_path=ckpt,
             checkpoint_every=2)
    resumed = prob.run(sc, max_iter=3, verbose=False, checkpoint_path=ckpt,
                       resume=True)
    local = prob.run(sc, max_iter=1, verbose=False, host_results=False)
    return dict(u_full=full["u"], u_resumed=resumed["u"],
                cost_full=full["cost_history"],
                cost_resumed=resumed["cost_history"],
                local_shape=np.asarray(local["u"].shape))


@case
def pgd_small():
    """GridShardedProblem2D for 2 iterations at 16 x 17 (the test holds
    it against vch_tpu's ControlProblem2D)."""
    from vch_tpu_torch.config import ForwardSolverConfig2D
    from vch_tpu_torch.parallel.spatial import GridShardedProblem2D
    cfg = ForwardSolverConfig2D(Nx=15, Ny=16, T=0.05, dt_initial=1e-2)
    prob = GridShardedProblem2D(cfg, mesh=_mesh(names=("gx",)))
    res = prob.optimize(max_iter=2, verbose=False)
    d2 = prob.second_order_check(res, num_directions=2)
    return dict(cost=np.asarray(res.cost_history), u=res.u_optimal,
                r=res.r_optimal, trials=np.asarray(res.ls_trials_per_iter),
                alpha=np.asarray(res.alpha_history), d2=np.asarray(d2),
                newton=np.asarray(prob.newton_solves))


@case
def pgd_batched_slow():
    """tests/test_spatial_sharding.py:255 through the port."""
    from vch_tpu_torch.parallel.batch import BatchedProblem2D
    from vch_tpu_torch.parallel.spatial import GridShardedBatchedProblem2D
    cfg = _forward_cfg(0.04)
    sc = diversified_sweep_2d(cfg, 4)
    out = GridShardedBatchedProblem2D(cfg, mesh=_combined()).run(
        sc, max_iter=2, verbose=False)
    ref = (BatchedProblem2D(cfg, device="cpu").run(sc, max_iter=2,
                                                   verbose=False)
           if _is_lead() else out)
    return dict(**_run_out(out), **{k + "_ref": v
                                    for k, v in _run_out(ref).items()})


@case
def pgd_grid_slow():
    """tests/test_spatial_sharding.py:285 through the port."""
    from vch_tpu_torch.config import (ForwardSolverConfig2D,
                                      OptimizationConfig)
    from vch_tpu_torch.parallel.spatial import GridShardedProblem2D
    cfg = ForwardSolverConfig2D(Nx=31, Ny=31, T=0.05, dt_initial=1e-2)
    opt = OptimizationConfig.defaults_2d(alpha_max=400.0)
    prob = GridShardedProblem2D(cfg, opt_config=opt,
                                mesh=_mesh(names=("gx",)))
    prob.loop.s = dataclasses.replace(prob.loop.s, plateau_length=2,
                                      plateau_tolerance=1e-2)
    res = prob.optimize(max_iter=6, verbose=False)
    return dict(cost=np.asarray(res.cost_history), u=res.u_optimal,
                trials=np.asarray(res.ls_trials_per_iter),
                alpha=np.asarray(res.alpha_history),
                boosts=np.asarray(res.plateau_boosts),
                newton=np.asarray(prob.newton_solves))


# -- the scenario mesh (tests/test_torch_mesh.py) -----------------------------

@case
def shard():
    import torch
    from vch_tpu_torch.parallel.batch import shard_fused
    from vch_tpu_torch.parallel.mesh import (BATCH_AXIS, all_gather_dim,
                                             shard_batch)
    mesh = _mesh()
    x = np.arange(8 * 4).reshape(8, 4)
    own = shard_batch((x, None), mesh)[0]
    blocks = all_gather_dim(torch.as_tensor(own)[None],
                            mesh.get_group(BATCH_AXIS)).numpy()
    calls = []

    def fn(a, b):
        calls.append(a.shape[0])
        return a * 2.0, b + 1.0

    sf = shard_fused(fn, mesh, 2, 2)
    even = sf(torch.arange(8.0), torch.ones(8, 3))
    odd = sf(torch.arange(3.0), torch.ones(3, 3))
    return dict(blocks=blocks, even0=even[0].numpy(), even1=even[1].numpy(),
                odd0=odd[0].numpy(), calls=np.asarray(calls))


def _sweep1d(cfg, b3, ks):
    from vch_tpu_torch.config import OptimizationConfig
    from vch_tpu_torch.parallel.batch import sweep_1d
    return sweep_1d(cfg, OptimizationConfig(), b3_values=b3, kappa_values=ks)


@case
def batched_1d():
    from vch_tpu_torch.config import ForwardSolverConfig1D
    from vch_tpu_torch.parallel.batch import BatchedProblem1D
    cfg = ForwardSolverConfig1D(N=64, T=0.2)
    sc = _sweep1d(cfg, [1e-3, 2e-3, 3e-3, 4e-3], [1e-5, 1e-4])
    out = BatchedProblem1D(cfg, device="cpu", mesh=_mesh()).run(
        sc, max_iter=3, verbose=False)
    ref = (BatchedProblem1D(cfg, device="cpu").run(sc, max_iter=3,
                                                   verbose=False)
           if _is_lead() else out)
    return dict(**_run_out(out), **{k + "_ref": v
                                    for k, v in _run_out(ref).items()})


STRAGGLER_ITERS = 4


@case
def straggler():
    """Per-rank straggler buckets (tests/test_parallel.py:157)."""
    from vch_tpu_torch.config import ForwardSolverConfig2D
    from vch_tpu_torch.parallel.batch import BatchedProblem2D, sweep_2d
    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.15)
    mk = lambda: sweep_2d(cfg, b3_values=[5e-5, 1e-4, 2e-4, 4e-4],
                          kappa_values=[5e-5, 1e-4, 1.5e-4, 2e-4, 3e-4,
                                        4e-4])
    mesh = _mesh()
    full = BatchedProblem2D(cfg, alpha_max=2000.0, mesh=mesh,
                            device="cpu").run(mk(), max_iter=STRAGGLER_ITERS,
                                              verbose=False)
    prob = BatchedProblem2D(cfg, alpha_max=2000.0, mesh=mesh,
                            straggler_batch=1, device="cpu")
    sub = prob.run(mk(), max_iter=STRAGGLER_ITERS, verbose=False)
    return dict(**_run_out(sub), **{k + "_full": v
                                    for k, v in _run_out(full).items()},
                rounds=np.asarray(prob.straggler_rounds),
                buckets=np.asarray(prob._straggler_buckets(24)))


def _f32_2d(**kw):
    from vch_tpu_torch.config import ForwardSolverConfig2D
    return ForwardSolverConfig2D(Nx=16, Ny=16, T=0.06, dtype="float32",
                                 newton_tol=2e-4, fused_krylov_fixed_iters=4,
                                 fused_solve_precision="highest", **kw)


def _mesh_and_plain(make, sc, iters):
    mesh_out = make(mesh=_mesh()).run(sc, max_iter=iters, verbose=False)
    plain = (make().run(sc, max_iter=iters, verbose=False) if _is_lead()
             else mesh_out)
    return dict(**_run_out(mesh_out), **{k + "_ref": v
                                         for k, v in _run_out(plain).items()})


@case
def fused_2d():
    from vch_tpu_torch.parallel.batch import BatchedProblem2D, sweep_2d
    cfg = _f32_2d()
    sc = sweep_2d(cfg, b3_values=[1e-4, 2e-4, 3e-4, 4e-4],
                  kappa_values=[1e-5, 1e-4])
    return _mesh_and_plain(lambda **k: BatchedProblem2D(
        cfg, fused_march=True, device="cpu", **k), sc, 2)


@case
def fused_1d():
    from vch_tpu_torch.config import ForwardSolverConfig1D
    from vch_tpu_torch.parallel.batch import BatchedProblem1D
    cfg = ForwardSolverConfig1D(N=64, T=0.2, dtype="float32",
                                newton_tol=2e-4, linsolve_1d="spectral")
    sc = _sweep1d(cfg, [1e-3, 2e-3, 3e-3, 4e-3], [1e-5, 1e-4])
    return _mesh_and_plain(lambda **k: BatchedProblem1D(
        cfg, fused_march=True, device="cpu", **k), sc, 2)


@case
def indivisible():
    from vch_tpu_torch.parallel.batch import BatchedProblem2D, sweep_2d
    cfg = _f32_2d()
    sc = sweep_2d(cfg, b3_values=[1e-4, 2e-4, 3e-4], kappa_values=[1e-4])
    return _mesh_and_plain(lambda **k: BatchedProblem2D(
        cfg, fused_march=True, device="cpu", **k), sc, 1)


@case
def blocked():
    from vch_tpu_torch.parallel.batch import BatchedProblem2D, sweep_2d
    cfg = _f32_2d(fused_march_block=4)
    cfg = dataclasses.replace(cfg, T=0.05)
    sc = sweep_2d(cfg, b3_values=[1e-4, 2e-4, 3e-4, 4e-4],
                  kappa_values=[1e-5, 1e-4])
    return _mesh_and_plain(lambda **k: BatchedProblem2D(
        cfg, fused_march=True, device="cpu", **k), sc, 2)


@case
def lowmem():
    from vch_tpu_torch.config import ForwardSolverConfig2D
    from vch_tpu_torch.parallel.batch import LowMemBatchedProblem2D, sweep_2d
    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.05)
    sc = sweep_2d(cfg, b3_values=[1e-4, 2e-4], kappa_values=[5e-5, 1e-4],
                  materialize_phi_Q=False)
    out = _mesh_and_plain(lambda **k: LowMemBatchedProblem2D(
        cfg, K=2, device="cpu", **k), sc, 2)
    return out


@case
def checkpoint():
    """Checkpoint, resume and metrics under the mesh (the first rank
    writes; every rank resumes from the file)."""
    import json
    from vch_tpu_torch.config import ForwardSolverConfig1D
    from vch_tpu_torch.parallel.batch import BatchedProblem1D
    cfg = ForwardSolverConfig1D(N=48, T=0.2)
    sc = _sweep1d(cfg, [1e-3, 2e-3, 3e-3, 4e-3], [1e-4])
    mesh = _mesh()
    full = BatchedProblem1D(cfg, device="cpu", mesh=mesh).run(
        sc, max_iter=4, verbose=False)
    ck, met = (os.path.join(OUT, n) for n in ("pgd.npz", "m.jsonl"))
    prob = BatchedProblem1D(cfg, device="cpu", mesh=mesh)
    prob.run(sc, max_iter=2, verbose=False, checkpoint_path=ck,
             checkpoint_every=2, metrics_path=met)
    resumed = prob.run(sc, max_iter=4, verbose=False, checkpoint_path=ck,
                       resume=True)
    local = prob.run(sc, max_iter=1, verbose=False, host_results=False)
    lines = open(met).read().splitlines() if _is_lead() else []
    events = [json.loads(ln)["event"] for ln in lines]
    return dict(u_full=full["u"], u_resumed=resumed["u"],
                cost_full=full["cost_history"],
                cost_resumed=resumed["cost_history"],
                events=np.asarray(events),
                local_rows=np.asarray(local["u"].shape[0]))


@case
def factoring():
    """make_batched_problem_2d's automatic combined arm on a 1D mesh when
    one member does not fit the (tiny) limit."""
    from vch_tpu_torch.config import ForwardSolverConfig2D
    from vch_tpu_torch.parallel.batch import make_batched_problem_2d
    from vch_tpu_torch.parallel.spatial import GridShardedBatchedProblem2D
    cfg = ForwardSolverConfig2D(Nx=15, Ny=16, T=0.03, dt_initial=1e-2)
    prob = make_batched_problem_2d(cfg, batch=4, hbm_limit_bytes=150000,
                                   device="cpu", mesh=_mesh())
    return dict(kind=np.asarray(type(prob).__name__),
                shape=np.asarray(tuple(prob.mesh.shape)),
                names=np.asarray(prob.mesh.mesh_dim_names),
                combined=np.asarray(isinstance(
                    prob, GridShardedBatchedProblem2D)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("cases", nargs="+")
    args = ap.parse_args()
    global OUT
    OUT = args.out
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    from vch_tpu_torch.parallel.mesh import initialize_distributed
    if not initialize_distributed("file://" + args.store, args.world,
                                  args.rank, device="cpu", timeout=60):
        raise SystemExit("no process group")
    for name in args.cases:
        t0 = time.perf_counter()
        res = CASES[name]()
        dist.barrier()
        if args.rank == 0:
            np.savez(os.path.join(args.out, f"{name}.npz"), **res)
        print(f"{name} {time.perf_counter() - t0:.1f} s", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
