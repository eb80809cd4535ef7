"""Batched PGD over 1D and 2D scenario sweeps (vch_tpu/parallel/batch.py).

Each member of the scenario batch has its own initial condition, targets and
cost weights (b1, b2, b3, kappa_spar). One PGD iteration runs the whole-batch
adjoint sweep for r, then a host-driven masked optimistic/backtracking line
search: every trial is prox -> whole-batch forward march -> cost, and once
few members are still searching they are gathered into a sub-batch
(`straggler_batch`: a fixed size, or "auto", the smallest power-of-two
bucket >= 8 that holds them), padded with non-searching rows whose results
are discarded (their Newton solves are still counted, as in vch_tpu); or,
with `speculative`, several backtracking candidates per straggler are
packed into one full-batch trial. `chunk_size` runs the adjoint, the trial
and the forward on chunks of the batch. Plateau detection, alpha growth and
convergence freezing follow vch_tpu/parallel/batch.py:922-984. `run` takes
vch_tpu's checkpoint/resume, JSONL metrics and `host_results` (numpy
results by default); `prewarm` pays the kernels' first-launch costs and
`trial_memory_analysis` measures a trial's device memory.

Three problems share that PGD loop (`_BatchedPGDBase`): `BatchedProblem2D`
keeps each member's whole trajectory, `LowMemBatchedProblem2D` keeps K-step
segment checkpoints and recomputes each segment in the adjoint
(`make_batched_problem_2d` picks one of the two by the estimated peak device
memory), and `BatchedProblem1D` runs the 1D family in the reference's history
layout (a duplicated t = 0 row): its forward is the fused 1D march kernel or
the batched per-step marcher, its adjoint the batched per-step sweep. The two
2D problems take the whole-march and whole-sweep kernels, or the scan path
(the batched per-step marcher and sweep), by vch_tpu's rule
(`fused_march_rule`).

With a device mesh (`mesh`, or `use_mesh=True` for every rank of the world;
parallel/mesh.py) the batch is sharded over the "scenarios" ranks of
torch.distributed, one process per device: each rank holds its block of
B/D members and runs the same kernels on it (vch_tpu's `shard_fused`:
members are independent, so there is no collective inside a march or a
sweep). The host schedule is the same on every rank: each (B,) cost,
Newton count and control change is all-gathered before the host reads it.
Under a mesh a numeric or "auto" straggler_batch is a per-rank bucket size
(each rank gathers its own stragglers, the bucket sized by the rank with
the most), and the speculative search and the chunker are off, as in
vch_tpu. A batch the mesh does not divide runs whole on every rank.
Checkpoints and metrics are written by the mesh's first rank; results with
`host_results=True` are the whole batch on every rank, with
`host_results=False` the rank's own block (vch_tpu returns a global sharded
array; ROADMAP C). The combined ("scenarios", "gx") mesh problem is
parallel/spatial.py's GridShardedBatchedProblem2D, which
`make_batched_problem_2d` routes to for a mesh with a grid dimension, or
when one member's low-memory working set does not fit a device.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from vch_tpu_torch.config import (ForwardSolverConfig1D,
                                  ForwardSolverConfig2D, OptimizationConfig,
                                  PGDSettings)
from vch_tpu_torch.control.cost import calculate_cost_1d, calculate_cost_2d
from vch_tpu_torch.control.prox import calculate_gradient, proximal_step
from vch_tpu_torch.control.targets import build_targets_1d, build_targets_2d
from vch_tpu_torch.device import resolve_device, to_numpy
from vch_tpu_torch.models.adjoint1d import AdjointSolver1D
from vch_tpu_torch.models.adjoint2d import AdjointSolver2D
from vch_tpu_torch.models.forward1d import ForwardSolver1D
from vch_tpu_torch.models.forward2d import ForwardSolver2D, fused_kernels_fit
from vch_tpu_torch.models.lowmem import FusedLowMemBatch2D, LowMemPipeline2D
from vch_tpu_torch.models.timegrid import build_dt_schedule
from vch_tpu_torch.parallel.mesh import (BATCH_AXIS, _world_mesh,
                                         all_gather_dim, axis_rank,
                                         axis_size, batch_sharding,
                                         check_mesh, local_block, make_mesh,
                                         place_block, shard_batch)

Array = Union[np.ndarray, torch.Tensor]


@dataclass
class ScenarioBatch:
    """Per-scenario inputs, leading batch axis B (numpy or tensors)."""

    phi0: Array          # (B, *space)
    phi_T: Array         # (B, *space)
    phi_Q: Optional[Array]   # (B, M+1, *space), or None: procedural
    b1: Array            # (B,)
    b2: Array
    b3: Array
    kappa_spar: Array
    u_min: float = -1.0
    u_max: float = 1.0
    # the procedural tracking target when phi_Q is None: "ramp" (the time
    # ramp phi0 -> phi_T, choice_q=1) or "zeros" (choice_q=2), synthesized
    # per segment by the low-memory problem instead of stored
    phi_Q_mode: Optional[str] = None

    @property
    def batch(self) -> int:
        return self.phi0.shape[0]


def _sweep(opt, phi0, phi_T, phi_Q, b3_values, kappa_values, phi_Q_mode=None):
    """The (b3, kappa_spar) grid over one IC and one pair of targets; the
    values a sequence, a numpy array or a tensor on any device."""
    b3s = to_numpy(b3_values if b3_values is not None else [opt.b3])
    kss = to_numpy(kappa_values if kappa_values is not None
                   else [opt.kappa_sparsity])
    g_b3, g_ks = np.meshgrid(b3s, kss, indexing="ij")
    B = g_b3.size
    rep = lambda a: np.broadcast_to(a, (B,) + a.shape).copy()
    return ScenarioBatch(
        phi0=rep(phi0), phi_T=rep(phi_T),
        phi_Q=None if phi_Q is None else rep(phi_Q),
        b1=np.full(B, opt.b1), b2=np.full(B, opt.b2),
        b3=g_b3.ravel(), kappa_spar=g_ks.ravel(),
        u_min=opt.u_min, u_max=opt.u_max, phi_Q_mode=phi_Q_mode)


def sweep_1d(fwd_config: ForwardSolverConfig1D,
             opt_config: Optional[OptimizationConfig] = None,
             b3_values=None, kappa_values=None,
             choice_t: int = 1, choice_q: int = 1) -> ScenarioBatch:
    """(b3, kappa_spar) grid sweep with the default 1D IC and targets, as
    numpy arrays; phi_Q in core layout, M+1 rows
    (vch_tpu/parallel/batch.py:106-128; BASELINE config 2)."""
    opt = opt_config or OptimizationConfig()
    solver = ForwardSolver1D(fwd_config, device="cpu")   # host grids and IC
    phi0 = solver.default_initial_phi()
    phi_T, phi_Q = build_targets_1d(solver.x, solver.t_hist, phi0,
                                    float(fwd_config.Lx), float(fwd_config.T),
                                    choice_t=choice_t, choice_q=choice_q)
    return _sweep(opt, phi0, phi_T, phi_Q, b3_values, kappa_values)


def sweep_2d(fwd_config: ForwardSolverConfig2D,
             opt_config: Optional[OptimizationConfig] = None,
             b3_values=None, kappa_values=None,
             choice_t: int = 1, choice_q: int = 1,
             materialize_phi_Q: bool = True) -> ScenarioBatch:
    """(b3, kappa_spar) grid sweep with the default IC and targets, as
    numpy arrays (vch_tpu/parallel/batch.py:131-162). With
    materialize_phi_Q=False no tracking-target frames are stored: phi_Q is
    None and phi_Q_mode names its closed form."""
    opt = opt_config or OptimizationConfig.defaults_2d()
    solver = ForwardSolver2D(fwd_config, device="cpu")   # host grids and IC
    phi0 = solver.default_initial_phi()
    phi_T, phi_Q = build_targets_2d(solver.x, solver.y, solver.t_hist, phi0,
                                    float(fwd_config.Lx), float(fwd_config.Ly),
                                    float(fwd_config.T),
                                    choice_t=choice_t, choice_q=choice_q)
    if materialize_phi_Q:
        return _sweep(opt, phi0, phi_T, phi_Q, b3_values, kappa_values)
    return _sweep(opt, phi0, phi_T, None, b3_values, kappa_values,
                  phi_Q_mode="ramp" if choice_q == 1 else "zeros")


def straggler_bucket(n_search: int, B: int) -> Optional[int]:
    """Smallest power-of-two sub-batch >= 8 holding n_search members, or
    None when it would not be smaller than the batch."""
    sb = 8
    while sb < n_search:
        sb *= 2
    return sb if sb < B else None


def shard_fused(fn, mesh, n_in: int, n_out: int):
    """A whole-batch call run over the mesh's scenario ranks
    (vch_tpu/parallel/batch.py:55): given the whole batch on every rank,
    each rank runs fn (a fused kernel route) on its own block, with no
    collective inside, and the blocks of the n_out outputs are all-gathered
    so that every rank returns fn(*args). Every argument has a leading batch
    axis or is None. A batch the mesh does not divide runs whole on every
    rank. Each rank's block is cut by the same `place_block` as a batched
    problem's inputs; the problems themselves do not call shard_fused:
    their run() places each rank's block once and keeps the results
    rank-local, so a march or a sweep is the same per-rank launch without
    the gathers (ROADMAP C)."""
    check_mesh(mesh)
    group = mesh.get_group(BATCH_AXIS)

    def call(*args):
        if len(args) != n_in:
            raise TypeError(f"expected {n_in} arguments, got {len(args)}")
        if args[0].shape[0] % axis_size(mesh, BATCH_AXIS):
            return fn(*args)
        out = fn(*shard_batch(list(args), mesh))
        outs = (out,) if n_out == 1 else tuple(out)
        outs = tuple(_tmap(lambda t: all_gather_dim(t, group), o)
                     for o in outs)
        return outs[0] if n_out == 1 else outs

    return call


def _mesh_for(mesh, use_mesh: bool, device):
    """A batched problem's mesh: `mesh`, else with use_mesh one over every
    rank of the world (make_mesh), made before any tensor is placed: making
    the process group selects this rank's card (LOCAL_RANK)."""
    if mesh is None and use_mesh:
        mesh = make_mesh(device=device)
    return mesh


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (like.ndim - 1))


def _tmap(fn, *trees):
    """fn over matching tensors of None, a tensor, or a NamedTuple of
    tensors (the low-memory problem's state)."""
    if trees[0] is None:
        return None
    if isinstance(trees[0], tuple):
        return type(trees[0])(*[fn(*ts) for ts in zip(*trees)])
    return fn(*trees)


def _gather(it: torch.Tensor, *trees) -> list:
    """The rows `it` (indices may repeat) of each tree's tensors."""
    return [_tmap(lambda x: x.index_select(0, it), a) for a in trees]


def _scatter(res: tuple, sub: tuple, it: torch.Tensor, take: torch.Tensor):
    """`res` with its rows `it` (no index repeated) set to the rows of `sub`
    where take (len(it),), and left as they are elsewhere."""
    put = lambda full, s: full.index_copy(
        0, it, torch.where(_bcast(take, s), s, full.index_select(0, it)))
    return tuple(_tmap(put, f, s) for f, s in zip(res, sub))


def _leaves(tree):
    """The tensors of a (nested) tuple / NamedTuple of tensors and None."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [t for sub in tree for t in _leaves(sub)]
    return [tree]


def _cat(outs):
    """Concatenate along dim 0 the matching leaves of a list of results (a
    tensor, None, or a tuple / NamedTuple of them)."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        parts = [_cat([o[i] for o in outs]) for i in range(len(first))]
        return (type(first)(*parts) if hasattr(first, "_fields")
                else tuple(parts))
    return torch.cat(outs, dim=0)


def _torch_dtype(dtype) -> Optional[torch.dtype]:
    """None, a torch dtype, or a numpy dtype or its name, as a torch dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _BatchedPGDBase:
    """The batched PGD loop on one device: `run`, the masked `_search`, the
    speculative `_search_speculative`, the chunker, `prewarm` and
    `trial_memory_analysis` (vch_tpu/parallel/batch.py:_BatchedPGDBase).
    A subclass sets `solver` (its forward solver) and `_use_fused_march`
    before calling __init__ with its PGD settings and the shape of one
    member's control, and supplies the hooks
      _forward_stats(u, phi0, phi_Q, phi_T) -> (phi, newton_solves (B,)),
      _adjoint(phi, u, b1, b2, phi_Q, phi_T) -> r (B, M+1, ...),
      _cost(phi, u, phi_Q, phi_T, b1, b2, b3, ks) -> (B,),
    where phi is whatever the subclass's forward keeps per member: a tensor
    or a NamedTuple of tensors, each with a leading batch axis.

    straggler_batch (vch_tpu :188-204): None runs every trial on the whole
    batch; an int sb gathers the still-searching members, padded with
    non-searching rows to exactly sb, into a sub-batch trial once
    0 < searching <= sb < B; "auto" takes the smallest power-of-two bucket
    (>= 8, < B) that holds them each round, and is the default where the
    fused route is on. speculative (:206-214) packs several backtracking
    candidates per straggler into one full-batch trial
    (`_search_speculative`). chunk_size (:176-187) runs the adjoint, the
    trial and the forward on chunk_size members per call where it divides
    the batch. The counters straggler_rounds, speculative_rounds and
    chunk_calls count sub-batch rounds, packed rounds and chunked calls.

    mesh (a DeviceMesh with a "scenarios" dimension; a subclass's
    use_mesh=True makes one over every rank of the world, `_mesh_for`)
    shards the batch over the ranks (vch_tpu :168-175; see the module
    docstring); its device type must be the problem's device."""

    _requires_divisible_batch = False

    def __init__(self, settings: PGDSettings, alpha_max: float,
                 control_shape: tuple, straggler_batch=None,
                 speculative: Optional[bool] = None,
                 chunk_size: Optional[int] = None, mesh=None):
        self.device = self.solver.dts.device
        self.dtype = self.solver.dtype
        self.mesh = None if mesh is None else check_mesh(mesh)
        if mesh is not None:
            if BATCH_AXIS not in mesh.mesh_dim_names:
                raise ValueError(f"the mesh has no '{BATCH_AXIS}' dimension: "
                                 f"{mesh.mesh_dim_names}")
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh for a problem "
                                 f"on {self.device}")
        self._shard = None     # this rank's members in the current run
        self.s = settings
        self.alpha_max = alpha_max
        self._control_shape = tuple(control_shape)
        self._local_control_shape = self._control_shape
        self.chunk_size = chunk_size
        self.chunk_calls = 0
        if straggler_batch is None and self._use_fused_march:
            straggler_batch = "auto"
        self.straggler_batch = straggler_batch or None
        self.straggler_rounds = 0
        self.speculative = bool(speculative)
        self.speculative_rounds = 0

    def _set_phi_Q_mode(self, mode: Optional[str]):
        """Procedural tracking targets (ScenarioBatch.phi_Q None) need a
        problem that synthesizes them; this one needs phi_Q stored."""
        raise ValueError(
            "ScenarioBatch.phi_Q=None (procedural targets) is supported by "
            "LowMemBatchedProblem2D only; pass a materialized phi_Q here")

    # -- the mesh (vch_tpu :373-391) ------------------------------------
    def _batch_shards(self) -> int:
        """The ranks along the scenario axis (1 without a mesh)."""
        return 1 if self.mesh is None else axis_size(self.mesh, BATCH_AXIS)

    def _shard_of(self, B: int) -> Optional[slice]:
        """This rank's members of a batch of B, or None where the batch is
        not sharded (no mesh, or a batch the mesh does not divide, which then
        runs whole on every rank; raises for a problem that needs it
        divided)."""
        if self.mesh is None:
            return None
        D = self._batch_shards()
        if B % D:
            if self._requires_divisible_batch:
                raise ValueError(
                    f"batch {B} is not divisible by the mesh's scenario-axis "
                    f"size {D}; the combined (scenarios, gx) mesh programs "
                    f"have no unsharded fallback — pad or trim the sweep")
            return None
        return local_block(B, D, axis_rank(self.mesh, BATCH_AXIS))

    def _input_sharding(self, a):
        """The placements of a batch-leading input on the mesh, one per
        mesh dimension (vch_tpu :388-391)."""
        return batch_sharding(self.mesh)

    def _place(self, a):
        """This rank's block of a batch-leading input of the current run,
        by its placements (the whole input where the run is not sharded)."""
        if a is None or self._shard is None:
            return a
        return place_block(a, self.mesh, self._input_sharding(a))

    def _host_read(self, t: torch.Tensor) -> np.ndarray:
        """A per-member device result as a host array over the whole batch:
        all-gathered over the scenario ranks in a sharded run, so that every
        rank drives the same host schedule (vch_tpu :40-52)."""
        if self._shard is not None:
            t = all_gather_dim(t, self.mesh.get_group(BATCH_AXIS))
        return t.cpu().numpy()

    def _gather_full(self, t: torch.Tensor) -> torch.Tensor:
        """The whole batch of a rank-local result (itself where the run is
        not sharded)."""
        if self._shard is None:
            return t
        return all_gather_dim(t, self.mesh.get_group(BATCH_AXIS))

    def _local_batch(self, B: int) -> int:
        """This rank's member count in the current run."""
        sh = self._shard
        return B if sh is None else sh.stop - sh.start

    def _lead(self) -> bool:
        """Whether this rank writes the run's files and lines: the mesh's
        first rank, or the only process."""
        return (self.mesh is None
                or dist.get_rank() == int(self.mesh.mesh.flatten()[0]))

    def _barrier(self):
        """Wait for every rank of the mesh (one barrier per dimension)."""
        if self.mesh is not None:
            for ax in self.mesh.mesh_dim_names:
                dist.barrier(group=self.mesh.get_group(ax))

    def _chunked(self, fn, *args):
        """fn(*args) on chunk_size members per call, the results
        concatenated along the batch axis (vch_tpu :255-275): every
        argument leaf whose leading axis is the batch is sliced. The plain
        call where chunking is off, chunk_size >= B or B % chunk_size."""
        c = self.chunk_size
        B = next(t.shape[0] for t in _leaves(args) if t.ndim > 0)
        if not c or c >= B or B % c or self.mesh is not None:
            return fn(*args)
        outs = []
        for i in range(0, B, c):
            sl = lambda t: (t[i:i + c] if t.ndim > 0 and t.shape[0] == B
                            else t)
            outs.append(fn(*[_tmap(sl, a) for a in args]))
            self.chunk_calls += 1
        return _cat(outs)

    def _forward_v(self, u, phi0, phi_Q, phi_T):
        return self._chunked(self._forward_stats, u, phi0, phi_Q, phi_T)

    def _adjoint_v(self, phi, u, b1, b2, phi_Q, phi_T):
        return self._chunked(self._adjoint, phi, u, b1, b2, phi_Q, phi_T)

    def _trial(self, u, r, alpha, phi0, phi_Q, phi_T, b1, b2, b3, ks):
        """prox -> forward march -> cost for a (sub-)batch; returns
        (u_t, phi_t, cost, newton_solves (B,))."""
        grad = calculate_gradient(r, u, _bcast(b3, u))
        u_t = proximal_step(u, grad, _bcast(alpha, u), _bcast(ks, u),
                            self.u_min, self.u_max)
        phi_t, nsolve = self._forward_stats(u_t, phi0, phi_Q, phi_T)
        c_t = self._cost(phi_t, u_t, phi_Q, phi_T, b1, b2, b3, ks)
        return u_t, phi_t, c_t, nsolve

    def _trial_v(self, *args):
        return self._chunked(self._trial, *args)

    @staticmethod
    def _merge(take: torch.Tensor, new, old):
        """Per member, `new` where take (B,) else `old`."""
        pick = lambda a, b: torch.where(_bcast(take, a), a, b)
        return tuple(_tmap(pick, n, o) for n, o in zip(new, old))

    def _change(self, u1, u):
        """Each member's relative control change."""
        dims = tuple(range(1, u.ndim))
        num = torch.sqrt(torch.sum((u1 - u) ** 2, dim=dims))
        den = torch.sqrt(torch.sum(u ** 2, dim=dims)) + 1e-9
        return num / den

    def _search(self, u, cost_np, alpha_prev_np, r, phi0, phi_Q, phi_T,
                b1, b2, b3, ks, dtype):
        """Masked host-driven optimistic + backtracking search
        (vch_tpu/parallel/batch.py:401-546): alpha_prev first, then
        alpha_prev * ls_alpha_factor * ls_beta^(j-1); a member that fails
        every trial keeps its last (worse) iterate, alpha already times
        beta. Backtracking rounds with few members still searching run on a
        gathered sub-batch (`straggler_batch`), padded with non-searching
        rows whose results are discarded (their Newton solves are still
        counted, as in vch_tpu); in a sharded run each rank gathers its own
        stragglers into a bucket sized by the rank with the most (vch_tpu
        :437-450, :467-494). The host arrays are over the whole batch; the
        tensors are this rank's members."""
        s = self.s
        B = cost_np.shape[0]
        max_trials = 1 + s.ls_max_trials
        searching = np.ones(B, dtype=bool)
        alpha_try = alpha_prev_np.copy()
        n_trials = np.zeros(B, dtype=int)
        opt_ok = np.zeros(B, dtype=bool)
        res = None
        res_alpha = alpha_prev_np.copy()
        solves = 0
        phase = {"optimistic": 0.0, "backtracking": 0.0}
        dev = self.device
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        mine = self._place        # this rank's part of a (B,) host array
        sb = self.straggler_batch
        # compaction in D blocks of B/D members: one block without a mesh,
        # a block per rank on a 1D scenario mesh in a sharded run; none on
        # the combined mesh or in a mesh run the batch does not divide
        # (vch_tpu :334, :426-430)
        D = 0
        if sb is not None and self.mesh is None:
            D = 1
        elif (sb is not None and self._shard is not None
              and len(self.mesh.mesh_dim_names) == 1):
            D = self._batch_shards()
        rk = 0 if self.mesh is None else axis_rank(self.mesh, BATCH_AXIS)
        for j in range(max_trials):
            t_j = time.perf_counter()
            n_search = int(searching.sum())
            last = j == max_trials - 1
            nxt = np.where(j == 0, alpha_prev_np * s.ls_alpha_factor,
                           alpha_try * s.ls_beta)
            sb_loc = None
            if D > 0 and j > 0 and res is not None and n_search > 0:
                B_local = B // D
                s2 = searching.reshape(D, B_local)
                counts = int(s2.sum(axis=1).max())
                sb_loc = (straggler_bucket(counts, B_local) if sb == "auto"
                          else (sb if counts <= sb < B_local else None))
            if sb_loc is not None:
                self.straggler_rounds += 1
                # each block's stragglers by local index, padded with its
                # own non-searching rows (their writes are masked off); no
                # index repeats
                blocks = []
                for dv in range(D):
                    loc_s = np.nonzero(s2[dv])[0]
                    loc_ns = np.nonzero(~s2[dv])[0][: sb_loc - loc_s.size]
                    blocks.append(np.concatenate([loc_s, loc_ns]))
                idx = np.concatenate([dv * B_local + b
                                      for dv, b in enumerate(blocks)])
                own = rk * B_local + blocks[rk]
                it = torch.as_tensor(blocks[rk], device=dev)
                u_t, phi_t, c_t, ns = self._trial_v(
                    *_gather(it, u, r), as_t(alpha_try[own]),
                    *_gather(it, phi0, phi_Q, phi_T, b1, b2, b3, ks))
                solves += int(self._host_read(ns).sum())
                c_sub = self._host_read(c_t)    # rank order = idx's order
                ok = np.zeros(B, dtype=bool)
                ok[idx] = c_sub < cost_np[idx]
                take = searching & (ok | last)
                res = _scatter(res, (u_t, phi_t, c_t), it, torch.as_tensor(
                    take[own], device=dev))
            else:
                u_t, phi_t, c_t, ns = self._trial_v(
                    u, r, as_t(mine(alpha_try)), phi0, phi_Q, phi_T, b1, b2,
                    b3, ks)
                solves += int(self._host_read(ns).sum())
                c_np = self._host_read(c_t)
                ok = c_np < cost_np
                take = searching & (ok | last)
                if res is None:
                    res = (u_t, phi_t, c_t)
                else:
                    tk = torch.as_tensor(mine(take), device=dev)
                    res = self._merge(tk, (u_t, phi_t, c_t), res)
            res_alpha = np.where(take, np.where(ok, alpha_try, nxt), res_alpha)
            n_trials = np.where(searching, j + 1, n_trials)
            if j == 0:
                opt_ok = ok.copy()
            phase["optimistic" if j == 0 else "backtracking"] += (
                time.perf_counter() - t_j)
            searching = searching & ~ok
            if not searching.any():
                break
            alpha_try = np.where(searching, nxt, alpha_try)
        u1, phi1, c1 = res
        return (u1, phi1, self._host_read(c1), res_alpha, n_trials, opt_ok,
                solves, phase)

    def _search_speculative(self, u, cost_np, alpha_prev_np, r, phi0, phi_Q,
                            phi_T, b1, b2, b3, ks, dtype):
        """The same trial sequence as `_search`, the backtracking ladder
        evaluated speculatively (vch_tpu/parallel/batch.py:548-684): once
        <= B/2 members are still searching, one full-batch trial packs
        several ladder candidates alpha_prev * f * beta^(t-1) per straggler
        (round-robin over the B rows; the gather repeats members), and each
        member keeps its first succeeding candidate, which is what the
        sequential schedule would have selected. Only the taken rows are
        written back, so the scatter repeats no index."""
        s = self.s
        B = cost_np.shape[0]
        max_trials = 1 + s.ls_max_trials
        phase = {"optimistic": 0.0, "backtracking": 0.0}
        dev = self.device
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)

        # round 0: the optimistic trial at alpha_prev for every member
        t_j = time.perf_counter()
        u_t, phi_t, c_t, ns = self._trial_v(u, r, as_t(alpha_prev_np), phi0,
                                            phi_Q, phi_T, b1, b2, b3, ks)
        solves = int(ns.sum())
        ok = c_t.cpu().numpy() < cost_np
        res = (u_t, phi_t, c_t)
        opt_ok = ok.copy()
        phase["optimistic"] += time.perf_counter() - t_j

        searching = ~ok
        pos = np.ones(B, dtype=int)          # ladder trials consumed so far
        n_trials = np.ones(B, dtype=int)
        res_alpha = np.where(ok, alpha_prev_np,
                             alpha_prev_np * s.ls_alpha_factor)
        lead = alpha_prev_np * s.ls_alpha_factor     # ladder head per member
        ladder = lambda m, t: lead[m] * s.ls_beta ** (t - 1)

        while searching.any():
            t_j = time.perf_counter()
            idx_s = np.nonzero(searching)[0]
            n_s = idx_s.size
            if n_s > B // 2:
                # too many stragglers to pack >= 2 candidates each: a plain
                # full-batch masked round, one ladder step per member
                alpha_try = np.where(searching, ladder(np.arange(B), pos),
                                     res_alpha)
                u_t, phi_t, c_t, ns = self._trial_v(
                    u, r, as_t(alpha_try), phi0, phi_Q, phi_T, b1, b2, b3, ks)
                solves += int(ns.sum())
                ok_full = (c_t.cpu().numpy() < cost_np) & searching
                pos_new = pos + searching
                fail_out = searching & ~ok_full & (pos_new >= max_trials)
                take = ok_full | fail_out
                res = self._merge(torch.as_tensor(take, device=dev),
                                  (u_t, phi_t, c_t), res)
                res_alpha = np.where(
                    ok_full, alpha_try,
                    np.where(fail_out, alpha_try * s.ls_beta, res_alpha))
                n_trials = np.where(take, pos_new, n_trials)
                pos = pos_new
                searching = searching & ~take
                phase["backtracking"] += time.perf_counter() - t_j
                continue

            # packing: the B rows of one trial round-robin over the
            # stragglers' remaining ladders, padded with an idle member
            self.speculative_rounds += 1
            rem = max_trials - pos[idx_s]
            base, extra = divmod(B, n_s)
            counts = np.minimum(base + (np.arange(n_s) < extra), rem)
            rows_m = np.repeat(idx_s, counts)
            rows_t = np.concatenate(
                [pos[m] + np.arange(c) for m, c in zip(idx_s, counts)])
            n_rows = rows_m.size
            h = int(np.nonzero(~searching)[0][0])
            if n_rows < B:
                rows_m = np.concatenate(
                    [rows_m, np.full(B - n_rows, h, dtype=int)])
                rows_t = np.concatenate(
                    [rows_t, np.ones(B - n_rows, dtype=int)])
            alpha_rows = ladder(rows_m, rows_t)
            it = torch.as_tensor(rows_m, device=dev)
            u_t, phi_t, c_t, ns = self._trial_v(
                *_gather(it, u, r), as_t(alpha_rows),
                *_gather(it, phi0, phi_Q, phi_T, b1, b2, b3, ks))
            solves += int(ns.sum())
            ok_rows = c_t.cpu().numpy() < cost_np[rows_m]

            # per straggler: the first succeeding candidate in ladder order
            # (rows_t ascends by construction), or, once its ladder is used
            # up, its last (worse) candidate with alpha shrunk once more
            rows, tgt = [], []
            still = searching.copy()
            for m in idx_s:
                rows_i = np.nonzero(rows_m[:n_rows] == m)[0]
                hits = rows_i[ok_rows[rows_i]]
                if hits.size:
                    w = int(hits[0])
                    res_alpha[m] = alpha_rows[w]
                    n_trials[m] = rows_t[w] + 1
                else:
                    pos[m] += rows_i.size
                    if pos[m] < max_trials:
                        continue
                    w = int(rows_i[-1])
                    res_alpha[m] = alpha_rows[w] * s.ls_beta
                    n_trials[m] = max_trials
                rows.append(w)
                tgt.append(m)
                still[m] = False
            if rows:
                src = torch.as_tensor(rows, device=dev)
                dst = torch.as_tensor(tgt, device=dev)
                put = lambda full, sub: full.index_copy(
                    0, dst, sub.index_select(0, src))
                res = tuple(_tmap(put, full, sub)
                            for full, sub in zip(res, (u_t, phi_t, c_t)))
            searching = still
            phase["backtracking"] += time.perf_counter() - t_j

        u1, phi1, c1 = res
        return (u1, phi1, c1.cpu().numpy(), res_alpha, n_trials, opt_ok,
                solves, phase)

    def _straggler_buckets(self, B: int) -> list:
        """The sub-batch sizes (whole-batch counts) the masked search can
        gather into (vch_tpu :686-715): under a 1D scenario mesh, per-rank
        buckets times the rank count (none if the batch does not divide);
        none on the combined mesh."""
        sb = self.straggler_batch
        if sb is None:
            return []
        D = self._batch_shards()
        if self.mesh is not None and (len(self.mesh.mesh_dim_names) != 1
                                      or B % D):
            return []
        B //= D
        if sb == "auto":
            out, c = [], 8
            while c < B:
                out.append(c * D)
                c *= 2
            return out
        return [sb * D] if 0 < sb < B else []

    def _inputs(self, scenarios: ScenarioBatch, dtype):
        """This rank's block of the scenario batch (the whole batch where
        the run is not sharded: set self._shard first) on the problem's
        device in `dtype`: (phi0, phi_Q, phi_T, b1, b2, b3, ks); sets the
        prox bounds and a procedural phi_Q's mode."""
        as_t = lambda a: (None if a is None else torch.as_tensor(
            self._place(a), dtype=dtype, device=self.device))
        if scenarios.phi_Q is None:
            self._set_phi_Q_mode(scenarios.phi_Q_mode)
        self.u_min, self.u_max = scenarios.u_min, scenarios.u_max
        return tuple(as_t(a) for a in (
            scenarios.phi0, scenarios.phi_Q, scenarios.phi_T, scenarios.b1,
            scenarios.b2, scenarios.b3, scenarios.kappa_spar))

    def trial_memory_analysis(self, scenarios: ScenarioBatch, dtype=None):
        """Device memory of one full-batch line-search trial (u and r of
        zeros, alpha 1), the run's peak-memory step (vch_tpu :717-746).

        vch_tpu reads XLA's compile-time buffer assignment; eager PyTorch
        has none, so on a CUDA device this runs the trial and reads the
        allocator: peak_memory_in_bytes is the peak allocated during the
        trial less what was allocated before its arguments were made,
        argument_size_in_bytes and output_size_in_bytes the bytes of the
        trial's argument and output tensors, temp_size_in_bytes the rest of
        the peak, alias_size_in_bytes and generated_code_size_in_bytes 0.
        On a CPU device it returns None, vch_tpu's answer for a backend
        with no analysis: PyTorch keeps no allocator statistics for host
        memory."""
        if self.device.type != "cuda":
            return None
        dev = self.device
        dtype = _torch_dtype(dtype) or self.dtype
        self._shard = self._shard_of(scenarios.batch)
        B = self._local_batch(scenarios.batch)
        _sync(dev)
        base = torch.cuda.memory_allocated(dev)
        phi0, phi_Q, phi_T, b1, b2, b3, ks = self._inputs(scenarios, dtype)
        u = torch.zeros((B,) + self._local_control_shape, dtype=dtype,
                        device=dev)
        args = (u, torch.zeros_like(u), torch.ones(B, dtype=dtype, device=dev),
                phi0, phi_Q, phi_T, b1, b2, b3, ks)
        torch.cuda.reset_peak_memory_stats(dev)
        out = self._trial_v(*args)
        _sync(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
        nbytes = lambda tree: sum(t.numel() * t.element_size()
                                  for t in _leaves(tree))
        arg_b, out_b = nbytes(args), nbytes(out)
        return {"peak_memory_in_bytes": int(peak),
                "argument_size_in_bytes": int(arg_b),
                "output_size_in_bytes": int(out_b),
                "temp_size_in_bytes": int(max(peak - arg_b - out_b, 0)),
                "alias_size_in_bytes": 0,
                "generated_code_size_in_bytes": 0}

    def prewarm(self, scenarios: ScenarioBatch, dtype=None):
        """Pay the first-launch costs before a timed run (vch_tpu
        :748-817): the kernel library's build and load (`ops/_build.load`,
        nvcc on a fresh checkout), then one throwaway full-batch trial and
        masked merge and, at each size of `_straggler_buckets`, one gather
        -> sub-batch trial -> masked scatter, so that each kernel's first
        launch (its shared-memory attributes) falls here too. Nothing when
        no bucket applies, as in vch_tpu, and nothing on a CPU device,
        where the plain versions have nothing to build."""
        buckets = self._straggler_buckets(scenarios.batch)
        if not buckets or self.device.type != "cuda":
            return
        from vch_tpu_torch.ops import _build
        _build.load()
        dev = self.device
        dtype = _torch_dtype(dtype) or self.dtype
        self._shard = self._shard_of(scenarios.batch)
        B = self._local_batch(scenarios.batch)
        D = scenarios.batch // B        # per-rank buckets under a mesh
        phi0, phi_Q, phi_T, b1, b2, b3, ks = self._inputs(scenarios, dtype)
        u = torch.zeros((B,) + self._local_control_shape, dtype=dtype,
                        device=dev)
        r = torch.zeros_like(u)
        ones = lambda n: torch.ones(n, dtype=dtype, device=dev)
        res = self._trial_v(u, r, ones(B), phi0, phi_Q, phi_T, b1, b2, b3,
                            ks)[:3]
        res = self._merge(torch.zeros(B, dtype=torch.bool, device=dev),
                          res, res)
        for bsz in buckets:
            bsz //= D
            it = torch.arange(bsz, device=dev)
            out = self._trial_v(*_gather(it, u, r), ones(bsz),
                                *_gather(it, phi0, phi_Q, phi_T, b1, b2, b3,
                                         ks))
            res = _scatter(res, out[:3], it, torch.zeros(
                bsz, dtype=torch.bool, device=dev))
        _sync(dev)

    def run(self, scenarios: ScenarioBatch, max_iter: int,
            verbose: bool = True, dtype=None,
            checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 0, resume: bool = False,
            metrics_path: Optional[str] = None,
            host_results: bool = True):
        """Vectorized PGD over the batch (vch_tpu/parallel/batch.py:819-1006).

        dtype: the inputs' dtype (None: the problem's). checkpoint_path with
        checkpoint_every writes the optimizer state (u, alpha, plateau,
        converged, iters_to_converge, cost_history; meta `iteration`) every
        checkpoint_every iterations (utils/checkpoint.py, vch_tpu's file
        layout); resume=True restarts from it, recomputing phi from u with
        one forward solve, whose Newton solves are counted. metrics_path:
        one JSON line per iteration (`pgd_iter`) and a `run_done` line
        (utils/metrics.py).

        Returns a dict: u, r, phi (host numpy arrays, phi tree-mapped where
        it is a NamedTuple; with host_results=False tensors on the
        problem's device), cost_history (iterations+1, B), alpha,
        converged, iterations, newton_solves (forward Newton linear solves,
        padding and packed rows included), timers (backward / optimistic /
        backtracking split), advisor_alpha and ls_trials.

        Under a mesh every rank calls run with the whole ScenarioBatch and
        runs its own members (a batch the mesh does not divide runs whole on
        every rank); the cost history and counters are the whole batch's on
        every rank, u, r and phi too with host_results (else this rank's
        block), the checkpoint and metrics files are written by the mesh's
        first rank, and a resume reads the file on every rank."""
        from vch_tpu_torch.utils.checkpoint import (host_numpy,
                                                    load_checkpoint,
                                                    save_checkpoint)
        from vch_tpu_torch.utils.metrics import MetricsLogger
        dev = self.device
        dtype = _torch_dtype(dtype) or self.dtype
        B = scenarios.batch
        self._shard = self._shard_of(B)
        lead = self._lead()
        metrics = (MetricsLogger(metrics_path) if metrics_path and lead
                   else None)
        phi0, phi_Q, phi_T, b1, b2, b3, ks = self._inputs(scenarios, dtype)

        timers = {"total_optimization": 0.0, "backward_total": 0.0,
                  "line_search_total": 0.0, "optimistic_eval_total": 0.0,
                  "backtracking_total": 0.0}
        t_run0 = time.perf_counter()
        k_start = 0
        if resume and checkpoint_path:
            # every rank reads the file and takes its own members
            state, meta = load_checkpoint(checkpoint_path)
            u = torch.as_tensor(self._place(state["u"]), dtype=dtype,
                                device=dev)
            phi, ns0 = self._forward_v(u, phi0, phi_Q, phi_T)
            alpha = state["alpha"]
            plateau = state["plateau"].astype(int)
            converged = state["converged"].astype(bool)
            iters_to_converge = state["iters_to_converge"].astype(int)
            cost_hist = list(state["cost_history"])
            k_start = int(meta["iteration"])
            if verbose and lead:
                print(f"[resume] from {checkpoint_path} at iter {k_start}")
        else:
            u = torch.zeros((self._local_batch(B),)
                            + self._local_control_shape, dtype=dtype,
                            device=dev)
            phi, ns0 = self._forward_v(u, phi0, phi_Q, phi_T)
            cost = self._cost(phi, u, phi_Q, phi_T, b1, b2, b3, ks)
            alpha = np.full((B,), self.alpha_max)
            cost_hist = [self._host_read(cost)]
            plateau = np.zeros(B, dtype=int)
            converged = np.zeros(B, dtype=bool)
            iters_to_converge = np.full(B, max_iter, dtype=int)
        newton_solves = int(self._host_read(ns0).sum())
        s = self.s
        advisor_sum = np.zeros(B)
        advisor_cnt = np.zeros(B, dtype=int)
        ls_trials = np.zeros(B, dtype=int)
        # the speculative search gathers across the batch axis: off under a
        # mesh (vch_tpu :930-933)
        search = (self._search_speculative
                  if self.speculative and self.mesh is None else self._search)
        r = None

        for k in range(k_start, max_iter):
            t0 = time.perf_counter()
            r = self._adjoint_v(phi, u, b1, b2, phi_Q, phi_T)
            _sync(dev)
            timers["backward_total"] += time.perf_counter() - t0
            alpha_prev = alpha.copy()
            u_prev = u
            u, phi, c_np, a_np, n_trials, opt_ok, solves, phase = search(
                u, cost_hist[-1], alpha, r, phi0, phi_Q, phi_T,
                b1, b2, b3, ks, dtype)
            timers["line_search_total"] += phase["backtracking"]
            timers["optimistic_eval_total"] += phase["optimistic"]
            timers["backtracking_total"] += phase["backtracking"]
            newton_solves += solves
            ls_trials += np.asarray(n_trials, dtype=int)
            ch_np = self._host_read(self._change(u, u_prev))

            if k >= s.advisor_start_iter:
                advisor_sum += np.where(opt_ok, alpha_prev, 0.0)
                advisor_cnt += opt_ok.astype(int)

            flat = np.abs(c_np - cost_hist[-1]) < s.plateau_tolerance
            plateau = np.where(flat, plateau + 1, 0)
            boost = plateau >= s.plateau_length
            a_next = np.where(boost, a_np * s.plateau_boost, a_np * 1.2)
            plateau = np.where(boost, 0, plateau)
            alpha = np.minimum(self.alpha_max, a_next)

            newly = (~converged) & (ch_np < s.conv_tol) & (k > s.conv_min_iter)
            iters_to_converge[newly] = k + 1
            converged |= newly
            cost_hist.append(c_np)
            if verbose and lead:
                print(f"iter {k+1:4d} | mean cost {c_np.mean():.6f} | "
                      f"converged {converged.sum()}/{B} | "
                      f"max trials {int(np.asarray(n_trials).max())}")
            if metrics:
                metrics.log("pgd_iter", k=k + 1, mean_cost=float(c_np.mean()),
                            max_cost=float(c_np.max()),
                            converged=int(converged.sum()),
                            max_trials=int(np.asarray(n_trials).max()),
                            newton_solves=newton_solves,
                            mean_alpha=float(np.mean(a_np)))
            if (checkpoint_path and checkpoint_every
                    and (k + 1) % checkpoint_every == 0):
                # the whole batch's u (a collective), written by one rank
                u_all = self._gather_full(u)
                if lead:
                    save_checkpoint(
                        checkpoint_path,
                        {"u": u_all, "alpha": alpha, "plateau": plateau,
                         "converged": converged,
                         "iters_to_converge": iters_to_converge,
                         "cost_history": np.stack(cost_hist)},
                        {"iteration": k + 1})
                del u_all
                self._barrier()
            if converged.all():
                break

        if r is None:
            # the loop never ran (max_iter 0, or a resume at max_iter)
            r = self._adjoint_v(phi, u, b1, b2, phi_Q, phi_T)
        _sync(dev)
        timers["total_optimization"] = time.perf_counter() - t_run0
        advisor_alpha = np.where(advisor_cnt > 0,
                                 advisor_sum / np.maximum(advisor_cnt, 1),
                                 np.nan)
        if metrics:
            metrics.log("run_done", timers=timers,
                        newton_solves=newton_solves)
        # host_results: the whole batch on every rank; else this rank's own
        # members (vch_tpu returns a global sharded array; ROADMAP C)
        out = ((lambda a: host_numpy(self._gather_full(a))) if host_results
               else (lambda a: a))
        return {
            "u": out(u), "r": out(r), "phi": _tmap(out, phi),
            "cost_history": np.stack(cost_hist), "alpha": np.asarray(alpha),
            "converged": converged, "iterations": iters_to_converge,
            "newton_solves": newton_solves, "timers": timers,
            "advisor_alpha": advisor_alpha, "ls_trials": ls_trials,
        }


def _control_shape_2d(solver: ForwardSolver2D) -> tuple:
    return (solver.M + 1, solver.config.Nx + 1, solver.config.Ny + 1)


def fused_march_rule(cfg: ForwardSolverConfig2D, device,
                     fused_march: Optional[bool] = None) -> bool:
    """Whether a batched 2D problem on `device` takes the whole-march and
    whole-sweep kernels (vch_tpu/parallel/batch.py:1142-1167, :1321-1325):
    `fused_march` if given, else on for a CUDA device, and only where the
    kernels carry the config (`fused_kernels_fit`: float32 on a grid whose
    solve vch_tpu keeps on its kernel; the forward's and the adjoint's rules
    are the same). A float64 config never takes them: asking for them there
    raises. Off, the problem runs the scan path."""
    fits = fused_kernels_fit(cfg)
    if fused_march is None:
        return torch.device(device).type == "cuda" and fits
    if fused_march and not fits:
        raise ValueError(f"fused_march=True needs the float32 fixed-trip "
                         f"path; this config is {cfg.dtype}")
    return bool(fused_march)


class BatchedProblem1D(_BatchedPGDBase):
    """Batched 1D PGD on one device (device=None: the CUDA card), in the
    reference layout: controls and histories carry M + 2 rows, the t = 0 row
    duplicated (vch_tpu/parallel/batch.py:1009-1109).

    fused_march: the forward solve of the baseline and of every line-search
    trial as one launch of the fused 1D march kernel, with straggler_batch
    "auto" unless given. None turns it on for a CUDA device on the float32
    spectral fixed-trip path. A (sub-)batch the kernel's availability rule
    refuses (`ForwardSolver1D.fused_march_available`) takes the batched
    per-step marcher, as does every forward solve with fused_march off,
    which also runs every trial on the whole batch unless straggler_batch
    is given. straggler_batch, speculative, chunk_size, mesh and use_mesh:
    see _BatchedPGDBase."""

    def __init__(self, fwd_config: Optional[ForwardSolverConfig1D] = None,
                 settings: Optional[PGDSettings] = None,
                 alpha_max: float = 100.0, mesh=None, use_mesh: bool = False,
                 straggler_batch=None, speculative=None, chunk_size=None,
                 fused_march: Optional[bool] = None, device=None):
        self.fwd_config = cfg = fwd_config or ForwardSolverConfig1D()
        device = resolve_device(device)
        mesh = _mesh_for(mesh, use_mesh, device)
        self.solver = ForwardSolver1D(cfg, device=device)
        self.adj = AdjointSolver1D(cfg, device=device)
        self._use_fused_march = (
            fused_march if fused_march is not None
            else (device.type == "cuda" and self.solver._use_spectral
                  and self.solver._krylov_fixed is not None))
        super().__init__(settings or PGDSettings.defaults_1d(), alpha_max,
                         (self.solver.M + 2, cfg.N + 1),
                         straggler_batch=straggler_batch,
                         speculative=speculative, chunk_size=chunk_size,
                         mesh=mesh)
        as_t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=device)
        t_ref = np.concatenate([[0.0], self.solver.t_hist])
        self._x = as_t(self.solver.x)
        self._t_ref = as_t(t_ref)
        self._dts_ref = as_t(np.diff(t_ref))

    def _forward_stats(self, u_ref, phi0, phi_Q=None, phi_T=None):
        M = self.solver.M
        u = u_ref[:, : M + 1]           # core layout: drop the duplicate row
        if (self._use_fused_march
                and self.solver.fused_march_available(phi0.shape[0])):
            phi, ns, _bad = self.solver.march_fused_batch(u.contiguous(),
                                                          phi0.contiguous())
        else:
            phi, ns, _bad = self.solver._march_batch(u, phi0)
        return torch.cat([phi[:, :1], phi], dim=1), ns

    def _adjoint(self, phi_ref, u, b1, b2, phi_Q, phi_T):
        return self.adj._run_batch(phi_ref, self._dts_ref, b1[:, None],
                                   b2[:, None], phi_Q, phi_T)[2]

    def _cost(self, phi_ref, u_ref, phi_Q, phi_T, b1, b2, b3, ks):
        return calculate_cost_1d(phi_ref, u_ref, phi_Q, phi_T, self._x,
                                 self._t_ref, b1, b2, b3, ks)

    def _to_ref_layout(self, scenarios: ScenarioBatch) -> ScenarioBatch:
        """phi_Q in core layout (M+1 rows, as sweep_1d builds it) gets the
        duplicated t = 0 row, on a copy of the caller's batch, so that a
        second run on the same batch converts again from the same input."""
        pq = scenarios.phi_Q
        if pq is None or pq.shape[1] != self.solver.M + 1:
            return scenarios
        cat = torch.cat if isinstance(pq, torch.Tensor) else np.concatenate
        return dataclasses.replace(scenarios, phi_Q=cat([pq[:, :1], pq], 1))

    def prewarm(self, scenarios: ScenarioBatch, dtype=None):
        return super().prewarm(self._to_ref_layout(scenarios), dtype)

    def trial_memory_analysis(self, scenarios: ScenarioBatch, dtype=None):
        return super().trial_memory_analysis(self._to_ref_layout(scenarios),
                                             dtype)

    def run(self, scenarios: ScenarioBatch, max_iter: int,
            verbose: bool = True, dtype=None, **kwargs):
        return super().run(self._to_ref_layout(scenarios), max_iter,
                           verbose=verbose, dtype=dtype, **kwargs)


class BatchedProblem2D(_BatchedPGDBase):
    """Batched 2D PGD on one device (device=None: the CUDA card), keeping
    each member's trajectory (vch_tpu/parallel/batch.py:1112-1182).

    fused_march (`fused_march_rule`; None: on for a CUDA device where the
    kernels carry the config): the forward solve of the baseline and of
    every trial as one launch of the whole-march kernel and the adjoint as
    one of the whole-sweep kernel (where its own rule holds), with
    straggler_batch "auto" unless given. Off, the scan path: the batched
    per-step marcher and sweep (masked lockstep over the members; on a
    float32 CUDA run the per-solve kernels, one CTA per member; adaptive
    Krylov in float64), every trial on the whole batch unless
    straggler_batch is given. straggler_batch, speculative, chunk_size, mesh
    and use_mesh: see _BatchedPGDBase."""

    def __init__(self, fwd_config: Optional[ForwardSolverConfig2D] = None,
                 settings: Optional[PGDSettings] = None,
                 alpha_max: float = 50.0, mesh=None, use_mesh: bool = False,
                 straggler_batch=None, speculative=None, chunk_size=None,
                 fused_march: Optional[bool] = None, device=None):
        self.fwd_config = cfg = fwd_config or ForwardSolverConfig2D()
        device = resolve_device(device)
        mesh = _mesh_for(mesh, use_mesh, device)
        self.solver = ForwardSolver2D(cfg, device=device)
        self.adj = AdjointSolver2D(cfg, device=device)
        self._use_fused_march = fused_march_rule(cfg, device, fused_march)
        self._use_fused_adjoint = (self._use_fused_march
                                   and self.adj.fused_march_available())
        super().__init__(settings or PGDSettings.defaults_2d(), alpha_max,
                         _control_shape_2d(self.solver),
                         straggler_batch=straggler_batch,
                         speculative=speculative, chunk_size=chunk_size,
                         mesh=mesh)
        as_t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=device)
        self._x = as_t(self.solver.x)
        self._y = as_t(self.solver.y)
        self._t = as_t(self.solver.t_hist)

    def _forward_stats(self, u, phi0, phi_Q, phi_T):
        march = (self.solver.march_fused_batch if self._use_fused_march
                 else self.solver._march_batch)
        phi, nsolve, _bad = march(u, phi0)
        return phi, nsolve

    def _adjoint(self, phi, u, b1, b2, phi_Q, phi_T):
        if self._use_fused_adjoint:
            return self.adj.adjoint_fused_batch(phi, b1, b2, phi_Q, phi_T)
        return self.adj._run_batch(phi, self.adj.dts, b1, b2, phi_Q, phi_T)[2]

    def _cost(self, phi, u, phi_Q, phi_T, b1, b2, b3, ks):
        return calculate_cost_2d(phi, u, phi_Q, phi_T, self._x, self._y,
                                 self._t, b1, b2, b3, ks)


class LowMemBatchedProblem2D(_BatchedPGDBase):
    """Batched 2D PGD that never keeps a trajectory
    (vch_tpu/parallel/batch.py:1290-1374): the "phi" slot of the PGD loop
    holds a models.lowmem.LowMemState (the K-step segment checkpoints, the
    final state and the J1 accumulator), trials are costed from the
    accumulator, and the adjoint recomputes each segment from its
    checkpoint. fused_march as BatchedProblem2D's (the forward's and the
    adjoint's rules together): on, every segment is one launch of the
    segment march kernel and, in the adjoint, one of the segment sweep
    kernel, with straggler_batch "auto" unless given; off, the scan arm of
    models.lowmem (`_LowMemCore.forward_ckpt` / `adjoint_r`). The other
    keywords as BatchedProblem2D's."""

    def __init__(self, fwd_config: Optional[ForwardSolverConfig2D] = None,
                 K: int = 10, settings: Optional[PGDSettings] = None,
                 alpha_max: float = 50.0, mesh=None, use_mesh: bool = False,
                 straggler_batch=None, speculative=None, chunk_size=None,
                 fused_march: Optional[bool] = None, device=None):
        self.fwd_config = cfg = fwd_config or ForwardSolverConfig2D()
        device = resolve_device(device)
        mesh = _mesh_for(mesh, use_mesh, device)
        self.pipe = LowMemPipeline2D(cfg, K=K, device=device)
        self.solver, self.adj = self.pipe.solver, self.pipe.adjoint
        self._use_fused_march = (
            fused_march_rule(cfg, device, fused_march)
            and self.adj.fused_march_available())
        self._fused = (FusedLowMemBatch2D(self.pipe) if self._use_fused_march
                       else None)
        super().__init__(settings or PGDSettings.defaults_2d(), alpha_max,
                         _control_shape_2d(self.solver),
                         straggler_batch=straggler_batch,
                         speculative=speculative, chunk_size=chunk_size,
                         mesh=mesh)

    def _set_phi_Q_mode(self, mode: Optional[str]):
        if mode not in ("ramp", "zeros"):
            raise ValueError(f"phi_Q=None requires phi_Q_mode in "
                             f"('ramp', 'zeros'); got {mode!r}")
        self.pipe.core.phi_Q_mode = mode

    def _forward_stats(self, u, phi0, phi_Q, phi_T):
        if self._fused is not None:
            return self._fused.forward(u, phi0, phi_Q, phi_T)
        state = self.pipe.core.forward_ckpt(u, phi0, phi_Q, phi_T)
        return state, state.newton_solves

    def _adjoint(self, state, u, b1, b2, phi_Q, phi_T):
        if self._fused is not None:
            return self._fused.adjoint_r(state, u, phi_Q, b1, b2, phi_T)
        return self.pipe.core.adjoint_r(state, u, phi_Q, b1, b2, phi_T)

    def _cost(self, state, u, phi_Q, phi_T, b1, b2, b3, ks):
        return self.pipe.core.cost(state, u, phi_T, b1, b2, b3, ks)


# Peak device memory of BatchedProblem2D.run: FULL_MEMORY_PEAK_PER_S
# trajectory-shaped arrays S = B (M+1) (Nx+1) (Ny+1) x bytes with phi_Q
# stored (one S less without), plus the march kernel's workspace of
# MARCH_WORKSPACE_FIELDS (Nx+1, Ny+1) fields per member, which does not grow
# with M (csrc/common.cuh FWD_FIELDS). Measured on an H100 80GB at config 4
# (chip_smoke.py phase 7; PERF.md section 6): 14.10 S at B = 64 and 14.06 S
# at B = 128 with M = 100, i.e. 13.77 S besides the workspace's 0.33 S;
# rounded up.
FULL_MEMORY_PEAK_PER_S = 13.8
MARCH_WORKSPACE_FIELDS = 33


def full_memory_estimate_bytes(cfg: ForwardSolverConfig2D, batch: int,
                               materialized_phi_Q: bool = True) -> int:
    """Estimated peak device memory of BatchedProblem2D.run."""
    M = len(build_dt_schedule(cfg.T, cfg.dt_initial))
    field = batch * (cfg.Nx + 1) * (cfg.Ny + 1) * (
        8 if cfg.dtype == "float64" else 4)
    per_s = FULL_MEMORY_PEAK_PER_S - (0 if materialized_phi_Q else 1)
    return int(per_s * (M + 1) * field + MARCH_WORKSPACE_FIELDS * field)


def grid_factor(n_devices: int, rows: int, member_bytes: float,
                limit: float) -> int:
    """The grid axis of the automatic combined mesh: the smallest divisor
    gx >= 2 of n_devices that also divides the grid's rows into blocks of
    >= 2 and brings one member's working set under `limit` per device.
    vch_tpu doubles gx from 2 (batch.py:1268-1272), so a grid of 129 or 257
    rows never factors; the port tries every divisor (ROADMAP C). Raises
    ValueError when none does."""
    for gx in range(2, n_devices + 1):
        if (n_devices % gx == 0 and rows % gx == 0 and rows // gx >= 2
                and member_bytes / gx <= limit):
            return gx
    raise ValueError(
        f"one member's low-memory working set (~{member_bytes / 2**30:.1f} "
        f"GiB) does not fit a device and the {n_devices}-device mesh cannot "
        f"be factored into (scenarios, gx) with gx dividing both the device "
        f"count and Nx+1={rows} and bringing it under {limit / 2**30:.1f} "
        f"GiB")


def make_batched_problem_2d(fwd_config: Optional[ForwardSolverConfig2D] = None,
                            batch: int = 1, materialized_phi_Q: bool = True,
                            hbm_limit_bytes: Optional[int] = None,
                            safety: float = 0.75, K: int = 10, device=None,
                            fused_march: Optional[bool] = None, **kwargs):
    """The full-memory or the segment-checkpointed batched 2D problem, by
    estimated peak device memory (vch_tpu/parallel/batch.py:1185-1287):
    LowMemBatchedProblem2D when the full-memory estimate
    (full_memory_estimate_bytes) exceeds safety * limit, else
    BatchedProblem2D, on `device` (None: the CUDA card), with `fused_march`
    passed to either. The limit is hbm_limit_bytes if given, else the total
    memory of the CUDA device, or 16 GiB for a CPU device.

    With a mesh (kwargs["mesh"]): a mesh with a dimension besides
    "scenarios" (the grid axis) gives GridShardedBatchedProblem2D on it
    (kwargs settings, alpha_max, mesh and grid_axis only); a 1D scenario
    mesh where even one member's low-memory working set ((ceil(M/K) + 1 +
    2K) fields, three live copies) exceeds safety * limit is re-meshed into
    (scenarios, gx), gx from `grid_factor`, and gives the same."""
    cfg = fwd_config or ForwardSolverConfig2D()
    device = resolve_device(device)
    mesh = kwargs.get("mesh")
    if mesh is not None:
        check_mesh(mesh)
        axes = tuple(mesh.mesh_dim_names)
        extra_axes = [a for a in axes if a != BATCH_AXIS]
        if len(extra_axes) > 1:
            raise ValueError(f"mesh has axes {axes}; at most one "
                             f"non-'{BATCH_AXIS}' (grid) axis is supported")
        if extra_axes:
            from vch_tpu_torch.parallel.spatial import (
                GridShardedBatchedProblem2D)
            ga = kwargs.get("grid_axis")
            if ga is not None and ga != extra_axes[0]:
                raise ValueError(f"grid_axis={ga!r} not found in mesh axes "
                                 f"{axes}")
            kwargs.setdefault("grid_axis", extra_axes[0])
            supported = {"settings", "alpha_max", "mesh", "grid_axis"}
            extra = set(kwargs) - supported
            if extra or fused_march:
                raise ValueError(
                    f"the combined (scenarios, grid) mesh arm does not "
                    f"support {sorted(extra) or ['fused_march']}; supported "
                    f"kwargs: {sorted(supported)}")
            return GridShardedBatchedProblem2D(cfg, device=device, **kwargs)
    est = full_memory_estimate_bytes(cfg, batch, materialized_phi_Q)
    if hbm_limit_bytes is None:
        hbm_limit_bytes = (
            torch.cuda.get_device_properties(device).total_memory
            if device.type == "cuda" else 16 * 2**30)
    M = len(build_dt_schedule(cfg.T, cfg.dt_initial))
    field = (cfg.Nx + 1) * (cfg.Ny + 1) * (8 if cfg.dtype == "float64" else 4)
    member_lowmem = (-(-M // K) + 1 + 2 * K) * field * 3
    if mesh is not None and member_lowmem > safety * hbm_limit_bytes:
        from vch_tpu_torch.parallel.spatial import GridShardedBatchedProblem2D
        ranks = mesh.mesh.flatten().tolist()
        gx = grid_factor(len(ranks), cfg.Nx + 1, member_lowmem,
                         safety * hbm_limit_bytes)
        combined = _world_mesh(mesh.device_type, (len(ranks) // gx, gx),
                               (BATCH_AXIS, "gx"), ranks=ranks)
        kw = {k: v for k, v in kwargs.items() if k in ("settings",
                                                       "alpha_max")}
        return GridShardedBatchedProblem2D(cfg, mesh=combined, device=device,
                                           **kw)
    if est > safety * hbm_limit_bytes:
        return LowMemBatchedProblem2D(cfg, K=K, device=device,
                                      fused_march=fused_march, **kwargs)
    return BatchedProblem2D(cfg, device=device, fused_march=fused_march,
                            **kwargs)


def tile_batch(sc: ScenarioBatch, B: int) -> ScenarioBatch:
    """Repeat a sweep's members to exactly B (bench.py:112-118)."""
    reps = -(-B // sc.batch)
    tile = lambda a: (None if a is None else
                      np.concatenate([to_numpy(a)] * reps, axis=0)[:B])
    return dataclasses.replace(
        sc, phi0=tile(sc.phi0), phi_T=tile(sc.phi_T), phi_Q=tile(sc.phi_Q),
        b1=tile(sc.b1), b2=tile(sc.b2), b3=tile(sc.b3),
        kappa_spar=tile(sc.kappa_spar))
