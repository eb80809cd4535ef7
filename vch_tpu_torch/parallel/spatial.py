"""Spatial (grid) sharding: the 2D solvers with the grid's x-axis split over
the ranks of a mesh dimension ("gx") (vch_tpu/parallel/spatial.py).

For grids where one member's working set outgrows a device (BASELINE config
5 and beyond) each rank holds a block of (Nx+1)/G rows of every field and
the solvers run the unsharded schedule with collectives on the "gx" group:

  - the 5-point stencil Laplacian exchanges one halo row with each
    neighbouring rank per apply (`dist.batch_isend_irecv`); the first and
    last rank use their own second / second-to-last row instead, the
    mirrored Neumann ghost (ops/laplacian.py). A group of one makes no
    point-to-point call;
  - the cosine-basis preconditioner's x-transforms contract over the
    sharded axis: each rank multiplies its column block of Vx^-1 (Vx) and
    the partial products are combined by `dist.reduce_scatter_tensor`, so
    each rank gets its own row block of the result;
  - every scalar reduction (residual norms, the step-ceiling minima, the
    mean diagonals, the mass-correction sums, the Krylov inner products) is
    an `all_reduce` (SUM or MIN) on the group; the Krylov recurrences are
    ops/linsolve.py's with a reducing `dot_fn`.

vch_tpu runs the mesh as one SPMD program; here every rank runs its own
Python loops, and every host decision (a Newton or Armijo exit, a Krylov
trip, a line-search trial) reads a value that was all-reduced on the group,
so the ranks of a group take the same branch. On the combined ("scenarios",
"gx") mesh each scenario row has its own "gx" group: rows run their own
trip counts (vch_tpu ORs every loop predicate over the whole mesh to keep
one program in lockstep, spatial.py:192-201; here no collective spans two
rows, so none is needed), and within a rank the members converge masked, as
in the port's batched loops. Per member the result is the same either way.

Everything here is plain PyTorch plus collectives, as vch_tpu's module is
plain JAX (no Pallas kernel). On one CUDA card NCCL runs a group of one;
the point-to-point halos and the reduce-scatter across ranks run under gloo
on the CPU (tests/test_torch_spatial.py). Float64 takes the adaptive Krylov
solves, float32 the fixed-trip adjoint solve, as vch_tpu.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from vch_tpu_torch.config import (DELTA_SEP, ForwardSolverConfig2D,
                                  OptimizationConfig, PGDSettings)
from vch_tpu_torch.control.cost import calculate_cost_2d
from vch_tpu_torch.control.diagnostics import (
    approximate_second_order_condition, verify_sparsity_condition)
from vch_tpu_torch.control.pgd import ProximalGradientLoop
from vch_tpu_torch.control.targets import build_targets_2d
from vch_tpu_torch.device import as_tensor, to_numpy
from vch_tpu_torch.models.adjoint2d import AdjointSweep2D
from vch_tpu_torch.models.forward1d import MarchStats
from vch_tpu_torch.models.forward2d import ForwardStep2D, torch_dtype
from vch_tpu_torch.models.timegrid import build_dt_schedule, t_history
from vch_tpu_torch.ops.grids import trapz_weights
from vch_tpu_torch.ops.laplacian import neumann_eigendecomposition
from vch_tpu_torch.ops.potential import init_phi_random_2d
from vch_tpu_torch.parallel.batch import _BatchedPGDBase
from vch_tpu_torch.parallel.mesh import (BATCH_AXIS, _world_mesh,
                                         all_gather_dim, axis_rank,
                                         axis_size, check_mesh, local_block,
                                         world_size)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class GridComm:
    """The collectives of a grid-sharded solver on one mesh dimension, each
    counted in `counts` by kind (all_reduce, reduce_scatter, halo: one
    exchange with the neighbours, p2p: its sends and receives)."""

    def __init__(self, mesh, axis: str):
        self.group = mesh.get_group(axis)
        self.size = axis_size(mesh, axis)
        self.rank = axis_rank(mesh, axis)
        peer = lambda g: dist.get_global_rank(self.group, g)
        self.up = peer(self.rank - 1) if self.rank > 0 else None
        self.down = peer(self.rank + 1) if self.rank < self.size - 1 else None
        self.counts = dict(all_reduce=0, reduce_scatter=0, halo=0, p2p=0)

    def _reduce(self, t, op):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, op=op, group=self.group)
        self.counts["all_reduce"] += 1
        return t

    def sum(self, t):
        return self._reduce(t, dist.ReduceOp.SUM)

    def min(self, t):
        return self._reduce(t, dist.ReduceOp.MIN)

    def reduce_scatter_rows(self, part):
        """part (..., n, m), a partial sum over the ranks: its sum, this
        rank's block of n / size rows."""
        lead = part.dim() - 2
        perm = (lead,) + tuple(range(lead)) + (lead + 1,)
        x = part.permute(perm).contiguous()            # rows first
        out = x.new_empty((x.shape[0] // self.size,) + x.shape[1:])
        dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM,
                                   group=self.group)
        self.counts["reduce_scatter"] += 1
        inv = tuple(range(1, lead + 1)) + (0, lead + 1)
        return out.permute(inv)

    def halos(self, first, last):
        """(the row above this block: the previous rank's last row; the row
        below: the next rank's first row), None where there is no
        neighbour."""
        ops, up, down = [], None, None
        if self.up is not None:
            up = torch.empty_like(first)
            ops += [dist.P2POp(dist.isend, first, self.up, self.group),
                    dist.P2POp(dist.irecv, up, self.up, self.group)]
        if self.down is not None:
            down = torch.empty_like(last)
            ops += [dist.P2POp(dist.isend, last, self.down, self.group),
                    dist.P2POp(dist.irecv, down, self.down, self.group)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            self.counts["p2p"] += len(ops)
        self.counts["halo"] += 1
        return up, down


def _halo_laplacian_local(v, hx, hy, comm: GridComm):
    """The 2D Neumann Laplacian of this rank's row block v (..., rows, m),
    one halo row exchanged with each neighbour (vch_tpu spatial.py:52)."""
    up, down = comm.halos(v[..., :1, :].contiguous(),
                          v[..., -1:, :].contiguous())
    up = v[..., 1:2, :] if up is None else up          # mirrored ghost
    down = v[..., -2:-1, :] if down is None else down
    pad = torch.cat([up, v, down], dim=-2)
    lap_x = (pad[..., :-2, :] - 2.0 * v + pad[..., 2:, :]) / (hx * hx)
    pady = torch.cat([v[..., 1:2], v, v[..., -2:-1]], dim=-1)
    lap_y = (pady[..., :-2] - 2.0 * v + pady[..., 2:]) / (hy * hy)
    return lap_x + lap_y


def sharded_laplacian_2d(mesh, axis_name: str, hx: float, hy: float):
    """The Laplacian with the x-axis sharded over `axis_name` (the minimal
    parity probe of vch_tpu spatial.py:73): apply(v) takes the whole field
    (every rank holds it) and returns this rank's row block of its
    Laplacian."""
    comm = GridComm(check_mesh(mesh), axis_name)

    def apply(v):
        blk = local_block(v.shape[-2], comm.size, comm.rank)
        return _halo_laplacian_local(v[..., blk, :].contiguous(), hx, hy,
                                     comm)

    return apply


class _GridSharded:
    """What the grid-sharded forward and adjoint share: the mesh, the "gx"
    group, this rank's row block and the cosine-basis constants restricted
    to it (vch_tpu spatial.py:99-144, :435-462)."""

    def __init__(self, config, mesh, axis, batch_axis, device):
        self.config = cfg = config or ForwardSolverConfig2D()
        if mesh is None:
            mesh = _world_mesh(device, (world_size(device),), (axis,))
        self.mesh = check_mesh(mesh)
        if (device is not None
                and torch.device(device).type != self.mesh.device_type):
            raise ValueError(f"device {device} is not the mesh's "
                             f"{self.mesh.device_type}")
        self.axis, self.batch_axis = axis, batch_axis
        self.comm = GridComm(self.mesh, axis)
        n_sh, rows = self.comm.size, cfg.Nx + 1
        if rows % n_sh or rows // n_sh < 2:
            raise ValueError(f"Nx+1={rows} must divide into the grid axis' "
                             f"{n_sh} shards of >= 2 rows (halo width 1)")
        self.rows = local_block(rows, n_sh, self.comm.rank)
        self.device = dev = _mesh_device(self.mesh)
        self.dtype = torch_dtype(cfg.dtype)
        self.hx, self.hy = cfg.Lx / cfg.Nx, cfg.Ly / cfg.Ny
        self.dts_np = build_dt_schedule(cfg.T, cfg.dt_initial)
        self.t_hist = t_history(self.dts_np, cfg.T)
        self.M = len(self.dts_np)
        lamx, Vx, Vx_inv = neumann_eigendecomposition(cfg.Nx, self.hx)
        lamy, Vy, Vy_inv = neumann_eigendecomposition(cfg.Ny, self.hy)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                      dtype=self.dtype, device=dev)
        r = self.rows
        # this rank's columns of Vx^-1 and Vx: the partial products of the
        # x-transforms over its rows (vch_tpu's VxiT / VxT row blocks)
        self.Vxi_cols, self.Vx_cols = t(Vx_inv[:, r]), t(Vx[:, r])
        self.lam = t(lamx[r][:, None] + lamy[None, :])
        self.Vy_inv_T, self.VyT = t(Vy_inv.T), t(Vy.T)
        self.dts = t(self.dts_np)
        wx = trapz_weights(cfg.Nx + 1) * self.hx
        wy = trapz_weights(cfg.Ny + 1) * self.hy
        self.wts = t(np.outer(wx, wy)[r])
        self.wx_l = t(wx[r])
        self.krylov_tol = (cfg.krylov_tol if self.dtype == torch.float64
                           else max(cfg.krylov_tol, 1e-6))
        self.n_total = (cfg.Nx + 1) * (cfg.Ny + 1)

    # the grid operations of ops.linsolve.LocalGrid on this rank's rows,
    # reduced over the "gx" group, for the shared 2D step and sweep
    @property
    def grid(self):
        return self

    def lap(self, v):
        return _halo_laplacian_local(v, self.hx, self.hy, self.comm)

    def sums(self, *parts):
        """The sums over the whole grid, in one all_reduce."""
        s = self.comm.sum(torch.cat([torch.sum(a, dim=(-2, -1), keepdim=True)
                                     for a in parts], dim=-1))
        return tuple(s[..., i:i + 1] for i in range(len(parts)))

    def mins(self, *parts):
        s = self.comm.min(torch.cat([torch.amin(a, dim=(-2, -1),
                                                keepdim=True)
                                     for a in parts], dim=-1))
        return tuple(s[..., i:i + 1] for i in range(len(parts)))

    def mean(self, a):
        return self.sums(a)[0] / self.n_total

    def dot(self, a, b):
        return self.sums(a * b)[0]

    def to_spec(self, v):
        """This rank's row block of Vx^-1 v Vy^-T from its row block of v."""
        part = torch.matmul(self.Vxi_cols, v)
        return torch.matmul(self.comm.reduce_scatter_rows(part),
                            self.Vy_inv_T)

    def from_spec(self, vh):
        part = torch.matmul(self.Vx_cols, vh)
        return torch.matmul(self.comm.reduce_scatter_rows(part), self.VyT)

    def local(self, a, dim: int = -2):
        """This rank's row block of a whole field `a` (numpy or tensor)
        along `dim`, as a tensor of the solver's dtype on its device."""
        t = as_tensor(a, self.dtype, self.device)
        idx = [slice(None)] * t.dim()
        idx[dim] = self.rows
        return t[tuple(idx)].contiguous()

    def gather(self, t, dim: int = -2):
        """The whole field from every rank's row block t along `dim`."""
        return all_gather_dim(t, self.comm.group,
                              dim % t.dim())


class GridShardedForward2D(ForwardStep2D, _GridSharded):
    """The 2D forward march with the grid's x-axis sharded over the mesh
    dimension `axis` (vch_tpu spatial.py:89): ForwardSolver2D's own step
    (models/forward2d.py ForwardStep2D: Crank-Nicolson, Newton with the
    spectral-preconditioned Schur solve, the step ceiling, Armijo with the
    best-trial fallback, the interior-only mass correction, the non-finite
    sanitizer) on this rank's rows, its grid operations those of
    _GridSharded. Requires Nx+1
    divisible by the axis size and >= 2 rows a shard.

    mesh: a DeviceMesh with the dimension `axis` (None: every rank of the
    world on one dimension, of `device`'s type; None: the CUDA card); its
    device type is the solver's device. batch_axis: on the combined
    ("scenarios", "gx") mesh, the march takes a leading batch axis of this
    rank's members (its scenario block)."""

    def __init__(self, config: Optional[ForwardSolverConfig2D] = None,
                 mesh=None, axis: str = "gx",
                 batch_axis: Optional[str] = None, device=None):
        super().__init__(config, mesh, axis, batch_axis, device)
        f64 = self.dtype == torch.float64
        self._rtol = 0.0 if f64 else self.config.newton_rtol
        self._stagnation = not f64
        self.last_stats = None

    def _newton_kw(self, kernels: bool = True):
        """newton_2d's arguments: the adaptive Krylov solve in both dtypes,
        as vch_tpu's sharded Schur solve (spatial.py:232-256), and no
        per-solve kernel."""
        cfg = self.config
        return dict(tau=cfg.tau, c1=cfg.c1, c2=cfg.c2, kappa=cfg.kappa,
                    delta_sep=DELTA_SEP, tol=cfg.newton_tol,
                    max_iter=cfg.newton_max_iter, krylov_tol=self.krylov_tol,
                    krylov_max_iter=cfg.krylov_max_iter, rtol=self._rtol,
                    stagnation_exit=self._stagnation)

    def march(self, u, phi0):
        """The inner API on this rank's row blocks: u (M+1, rows, m) and
        phi0 (rows, m), or with batch_axis (B, M+1, rows, m) and (B, rows,
        m) for this rank's members; host numpy or tensors on any device
        (ones already in the solver's dtype on its device are not copied).
        Returns (phi_hist, newton_solves, first_bad): the history's row
        block, the counts as 0-d tensors (per member with batch_axis)."""
        u = as_tensor(u, self.dtype, self.device)
        phi0 = as_tensor(phi0, self.dtype, self.device)
        if self.batch_axis is not None:
            return self._march_batch(u, phi0)
        phi, ns, bad = self._march_batch(u[None], phi0[None])
        return phi[0], ns[0], bad[0]

    def simulate(self, control=None, initial_phi=None):
        """The grid-sharded forward simulation from initial_phi (default:
        the seed-42 IC) under control (M+1, Nx+1, Ny+1) (default: zero),
        both whole fields every rank holds. Returns (phi_hist, (x, y),
        t_hist) with phi_hist this rank's row block (M+1, rows, Ny+1)
        (`gather` assembles the whole); the Newton count lands in
        `last_stats`, and a non-finite mass defect raises (vch_tpu
        spatial.py:387-420)."""
        if self.batch_axis is not None:
            raise ValueError("simulate() is the single-scenario surface; "
                             "batched marchers are driven through march() "
                             "by GridShardedBatchedProblem2D")
        cfg = self.config
        shape = (self.M + 1, cfg.Nx + 1, cfg.Ny + 1)
        if initial_phi is None:
            initial_phi = init_phi_random_2d(cfg.Nx, cfg.Ny, DELTA_SEP,
                                             amp=0.1, seed=42)
        if control is None:
            u = torch.zeros((self.M + 1, self.rows.stop - self.rows.start,
                             cfg.Ny + 1), dtype=self.dtype,
                            device=self.device)
        else:
            if tuple(np.shape(control)) != shape:
                raise ValueError(f"control must be (M+1, Nx+1, Ny+1) = "
                                 f"{shape}; got {tuple(np.shape(control))}")
            u = self.local(control)
        phi_hist, ns, bad = self.march(u, self.local(initial_phi))
        self.last_stats = MarchStats(int(ns), int(bad))
        if self.last_stats.first_bad_step >= 0:
            raise RuntimeError(
                f"Non-finite mass defect at time step "
                f"{self.last_stats.first_bad_step} — solution diverged (see "
                "Forward_solver.py:166-172 semantics).")
        x = np.linspace(0.0, cfg.Lx, cfg.Nx + 1)
        y = np.linspace(0.0, cfg.Ly, cfg.Ny + 1)
        return phi_hist, (x, y), self.t_hist


class GridShardedAdjoint2D(AdjointSweep2D, _GridSharded):
    """The 2D adjoint (p, q, r) backward sweep with the grid's x-axis
    sharded (vch_tpu spatial.py:423): AdjointSolver2D's own sweep
    (models/adjoint2d.py AdjointSweep2D: the terminal solve exact in the
    cosine basis, the split-preconditioned BiCGStab per step, the
    dt <= 1e-14 skip) on this rank's rows, with the halo Laplacian, the
    reduce-scattered transforms and the all-reduced inner product of
    _GridSharded. Float32 takes the fixed-trip solve (adjoint_krylov_fixed_iters,
    else krylov_fixed_iters), float64 the adaptive one. mesh, device as
    GridShardedForward2D's."""

    def __init__(self, config: Optional[ForwardSolverConfig2D] = None,
                 mesh=None, axis: str = "gx",
                 batch_axis: Optional[str] = None, device=None):
        super().__init__(config, mesh, axis, batch_axis, device)
        cfg = self.config
        self._krylov_fixed = (None if self.dtype == torch.float64
                              else (cfg.adjoint_krylov_fixed_iters
                                    or cfg.krylov_fixed_iters))
        self._use_pallas, self._pallas_variant, self.entries = (
            False, cfg.pallas_variant, None)

    def _run_local(self, phi, dts_np, b1, b2, phi_Q, phi_T):
        """This rank's members: phi, phi_Q (B, M+1, rows, m), phi_T
        (B, rows, m), b1, b2 (B,). Returns (p, q, r), each (B, M+1, rows,
        m) (vch_tpu spatial.py:490-585)."""
        dts = torch.as_tensor(dts_np, dtype=self.dtype, device=self.device)
        return self._run_batch(phi, dts, b1, b2, phi_Q, phi_T)

    def run_impl(self, phi_hist, dts, b1, b2, phi_Q, phi_T_target):
        """The inner API on this rank's row blocks: phi_hist, phi_Q
        (M+1, rows, m), phi_T_target (rows, m), or with batch_axis each with
        a leading axis of this rank's members and b1, b2 (B,); host numpy
        or tensors on any device (ones already in the solver's dtype on its
        device are not copied). dts: the step sizes (M,), read to the host.
        Returns (p, q, r) row blocks."""
        dts = to_numpy(dts).astype(np.float64)
        t = lambda a: as_tensor(a, self.dtype, self.device)
        phi_hist, phi_Q, phi_T_target = map(t, (phi_hist, phi_Q,
                                                phi_T_target))
        if self.batch_axis is not None:
            return self._run_local(phi_hist, dts, t(b1), t(b2), phi_Q,
                                   phi_T_target)
        out = self._run_local(phi_hist[None], dts, t(b1).reshape(1),
                              t(b2).reshape(1), phi_Q[None],
                              phi_T_target[None])
        return tuple(a[0] for a in out)

    def run(self, phi_hist, t_hist, b1: float, b2: float, phi_Q=None,
            phi_T_target=None):
        """AdjointSolver2D.run's surface on whole fields every rank holds
        (phi_hist, phi_Q (M+1, Nx+1, Ny+1), phi_T_target (Nx+1, Ny+1));
        returns this rank's row blocks of (p, q, r)."""
        if self.batch_axis is not None:
            raise ValueError("run() is the single-scenario surface; batched "
                             "sweeps go through run_impl() with (B,)-shaped "
                             "b1/b2 (GridShardedBatchedProblem2D)")
        phi = self.local(phi_hist)
        dts = np.diff(to_numpy(t_hist).astype(np.float64))
        phi_Q = (torch.zeros_like(phi) if phi_Q is None
                 else self.local(phi_Q))
        phi_T = (torch.zeros_like(phi[0]) if phi_T_target is None
                 else self.local(phi_T_target))
        return self.run_impl(phi, dts, float(b1), float(b2), phi_Q, phi_T)


def _sharded_cost(sh: _GridSharded, phi, u, phi_Q, phi_T, y, t, b1, b2, b3,
                  ks):
    """calculate_cost_2d on row blocks (..., M+1, rows, m): each rank's
    trapezoid sums over its rows, then one all_reduce of the whole cost
    (it is linear in them)."""
    def sp(a):
        return torch.sum(torch.trapezoid(a, x=y, dim=-1) * sh.wx_l, dim=-1)

    tr = lambda a: torch.trapezoid(a, x=t, dim=-1)
    J = ((b1 / 2.0) * tr(sp((phi - phi_Q) ** 2))
         + (b2 / 2.0) * sp((phi[..., -1, :, :] - phi_T) ** 2)
         + (b3 / 2.0) * tr(sp(u ** 2)) + ks * tr(sp(torch.abs(u))))
    return sh.comm.sum(J)


class GridShardedProblem2D:
    """Sparse-control PGD with the grid sharded over the mesh (vch_tpu
    spatial.py:618): the grid-sharded forward march and adjoint sweep,
    the gradient, the prox and an all-reduced cost wired into the port's
    host ProximalGradientLoop, so the trial schedule is ControlProblem2D's.
    Every rank holds its row block of u, phi and r; `optimize` returns the
    whole fields on every rank. `newton_solves` is the baseline march's
    count, as in vch_tpu. mesh, device as GridShardedForward2D's."""

    def __init__(self, config: Optional[ForwardSolverConfig2D] = None,
                 opt_config: Optional[OptimizationConfig] = None, mesh=None,
                 axis: str = "gx", choice_t: int = 1, choice_q: int = 1,
                 initial_phi=None, device=None):
        self.fwd = GridShardedForward2D(config, mesh=mesh, axis=axis,
                                        device=device)
        self.config = cfg = self.fwd.config
        self.adjoint = GridShardedAdjoint2D(cfg, mesh=self.fwd.mesh,
                                            axis=axis)
        self.opt_config = opt = opt_config or OptimizationConfig.defaults_2d()
        fwd = self.fwd
        self.device, self.dtype = fwd.device, fwd.dtype
        self.phi0 = (init_phi_random_2d(cfg.Nx, cfg.Ny, DELTA_SEP, amp=0.1,
                                        seed=42)
                     if initial_phi is None
                     else to_numpy(initial_phi).astype(np.float64))
        self._phi0_l = fwd.local(self.phi0)
        x = np.linspace(0.0, cfg.Lx, cfg.Nx + 1)
        y = np.linspace(0.0, cfg.Ly, cfg.Ny + 1)
        self.x, self.y, self.t_hist = x, y, fwd.t_hist
        phi_T, phi_Q = build_targets_2d(x, y, self.t_hist, self.phi0,
                                        float(cfg.Lx), float(cfg.Ly),
                                        float(cfg.T), choice_t=choice_t,
                                        choice_q=choice_q)
        as_t = lambda a: torch.as_tensor(a, dtype=self.dtype,
                                         device=self.device)
        self.phi_T_target, self.phi_Q_target = as_t(phi_T), as_t(phi_Q)
        self._phiT_l, self._phiQ_l = fwd.local(phi_T), fwd.local(phi_Q)
        self._x, self._y, self._t = as_t(x), as_t(y), as_t(self.t_hist)
        self.newton_solves = 0

        def forward(u):
            return fwd.march(u, self._phi0_l)[0]

        def adjoint(phi_hist):
            return self.adjoint.run_impl(phi_hist, fwd.dts_np, opt.b1,
                                         opt.b2, self._phiQ_l,
                                         self._phiT_l)[2]

        def cost(phi_hist, u):
            return _sharded_cost(fwd, phi_hist, u, self._phiQ_l,
                                 self._phiT_l, self._y, self._t, opt.b1,
                                 opt.b2, opt.b3, opt.kappa_sparsity)

        def norm(v):
            return torch.sqrt(fwd.comm.sum(torch.sum(v * v)))

        self.loop = ProximalGradientLoop(
            forward, adjoint, cost, opt, settings=PGDSettings.defaults_2d(),
            search_mode="host", norm=norm)
        self._u0 = torch.zeros((fwd.M + 1,) + tuple(self._phi0_l.shape),
                               dtype=self.dtype, device=self.device)

    def optimize(self, max_iter: Optional[int] = None, verbose: bool = True):
        """PGD from u = 0; the result's u_optimal, r_optimal and phi_final
        are the whole fields (gathered from every rank's rows)."""
        phi0_hist, ns, _ = self.fwd.march(self._u0, self._phi0_l)
        self.newton_solves = int(ns)
        res = self.loop.run(self._u0, phi0_hist, max_iter=max_iter,
                            verbose=verbose and self._lead())
        whole = lambda a: self.fwd.gather(torch.as_tensor(
            a, device=self.device)).cpu().numpy()
        res.u_optimal = whole(res.u_optimal)
        res.r_optimal = whole(res.r_optimal)
        res.phi_final = whole(res.phi_final)
        return res

    def _lead(self) -> bool:
        return dist.get_rank() == int(self.fwd.mesh.mesh.flatten()[0])

    def verify_sparsity(self, result, verbose: bool = True):
        return verify_sparsity_condition(result.u_optimal, result.r_optimal,
                                         self.opt_config.kappa_sparsity,
                                         verbose=verbose)

    def _forward_whole(self, u):
        """Whole trajectories of whole controls u (D, M+1, Nx+1, Ny+1),
        each marched grid-sharded."""
        out = [self.fwd.gather(self.fwd.march(self.fwd.local(u_i),
                                              self._phi0_l)[0])
               for u_i in u]
        return torch.stack(out)

    def _cost_whole(self, phi_hist, u):
        opt = self.opt_config
        return calculate_cost_2d(phi_hist, u, self.phi_Q_target,
                                 self.phi_T_target, self._x, self._y,
                                 self._t, opt.b1, opt.b2, opt.b3,
                                 opt.kappa_sparsity)

    def second_order_check(self, result, num_directions: int = 5,
                           epsilon: float = 1e-4, seed: int = 42):
        """The FD coercivity probe (vch_tpu spatial.py:706): every rank draws
        the same directions, each perturbed march runs grid-sharded."""
        opt = self.opt_config
        return approximate_second_order_condition(
            None, self._cost_whole, result.u_optimal,
            result.r_optimal, result.phi_final, opt.b3, opt.kappa_sparsity,
            opt.u_min, opt.u_max, num_directions=num_directions,
            epsilon=epsilon, seed=seed, handle_kink=False, dtype=self.dtype,
            device=self.device, forward_batch=self._forward_whole)


class GridShardedBatchedProblem2D(_BatchedPGDBase):
    """Batched PGD over the combined ("scenarios", "gx") mesh (vch_tpu
    spatial.py:721): the batch is sharded over "scenarios" and every
    member's field rows over `grid_axis`. Each rank marches and sweeps its
    members' row blocks (GridSharded{Forward,Adjoint}2D with batch_axis)
    and costs them with one all-reduce on its "gx" group; the masked host
    search of _BatchedPGDBase runs unchanged (no sub-batches, no speculative
    packing, no chunks, as on vch_tpu's combined mesh), so the trials are
    BatchedProblem2D's member for member. The batch must divide the
    scenario axis.

    mesh None: every rank of the world as (world / grid_shards,
    grid_shards), grid_shards default 2, of `device`'s type (None: the CUDA
    card); on one card grid_shards=1 gives a (1, 1) mesh. The mesh's device
    type is the problem's device."""

    _requires_divisible_batch = True

    def __init__(self, fwd_config: Optional[ForwardSolverConfig2D] = None,
                 settings: Optional[PGDSettings] = None,
                 alpha_max: float = 50.0, mesh=None, grid_axis: str = "gx",
                 grid_shards: Optional[int] = None, device=None):
        self.fwd_config = cfg = fwd_config or ForwardSolverConfig2D()
        if mesh is None:
            world = world_size(device)
            gs = grid_shards or 2
            if world % gs:
                raise ValueError(f"grid_shards={gs} does not divide the "
                                 f"world's {world} ranks")
            mesh = _world_mesh(device, (world // gs, gs),
                               (BATCH_AXIS, grid_axis))
        check_mesh(mesh)
        if (BATCH_AXIS not in mesh.mesh_dim_names
                or grid_axis not in mesh.mesh_dim_names):
            raise ValueError(f"the mesh needs the dimensions "
                             f"{(BATCH_AXIS, grid_axis)}; it has "
                             f"{mesh.mesh_dim_names}")
        self.grid_axis = grid_axis
        self.fwd = GridShardedForward2D(cfg, mesh=mesh, axis=grid_axis,
                                        batch_axis=BATCH_AXIS)
        self.adj = GridShardedAdjoint2D(cfg, mesh=mesh, axis=grid_axis,
                                        batch_axis=BATCH_AXIS)
        self.solver = self.fwd
        self._use_fused_march = False
        super().__init__(settings or PGDSettings.defaults_2d(), alpha_max,
                         (self.fwd.M + 1, cfg.Nx + 1, cfg.Ny + 1),
                         mesh=mesh)
        rows = self.fwd.rows.stop - self.fwd.rows.start
        self._local_control_shape = (self.fwd.M + 1, rows, cfg.Ny + 1)
        as_t = lambda a: torch.as_tensor(a, dtype=self.dtype,
                                         device=self.device)
        self._y = as_t(np.linspace(0.0, cfg.Ly, cfg.Ny + 1))
        self._t = as_t(self.fwd.t_hist)

    def _forward_stats(self, u, phi0, phi_Q, phi_T):
        phi, ns, _bad = self.fwd.march(u, phi0)
        return phi, ns

    def _adjoint(self, phi, u, b1, b2, phi_Q, phi_T):
        return self.adj.run_impl(phi, self.fwd.dts_np, b1, b2, phi_Q,
                                 phi_T)[2]

    def _cost(self, phi, u, phi_Q, phi_T, b1, b2, b3, ks):
        return _sharded_cost(self.fwd, phi, u, phi_Q, phi_T, self._y,
                             self._t, b1, b2, b3, ks)

    def _change(self, u1, u):
        dims = tuple(range(1, u.ndim))
        s = self.fwd.comm.sum(torch.stack(
            [torch.sum((u1 - u) ** 2, dim=dims),
             torch.sum(u ** 2, dim=dims)]))
        return torch.sqrt(s[0]) / (torch.sqrt(s[1]) + 1e-9)

    def _input_sharding(self, a):
        """The placements of a batch-leading input on the combined mesh
        (vch_tpu spatial.py:798): the batch over "scenarios" and, for a
        field, its rows over the grid axis: (B,) -> Shard(0); (B, nx, ny)
        -> Shard(1) on the grid axis; (B, M+1, nx, ny) -> Shard(2)."""
        from torch.distributed.tensor import Replicate, Shard
        rows = {1: None, 3: 1, 4: 2}[np.ndim(a)]
        return tuple(Shard(0) if ax == BATCH_AXIS else
                     (Replicate() if rows is None else Shard(rows))
                     for ax in self.mesh.mesh_dim_names)

    def _gather_full(self, t):
        return super()._gather_full(self.fwd.gather(t) if t.ndim >= 3
                                    else t)
