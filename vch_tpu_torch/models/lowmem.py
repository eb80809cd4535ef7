"""Segment-checkpointed (low-memory) batched forward and adjoint
(vch_tpu/models/lowmem.py).

The adjoint sweep needs the whole phi trajectory, and at 256x256 with large
batches the stored history dominates device memory. The forward march keeps
only the state (phi, mu, w) at the start of each K-step segment, plus the
running tracking integral J1, and the adjoint recomputes each segment from
its checkpoint just before it sweeps it: O(M/K + K) live frames instead of
O(M). `_LowMemCore` holds that schedule once for two arms, each batched over
a leading member axis:

  - the scan arm (`forward_ckpt`, `adjoint_r` with their default segment
    functions): each segment steps the per-step marcher and the per-step
    sweep of an adapter (`_Adapter2D`, `_Adapter1D`) in masked lockstep, as
    vmap of vch_tpu's `_LowMemCore` does; `LowMemPipeline2D.adjoint_r` and
    `LowMemPipeline1D.adjoint_r` run it for one member;
  - the fused arm (`FusedLowMemBatch2D`): each segment is one launch of the
    segment march kernel and one of the segment adjoint kernel
    (`ops.march.march_fused_2d_segment`, `adjoint_fused_2d_segment`), as
    vch_tpu's `FusedLowMemBatch2D` does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from vch_tpu_torch.config import ForwardSolverConfig1D, ForwardSolverConfig2D
from vch_tpu_torch.device import as_tensor
from vch_tpu_torch.models.adjoint1d import AdjointSolver1D
from vch_tpu_torch.models.adjoint2d import AdjointSolver2D
from vch_tpu_torch.models.forward1d import ForwardSolver1D
from vch_tpu_torch.models.forward2d import ForwardSolver2D


class LowMemState(NamedTuple):
    """What the PGD loop needs from a checkpointed forward solve, each with
    a leading batch axis B (vch_tpu/models/lowmem.py:40).

    ck_phi / ck_mu / ck_w (B, S, *space) are the S segment-start states,
    phi_T (B, *space) the final state, j1_raw (B,) the trapezoid-in-time
    tracking integral of (phi - phi_Q)^2 without the b1/2 factor, and
    newton_solves (B,) the measured Newton solve count.
    """

    ck_phi: torch.Tensor
    ck_mu: torch.Tensor
    ck_w: torch.Tensor
    phi_T: torch.Tensor
    j1_raw: torch.Tensor
    newton_solves: torch.Tensor


class _Adapter2D:
    """The 2D physics of the schedule, batched (vch_tpu/models/lowmem.py:
    59-169): the step of ForwardSolver2D's per-step marcher and of
    AdjointSolver2D's per-step sweep, the terminal solve, and the initial
    state with the masses m0 (B, 1, 1)."""

    def __init__(self, solver: ForwardSolver2D, adjoint: AdjointSolver2D):
        self.solver, self.adjoint = solver, adjoint

    def init_state(self, phi0):
        w0 = torch.zeros_like(phi0)
        return (self.solver.initialize_mu(phi0, w0), w0,
                torch.sum(self.solver.wts * phi0, dim=(-2, -1), keepdim=True))

    def forward_step(self, phi, mu, w, u_n, u_np1, dt, m0):
        return self.solver._step(phi, mu, w, u_n, u_np1, dt, m0)[:4]

    def terminal(self, phi_T, phi_T_target, b2):
        return self.adjoint.terminal(phi_T, phi_T_target, b2)

    def adjoint_step(self, carry, phi_n, phi_np1, src_n, src_np1, dt, b1):
        return self.adjoint._sweep_step(*carry, phi_n, phi_np1, src_n,
                                        src_np1, dt, b1.reshape(-1, 1, 1))


class _Adapter1D:
    """The 1D physics of the schedule in core layout (no duplicated t = 0
    row), batched (vch_tpu/models/lowmem.py:171-270): ForwardSolver1D's
    step, and AdjointSolver1D's sweep step with the float32 solve in
    `adjoint_krylov_fixed_iters` fixed trips, as vch_tpu's adapter takes
    it."""

    def __init__(self, solver: ForwardSolver1D, adjoint: AdjointSolver1D):
        self.solver, self.adjoint = solver, adjoint

    def init_state(self, phi0):
        w0 = torch.zeros_like(phi0)
        return (self.solver.initialize_mu(phi0, w0), w0,
                torch.sum(self.solver.wts * phi0, dim=-1, keepdim=True))

    def forward_step(self, phi, mu, w, u_n, u_np1, dt, m0):
        return self.solver._step(phi, mu, w, u_n, u_np1, dt, m0)[:4]

    def terminal(self, phi_T, phi_T_target, b2):
        return self.adjoint.terminal(phi_T, phi_T_target, b2.reshape(-1, 1))

    def adjoint_step(self, carry, phi_n, phi_np1, src_n, src_np1, dt, b1):
        return self.adjoint._sweep_step(
            *carry, phi_n, phi_np1, src_n, src_np1, dt, b1.reshape(-1, 1),
            krylov_fixed=self.adjoint._krylov_fixed)


class _LowMemCore:
    """Segment bounds, procedural tracking targets, the cost from the J1
    accumulator, and the checkpointed forward and recomputing adjoint over
    the adapter's physics (vch_tpu/models/lowmem.py:272-455).

    Segments: S_full = M // K full segments of K steps plus one tail segment
    of rem = M - S_full * K steps when rem > 0, so any dt schedule works,
    including a partial final step. x, y are the space nodes (y None in
    1D).
    """

    def __init__(self, dts: np.ndarray, K: int, t_hist: np.ndarray, x, y,
                 dtype: torch.dtype, device: torch.device, adapter=None):
        if K < 1:
            raise ValueError(f"K must be >= 1, got {K}")
        self.K = int(K)
        self.M = len(dts)
        self.S_full = self.M // self.K
        self.rem = self.M - self.S_full * self.K
        self.dts_np = np.asarray(dts, np.float64)
        self.t_np = np.asarray(t_hist, np.float64)
        self.dtype = dtype
        self.a = adapter
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        self.x, self.t = as_t(x), as_t(self.t_np)
        self.y = None if y is None else as_t(y)
        self._dts = as_t(self.dts_np)
        self._t_rel = as_t(self.t_np / self.t_np[-1])
        # procedural tracking target used when phi_Q is None: "ramp" is the
        # linear time ramp phi0 -> phi_T (targets choice_q=1), "zeros" is
        # choice_q=2 (vch_tpu/models/lowmem.py:293-315)
        self.phi_Q_mode = "ramp"
        self.bounds = [(i * self.K, self.K) for i in range(self.S_full)]
        if self.rem:
            self.bounds.append((self.S_full * self.K, self.rem))

    def phiQ_seg(self, phi_Q, start: int, length: int, phi0, phi_T_ref):
        """Frames [start, start+length) of the tracking target, (B, length,
        *space): sliced from phi_Q, or synthesized when phi_Q is None."""
        if phi_Q is not None:
            return phi_Q[:, start:start + length]
        if self.phi_Q_mode == "zeros":
            return phi0.new_zeros((phi0.shape[0], length) + phi0.shape[1:])
        if self.phi_Q_mode != "ramp":
            raise ValueError(f"unknown phi_Q_mode {self.phi_Q_mode!r}")
        tp = self._t_rel[start:start + length].reshape(
            (1, length) + (1,) * (phi0.dim() - 1))
        return (1.0 - tp) * phi0[:, None] + tp * phi_T_ref[:, None]

    def space_int(self, v):
        """trapz over y, then x (control/cost.py's space integral); over x
        alone in 1D."""
        if self.y is not None:
            v = torch.trapezoid(v, x=self.y, dim=-1)
        return torch.trapezoid(v, x=self.x, dim=-1)

    def cost(self, state: LowMemState, u, phi_T_target, b1, b2, b3,
             kappa_spar):
        """J per member from the checkpointed state and the control, without
        a trajectory (vch_tpu/models/lowmem.py:387-397)."""
        J1 = (b1 / 2.0) * state.j1_raw
        J2 = (b2 / 2.0) * self.space_int((state.phi_T - phi_T_target) ** 2)
        J3 = (b3 / 2.0) * torch.trapezoid(self.space_int(u ** 2), x=self.t,
                                          dim=-1)
        J4 = kappa_spar * torch.trapezoid(self.space_int(torch.abs(u)),
                                          x=self.t, dim=-1)
        return J1 + J2 + J3 + J4

    # A segment march takes (start, length, phi, mu, w, m0, u) and returns
    # (phis (B, length+1, ...) from the segment-start state on, phi, mu, w
    # after the segment, newton_solves (B,)); a segment sweep takes (start,
    # length, phis, phi_Q_seg, p, q, r, b1) and returns (r (B, length, ...)
    # in forward order, and p, q, r at level start).

    def _segment_scan(self, start, length, phi, mu, w, m0, u):
        """The scan arm's segment march: `length` steps of the adapter
        (vch_tpu/models/lowmem.py:317-332)."""
        phis, ns = [phi], 0
        for n in range(start, start + length):
            phi, mu, w, k = self.a.forward_step(phi, mu, w, u[:, n],
                                                u[:, n + 1], self._dts[n], m0)
            phis.append(phi)
            ns = ns + k
        return torch.stack(phis, dim=1), phi, mu, w, ns

    def _segment_sweep(self, start, length, phis, phiQ_seg, p, q, r, b1):
        """The scan arm's segment sweep: the adapter's sweep step over the
        segment in reverse; dt <= 1e-14 copies the next level
        (vch_tpu/models/lowmem.py:414-422)."""
        src = phis - phiQ_seg
        rs = []
        for i in range(length - 1, -1, -1):
            if not self.dts_np[start + i] <= 1e-14:
                p, q, r = self.a.adjoint_step(
                    (p, q, r), phis[:, i], phis[:, i + 1], src[:, i],
                    src[:, i + 1], self._dts[start + i], b1)
            rs.append(r)
        return torch.stack(rs[::-1], dim=1), p, q, r

    def forward_ckpt(self, u, phi0, phi_Q, phi_T_ref=None,
                     march=None) -> LowMemState:
        """Checkpointed forward with the J1 accumulator. u (B, M+1, *space),
        phi0 and phi_T_ref (the ramp's end) (B, *space), phi_Q (B, M+1,
        *space) or None (synthesized per segment); `march` the segment march
        (default: the scan arm's) (vch_tpu/models/lowmem.py:341-384)."""
        march = march or self._segment_scan
        mu, w, m0 = self.a.init_state(phi0)
        phi = phi0
        cks = []
        j1 = phi0.new_zeros(phi0.shape[0])
        ns = torch.zeros(phi0.shape[0], dtype=torch.int64, device=phi0.device)
        for start, length in self.bounds:
            cks.append((phi, mu, w))
            phis, phi, mu, w, ns_i = march(start, length, phi, mu, w, m0, u)
            pQ = self.phiQ_seg(phi_Q, start, length + 1, phi0, phi_T_ref)
            g = self.space_int((phis - pQ) ** 2)            # (B, length+1)
            dt_seg = self._dts[start:start + length]
            j1 = j1 + torch.sum(0.5 * dt_seg * (g[:, :-1] + g[:, 1:]), dim=1)
            ns = ns + ns_i
        stack = lambda i: torch.stack([c[i] for c in cks], dim=1)
        return LowMemState(stack(0), stack(1), stack(2), phi, j1, ns)

    def adjoint_r(self, state: LowMemState, u, phi_Q, b1, b2, phi_T_target,
                  march=None, sweep=None):
        """r (B, M+1, *space) by recompute-and-sweep, segment by segment in
        reverse from the terminal solve; b1, b2 (B,); `march` and `sweep`
        the segment functions (default: the scan arm's)
        (vch_tpu/models/lowmem.py:400-455)."""
        march = march or self._segment_scan
        sweep = sweep or self._segment_sweep
        phi0 = state.ck_phi[:, 0]
        m0 = self.a.init_state(phi0)[2]
        p, q, r = self.a.terminal(state.phi_T, phi_T_target, b2)
        r_T = r
        parts_rev = []
        for idx in range(len(self.bounds) - 1, -1, -1):
            start, length = self.bounds[idx]
            phis = march(start, length, state.ck_phi[:, idx],
                         state.ck_mu[:, idx], state.ck_w[:, idx], m0, u)[0]
            pQ = self.phiQ_seg(phi_Q, start, length + 1, phi0, phi_T_target)
            r_seg, p, q, r = sweep(start, length, phis, pQ, p, q, r, b1)
            parts_rev.append(r_seg)
        return torch.cat(list(reversed(parts_rev)) + [r_T[:, None]], dim=1)


def _one_member_r(pipe, u, initial_phi, b1, b2, phi_Q, phi_T_target):
    """The scan arm's adjoint r (M+1, *space) of one member from its
    control u (M+1, *space), with phi_Q and phi_T_target zero where None
    (vch_tpu/models/lowmem.py:481-498, :654-669)."""
    s = pipe.solver
    dev = s.dts.device
    as_t = lambda a: as_tensor(a, pipe.dtype, dev)
    phi0 = as_t(s.default_initial_phi() if initial_phi is None
                else initial_phi)
    u = as_t(u)
    if tuple(u.shape) != (s.M + 1,) + tuple(phi0.shape):
        raise ValueError(f"u must be (M+1, *space) = "
                         f"{(s.M + 1,) + tuple(phi0.shape)}; got "
                         f"{tuple(u.shape)}")
    phi_Q = torch.zeros_like(u) if phi_Q is None else as_t(phi_Q)
    phi_T_target = (torch.zeros_like(phi0) if phi_T_target is None
                    else as_t(phi_T_target))
    b = lambda v: torch.full((1,), float(v), dtype=pipe.dtype, device=dev)
    state = pipe.core.forward_ckpt(u[None], phi0[None], phi_Q[None])
    return pipe.core.adjoint_r(state, u[None], phi_Q[None], b(b1), b(b2),
                               phi_T_target[None])[0]


class LowMemPipeline2D:
    """The solvers and the segment schedule of the 2D low-memory path on
    one device, device=None being the CUDA card
    (vch_tpu/models/lowmem.py:458-498)."""

    def __init__(self, config: Optional[ForwardSolverConfig2D] = None,
                 K: int = 10, device=None):
        self.solver = ForwardSolver2D(config, device=device)
        self.adjoint = AdjointSolver2D(self.solver.config, device=device)
        self.config = self.solver.config
        self.dtype = self.solver.dtype
        s = self.solver
        self.core = _LowMemCore(s.dts_np, K, s.t_hist, s.x, s.y, self.dtype,
                                s.dts.device, _Adapter2D(s, self.adjoint))
        self.K = self.core.K
        self.S = self.core.S_full + (self.core.rem > 0)

    def adjoint_r(self, u, initial_phi=None, b1: float = 5.0,
                  b2: float = 10.0, phi_Q=None, phi_T_target=None):
        """The reference-scheme adjoint r (M+1, Nx+1, Ny+1) of one member
        under the control u, with O(M/K + K) live states, on the scan
        arm."""
        return _one_member_r(self, u, initial_phi, b1, b2, phi_Q,
                             phi_T_target)


class LowMemPipeline1D:
    """The 1D variant in core layout, on the scan arm
    (vch_tpu/models/lowmem.py:638-669)."""

    def __init__(self, config: Optional[ForwardSolverConfig1D] = None,
                 K: int = 10, device=None):
        self.solver = ForwardSolver1D(config, device=device)
        self.adjoint = AdjointSolver1D(self.solver.config, device=device)
        self.config = self.solver.config
        self.dtype = self.solver.dtype
        s = self.solver
        self.core = _LowMemCore(s.dts_np, K, s.t_hist, s.x, None, self.dtype,
                                s.dts.device, _Adapter1D(s, self.adjoint))
        self.K = self.core.K
        self.S = self.core.S_full + (self.core.rem > 0)

    def adjoint_r(self, u, initial_phi=None, b1: float = 0.3,
                  b2: float = 13.0, phi_Q=None, phi_T_target=None):
        """The adjoint r (M+1, N+1) of one member under the control u."""
        return _one_member_r(self, u, initial_phi, b1, b2, phi_Q,
                             phi_T_target)


class FusedLowMemBatch2D:
    """The fused arm: `_LowMemCore`'s schedule with each K-step segment one
    segment-march launch and, in the adjoint, one segment-adjoint launch
    (vch_tpu/models/lowmem.py:501-635). Live trajectory memory: the S
    checkpoints plus one segment of K+1 frames."""

    def __init__(self, pipe: LowMemPipeline2D):
        self.pipe = pipe
        self.core = pipe.core
        self.solver = pipe.solver
        self.adjoint = pipe.adjoint

    def _march(self, start, length, phi, mu, w, m0, u):
        hist, phi_f, mu_f, w_f, ns, _bad = self.solver.march_segment(
            start, length, phi.contiguous(), mu.contiguous(), w.contiguous(),
            m0.reshape(-1), u[:, start:start + length + 1].contiguous())
        return torch.cat([phi[:, None], hist], dim=1), phi_f, mu_f, w_f, ns

    def _sweep(self, start, length, phis, phiQ_seg, p, q, r, b1):
        return self.adjoint.adjoint_segment(start, length, phis,
                                            phiQ_seg.contiguous(), p, q, r,
                                            b1)

    def forward(self, u, phi0, phi_Q, phi_T_ref):
        """Checkpointed forward with the J1 accumulator. u (B, M+1, n, m),
        phi0 and phi_T_ref (B, n, m), phi_Q (B, M+1, n, m) or None.
        Returns (LowMemState, newton_solves (B,))."""
        state = self.core.forward_ckpt(u, phi0, phi_Q, phi_T_ref,
                                       march=self._march)
        return state, state.newton_solves

    def adjoint_r(self, state: LowMemState, u, phi_Q, b1, b2, phi_T_target):
        """r (B, M+1, n, m) by recompute-and-sweep on the segment kernels."""
        return self.core.adjoint_r(state, u, phi_Q, b1, b2, phi_T_target,
                                   march=self._march, sweep=self._sweep)
