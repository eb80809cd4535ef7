"""Segment-checkpointed (low-memory) batched 2D forward and adjoint
(vch_tpu/models/lowmem.py).

The adjoint sweep needs the whole phi trajectory, and at 256x256 with large
batches the stored history dominates device memory. The forward march keeps
only the state (phi, mu, w) at the start of each K-step segment, plus the
running tracking integral J1, and the adjoint recomputes each segment from
its checkpoint just before it sweeps it: O(M/K + K) live frames instead of
O(M). Each segment runs as one launch of the segment march kernel and one
of the segment adjoint kernel (`ops.march.march_fused_2d_segment`,
`adjoint_fused_2d_segment`), as vch_tpu's `FusedLowMemBatch2D` does.

Not ported: the scan path (`_LowMemCore._segment_scan` and its
`forward_ckpt` / `adjoint_r`) and `LowMemPipeline1D`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from vch_tpu_torch.config import ForwardSolverConfig2D
from vch_tpu_torch.models.adjoint2d import AdjointSolver2D
from vch_tpu_torch.models.forward2d import ForwardSolver2D


class LowMemState(NamedTuple):
    """What the PGD loop needs from a checkpointed forward solve, each with
    a leading batch axis B (vch_tpu/models/lowmem.py:40).

    ck_phi / ck_mu / ck_w (B, S, n, m) are the S segment-start states,
    phi_T (B, n, m) the final state, j1_raw (B,) the trapezoid-in-time
    tracking integral of (phi - phi_Q)^2 without the b1/2 factor, and
    newton_solves (B,) the measured Newton solve count.
    """

    ck_phi: torch.Tensor
    ck_mu: torch.Tensor
    ck_w: torch.Tensor
    phi_T: torch.Tensor
    j1_raw: torch.Tensor
    newton_solves: torch.Tensor


class _LowMemCore:
    """Segment bounds, procedural tracking targets and the cost from the J1
    accumulator (the parts of vch_tpu's _LowMemCore the fused arm uses).

    Segments: S_full = M // K full segments of K steps plus one tail segment
    of rem = M - S_full * K steps when rem > 0, so any dt schedule works,
    including a partial final step.
    """

    def __init__(self, dts: np.ndarray, K: int, t_hist: np.ndarray, x, y,
                 dtype: torch.dtype, device: torch.device):
        if K < 1:
            raise ValueError(f"K must be >= 1, got {K}")
        self.K = int(K)
        self.M = len(dts)
        self.S_full = self.M // self.K
        self.rem = self.M - self.S_full * self.K
        self.dts_np = np.asarray(dts, np.float64)
        self.t_np = np.asarray(t_hist, np.float64)
        self.dtype = dtype
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        self.x, self.y, self.t = as_t(x), as_t(y), as_t(self.t_np)
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
        n, m): sliced from phi_Q, or synthesized when phi_Q is None."""
        if phi_Q is not None:
            return phi_Q[:, start:start + length]
        if self.phi_Q_mode == "zeros":
            return phi0.new_zeros((phi0.shape[0], length) + phi0.shape[1:])
        if self.phi_Q_mode != "ramp":
            raise ValueError(f"unknown phi_Q_mode {self.phi_Q_mode!r}")
        tp = self._t_rel[start:start + length].reshape(1, length, 1, 1)
        return (1.0 - tp) * phi0[:, None] + tp * phi_T_ref[:, None]

    def space_int(self, v):
        """trapz over y, then x (control/cost.py's space integral)."""
        return torch.trapezoid(torch.trapezoid(v, x=self.y, dim=-1),
                               x=self.x, dim=-1)

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


class LowMemPipeline2D:
    """The solvers and the segment schedule of the 2D low-memory path on
    one device, device=None being the CUDA card
    (vch_tpu/models/lowmem.py:458-475)."""

    def __init__(self, config: Optional[ForwardSolverConfig2D] = None,
                 K: int = 10, device=None):
        self.solver = ForwardSolver2D(config, device=device)
        self.adjoint = AdjointSolver2D(self.solver.config, device=device)
        self.config = self.solver.config
        self.dtype = self.solver.dtype
        s = self.solver
        self.core = _LowMemCore(s.dts_np, K, s.t_hist, s.x, s.y, self.dtype,
                                s.dts.device)
        self.K = self.core.K
        self.S = self.core.S_full + (self.core.rem > 0)


class FusedLowMemBatch2D:
    """Batched checkpointed forward and recompute-and-sweep adjoint on the
    segment kernels (vch_tpu/models/lowmem.py:501-635): each K-step segment
    is one segment-march launch and, in the adjoint, one segment-adjoint
    launch. Live trajectory memory: the S checkpoints plus one segment of
    K+1 frames."""

    def __init__(self, pipe: LowMemPipeline2D):
        self.pipe = pipe
        self.core = pipe.core
        self.solver = pipe.solver
        self.adjoint = pipe.adjoint

    def _march(self, start, length, phi, mu, w, m0, u):
        return self.solver.march_segment(
            start, length, phi.contiguous(), mu.contiguous(), w.contiguous(),
            m0, u[:, start:start + length + 1].contiguous())

    def forward(self, u, phi0, phi_Q, phi_T_ref):
        """Checkpointed forward with the J1 accumulator. u (B, M+1, n, m),
        phi0 and phi_T_ref (B, n, m), phi_Q (B, M+1, n, m) or None.
        Returns (LowMemState, newton_solves (B,))."""
        core = self.core
        w = torch.zeros_like(phi0)
        mu = self.solver.initialize_mu(phi0, w)
        m0 = torch.sum(self.solver.wts * phi0, dim=(-2, -1))
        phi = phi0
        cks = []
        j1 = phi0.new_zeros(phi0.shape[0])
        ns = torch.zeros(phi0.shape[0], dtype=torch.int32, device=phi0.device)
        for start, length in core.bounds:
            cks.append((phi, mu, w))
            hist, phi, mu, w, ns_i, _bad = self._march(start, length, phi, mu,
                                                       w, m0, u)
            phis = torch.cat([cks[-1][0][:, None], hist], dim=1)
            pQ = core.phiQ_seg(phi_Q, start, length + 1, phi0, phi_T_ref)
            g = core.space_int((phis - pQ) ** 2)            # (B, length+1)
            dt_seg = self.solver.dts[start:start + length]
            j1 = j1 + torch.sum(0.5 * dt_seg * (g[:, :-1] + g[:, 1:]), dim=1)
            ns = ns + ns_i
        state = LowMemState(
            torch.stack([c[0] for c in cks], dim=1),
            torch.stack([c[1] for c in cks], dim=1),
            torch.stack([c[2] for c in cks], dim=1),
            phi, j1, ns)
        return state, ns

    def adjoint_r(self, state: LowMemState, u, phi_Q, b1, b2, phi_T_target):
        """r (B, M+1, n, m) by recompute-and-sweep, segment by segment in
        reverse from the terminal solve."""
        core = self.core
        phi0 = state.ck_phi[:, 0]
        m0 = torch.sum(self.solver.wts * phi0, dim=(-2, -1))
        p, q, r = self.adjoint.terminal(state.phi_T, phi_T_target, b2)
        r_T = r
        parts_rev = []
        for idx in range(len(core.bounds) - 1, -1, -1):
            start, length = core.bounds[idx]
            ck = state.ck_phi[:, idx]
            hist = self._march(start, length, ck, state.ck_mu[:, idx],
                               state.ck_w[:, idx], m0, u)[0]
            phis = torch.cat([ck[:, None], hist], dim=1)
            pQ = core.phiQ_seg(phi_Q, start, length + 1, phi0, phi_T_target)
            r_seg, p, q, r = self.adjoint.adjoint_segment(
                start, length, phis, pQ.contiguous(), p, q, r, b1)
            parts_rev.append(r_seg)
        return torch.cat(list(reversed(parts_rev)) + [r_T[:, None]], dim=1)
