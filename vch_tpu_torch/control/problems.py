"""The single-scenario control problems (vch_tpu/control/problems.py): the
reference programs GD2_configured.py (2D) and GD_1D.py (1D) as objects, each
with the uncontrolled baseline trajectory, the targets, and the forward,
adjoint and cost callables handed to ProximalGradientLoop. The 1D problem
works in the reference's history layout (a duplicated t = 0 row), so its
cost trajectory compares directly with a reference run; its exact-gradient
mode works in the core layout.

gradient_mode "reference" takes the reference's approximate adjoint r;
"exact" the exact gradient of the discrete smooth cost
(models/adjoint_exact1d.py, adjoint_exact2d.py) under
`PGDSettings.defaults_exact`, which never keeps an ascent step.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vch_tpu_torch.config import (ForwardSolverConfig1D,
                                  ForwardSolverConfig2D, OptimizationConfig,
                                  PGDSettings)
from vch_tpu_torch.control.cost import calculate_cost_1d, calculate_cost_2d
from vch_tpu_torch.control.diagnostics import (
    approximate_second_order_condition, verify_sparsity_condition)
from vch_tpu_torch.control.pgd import PGDResult, ProximalGradientLoop
from vch_tpu_torch.control.targets import build_targets_1d, build_targets_2d
from vch_tpu_torch.device import as_tensor, resolve_device, to_numpy
from vch_tpu_torch.models.adjoint1d import AdjointSolver1D
from vch_tpu_torch.models.adjoint2d import AdjointSolver2D
from vch_tpu_torch.models.adjoint_exact1d import ExactAdjoint1D
from vch_tpu_torch.models.adjoint_exact2d import ExactAdjoint2D
from vch_tpu_torch.models.forward1d import ForwardSolver1D
from vch_tpu_torch.models.forward2d import ForwardSolver2D


class _NewtonCounter:
    """`newton_solves`, the forward Newton linear solves of every march the
    problem ran, held on the problem's device: a march adds its counts
    there without a host read, and reading the property is the one sync."""

    @property
    def newton_solves(self) -> int:
        return int(self._newton_solves)

    @newton_solves.setter
    def newton_solves(self, value: int):
        self._newton_solves = torch.tensor(int(value), dtype=torch.int64,
                                           device=self.device)

    def _count_solves(self, ns: torch.Tensor):
        self._newton_solves += ns.sum()


def _check_gradient_mode(gradient_mode: str):
    if gradient_mode not in ("reference", "exact"):
        raise ValueError(f"gradient_mode must be 'reference' or 'exact', "
                         f"got {gradient_mode!r}")


class ControlProblem2D(_NewtonCounter):
    """Sparse optimal control of the 2D vCH system (ref: GD2_configured.py)
    on one device (device=None: the CUDA card).

    The baseline trajectory comes from the per-step marcher. Each
    line-search trial's forward solve runs, as vch_tpu routes it on the TPU
    (problems.py:74-82), as the whole-march kernel at B = 1 on a CUDA device
    when the float32 fixed-trip path fits its rule, else the per-step
    marcher; the gradient is the per-step adjoint sweep's r, or with
    gradient_mode "exact" the exact gradient (models/adjoint_exact2d.py,
    plain PyTorch as in vch_tpu: its own march and reverse sweep, no
    kernel) under `PGDSettings.defaults_exact`; 2D has no layout quirk, so
    both modes share one frame. `newton_solves` counts the forward Newton
    linear solves of every march the problem ran, the exact gradient's own
    march not included.
    """

    def __init__(self, fwd_config: Optional[ForwardSolverConfig2D] = None,
                 opt_config: Optional[OptimizationConfig] = None,
                 choice_t: int = 1, choice_q: int = 1,
                 initial_phi: Optional[np.ndarray] = None,
                 gradient_mode: str = "reference", device=None):
        _check_gradient_mode(gradient_mode)
        device = resolve_device(device)
        self.gradient_mode = gradient_mode
        self.fwd_config = fwd_config or ForwardSolverConfig2D()
        self.opt_config = opt_config or OptimizationConfig.defaults_2d()
        self.device = device
        self.solver = ForwardSolver2D(self.fwd_config, device=device)
        self.adjoint = AdjointSolver2D(self.fwd_config, device=device)
        self.dtype = dtype = self.solver.dtype
        as_t = lambda a: as_tensor(a, dtype, device)
        self.phi0 = (self.solver.default_initial_phi() if initial_phi is None
                     else to_numpy(initial_phi).astype(np.float64))
        self._phi0_dev = as_t(self.phi0)

        phi_hist, (x, y), t_hist = self.solver.simulate(initial_phi=self.phi0)
        self.newton_solves = self.solver.last_stats.newton_solves
        self.phi_hist0 = phi_hist
        self.x, self.y, self.t_hist = x, y, t_hist
        self._dts = as_t(np.diff(t_hist))
        cfg = self.fwd_config
        # the ramp starts from phi0 as the solver holds it (float32 rounded
        # in a float32 problem), as vch_tpu builds it
        phi_T, phi_Q = build_targets_2d(
            x, y, t_hist, phi_hist[0].cpu().numpy(), float(cfg.Lx),
            float(cfg.Ly), float(cfg.T), choice_t=choice_t,
            choice_q=choice_q)
        self.phi_T_target = as_t(phi_T)
        self.phi_Q_target = as_t(phi_Q)
        self._x, self._y, self._t = as_t(x), as_t(y), as_t(t_hist)
        self._fused = (device.type == "cuda"
                       and self.solver.fused_march_available())
        exact = gradient_mode == "exact"
        if exact:
            self._exact = ExactAdjoint2D(self.fwd_config, device=device)
        self.loop = ProximalGradientLoop(
            self._forward, self._adjoint_exact if exact else self._adjoint_r,
            self._cost, self.opt_config,
            settings=(PGDSettings.defaults_exact() if exact
                      else PGDSettings.defaults_2d()),
            error_norms=self.error_norms, adjoint_takes_u=exact)

    def _forward_batch(self, u, active=None):
        """Trajectories of the controls u (D, M+1, Nx+1, Ny+1) from phi0.
        `active` (D,) bool: the members that march (the fused line search's
        trial slots); the others' trajectories are unspecified."""
        if self._fused:
            phi0 = self._phi0_dev.expand(u.shape[0], -1, -1).contiguous()
            phi, ns, _ = self.solver.march_fused_batch(
                u.contiguous(), phi0,
                active=None if active is None else active.to(torch.int32))
            self._count_solves(ns)
            return phi
        out = []
        for i, u_i in enumerate(u):
            phi, ns, _ = self.solver._march_batch(
                u_i[None], self._phi0_dev[None],
                active=None if active is None else active[i:i + 1])
            self._count_solves(ns)
            out.append(phi[0])
        return torch.stack(out)

    def _forward(self, u, active=None):
        return self._forward_batch(
            u[None], None if active is None else active.reshape(1))[0]

    def _adjoint_r(self, phi_hist):
        """The adjoint's r of a trajectory."""
        opt = self.opt_config
        _, _, r = self.adjoint._run_impl(phi_hist, self._dts, opt.b1, opt.b2,
                                         self.phi_Q_target, self.phi_T_target)
        return r

    def _adjoint_exact(self, phi_hist, u):
        """The exact gradient density less b3 u, which the loop adds back
        (vch_tpu/control/problems.py:88-93)."""
        opt = self.opt_config
        g, _ = self._exact._grad(u, self._phi0_dev, opt.b1, opt.b2, opt.b3,
                                 self.phi_Q_target, self.phi_T_target)
        return g - opt.b3 * u

    def _cost(self, phi_hist, u):
        opt = self.opt_config
        return calculate_cost_2d(phi_hist, u, self.phi_Q_target,
                                 self.phi_T_target, self._x, self._y, self._t,
                                 opt.b1, opt.b2, opt.b3, opt.kappa_sparsity)

    def error_norms(self, phi_hist):
        """(relative tracking error over space-time, relative terminal
        error) of a trajectory."""
        x, y, t = self._x, self._y, self._t

        def sp(a):
            return torch.trapezoid(torch.trapezoid(a, x=y, dim=-1), x=x,
                                   dim=-1)

        def l2_xt(A):
            return torch.sqrt(torch.trapezoid(sp(A ** 2), x=t, dim=-1))

        xh, yh, th = self.x, self.y, self.t_hist
        rms_scale = float(np.sqrt(max((xh[-1] - xh[0]) * (yh[-1] - yh[0]),
                                      1e-30) * max(th[-1] - th[0], 1e-30)))
        numQ = l2_xt(phi_hist - self.phi_Q_target)
        denQ = l2_xt(self.phi_Q_target)
        denQ = torch.where(denQ < 1e-9 * rms_scale,
                           torch.full_like(denQ, rms_scale), denQ)
        rel_track = numQ / (denQ + 1e-12)
        numT = torch.sqrt(sp((phi_hist[..., -1, :, :]
                              - self.phi_T_target) ** 2))
        denT = torch.sqrt(sp(self.phi_T_target ** 2)) + 1e-12
        return rel_track, numT / denT

    def initial_control(self):
        return torch.zeros_like(self.phi_hist0)

    def optimize(self, max_iter: Optional[int] = None,
                 verbose: bool = True) -> PGDResult:
        return self.loop.run(self.initial_control(), self.phi_hist0,
                             max_iter=max_iter, verbose=verbose)

    def verify_sparsity(self, result, verbose: bool = True):
        return verify_sparsity_condition(result.u_optimal, result.r_optimal,
                                         self.opt_config.kappa_sparsity,
                                         verbose=verbose)

    def second_order_check(self, result, num_directions: int = 5,
                           epsilon: float = 1e-4, seed: int = 42):
        """Batched FD coercivity probe (2D cone: bound activity only,
        ref second_order_conditions_2d.py:35-88)."""
        opt = self.opt_config
        return approximate_second_order_condition(
            None, self._cost, result.u_optimal,
            result.r_optimal, result.phi_final, opt.b3, opt.kappa_sparsity,
            opt.u_min, opt.u_max, num_directions=num_directions,
            epsilon=epsilon, seed=seed, handle_kink=False, dtype=self.dtype,
            device=self.device, forward_batch=self._forward_batch)


class ControlProblem1D(_NewtonCounter):
    """Sparse optimal control of the 1D vCH system (ref: GD_1D.py) on one
    device (device=None: the CUDA card), in the reference layout: the
    baseline, the controls and the targets carry M + 2 rows, the t = 0 row
    duplicated (vch_tpu/control/problems.py:163-305).

    Every forward solve is the per-step marcher of one member and the
    gradient the per-step adjoint sweep's r: as in vch_tpu this problem runs
    no kernel. gradient_mode "exact" takes the exact gradient
    (models/adjoint_exact1d.py) under `PGDSettings.defaults_exact` and works
    in the core layout (M + 1 rows, no duplicated row), the targets built
    on the core time grid: the reference frame reads u_ref[k] at t_k in its
    dynamics and places it at t_{k-1} in its cost quadrature, which makes
    the exact gradient ill-posed at the edge rows
    (vch_tpu/control/problems.py:207-236). `newton_solves` counts the
    forward Newton linear solves of every march the problem ran, the exact
    gradient's own march not included.
    """

    def __init__(self, fwd_config: Optional[ForwardSolverConfig1D] = None,
                 opt_config: Optional[OptimizationConfig] = None,
                 choice_t: int = 1, choice_q: int = 1,
                 initial_phi: Optional[np.ndarray] = None,
                 gradient_mode: str = "reference", device=None):
        _check_gradient_mode(gradient_mode)
        device = resolve_device(device)
        self.gradient_mode = gradient_mode
        self.fwd_config = cfg = fwd_config or ForwardSolverConfig1D()
        self.opt_config = opt_config or OptimizationConfig()
        self.device = device
        self.solver = ForwardSolver1D(cfg, device=device)
        self.adjoint = AdjointSolver1D(cfg, device=device)
        self.dtype = dtype = self.solver.dtype
        as_t = lambda a: as_tensor(a, dtype, device)
        self.phi0 = (self.solver.default_initial_phi() if initial_phi is None
                     else to_numpy(initial_phi).astype(np.float64))
        self._phi0_dev = as_t(self.phi0)

        # the uncontrolled baseline in reference layout
        phi_hist, x, t_hist = self.solver.simulate(initial_phi=self.phi0,
                                                   ref_layout=True)
        self.newton_solves = self.solver.last_stats.newton_solves
        self._dts = as_t(np.diff(t_hist))
        exact = gradient_mode == "exact"
        if exact:
            # the core layout: the baseline and the time grid without
            # their duplicated t = 0 entry (the march vch_tpu runs once
            # more), the targets on the core grid
            self._exact = ExactAdjoint1D(cfg, device=device)
            phi_hist, t_hist = phi_hist[1:], t_hist[1:]
        self.phi_hist0 = phi_hist
        self.x, self.t_hist = x, t_hist
        phi_T, phi_Q = build_targets_1d(
            x, t_hist, phi_hist[0].cpu().numpy(), float(cfg.Lx), float(cfg.T),
            choice_t=choice_t, choice_q=choice_q)
        self.phi_T_target = as_t(phi_T)
        self.phi_Q_target = as_t(phi_Q)
        self._x, self._t = as_t(x), as_t(t_hist)
        self.loop = ProximalGradientLoop(
            self._forward, self._adjoint_exact if exact else self._adjoint_r,
            self._cost, self.opt_config,
            settings=(PGDSettings.defaults_exact() if exact
                      else PGDSettings.defaults_1d()),
            error_norms=self.error_norms, adjoint_takes_u=exact)

    def _forward_batch(self, u, active=None):
        """Trajectories of the controls u (D, rows, N+1) from phi0, in the
        problem's layout: in the reference layout (M + 2 rows) the duplicate
        control row dropped for the march and the duplicate history row
        added; in the exact mode's core layout (M + 1 rows) as marched.
        `active` (D,) bool: the members that march; the others'
        trajectories are unspecified."""
        M = self.solver.M
        phi0 = self._phi0_dev.expand(u.shape[0], -1)
        phi, ns, _ = self.solver._march_batch(u[:, : M + 1], phi0, active)
        self._count_solves(ns)
        if self.gradient_mode == "exact":
            return phi
        return torch.cat([phi[:, :1], phi], dim=1)

    def _forward(self, u_ref, active=None):
        return self._forward_batch(
            u_ref[None], None if active is None else active.reshape(1))[0]

    def _adjoint_r(self, phi_ref):
        """The adjoint's r of a trajectory in the reference layout."""
        opt = self.opt_config
        _, _, r = self.adjoint._run_impl(phi_ref, self._dts, opt.b1, opt.b2,
                                         self.phi_Q_target, self.phi_T_target)
        return r

    def _adjoint_exact(self, phi_core, u_core):
        """The exact gradient density less b3 u, which the loop adds back
        (vch_tpu/control/problems.py:231-235)."""
        opt = self.opt_config
        g, _ = self._exact._grad(u_core, self._phi0_dev, opt.b1, opt.b2,
                                 opt.b3, self.phi_Q_target,
                                 self.phi_T_target)
        return g - opt.b3 * u_core

    def _cost(self, phi_ref, u_ref):
        opt = self.opt_config
        return calculate_cost_1d(phi_ref, u_ref, self.phi_Q_target,
                                 self.phi_T_target, self._x, self._t, opt.b1,
                                 opt.b2, opt.b3, opt.kappa_sparsity)

    def error_norms(self, phi_ref):
        """(relative tracking error over space-time, relative terminal
        error) of a trajectory."""
        x, t = self._x, self._t

        def l2_x(a):
            return torch.sqrt(torch.trapezoid(a ** 2, x=x, dim=-1))

        def l2_xt(A):
            return torch.sqrt(torch.trapezoid(
                torch.trapezoid(A ** 2, x=x, dim=-1), x=t, dim=-1))

        xh, th = self.x, self.t_hist
        rms_scale = float(np.sqrt(max(xh[-1] - xh[0], 1e-30)
                                  * max(th[-1] - th[0], 1e-30)))
        numQ = l2_xt(phi_ref - self.phi_Q_target)
        denQ = l2_xt(self.phi_Q_target)
        denQ = torch.where(denQ < 1e-9 * rms_scale,
                           torch.full_like(denQ, rms_scale), denQ)
        rel_track = numQ / (denQ + 1e-12)
        numT = l2_x(phi_ref[..., -1, :] - self.phi_T_target)
        denT = l2_x(self.phi_T_target) + 1e-12
        return rel_track, numT / denT

    def initial_control(self):
        return torch.zeros_like(self.phi_hist0)

    def optimize(self, max_iter: Optional[int] = None,
                 verbose: bool = True) -> PGDResult:
        return self.loop.run(self.initial_control(), self.phi_hist0,
                             max_iter=max_iter, verbose=verbose)

    def verify_sparsity(self, result, verbose: bool = True):
        return verify_sparsity_condition(result.u_optimal, result.r_optimal,
                                         self.opt_config.kappa_sparsity,
                                         verbose=verbose)

    def second_order_check(self, result, num_directions: int = 3,
                           epsilon: float = 1e-4, seed: int = 42):
        """Batched FD coercivity probe (1D cone: handles the L1 kink, ref
        second_order_conditions.py:33-55)."""
        opt = self.opt_config
        return approximate_second_order_condition(
            None, self._cost, result.u_optimal,
            result.r_optimal, result.phi_final, opt.b3, opt.kappa_sparsity,
            opt.u_min, opt.u_max, num_directions=num_directions,
            epsilon=epsilon, seed=seed, handle_kink=True, dtype=self.dtype,
            device=self.device, forward_batch=self._forward_batch)
