"""Proximal gradient descent (ISTA) loop of the single-scenario problems,
with the optimistic step, the backtracking line search, plateau detection
and the alpha advisor (vch_tpu/control/pgd.py:121-376).

Two search modes, as vch_tpu's. "host" (the default): each trial (prox,
forward solve, cost) is one call, and its cost comes back to the host to
decide the next. "fused": the whole search runs on the device with no host
read (`optimistic_backtracking_search`, vch_tpu's while_loop as a fixed run
of trial slots under a per-member mask), and an iteration ends in one host
read of its scalars. Semantics as vch_tpu's:
  - the optimistic trial at alpha_prev; on failure backtracking from
    ls_alpha_factor * alpha_prev, times ls_beta per trial, at most
    ls_max_trials; when every trial fails the last (worse) iterate is kept,
    alpha already times beta (keep_failed_step);
  - alpha_prev <- min(alpha_max, 1.2 alpha), or plateau_boost times alpha
    after plateau_length iterations within plateau_tolerance;
  - convergence: relative control change below conv_tol after more than
    conv_min_iter iterations;
  - the alpha advisor: the mean of the successful optimistic alphas from
    advisor_start_iter on;
  - the phase timers backward_total, optimistic_eval_total,
    line_search_total and successful_step_total, each closed by a device
    synchronization.
The fused mode differs from the host mode where vch_tpu's does
(vch_tpu/control/pgd.py:240-260, :353): it never reads keep_failed_step
(every trial failing, it keeps the last, worse trial even under
`PGDSettings.defaults_exact()`), prints no time study and leaves the four
phase timers at 0.
"""
from __future__ import annotations

import inspect
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from vch_tpu_torch.config import OptimizationConfig, PGDSettings
from vch_tpu_torch.control.prox import calculate_gradient, proximal_step


@dataclass
class PGDResult:
    u_optimal: np.ndarray
    r_optimal: np.ndarray
    phi_final: np.ndarray
    cost_history: list
    alpha_history: list
    tracking_err_history: list
    terminal_err_history: list
    iterations: int
    converged: bool
    timers: dict
    ls_trials_per_iter: list
    advisor_alpha: Optional[float] = None
    plateau_boosts: int = 0


def _sync(t: torch.Tensor):
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _where(mask, a, b):
    """torch.where with a per-member mask (0-d or (B,)) over a's trailing
    axes."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim())),
                       a, b)


def optimistic_backtracking_search(trial, cost_k, alpha_prev, s: PGDSettings):
    """One PGD step-size search on the device: the optimistic trial at
    alpha_prev, then backtracking (vch_tpu/control/pgd.py:76-118), with no
    host read.

    trial(alpha, active) -> (u, phi, cost): alpha a float64 tensor of
    cost_k's shape, active a bool tensor of that shape, the members still
    searching; the trial may skip the others, whose results are masked out.
    cost_k: a 0-d tensor, or (B,) for the semantics of jax.vmap of
    vch_tpu's search (each member its own predicate; a member that has
    finished holds its state). alpha_prev: a number or a tensor of cost_k's
    shape.

    vch_tpu's while_loop becomes exactly 1 + s.ls_max_trials trial slots,
    enqueued without a host read; slot j runs at
        alpha_0 = alpha_prev                         (optimistic step)
        alpha_j = alpha_prev * f * beta^(j-1), j>=1  (backtracking)
    for the members whose earlier trials all failed, and a mask selects the
    accepted trial. Alpha stays in float64 and the test is c_t < cost_k on
    the trial's own values, as in the host mode, so both modes walk the
    same trials. Returns device tensors (alpha_k float64, u1, phi1, c1,
    n_trials int32, optimistic_ok bool): the accepted trial and its alpha;
    when every trial fails, the last trial with alpha already times beta.
    """
    dev = cost_k.device
    f64 = torch.float64
    if torch.is_tensor(alpha_prev):
        alpha0 = alpha_prev.to(dev, f64).expand(cost_k.shape)
    else:
        alpha0 = torch.full(cost_k.shape, float(alpha_prev), dtype=f64,
                            device=dev)
    alpha = alpha0
    ok = torch.zeros(cost_k.shape, dtype=torch.bool, device=dev)
    n_trials = torch.zeros(cost_k.shape, dtype=torch.int32, device=dev)
    for j in range(1 + s.ls_max_trials):
        active = ~ok
        u_t, phi_t, c_t = trial(alpha, active)
        ok_t = c_t < cost_k
        nxt = alpha0 * s.ls_alpha_factor if j == 0 else alpha * s.ls_beta
        report = torch.where(ok_t, alpha, nxt)
        if j == 0:      # every member runs the optimistic trial
            u1, phi1, c1, alpha_k = u_t, phi_t, c_t, report
        else:
            u1, phi1 = _where(active, u_t, u1), _where(active, phi_t, phi1)
            c1 = torch.where(active, c_t, c1)
            alpha_k = torch.where(active, report, alpha_k)
        ok = ok | (active & ok_t)
        n_trials = n_trials + active
        alpha = torch.where(active, nxt, alpha)
    return alpha_k, u1, phi1, c1, n_trials, ok & (n_trials == 1)


class ProximalGradientLoop:
    """Dimension-agnostic PGD engine over callables on tensors:

    forward:  u -> phi_hist
    adjoint:  phi_hist -> r, or (phi_hist, u) -> r with adjoint_takes_u
              (the exact gradient's, which reads u; vch_tpu's contract,
              vch_tpu/control/pgd.py:141, 152)
    cost:     (phi_hist, u) -> 0-d tensor
    error_norms: optional phi_hist -> (rel_tracking, rel_terminal)
    norm:     optional u -> 0-d tensor, the 2-norm of the relative control
              change (default torch.linalg.norm; the grid-sharded problem
              passes one all-reduced over the ranks' row blocks)

    search_mode "host" drives the search from the host; "fused" runs it on
    the device (`optimistic_backtracking_search`) and reads the iteration's
    scalars once at its end. In the fused mode the trial passes the
    members still searching to the forward when the forward declares an
    `active` parameter (`forward(u, active=...)`, a 0-d bool tensor), so an
    idle trial slot marches nothing; a forward that does not runs every
    slot in full, and the mask still gives vch_tpu's result, with more
    work.
    """

    def __init__(self, forward: Callable, adjoint: Callable, cost: Callable,
                 opt_config: OptimizationConfig,
                 settings: Optional[PGDSettings] = None,
                 error_norms: Optional[Callable] = None,
                 search_mode: str = "host", adjoint_takes_u: bool = False,
                 norm: Optional[Callable] = None):
        if search_mode not in ("host", "fused"):
            raise ValueError(f"search_mode must be 'host' or 'fused', got "
                             f"{search_mode!r}")
        self.forward = forward
        self.adjoint = adjoint
        self.cost = cost
        self.opt = opt_config
        self.s = settings or PGDSettings()
        self.error_norms = error_norms
        self.search_mode = search_mode
        self.adjoint_takes_u = adjoint_takes_u
        self.norm = norm or torch.linalg.norm
        try:
            params = inspect.signature(forward).parameters
        except (TypeError, ValueError):
            params = {}
        self._forward_takes_active = "active" in params

    def _adjoint_grad(self, phi_k, u_k):
        """r and the gradient r + b3 u of the iterate (phi_k, u_k)."""
        r_k = (self.adjoint(phi_k, u_k) if self.adjoint_takes_u
               else self.adjoint(phi_k))
        return r_k, calculate_gradient(r_k, u_k, self.opt.b3)

    def _trial(self, u_k, grad):
        """The trial(alpha, active=None) -> (u, phi, cost) of the iterate
        u_k and its gradient; active reaches a forward that declares it."""
        opt = self.opt

        def trial(alpha, active=None):
            u_t = proximal_step(u_k, grad, alpha, opt.kappa_sparsity,
                                opt.u_min, opt.u_max)
            phi_t = (self.forward(u_t) if active is None
                     or not self._forward_takes_active
                     else self.forward(u_t, active=active))
            return u_t, phi_t, self.cost(phi_t, u_t)
        return trial

    def _iteration_host(self, u_k, phi_k, cost_k, alpha_prev, timers: dict):
        """One iteration: the adjoint and the gradient, then the optimistic
        and backtracking trials (vch_tpu/control/pgd.py:197-238; the
        adjoint's call :171-177). cost_k and the cost returned twice (the
        history's and the next iteration's) are numbers."""
        s = self.s
        t0 = time.perf_counter()
        r_k, grad = self._adjoint_grad(phi_k, u_k)
        _sync(grad)
        timers["backward_total"] += time.perf_counter() - t0
        trial = self._trial(u_k, grad)
        max_trials = 1 + s.ls_max_trials
        alpha = alpha_prev
        j = 0
        while True:
            tt = time.perf_counter()
            u_t, phi_t, c_t = trial(alpha)
            c = float(c_t)
            trial_time = time.perf_counter() - tt
            j += 1
            ok = c < cost_k
            timers["optimistic_eval_total" if j == 1
                   else "line_search_total"] += trial_time
            if ok:
                timers["successful_step_total"] += trial_time
            nxt = (alpha_prev * s.ls_alpha_factor if j == 1
                   else alpha * s.ls_beta)
            alpha_report = alpha if ok else nxt
            if ok or j >= max_trials:
                break
            alpha = nxt
        if not ok and not s.keep_failed_step:
            u_t, phi_t, c = u_k, phi_k, cost_k     # reject the ascent step
        opt_ok = ok and j == 1
        change = float(self.norm(u_t - u_k) / (self.norm(u_k) + 1e-9))
        errs = ((0.0, 0.0) if self.error_norms is None
                else tuple(float(e) for e in self.error_norms(phi_t)))
        return u_t, phi_t, c, c, alpha_report, r_k, j, change, opt_ok, errs

    def _iteration_fused(self, u_k, phi_k, cost_k, alpha_prev, timers: dict):
        """One iteration on the device (vch_tpu/control/pgd.py:240-260): the
        adjoint and the gradient, the search, the change and the error
        norms, then one host read of their scalars. cost_k and the next
        iteration's cost are 0-d device tensors; the history's cost is a
        number. Reads no timer and keep_failed_step."""
        r_k, grad = self._adjoint_grad(phi_k, u_k)
        alpha_k, u_1, phi_1, c_1, n_trials, opt_ok = (
            optimistic_backtracking_search(self._trial(u_k, grad),
                                           cost_k, alpha_prev, self.s))
        change = self.norm(u_1 - u_k) / (self.norm(u_k) + 1e-9)
        errs = ((torch.zeros_like(alpha_k),) * 2 if self.error_norms is None
                else self.error_norms(phi_1))
        c, a, j, ch, ok, e_track, e_term = torch.stack([
            t.to(torch.float64).reshape(())
            for t in (c_1, alpha_k, n_trials, change, opt_ok) + tuple(errs)
        ]).tolist()
        return (u_1, phi_1, c, c_1, a, r_k, int(j), ch, bool(ok),
                (e_track, e_term))

    def run(self, u0: torch.Tensor, phi0_hist: torch.Tensor,
            max_iter: Optional[int] = None, verbose: bool = True) -> PGDResult:
        """PGD from the control u0 and its trajectory phi0_hist
        (vch_tpu/control/pgd.py:262-376)."""
        opt, s = self.opt, self.s
        max_iter = max_iter if max_iter is not None else opt.max_iter
        u_k, phi_k = u0, phi0_hist
        fused = self.search_mode == "fused"
        cost_k = self.cost(phi_k, u_k)
        cost_history = [float(cost_k)]
        if not fused:
            cost_k = cost_history[0]
        step = self._iteration_fused if fused else self._iteration_host
        alpha_prev = float(opt.alpha_max)
        alpha_history, track_hist, term_hist, ls_trials = [], [], [], []
        timers = {"total_optimization": 0.0, "backward_total": 0.0,
                  "line_search_total": 0.0, "optimistic_eval_total": 0.0,
                  "successful_step_total": 0.0, "iteration_total": 0.0}
        plateau_counter = plateau_boosts = 0
        successful_optimistic_alphas: list = []
        advisor_last_avg, advisor_stable = 0.0, 0
        converged = False
        r_k = torch.zeros_like(u_k)
        final_iters = max_iter
        t_start = time.perf_counter()
        for k in range(max_iter):
            it0 = time.perf_counter()
            (u_1, phi_1, c_1, cost_1, alpha_k, r_k, n_trials, change, opt_ok,
             (e_track, e_term)) = step(u_k, phi_k, cost_k, alpha_prev,
                                       timers)
            timers["iteration_total"] += time.perf_counter() - it0
            cost_history.append(c_1)
            alpha_history.append(alpha_k)
            track_hist.append(e_track)
            term_hist.append(e_term)
            ls_trials.append(n_trials)

            if opt_ok and k >= s.advisor_start_iter:
                successful_optimistic_alphas.append(alpha_prev)
                if len(successful_optimistic_alphas) > 10:
                    cur_avg = float(np.mean(successful_optimistic_alphas))
                    if np.isclose(cur_avg, advisor_last_avg, rtol=1e-3):
                        advisor_stable += 1
                    else:
                        advisor_stable = 0
                    advisor_last_avg = cur_avg
                    if advisor_stable >= 50 and k % 10 == 0 and verbose:
                        print(f"[LIVE ADVISOR] Stable average alpha "
                              f"{cur_avg:.4f} found — consider restarting "
                              f"with it as alpha_max.")

            if (k > 0 and abs(cost_history[-1] - cost_history[-2])
                    < s.plateau_tolerance):
                plateau_counter += 1
            else:
                plateau_counter = 0
            if plateau_counter >= s.plateau_length:
                if verbose:
                    print(f"[Notice] Cost plateaued for {plateau_counter} "
                          f"iterations. Boosting learning rate.")
                alpha_prev = min(opt.alpha_max, alpha_k * s.plateau_boost)
                plateau_counter = 0
                plateau_boosts += 1
            else:
                alpha_prev = min(opt.alpha_max, alpha_k * 1.2)

            if verbose:
                print(f"iter {k+1:4d} | cost {c_1:.6f} | alpha {alpha_k:.4f} "
                      f"| trials {n_trials} | rel-du {change:.3e}")
            u_k, phi_k, cost_k = u_1, phi_1, cost_1
            if change < s.conv_tol and k > s.conv_min_iter:
                if verbose:
                    print(f"Convergence reached at iteration {k+1}.")
                converged = True
                final_iters = k + 1
                break

        timers["total_optimization"] = time.perf_counter() - t_start
        if verbose and not fused:
            tot = timers["total_optimization"]
            print("\n--- COMPUTATIONAL TIME STUDY ---")
            print(f"Total optimization time:   {tot:8.2f} s")
            for key, label in (("backward_total", "Backward (adjoint) solves"),
                               ("optimistic_eval_total", "Optimistic evals"),
                               ("line_search_total", "Backtracking searches"),
                               ("successful_step_total", "Accepted steps")):
                v = timers[key]
                pct = 100.0 * v / tot if tot > 0 else 0.0
                print(f"{label:<26} {v:8.2f} s ({pct:4.1f}%)")
            if ls_trials:
                print(f"Line-search trials: total {sum(ls_trials)}, "
                      f"mean {np.mean(ls_trials):.2f}, max {max(ls_trials)}")
        advisor = (float(np.mean(successful_optimistic_alphas))
                   if successful_optimistic_alphas else None)
        host = lambda t: t.detach().cpu().numpy()
        return PGDResult(
            u_optimal=host(u_k), r_optimal=host(r_k), phi_final=host(phi_k),
            cost_history=cost_history, alpha_history=alpha_history,
            tracking_err_history=track_hist, terminal_err_history=term_hist,
            iterations=final_iters, converged=converged, timers=timers,
            ls_trials_per_iter=ls_trials, advisor_alpha=advisor,
            plateau_boosts=plateau_boosts)
