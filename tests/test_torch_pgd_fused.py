"""Port parity for the fused line search: `vch_tpu_torch.control.pgd`'s
`optimistic_backtracking_search` and `ProximalGradientLoop(search_mode=
"fused")` against vch_tpu's fused mode on the CPU, and the `active` member
mask of the marchers the fused search drives.

Tolerances, each beside its case:
  - the search on toy trials (float64): exact. The toy trials are
    products and differences only (no a * b + c, which XLA may contract
    into one FMA), which both packages round alike, and the search's own
    arithmetic (alpha in float64, the test c_t < cost_k) is vch_tpu's.
  - config 1 (float64): costs 5e-9 relative, the golden-run bound of
    tests/test_torch_control1d.py (the two packages' marches differ by
    ~5e-12 and PGD amplifies it); trials and alphas exactly equal (alpha
    depends only on the trial counts).
  - the 2D problem at 16 x 16, T = 0.1: float64 1e-10 relative, float32
    2e-5 relative (the bound of tests/test_torch_control2d.py: float32
    sums in another order); trials equal. alpha_max is 1e4: at 2000 every
    trial of the first four iterations succeeds, at 1e4 iterations 3 and 4
    fail all eleven trials.
  - the port's fused mode against its host mode (float64): bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vch_tpu.config import ForwardSolverConfig2D as JaxConfig2D
from vch_tpu.config import OptimizationConfig as JaxOpt
from vch_tpu.control.pgd import PGDSettings as JaxSettings
from vch_tpu.control.pgd import ProximalGradientLoop as JaxLoop
from vch_tpu.control.pgd import \
    optimistic_backtracking_search as jax_search
from vch_tpu.control.problems import ControlProblem1D as JaxProblem1D
from vch_tpu.control.problems import ControlProblem2D as JaxProblem2D

from vch_tpu_torch.config import (ForwardSolverConfig1D,
                                  ForwardSolverConfig2D, OptimizationConfig,
                                  PGDSettings)
from vch_tpu_torch.control.pgd import (ProximalGradientLoop,
                                       optimistic_backtracking_search)
from vch_tpu_torch.control.problems import ControlProblem1D, ControlProblem2D
from vch_tpu_torch.models.forward1d import ForwardSolver1D
from vch_tpu_torch.models.forward2d import ForwardSolver2D
from vch_tpu_torch.ops import march as km
from vch_tpu_torch.utils.convert import config_from_vch_tpu

torch.set_num_threads(2)


def _jax_fused(loop):
    """vch_tpu's loop of a problem with only search_mode changed."""
    return JaxLoop(loop.forward, loop.adjoint, loop.cost, loop.opt,
                   settings=loop.s, error_norms=loop.error_norms,
                   search_mode="fused", adjoint_takes_u=loop.adjoint_takes_u)


def _fused(loop, settings=None):
    """The port's loop of a problem with only search_mode changed."""
    return ProximalGradientLoop(loop.forward, loop.adjoint, loop.cost,
                                loop.opt, settings=settings or loop.s,
                                error_norms=loop.error_norms,
                                search_mode="fused",
                                adjoint_takes_u=loop.adjoint_takes_u)


# ---- (i) the search on toy analytic trials ------------------------------

def _toy_inputs(seed, B=None):
    rng = np.random.default_rng(seed)
    shape = (5,) if B is None else (B, 5)
    return rng.standard_normal(shape), rng.standard_normal(shape)


def _port_search(v, w, a_star, cost_k, alpha_prev, s):
    tv, tw, ta = (torch.as_tensor(x, dtype=torch.float64)
                  for x in (v, w, a_star))
    seen = []

    def trial(alpha, active):
        seen.append(active.clone())
        col = lambda t: t.reshape(t.shape + (1,) * (tv.dim() - t.dim()))
        d = alpha - ta
        return col(alpha) * tv, col(alpha * alpha) * tw, d * d

    out = optimistic_backtracking_search(
        trial, torch.as_tensor(cost_k, dtype=torch.float64), alpha_prev, s)
    return [o.numpy() for o in out], seen


def _jax_search(v, w, a_star, cost_k, alpha_prev, s, batched):
    def one(v, w, a_star, cost_k):
        def trial(alpha):
            d = alpha - a_star
            return alpha * v, alpha * alpha * w, d * d
        return jax_search(trial, cost_k, alpha_prev, s)
    f = jax.vmap(one) if batched else one
    out = f(*(jnp.asarray(x, jnp.float64) for x in (v, w, a_star, cost_k)))
    return [np.asarray(o) for o in out]


def _settings(factor, trials=5, beta=0.8):
    kw = dict(ls_max_trials=trials, ls_beta=beta, ls_alpha_factor=factor)
    return PGDSettings(**kw), JaxSettings(**kw)


def _assert_same(port, ref):
    names = ("alpha_k", "u1", "phi1", "c1", "n_trials", "optimistic_ok")
    for name, a, b in zip(names, port, ref):
        assert a.shape == b.shape, name
        assert np.array_equal(a, b), (name, a, b)


# (a_star, cost_k) with alpha_prev = 10: the optimistic trial succeeds;
# backtracking succeeds in slot 2 or 4, the third or fifth trial (alpha_j =
# 10 f beta^(j-1) within sqrt(cost_k) of a_star); every trial fails
SEARCH_CASES = {"optimistic": (9.0, 2.0), "backtrack_2": (None, 2),
                "backtrack_4": (None, 4), "total_failure": (1.0, -1.0)}


def _case(name, factor, beta=0.8, alpha_prev=10.0):
    a_star, cost_k = SEARCH_CASES[name]
    if a_star is None:        # the slot j that should succeed
        j = cost_k
        a_star = alpha_prev * factor * beta ** (j - 1)
        # accepted: |alpha - a_star| < sqrt(cost_k), rejected at j - 1
        gap = alpha_prev * factor * beta ** (j - 2) - a_star
        cost_k = (0.5 * gap) ** 2
    return a_star, cost_k


@pytest.mark.parametrize("factor", [0.8, 1.0])
@pytest.mark.parametrize("name", list(SEARCH_CASES))
def test_search_matches_vch_tpu(name, factor):
    """Exact: the same alphas, iterate, cost, trial count and flag."""
    s, js = _settings(factor)
    a_star, cost_k = _case(name, factor)
    v, w = _toy_inputs(0)
    port, seen = _port_search(v, w, a_star, cost_k, 10.0, s)
    ref = _jax_search(v, w, a_star, cost_k, 10.0, js, batched=False)
    _assert_same(port, ref)
    # exactly 1 + ls_max_trials slots, a member active until it succeeds
    assert len(seen) == 6
    n = int(port[4])
    assert [bool(a) for a in seen] == [True] * n + [False] * (6 - n)
    want = {"optimistic": 1, "backtrack_2": 3, "backtrack_4": 5,
            "total_failure": 6}[name]
    assert n == want
    if name == "total_failure":
        # the last trial returned, alpha already times beta (up to the
        # rounding of another order of products)
        last = 10.0 * factor * 0.8 ** 4
        np.testing.assert_allclose(port[0], last * 0.8, rtol=1e-14)
        np.testing.assert_allclose(port[1], last * v, rtol=1e-14)
        assert not port[5]


@pytest.mark.parametrize("factor", [0.8, 1.0])
def test_batched_search_matches_vmap(factor):
    """A (B,) cost_k: members finish at slots 0, 2, 4, never, each holding
    its state after, exactly as jax.vmap of vch_tpu's search."""
    s, js = _settings(factor)
    cases = [_case(n, factor) for n in SEARCH_CASES]
    a_star = np.array([c[0] for c in cases])
    cost_k = np.array([c[1] for c in cases])
    v, w = _toy_inputs(1, B=len(cases))
    port, seen = _port_search(v, w, a_star, cost_k, 10.0, s)
    ref = _jax_search(v, w, a_star, cost_k, 10.0, js, batched=True)
    _assert_same(port, ref)
    assert port[4].tolist() == [1, 3, 5, 6]
    assert [a.tolist() for a in seen][1] == [False, True, True, True]


# ---- (ii) config 1 (float64) through both fused loops --------------------

@pytest.fixture(scope="module")
def config1_runs():
    jprob = JaxProblem1D()
    jres = _jax_fused(jprob.loop).run(jprob.initial_control(),
                                      jprob.phi_hist0, max_iter=4,
                                      verbose=False)
    prob = ControlProblem1D(device="cpu")
    n0 = prob.newton_solves
    fres = _fused(prob.loop).run(prob.initial_control(), prob.phi_hist0,
                                 max_iter=4, verbose=False)
    n1 = prob.newton_solves
    hres = prob.loop.run(prob.initial_control(), prob.phi_hist0, max_iter=4,
                         verbose=False)
    return jres, fres, hres, (n1 - n0, prob.newton_solves - n1)


def test_config1_fused_matches_vch_tpu_fused(config1_runs):
    jres, fres, _, _ = config1_runs
    c, jc = np.asarray(fres.cost_history), np.asarray(jres.cost_history)
    assert np.abs(c / jc - 1).max() < 5e-9
    assert fres.ls_trials_per_iter == [int(n) for n in
                                       jres.ls_trials_per_iter] == [1, 4, 6, 4]
    assert fres.alpha_history == [float(a) for a in jres.alpha_history]
    # iteration 3 fails all six trials and keeps the last, worse iterate
    assert c[3] > c[2] and jc[3] > jc[2]


def test_config1_fused_equals_host_mode(config1_runs):
    """(vi) Bit for bit, with the same Newton solves: an idle slot marches
    nothing."""
    _, fres, hres, (n_fused, n_host) = config1_runs
    assert fres.cost_history == hres.cost_history
    assert fres.alpha_history == hres.alpha_history
    assert fres.ls_trials_per_iter == hres.ls_trials_per_iter
    assert fres.tracking_err_history == hres.tracking_err_history
    assert fres.terminal_err_history == hres.terminal_err_history
    for k in ("u_optimal", "r_optimal", "phi_final"):
        assert np.array_equal(getattr(fres, k), getattr(hres, k)), k
    assert n_fused == n_host > 0


# ---- (iii) the 2D problem at 16 x 16 -------------------------------------

def _problems_2d(dtype):
    cfg = dict(Nx=16, Ny=16, T=0.1, dtype=dtype,
               newton_tol=2e-4 if dtype == "float32" else 1e-6)
    jprob = JaxProblem2D(JaxConfig2D(**cfg), JaxOpt.defaults_2d().model_copy(
        update=dict(alpha_max=1e4)))
    prob = ControlProblem2D(config_from_vch_tpu(JaxConfig2D(**cfg)
                                                .model_dump()),
                            OptimizationConfig.defaults_2d(alpha_max=1e4),
                            device="cpu")
    return jprob, prob


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-10),
                                       ("float32", 2e-5)])
def test_2d_fused_matches_vch_tpu_fused(dtype, tol):
    jprob, prob = _problems_2d(dtype)
    jres = _jax_fused(jprob.loop).run(jprob.initial_control(),
                                      jprob.phi_hist0, max_iter=4,
                                      verbose=False)
    res = _fused(prob.loop).run(prob.initial_control(), prob.phi_hist0,
                                max_iter=4, verbose=False)
    c, jc = np.asarray(res.cost_history), np.asarray(jres.cost_history)
    assert np.isfinite(c).all()
    assert (np.abs(c - jc) / np.abs(jc)).max() <= tol, (c, jc)
    assert res.ls_trials_per_iter == [int(n) for n in
                                      jres.ls_trials_per_iter]
    assert res.ls_trials_per_iter == [1, 1, 11, 11]
    assert res.alpha_history == [float(a) for a in jres.alpha_history]
    if dtype == "float64":
        # (vi) the port's host mode, bit for bit
        hres = prob.loop.run(prob.initial_control(), prob.phi_hist0,
                             max_iter=4, verbose=False)
        assert hres.cost_history == res.cost_history
        assert np.array_equal(hres.u_optimal, res.u_optimal)


# ---- (iv), (v) keep_failed_step, the time study --------------------------

def _toy_loops(mode, settings_name):
    """A loop over u (4,) whose every trial fails: from u = 0 (cost 0) any
    step gives cost sum(u^2) > 0. In both packages."""
    s = getattr(PGDSettings, settings_name)()
    js = getattr(JaxSettings, settings_name)()
    port = ProximalGradientLoop(
        lambda u: 2.0 * u, lambda phi: phi - 1.0,
        lambda phi, u: torch.sum(u * u), OptimizationConfig(), settings=s,
        search_mode=mode)
    ref = JaxLoop(lambda u: 2.0 * u, lambda phi: phi - 1.0,
                  lambda phi, u: jnp.sum(u * u), JaxOpt(), settings=js,
                  search_mode=mode)
    return port, ref


@pytest.mark.parametrize("mode", ["fused", "host"])
def test_keep_failed_step_quirk(mode):
    """Under defaults_exact every trial fails: the fused mode keeps the
    last trial (it never reads keep_failed_step), the host mode rejects it;
    both packages alike."""
    port, ref = _toy_loops(mode, "defaults_exact")
    u0 = np.zeros(4)
    res = port.run(torch.as_tensor(u0), torch.as_tensor(u0), max_iter=1,
                   verbose=False)
    jres = ref.run(jnp.asarray(u0), jnp.asarray(u0), max_iter=1,
                   verbose=False)
    assert res.ls_trials_per_iter == [int(n) for n in
                                      jres.ls_trials_per_iter] == [16]
    assert res.alpha_history == [float(a) for a in jres.alpha_history]
    assert np.array_equal(res.u_optimal, np.asarray(jres.u_optimal))
    # a sum of four squares, which the packages may add in another order
    np.testing.assert_allclose(res.cost_history, jres.cost_history,
                               rtol=1e-14)
    if mode == "fused":
        last = 100.0 * 0.5 ** 14
        assert res.u_optimal[0] > 0 and res.cost_history[1] > 0
        np.testing.assert_allclose(res.u_optimal,
                                   np.clip(last * (1 - 9e-5), -1, 1))
    else:
        assert not res.u_optimal.any() and res.cost_history == [0.0, 0.0]


@pytest.mark.parametrize("mode", ["fused", "host"])
def test_time_study_only_in_host_mode(mode, capsys):
    """(v) The fused mode prints no time study and leaves the four phase
    timers at 0, as vch_tpu's."""
    port, _ = _toy_loops(mode, "defaults_1d")
    u0 = torch.zeros(4, dtype=torch.float64)
    res = port.run(u0, u0, max_iter=2, verbose=True)
    out = capsys.readouterr().out
    assert "iter    1" in out
    phases = ("backward_total", "optimistic_eval_total", "line_search_total",
              "successful_step_total")
    if mode == "fused":
        assert "TIME STUDY" not in out
        assert all(res.timers[k] == 0.0 for k in phases)
    else:
        assert "TIME STUDY" in out
        assert res.timers["backward_total"] > 0
    assert res.timers["iteration_total"] > 0


def test_search_mode_is_checked():
    with pytest.raises(ValueError, match="search_mode"):
        ProximalGradientLoop(None, None, None, OptimizationConfig(),
                             search_mode="device")
    loop = ProximalGradientLoop(None, None, None, OptimizationConfig(),
                                search_mode="fused")
    assert loop.search_mode == "fused" and not loop._forward_takes_active
    prob = ControlProblem1D(ForwardSolverConfig1D(N=16, T=0.02),
                            device="cpu")
    assert _fused(prob.loop)._forward_takes_active


# ---- (vii) the active mask of the marchers -------------------------------

ACTIVE = [True, False, True]


def _check_masked(full, masked):
    """Active members equal the unmasked run, inactive ones solved nothing
    and have no bad step."""
    (h, ns, bad), (hm, nsm, badm) = full, masked
    for b, on in enumerate(ACTIVE):
        if on:
            assert torch.equal(hm[b], h[b])
            assert int(nsm[b]) == int(ns[b]) > 0
            assert int(badm[b]) == int(bad[b])
        else:
            assert int(nsm[b]) == 0 and int(badm[b]) == -1


def _inputs_2d(dtype, B=3):
    solver = ForwardSolver2D(ForwardSolverConfig2D(Nx=12, Ny=12, T=0.03,
                                                   dtype=dtype),
                             device="cpu")
    rng = np.random.default_rng(3)
    phi0 = torch.as_tensor(np.stack([solver.default_initial_phi()] * B)
                           + 0.01 * rng.standard_normal((B, 13, 13)),
                           dtype=solver.dtype)
    u = torch.as_tensor(0.3 * rng.standard_normal((B, solver.M + 1, 13, 13)),
                        dtype=solver.dtype)
    return solver, u, phi0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_march_fused_2d_plain_active(dtype):
    solver, u, phi0 = _inputs_2d(dtype)
    flags = torch.tensor(ACTIVE, dtype=torch.int32)
    full = solver.march_fused_batch(u, phi0)
    masked = solver.march_fused_batch(u, phi0, active=flags)
    _check_masked(full, masked)
    assert not masked[0][1].any()           # the plain version's zeros
    ones = solver.march_fused_batch(u, phi0, active=torch.ones_like(flags))
    assert all(torch.equal(a, b) for a, b in zip(ones, full))


def test_active_flag_refused_by_the_other_marches():
    solver, u, phi0 = _inputs_2d("float32", B=8)
    flags = torch.ones(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="active"):
        solver.march_fused_batch(u, phi0, active=flags)     # blocked route
    args = (solver.dts, phi0, u) + solver._ops()
    kw = solver._march_kw()
    for fn in (km.march_fused_2d_blocked, km.march_fused_2d_blocked_plain):
        with pytest.raises(ValueError, match="active"):
            fn(*args, block_b=8, active=flags, **kw)
    with pytest.raises(ValueError, match="active"):
        km._march_fused_2d_cta(*args, active=flags, **kw)
    K = 2
    seg = (solver.dts[:K], phi0, phi0, phi0, torch.zeros(8), u[:, :K + 1])
    for fn in (km.march_fused_2d_segment, km._march_fused_2d_segment_cta,
               km.march_fused_2d_segment_plain):
        with pytest.raises(ValueError, match="active"):
            fn(*seg, *solver._ops(), active=flags, **kw)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_per_step_marcher_2d_active(dtype):
    solver, u, phi0 = _inputs_2d(dtype)
    active = torch.tensor(ACTIVE)
    _check_masked(solver._march_batch(u, phi0),
                  solver._march_batch(u, phi0, active=active))
    none = solver._march_batch(u, phi0, active=torch.zeros_like(active))
    assert not none[1].any() and (none[2] == -1).all()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_per_step_marcher_1d_active(dtype):
    solver = ForwardSolver1D(ForwardSolverConfig1D(N=32, T=0.05, dtype=dtype),
                             device="cpu")
    rng = np.random.default_rng(4)
    B = len(ACTIVE)
    phi0 = torch.as_tensor(np.stack([solver.default_initial_phi()] * B)
                           + 0.01 * rng.standard_normal((B, 33)),
                           dtype=solver.dtype)
    u = torch.as_tensor(0.3 * rng.standard_normal((B, solver.M + 1, 33)),
                        dtype=solver.dtype)
    active = torch.tensor(ACTIVE)
    _check_masked(solver._march_batch(u, phi0),
                  solver._march_batch(u, phi0, active=active))


def test_problem_forward_passes_active():
    """The problems' forwards: an inactive member marches nothing and adds
    no Newton solve; an active one gives the unmasked trajectory."""
    prob = ControlProblem2D(ForwardSolverConfig2D(Nx=12, Ny=12, T=0.03),
                            device="cpu")
    u = 0.2 * torch.ones_like(prob.phi_hist0)
    n0 = prob.newton_solves
    phi = prob._forward(u)
    n1 = prob.newton_solves
    assert n1 > n0
    assert torch.equal(prob._forward(u, active=torch.tensor(True)), phi)
    assert prob.newton_solves == 2 * n1 - n0
    prob._forward(u, active=torch.tensor(False))
    assert prob.newton_solves == 2 * n1 - n0
    prob1 = ControlProblem1D(ForwardSolverConfig1D(N=16, T=0.02),
                             device="cpu")
    u1 = 0.2 * torch.ones_like(prob1.phi_hist0)
    n0 = prob1.newton_solves
    phi1 = prob1._forward(u1)
    assert torch.equal(prob1._forward(u1, active=torch.tensor(True)), phi1)
    n2 = prob1.newton_solves
    prob1._forward(u1, active=torch.tensor(False))
    assert prob1.newton_solves == n2 > n0
