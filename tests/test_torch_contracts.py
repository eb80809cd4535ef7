"""The contracts the port shares with vch_tpu under vch_tpu's names, against
vch_tpu on the CPU in float64:

  - fault C3: the public `apply_laplacian_2d(Lx, Ly, v)` in vch_tpu's call
    form on the Neumann Ly, which is not symmetric: 1e-12 relative; the
    solvers' helper `apply_laplacian_2d_t` takes Ly transposed, and handed
    Ly it gives another field (the fault's size, > 0.1);
  - the same fault's kin: `mu_residual_2d`, `phi_residual_2d`,
    `newton_schur_solve_2d` and `newton_2d` on vch_tpu's `SpectralOp2D`
    (`make_spectral_op_2d`, Ly untransposed) and one member's fields, as
    vch_tpu calls them: 1e-12 relative, Newton solves equal; any other
    tuple raises TypeError;
  - `ProximalGradientLoop` on vch_tpu's adjoint contract (adjoint:
    phi_hist -> r) at config 1, 3 iterations, in both search modes: costs
    within 5e-9 relative of vch_tpu's loop (the golden-run bound of
    tests/test_torch_control1d.py), trials and alphas equal;
    `adjoint_takes_u=True` with a two-argument adjoint: the same run to the
    last bit;
  - `approximate_second_order_condition` with vch_tpu's one-control
    `forward` against `forward_batch=`: 1e-12 relative on a 2D problem,
    FORWARD_VS_BATCH_TOL at config 1 (see there); against vch_tpu's on a toy
    forward and cost: SECOND_ORDER_TOL;
  - `perform_gradient_step` (1e-12) and the cost print (`verbose=True`: the
    same five lines as vch_tpu's for the same values);
  - the package namespaces of vch_tpu: `vch_tpu_torch`'s config names,
    `vch_tpu_torch.control`'s `__all__`, `vch_tpu_torch.models`' solvers
    (the 2D ones on first access), none importing JAX or vch_tpu.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vch_tpu.control as jcontrol
import vch_tpu.models as jmodels
import vch_tpu.models.forward2d as jf2d
import vch_tpu.ops as jops
import vch_tpu.ops.linsolve as jls
from vch_tpu.control.diagnostics import \
    approximate_second_order_condition as jax_second_order
from vch_tpu.control.pgd import PGDSettings as JaxSettings
from vch_tpu.control.pgd import ProximalGradientLoop as JaxLoop
from vch_tpu.control.problems import ControlProblem1D as JaxProblem1D

import vch_tpu_torch
import vch_tpu_torch.control as tcontrol
import vch_tpu_torch.models as tmodels
import vch_tpu_torch.models.forward2d as tf2d
import vch_tpu_torch.ops as tops
import vch_tpu_torch.ops.linsolve as tls
from vch_tpu_torch import config as tconfig
from vch_tpu_torch.config import (ForwardSolverConfig2D, OptimizationConfig,
                                  PGDSettings)
from vch_tpu_torch.control.diagnostics import \
    approximate_second_order_condition
from vch_tpu_torch.control.pgd import ProximalGradientLoop
from vch_tpu_torch.control.problems import ControlProblem1D, ControlProblem2D
from vch_tpu_torch.ops import laplacian as tlap

torch.set_num_threads(2)

TOL = 1e-12
PGD_COST_TOL = 5e-9
# The finite-difference quotient divides cost differences by eps^2 / 2
# = 5e-9: the two packages' sums round differently by ~1e-16 of the cost,
# which the quotient lifts to ~1e-7 of the estimate.
SECOND_ORDER_TOL = 1e-6


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


# ---- fault C3: apply_laplacian_2d takes Ly -------------------------------

@pytest.mark.parametrize("Nx,Ny,batch", [(16, 16, ()), (20, 14, (3,))])
def test_public_laplacian_takes_ly_as_vch_tpu(Nx, Ny, batch):
    """vch_tpu's call form on the Neumann matrices (2/h^2 in Ly's first and
    last rows): the port's public op equals vch_tpu's; the solvers' helper
    takes Ly transposed, and handed Ly it is far off."""
    Lx = tlap.laplacian_matrix_neumann(Nx, 1 / Nx)
    Ly = tlap.laplacian_matrix_neumann(Ny, 1 / Ny)
    assert not np.array_equal(Ly, Ly.T)
    v = np.random.default_rng(0).standard_normal(batch + (Nx + 1, Ny + 1))
    want = jops.apply_laplacian_2d(jnp.asarray(Lx), jnp.asarray(Ly),
                                   jnp.asarray(v))
    assert _rel(tops.apply_laplacian_2d(_t(Lx), _t(Ly), _t(v)), want) <= TOL
    assert _rel(tlap.apply_laplacian_2d_t(
        _t(Lx), _t(Ly.T).contiguous(), _t(v)), want) <= TOL
    assert _rel(tlap.apply_laplacian_2d_t(_t(Lx), _t(Ly), _t(v)), want) > 0.1
    stencil = tops.stencil_laplacian_2d(_t(v), 1 / Nx, 1 / Ny)
    assert _rel(tops.apply_laplacian_2d(_t(Lx), _t(Ly), _t(v)),
                stencil) <= 1e-12


# ---- the residuals and Newton solves on vch_tpu's SpectralOp2D ----------

def _spectral_op_inputs():
    """vch_tpu's and the port's SpectralOp2D of a 20 x 14 grid, and one
    member's fields near a two-phase state, at config 3's constants."""
    Nx, Ny = 20, 14
    jop = jls.make_spectral_op_2d(Nx, Ny, 1 / Nx, 1 / Ny)
    top = tls.make_spectral_op_2d(Nx, Ny, 1 / Nx, 1 / Ny, device="cpu")
    rng = np.random.default_rng(1)
    x = np.linspace(0.0, 1.0, Nx + 1)[:, None]
    y = np.linspace(0.0, 1.0, Ny + 1)[None, :]
    phi_old = (0.6 * np.cos(np.pi * x) * np.cos(2 * np.pi * y)
               + 0.05 * rng.standard_normal((Nx + 1, Ny + 1)))
    phi_new = phi_old + 0.01 * rng.standard_normal(phi_old.shape)
    fields = dict(phi_new=phi_new, phi_old=phi_old, **{
        k: 0.1 * rng.standard_normal(phi_old.shape)
        for k in ("mu_new", "mu_old", "w_new", "w_old", "Rphi", "Rmu")})
    cfg = ForwardSolverConfig2D()
    consts = dict(dt=1e-3, tau=cfg.tau, c1=cfg.c1, c2=cfg.c2,
                  kappa=cfg.kappa, delta_sep=1e-3)
    return jop, top, fields, consts


def _spectral_op_calls(pkg, op, f, c, arr):
    """{name: the outputs of the call} in vch_tpu's form, for the package
    `pkg` (its forward2d and linsolve modules)."""
    fwd, ls = pkg
    a = {k: arr(v) for k, v in f.items()}
    return {
        "mu_residual_2d": (fwd.mu_residual_2d(
            op, a["phi_new"], a["phi_old"], a["mu_new"], a["mu_old"],
            c["dt"]),),
        "phi_residual_2d": (fwd.phi_residual_2d(
            op, a["phi_new"], a["phi_old"], a["mu_new"], a["mu_old"],
            a["w_new"], a["w_old"], c["dt"], c["tau"], c["c1"], c["c2"],
            c["kappa"], c["delta_sep"]),),
        "newton_schur_solve_2d": ls.newton_schur_solve_2d(
            op, a["phi_old"], a["Rphi"], a["Rmu"], c["dt"], c["tau"],
            c["c1"], c["kappa"], c["delta_sep"], tol=1e-12, max_iter=200),
        "newton_2d": fwd.newton_2d(
            op, a["phi_old"], a["mu_old"], a["w_old"], a["w_new"], c["dt"],
            c["tau"], c["c1"], c["c2"], c["kappa"], c["delta_sep"], 1e-10,
            20, 1e-12, 200, a["mu_old"], record_history=True,
            return_iters=True),
    }


@pytest.fixture(scope="module")
def spectral_op_calls():
    jop, top, f, c = _spectral_op_inputs()
    return (_spectral_op_calls((jf2d, jls), jop, f, c, jnp.asarray),
            _spectral_op_calls((tf2d, tls), top, f, c, _t))


@pytest.mark.parametrize("name", ["mu_residual_2d", "phi_residual_2d",
                                  "newton_schur_solve_2d", "newton_2d"])
def test_spectral_op_call_form_matches_vch_tpu(spectral_op_calls, name):
    """vch_tpu's call: its SpectralOp2D (Ly, not Ly transposed) and one
    member's (n, m) fields, by position; every output of the port's is
    vch_tpu's to 1e-12 of its largest value (the residual history's NaN
    where no round ran in the same places), the Newton solves equal."""
    want, got = (calls[name] for calls in spectral_op_calls)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        if g.ndim == 0:                  # newton_2d's Newton solves
            assert int(g) == int(w) > 0
            continue
        assert np.array_equal(np.isnan(g), np.isnan(w))
        ok = ~np.isnan(w)
        assert _rel(g[ok], w[ok]) <= TOL


def test_a_plain_tuple_is_no_operator():
    """A tuple that is neither vch_tpu's SpectralOp2D nor an Ops2D (say,
    a SpectralOp2D's fields unpacked) raises instead of being read in the
    wrong order."""
    _, top, f, c = _spectral_op_inputs()
    a = {k: _t(v) for k, v in f.items()}
    assert isinstance(tls.as_grid(tls.ops_2d(top)), tls.LocalGrid)
    with pytest.raises(TypeError):
        tf2d.mu_residual_2d(tuple(top), a["phi_new"], a["phi_old"],
                            a["mu_new"], a["mu_old"], c["dt"])


# ---- ProximalGradientLoop on vch_tpu's adjoint contract ------------------

@pytest.fixture(scope="module")
def config1():
    """vch_tpu's loop of config 1 built on its contract, 3 iterations, and
    the port's problem."""
    jprob = JaxProblem1D()
    jloop = JaxLoop(jprob.loop.forward, jprob.loop.adjoint, jprob.loop.cost,
                    jprob.opt_config, settings=JaxSettings.defaults_1d())
    jres = jloop.run(jprob.initial_control(), jprob.phi_hist0, max_iter=3,
                     verbose=False)
    return jres, ControlProblem1D(device="cpu"), {}


def _contract_run(config1, mode, takes_u):
    """The port's loop of config 1 on vch_tpu's contract (takes_u: a
    two-argument adjoint with adjoint_takes_u=True), run once."""
    _, prob, runs = config1
    if (mode, takes_u) not in runs:
        adjoint = ((lambda phi, u: prob._adjoint_r(phi)) if takes_u
                   else prob._adjoint_r)
        loop = ProximalGradientLoop(prob.loop.forward, adjoint,
                                    prob.loop.cost, prob.opt_config,
                                    settings=PGDSettings.defaults_1d(),
                                    search_mode=mode,
                                    adjoint_takes_u=takes_u)
        runs[mode, takes_u] = loop.run(prob.initial_control(),
                                       prob.phi_hist0, max_iter=3,
                                       verbose=False)
    return runs[mode, takes_u]


@pytest.mark.parametrize("mode", ["host", "fused"])
def test_loop_on_vch_tpu_adjoint_contract(config1, mode):
    """adjoint: phi_hist -> r, as vch_tpu documents it: vch_tpu's trials,
    alphas and costs in both search modes (iteration 3 fails all six
    trials and keeps the last, worse iterate)."""
    jres = config1[0]
    res = _contract_run(config1, mode, False)
    c, jc = np.asarray(res.cost_history), np.asarray(jres.cost_history)
    assert np.abs(c / jc - 1).max() < PGD_COST_TOL
    assert res.ls_trials_per_iter == [int(n) for n in
                                      jres.ls_trials_per_iter] == [1, 4, 6]
    assert res.alpha_history == [float(a) for a in jres.alpha_history]


def test_adjoint_takes_u_keeps_the_two_argument_contract(config1):
    """adjoint_takes_u=True calls adjoint(phi_hist, u): with the same r it
    is the one-argument run to the last bit."""
    assert not config1[1].loop.adjoint_takes_u   # the reference gradient
    one = _contract_run(config1, "host", False)
    two = _contract_run(config1, "host", True)
    assert two.cost_history == one.cost_history
    assert two.alpha_history == one.alpha_history
    assert two.ls_trials_per_iter == one.ls_trials_per_iter
    assert np.array_equal(two.u_optimal, one.u_optimal)
    assert np.array_equal(two.r_optimal, one.r_optimal)


@pytest.mark.parametrize("mode", ["host", "fused"])
@pytest.mark.parametrize("takes_u", [False, True])
def test_loop_calls_the_adjoint_by_its_contract(mode, takes_u):
    """The loop passes u to the adjoint only with adjoint_takes_u, in both
    search modes and in every iteration."""
    seen = []

    def adjoint(phi, *rest):
        seen.append(len(rest))
        return phi - 1.0

    loop = ProximalGradientLoop(
        lambda u: 2.0 * u, adjoint, lambda phi, u: torch.sum(phi * phi),
        OptimizationConfig(), search_mode=mode, adjoint_takes_u=takes_u)
    u0 = torch.zeros(4, dtype=torch.float64)
    loop.run(u0, 2.0 * u0, max_iter=2, verbose=False)
    assert seen == [int(takes_u)] * 2


# ---- approximate_second_order_condition(forward, ...) --------------------

# The 1D problems' forward_batch marches the directions as one batch, whose
# solves round differently from one member's (phi ~6e-13 apart, held below
# FORWARD_VS_BATCH_PHI_TOL), and the finite-difference quotient lifts that
# to ~3e-7 of the estimate; the 2D problem on the CPU marches one member at
# a time, so the two calls agree to the last bit.
FORWARD_VS_BATCH_TOL = {1: 1e-5, 2: TOL}
FORWARD_VS_BATCH_PHI_TOL = {1: 1e-11, 2: TOL}


def _second_order_problem(config1, dim):
    if dim == 1:
        return config1[1], _contract_run(config1, "host", False)
    prob = ControlProblem2D(ForwardSolverConfig2D(Nx=16, Ny=16, T=0.1),
                            device="cpu")
    return prob, prob.optimize(max_iter=2, verbose=False)


@pytest.mark.parametrize("dim", [1, 2])
def test_second_order_forward_equals_forward_batch(config1, dim):
    """vch_tpu's one-control forward, one call a direction, against the
    problems' forward_batch, at config 1's third iterate and at a 16 x 16
    2D problem's second: the trajectories of three perturbed controls, one
    call each against one batch, then the estimates."""
    prob, res = _second_order_problem(config1, dim)
    opt = prob.opt_config
    args = (res.u_optimal, res.r_optimal, res.phi_final, opt.b3,
            opt.kappa_sparsity, opt.u_min, opt.u_max)
    kw = dict(num_directions=3, epsilon=1e-4, seed=42, handle_kink=dim == 1,
              dtype=torch.float64, device="cpu")
    u_pert = _t(res.u_optimal[None] + 1e-4 * np.random.default_rng(
        6).standard_normal((3,) + res.u_optimal.shape))
    phi_batch = prob._forward_batch(u_pert)
    phi_one = torch.stack([prob.loop.forward(u_i) for u_i in u_pert])
    assert _rel(phi_one, phi_batch) <= FORWARD_VS_BATCH_PHI_TOL[dim]
    one = approximate_second_order_condition(prob.loop.forward,
                                             prob.loop.cost, *args, **kw)
    batch = prob.second_order_check(res, num_directions=3)
    assert np.isfinite(one).all() and len(one) == 3
    assert _rel(one, batch) <= FORWARD_VS_BATCH_TOL[dim]
    with pytest.raises(ValueError):
        approximate_second_order_condition(None, prob.loop.cost, *args,
                                           **kw)
    with pytest.raises(ValueError):
        approximate_second_order_condition(
            prob.loop.forward, prob.loop.cost, *args,
            forward_batch=prob._forward_batch, **kw)


def _toy_second_order_inputs():
    rng = np.random.default_rng(3)
    u = np.clip(rng.uniform(-1.2, 1.2, (6, 9)), -1.0, 1.0)
    u[np.abs(u) < 0.3] = 0.0           # the L1 kink and both bounds active
    r = 0.01 * rng.standard_normal(u.shape)
    return u, r, u ** 3 + 0.5 * u


@pytest.mark.parametrize("handle_kink", [True, False])
def test_second_order_matches_vch_tpu(handle_kink):
    """A toy forward phi = u^3 + u/2 and cost |phi|^2/2 + |u|^2/10 through
    both packages' probes, the port's both with `forward` and with
    `forward_batch=`."""
    u, r, phi = _toy_second_order_inputs()
    args = (u, r, phi, 1e-3, 1e-2, -1.0, 1.0)
    kw = dict(num_directions=4, epsilon=1e-4, seed=7,
              handle_kink=handle_kink)
    want = jax_second_order(
        lambda v: v ** 3 + 0.5 * v,
        lambda p, v: 0.5 * jnp.sum(p * p) + 0.1 * jnp.sum(v * v),
        *args, **kw)
    fwd = lambda v: v ** 3 + 0.5 * v
    got = approximate_second_order_condition(
        fwd, lambda p, v: 0.5 * torch.sum(p * p) + 0.1 * torch.sum(v * v),
        *args, dtype=torch.float64, device="cpu", **kw)
    batch = approximate_second_order_condition(
        None, lambda p, v: (0.5 * torch.sum(p * p, dim=(-2, -1))
                            + 0.1 * torch.sum(v * v, dim=(-2, -1))),
        *args, dtype=torch.float64, device="cpu", forward_batch=fwd, **kw)
    assert _rel(got, want) <= SECOND_ORDER_TOL
    assert _rel(batch, want) <= SECOND_ORDER_TOL


# ---- perform_gradient_step, the cost print --------------------------------

def test_perform_gradient_step_matches_vch_tpu():
    rng = np.random.default_rng(4)
    u, g = rng.standard_normal((2, 7, 5))
    want = jcontrol.perform_gradient_step(jnp.asarray(u), jnp.asarray(g), 0.3)
    assert _rel(tcontrol.perform_gradient_step(_t(u), _t(g), 0.3),
                want) <= TOL


def _cost_inputs(dim):
    rng = np.random.default_rng(5)
    shape = (11, 9) if dim == 1 else (6, 9, 8)
    phi, u, phi_Q = (rng.standard_normal(shape) for _ in range(3))
    phi_T = rng.standard_normal(shape[1:])
    grids = [np.linspace(0.0, 1.0, n) for n in shape[1:]]
    t = np.linspace(0.0, 1.0, shape[0])
    return [phi, u, phi_Q, phi_T] + grids + [t, 0.3, 13.0, 0.0019, 9e-5]


@pytest.mark.parametrize("dim", [1, 2])
def test_cost_verbose_prints_vch_tpu_lines(dim, capsys):
    """calculate_cost_{1,2}d(..., verbose=True): vch_tpu's five lines of
    J1-J4 and the total, the same text for the same values; silent by
    default."""
    args = _cost_inputs(dim)
    name = f"calculate_cost_{dim}d"
    want = getattr(jcontrol, name)(
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args],
        verbose=True)
    ref_out = capsys.readouterr().out
    got = getattr(tcontrol, name)(
        *[_t(a) if isinstance(a, np.ndarray) else a for a in args],
        verbose=True)
    assert capsys.readouterr().out == ref_out
    assert ref_out.count("\n") == 6 and "Total Cost" in ref_out
    assert _rel(got, want) <= TOL
    assert _rel(getattr(tcontrol, name)(
        *[_t(a) if isinstance(a, np.ndarray) else a for a in args]),
        want) <= TOL
    assert capsys.readouterr().out == ""


# ---- the package namespaces ----------------------------------------------

def test_package_namespaces_match_vch_tpu():
    """vch_tpu's config names at the package's top, vch_tpu.control's
    __all__, vch_tpu.models' 1D solvers at import and 2D solvers on first
    access; an unknown solver raises AttributeError in both."""
    from vch_tpu_torch.models import adjoint1d, adjoint2d, forward1d, \
        forward2d
    for n in ("ForwardSolverConfig1D", "ForwardSolverConfig2D",
              "OptimizationConfig", "SimulationParameters", "load_params",
              "save_params"):
        assert getattr(vch_tpu_torch, n) is getattr(tconfig, n)
    assert tcontrol.__all__ == jcontrol.__all__
    for n in tcontrol.__all__:
        module = getattr(jcontrol, n).__module__.split(".")[-1]
        assert getattr(tcontrol, n) is getattr(
            getattr(tcontrol, module), n)
    assert tmodels.__all__ == jmodels.__all__
    assert tmodels.ForwardSolver1D is forward1d.ForwardSolver1D
    assert tmodels.AdjointSolver1D is adjoint1d.AdjointSolver1D
    assert tmodels.ForwardSolver2D is forward2d.ForwardSolver2D
    assert tmodels.AdjointSolver2D is adjoint2d.AdjointSolver2D
    for models in (tmodels, jmodels):
        with pytest.raises(AttributeError):
            models.ForwardSolver3D


def test_namespaces_import_no_jax_or_vch_tpu():
    code = ("import sys; from vch_tpu_torch import ForwardSolverConfig2D; "
            "from vch_tpu_torch.models import ForwardSolver2D, "
            "AdjointSolver2D; from vch_tpu_torch.control import "
            "calculate_cost_2d, perform_gradient_step; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'vch_tpu', 'pydantic', 'jaxlib')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stdout + proc.stderr
