"""vch_tpu's call forms through the port's public entry points, on the CPU
in float64 (N = 20 in 1D; 12 x 12 in 2D, a few steps).

(a) Each case of CASES calls a vch_tpu entry point and the port's of the
    same name on the same inputs, made from a numpy seed, in vch_tpu's
    call form: host numpy arrays where the entry point holds a device (the
    solvers, the problems, the pipelines, the cost's grids, the host
    diagnostics), tensors where it is a primitive that computes where its
    tensors live (`newton_1d` on one member's (N+1,) fields, the free
    energies, the cost's fields). Every float result is within TOL of
    vch_tpu's relative to its max |.|; every count (Newton solves, the
    stats' integers, the residual histories' lengths) is equal.
(b) The card's refusal, emulated: `torch.Tensor.__array__` raises the
    TypeError a CUDA tensor raises, so any path that sends a tensor
    through numpy fails here as on the card. Each case is called again
    with tensors in place of every numpy input (simulate's own phi_hist
    fed straight into the adjoint's run), and its results equal the
    numpy-input results bit for bit.
(c) A coverage guard: every public function and method of vch_tpu's
    models/, control/, ops/, parallel/, utils/ and viz/ modules (the two
    Pallas modules excepted) and of its top-level cli.py and config.py
    that has an array parameter is a case of (a) here or in
    tests/test_torch_call_forms_parallel.py (parallel/) and
    tests/test_torch_call_forms_artifacts.py (utils/, viz/: the files
    written), or an entry of ALLOWED with its reason. Each parameter
    name is classed as an array or not in ARRAY_PARAMS / OTHER_PARAMS
    (PARAM_OVERRIDES where a name is both); an unclassed name, an entry
    that names no such callable or one without an array parameter, and a
    class or override no signature uses all fail.
"""
import ast
import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vch_tpu
from vch_tpu.config import DELTA_SEP
from vch_tpu.config import ForwardSolverConfig1D as JaxConfig1D
from vch_tpu.config import ForwardSolverConfig2D as JaxConfig2D
from vch_tpu.config import OptimizationConfig as JaxOpt
from vch_tpu.control import cost as jcost
from vch_tpu.control import diagnostics as jdiag
from vch_tpu.control import targets as jtargets
from vch_tpu.control.problems import ControlProblem1D as JaxProblem1D
from vch_tpu.control.problems import ControlProblem2D as JaxProblem2D
from vch_tpu.models import forward1d as jf1d
from vch_tpu.models import timegrid as jtimegrid
from vch_tpu.models.adjoint1d import AdjointSolver1D as JaxAdjoint1D
from vch_tpu.models.adjoint2d import AdjointSolver2D as JaxAdjoint2D
from vch_tpu.models.adjoint_exact1d import ExactAdjoint1D as JaxExact1D
from vch_tpu.models.adjoint_exact2d import ExactAdjoint2D as JaxExact2D
from vch_tpu.models.forward2d import ForwardSolver2D as JaxSolver2D
from vch_tpu.models.lowmem import LowMemPipeline1D as JaxLowMem1D
from vch_tpu.models.lowmem import LowMemPipeline2D as JaxLowMem2D
from vch_tpu.ops import potential as jpot
from vch_tpu.ops import stability as jstab

from vch_tpu_torch.config import (ForwardSolverConfig1D, ForwardSolverConfig2D,
                                  OptimizationConfig)
from vch_tpu_torch.control import cost as tcost
from vch_tpu_torch.control import diagnostics as tdiag
from vch_tpu_torch.control import targets as ttargets
from vch_tpu_torch.control.problems import ControlProblem1D, ControlProblem2D
from vch_tpu_torch.models import forward1d as tf1d
from vch_tpu_torch.models import timegrid as ttimegrid
from vch_tpu_torch.models.adjoint1d import AdjointSolver1D
from vch_tpu_torch.models.adjoint2d import AdjointSolver2D
from vch_tpu_torch.models.adjoint_exact1d import ExactAdjoint1D
from vch_tpu_torch.models.adjoint_exact2d import ExactAdjoint2D
from vch_tpu_torch.models.forward2d import ForwardSolver2D
from vch_tpu_torch.models.lowmem import LowMemPipeline1D, LowMemPipeline2D
from vch_tpu_torch.ops import potential as tpot
from vch_tpu_torch.ops import stability as tstab

torch.set_num_threads(2)

TOL = 1e-12
CPU = "cpu"
# a float32 card tensor's refusal, word for word
CARD_REFUSAL = ("can't convert cuda:0 device type tensor to numpy. Use "
                "Tensor.cpu() to copy the tensor to host memory first.")

CFG1 = dict(N=20, T=0.05, dt_initial=0.01)
CFG2 = dict(Nx=12, Ny=12, T=0.03, dt_initial=0.01)
B1D, B2D = (0.3, 13.0, 0.0019), (5.0, 10.0, 1e-4)


def _numpy(a):
    return a


def _tensor(a):
    return torch.from_numpy(np.array(a))


# --- shared numpy inputs and solvers (one of each per process) ------------

@functools.lru_cache(maxsize=None)
def _solver(dim):
    if dim == 1:
        return tf1d.ForwardSolver1D(ForwardSolverConfig1D(**CFG1),
                                    device=CPU)
    return ForwardSolver2D(ForwardSolverConfig2D(**CFG2), device=CPU)


@functools.lru_cache(maxsize=None)
def _jax_solver(dim):
    if dim == 1:
        return jf1d.ForwardSolver1D(JaxConfig1D(**CFG1))
    return JaxSolver2D(JaxConfig2D(**CFG2))


@functools.lru_cache(maxsize=None)
def _inputs(dim):
    """A control, an initial field, the targets, a state for one Newton
    solve and the time grid, from a numpy seed."""
    s = _solver(dim)
    rng = np.random.default_rng(20 + dim)
    space = ((s.config.N + 1,) if dim == 1
             else (s.config.Nx + 1, s.config.Ny + 1))
    frames = (s.M + 1,) + space
    phi0 = np.clip(s.default_initial_phi()
                   + 0.02 * rng.standard_normal(space), -0.9, 0.9)
    d = dict(control=0.2 * rng.standard_normal(frames), phi0=phi0,
             phi_Q=0.3 * rng.standard_normal(frames),
             phi_T=0.3 * rng.standard_normal(space),
             mu=0.1 * rng.standard_normal(space),
             w_old=0.1 * rng.standard_normal(space),
             w_new=0.1 * rng.standard_normal(space),
             w_hist=0.1 * rng.standard_normal(frames),
             r=0.05 * rng.standard_normal(frames),
             t_hist=np.asarray(s.t_hist, np.float64))
    return d


@functools.lru_cache(maxsize=None)
def _phi_hist_np(dim):
    """The port's trajectory under the shared control, as numpy: the
    history both packages' adjoints get in (a)."""
    d = _inputs(dim)
    phi = _solver(dim).simulate(control=d["control"],
                                initial_phi=d["phi0"])[0].numpy()
    return phi


# --- the cases: (port(form), vch_tpu()) ----------------------------------

def _simulate(dim):
    def port(inp):
        d, s = _inputs(dim), _solver(dim)
        out = s.simulate(control=inp(d["control"]),
                         initial_phi=inp(d["phi0"]))
        return out, tuple(s.last_stats)

    def ref():
        d, s = _inputs(dim), _jax_solver(dim)
        out = s.simulate(control=d["control"], initial_phi=d["phi0"])
        return out, tuple(int(v) for v in s.last_stats)
    return port, ref


def _adjoint_run(dim):
    cls, jcls = ((AdjointSolver1D, JaxAdjoint1D) if dim == 1
                 else (AdjointSolver2D, JaxAdjoint2D))
    b1, b2 = (B1D if dim == 1 else B2D)[:2]

    def port(inp):
        d, s = _inputs(dim), _solver(dim)
        if inp is _numpy:
            phi_hist = _phi_hist_np(dim)
        else:      # simulate's own output, straight into run
            phi_hist = s.simulate(control=inp(d["control"]),
                                  initial_phi=inp(d["phi0"]))[0]
        adj = cls(s.config, device=CPU)
        return adj.run(phi_hist, inp(d["t_hist"]), b1, b2, inp(d["phi_Q"]),
                       inp(d["phi_T"]))

    def ref():
        d = _inputs(dim)
        adj = jcls(_jax_solver(dim).config)
        return adj.run(_phi_hist_np(dim), d["t_hist"], b1, b2, d["phi_Q"],
                       d["phi_T"])
    return port, ref


def _initialize_mu(dim):
    def port(inp):
        d = _inputs(dim)
        return _solver(dim).initialize_mu(inp(d["phi0"]), inp(d["w_new"]))

    def ref():
        d = _inputs(dim)
        return _jax_solver(dim).initialize_mu(d["phi0"], d["w_new"])
    return port, ref


def _energy_history(dim):
    def port(inp):
        return _solver(dim).energy_history(inp(_phi_hist_np(dim)),
                                           inp(_inputs(dim)["w_hist"]))

    def ref():
        return _jax_solver(dim).energy_history(_phi_hist_np(dim),
                                               _inputs(dim)["w_hist"])
    return port, ref


def _newton_residual_history(dim):
    keys = ("phi0", "mu", "w_old", "w_new")

    def port(inp):
        d, s = _inputs(dim), _solver(dim)
        return s.newton_residual_history(*(inp(d[k]) for k in keys),
                                         s.config.dt_initial)

    def ref():
        d, s = _inputs(dim), _jax_solver(dim)
        return s.newton_residual_history(*(d[k] for k in keys),
                                         s.config.dt_initial)
    return port, ref


def _newton_1d_one_member():
    """vch_tpu's (N+1,) form on the dense Schur path, the histories and
    the solve count included."""
    def args(s, conv):
        d, cfg = _inputs(1), s.config
        L = conv(_solver(1).L.numpy())
        return ((L,) + tuple(conv(d[k]) for k in
                             ("phi0", "mu", "w_old", "w_new"))
                + (cfg.dt_initial, cfg.tau, cfg.c1, cfg.c2, cfg.kappa,
                   DELTA_SEP, cfg.newton_tol, cfg.newton_max_iter))

    def port(inp):
        return tf1d.newton_1d(*args(_solver(1), _tensor),
                              record_history=True, return_iters=True)

    def ref():
        return jf1d.newton_1d(*args(_jax_solver(1), jnp.asarray),
                              record_history=True, return_iters=True)
    return port, ref


def _cost(dim, breakdown):
    """The fields as tensors (the cost is a primitive over them), the grids
    x, y, t_hist in the form under test."""
    name = ("cost_breakdown_" if breakdown else "calculate_cost_") + f"{dim}d"
    weights = (B1D if dim == 1 else B2D) + (1e-3,)

    def call(mod, field, grid):
        d, s = _inputs(dim), _solver(dim)
        fields = (field(_phi_hist_np(dim)), field(d["control"]),
                  field(d["phi_Q"]), field(d["phi_T"]))
        grids = ((s.x,) if dim == 1 else (s.x, s.y)) + (d["t_hist"],)
        return getattr(mod, name)(*fields, *(grid(np.asarray(g))
                                             for g in grids), *weights)

    return (lambda inp: call(tcost, _tensor, inp),
            lambda: call(jcost, jnp.asarray, _numpy))


def _targets(dim):
    def call(fn, inp):
        d, s = _inputs(dim), _solver(dim)
        cfg = s.config
        if dim == 1:
            return fn(inp(np.asarray(s.x)), inp(d["t_hist"]), inp(d["phi0"]),
                      cfg.Lx, cfg.T)
        return fn(inp(np.asarray(s.x)), inp(np.asarray(s.y)),
                  inp(d["t_hist"]), inp(d["phi0"]), cfg.Lx, cfg.Ly, cfg.T)
    name = f"build_targets_{dim}d"
    return (lambda inp: call(getattr(ttargets, name), inp),
            lambda: call(getattr(jtargets, name), _numpy))


def _sparsity():
    def call(fn, inp):
        u = np.where(np.abs(_inputs(2)["control"]) < 0.1, 0.0,
                     _inputs(2)["control"])
        return fn(inp(u), inp(_inputs(2)["r"]), 0.05, verbose=False)
    return (lambda inp: call(tdiag.verify_sparsity_condition, inp),
            lambda: call(jdiag.verify_sparsity_condition, _numpy))


def _cone_direction():
    def call(fn, inp):
        d = _inputs(1)
        u = np.clip(np.where(np.abs(d["control"]) < 0.1, 0.0, d["control"]),
                    -0.3, 0.3)
        return fn(inp(u), inp(d["r"]), -0.3, 0.3, 0.02, 1e-3,
                  np.random.default_rng(5))
    return (lambda inp: call(tdiag.generate_critical_cone_direction, inp),
            lambda: call(jdiag.generate_critical_cone_direction, _numpy))


def _second_order():
    """vch_tpu's `forward=` form on a toy linear forward and quadratic cost
    (the problems' own probes are in tests/test_torch_contracts.py). The
    step epsilon = 0.1 keeps the finite-difference quotient's division by
    eps^2 / 2 from lifting the packages' summation-order roundoff to
    TOL's size."""
    def port(inp):
        d = _inputs(1)
        return tdiag.approximate_second_order_condition(
            lambda u: 2.0 * u, lambda phi, u: 0.5 * torch.sum(phi * phi),
            inp(d["control"]), inp(d["r"]), inp(2.0 * d["control"]), 1e-3,
            0.02, -1.0, 1.0, num_directions=3, epsilon=0.1, device=CPU)

    def ref():
        d = _inputs(1)
        return jdiag.approximate_second_order_condition(
            lambda u: 2.0 * u, lambda phi, u: 0.5 * jnp.sum(phi * phi),
            d["control"], d["r"], 2.0 * d["control"], 1e-3, 0.02, -1.0, 1.0,
            num_directions=3, epsilon=0.1)
    return port, ref


def _free_energy(dim):
    def call(mod, conv):
        s = _solver(dim)
        cfg = s.config
        phi, w = conv(_phi_hist_np(dim)), conv(_inputs(dim)["w_hist"])
        if dim == 1:
            return mod.free_energy_1d(phi, cfg.kappa, cfg.c1, cfg.c2, s.h,
                                      w=w, eps=1e-8)
        return mod.free_energy_2d(phi, cfg.kappa, cfg.c1, cfg.c2, s.hx, s.hy,
                                  w=w, eps=0.5 * DELTA_SEP)
    return (lambda inp: call(tpot, _tensor),
            lambda: call(jpot, jnp.asarray))


def _dispersion():
    k = np.pi * np.arange(1, 13) / 2.0
    return (lambda inp: tstab.dispersion_relation(0.75, 1.0, 9e-4, 0.05,
                                                  inp(k)),
            lambda: jstab.dispersion_relation(0.75, 1.0, 9e-4, 0.05, k))


def _t_history():
    dts = np.asarray(_solver(2).dts_np, np.float64)
    return (lambda inp: ttimegrid.t_history(inp(dts), 0.03),
            lambda: jtimegrid.t_history(dts, 0.03))


def _exact_gradient(dim):
    cls, jcls = ((ExactAdjoint1D, JaxExact1D) if dim == 1
                 else (ExactAdjoint2D, JaxExact2D))
    b = B1D if dim == 1 else B2D

    def call(adj, inp):
        d = _inputs(dim)
        g, J = adj.gradient(inp(d["control"]), inp(d["phi0"]), *b,
                            phi_Q=inp(d["phi_Q"]), phi_T=inp(d["phi_T"]))
        return g, J
    return (lambda inp: call(cls(_solver(dim).config, device=CPU), inp),
            lambda: call(jcls(_jax_solver(dim).config), _numpy))


def _lowmem_adjoint_r(dim):
    cls, jcls = ((LowMemPipeline1D, JaxLowMem1D) if dim == 1
                 else (LowMemPipeline2D, JaxLowMem2D))
    b1, b2 = (B1D if dim == 1 else B2D)[:2]

    def call(pipe, inp):
        d = _inputs(dim)
        return pipe.adjoint_r(inp(d["control"]), inp(d["phi0"]), b1, b2,
                              inp(d["phi_Q"]), inp(d["phi_T"]))
    return (lambda inp: call(cls(_solver(dim).config, K=2, device=CPU), inp),
            lambda: call(jcls(_jax_solver(dim).config, K=2), _numpy))


def _problem(dim):
    """The constructor's initial_phi: the baseline march, the targets and
    the host phi0 built from it."""
    cls, jcls = ((ControlProblem1D, JaxProblem1D) if dim == 1
                 else (ControlProblem2D, JaxProblem2D))
    names = ("phi0", "phi_hist0", "phi_T_target", "phi_Q_target")

    def port(inp):
        p = cls(_solver(dim).config, OptimizationConfig(),
                initial_phi=inp(_inputs(dim)["phi0"]), device=CPU)
        return ([getattr(p, n) for n in names]
                + [int(p.solver.last_stats.newton_solves)])

    def ref():
        p = jcls(_jax_solver(dim).config, JaxOpt(),
                 initial_phi=_inputs(dim)["phi0"])
        return ([getattr(p, n) for n in names]
                + [int(p.solver.last_stats.newton_solves)])
    return port, ref


# (vch_tpu module, qualified name) -> the case's (port(form), vch_tpu())
CASES = {
    ("models/forward1d.py", "ForwardSolver1D.simulate"): _simulate(1),
    ("models/forward2d.py", "ForwardSolver2D.simulate"): _simulate(2),
    ("models/adjoint1d.py", "AdjointSolver1D.run"): _adjoint_run(1),
    ("models/adjoint2d.py", "AdjointSolver2D.run"): _adjoint_run(2),
    ("models/forward1d.py", "ForwardSolver1D.initialize_mu"):
        _initialize_mu(1),
    ("models/forward2d.py", "ForwardSolver2D.initialize_mu"):
        _initialize_mu(2),
    ("models/forward1d.py", "ForwardSolver1D.energy_history"):
        _energy_history(1),
    ("models/forward2d.py", "ForwardSolver2D.energy_history"):
        _energy_history(2),
    ("models/forward1d.py", "ForwardSolver1D.newton_residual_history"):
        _newton_residual_history(1),
    ("models/forward2d.py", "ForwardSolver2D.newton_residual_history"):
        _newton_residual_history(2),
    ("models/forward1d.py", "newton_1d"): _newton_1d_one_member(),
    ("control/cost.py", "cost_breakdown_1d"): _cost(1, True),
    ("control/cost.py", "calculate_cost_1d"): _cost(1, False),
    ("control/cost.py", "cost_breakdown_2d"): _cost(2, True),
    ("control/cost.py", "calculate_cost_2d"): _cost(2, False),
    ("control/targets.py", "build_targets_1d"): _targets(1),
    ("control/targets.py", "build_targets_2d"): _targets(2),
    ("control/diagnostics.py", "verify_sparsity_condition"): _sparsity(),
    ("control/diagnostics.py", "generate_critical_cone_direction"):
        _cone_direction(),
    ("control/diagnostics.py", "approximate_second_order_condition"):
        _second_order(),
    ("ops/potential.py", "free_energy_1d"): _free_energy(1),
    ("ops/potential.py", "free_energy_2d"): _free_energy(2),
    ("ops/stability.py", "dispersion_relation"): _dispersion(),
    ("models/timegrid.py", "t_history"): _t_history(),
    ("models/adjoint_exact1d.py", "ExactAdjoint1D.gradient"):
        _exact_gradient(1),
    ("models/adjoint_exact2d.py", "ExactAdjoint2D.gradient"):
        _exact_gradient(2),
    ("models/lowmem.py", "LowMemPipeline1D.adjoint_r"): _lowmem_adjoint_r(1),
    ("models/lowmem.py", "LowMemPipeline2D.adjoint_r"): _lowmem_adjoint_r(2),
    ("control/problems.py", "ControlProblem1D.__init__"): _problem(1),
    ("control/problems.py", "ControlProblem2D.__init__"): _problem(2),
}
CASE_IDS = [f"{rel}::{name}" for rel, name in CASES]


# --- comparison ----------------------------------------------------------

def _leaves(out):
    """The arrays of a result, in order: tensors read to the host, vch_tpu's
    arrays, numbers and dict values (by key) as numpy; a list of numbers
    (a residual history) as one array."""
    if isinstance(out, dict):
        return [a for k in sorted(out) for a in _leaves(out[k])]
    if isinstance(out, list) and out and all(
            isinstance(o, (float, np.floating)) for o in out):
        return [np.asarray(out)]
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _leaves(o)]
    if torch.is_tensor(out):
        return [out.detach().cpu().numpy()]
    return [np.asarray(out)]


def _assert_close(got, ref, tol=TOL):
    g, r = _leaves(got), _leaves(ref)
    assert len(g) == len(r), (len(g), len(r))
    for i, (a, b) in enumerate(zip(g, r)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        if b.dtype.kind in "biu" or a.dtype.kind in "biu":
            assert np.array_equal(a, b), (i, a, b)
            continue
        nan = np.isnan(b)
        assert np.array_equal(np.isnan(a), nan), i
        if nan.all():
            continue
        a, b = a[~nan], b[~nan]
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
        assert err <= tol, (i, err)


def _assert_same_bits(got, base):
    g, b = _leaves(got), _leaves(base)
    assert len(g) == len(b)
    for i, (x, y) in enumerate(zip(g, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, (i, x.dtype,
                                                            y.dtype)
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), i


@pytest.fixture
def card(monkeypatch):
    """Tensors refuse numpy as a CUDA tensor does."""
    def refuse(self, *args, **kwargs):
        raise TypeError(CARD_REFUSAL)
    monkeypatch.setattr(torch.Tensor, "__array__", refuse)


@pytest.mark.parametrize("key", list(CASES), ids=CASE_IDS)
def test_call_form_matches_vch_tpu(key):
    port, ref = CASES[key]
    _assert_close(port(_numpy), ref())


@pytest.mark.parametrize("key", list(CASES), ids=CASE_IDS)
def test_port_tensors_on_the_emulated_card(key, request):
    port, _ = CASES[key]
    base = port(_numpy)
    request.getfixturevalue("card")
    with pytest.raises(TypeError, match="cuda:0 device type"):
        np.asarray(torch.zeros(1))
    _assert_same_bits(port(_tensor), base)


def test_newton_1d_one_member_is_the_batch_of_one():
    """The (N+1,) form is the (1, N+1) form without its batch axis, bit for
    bit; the batched form keeps its shapes."""
    s, d = _solver(1), _inputs(1)
    cfg = s.config
    fields = [torch.from_numpy(np.array(d[k]))
              for k in ("phi0", "mu", "w_old", "w_new")]
    kw = dict(tau=cfg.tau, c1=cfg.c1, c2=cfg.c2, kappa=cfg.kappa,
              delta_sep=DELTA_SEP, tol=cfg.newton_tol,
              max_iter=cfg.newton_max_iter, record_history=True,
              return_iters=True)
    one = tf1d.newton_1d(s.L, *fields, cfg.dt_initial, **kw)
    batch = tf1d.newton_1d(s.L, *(f[None] for f in fields), cfg.dt_initial,
                           **kw)
    assert [tuple(a.shape) for a in one] == [
        (cfg.N + 1,), (cfg.N + 1,), (cfg.newton_max_iter + 1,), ()]
    assert [tuple(a.shape) for a in batch] == [
        (1, cfg.N + 1), (1, cfg.N + 1), (1, cfg.newton_max_iter + 1), (1,)]
    for a, b in zip(one, batch):
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b[0]))


def test_grids_of_the_cost_are_not_copied():
    """Grids already in phi_hist's dtype on its device (the problems' hot
    path) are used as they are: as_tensor returns the same tensor."""
    from vch_tpu_torch.device import as_tensor
    x = torch.linspace(0.0, 1.0, 9, dtype=torch.float64)
    assert as_tensor(x, torch.float64, torch.device(CPU)) is x
    assert as_tensor(x) is x


def test_a_mismatched_shape_still_raises():
    s = _solver(2)
    bad = np.zeros((s.M, s.config.Nx + 1, s.config.Ny + 1))
    for form in (_numpy, _tensor):
        with pytest.raises(ValueError, match="control must be"):
            s.simulate(control=form(bad))


# --- (c) the coverage guard ----------------------------------------------

ROOT = Path(vch_tpu.__file__).resolve().parent
PALLAS_MODULES = {"ops/pallas_march.py", "ops/pallas_kernels.py"}
GUARD_DIRS = ("models", "control", "ops", "parallel", "utils", "viz")
GUARD_FILES = ("cli.py", "config.py")
METHODS = ("__init__", "__call__")

ARRAY_PARAMS = {
    "phi_hist", "t_hist", "phi_Q", "phi_Q_target", "phi_T_target", "phi_T",
    "dts", "u",
    "initial_phi", "w_old", "u_n", "u_np1", "L", "phi_new", "phi_old",
    "mu_new", "mu_old", "w_new", "phi", "w", "phi0", "control", "w_hist",
    "mu_init", "phi_T_ref", "state", "u0", "phi0_hist", "x", "y",
    "phi_initial", "u_optimal", "r_optimal", "u_star", "r_star", "phi_star",
    "r", "grad_smooth", "v", "vhat", "rhs", "b", "x0", "op", "spectral_op",
    "Rphi", "Rmu", "k", "b3_values", "kappa_values", "scenarios", "tree",
    "cost_history", "tracking_err_history", "terminal_err_history",
    "phi_final", "phi_natural_final", "phi_controlled_final", "phi_target"}
OTHER_PARAMS = {
    "config", "b1", "b2", "b3", "interpret", "batch", "ref_layout", "eps",
    "dt", "gamma", "tau", "c1", "c2", "kappa", "delta_sep", "tol",
    "max_iter", "record_history", "rtol", "stagnation_exit", "krylov_fixed",
    "krylov_tol", "return_iters", "krylov_max_iter", "use_pallas",
    "pallas_interpret", "pallas_variant", "K", "pipe", "T", "time_tol",
    "kappa_spar", "verbose", "u_min", "u_max", "rng", "tol_s",
    "handle_kink", "forward", "cost", "num_directions", "epsilon", "seed",
    "trial", "cost_k", "alpha_prev", "s", "adjoint", "opt_config",
    "settings", "error_norms", "search_mode", "adjoint_takes_u",
    "fwd_config", "choice_t", "choice_q", "gradient_mode", "result",
    "alpha", "threshold", "Lx", "Ly", "A_T", "k_tan", "n_nodes", "N", "Nx",
    "Ny", "h", "hx", "hy", "dtype", "apply_A", "apply_M", "n_iter",
    "dot_fn", "sync_pred", "apply_Phalf", "apply_Phalf_inv", "denom_of_lam",
    "fixed_iters", "amp", "enforce_zero_mean", "Nmodes",
    # parallel/
    "fn", "mesh", "n_in", "n_out", "alpha_max", "use_mesh",
    "straggler_batch", "speculative", "chunk_size", "fused_march",
    "materialize_phi_Q", "materialized_phi_Q", "hbm_limit_bytes", "safety",
    "n_devices", "devices", "coordinator_address", "num_processes",
    "process_id", "axis_name", "axis", "batch_axis", "grid_axis",
    "grid_shards",
    # utils/, viz/
    "path", "meta", "echo", "event", "logdir", "pgd_iters", "elapsed_s",
    "newton_solves", "name", "seconds", "title", "cmap", "prefix", "skip",
    "fps", "max_frames", "params",
    # cli.py, config.py
    "args", "argv", "c2_val", "info", "u_max_val", "iteration_count",
    "filepath", "two_d", "prompt", "config_model", "previous_instance"}
# (module, qualified name, parameter) -> True: an array where the name is
# elsewhere a number
PARAM_OVERRIDES = {
    ("ops/laplacian.py", "apply_laplacian_2d", "Lx"): True,
    ("ops/laplacian.py", "apply_laplacian_2d", "Ly"): True,
}

PRIMITIVE = ("a tensor primitive with no device parameter: it computes "
             "where its tensor arguments live (vch_tpu's jnp code turns "
             "numpy into device arrays implicitly, and the port's entry "
             "points resolve no device for host input); a numpy caller "
             "converts with vch_tpu_torch.device.as_tensor (ROADMAP C, "
             "'tensor primitives')")
KERNEL = ("a whole-march or whole-sweep kernel entry: the batched problems "
          "hand it contiguous tensors on the solver's device, and it is "
          "held against vch_tpu's Pallas kernel in interpret mode by "
          "tests/test_torch_march.py, test_torch_blocked.py and "
          "test_torch_lowmem.py (ROADMAP C, 'tensor primitives')")
ON_THE_CPU = ("tests/test_torch_batch_side_paths.py::"
              "test_prewarm_and_trial_memory_analysis_on_the_cpu")
PREWARM = ("on a CPU device it builds and runs nothing and returns None, "
           "which " + ON_THE_CPU + " holds; on the card it places the batch "
           "with run()'s own `_inputs`, which the BatchedProblem1D.run case "
           "holds on every call form, and chip_smoke.py phase 16c runs it "
           "on a batch of CUDA tensors (straggler_batch=2: one bucket)")
TRIAL_MEMORY = ("on a CPU device it returns None (PyTorch keeps no allocator "
                "statistics for host memory; vch_tpu's answer for a backend "
                "with no analysis), which " + ON_THE_CPU + " holds; on the "
                "card it places the batch with run()'s own `_inputs`, and "
                "chip_smoke.py phase 16c runs it on the list-valued batch "
                "and on a batch of CUDA tensors, their argument and output "
                "bytes equal")
LOOP = ("generic over the caller's forward, adjoint and cost, which fix the "
        "device and dtype: u0 and phi0_hist are those callables' tensors, "
        "as the problems pass them (ROADMAP C, 'tensor primitives')")

# (vch_tpu module, qualified name) -> the reason it is not a case of (a)
ALLOWED = {
    ("models/adjoint2d.py", "AdjointSolver2D.adjoint_fused_batch"): KERNEL,
    ("models/forward1d.py", "ForwardSolver1D.march_fused_batch"): KERNEL,
    ("models/forward2d.py", "ForwardSolver2D.march_fused_batch"): KERNEL,
    ("models/lowmem.py", "FusedLowMemBatch2D.forward"): KERNEL,
    ("models/lowmem.py", "FusedLowMemBatch2D.adjoint_r"): KERNEL,
    ("control/pgd.py", "ProximalGradientLoop.run"): LOOP,
    ("parallel/batch.py", "BatchedProblem1D.prewarm"): PREWARM,
    ("parallel/batch.py", "BatchedProblem1D.trial_memory_analysis"):
        TRIAL_MEMORY,
    ("models/forward1d.py", "solve_w"): PRIMITIVE,
    ("models/forward1d.py", "mu_residual"): PRIMITIVE,
    ("models/forward1d.py", "phi_residual"): PRIMITIVE,
    ("models/forward2d.py", "mu_residual_2d"): PRIMITIVE,
    ("models/forward2d.py", "phi_residual_2d"): PRIMITIVE,
    ("models/forward2d.py", "newton_2d"): PRIMITIVE + (
        "; its one-member form is held against vch_tpu by "
        "tests/test_torch_contracts.py"),
    ("control/prox.py", "calculate_gradient"): PRIMITIVE,
    ("control/prox.py", "perform_gradient_step"): PRIMITIVE,
    ("control/prox.py", "soft_threshold"): PRIMITIVE,
    ("control/prox.py", "proximal_step"): PRIMITIVE,
    ("ops/laplacian.py", "apply_laplacian_1d"): PRIMITIVE,
    ("ops/laplacian.py", "apply_laplacian_2d"): PRIMITIVE + (
        "; vch_tpu's call form is held by tests/test_torch_contracts.py"),
    ("ops/laplacian.py", "stencil_laplacian_1d"): PRIMITIVE,
    ("ops/laplacian.py", "stencil_laplacian_2d"): PRIMITIVE,
    ("ops/linsolve.py", "to_spectral"): PRIMITIVE,
    ("ops/linsolve.py", "from_spectral"): PRIMITIVE,
    ("ops/linsolve.py", "spectral_poly_solve"): PRIMITIVE,
    ("ops/linsolve.py", "bicgstab"): PRIMITIVE,
    ("ops/linsolve.py", "bicgstab_fixed"): PRIMITIVE,
    ("ops/linsolve.py", "bicgstab_split"): PRIMITIVE,
    ("ops/linsolve.py", "bicgstab_split_fixed"): PRIMITIVE,
    ("ops/linsolve.py", "newton_schur_solve_1d"): PRIMITIVE,
    ("ops/linsolve.py", "newton_schur_solve_1d_spectral"): PRIMITIVE,
    ("ops/linsolve.py", "newton_schur_solve_2d"): PRIMITIVE,
    ("ops/potential.py", "regularized_log"): PRIMITIVE,
    ("ops/potential.py", "f_prime"): PRIMITIVE,
    ("ops/potential.py", "fpp_log"): PRIMITIVE,
}


def _guarded_modules(root=ROOT):
    """The guarded modules' paths under `root`."""
    paths = [root / f for f in GUARD_FILES]
    for d in GUARD_DIRS:
        paths += sorted((root / d).rglob("*.py"))
    return [p for p in paths
            if p.relative_to(root).as_posix() not in PALLAS_MODULES]


def _public_callables(root=ROOT):
    """{(module, qualified name): [parameter, ...]} of the public functions
    and methods (and __init__ / __call__) of vch_tpu's guarded modules,
    `self` left out."""
    out = {}
    for path in _guarded_modules(root):
        rel = path.relative_to(root).as_posix()
        for node in ast.parse(path.read_text()).body:
            if (isinstance(node, ast.FunctionDef)
                    and not node.name.startswith("_")):
                out[(rel, node.name)] = _params(node)
            elif (isinstance(node, ast.ClassDef)
                  and not node.name.startswith("_")):
                for m in node.body:
                    if (isinstance(m, ast.FunctionDef)
                            and (not m.name.startswith("_")
                                 or m.name in METHODS)):
                        static = any(getattr(dec, "id", None)
                                     == "staticmethod"
                                     for dec in m.decorator_list)
                        params = _params(m)
                        out[(rel, f"{node.name}.{m.name}")] = (
                            params if static else params[1:])
    return out


def _params(fn):
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]


def coverage_failures(callables, cases, allowed, arrays, others, overrides):
    """What the guard reports: unclassed parameter names, callables with
    an array parameter in neither `cases` nor `allowed`, and stale
    entries."""
    fails, used = [], set()
    with_arrays = set()
    for key, params in sorted(callables.items()):
        for p in params:
            used.add(p)
            if (key + (p,)) in overrides:
                is_array = overrides[key + (p,)]
            elif p in arrays and p not in others:
                is_array = True
            elif p in others and p not in arrays:
                is_array = False
            else:
                fails.append(f"{key}: parameter {p!r} is classed "
                             f"{'twice' if p in arrays else 'nowhere'}")
                continue
            if is_array:
                with_arrays.add(key)
    for key in sorted(with_arrays):
        if key not in cases and key not in allowed:
            fails.append(f"{key}: an array parameter and no case or "
                         "allowlist entry")
    for name, table in (("case", cases), ("allowlist entry", allowed)):
        for key in sorted(table):
            if key not in callables:
                fails.append(f"stale {name} {key}: no such public callable")
            elif key not in with_arrays:
                fails.append(f"stale {name} {key}: no array parameter")
    for key in sorted(set(cases) & set(allowed)):
        fails.append(f"{key}: both a case and an allowlist entry")
    for p in sorted((arrays | others) - used):
        fails.append(f"stale class of {p!r}: no signature has it")
    for key in sorted(overrides):
        if key[:2] not in callables or key[2] not in callables[key[:2]]:
            fails.append(f"stale override {key}")
    return fails


def _all_cases():
    """CASES with those of the parallel/ and the file-writing cases."""
    import test_torch_call_forms_artifacts as artifacts
    import test_torch_call_forms_parallel as parallel
    return {**CASES, **parallel.CASES, **artifacts.CASES}


def test_every_array_entry_point_is_covered():
    fails = coverage_failures(_public_callables(), _all_cases(), ALLOWED,
                              ARRAY_PARAMS, OTHER_PARAMS, PARAM_OVERRIDES)
    assert not fails, "\n".join(fails)


def test_the_guard_sees_an_uncovered_or_stale_entry(tmp_path):
    callables, cases = _public_callables(), _all_cases()
    assert ({rel.split("/")[0] for rel, _ in callables}
            == set(GUARD_DIRS) | set(GUARD_FILES))
    new = dict(callables)
    new[("models/forward1d.py", "smooth")] = ["phi", "tau"]
    fails = coverage_failures(new, cases, ALLOWED, ARRAY_PARAMS,
                              OTHER_PARAMS, PARAM_OVERRIDES)
    assert fails == [f"{('models/forward1d.py', 'smooth')}: an array "
                     "parameter and no case or allowlist entry"]
    # an array-taking callable in each guarded folder and top-level file
    # of a package laid out as vch_tpu, found by the walk itself
    invented = {
        "parallel/grid.py": "def sweep_3d(fwd_config, b3_values): pass",
        "utils/stats.py": "class Summary:\n    def add(self, state): pass",
        "viz/extra.py": "def plot_rate(cost_history, path): pass",
        "cli.py": "def cmd_plot(args, phi_final): pass",
        "config.py": "def load_field(filepath, phi0): pass"}
    for rel, code in invented.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(code + "\n")
    found = _public_callables(tmp_path)
    fails = coverage_failures({**callables, **found}, cases, ALLOWED,
                              ARRAY_PARAMS, OTHER_PARAMS, PARAM_OVERRIDES)
    assert sorted(fails) == sorted(
        f"{key}: an array parameter and no case or allowlist entry"
        for key in [("parallel/grid.py", "sweep_3d"),
                    ("utils/stats.py", "Summary.add"),
                    ("viz/extra.py", "plot_rate"), ("cli.py", "cmd_plot"),
                    ("config.py", "load_field")])
    stale = {**ALLOWED, ("ops/grids.py", "grid_1d"): PRIMITIVE,
             ("ops/nowhere.py", "f"): PRIMITIVE}
    fails = coverage_failures(callables, cases, stale, ARRAY_PARAMS,
                              OTHER_PARAMS, PARAM_OVERRIDES)
    assert sorted(fails) == sorted([
        f"stale allowlist entry {('ops/grids.py', 'grid_1d')}: no array "
        "parameter",
        f"stale allowlist entry {('ops/nowhere.py', 'f')}: no such public "
        "callable"])
    new[("models/forward1d.py", "smooth")] = ["blob"]
    fails = coverage_failures(new, cases, ALLOWED, ARRAY_PARAMS,
                              OTHER_PARAMS | {"unused"}, PARAM_OVERRIDES)
    assert sorted(fails) == sorted([
        f"{('models/forward1d.py', 'smooth')}: parameter 'blob' is "
        "classed nowhere",
        "stale class of 'unused': no signature has it"])
