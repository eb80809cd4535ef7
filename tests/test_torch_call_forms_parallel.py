"""vch_tpu's call forms through the port's parallel/ entry points, on the CPU
in float64: sweep_1d and sweep_2d, the batched problem's run, shard_batch and
the grid-sharded solvers' inner and outer APIs.

The same two checks as tests/test_torch_call_forms.py, whose coverage guard
counts the cases here:

(a) the port on host numpy (lists for the sweep values) against vch_tpu on
    the same inputs (jnp values for the sweeps), within the case's
    tolerance: the sweeps and shard_batch bit for bit; the batched run
    1e-12 relative to each result's max |.|; the grid-sharded forward
    1e-8 and the adjoint 1e-7 times the field's scale (vch_tpu's own
    spatial gates, tests/test_torch_spatial.py); every count equal;
(b) on the emulated card (`torch.Tensor.__array__` raises a CUDA tensor's
    TypeError), the port on tensors gives the numpy run's results bit for
    bit.

The mesh cases run the port in a gloo world of 1 made in this process
(parallel/mesh.py `initialize_distributed`: a FileStore in a temporary
directory, so no port is opened) and destroyed after each call
(`test_torch_dist_cases.own_world`), and vch_tpu on a one-device CPU mesh.
At world size 1 a rank's row block is the whole field.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import test_torch_call_forms as cf
import test_torch_dist_cases as dist_cases
from test_torch_call_forms import card  # noqa: F401  (the fixture)
from vch_tpu.config import ForwardSolverConfig1D as JaxConfig1D
from vch_tpu.config import ForwardSolverConfig2D as JaxConfig2D
from vch_tpu.parallel import batch as jbatch
from vch_tpu.parallel import mesh as jmesh
from vch_tpu.parallel import spatial as jspatial

from vch_tpu_torch.config import (DELTA_SEP, ForwardSolverConfig1D,
                                  ForwardSolverConfig2D)
from vch_tpu_torch.ops.potential import init_phi_random_2d
from vch_tpu_torch.parallel import batch as tbatch
from vch_tpu_torch.parallel import mesh as tmesh
from vch_tpu_torch.parallel import spatial as tspatial

SWEEP = dict(b3_values=[1e-3, 5e-3], kappa_values=[5e-5, 2e-4])
FIELDS = ("phi0", "phi_T", "phi_Q", "b1", "b2", "b3", "kappa_spar")
GRID = dict(Nx=31, Ny=24, T=0.05, dt_initial=1e-2)
BITS = None                          # a case's tolerance: bit for bit
FORWARD_TOL, ADJOINT_TOL = 1e-8, 1e-7
B1, B2 = 5.0, 10.0


def _batch_fields(sc):
    return [getattr(sc, f) for f in FIELDS] + [sc.u_min, sc.u_max]


# --- the sweeps and the batched run ------------------------------------------

def _sweep(dim):
    name = f"sweep_{dim}d"
    kw = cf.CFG1 if dim == 1 else cf.CFG2
    cfg = (ForwardSolverConfig1D if dim == 1 else ForwardSolverConfig2D)(**kw)
    jcfg = (JaxConfig1D if dim == 1 else JaxConfig2D)(**kw)

    def port(inp):
        return _batch_fields(getattr(tbatch, name)(
            cfg, **{k: inp(v) for k, v in SWEEP.items()}))

    def ref():
        return _batch_fields(getattr(jbatch, name)(
            jcfg, **{k: jnp.asarray(v) for k, v in SWEEP.items()}))
    return port, ref, BITS


RUN_KEYS = ("u", "r", "phi", "cost_history", "alpha", "advisor_alpha",
            "ls_trials", "newton_solves", "converged", "iterations")


def _batched_run():
    """Two PGD iterations of the 1D batched problem on the scan path (the
    CPU's route in float64 in both packages), the scenario batch's arrays
    in the form under test."""
    def port(inp):
        cfg = ForwardSolverConfig1D(**cf.CFG1)
        sc = tbatch.sweep_1d(cfg, **SWEEP)
        sc = dataclasses.replace(sc, **{f: inp(getattr(sc, f))
                                        for f in FIELDS})
        out = tbatch.BatchedProblem1D(cfg, device=cf.CPU).run(
            sc, max_iter=2, verbose=False)
        return {k: out[k] for k in RUN_KEYS}

    def ref():
        cfg = JaxConfig1D(**cf.CFG1)
        out = jbatch.BatchedProblem1D(cfg).run(
            jbatch.sweep_1d(cfg, **SWEEP), max_iter=2, verbose=False)
        return {k: out[k] for k in RUN_KEYS}
    return port, ref, cf.TOL


# --- the mesh ----------------------------------------------------------------

def _jax_mesh(name):
    return Mesh(np.array(jax.devices()[:1]), (name,))


def _shard_batch():
    rng = np.random.default_rng(7)
    tree = dict(phi0=rng.standard_normal((4, 13, 13)),
                b3=rng.standard_normal(4))

    def port(inp):
        with dist_cases.own_world():
            mesh = tmesh.make_mesh(device=cf.CPU)
            return tmesh.shard_batch({k: inp(v) for k, v in tree.items()},
                                     mesh)

    def ref():
        return jmesh.shard_batch(tree, jmesh.make_mesh(1))
    return port, ref, BITS


# --- the grid-sharded solvers ----------------------------------------------

@functools.lru_cache(maxsize=None)
def _grid_inputs():
    """A control, an initial field, the port's trajectory under them, the
    targets and the step sizes, from a numpy seed."""
    cfg = ForwardSolverConfig2D(**GRID)
    rng = np.random.default_rng(31)
    with dist_cases.own_world():
        fwd = tspatial.GridShardedForward2D(cfg, device=cf.CPU)
        shape = (fwd.M + 1, cfg.Nx + 1, cfg.Ny + 1)
        u = 0.05 * rng.standard_normal(shape)
        phi0 = np.clip(init_phi_random_2d(cfg.Nx, cfg.Ny, DELTA_SEP, amp=0.1,
                                          seed=42)
                       + 0.02 * rng.standard_normal(shape[1:]), -0.9, 0.9)
        phi_hist = fwd.march(torch.from_numpy(u),
                             torch.from_numpy(phi0))[0].numpy()
        return dict(u=u, phi0=phi0, phi_hist=phi_hist,
                    phi_Q=0.3 * rng.standard_normal(shape),
                    phi_T=0.3 * rng.standard_normal(shape[1:]),
                    dts=np.asarray(fwd.dts_np, np.float64),
                    t_hist=np.asarray(fwd.t_hist, np.float64))


@functools.lru_cache(maxsize=None)
def _jax_grid(kind):
    cls = (jspatial.GridShardedForward2D if kind == "forward"
           else jspatial.GridShardedAdjoint2D)
    return cls(JaxConfig2D(**GRID), mesh=_jax_mesh("gx"))


def _in_world(make, call):
    """call(make(config)) in a gloo world of 1, the solver on the CPU."""
    with dist_cases.own_world():
        return call(make(ForwardSolverConfig2D(**GRID), device=cf.CPU))


def _march():
    def port(inp):
        d = _grid_inputs()
        return _in_world(tspatial.GridShardedForward2D,
                         lambda s: s.march(inp(d["u"]), inp(d["phi0"])))

    def ref():
        d = _grid_inputs()
        return _jax_grid("forward").march(d["u"], d["phi0"])
    return port, ref, FORWARD_TOL


def _simulate():
    def stats(s):
        return int(s.last_stats.newton_solves), int(
            s.last_stats.first_bad_step)

    def port(inp):
        d = _grid_inputs()
        return _in_world(tspatial.GridShardedForward2D, lambda s: (
            s.simulate(control=inp(d["u"]), initial_phi=inp(d["phi0"])),
            stats(s)))

    def ref():
        d, s = _grid_inputs(), _jax_grid("forward")
        return s.simulate(control=d["u"], initial_phi=d["phi0"]), stats(s)
    return port, ref, FORWARD_TOL


def _run_impl():
    keys = ("phi_hist", "dts")

    def port(inp):
        d = _grid_inputs()
        return _in_world(tspatial.GridShardedAdjoint2D, lambda s: s.run_impl(
            *(inp(d[k]) for k in keys), B1, B2, inp(d["phi_Q"]),
            inp(d["phi_T"])))

    def ref():
        d = _grid_inputs()
        return _jax_grid("adjoint").run_impl(*(d[k] for k in keys), B1, B2,
                                             d["phi_Q"], d["phi_T"])
    return port, ref, ADJOINT_TOL


def _adjoint_run():
    keys = ("phi_hist", "t_hist")

    def port(inp):
        d = _grid_inputs()
        return _in_world(tspatial.GridShardedAdjoint2D, lambda s: s.run(
            *(inp(d[k]) for k in keys), B1, B2, inp(d["phi_Q"]),
            inp(d["phi_T"])))

    def ref():
        d = _grid_inputs()
        return _jax_grid("adjoint").run(*(d[k] for k in keys), B1, B2,
                                        d["phi_Q"], d["phi_T"])
    return port, ref, ADJOINT_TOL


def _problem():
    """The constructor's initial_phi: the host phi0 and the targets built
    from it."""
    names = ("phi0", "phi_T_target", "phi_Q_target", "x", "y", "t_hist")

    def port(inp):
        phi0 = _grid_inputs()["phi0"]
        return _in_world(
            lambda cfg, device: tspatial.GridShardedProblem2D(
                cfg, initial_phi=inp(phi0), device=device),
            lambda p: [getattr(p, n) for n in names])

    def ref():
        p = jspatial.GridShardedProblem2D(
            JaxConfig2D(**GRID), mesh=_jax_mesh("gx"),
            initial_phi=_grid_inputs()["phi0"])
        return [getattr(p, n) for n in names]
    return port, ref, cf.TOL


# (vch_tpu module, qualified name) -> (port(form), vch_tpu(), tolerance)
CASES = {
    ("parallel/batch.py", "sweep_1d"): _sweep(1),
    ("parallel/batch.py", "sweep_2d"): _sweep(2),
    ("parallel/batch.py", "BatchedProblem1D.run"): _batched_run(),
    ("parallel/mesh.py", "shard_batch"): _shard_batch(),
    ("parallel/spatial.py", "GridShardedForward2D.march"): _march(),
    ("parallel/spatial.py", "GridShardedForward2D.simulate"): _simulate(),
    ("parallel/spatial.py", "GridShardedAdjoint2D.run_impl"): _run_impl(),
    ("parallel/spatial.py", "GridShardedAdjoint2D.run"): _adjoint_run(),
    ("parallel/spatial.py", "GridShardedProblem2D.__init__"): _problem(),
}
CASE_IDS = [f"{rel}::{name}" for rel, name in CASES]


def assert_matches(got, ref, tol):
    """Within tol of vch_tpu (tests/test_torch_call_forms.py's measure), or
    bit for bit, dtypes included, where tol is BITS."""
    if tol is BITS:
        cf._assert_same_bits(got, ref)
    else:
        cf._assert_close(got, ref, tol)


@pytest.mark.parametrize("key", list(CASES), ids=CASE_IDS)
def test_call_form_matches_vch_tpu(key):
    port, ref, tol = CASES[key]
    assert_matches(port(cf._numpy), ref(), tol)


@pytest.mark.parametrize("key", list(CASES), ids=CASE_IDS)
def test_port_tensors_on_the_emulated_card(key, request):
    port = CASES[key][0]
    base = port(cf._numpy)
    request.getfixturevalue("card")
    with pytest.raises(TypeError, match="cuda:0 device type"):
        np.asarray(torch.zeros(1))
    cf._assert_same_bits(port(cf._tensor), base)

