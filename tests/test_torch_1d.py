"""Port parity for the 1D family below the control problems: grids, the
seeded initial condition, the free energy, the cosine operators, both Newton
Schur solves, the per-step marcher and the adjoint sweep of
vch_tpu_torch against vch_tpu on the same numpy inputs and against the
reference's golden run tests/golden/ref_1d.npz; cost and targets.

Tolerances: float64 1e-10 for single operations (only summation order
differs) and 1e-12 relative for cost and targets; the golden trajectory 1e-9
absolute and the golden adjoint 1e-7 relative (1e-8 absolute for the spectral
r), the bounds of tests/test_forward_1d.py and tests/test_backward_1d.py;
float32 against vch_tpu's float32: 2e-5 absolute for the marcher (measured
3e-7 on 6 steps) and 2e-3 of |r|max for the adaptive adjoint sweep (two
float32 Krylov solves to a 1e-6 tolerance).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vch_tpu.config import DELTA_SEP, ForwardSolverConfig1D as JaxConfig1D
from vch_tpu.control import cost as jcost
from vch_tpu.control import targets as jtargets
from vch_tpu.models.adjoint1d import AdjointSolver1D as JaxAdjoint1D
from vch_tpu.models.forward1d import ForwardSolver1D as JaxSolver1D
from vch_tpu.ops import grids as jgrids
from vch_tpu.ops import linsolve as jls
from vch_tpu.ops import potential as jpot

from vch_tpu_torch.config import (ForwardSolverConfig1D, OptimizationConfig,
                                  PGDSettings)
from vch_tpu_torch.control import cost as tcost
from vch_tpu_torch.control import targets as ttargets
from vch_tpu_torch.models.adjoint1d import AdjointSolver1D
from vch_tpu_torch.models.forward1d import ForwardSolver1D
from vch_tpu_torch.ops import grids as tgrids
from vch_tpu_torch.ops import linsolve as tls
from vch_tpu_torch.ops import potential as tpot
from vch_tpu_torch.utils.convert import (config_from_vch_tpu,
                                         spectral_op_from_numpy)

torch.set_num_threads(2)
T64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)


def test_config_1d_defaults_and_dump_round_trip():
    jc = JaxConfig1D(N=64, T=0.5, dtype="float32", linsolve_1d="spectral",
                     forward_matmul_precision="high")
    tc = config_from_vch_tpu(jc.model_dump())
    assert isinstance(tc, ForwardSolverConfig1D)
    for k, v in jc.model_dump().items():
        assert getattr(tc, k) == v, k
    assert ForwardSolverConfig1D() == config_from_vch_tpu(
        JaxConfig1D().model_dump())
    with pytest.raises(ValueError, match="greater than c1"):
        ForwardSolverConfig1D(c1=1.0, c2=0.5)
    with pytest.raises(ValueError, match="linsolve_1d"):
        ForwardSolverConfig1D(linsolve_1d="lu")
    assert OptimizationConfig.defaults_1d() == OptimizationConfig()
    assert PGDSettings.defaults_1d() == PGDSettings()


def test_grid_ic_and_energy_match():
    for a, b in zip(tgrids.grid_1d(37, 1.5), jgrids.grid_1d(37, 1.5)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for seed in (42, 7):
        assert np.array_equal(
            tpot.init_phi_random_1d(128, DELTA_SEP, amp=0.01, seed=seed),
            jpot.init_phi_random_1d(128, DELTA_SEP, amp=0.01, seed=seed))
    rng = np.random.default_rng(0)
    phi = np.clip(0.5 * rng.standard_normal((3, 65)), -0.98, 0.98)
    w = rng.standard_normal((3, 65))
    got = tpot.free_energy_1d(T64(phi), 9e-4, 0.75, 1.0, 1 / 64, w=T64(w))
    ref = jpot.free_energy_1d(jnp.asarray(phi), 9e-4, 0.75, 1.0, 1 / 64,
                              w=jnp.asarray(w))
    assert np.abs(got.numpy() - np.asarray(ref)).max() < 1e-12


def test_initial_condition_is_the_golden_first_row(golden_1d):
    phi0 = tpot.init_phi_random_1d(128, DELTA_SEP, amp=0.01, seed=42)
    assert np.array_equal(phi0, golden_1d["phi_hist"][0])


def test_spectral_op_1d_matches_and_converts():
    jop = jls.make_spectral_op_1d(48, 1 / 48)
    top = tls.make_spectral_op_1d(48, 1 / 48)
    conv = spectral_op_from_numpy({k: np.asarray(v)
                                   for k, v in jop._asdict().items()})
    assert isinstance(conv, tls.SpectralOp1D)
    for name in top._fields:
        assert np.array_equal(getattr(top, name).numpy(),
                              np.asarray(getattr(jop, name))), name
        assert torch.equal(getattr(conv, name), getattr(top, name))
    v = T64(np.random.default_rng(1).standard_normal(49))
    back = (v @ top.Vinv.T) @ top.V.T
    assert (back - v).abs().max() < 1e-12


def _newton_state(B, n, seed=0):
    rng = np.random.default_rng(seed)
    phi = np.clip(0.4 * rng.standard_normal((B, n)), -0.9, 0.9)
    return phi, rng.standard_normal((B, n)), rng.standard_normal((B, n))


def test_dense_schur_solve_matches_per_member():
    N, dt, tau, c1, kappa = 48, 1e-2, 0.05, 0.75, 9e-4
    jop = jls.make_spectral_op_1d(N, 1 / N)
    top = tls.make_spectral_op_1d(N, 1 / N)
    phi, Rphi, Rmu = _newton_state(3, N + 1)
    got = tls.newton_schur_solve_1d(top.L, T64(phi), T64(Rphi), T64(Rmu), dt,
                                    tau, c1, kappa, DELTA_SEP)
    ref = jax.vmap(lambda p, a, b: jls.newton_schur_solve_1d(
        jop.L, p, a, b, dt, tau, c1, kappa, DELTA_SEP))(
            jnp.asarray(phi), jnp.asarray(Rphi), jnp.asarray(Rmu))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() < 1e-10 * np.abs(r).max()


@pytest.mark.parametrize("fixed", [None, 4])
def test_spectral_schur_solve_matches_per_member(fixed):
    N, dt, tau, c1, kappa = 48, 1e-2, 0.05, 0.75, 9e-4
    jop = jls.make_spectral_op_1d(N, 1 / N)
    top = tls.make_spectral_op_1d(N, 1 / N)
    phi, Rphi, Rmu = _newton_state(3, N + 1, seed=1)
    got = tls.newton_schur_solve_1d_spectral(
        top, T64(phi), T64(Rphi), T64(Rmu), dt, tau, c1, kappa, DELTA_SEP,
        fixed_iters=fixed)
    ref = jax.vmap(lambda p, a, b: jls.newton_schur_solve_1d_spectral(
        jop, p, a, b, dt, tau, c1, kappa, DELTA_SEP, fixed_iters=fixed))(
            jnp.asarray(phi), jnp.asarray(Rphi), jnp.asarray(Rmu))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() < 1e-10 * np.abs(r).max()
    dense = tls.newton_schur_solve_1d(top.L, T64(phi), T64(Rphi), T64(Rmu),
                                      dt, tau, c1, kappa, DELTA_SEP)
    if fixed is None:       # the adaptive solve reaches the exact step
        assert (got[0] - dense[0]).abs().max() < 1e-7 * dense[0].abs().max()


@pytest.mark.parametrize("linsolve", ["auto", "spectral"])
def test_forward_golden_trajectory_both_layouts(golden_1d, linsolve):
    g = golden_1d
    s = ForwardSolver1D(ForwardSolverConfig1D(linsolve_1d=linsolve),
                        device="cpu")
    assert s._use_spectral == (linsolve == "spectral")
    phi_ref, x, t_ref = s.simulate(ref_layout=True)
    assert np.abs(t_ref - g["t_hist"]).max() == 0.0
    assert np.array_equal(x, g["x"])
    assert np.abs(phi_ref.numpy() - g["phi_hist"]).max() < 1e-9
    assert s.last_stats.first_bad_step == -1
    assert 100 <= s.last_stats.newton_solves <= 100 * 50
    phi_core, _, t_core = s.simulate()
    assert phi_core.shape == (101, 129) and len(t_core) == 101
    assert torch.equal(phi_core, phi_ref[1:])
    assert torch.equal(phi_ref[0], phi_ref[1])


def test_forward_control_in_either_layout_and_newton_counts():
    cfg = dict(N=32, T=0.05)
    js = JaxSolver1D(JaxConfig1D(**cfg))
    ts = ForwardSolver1D(ForwardSolverConfig1D(**cfg), device="cpu")
    u = 0.5 * np.random.default_rng(0).standard_normal((js.M + 2, 33))
    jp, _, _ = js.simulate(control=u)              # reference layout in
    tp, _, _ = ts.simulate(control=u)
    tp_core, _, _ = ts.simulate(control=u[: ts.M + 1])
    assert np.abs(tp.numpy() - np.asarray(jp)).max() < 1e-10
    assert torch.equal(tp, tp_core)
    assert ts.last_stats.newton_solves == int(js.last_stats.newton_solves)
    with pytest.raises(ValueError, match="control must be"):
        ts.simulate(control=u[:3])


def test_forward_batched_marcher_is_vmap_of_the_scan():
    """Members with different Newton counts: each freezes at its own exit."""
    cfg = dict(N=32, T=0.04, newton_tol=1e-9)
    js = JaxSolver1D(JaxConfig1D(**cfg))
    ts = ForwardSolver1D(ForwardSolverConfig1D(**cfg), device="cpu")
    rng = np.random.default_rng(2)
    x = np.linspace(0, 1, 33)
    phi0 = np.stack([jpot.init_phi_random_1d(32, DELTA_SEP, seed=s)
                     + a * np.cos(np.pi * x)
                     for s, a in ((1, 0.0), (2, 0.5), (3, 0.8))])
    u = rng.standard_normal((3, js.M + 1, 33))
    jp, st = jax.vmap(js._march_impl)(jnp.asarray(u), jnp.asarray(phi0))
    tp, ns, bad = ts._march_batch(T64(u), T64(phi0))
    assert np.abs(tp.numpy() - np.asarray(jp)).max() < 1e-10
    assert ns.tolist() == np.asarray(st.newton_solves).tolist()
    assert len(set(ns.tolist())) > 1 and (bad == -1).all()


def test_forward_float32_spectral_matches_vch_tpu():
    cfg = dict(N=64, T=0.06, dtype="float32", newton_tol=2e-4)
    js = JaxSolver1D(JaxConfig1D(**cfg))
    ts = ForwardSolver1D(ForwardSolverConfig1D(**cfg), device="cpu")
    assert ts._use_spectral and ts._krylov_fixed == 4 and ts._stagnation
    jp, _, _ = js.simulate()
    tp, _, _ = ts.simulate()
    assert tp.dtype == torch.float32
    assert np.abs(tp.numpy() - np.asarray(jp)).max() < 2e-5
    assert ts.last_stats.newton_solves == int(js.last_stats.newton_solves)


def test_forward_mass_energy_and_sanitizer():
    ts = ForwardSolver1D(ForwardSolverConfig1D(N=32, T=0.05), device="cpu")
    phi, _, _ = ts.simulate()
    mass = (ts.wts * phi).sum(dim=-1)
    assert (mass - mass[0]).abs().max() < 1e-12
    E = ts.energy_history(phi)
    assert E.shape == (6,) and bool((E[1:] <= E[:-1] + 1e-12).all())
    with pytest.raises(RuntimeError, match="Non-finite mass defect at time "
                                           "step 0"):
        ts.simulate(initial_phi=np.full(33, np.nan))


def test_newton_residual_history_converges_quadratically():
    js = JaxSolver1D(JaxConfig1D())
    ts = ForwardSolver1D(device="cpu")
    phi0 = ts.default_initial_phi()
    w = np.zeros(129)
    mu0 = ts.initialize_mu(T64(phi0), T64(w)).numpy()
    assert np.abs(mu0 - np.asarray(js.initialize_mu(
        jnp.asarray(phi0), jnp.asarray(w)))).max() < 1e-10
    _, _, jh = js.newton_residual_history(phi0, mu0, w, w, 1e-2)
    _, _, th = ts.newton_residual_history(phi0, mu0, w, w, 1e-2)
    assert len(th) == len(jh) and th[-1] < 1e-6
    assert np.allclose(th, jh, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("linsolve", ["auto", "spectral"])
def test_adjoint_golden_both_layouts(golden_1d, linsolve):
    g = golden_1d
    adj = AdjointSolver1D(ForwardSolverConfig1D(linsolve_1d=linsolve),
                          device="cpu")
    p, q, r = (v.numpy() for v in adj.run(
        g["phi_hist"], g["t_hist"], 0.3, 13.0, g["phi_Q_target"],
        g["phi_T_target"]))
    if linsolve == "auto":
        for name, v in (("p", p), ("q", q)):
            assert np.abs(v - g[name]).max() < 1e-7 * np.abs(g[name]).max()
        assert np.abs(r - g["r"]).max() < 1e-7 * max(np.abs(g["r"]).max(),
                                                     1e-3)
    else:
        assert np.abs(r - g["r"]).max() < 1e-8
    # the duplicated t = 0 row stays zero; the core layout gives the rest
    assert not p[0].any() and not q[0].any() and not r[0].any()
    pc, qc, rc = (v.numpy() for v in adj.run(
        g["phi_hist"][1:], g["t_hist"][1:], 0.3, 13.0, g["phi_Q_target"][1:],
        g["phi_T_target"]))
    assert pc.shape == (101, 129)
    assert np.array_equal(pc, p[1:]) and np.array_equal(rc, r[1:])


def test_adjoint_float32_spectral_matches_vch_tpu(golden_1d):
    g = golden_1d
    cfg = dict(dtype="float32", newton_tol=2e-4)
    ja = JaxAdjoint1D(JaxConfig1D(**cfg))
    ta = AdjointSolver1D(ForwardSolverConfig1D(**cfg), device="cpu")
    assert ta._use_spectral and ta._krylov_tol == 1e-6
    args = (g["phi_hist"], g["t_hist"], 0.3, 13.0, g["phi_Q_target"],
            g["phi_T_target"])
    jr = np.asarray(ja.run(*args)[2])
    tr = ta.run(*args)[2].numpy()
    scale = np.abs(g["r"]).max()
    assert np.abs(tr - jr).max() < 2e-3 * scale
    assert np.abs(tr - g["r"]).max() < 2 * np.abs(jr - g["r"]).max() + 1e-3 * scale


def test_adjoint_batched_sweep_is_vmap_of_the_scan(golden_1d):
    g = golden_1d
    ja = JaxAdjoint1D(JaxConfig1D(linsolve_1d="spectral"))
    ta = AdjointSolver1D(ForwardSolverConfig1D(linsolve_1d="spectral"),
                         device="cpu")
    rng = np.random.default_rng(0)
    hist = np.stack([g["phi_hist"][:12], g["phi_hist"][30:42]])
    hist[1] += 1e-3 * rng.standard_normal(hist[1].shape)
    dts = np.diff(g["t_hist"][:12])
    phiQ = np.stack([g["phi_Q_target"][:12]] * 2)
    phiT = np.stack([g["phi_T_target"], 0.5 * g["phi_T_target"]])
    b1, b2 = np.array([0.3, 1.0]), np.array([13.0, 5.0])
    jr = jax.vmap(ja._run_impl, in_axes=(0, None, 0, 0, 0, 0))(
        jnp.asarray(hist), jnp.asarray(dts), jnp.asarray(b1), jnp.asarray(b2),
        jnp.asarray(phiQ), jnp.asarray(phiT))
    tr = ta._run_batch(T64(hist), T64(dts), T64(b1)[:, None],
                       T64(b2)[:, None], T64(phiQ), T64(phiT))
    for t, j in zip(tr, jr):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() < 1e-8 * np.abs(j).max()


def test_cost_and_targets_1d_match():
    rng = np.random.default_rng(0)
    x = np.linspace(0, 1, 33)
    t = np.concatenate([[0.0], np.linspace(0, 0.4, 9)])
    phi0 = 0.01 * rng.standard_normal(33)
    for ct in (1, 2, 3):
        for cq in (1, 2):
            got = ttargets.build_targets_1d(x, t, phi0, 1.0, 0.4, ct, cq)
            ref = jtargets.build_targets_1d(x, t, phi0, 1.0, 0.4, ct, cq)
            for a, b in zip(got, ref):
                assert np.array_equal(a, b)
    phi_T, phi_Q = got = ttargets.build_targets_1d(x, t, phi0, 1.0, 0.4)
    phi = rng.standard_normal((2, 10, 33))
    u = rng.standard_normal((2, 10, 33))
    b = [np.array([0.3, 1.0]), np.array([13.0, 2.0]), np.array([1e-3, 2e-3]),
         np.array([9e-5, 1e-4])]
    got = tcost.cost_breakdown_1d(T64(phi), T64(u), T64(phi_Q), T64(phi_T),
                                  T64(x), T64(t), *[T64(v) for v in b])
    ref = jax.vmap(lambda p, uu, *bb: jcost.cost_breakdown_1d(
        p, uu, jnp.asarray(phi_Q), jnp.asarray(phi_T), x, t, *bb))(
            jnp.asarray(phi), jnp.asarray(u), *[jnp.asarray(v) for v in b])
    for a, r in zip(got, ref):
        r = np.asarray(r)
        assert np.abs(a.numpy() - r).max() < 1e-12 * np.abs(r).max()
    total = tcost.calculate_cost_1d(T64(phi), T64(u), T64(phi_Q), T64(phi_T),
                                    T64(x), T64(t), *[T64(v) for v in b])
    assert torch.allclose(total, sum(got), rtol=0, atol=0)
