"""Port parity for `fused_solve_precision`: the fused 2D march's Krylov
operator (apply_S's four products) at vch_tpu's default "bf16x3" and at
"default", against vch_tpu (Pallas kernels in interpret mode) left at its
own default or at solve_prec="bf16x3", never pinned to "highest".

Tolerances, each beside its case:
  - the product: 1e-6 relative to vch_tpu's `_make_mm` (float32 sums in
    another order); "default" against numpy's product of the bf16-rounded
    operands, 1e-6 relative in float32 and 1e-12 in float64;
  - the three plain marches: test_torch_march.py's gates, 1e-5 absolute in
    float32 and 1e-10 in float64, Newton counts and first_bad equal;
  - the batched problems: test_torch_batch.py's and test_torch_lowmem.py's,
    costs 2e-4 relative, Newton solves, trials and straggler rounds equal;
  - ControlProblem2D with its trials on the fused march: costs 2e-5
    relative (test_torch_control2d.py's float32 bound), trials equal.
On the CPU vch_tpu's "default" computes as "highest" (XLA there ignores
Precision.DEFAULT), so the port's one-pass product is held against an
explicit bf16 product instead, and its march only for a clean finish.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vch_tpu.config import DELTA_SEP
from vch_tpu.config import ForwardSolverConfig2D as JaxConfig2D
from vch_tpu.config import OptimizationConfig as JaxOpt
from vch_tpu.control.pgd import ProximalGradientLoop as JaxLoop
from vch_tpu.control.problems import ControlProblem2D as JaxProblem2D
from vch_tpu.ops.grids import grid_2d
from vch_tpu.ops.linsolve import make_spectral_op_2d
from vch_tpu.ops.pallas_march import _make_mm as jax_make_mm
from vch_tpu.ops.pallas_march import march_fused_2d as jax_march
from vch_tpu.ops.pallas_march import \
    march_fused_2d_blocked as jax_march_blocked
from vch_tpu.ops.pallas_march import \
    march_fused_2d_segment as jax_march_segment
from vch_tpu.ops.potential import init_phi_random_2d
from vch_tpu.models.timegrid import build_dt_schedule
from vch_tpu.parallel.batch import BatchedProblem2D as JaxBatched2D
from vch_tpu.parallel.batch import LowMemBatchedProblem2D as JaxLowMem2D
from vch_tpu.parallel.batch import sweep_2d as jax_sweep_2d

from vch_tpu_torch.config import ForwardSolverConfig2D, OptimizationConfig
from vch_tpu_torch.control.pgd import ProximalGradientLoop
from vch_tpu_torch.control.problems import ControlProblem2D
from vch_tpu_torch.ops import march as km
from vch_tpu_torch.parallel.batch import (BatchedProblem2D,
                                          LowMemBatchedProblem2D)
from vch_tpu_torch.utils.convert import (config_from_vch_tpu,
                                         scenario_batch_from_numpy,
                                         spectral_op_from_numpy)

torch.set_num_threads(2)

N, T, TRIPS = 16, 0.04, 3
PHYS = dict(tau=0.05, c1=0.75, c2=1.0, kappa=0.01 ** 2, gamma=10.0)
DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


def _bf16_round(a):
    """numpy operands rounded to bf16 (nearest even), as float64."""
    return torch.as_tensor(a).to(torch.bfloat16).double().numpy()


# ---- the product -----------------------------------------------------------

@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_make_mm_matches_vch_tpu(dtype_name):
    np_dt, tdt = DTYPES[dtype_name]
    rng = np.random.default_rng(3)
    a = rng.standard_normal((17, 23)).astype(np_dt)
    c = rng.standard_normal((23, 19)).astype(np_dt)
    ref = np.asarray(jax_make_mm(jnp.dtype(np_dt), "bf16x3")(
        jnp.asarray(a), jnp.asarray(c)))
    got = km._make_mm(tdt, "bf16x3")(torch.as_tensor(a),
                                    torch.as_tensor(c)).numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-6 * scale
    # bf16x3 is not the full product: it drops lo lo (~2^-16 relative)
    assert np.abs(got - a.astype(np.float64) @ c).max() > 1e-9 * scale


@pytest.mark.parametrize("dtype_name,tol", [("float32", 1e-6),
                                            ("float64", 1e-12)])
def test_default_mode_is_one_bf16_pass(dtype_name, tol):
    np_dt, tdt = DTYPES[dtype_name]
    rng = np.random.default_rng(4)
    a = rng.standard_normal((9, 31)).astype(np_dt)
    c = rng.standard_normal((31, 12)).astype(np_dt)
    ref = _bf16_round(a) @ _bf16_round(c)
    got = km._make_mm(tdt, "default")(torch.as_tensor(a),
                                     torch.as_tensor(c)).numpy()
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("mode", [None, "highest", "high", "float32"])
def test_other_modes_are_full_precision(mode):
    """vch_tpu falls through to its full-precision product for any mode
    but "bf16x3" and "default" (pallas_march.py:207-214)."""
    assert km.solve_passes(mode) == 0
    assert km._make_mm(torch.float32, mode) is torch.matmul
    assert (km.solve_passes("bf16x3"), km.solve_passes("default")) == (3, 1)


# ---- the three plain marches -----------------------------------------------

def _setup(dtype_name, B=3):
    np_dt = DTYPES[dtype_name][0]
    op = make_spectral_op_2d(N, N, 1.0 / N, 1.0 / N, dtype=jnp.float64)
    op_np = {k: np.asarray(v) for k, v in op._asdict().items()}
    _, _, wts = grid_2d(N, N, 1.0, 1.0)
    dts = build_dt_schedule(T, 1e-2)
    rng = np.random.default_rng(0)
    phi0 = np.stack([init_phi_random_2d(N, N, DELTA_SEP, amp=0.1, seed=42 + i)
                     for i in range(B)])
    u = 0.1 * rng.standard_normal((B, len(dts) + 1, N + 1, N + 1))
    f64 = dtype_name == "float64"
    kw = dict(PHYS, delta_sep=DELTA_SEP, area=1.0,
              newton_tol=1e-6 if f64 else 2e-4,
              newton_rtol=0.0 if f64 else 1e-5, newton_max_iter=500,
              n_trips=TRIPS, stagnation_exit=not f64)
    return np_dt, op_np, wts, dts, phi0, u, kw


def _jax_ops(op_np, np_dt):
    j = lambda a: jnp.asarray(a, np_dt)
    return (j(op_np["Lx"]), j(op_np["Ly"].T), j(op_np["Vx_inv"]),
            j(op_np["Vy_inv"].T), j(op_np["Vx"]), j(op_np["Vy"].T),
            j(op_np["lam"]))


def _torch_ops(op_np, tdt):
    op = spectral_op_from_numpy(op_np, dtype=tdt, device="cpu")
    c = lambda t: t.contiguous()
    return (op.Lx, c(op.Ly.T), op.Vx_inv, c(op.Vy_inv.T), op.Vx, c(op.Vy.T),
            op.lam)


def _segment_carry(op_np, phi0, kw):
    """(mu0, w0, m0) from phi0, as vch_tpu's tests form a first segment's
    carry (float64 numpy)."""
    L = op_np["Lx"], op_np["Ly"]
    lap = np.einsum("ik,bkj->bij", L[0], phi0) + np.einsum(
        "bik,jk->bij", phi0, L[1])
    ph = np.clip(phi0, -1.0 + max(1e-8, 0.5 * DELTA_SEP),
                 1.0 - max(1e-8, 0.5 * DELTA_SEP))
    mu = (-kw["kappa"] * lap + kw["c1"] * np.log((1 + ph) / (1 - ph))
          - 2.0 * kw["c2"] * phi0)
    return mu, np.zeros_like(phi0)


@pytest.mark.parametrize("form", ["whole", "blocked", "segment"])
@pytest.mark.parametrize("dtype_name,tol", [("float64", 1e-10),
                                            ("float32", 1e-5)])
def test_plain_marches_match_vch_tpu_at_bf16x3(form, dtype_name, tol):
    """march_fused_2d_plain (B = 3), the blocked plain march (B = 8) and
    the segment plain march (B = 3, the whole march as one segment)
    against vch_tpu's kernels at solve_prec="bf16x3"."""
    B = 8 if form == "blocked" else 3
    np_dt, op_np, wts, dts, phi0, u, kw = _setup(dtype_name, B)
    tdt = DTYPES[dtype_name][1]
    j = lambda a: jnp.asarray(a, np_dt)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=tdt)
    jops, tops = _jax_ops(op_np, np_dt), _torch_ops(op_np, tdt)
    if form == "segment":
        mu0, w0 = _segment_carry(op_np, phi0, kw)
        m0 = np.einsum("bij,ij->b", phi0, wts)
        jout = jax_march_segment(j(dts), j(phi0), j(mu0), j(w0), j(m0), j(u),
                                 *jops, j(wts), interpret=True,
                                 solve_prec="bf16x3", fwd_mm="highest", **kw)
        tout = km.march_fused_2d_segment(t(dts), t(phi0), t(mu0), t(w0),
                                         t(m0), t(u), *tops, t(wts),
                                         solve_prec="bf16x3", **kw)
        pairs = [(jout[0], tout[0])] + list(zip(jout[1:4], tout[1:4]))
    elif form == "blocked":
        jout = jax_march_blocked(j(dts), j(phi0), j(u), *jops, j(wts),
                                 interpret=True, solve_prec="bf16x3",
                                 fwd_mm="highest", block_b=8, **kw)
        tout = km.march_fused_2d_blocked(t(dts), t(phi0), t(u), *tops,
                                         t(wts), solve_prec="bf16x3",
                                         block_b=8, **kw)
        pairs = [(jout[0], tout[0])]
    else:
        jout = jax_march(j(dts), j(phi0), j(u), *jops, j(wts), interpret=True,
                         solve_prec="bf16x3", fwd_mm="highest", **kw)
        tout = km.march_fused_2d(t(dts), t(phi0), t(u), *tops, t(wts),
                                 solve_prec="bf16x3", **kw)
        pairs = [(jout[0], tout[0])]
    for ja, ta in pairs:
        ta = ta.numpy()
        assert ta.shape == np.asarray(ja).shape
        assert np.isfinite(ta).all()
        assert np.abs(ta - np.asarray(ja)).max() <= tol
    np.testing.assert_array_equal(tout[-2].numpy(), np.asarray(jout[-2]))
    np.testing.assert_array_equal(tout[-1].numpy(), np.asarray(jout[-1]))
    assert (tout[-1].numpy() == -1).all() and (tout[-2].numpy() > 0).all()


def test_plain_march_default_mode_finishes_clean():
    """The one-pass solve direction costs Newton iterations, never a bad
    step: every member finishes with first_bad -1, and takes more Newton
    solves than at bf16x3."""
    np_dt, op_np, wts, dts, phi0, u, kw = _setup("float32")
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    args = (t(dts), t(phi0), t(u), *_torch_ops(op_np, torch.float32), t(wts))
    h1, ns1, bad1 = km.march_fused_2d(*args, solve_prec="default", **kw)
    _, ns3, _ = km.march_fused_2d(*args, solve_prec="bf16x3", **kw)
    assert torch.isfinite(h1).all() and (bad1 == -1).all()
    assert int(ns1.sum()) > int(ns3.sum())


@pytest.mark.parametrize("oracle", ["_march_fused_2d_cta",
                                    "_march_fused_2d_segment_cta"])
@pytest.mark.parametrize("mode", ["bf16x3", "default", "high"])
def test_one_cta_oracles_refuse_other_modes(oracle, mode):
    """The one-CTA oracles compute full float32 only: any other mode
    raises, on any device, before anything runs."""
    np_dt, op_np, wts, dts, phi0, u, kw = _setup("float32", B=1)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    ops = (*_torch_ops(op_np, torch.float32), t(wts))
    args = ((t(dts), t(phi0), t(u)) + ops if oracle == "_march_fused_2d_cta"
            else (t(dts), t(phi0), t(phi0), t(phi0), t(phi0.sum((1, 2))),
                  t(u)) + ops)
    fn = getattr(km, oracle)
    before = fn.launches
    with pytest.raises(ValueError, match="full float32"):
        fn(*args, solve_prec=mode, **kw)
    assert fn.launches == before
    for ok in ("highest", None):
        assert fn(*args, solve_prec=ok, **kw)[0].shape[0] == 1


# ---- the batched problems at vch_tpu's default config ----------------------

B3 = np.logspace(-6, 0, 4)
KS = np.logspace(-6, -1, 4)


@pytest.fixture(scope="module", params=[0, 8], ids=["one_member", "blocked"])
def slice_runs(request):
    """test_torch_batch.py's slice at vch_tpu's default solve precision:
    16 x 16, B = 16, 4 PGD iterations, one member a program (block 0) or
    the blocked march (block 8)."""
    jcfg = JaxConfig2D(Nx=16, Ny=16, T=0.06, dtype="float32",
                       newton_tol=2e-4, fused_march_block=request.param)
    assert jcfg.fused_solve_precision == "bf16x3"
    jsc = jax_sweep_2d(jcfg, b3_values=B3, kappa_values=KS)
    jprob = JaxBatched2D(jcfg, fused_march=True)
    jout = jprob.run(jsc, max_iter=4, verbose=False)
    cfg = config_from_vch_tpu(jcfg.model_dump())
    assert cfg.fused_solve_precision == "bf16x3"
    prob = BatchedProblem2D(cfg, device="cpu", fused_march=True)
    out = prob.run(scenario_batch_from_numpy(jsc, dtype=torch.float32),
                   max_iter=4, verbose=False)
    return jprob, jout, prob, out


def test_batched_problem_matches_vch_tpu_at_its_default(slice_runs):
    jprob, jout, prob, out = slice_runs
    c0, c1 = jout["cost_history"], out["cost_history"]
    assert c1.shape == c0.shape == (5, 16) and np.isfinite(c1).all()
    assert (np.abs(c1 - c0) / np.abs(c0)).max() <= 2e-4
    assert out["newton_solves"] == jout["newton_solves"]
    np.testing.assert_array_equal(out["ls_trials"], jout["ls_trials"])
    assert prob.straggler_rounds == jprob.straggler_rounds > 0


def test_lowmem_problem_matches_vch_tpu_at_its_default():
    """test_torch_lowmem.py's run (16 x 16, B = 4, K = 4, procedural
    ramp targets, 3 PGD iterations) at vch_tpu's default precision: the
    forward segments and the adjoint's recompute share the mode."""
    jcfg = JaxConfig2D(Nx=16, Ny=16, T=0.06, dtype="float32",
                       newton_tol=2e-4)
    mk = lambda: jax_sweep_2d(jcfg, b3_values=[1e-4, 2e-4],
                              kappa_values=[1e-5, 1e-4],
                              materialize_phi_Q=False)
    jout = JaxLowMem2D(jcfg, K=4, fused_march=True).run(mk(), max_iter=3,
                                                        verbose=False)
    prob = LowMemBatchedProblem2D(config_from_vch_tpu(jcfg.model_dump()),
                                  K=4, device="cpu", fused_march=True)
    out = prob.run(scenario_batch_from_numpy(mk(), dtype=torch.float32),
                   max_iter=3, verbose=False)
    c0, c1 = jout["cost_history"], out["cost_history"]
    assert np.isfinite(c1).all()
    assert np.abs(c1 - c0).max() / np.abs(c0).min() <= 2e-4
    assert out["newton_solves"] == jout["newton_solves"]
    np.testing.assert_array_equal(out["ls_trials"], jout["ls_trials"])


# ---- ControlProblem2D, its trials on the fused march ------------------------

@pytest.mark.parametrize("search_mode", ["host", "fused"])
def test_control_problem_on_the_fused_march_matches_vch_tpu(search_mode):
    """Config 3 cut to 16 x 16, T = 0.05, float32, 3 PGD iterations, each
    trial one march of the fused kernel at vch_tpu's default precision:
    vch_tpu's TPU route (march_fused_batch at B = 1) in interpret mode,
    the port's card route (`_fused`) on CPU tensors."""
    cfg = dict(Nx=16, Ny=16, T=0.05, dtype="float32", newton_tol=2e-4)
    jprob = JaxProblem2D(JaxConfig2D(**cfg), JaxOpt.defaults_2d())
    jloop = jprob.loop
    jfwd = lambda u: jprob.solver.march_fused_batch(
        u[None], jprob._phi0_dev[None], interpret=True)[0][0]
    jres = JaxLoop(jfwd, jloop.adjoint, jloop.cost, jloop.opt,
                   settings=jloop.s, error_norms=jloop.error_norms,
                   search_mode=search_mode).run(
        jprob.initial_control(), jprob.phi_hist0, max_iter=3, verbose=False)
    prob = ControlProblem2D(config_from_vch_tpu(
        JaxConfig2D(**cfg).model_dump()), OptimizationConfig.defaults_2d(),
        device="cpu")
    assert prob.fwd_config.fused_solve_precision == "bf16x3"
    prob._fused = True
    loop = prob.loop
    res = ProximalGradientLoop(loop.forward, loop.adjoint, loop.cost,
                               loop.opt, settings=loop.s,
                               error_norms=loop.error_norms,
                               search_mode=search_mode).run(
        prob.initial_control(), prob.phi_hist0, max_iter=3, verbose=False)
    c, jc = np.asarray(res.cost_history), np.asarray(jres.cost_history)
    assert np.isfinite(c).all() and c[-1] < c[0]
    assert (np.abs(c - jc) / np.abs(jc)).max() <= 2e-5, (c, jc)
    assert res.ls_trials_per_iter == [int(n) for n in
                                      jres.ls_trials_per_iter]
