"""Port parity for the fused 1D march: the plain PyTorch version of
vch_tpu_torch/ops/march.py (`march_fused_1d_plain`, the oracle of the CUDA
kernel, which tests/test_torch_cuda.py and chip_smoke.py hold against it on
the card) against vch_tpu's Pallas kernel `march_fused_1d` in interpret
mode, on the same numpy inputs.

Tolerances: float64 phi 1e-10 (the same recurrences; the Pallas body runs
(B, n) x (n, n) products and the plain version one member's vector at a
time, so only summation order differs; measured 7e-16), float32 phi 1e-5
(measured 5e-7); Newton solves and first_bad equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vch_tpu.config import DELTA_SEP, ForwardSolverConfig1D as JaxConfig1D
from vch_tpu.models.forward1d import ForwardSolver1D as JaxSolver1D
from vch_tpu.ops.potential import init_phi_random_1d

from vch_tpu_torch.config import ForwardSolverConfig1D
from vch_tpu_torch.models.forward1d import ForwardSolver1D
from vch_tpu_torch.ops import march as km

torch.set_num_threads(2)

N, T, B = 64, 0.06, 4
TOL = {"float64": 1e-10, "float32": 1e-5}


def _solvers(dtype, newton_tol=2e-4, newton_rtol=1e-5):
    kw = dict(N=N, T=T, dtype=dtype, newton_tol=newton_tol,
              newton_rtol=newton_rtol, linsolve_1d="spectral")
    js = JaxSolver1D(JaxConfig1D(**kw))
    ts = ForwardSolver1D(ForwardSolverConfig1D(**kw), device="cpu")
    if dtype == "float64":
        # the fused march is the fixed-trip path: give the float64 solvers
        # the float32 path's trips and Newton exits
        for s in (js, ts):
            s._krylov_fixed = 4
            s._rtol, s._stagnation = newton_rtol, True
    return js, ts


def _inputs(B=B, seed=0, wave_amp=0.0):
    rng = np.random.default_rng(seed)
    M = 6
    x = np.linspace(0.0, 1.0, N + 1)
    phi0 = np.stack([init_phi_random_1d(N, DELTA_SEP, amp=0.01, seed=42 + i)
                     + wave_amp * np.cos(np.pi * (i + 1) * x)
                     for i in range(B)])
    return phi0, 0.05 * rng.standard_normal((B, M + 1, N + 1))


def _both(dtype, phi0, u, **exits):
    js, ts = _solvers(dtype, **exits)
    assert js.M == ts.M == u.shape[1] - 1
    jp, jn, jb = js.march_fused_batch(jnp.asarray(u, js.dtype),
                                      jnp.asarray(phi0, js.dtype),
                                      interpret=True)
    as_t = lambda a: torch.as_tensor(a, dtype=ts.dtype)
    tp, tn, tb = ts.march_fused_batch(as_t(u), as_t(phi0))
    return (np.asarray(jp), np.asarray(jn), np.asarray(jb),
            tp.numpy(), tn.numpy(), tb.numpy())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_march_1d_matches_pallas_interpret(dtype):
    phi0, u = _inputs()
    jp, jn, jb, tp, tn, tb = _both(dtype, phi0, u)
    assert tp.shape == (B, 7, N + 1) and tn.dtype == np.float32
    assert np.abs(tp - jp).max() < TOL[dtype]
    assert np.array_equal(tn, jn) and tn.min() >= 6
    assert np.array_equal(tb, jb) and (tb == -1).all()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_march_1d_on_a_hard_start(dtype):
    """A cosine wave of amplitude 0.6 under the noise, a tight absolute
    Newton tolerance and no relative one: steps take several Newton
    iterations and members differ in their counts; the member-wise exits
    of the plain version against the masked lockstep of the Pallas body."""
    phi0, u = _inputs(seed=3, wave_amp=0.6)
    tol = {"float64": 1e-8, "float32": 2e-3}[dtype]   # float32 can reach it
    jp, jn, jb, tp, tn, tb = _both(dtype, phi0, u, newton_tol=tol,
                                   newton_rtol=0.0)
    assert np.abs(tp - jp).max() < 10 * TOL[dtype]
    assert np.array_equal(tb, jb)
    if dtype == "float64":
        assert np.array_equal(tn, jn) and tn.max() > 12
        assert len(set(tn.tolist())) > 1
    else:
        # float32: the residual after a step's first iteration lies within
        # roundoff of the tolerance (1.5e-3 against 2e-3 for member 0), so
        # the two may differ by that step's second iteration
        assert np.abs(tn - jn).max() <= 6 and tn.max() >= 12


def test_a_diverged_member_reports_the_same_first_bad():
    phi0, u = _inputs()
    phi0[2, 5] = np.nan
    jp, jn, jb, tp, tn, tb = _both("float32", phi0, u)
    assert tb.tolist() == [-1.0, -1.0, 0.0, -1.0]
    assert np.array_equal(tb, jb) and np.array_equal(tn, jn)
    keep = [0, 1, 3]
    assert np.abs(tp[keep] - jp[keep]).max() < 1e-5
    assert np.isnan(tp[2, 1:]).all()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_a_members_result_does_not_change_with_the_batch(dtype):
    _, ts = _solvers(dtype)
    phi0, u = _inputs()
    as_t = lambda a: torch.as_tensor(a, dtype=ts.dtype)
    full = ts.march_fused_batch(as_t(u), as_t(phi0))
    one = ts.march_fused_batch(as_t(u[2:3]), as_t(phi0[2:3]))
    for a, b in zip(full, one):
        assert torch.equal(a[2:3], b)


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    _, ts = _solvers("float32")
    phi0, u = _inputs(B=2)
    as_t = lambda a: torch.as_tensor(a, dtype=ts.dtype)
    before = km.march_fused_1d.launches
    got = ts.march_fused_batch(as_t(u), as_t(phi0))
    cfg = ts.config
    ref = km.march_fused_1d_plain(
        ts.dts, as_t(phi0), as_t(u), ts.LT, ts.VinvT, ts.VT, ts.lam[None],
        ts.wts[None], tau=cfg.tau, c1=cfg.c1, c2=cfg.c2, kappa=cfg.kappa,
        gamma=cfg.gamma, delta_sep=DELTA_SEP, Lx_len=1.0,
        newton_tol=cfg.newton_tol, newton_rtol=cfg.newton_rtol,
        newton_max_iter=cfg.newton_max_iter, n_trips=4, stagnation_exit=True)
    assert km.march_fused_1d.launches == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_fused_march_needs_the_fixed_trip_spectral_path():
    ts = ForwardSolver1D(ForwardSolverConfig1D(N=N, T=T), device="cpu")
    assert not ts.fused_march_available(4)
    with pytest.raises(ValueError, match="fixed-trip"):
        ts.march_fused_batch(torch.zeros(1, 7, N + 1, dtype=torch.float64),
                             torch.zeros(1, N + 1, dtype=torch.float64))
    _, t32 = _solvers("float32")
    assert t32.fused_march_available(256) and km.KERNELS.march_1d is km.march_fused_1d
