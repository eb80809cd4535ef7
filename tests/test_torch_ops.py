"""Port parity for the ops under the slice: float64, the same numpy inputs
through vch_tpu and vch_tpu_torch, agreement to 1e-12 relative (the two
sides differ only in the order of sums), and the seeded initial condition
bit for bit."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vch_tpu.config import DELTA_SEP
from vch_tpu.control import cost as jcost
from vch_tpu.control import prox as jprox
from vch_tpu.control import targets as jtargets
from vch_tpu.models import timegrid as jtime
from vch_tpu.ops import grids as jgrids
from vch_tpu.ops import laplacian as jlap
from vch_tpu.ops import linsolve as jlin
from vch_tpu.ops import potential as jpot

from vch_tpu_torch.control import cost as tcost
from vch_tpu_torch.control import prox as tprox
from vch_tpu_torch.control import targets as ttargets
from vch_tpu_torch.models import timegrid as ttime
from vch_tpu_torch.ops import grids as tgrids
from vch_tpu_torch.ops import laplacian as tlap
from vch_tpu_torch.ops import linsolve as tlin
from vch_tpu_torch.ops import potential as tpot

torch.set_num_threads(2)

NX, NY = 20, 14
TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _field(seed, shape=(3, NX + 1, NY + 1), scale=0.5):
    return scale * np.random.default_rng(seed).standard_normal(shape)


@pytest.fixture(scope="module")
def ops():
    hx, hy = 1.0 / NX, 1.0 / NY
    return (jlin.make_spectral_op_2d(NX, NY, hx, hy, dtype=jnp.float64),
            tlin.make_spectral_op_2d(NX, NY, hx, hy, dtype=torch.float64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_init_phi_random_2d_bit_equal(seed):
    a = jpot.init_phi_random_2d(NX, NY, DELTA_SEP, amp=0.1, seed=42 + seed)
    b = tpot.init_phi_random_2d(NX, NY, DELTA_SEP, amp=0.1, seed=42 + seed)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_host_tables_equal():
    assert np.array_equal(jgrids.trapz_weights(9), tgrids.trapz_weights(9))
    ja, ta = jgrids.grid_2d(NX, NY, 1.0, 2.0), tgrids.grid_2d(NX, NY, 1.0, 2.0)
    for x, y in zip((*ja[0], ja[1], ja[2]), (*ta[0], ta[1], ta[2])):
        assert np.array_equal(x, y)
    for N, h in ((NX, 1.0 / NX), (NY, 0.3)):
        assert np.array_equal(jlap.laplacian_matrix_neumann(N, h),
                              tlap.laplacian_matrix_neumann(N, h))
        for x, y in zip(jlap.neumann_eigendecomposition(N, h),
                        tlap.neumann_eigendecomposition(N, h)):
            assert np.array_equal(x, y)
    for T, dt in ((1.0, 1e-2), (0.06, 1e-2), (0.105, 0.02)):
        assert np.array_equal(jtime.build_dt_schedule(T, dt),
                              ttime.build_dt_schedule(T, dt))
        d = jtime.build_dt_schedule(T, dt)
        assert np.array_equal(jtime.t_history(d, T), ttime.t_history(d, T))


@pytest.mark.parametrize("choice_t,choice_q", [(1, 1), (2, 2)])
def test_targets_equal(choice_t, choice_q):
    x, y = np.linspace(0, 1, NX + 1), np.linspace(0, 1, NY + 1)
    t = np.linspace(0, 1, 5)
    phi0 = _field(3, (NX + 1, NY + 1))
    a = jtargets.build_targets_2d(x, y, t, phi0, 1.0, 1.0, 1.0,
                                  choice_t, choice_q)
    b = ttargets.build_targets_2d(x, y, t, phi0, 1.0, 1.0, 1.0,
                                  choice_t, choice_q)
    for u, v in zip(a, b):
        assert np.array_equal(u, v)


def test_spectral_op_equal(ops):
    jop, top = ops
    for name in jlin.SpectralOp2D._fields:
        assert np.array_equal(np.asarray(getattr(jop, name)),
                              getattr(top, name).numpy()), name


def test_apply_laplacian_2d(ops):
    jop, top = ops
    v = _field(0)
    a = jlap.apply_laplacian_2d(jop.Lx, jop.Ly, jnp.asarray(v))
    b = tlap.apply_laplacian_2d(top.Lx, top.Ly, _t(v))
    assert _rel(b, a) <= TOL


@pytest.mark.parametrize("direction", ["to", "from", "roundtrip"])
def test_spectral_transforms(ops, direction):
    jop, top = ops
    v = _field(1)
    if direction == "to":
        a = jlin.to_spectral(jop, jnp.asarray(v))
        b = tlin.to_spectral(top, _t(v))
    elif direction == "from":
        a = jlin.from_spectral(jop, jnp.asarray(v))
        b = tlin.from_spectral(top, _t(v))
    else:
        a = v
        b = tlin.from_spectral(top, tlin.to_spectral(top, _t(v)))
    assert _rel(b, a) <= TOL


@pytest.mark.parametrize("fn", ["f_prime", "fpp_log", "regularized_log"])
def test_potential_terms(fn):
    phi = np.clip(_field(2, scale=0.6), -1.2, 1.2)   # crosses the clips
    if fn == "f_prime":
        a = jpot.f_prime(jnp.asarray(phi), 0.75, 1.0, DELTA_SEP)
        b = tpot.f_prime(_t(phi), 0.75, 1.0, DELTA_SEP)
    elif fn == "fpp_log":
        a = jpot.fpp_log(jnp.asarray(phi), 0.75, 1.0)
        b = tpot.fpp_log(_t(phi), 0.75, 1.0)
    else:
        a = jpot.regularized_log(jnp.asarray(phi), DELTA_SEP)
        b = tpot.regularized_log(_t(phi), DELTA_SEP)
    assert _rel(b, a) <= TOL


def test_cost_2d_batched():
    M, B = 6, 3
    x, y = np.linspace(0, 1, NX + 1), np.linspace(0, 1, NY + 1)
    t = np.linspace(0, 0.06, M + 1)
    phi = _field(4, (B, M + 1, NX + 1, NY + 1))
    u = _field(5, (B, M + 1, NX + 1, NY + 1))
    phi_Q = _field(6, (B, M + 1, NX + 1, NY + 1))
    phi_T = _field(7, (B, NX + 1, NY + 1))
    w = [np.array([5.0, 0.3, 1.0]), np.array([10.0, 13.0, 2.0]),
         np.array([1e-4, 1e-2, 1.0]), np.array([1e-6, 1e-4, 1e-1])]
    a = [jcost.calculate_cost_2d(phi[i], u[i], phi_Q[i], phi_T[i], x, y, t,
                                 *[float(c[i]) for c in w]) for i in range(B)]
    b = tcost.calculate_cost_2d(_t(phi), _t(u), _t(phi_Q), _t(phi_T), _t(x),
                                _t(y), _t(t), *[_t(c) for c in w])
    assert b.shape == (B,)
    assert _rel(b, np.array(a)) <= TOL


@pytest.mark.parametrize("alpha,ks", [(0.5, 1e-2), (50.0, 1e-4), (3.0, 0.3)])
def test_proximal_step(alpha, ks):
    u, r = _field(8), _field(9)
    b3 = 1e-2
    a = jprox.proximal_step(jnp.asarray(u),
                            jprox.calculate_gradient(jnp.asarray(r),
                                                     jnp.asarray(u), b3),
                            alpha, ks, -1.0, 1.0)
    b = tprox.proximal_step(_t(u), tprox.calculate_gradient(_t(r), _t(u), b3),
                            alpha, ks, -1.0, 1.0)
    assert _rel(b, a) <= TOL
    assert (b.abs() <= 1.0).all()


def test_package_sets_no_tf32():
    import vch_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
