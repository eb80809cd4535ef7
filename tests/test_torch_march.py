"""Port parity: the forward-march and adjoint-sweep kernels' plain PyTorch
versions (vch_tpu_torch/ops/march.py) against vch_tpu's Pallas kernels run
in interpret mode on the same inputs. The CUDA kernels are held against the
plain versions in tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: float64 to 1e-10 (both sides run the same recurrences; only
summation order differs), float32 phi to 1e-5 absolute and r to 1e-4
relative (the f32 noise floor of the condition-1e6 adjoint; the TPU's own
fused-vs-scan record was 6.2e-5).
"""
import numpy as np
import pytest
import torch

from vch_tpu.config import DELTA_SEP
from vch_tpu.ops.grids import grid_2d
from vch_tpu.ops.linsolve import make_spectral_op_2d
from vch_tpu.ops.pallas_march import adjoint_fused_2d as jax_adjoint
from vch_tpu.ops.pallas_march import march_fused_2d as jax_march
from vch_tpu.ops.potential import init_phi_random_2d
from vch_tpu.models.timegrid import build_dt_schedule

from vch_tpu_torch.ops import march as tm
from vch_tpu_torch.utils.convert import spectral_op_from_numpy

import jax.numpy as jnp

torch.set_num_threads(2)

N, T, B, TRIPS = 16, 0.04, 3, 3
PHYS = dict(tau=0.05, c1=0.75, c2=1.0, kappa=0.01 ** 2, gamma=10.0)


def _setup(dtype_name, useed=0):
    np_dt = np.float64 if dtype_name == "float64" else np.float32
    op = make_spectral_op_2d(N, N, 1.0 / N, 1.0 / N, dtype=jnp.float64)
    op_np = {k: np.asarray(v) for k, v in op._asdict().items()}
    _, _, wts = grid_2d(N, N, 1.0, 1.0)
    dts = build_dt_schedule(T, 1e-2)
    M = len(dts)
    rng = np.random.default_rng(useed)
    phi0 = np.stack([init_phi_random_2d(N, N, DELTA_SEP, amp=0.1, seed=42 + i)
                     for i in range(B)])
    u = 0.1 * rng.standard_normal((B, M + 1, N + 1, N + 1))
    return np_dt, op_np, wts, dts, phi0, u


def _jax_ops(op_np, np_dt):
    j = lambda a: jnp.asarray(a, np_dt)
    return (j(op_np["Lx"]), j(op_np["Ly"].T), j(op_np["Vx_inv"]),
            j(op_np["Vy_inv"].T), j(op_np["Vx"]), j(op_np["Vy"].T),
            j(op_np["lam"]))


def _torch_ops(op_np, tdt, device="cpu"):
    op = spectral_op_from_numpy(op_np, dtype=tdt, device=device)
    c = lambda t: t.contiguous()
    return (op.Lx, c(op.Ly.T), op.Vx_inv, c(op.Vy_inv.T), op.Vx, c(op.Vy.T),
            op.lam)


def _march_kw(dtype_name, newton_max_iter=500):
    f64 = dtype_name == "float64"
    return dict(PHYS, delta_sep=DELTA_SEP, area=1.0,
                newton_tol=1e-6 if f64 else 2e-4,
                newton_rtol=0.0 if f64 else 1e-5,
                newton_max_iter=newton_max_iter, n_trips=TRIPS,
                stagnation_exit=not f64)


def _run_both_march(dtype_name, phi0_edit=None, newton_max_iter=500):
    np_dt, op_np, wts, dts, phi0, u = _setup(dtype_name)
    if phi0_edit is not None:
        phi0_edit(phi0)
    kw = _march_kw(dtype_name, newton_max_iter)
    j = lambda a: jnp.asarray(a, np_dt)
    jh, jns, jbad = jax_march(j(dts), j(phi0), j(u), *_jax_ops(op_np, np_dt),
                              j(wts), interpret=True, solve_prec="highest",
                              fwd_mm="highest", **kw)
    tdt = torch.float64 if np_dt == np.float64 else torch.float32
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=tdt)
    before = tm.march_fused_2d.launches
    th, tns, tbad = tm.march_fused_2d(t(dts), t(phi0), t(u),
                                      *_torch_ops(op_np, tdt), t(wts), **kw)
    assert tm.march_fused_2d.launches == before   # CPU tensors: plain path
    return ((np.asarray(jh), np.asarray(jns), np.asarray(jbad)),
            (th.numpy(), tns.numpy(), tbad.numpy()))


@pytest.mark.parametrize("dtype_name,tol", [("float64", 1e-10),
                                            ("float32", 1e-5)])
def test_march_plain_matches_pallas_interpret(dtype_name, tol):
    (jh, jns, jbad), (th, tns, tbad) = _run_both_march(dtype_name)
    assert th.shape == jh.shape
    assert np.isfinite(th).all()
    diff = np.abs(th - jh).max()
    assert diff <= tol, diff
    np.testing.assert_array_equal(tns, jns)
    np.testing.assert_array_equal(tbad, jbad)
    assert (tbad == -1).all()
    assert (tns > 0).all()


def test_march_plain_sanitizer_flags_nonfinite_member():
    def poison(phi0):
        phi0[1, 3, 3] = np.nan
    (_, _, jbad), (_, _, tbad) = _run_both_march("float32", poison,
                                                 newton_max_iter=3)
    assert tbad[0] == -1 and tbad[2] == -1
    assert tbad[1] == 0
    np.testing.assert_array_equal(tbad, jbad)


def _adjoint_inputs(dtype_name):
    np_dt, op_np, wts, dts, phi0, u = _setup(dtype_name, useed=1)
    M = len(dts)
    rng = np.random.default_rng(7)
    # a smooth, bounded history and tracking target (the adjoint is linear
    # in p; the history enters through f''(phi))
    hist = np.clip(phi0[:, None] + 0.05 * rng.standard_normal(
        (B, M + 1, N + 1, N + 1)), -0.9, 0.9)
    phi_Q = 0.3 * rng.standard_normal((B, M + 1, N + 1, N + 1))
    phi_T = 0.7 * rng.standard_normal((B, N + 1, N + 1))
    b1 = np.array([5.0, 0.3, 1.0])
    b2 = np.array([10.0, 13.0, 2.0])
    return np_dt, op_np, dts, hist, phi_Q, phi_T, b1, b2


@pytest.mark.parametrize("dtype_name,tol", [("float64", 1e-10),
                                            ("float32", 1e-4)])
def test_adjoint_plain_matches_pallas_interpret(dtype_name, tol):
    np_dt, op_np, dts, hist, phi_Q, phi_T, b1, b2 = _adjoint_inputs(dtype_name)
    kw = dict(tau=PHYS["tau"], gamma=PHYS["gamma"], c1=PHYS["c1"],
              c2=PHYS["c2"], n_trips=5)
    j = lambda a: jnp.asarray(a, np_dt)
    jr = np.asarray(jax_adjoint(j(dts), j(hist), j(phi_Q), j(phi_T), j(b1),
                                j(b2), *_jax_ops(op_np, np_dt),
                                interpret=True, solve_prec="highest", **kw))
    tdt = torch.float64 if np_dt == np.float64 else torch.float32
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=tdt)
    before = tm.adjoint_fused_2d.launches
    tr = tm.adjoint_fused_2d(t(dts), t(hist), t(phi_Q), t(phi_T), t(b1),
                             t(b2), *_torch_ops(op_np, tdt), **kw).numpy()
    assert tm.adjoint_fused_2d.launches == before
    assert tr.shape == jr.shape
    assert (tr[:, -1] == 0).all()
    rel = np.abs(tr - jr).max() / np.abs(jr).max()
    assert rel <= tol, rel
