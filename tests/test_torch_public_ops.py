"""The small public ops of the port (vch_tpu_torch/ops: the stability
analysis, the 1D apply, the matrix-free stencils, spectral_poly_solve, and
the package's exports) against vch_tpu's on the same float64 inputs, to
1e-12 relative. Mirrors tests/test_ops.py's stencil cases and
tests/test_spatial_sharding.py's stability and null-space cases."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vch_tpu.ops as jops
import vch_tpu_torch.ops as tops
from vch_tpu.ops import linsolve as jlin
from vch_tpu_torch.ops import linsolve as tlin

TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def test_exports_match_vch_tpu():
    """ops/__init__ exports vch_tpu's names, and spectral_poly_solve."""
    assert set(jops.__all__) <= set(tops.__all__)
    assert "spectral_poly_solve" in tops.__all__
    for name in tops.__all__:
        assert callable(getattr(tops, name)), name


def test_instability_report_matches_test_formula():
    """Mirrors tests/test_spatial_sharding.py: lambda(k) = (-kappa q^2 -
    a q)/(1 + tau q) equals q(2c2 - 2c1 - kappa q)/(1 + tau q)."""
    c1, c2, kappa, tau = 0.75, 1.0, 1e-4, 0.05
    k = np.pi * np.arange(1, 13)
    lam = tops.dispersion_relation(c1, c2, kappa, tau, k)
    q = k ** 2
    lam2 = q * (2 * c2 - 2 * c1 - kappa * q) / (1 + tau * q)
    assert np.allclose(lam, lam2, rtol=1e-12)
    rep = tops.instability_report(c1, c2, kappa, tau, 1.0, verbose=False)
    assert rep.shape == (12,)
    assert (rep > 0).sum() > 0


@pytest.mark.parametrize("args", [(0.75, 1.0, 1e-4, 0.05, 1.0, 12),
                                  (0.75, 1.0, 0.03 ** 2, 0.05, 2.0, 20),
                                  (1.2, 1.0, 1e-3, 0.0, 1.0, 8)])
def test_stability_matches_vch_tpu(args, capsys):
    """The growth rates and the printed summary, as vch_tpu's."""
    c1, c2, kappa, tau, Lx, n = args
    k = np.pi * np.arange(1, n + 1) / Lx
    assert _rel(tops.dispersion_relation(c1, c2, kappa, tau, k),
                jops.dispersion_relation(c1, c2, kappa, tau, k)) <= TOL
    got = tops.instability_report(c1, c2, kappa, tau, Lx, Nmodes=n)
    out_t = capsys.readouterr().out
    want = jops.instability_report(c1, c2, kappa, tau, Lx, Nmodes=n)
    out_j = capsys.readouterr().out
    assert _rel(got, want) <= TOL
    assert out_t == out_j and out_t.startswith("a=")


def test_stencil_matches_matrix_1d():
    """Mirrors tests/test_ops.py::test_stencil_matches_matrix_1d, and both
    1D forms against vch_tpu's on a batch."""
    N, h = 77, 1 / 77
    L = tops.laplacian_matrix_neumann(N, h)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(N + 1)
    assert np.allclose(tops.stencil_laplacian_1d(_t(v), h).numpy(), L @ v,
                       atol=1e-9)
    vb = rng.standard_normal((3, N + 1))
    assert _rel(tops.stencil_laplacian_1d(_t(vb), h),
                jops.stencil_laplacian_1d(jnp.asarray(vb), h)) <= TOL
    assert _rel(tops.apply_laplacian_1d(_t(L), _t(vb)),
                jops.apply_laplacian_1d(jnp.asarray(L), jnp.asarray(vb))) \
        <= TOL


@pytest.mark.parametrize("shape", [(17, 23), (2, 31, 31)])
def test_stencil_matches_matmul_2d(shape):
    """Mirrors tests/test_ops.py::test_stencil_matches_matmul_2d: the
    stencil against the two-product apply and against vch_tpu's stencil."""
    Nx, Ny = shape[-2] - 1, shape[-1] - 1
    hx, hy = 1 / Nx, 1 / Ny
    op = tlin.make_spectral_op_2d(Nx, Ny, hx, hy)
    v = np.random.default_rng(1).standard_normal(shape)
    a = tops.apply_laplacian_2d(op.Lx, op.Ly, _t(v)).numpy()
    b = tops.stencil_laplacian_2d(_t(v), hx, hy).numpy()
    assert np.abs(a - b).max() < 1e-9
    assert _rel(b, jops.stencil_laplacian_2d(jnp.asarray(v), hx, hy)) <= TOL


def test_stencil_neumann_nullspace():
    """Mirrors tests/test_spatial_sharding.py's null-space case: constants
    are in the Neumann Laplacian's kernel, exactly."""
    out = tops.stencil_laplacian_2d(torch.ones(64, 64, dtype=torch.float64),
                                    1 / 63, 1 / 63)
    assert out.abs().max().item() == 0.0
    out1 = tops.stencil_laplacian_1d(torch.ones(5, 33, dtype=torch.float64),
                                     1 / 32)
    assert out1.abs().max().item() == 0.0


@pytest.mark.parametrize("Nx,Ny,batch", [(16, 16, ()), (20, 14, (3,))])
def test_spectral_poly_solve_matches_vch_tpu(Nx, Ny, batch):
    """P v = rhs for P = (1/dt) I + (kappa/2) L^2 - (tau/dt) L, diagonal in
    the cosine basis: the port's solve against vch_tpu's on the same op and
    right-hand side, and P applied to it gives the right-hand side back."""
    hx, hy = 1 / Nx, 1 / Ny
    dt, kappa, tau = 1e-2, 1e-4, 0.05
    symbol = lambda lam: 1 / dt + 0.5 * kappa * lam ** 2 - (tau / dt) * lam
    rhs = np.random.default_rng(2).standard_normal(batch + (Nx + 1, Ny + 1))
    top = tlin.make_spectral_op_2d(Nx, Ny, hx, hy)
    jop = jlin.make_spectral_op_2d(Nx, Ny, hx, hy)
    got = tops.spectral_poly_solve(top, symbol, _t(rhs))
    want = jlin.spectral_poly_solve(jop, symbol, jnp.asarray(rhs))
    assert _rel(got, want) <= TOL
    lap = lambda v: tops.apply_laplacian_2d(top.Lx, top.Ly, v)
    back = (got / dt + 0.5 * kappa * lap(lap(got)) - (tau / dt) * lap(got))
    assert _rel(back, rhs) <= 1e-9
