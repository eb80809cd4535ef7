"""The cluster geometry of the per-solve kernels of
csrc/solve2d_cluster.cu (`vch_tpu_torch.ops.march.blocked_geometry` /
`fitted_geometry` with one member per cluster and kernel="solve",
"raw_solve", "schur_solve" or "raw_schur_solve"), which the wrappers
`ops.solve_kernels.bicgstab_adjoint_spectral`, `bicgstab_adjoint`,
`bicgstab_schur_spectral` and `bicgstab_schur` launch on, and the wrappers'
and their one-CTA oracles' plain path on CPU tensors.

Each solve splits a member over a thread-block cluster as the one-member
march and sweep do (the same bands, ring and shared memory), and its C
entry recomputes the split from (n, m, cluster, kc) and refuses a launch
whose numbers differ, so these CPU tests hold the kernels' split too. A
grid takes the solves when vch_tpu's rule `per_solve_kernels_fit` admits
it; the geometry exists on every grid of the lattice below that the rule
admits. The rule also admits grids wider than ~7,100 columns when they are
at most 71 rows tall, where no ring of 4 k rows fits: those raise, with
their bytes, as every grid past the ring's limit does."""
import numpy as np
import pytest
import torch

from vch_tpu_torch.ops import march as km
from vch_tpu_torch.ops import solve_kernels as sk
from vch_tpu_torch.ops.march import (BLOCKED_SMEM_LIMIT, blocked_geometry,
                                     fitted_geometry)
from vch_tpu_torch.ops.solve_kernels import per_solve_kernels_fit

H100_SMS = 132
_SIZES = (2, 3, 5, 9, 17, 33, 64, 65, 100, 129, 200, 257, 400, 513, 672,
          769, 1025, 2049, 4097)
_ADMITTED = [(n, m) for n in _SIZES for m in _SIZES
             if per_solve_kernels_fit(n, m)]


# each cluster solve's kernel in CLUSTER_KERNELS and its name in messages
KERNELS = {"solve": "the adjoint step solve",
           "raw_solve": "the raw adjoint step solve",
           "schur_solve": "the Schur solve",
           "raw_schur_solve": "the raw Schur solve"}


def _geometry(n, m, B, kernel="solve", **kw):
    return blocked_geometry(n, m, B, H100_SMS, members=1, kernel=kernel,
                            **kw)


def test_the_lattice_reaches_the_rule_s_edge():
    """The lattice holds grids on both sides of the rule: squares up to
    672, and thin grids up to 4097 wide and 2049 tall."""
    assert (672, 672) in _ADMITTED and (769, 769) not in _ADMITTED
    assert (9, 4097) in _ADMITTED and (2049, 9) in _ADMITTED
    assert len(_ADMITTED) > 200


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("B", [1, 8, 128, 512])
def test_every_admitted_grid_has_a_solve_geometry(B, kernel):
    """For every (n, m) of the lattice that per_solve_kernels_fit admits,
    at B = 1, 8, 128 and 512, for each cluster solve: a geometry whose bands
    cover every row once, whose ring fits BLOCKED_SMEM_LIMIT, and which the
    fit on the solve's own residency keeps or shrinks."""
    for n, m in _ADMITTED:
        g = _geometry(n, m, B, kernel)
        assert g.members == 1 and 1 <= g.cluster <= min(16, n)
        assert sum(r for _, r in g.bands) == n and len(g.bands) == g.cluster
        assert g.smem_bytes == 4 * 2 * g.kc * (g.rows_pad + g.m_pad + 4)
        assert g.smem_bytes <= BLOCKED_SMEM_LIMIT
        f = fitted_geometry(n, m, B, H100_SMS, lambda geo: 66 // geo.cluster,
                            members=1, kernel=kernel)
        assert f.cluster <= g.cluster and f.smem_bytes <= BLOCKED_SMEM_LIMIT


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("n,B,C,kc,smem", [(65, 1, 16, 32, 20_480),
                                           (65, 128, 1, 32, 35_840),
                                           (129, 128, 1, 32, 68_608),
                                           (257, 1, 16, 32, 72_704)])
def test_the_solve_at_its_main_path_shapes(n, B, C, kc, smem, kernel):
    """Config 3's solves (n = 65, one member) on up to 16 CTAs, the scan
    path's (n = 129, B = 128) on one CTA a member: the one-member march's
    and sweep's split at the same shape."""
    g = _geometry(n, n, B, kernel)
    assert (g.cluster, g.kc, g.smem_bytes) == (C, kc, smem)
    assert g == blocked_geometry(n, n, B, H100_SMS, members=1,
                                 kernel="sweep")


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("n,m,B,C", [(3600, 3600, 128, 1),
                                     (7200, 7200, 1, 16), (9, 7168, 1, 8),
                                     (9, 7168, 128, 1)])
def test_a_solve_past_the_ring_s_limit_raises_with_its_bytes(n, m, B, C,
                                                             kernel):
    """Past the ring's limit the geometry raises a ValueError that names the
    solve and the bytes a CTA would need: squares beyond the rule, and the
    thin wide grids that the rule admits (9 x 7168) but no ring holds."""
    with pytest.raises(ValueError, match=(
            f"{KERNELS[kernel]} on an \\({n}, {m}\\) grid in clusters "
            f"of {C} needs [0-9]+ bytes of shared memory per CTA \\(at most "
            f"{BLOCKED_SMEM_LIMIT}\\)")):
        _geometry(n, m, B, kernel)
    assert per_solve_kernels_fit(n, m) == (n == 9)


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("members,B,match", [
    (1, 0, "{} takes B % 1 == 0"),
    (8, 8, r"the cluster {} is built for \(1,\) members per cluster")])
def test_a_bad_solve_batch_or_block_raises(members, B, match, kernel):
    what = KERNELS[kernel] if members == 1 else kernel
    with pytest.raises(ValueError, match=match.format(what)):
        blocked_geometry(65, 65, B, H100_SMS, members=members,
                         kernel=kernel)


def _solve_args(wrapper, B, n=9, m=7, seed=0):
    """The arguments of a cluster solve's wrapper on an (n, m) grid,
    float32, (n, m) fields for B = None; the scalars the per-step solvers
    pass as 0-d tensors (the sweep's dt/2, the marcher's 1/dt and tau/dt)
    passed so."""
    from vch_tpu_torch.ops.linsolve import make_spectral_op_2d, ops_2d
    ops = ops_2d(make_spectral_op_2d(n - 1, m - 1, 1.0 / (n - 1),
                                     1.0 / (m - 1), dtype=torch.float32,
                                     device="cpu"))
    rng = np.random.default_rng(seed)
    sh = (B or 1, n, m)
    lam = ops.lam.double().numpy()
    t = lambda a: torch.as_tensor(a if B else a[0], dtype=torch.float32)
    spectral = (ops.Vx_inv, ops.Vy_inv_T, ops.Vx, ops.VyT, ops.lam)
    if "schur" in wrapper:
        d = 1.5 / (1 - np.clip(0.5 * rng.standard_normal(sh), -0.9, 0.9) ** 2)
        denom = 100 + 5e-5 * lam ** 2 - (5 + d.mean()) * lam
        mats = spectral if "spectral" in wrapper else (
            ops.Lx, ops.LyT) + spectral[:4]
        return mats + (t(denom * np.ones(sh)), t(d),
                       t(rng.standard_normal(sh)), torch.tensor(100.0),
                       torch.tensor(5.0), 5e-5)
    fpp = 1.5 / (1 - np.clip(0.5 * rng.standard_normal(sh), -0.9, 0.9) ** 2)
    dena = 1 - 0.05 * lam + 5e-3 * lam ** 2 - 5e-3 * fpp.mean() * lam
    mats = spectral if wrapper == "bicgstab_adjoint_spectral" else (
        ops.Lx, ops.LyT) + spectral[:4]
    return mats + (t(1 / np.sqrt(np.abs(dena)) * np.ones(sh)), t(fpp),
                   t(rng.standard_normal(sh)), t(rng.standard_normal(sh)),
                   0.05, torch.tensor(5e-3))


@pytest.mark.parametrize("wrapper,oracle", [
    ("bicgstab_adjoint_spectral", "_bicgstab_adjoint_spectral_cta"),
    ("bicgstab_schur_spectral", "_bicgstab_schur_spectral_cta"),
    ("bicgstab_adjoint", "_bicgstab_adjoint_cta"),
    ("bicgstab_schur", "_bicgstab_schur_cta")])
@pytest.mark.parametrize("B", [None, 3])
def test_the_solve_and_its_oracle_run_the_plain_version_on_cpu(B, wrapper,
                                                               oracle):
    """On CPU tensors each cluster solve's wrapper and its one-CTA oracle
    run the plain version and count no launch."""
    args = _solve_args(wrapper, B)
    fns = (getattr(sk, wrapper), getattr(sk, oracle))
    before = tuple(fn.launches for fn in fns)
    ref = getattr(sk, wrapper + "_plain")(*args, n_iter=5)
    for fn in fns:
        assert torch.equal(fn(*args, n_iter=5), ref)
    assert tuple(fn.launches for fn in fns) == before
    rhs = args[-4]
    assert ref.shape == rhs.shape and bool(torch.isfinite(ref).all())
    assert oracle in km.launch_counts()
