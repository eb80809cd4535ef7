"""The cluster geometry of the cluster sweep (csrc/adjoint2d_cluster.cu;
`vch_tpu_torch.ops.march.blocked_geometry` / `fitted_geometry` with
kernel="sweep"): the blocked sweep, the whole one-member sweep and the
segment sweep; the routing of the solvers' blocked and segment sweeps, and
the whole sweep's and the one-CTA sweep oracles' plain path on CPU
tensors.

The sweep splits a block of members over a thread-block cluster as the
cluster march does (the same bands, ring and shared memory), and the C
entries recompute the split from (n, m, cluster, kc) and refuse a launch
whose numbers differ, so these CPU tests hold the kernel's split too. Only
the residency differs: the sweep takes its own registers, so its clusters
are fitted against its own occupancy query."""
import numpy as np
import pytest
import torch

from vch_tpu_torch.config import DELTA_SEP, ForwardSolverConfig2D
from vch_tpu_torch.models.adjoint2d import AdjointSolver2D
from vch_tpu_torch.models.forward2d import ForwardSolver2D
from vch_tpu_torch.models.lowmem import FusedLowMemBatch2D, LowMemPipeline2D
from vch_tpu_torch.ops import march as km
from vch_tpu_torch.ops.march import (BLOCKED_SMEM_LIMIT, blocked_geometry,
                                     fitted_geometry)
from vch_tpu_torch.ops.potential import init_phi_random_2d

H100_SMS = 132


@pytest.mark.parametrize("members,B,C", [(8, 8, 16), (8, 64, 16),
                                         (8, 512, 2), (4, 8, 16),
                                         (2, 64, 4), (1, 32, 4), (1, 1, 16)])
def test_the_sweep_splits_a_block_as_the_march_does(members, B, C):
    """Cluster size from the blocks and the SMs, bands in rank order
    covering every row once, the ring's bytes: the march's geometry."""
    n = 257 if members == 1 else 65
    g = blocked_geometry(n, n, B, H100_SMS, members=members, kernel="sweep")
    assert g == blocked_geometry(n, n, B, H100_SMS, members=members)
    assert g.members == members and g.cluster == C
    row = 0
    for start, rows in g.bands:
        assert start == row and rows >= 1
        row += rows
    assert row == n and len(g.bands) == C
    assert g.units == members * (g.rows_pad // 4) * (g.m_pad // 4)
    assert g.passes == -(-g.units // 768)
    assert g.smem_bytes == 4 * 2 * g.kc * (members * (g.rows_pad + g.m_pad)
                                           + 4)
    assert g.smem_bytes <= BLOCKED_SMEM_LIMIT


def test_the_segment_sweep_at_the_low_memory_shape():
    """257 x 257, B = 32 by the SM rule: clusters of 4, bands of 65 and 64
    rows, 1105 units in two passes, 84,992 bytes of ring per CTA."""
    g = blocked_geometry(257, 257, 32, H100_SMS, members=1, kernel="sweep")
    assert g.cluster == 4 and [r for _, r in g.bands] == [65, 64, 64, 64]
    assert (g.rows_pad, g.m_pad, g.units, g.passes, g.kc,
            g.smem_bytes) == (68, 260, 1105, 2, 32, 84_992)


def test_the_blocked_sweep_at_257_takes_a_smaller_ring():
    """Eight members of 257 x 257 on clusters of 16 (the card tests' shape):
    a ring of 8 k rows, within the limit."""
    g = blocked_geometry(257, 257, 8, H100_SMS, kernel="sweep")
    assert g.cluster == 16 and g.rows_pad == 20 and g.m_pad == 260
    assert g.kc == 8 and g.smem_bytes == 4 * 2 * 8 * (8 * 280 + 4)
    assert 4 * 2 * 16 * (8 * 280 + 4) > BLOCKED_SMEM_LIMIT


@pytest.mark.parametrize("members,n,C,what", [
    (8, 1000, 1, "blocked sweep"),
    (1, 3600, 1, r"one-member sweep \(whole or segment sweep\)"),
    (1, 7200, 16, r"one-member sweep \(whole or segment sweep\)")])
def test_a_sweep_past_the_limit_raises_with_its_bytes(members, n, C, what):
    with pytest.raises(ValueError, match=f"{what} on an \\({n}, {n}\\) grid "
                       f"in clusters of {C} needs [0-9]+ bytes of shared "
                       f"memory per CTA \\(at most {BLOCKED_SMEM_LIMIT}\\)"):
        blocked_geometry(n, n, members, H100_SMS, cluster=C, members=members,
                         kernel="sweep")


@pytest.mark.parametrize("members,B,match", [(8, 12, "B % 8"),
                                             (1, 0, "B % 1"),
                                             (3, 6, "cluster sweep is built")])
def test_a_bad_sweep_batch_or_block_raises(members, B, match):
    with pytest.raises(ValueError, match=match):
        blocked_geometry(65, 65, B, H100_SMS, members=members,
                         kernel="sweep")


def test_an_unknown_kernel_raises():
    with pytest.raises(ValueError, match="kernel must be one of"):
        blocked_geometry(65, 65, 8, H100_SMS, kernel="apply")


# the whole one-member sweep (row 2): C by the SM rule, then the fit on a
# fake residency of 66 // C clusters
_WHOLE = [(65, 1, 16, 5, 8, 68, 32, 20_480),
          (65, 128, 1, 65, 68, 68, 32, 35_840),
          (129, 1, 16, 9, 12, 132, 32, 37_888),
          (129, 128, 1, 129, 132, 132, 32, 68_608),
          (257, 1, 16, 17, 20, 260, 32, 72_704),
          (257, 128, 1, 257, 260, 260, 32, 134_144)]


@pytest.mark.parametrize("n,B,C,rows,rpad,mpad,kc,smem", _WHOLE)
def test_the_whole_one_member_sweep_splits_as_the_one_member_march(
        n, B, C, rows, rpad, mpad, kc, smem):
    """One member per cluster: up to 16 CTAs at B = 1, one at B = 128
    (more members than SMs), the bands covering every row once, a ring of
    kc k rows within the limit, the one-member march's split."""
    g = blocked_geometry(n, n, B, H100_SMS, members=1, kernel="sweep")
    assert g == blocked_geometry(n, n, B, H100_SMS, members=1)
    assert (g.members, g.cluster, g.rows_max, g.rows_pad, g.m_pad,
            g.kc, g.smem_bytes) == (1, C, rows, rpad, mpad, kc, smem)
    assert sum(r for _, r in g.bands) == n and len(g.bands) == C
    assert g.smem_bytes == 4 * 2 * g.kc * (g.rows_pad + g.m_pad + 4)
    assert g.smem_bytes <= BLOCKED_SMEM_LIMIT
    assert 4 * 2 * 2 * g.kc * (g.rows_pad + g.m_pad + 4) > BLOCKED_SMEM_LIMIT \
        or g.kc == 32


@pytest.mark.parametrize("n,B,C,rows,rpad,mpad,kc,smem", _WHOLE)
def test_the_whole_one_member_sweep_fits_its_own_residency(
        n, B, C, rows, rpad, mpad, kc, smem):
    """At B = 1 the card holds the 16-CTA cluster (66 // 16 = 4 >= 1); at
    B = 128 the clusters of one CTA cannot all be resident (66 < 128) and
    nothing smaller exists, so C stays 1."""
    g = fitted_geometry(n, n, B, H100_SMS, _fake_sweep_resident, members=1,
                        kernel="sweep")
    assert g.cluster == C
    assert g == blocked_geometry(n, n, B, H100_SMS, cluster=C, members=1,
                                 kernel="sweep")
    assert _fake_sweep_resident(g) >= B or C == 1


def test_the_one_member_sweep_is_named_in_its_errors():
    with pytest.raises(ValueError, match=r"the one-member sweep \(whole or "
                       r"segment sweep\) takes B % 1 == 0, got B = 0"):
        blocked_geometry(65, 65, 0, H100_SMS, members=1, kernel="sweep")
    with pytest.raises(ValueError, match=r"the one-member sweep \(whole or "
                       r"segment sweep\) on an \(7200, 7200\) grid"):
        blocked_geometry(7200, 7200, 1, H100_SMS, members=1, kernel="sweep")


# Clusters the card holds at once of a kernel whose registers allow half
# the march's resident CTAs (one per two SMs): a model that only exercises
# the search.
def _fake_sweep_resident(geo):
    return 66 // geo.cluster


@pytest.mark.parametrize("members,n,B,C", [(1, 257, 32, 2), (1, 257, 16, 4),
                                           (1, 257, 8, 8), (1, 257, 2, 16),
                                           (8, 65, 64, 8), (8, 65, 512, 1),
                                           (8, 65, 16, 16), (4, 65, 64, 4)])
def test_the_fit_shrinks_the_sweep_cluster_on_its_own_residency(members, n,
                                                                B, C):
    """The fit takes the sweep's own residency: where it holds fewer
    clusters than the SM rule gives, the cluster shrinks (eight members
    first from 16 to 8) until every cluster is resident at once: at
    257 x 257, B = 32 on clusters of 2 where the SM rule gives 4."""
    g = fitted_geometry(n, n, B, H100_SMS, _fake_sweep_resident,
                        members=members, kernel="sweep")
    assert g.members == members and g.cluster == C
    assert g == blocked_geometry(n, n, B, H100_SMS, cluster=C,
                                 members=members, kernel="sweep")
    assert _fake_sweep_resident(g) >= B // members or C == 1


def _solvers(n=17, T=0.03):
    cfg = ForwardSolverConfig2D(Nx=n - 1, Ny=n - 1, T=T, dtype="float32",
                                newton_tol=2e-4)
    return (ForwardSolver2D(cfg, device="cpu"),
            AdjointSolver2D(cfg, device="cpu"))


def _sweep_inputs(fwd, B, seed=0):
    """A history of B members inside (-0.5, 0.5), seeded weights, zero
    targets along the way and terminal targets from init_phi_random_2d."""
    n = fwd.config.Nx + 1
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    phi0 = f32(np.stack([init_phi_random_2d(n - 1, n - 1, DELTA_SEP,
                                            seed=42 + i) for i in range(B)]))
    hist = f32(0.5 * np.tanh(rng.standard_normal((B, fwd.M + 1, n, n))))
    return (hist, f32(np.linspace(0.3, 5.0, B)),
            f32(np.linspace(13.0, 10.0, B)), torch.zeros_like(hist),
            0.1 * phi0)


class _Recorder:
    """An entry that records its calls and runs the plain version."""

    def __init__(self, plain):
        self.plain, self.calls = plain, []

    def __call__(self, *args, **kw):
        self.calls.append(kw)
        return self.plain(*args, **kw)


@pytest.mark.parametrize("B,blocked", [(8, True), (16, True), (6, False)])
def test_the_solver_routes_the_blocked_sweep(B, blocked):
    """vch_tpu's rule: block_b = 8 on grids of up to 96 points when B
    divides by it (entries.adjoint_blocked), else the whole sweep."""
    fwd, adj = _solvers()
    rec_b = _Recorder(km.adjoint_fused_2d_blocked_plain)
    rec_w = _Recorder(km.adjoint_fused_2d_plain)
    adj.entries = km.PLAIN._replace(adjoint_blocked=rec_b, adjoint=rec_w)
    hist, b1, b2, phiQ, phiT = _sweep_inputs(fwd, B)
    r = adj.adjoint_fused_batch(hist, b1, b2, phiQ, phiT)
    assert r.shape == hist.shape
    assert len(rec_b.calls) == int(blocked)
    assert len(rec_w.calls) == int(not blocked)
    if blocked:
        assert rec_b.calls[0]["block_b"] == 8


def test_the_low_memory_arm_routes_its_segments_to_the_segment_sweep():
    """The fused low-memory arm's sweep calls entries.adjoint_segment once
    per segment, with the segment's own steps."""
    pipe = LowMemPipeline2D(ForwardSolverConfig2D(
        Nx=16, Ny=16, T=0.05, dtype="float32", newton_tol=2e-4), K=2,
        device="cpu")
    rec = _Recorder(km.adjoint_fused_2d_segment_plain)
    pipe.adjoint.entries = km.PLAIN._replace(adjoint_segment=rec)
    fused = FusedLowMemBatch2D(pipe)
    hist, b1, b2, phiQ, phiT = _sweep_inputs(pipe.solver, 2)
    p, q, r = pipe.adjoint.terminal(hist[:, -1], phiT, b2)
    out = fused._sweep(1, 2, hist[:, 1:4].contiguous(), phiQ[:, 1:4], p, q, r,
                       b1)
    assert len(rec.calls) == 1 and out[0].shape == (2, 2, 17, 17)


def test_the_sweep_oracles_run_the_plain_version_on_cpu_tensors():
    fwd, adj = _solvers()
    hist, b1, b2, phiQ, phiT = _sweep_inputs(fwd, 2)
    aargs = (adj.dts, hist, phiQ, phiT, b1, b2) + adj._ops()
    before = (km._adjoint_fused_2d_cta.launches,
              km._adjoint_fused_2d_segment_cta.launches,
              km.adjoint_fused_2d_segment.launches)
    ref = km.adjoint_fused_2d_plain(*aargs, **adj._kw())
    assert torch.equal(km._adjoint_fused_2d_cta(*aargs, **adj._kw()), ref)
    K = adj.dts.shape[0]
    p, q, r = adj.terminal(hist[:, K], phiT, b2)
    sargs = (adj.dts, hist, phiQ, p, q, r, b1) + adj._ops()
    sref = km.adjoint_fused_2d_segment_plain(*sargs, **adj._kw())
    for fn in (km.adjoint_fused_2d_segment, km._adjoint_fused_2d_segment_cta):
        for a, b in zip(fn(*sargs, **adj._kw()), sref):
            assert torch.equal(a, b)
    assert (km._adjoint_fused_2d_cta.launches,
            km._adjoint_fused_2d_segment_cta.launches,
            km.adjoint_fused_2d_segment.launches) == before
    counts = km.launch_counts()
    assert "_adjoint_fused_2d_cta" in counts
    assert "_adjoint_fused_2d_segment_cta" in counts


def test_the_whole_sweep_runs_the_plain_version_on_cpu_tensors():
    """`adjoint_fused_2d` (the cluster kernel on the card) on CPU tensors:
    the plain version, no launch counted."""
    fwd, adj = _solvers()
    hist, b1, b2, phiQ, phiT = _sweep_inputs(fwd, 3)
    aargs = (adj.dts, hist, phiQ, phiT, b1, b2) + adj._ops()
    before = km.adjoint_fused_2d.launches
    ref = km.adjoint_fused_2d_plain(*aargs, **adj._kw())
    assert torch.equal(km.adjoint_fused_2d(*aargs, **adj._kw()), ref)
    assert km.adjoint_fused_2d.launches == before
    assert ref.shape == hist.shape and (ref[:, -1] == 0).all()
