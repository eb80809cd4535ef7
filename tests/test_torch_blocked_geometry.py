"""The cluster geometry of the cluster march
(`vch_tpu_torch.ops.march.blocked_geometry`): how a block of eight members
(the member-blocked march) or one member (the segment march) is split over
a thread-block cluster, how many CTAs a block takes on a card of a given SM
count, and the shared memory each CTA needs. The CUDA kernel
(csrc/march2d_blocked.cu) recomputes the split and the shared memory from
(n, m, cluster, kc) and refuses a launch whose numbers differ, so these CPU
tests hold the kernel's split too."""
import pytest

from vch_tpu_torch.config import ForwardSolverConfig2D
from vch_tpu_torch.ops.march import (BLOCKED_SMEM_LIMIT, SEGMENT_MEMBERS,
                                     blocked_cluster_size, blocked_geometry,
                                     fitted_geometry)

H100_SMS = 132


@pytest.mark.parametrize("n,C", [(n, C) for n in (12, 17, 29, 33, 64, 65, 96,
                                                  97)
                                 for C in (1, 2, 4, 8, 16) if C <= n])
def test_bands_cover_every_row_once_in_rank_order(n, C):
    g = blocked_geometry(n, 65, 8, H100_SMS, cluster=C)
    assert g.cluster == C and len(g.bands) == C
    row = 0
    for start, rows in g.bands:
        assert start == row and rows >= 1
        row += rows
    assert row == n
    assert g.rows_max == max(r for _, r in g.bands)
    assert max(r for _, r in g.bands) - min(r for _, r in g.bands) <= 1
    assert g.rows_pad % 4 == 0 and g.rows_max <= g.rows_pad < g.rows_max + 4


@pytest.mark.parametrize("B,sms,C", [
    (512, 132, 2),      # bench.py's headline: 64 blocks, 128 CTAs
    (64, 132, 16),      # 8 blocks of 16
    (8, 132, 16),
    (16, 132, 16),
    (144, 132, 4),      # 18 blocks
    (256, 132, 4),
    (1024, 132, 1),     # more blocks than SMs: one CTA each
    (2048, 132, 1),
    (512, 114, 1),      # a card of 114 SMs
    (64, 114, 8),
])
def test_the_cluster_follows_the_blocks_and_the_sms(B, sms, C):
    assert blocked_cluster_size(65, B, sms) == C
    assert blocked_geometry(65, 65, B, sms).cluster == C
    assert (B // 8) * C <= sms or C == 1


@pytest.mark.parametrize("n", [2, 3, 5, 9, 12, 15, 16, 17])
def test_the_cluster_never_exceeds_n_nor_the_limit(n):
    for B in (8, 16, 64, 512):
        C = blocked_cluster_size(n, B, H100_SMS)
        assert 1 <= C <= min(n, 16) and C & (C - 1) == 0
        assert blocked_cluster_size(n, B, H100_SMS, max_cluster=8) <= 8


def test_shared_memory_fits_every_blocked_route_grid():
    """Every grid the solvers send to the blocked march (Nx, Ny <= 96: up
    to 97 x 97 points, ForwardSolverConfig2D.resolved_fused_block) at the
    batches the card tests and chip_smoke.py run, and 33 x 29."""
    assert ForwardSolverConfig2D(Nx=96, Ny=96).resolved_fused_block() == 8
    assert ForwardSolverConfig2D(Nx=97, Ny=96).resolved_fused_block() == 0
    worst = 0
    for n in range(12, 98):
        for m in range(12, 98):
            for B in (8, 64, 512):
                g = blocked_geometry(n, m, B, H100_SMS)
                assert g.m_pad % 4 == 0 and m <= g.m_pad < m + 4
                assert g.units == 8 * (g.rows_pad // 4) * (g.m_pad // 4)
                assert g.passes == -(-g.units // 768)
                assert g.kc in (32, 16, 8, 4)
                worst = max(worst, g.smem_bytes)
    assert worst <= BLOCKED_SMEM_LIMIT == 232_448 - 4096
    g = blocked_geometry(33, 29, 8, H100_SMS)
    assert (g.cluster, g.rows_max, g.m_pad, g.kc) == (16, 3, 32, 32)


def test_geometry_at_the_headline_shape():
    """n = 65, B = 512 on an H100: 64 blocks on clusters of 2, bands of 33
    and 32 rows; 1224 units in two passes of up to 768; a ring of 32 k
    rows."""
    g = blocked_geometry(65, 65, 512, H100_SMS)
    assert g.cluster == 2 and [r for _, r in g.bands] == [33, 32]
    assert (g.rows_pad, g.m_pad, g.units, g.passes) == (36, 68, 1224, 2)
    assert g.kc == 32 and g.smem_bytes == 4 * 2 * 32 * (8 * (36 + 68) + 4)


def test_the_ring_shrinks_until_it_fits():
    g = blocked_geometry(97, 97, 512, H100_SMS, cluster=1)
    assert g.kc == 16
    assert 4 * 2 * 32 * (8 * (g.rows_pad + g.m_pad) + 4) > BLOCKED_SMEM_LIMIT
    assert g.smem_bytes <= BLOCKED_SMEM_LIMIT


@pytest.mark.parametrize("n,m,C", [(1000, 1000, 1), (900, 1200, 1)])
def test_a_shape_past_the_limit_raises(n, m, C):
    with pytest.raises(ValueError, match="bytes of shared memory"):
        blocked_geometry(n, m, 8, H100_SMS, cluster=C)


@pytest.mark.parametrize("B", [0, 4, 12, 100])
def test_a_batch_not_of_whole_blocks_raises(B):
    with pytest.raises(ValueError, match="B % 8"):
        blocked_geometry(65, 65, B, H100_SMS)


def test_a_cluster_override_past_n_or_16_raises():
    for bad in (0, 17):
        with pytest.raises(ValueError, match="cluster size"):
            blocked_geometry(65, 65, 8, H100_SMS, cluster=bad)
    with pytest.raises(ValueError, match="cluster size"):
        blocked_geometry(12, 12, 8, H100_SMS, cluster=16)


@pytest.mark.parametrize("n,m,B", [(65, 65, 512), (65, 65, 64), (33, 29, 8),
                                   (97, 97, 16)])
def test_eight_members_per_cluster_is_the_default(n, m, B):
    g = blocked_geometry(n, m, B, H100_SMS)
    assert g.members == 8
    assert g == blocked_geometry(n, m, B, H100_SMS, members=8)
    assert g.cluster == blocked_cluster_size(n, B, H100_SMS, members=8)


# ---- one member per cluster: the segment march ---------------------------

@pytest.mark.parametrize("C", [1, 2, 3, 4, 8, 16])
def test_one_member_bands_cover_every_row_once_at_257(C):
    g = blocked_geometry(257, 257, 2, H100_SMS, cluster=C,
                         members=SEGMENT_MEMBERS)
    assert g.members == 1 and g.cluster == C and len(g.bands) == C
    row = 0
    for start, rows in g.bands:
        assert start == row and rows >= 1
        row += rows
    assert row == 257
    assert g.rows_max == max(r for _, r in g.bands)
    assert max(r for _, r in g.bands) - min(r for _, r in g.bands) <= 1
    assert g.rows_pad % 4 == 0 and g.rows_max <= g.rows_pad < g.rows_max + 4
    assert g.units == (g.rows_pad // 4) * (g.m_pad // 4)


@pytest.mark.parametrize("B,C", [(1, 16), (2, 16), (4, 16), (8, 16),
                                 (16, 8), (32, 4)])
def test_one_member_cluster_follows_the_batch_and_the_sms(B, C):
    """The largest power of two up to 16 and n with B C <= 132: phase 6's
    B = 32 on clusters of 4 (128 CTAs), its straggler buckets and B = 1-2
    on 16 (8 where the occupancy query cannot hold every 16-cluster)."""
    assert blocked_cluster_size(257, B, H100_SMS, members=1) == C
    g = blocked_geometry(257, 257, B, H100_SMS, members=SEGMENT_MEMBERS)
    assert g.cluster == C and B * C <= H100_SMS
    assert blocked_geometry(257, 257, B, H100_SMS, max_cluster=8,
                            members=1).cluster == min(C, 8)


def test_one_member_shared_memory_fits_every_grid_up_to_257():
    """Every (n, m) up to 257 x 257 at the batches of the low-memory arm
    and its straggler buckets keeps the ring of 32 k rows."""
    worst = 0
    for n in range(2, 258):
        for m in {2, 29, n, 257}:
            for B in (1, 2, 8, 16, 32):
                g = blocked_geometry(n, m, B, H100_SMS, members=1)
                assert g.m_pad % 4 == 0 and m <= g.m_pad < m + 4
                assert g.units == (g.rows_pad // 4) * (g.m_pad // 4)
                assert g.passes == -(-g.units // 768) and g.kc == 32
                assert g.smem_bytes == 4 * 2 * 32 * (g.rows_pad + g.m_pad + 4)
                worst = max(worst, g.smem_bytes)
    assert worst <= BLOCKED_SMEM_LIMIT
    g = blocked_geometry(257, 257, 257, H100_SMS, cluster=1, members=1)
    assert g.kc == 32 and g.smem_bytes <= BLOCKED_SMEM_LIMIT


def test_one_member_geometry_at_the_low_memory_shape():
    """257 x 257, B = 32: clusters of 4, bands of 65 and 64 rows, 1105
    units in two passes, 84,992 bytes of ring per CTA."""
    g = blocked_geometry(257, 257, 32, H100_SMS, members=1)
    assert g.cluster == 4 and [r for _, r in g.bands] == [65, 64, 64, 64]
    assert (g.rows_pad, g.m_pad, g.units, g.passes) == (68, 260, 1105, 2)
    assert g.kc == 32 and g.smem_bytes == 84_992


@pytest.mark.parametrize("n,m,C", [(3600, 3600, 1), (1000, 6200, 1),
                                   (7200, 7200, 16)])
def test_a_one_member_shape_past_the_limit_raises(n, m, C):
    with pytest.raises(ValueError, match="segment march.*bytes of shared "
                                         "memory"):
        blocked_geometry(n, m, 1, H100_SMS, cluster=C, members=1)


@pytest.mark.parametrize("members,B,match", [(1, 0, "B % 1"),
                                             (3, 6, "built for")])
def test_a_bad_batch_or_member_count_raises(members, B, match):
    with pytest.raises(ValueError, match=match):
        blocked_geometry(65, 65, B, H100_SMS, members=members)


# Clusters of C CTAs an H100 holds at once with one member per cluster at
# 257 x 257 (cudaOccupancyMaxActiveClusters, measured at C = 2, 3, 4, 6, 8,
# 12, 16); other sizes from a model (132 // C up to 8 CTAs, 7 above) that
# only exercises the search.
H100_RESIDENT_257 = {16: 7, 12: 7, 8: 15, 6: 17, 4: 30, 3: 39, 2: 66}


def _h100_resident(geo):
    C = geo.cluster
    return H100_RESIDENT_257.get(C, 7 if C > 8 else H100_SMS // C)


@pytest.mark.parametrize("B,C", [(1, 16), (2, 16), (4, 16), (8, 8), (16, 7),
                                 (32, 3), (64, 2), (200, 1)])
def test_the_segment_cluster_shrinks_until_every_cluster_is_resident(B, C):
    """Below the SM rule, one member per cluster shrinks the cluster one
    CTA at a time until the card holds all B clusters at once: B = 32 on
    clusters of 3 (4 would hold 30 of 32 at once, a second wave)."""
    g = fitted_geometry(257, 257, B, H100_SMS, _h100_resident,
                        members=SEGMENT_MEMBERS)
    assert g.members == 1 and g.cluster == C
    assert g == blocked_geometry(257, 257, B, H100_SMS, cluster=C, members=1)
    assert _h100_resident(g) >= B or C == 1


@pytest.mark.parametrize("B,resident16,C", [(512, 7, 2), (64, 7, 8),
                                            (8, 7, 16), (16, 1, 8)])
def test_the_blocked_cluster_takes_8_where_16_is_not_resident(B, resident16,
                                                             C):
    """Eight members per cluster keep their rule: 16 where every cluster is
    resident, else 8 (n = 65, B = 64 on the H100 took 8)."""
    resident = lambda g: (resident16 if g.cluster == 16
                          else 15 if g.cluster == 8 else H100_SMS // g.cluster)
    g = fitted_geometry(65, 65, B, H100_SMS, resident)
    assert g.members == 8 and g.cluster == C


# ---- two and four members per cluster (the blocked march at block_b = 2
# and 4), and the whole one-member march -----------------------------------

@pytest.mark.parametrize("members,B,C", [(2, 8, 16), (4, 8, 16), (2, 64, 4),
                                         (4, 64, 8), (2, 512, 1),
                                         (4, 512, 1)])
def test_two_and_four_members_follow_the_blocks_and_the_sms(members, B, C):
    g = blocked_geometry(65, 65, B, H100_SMS, members=members)
    assert g.members == members and g.cluster == C
    assert g.units == members * (g.rows_pad // 4) * (g.m_pad // 4)
    assert g.smem_bytes == 4 * 2 * g.kc * (members * (g.rows_pad + g.m_pad)
                                           + 4)
    assert g.smem_bytes <= BLOCKED_SMEM_LIMIT
    assert (B // members) * C <= H100_SMS or C == 1


@pytest.mark.parametrize("members,B,C", [(2, 8, 16), (4, 8, 16),
                                         (2, 64, 3), (4, 64, 7),
                                         (2, 128, 2), (4, 128, 3)])
def test_two_and_four_members_shrink_until_every_cluster_is_resident(
        members, B, C):
    """Two and four members per cluster take the one-member search: B = 64
    at two members is 32 clusters, 4 CTAs each by the SM rule, of which the
    card holds 30; clusters of 3 are all resident (at four members, 16
    clusters of 8, 15 resident: 7)."""
    g = fitted_geometry(65, 65, B, H100_SMS, _h100_resident, members=members)
    assert g.members == members and g.cluster == C
    assert _h100_resident(g) >= B // members or C == 1


@pytest.mark.parametrize("B,C", [(128, 1), (64, 2), (32, 3), (16, 7), (8, 8),
                                 (1, 16)])
def test_one_member_march_at_config_4_and_its_buckets(B, C):
    """Config 4 (129 x 129, B = 128): one CTA per member, the card holding
    one per SM; its straggler buckets shrink to resident clusters."""
    g = fitted_geometry(129, 129, B, H100_SMS, _h100_resident, members=1)
    assert g.members == 1 and g.cluster == C
    assert g == blocked_geometry(129, 129, B, H100_SMS, cluster=C, members=1)
    assert B * C <= H100_SMS and (_h100_resident(g) >= B or C == 1)
    assert g.smem_bytes <= BLOCKED_SMEM_LIMIT


@pytest.mark.parametrize("B,C", [(1, 16), (5, 16), (8, 8)])
def test_one_member_march_at_config_3(B, C):
    """Config 3 (65 x 65): the trial march of one member on a cluster of 16,
    the checks' five members too (seven such clusters are resident)."""
    g = fitted_geometry(65, 65, B, H100_SMS, _h100_resident, members=1)
    assert g.cluster == C and [r for _, r in g.bands][:2] == (
        [5, 4] if C == 16 else [9, 8])
    assert g.units == (g.rows_pad // 4) * (g.m_pad // 4)


@pytest.mark.parametrize("members", [2, 4])
def test_a_batch_not_of_whole_blocks_of_two_or_four_raises(members):
    with pytest.raises(ValueError, match=f"B % {members}"):
        blocked_geometry(65, 65, members + 1, H100_SMS, members=members)


@pytest.mark.parametrize("B,C", [(512, 2), (256, 3), (128, 6), (64, 8),
                                 (32, 16), (8, 16)])
def test_the_blocked_cluster_shrinks_where_its_rule_leaves_a_second_wave(
        B, C):
    """Eight members at 65 x 65 on the H100's residency (measured at
    B = 128 and 256: 15 clusters of 8 and 30 of 4 at once, 17 of 6 and 39
    of 3): the 16 -> 8 trade, then the one-member search where clusters
    still wait: B = 128 on clusters of 6, B = 256 on 3."""
    held = {16: 7, 8: 15, 7: 15, 6: 17, 4: 30, 3: 39, 2: 66}
    g = fitted_geometry(65, 65, B, H100_SMS, lambda g: held[g.cluster])
    assert g.members == 8 and g.cluster == C
    assert held[C] >= B // 8
