"""The cluster geometry of the 1D march (`vch_tpu_torch.ops.march.
march1d_geometry`): how B members of length n are split over thread-block
clusters, how the columns are cut into bands of whole chunks (32 columns,
the last with the rest),
whether the operator bands stay in shared memory, and the shared memory
each CTA needs. The CUDA kernel (csrc/march1d.cu) recomputes the split and
the shared memory from (n, cluster, members, kc, resident) and refuses
a
launch whose numbers differ, so these CPU tests hold the kernel's split
too."""
import pytest

from vch_tpu_torch.ops.march import (MARCH_1D_CHUNK, MARCH_1D_MEMBERS_MAX,
                                     MARCH_1D_SMEM_LIMIT, march1d_geometry)

H100_SMS = 132


def _h100_resident(geo):
    """Clusters the H100 holds at once: one CTA per SM, 7 clusters of 16
    (measured for the 2D cluster march), 15 of 8, 30 of 4; other
    sizes from a model that only exercises the choice."""
    C = geo.cluster
    return {16: 7, 8: 15, 4: 30}.get(C, 7 if C > 8 else H100_SMS // C)


@pytest.mark.parametrize("n", [2, 17, 32, 33, 64, 65, 129, 257, 513, 545,
                               1025, 2049])
@pytest.mark.parametrize("C", [1, 2, 3, 5, 16])
def test_bands_are_whole_chunks_covering_every_column_once(n, C):
    nch = max(1, n // MARCH_1D_CHUNK)
    if C > min(16, nch):
        with pytest.raises(ValueError, match="cluster size"):
            march1d_geometry(n, 8, _h100_resident, cluster=C)
        return
    g = march1d_geometry(n, 8, _h100_resident, cluster=C)
    assert g.cluster == C and len(g.bands) == len(g.chunks) == C
    col = chunk = 0
    for (first, cols), (fc, nc) in zip(g.bands, g.chunks):
        assert first == col == MARCH_1D_CHUNK * fc and fc == chunk
        assert nc >= 1 and cols >= 1
        col += cols
        chunk += nc
    assert col == n and chunk == nch
    counts = [nc for _, nc in g.chunks]
    assert max(counts) - min(counts) <= 1 and counts == sorted(counts)
    assert g.width == max(cols for _, cols in g.bands)
    # every band but the last is whole chunks of 32; the last takes the rest
    assert all(cols == MARCH_1D_CHUNK * nc
               for (_, cols), (_, nc) in zip(g.bands[:-1], g.chunks[:-1]))
    assert g.bands[-1][1] - MARCH_1D_CHUNK * g.chunks[-1][1] == (
        n % MARCH_1D_CHUNK if n >= MARCH_1D_CHUNK else n - MARCH_1D_CHUNK)


@pytest.mark.parametrize("n,B,C,width,members,clusters", [
    (129, 8, 1, 129, 1, 8),         # config 1's grid: one CTA holds it all
    (257, 256, 4, 65, 9, 29),
    (513, 256, 16, 33, 37, 7),      # config 2: 7 clusters of 16 CTAs
    (513, 8, 16, 33, 2, 4),         # its smallest straggler bucket
    (513, 270, 16, 33, 39, 7),
])
def test_the_operator_bands_stay_in_shared_memory(n, B, C, width, members,
                                                  clusters):
    """The smallest cluster whose bands of the three (n, n) operators fit
    in one CTA's shared memory: n = 129 on one CTA, 257 on 4, 513 on 16
    (bands of 32 columns and one of 33: 203,148 bytes of operators)."""
    g = march1d_geometry(n, B, _h100_resident)
    assert g.resident
    assert (g.cluster, g.width, g.members, g.clusters) == (C, width, members,
                                                           clusters)
    assert g.smem_bytes <= MARCH_1D_SMEM_LIMIT == 232_448 - 8192
    assert 4 * 3 * n * g.width <= g.smem_bytes
    assert g.members * g.clusters >= B > g.members * (g.clusters - 1)
    if C > 1:
        assert march1d_geometry(n, B, _h100_resident,
                                cluster=C - 1).resident is False


def test_config_2_shape():
    """n = 513, B = 256: 37 members on each of 7 clusters of 16 CTAs, one
    chunk each (the last 33 columns), a ring of 2 stages of 32 k rows,
    222,860 bytes of shared memory per CTA."""
    g = march1d_geometry(513, 256, _h100_resident)
    assert [c for _, c in g.bands] == [32] * 15 + [33]
    assert [k for _, k in g.chunks] == [1] * 16
    assert g.kc == 32
    mbp = 40
    assert g.smem_bytes == 4 * (2 * mbp * 32 + 2 * 2 * 37 * 16
                                + 3 * 513 * 33)
    assert g.smem_bytes == 222_860


@pytest.mark.parametrize("n,B", [(545, 256), (1025, 64), (2049, 256),
                                 (8193, 8), (40001, 8)])
def test_wide_grids_stream_the_operators(n, B):
    """Past n = 544 no band of the three operators fits: clusters of 16
    stream the operator rows with the inputs through the ring; the march
    still runs (vch_tpu's own rule bounds the fused 1D march at B = 8 near
    n = 64,800)."""
    g = march1d_geometry(n, B, _h100_resident)
    assert not g.resident and g.cluster == 16
    assert g.smem_bytes <= MARCH_1D_SMEM_LIMIT
    assert 1 <= g.members <= MARCH_1D_MEMBERS_MAX


@pytest.mark.parametrize("B", [1, 7, 64, 448, 449, 1000])
def test_members_follow_the_resident_clusters(B):
    g = march1d_geometry(513, B, _h100_resident)
    assert g.members == min(MARCH_1D_MEMBERS_MAX, -(-B // min(7, B)))
    assert g.clusters == -(-B // g.members)
    assert g.clusters <= 7 or g.members == MARCH_1D_MEMBERS_MAX


@pytest.mark.parametrize("n,B", [(129, 8), (257, 256), (513, 8), (513, 256),
                                 (2049, 256)])
def test_the_ring_takes_32_rows_a_stage(n, B):
    g = march1d_geometry(n, B, _h100_resident)
    assert g.kc == 32 and g.smem_bytes <= MARCH_1D_SMEM_LIMIT


def test_member_and_cluster_overrides():
    g = march1d_geometry(513, 256, _h100_resident, members=3)
    assert g.members == 3 and g.clusters == 86 and g.cluster == 16
    with pytest.raises(ValueError, match="members per cluster"):
        march1d_geometry(513, 8, _h100_resident, members=65)
    with pytest.raises(ValueError, match="cluster size"):
        march1d_geometry(65, 8, _h100_resident, cluster=3)


def test_a_card_that_holds_no_cluster_keeps_the_largest_group():
    g = march1d_geometry(513, 256, lambda geo: 0)
    assert g.members == MARCH_1D_MEMBERS_MAX and g.clusters == 4


@pytest.mark.parametrize("n,B", [(1, 4), (65, 0)])
def test_a_degenerate_shape_raises(n, B):
    with pytest.raises(ValueError, match="n >= 2 and B >= 1"):
        march1d_geometry(n, B, _h100_resident)
