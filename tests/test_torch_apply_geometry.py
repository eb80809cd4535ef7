"""The cluster geometry of the three operator applies (the Schur apply,
the adjoint apply and the spectral solve;
`vch_tpu_torch.ops.solve_kernels.apply_geometry`): how one (n, m) member
is split over a thread-block cluster, and the shared memory each CTA of it
needs. The CUDA kernel (csrc/apply2d.cu) recomputes the same numbers and
refuses a launch whose geometry differs, so these CPU tests hold the
kernel's split too."""
import pytest

from vch_tpu_torch.ops.solve_kernels import (SMEM_LIMIT, apply_geometry,
                                             cluster_size)

NAMES = ("schur_apply", "adjoint_apply", "spectral_solve")


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n", [2, 3, 5, 17, 33, 64, 65, 96, 97, 129, 200,
                               257])
def test_bands_cover_every_row_once_in_rank_order(name, n):
    g = apply_geometry(name, n, 65)
    assert len(g.bands) == g.cluster
    row = 0
    for start, rows in g.bands:
        assert start == row and rows >= 1
        row += rows
    assert row == n
    assert g.rows_max == max(rows for _, rows in g.bands)
    assert max(r for _, r in g.bands) - min(r for _, r in g.bands) <= 1


@pytest.mark.parametrize("name", NAMES)
def test_cluster_size_depends_on_n_alone(name):
    for n in range(2, 258):
        sizes = {apply_geometry(name, n, m).cluster for m in (2, 29, 65, 257)}
        assert sizes == {cluster_size(n)}
        assert cluster_size(n) == (min(4, n) if n <= 96
                                   else 8 if n <= 192 else 16)


@pytest.mark.parametrize("name", NAMES)
def test_shared_memory_fits_every_shape_up_to_257(name):
    worst = 0
    for n in range(2, 258):
        for m in range(2, 258):
            g = apply_geometry(name, n, m)
            assert 1 <= g.per_thread <= 4
            assert g.m_pad % 4 == 0 and m <= g.m_pad < m + 4
            worst = max(worst, g.smem_bytes)
    assert worst <= SMEM_LIMIT == 232_448


def _ring(rows, m_pad, rows_max):
    """Bytes of the two-stage ring: B slabs rows x m_pad, k-major A slabs
    rows x rows_max padded to 4."""
    return 4 * 2 * rows * (m_pad + -(-rows_max // 4) * 4)


@pytest.mark.parametrize("name,n,m,C,rows_max,per_thread,chunk,smem", [
    ("schur_apply", 65, 65, 4, 17, 1, 4, 4 * 2 * 17 * 68 + _ring(65, 68, 17)),
    ("spectral_solve", 65, 65, 4, 17, 1, 4,
     4 * 3 * 17 * 68 + _ring(65, 68, 17)),
    ("schur_apply", 33, 29, 4, 9, 1, 4, 4 * 2 * 9 * 32 + _ring(29, 32, 9)),
    ("spectral_solve", 129, 129, 8, 17, 1, 4,
     4 * 3 * 17 * 132 + _ring(68, 132, 17)),
    ("spectral_solve", 257, 257, 16, 17, 2, 4, 205_360),
    ("schur_apply", 257, 257, 16, 17, 2, 4,
     4 * 2 * 17 * 260 + _ring(68, 260, 17)),
    ("adjoint_apply", 65, 65, 4, 17, 1, 4,
     4 * 2 * 17 * 68 + _ring(65, 68, 17)),
    ("adjoint_apply", 129, 129, 8, 17, 1, 4,
     4 * 2 * 17 * 132 + _ring(68, 132, 17)),
    ("adjoint_apply", 257, 257, 16, 17, 2, 4,
     4 * 2 * 17 * 260 + _ring(68, 260, 17)),
])
def test_geometry_at_the_shapes_the_card_runs(name, n, m, C, rows_max,
                                              per_thread, chunk, smem):
    g = apply_geometry(name, n, m)
    assert (g.cluster, g.rows_max, g.per_thread, g.chunk, g.smem_bytes) == (
        C, rows_max, per_thread, chunk, smem)


def test_the_chunk_shrinks_until_the_ring_fits():
    """At n = 257 on clusters of 8 a band is 33 rows: four, three or two
    bands' worth of ring do not fit in 232,448 bytes, one does."""
    g = apply_geometry("spectral_solve", 257, 257, cluster=8)
    assert g.chunk == 1
    assert g.smem_bytes == 4 * 3 * 33 * 260 + _ring(33, 260, 33) == 181_104
    assert 4 * 3 * 33 * 260 + _ring(66, 260, 33) > SMEM_LIMIT


@pytest.mark.parametrize("name,n,m", [("spectral_solve", 129, 700),
                                      ("schur_apply", 257, 1200),
                                      ("adjoint_apply", 257, 1200),
                                      ("adjoint_apply", 600, 600),
                                      ("spectral_solve", 600, 600),
                                      ("schur_apply", 2049, 256)])
def test_a_shape_past_the_limit_raises(name, n, m):
    with pytest.raises(ValueError, match="grid needs"):
        apply_geometry(name, n, m)


def test_a_cluster_override_keeps_the_split_and_its_limits():
    g = apply_geometry("spectral_solve", 257, 257, cluster=8)
    assert g.cluster == 8 and g.rows_max == 33
    assert [r for _, r in g.bands] == [33] + [32] * 7
    assert g.per_thread == 3
    for bad in (0, 17):
        with pytest.raises(ValueError, match="cluster size"):
            apply_geometry("schur_apply", 257, 257, cluster=bad)


def test_the_adjoint_apply_has_the_schur_applys_geometry():
    """Both hold two fields per CTA (the field and the intermediate L v the
    peers read), so their splits and shared memory agree at every shape."""
    for n in (2, 33, 65, 96, 97, 129, 193, 257):
        for m in (2, 29, 65, 257):
            assert (apply_geometry("adjoint_apply", n, m)
                    == apply_geometry("schur_apply", n, m))


def test_a_name_without_a_cluster_kernel_raises():
    with pytest.raises(ValueError, match="no cluster geometry"):
        apply_geometry("bicgstab_schur", 65, 65)
