"""The bf16 cluster march's host side (`vch_tpu_torch.ops.march`): the
shared memory of its staging (`bf16_staging`, `blocked_geometry(...,
solve_passes=)`), which csrc/cluster.cuh `staging16` recomputes and checks
at every launch, and the fragment copies of apply_S's operators
(`_bf16_operators`) that product16 reads one 16-byte lane at a time."""
import numpy as np
import pytest
import torch

from vch_tpu_torch.ops.march import (BLOCKED_SMEM_LIMIT, _bf16_operators,
                                     bf16_staging, blocked_geometry,
                                     solve_passes)

H100_SMS = 132


@pytest.mark.parametrize("n,B,members,C,expect", [
    # config 4: one member on a cluster of 1 (n = 129: 9 M tiles a slab)
    (129, 128, 1, 1, (9, 9, 87_552)),
    # the headline: eight members on clusters of 2 (bands of 33 and 32)
    (65, 512, 8, 2, (33, 17, 171_520)),
    # low memory: one member on clusters of 3, 17 left M tiles in 2 slabs
    (257, 32, 1, 3, (9, 6, 165_376)),
])
def test_main_path_staging(n, B, members, C, expect):
    g = blocked_geometry(n, n, B, H100_SMS, cluster=C, members=members,
                         solve_passes=3)
    assert bf16_staging(n, n, members, g.rows_max, 3) == expect
    ring = blocked_geometry(n, n, B, H100_SMS, cluster=C, members=members)
    assert g.smem_bytes == max(ring.smem_bytes, expect[2])
    assert g.solve_passes == 3 and ring.solve_passes == 0
    assert g._replace(smem_bytes=ring.smem_bytes, solve_passes=0) == ring


@pytest.mark.parametrize("n,m", [(17, 17), (33, 29), (65, 65), (97, 97),
                                 (129, 129), (257, 257), (513, 513),
                                 (1024, 1024)])
@pytest.mark.parametrize("members", [1, 2, 4, 8])
@pytest.mark.parametrize("passes", [1, 3])
def test_slabs_cover_every_tile_within_the_limit(n, m, members, passes):
    """Every slab fits the CTA; the slabs of a product cover its M tiles
    evenly (no two differ by more than one); at the same slab widths one
    pass stages half of what three do (alone it may take wider slabs)."""
    rows = -(-n // 16)
    fit = bf16_staging(n, m, members, rows, passes)
    jl, jr, nbytes = fit
    assert nbytes <= BLOCKED_SMEM_LIMIT
    for tiles, jt in ((-(-members * m // 16), jl),
                      (-(-members * rows // 16), jr)):
        slabs = -(-tiles // jt)
        last = tiles - (slabs - 1) * jt
        assert 1 <= jt <= tiles and 1 <= last <= jt and jt - last < slabs
    if passes == 3:
        one = bf16_staging(n, m, members, rows, 1)
        if (one[0], one[1]) == (jl, jr):
            assert 2 * one[2] == nbytes


@pytest.mark.parametrize("passes", [1, 3])
def test_a_grid_past_the_staging_raises_with_its_bytes(passes):
    n = 2400 if passes == 3 else 4800
    assert bf16_staging(n, 65, 1, 4, passes) is None
    with pytest.raises(ValueError, match="bytes of shared memory"):
        blocked_geometry(n, 65, 1, H100_SMS, members=1, cluster=16,
                         solve_passes=passes)
    # the float32 march still fits there
    assert blocked_geometry(n, 65, 1, H100_SMS, members=1,
                            cluster=16).smem_bytes <= BLOCKED_SMEM_LIMIT


def test_only_the_march_takes_solve_passes():
    """The cluster march and, since the sweep's bf16 forms, the cluster
    sweep take solve passes; every other cluster kernel raises."""
    with pytest.raises(ValueError, match="only the cluster march and sweep"):
        blocked_geometry(65, 65, 8, H100_SMS, members=1, kernel="solve",
                         solve_passes=3)
    assert blocked_geometry(65, 65, 8, H100_SMS, members=1, kernel="sweep",
                            solve_passes=3).solve_passes == 3
    assert [solve_passes(p) for p in ("bf16x3", "default", "highest",
                                      None)] == [3, 1, 0, 0]


@pytest.mark.parametrize("n,m", [(17, 17), (33, 29), (40, 9)])
def test_operator_fragments_hold_each_lanes_k_pairs(n, m):
    """Row r, k tile kt, lane t of an operator's copy: hi and lo of
    P[r, 16 kt + 2t + (0, 1)] and of P[r, 16 kt + 8 + 2t + (0, 1)], zero
    past K and past the rows; Vx and Vx_inv as they are, VyT and Vy_inv_T
    transposed; hi + lo the value to bf16's second rounding."""
    rng = np.random.default_rng(0)
    mats = [torch.tensor(rng.standard_normal(s), dtype=torch.float32)
            for s in ((n, n), (n, n), (m, m), (m, m))]
    buf = _bf16_operators(*mats)
    assert buf.dtype == torch.bfloat16
    ops = (mats[0], mats[1], mats[2].T, mats[3].T)
    off = 0
    for P in ops:
        rows, K = P.shape
        KT = -(-K // 16)
        size = (rows + 8) * KT * 32
        frag = buf[off:off + size].float().view(rows + 8, KT, 4, 2, 2, 2)
        off += size
        Pp = torch.zeros((rows + 8, 16 * KT))
        Pp[:rows, :K] = P
        hi = Pp.to(torch.bfloat16).float()
        lo = (Pp - hi).to(torch.bfloat16).float()
        for t in range(4):
            for half in range(2):
                for pair in range(2):
                    k = 16 * torch.arange(KT) + 8 * half + 2 * t + pair
                    assert torch.equal(frag[:, :, t, 0, half, pair], hi[:, k])
                    assert torch.equal(frag[:, :, t, 1, half, pair], lo[:, k])
        assert (hi + lo - Pp).abs().max() <= 2.0 ** -16 * Pp.abs().max()
    assert off == buf.numel()
