"""The launch geometry of the microbench probe's Hopper kernel
(csrc/micro_cluster.cu), on the CPU.

The microbench runs its one block of bb members on one thread-block cluster
of the cluster engine, so its split is `ops.march.blocked_geometry` /
`fitted_geometry` with kernel="micro" and B = members (the march's split:
the same bands, ring and shared memory), fitted against the microbench
kernel's own occupancy query; the C entry recomputes the split from
(n, cluster, kc) and refuses a launch whose numbers differ, so these tests
hold the kernel's split too. On CPU tensors the wrapper and its one-CTA
oracle run the plain version and launch nothing."""
import pytest
import torch

from vch_tpu_torch.ops import march as km
from vch_tpu_torch.ops import probe_kernels as pk
from vch_tpu_torch.ops.march import (BLOCKED_SMEM_LIMIT, blocked_geometry,
                                     fitted_geometry)
from vch_tpu_torch.probes import diag_blocked_microbench

H100_SMS = 132


@pytest.mark.parametrize("bb", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [17, 65, 129])
def test_the_micro_geometry_fits_one_block(n, bb):
    """One cluster of 16 CTAs (n >= 16), shared memory within a block's
    limit, the march's split of the same block, every row in one band;
    fitted to any residency of at least one cluster it stays as it is."""
    g = blocked_geometry(n, n, bb, H100_SMS, members=bb, kernel="micro")
    assert g.members == bb and g.cluster == 16
    assert g.smem_bytes <= BLOCKED_SMEM_LIMIT == 228_352
    assert g == blocked_geometry(n, n, bb, H100_SMS, members=bb)
    assert sum(rows for _, rows in g.bands) == n
    assert [start for start, _ in g.bands] == sorted(
        start for start, _ in g.bands)
    assert g.smem_bytes == 4 * 2 * g.kc * (bb * (g.rows_pad + g.m_pad) + 4)
    assert fitted_geometry(n, n, bb, H100_SMS, lambda geo: 1, members=bb,
                           kernel="micro") == g


def test_the_micro_cluster_at_the_probes_shape():
    """diag_blocked_microbench's default block: 8 members of 65 x 65 on 16
    CTAs, bands of 5 and 4 rows, a 32-row ring of 156,672 bytes."""
    g = blocked_geometry(65, 65, 8, H100_SMS, members=8, kernel="micro")
    assert (g.cluster, g.rows_max, g.rows_pad, g.m_pad, g.kc) == \
        (16, 5, 8, 68, 32)
    assert g.bands[0] == (0, 5) and g.bands[-1] == (61, 4)
    assert g.smem_bytes == 156_672
    assert g.units == 8 * 2 * 17 and g.passes == 1


@pytest.mark.parametrize("C", range(1, 17))
def test_the_micro_cluster_override(C):
    """Every cluster size 1-16 the card tests and chip_smoke.py sweep at
    n = 65 is a valid split of a block of 8 and of 1."""
    for bb in (8, 1):
        g = blocked_geometry(65, 65, bb, H100_SMS, cluster=C, members=bb,
                             kernel="micro")
        assert g.cluster == C and len(g.bands) == C
        assert g.smem_bytes <= BLOCKED_SMEM_LIMIT


def test_the_microbench_is_a_cluster_kernel_of_every_width():
    names = km._kernel_names("micro")
    assert sorted(names) == list(pk.MEMBER_BLOCKS)
    assert all("microbench" in v for v in names.values())
    assert km.CLUSTER_KERNELS["micro"][1] == "vch_micro_cluster_max_clusters"
    with pytest.raises(ValueError, match="members per cluster"):
        blocked_geometry(65, 65, 3, H100_SMS, members=3, kernel="micro")


def test_resident_clusters_asks_the_micro_kernel(monkeypatch):
    """`resident_clusters(..., kernel="micro")` calls the microbench
    kernel's own occupancy query with (members, segment, n, m, cluster,
    kc, smem)."""
    calls = []

    class Lib:
        @staticmethod
        def vch_micro_cluster_max_clusters(*args):
            calls.append(args)
            return 2

    monkeypatch.setattr(km._build, "load", lambda: Lib)
    g = blocked_geometry(65, 65, 8, H100_SMS, members=8, kernel="micro")
    try:
        # device -1: torch.cuda.device leaves the current device alone
        got = km.resident_clusters(-1, 65, 65, g.cluster, g.kc, g.smem_bytes,
                                   8, False, "micro")
    finally:
        km.resident_clusters.cache_clear()
    assert got == 2
    assert calls == [(8, 0, 65, 65, g.cluster, g.kc, g.smem_bytes)]


def test_a_block_the_card_cannot_hold_shrinks_to_one_cta():
    """With no cluster resident, the fit walks the cluster down to one
    CTA (launch_geometry then raises with the bytes on the card)."""
    g = fitted_geometry(65, 65, 8, H100_SMS, lambda geo: 0, members=8,
                        kernel="micro")
    assert g.cluster == 1


@pytest.mark.parametrize("n,bb", [(900, 8), (1800, 4), (3600, 2),
                                  (7200, 1)])
def test_a_block_too_large_for_shared_memory_raises(n, bb):
    with pytest.raises(ValueError, match="bytes of shared memory"):
        blocked_geometry(n, n, bb, H100_SMS, members=bb, kernel="micro")


def test_a_cluster_past_sixteen_or_n_raises():
    with pytest.raises(ValueError, match="cluster size"):
        blocked_geometry(65, 65, 8, H100_SMS, cluster=17, members=8,
                         kernel="micro")
    with pytest.raises(ValueError, match="cluster size"):
        blocked_geometry(9, 9, 1, H100_SMS, cluster=10, members=1,
                         kernel="micro")


@pytest.mark.parametrize("variant", pk.VARIANTS)
def test_the_microbench_and_its_oracle_run_plain_on_cpu_tensors(variant):
    """The cluster wrapper (with or without a cluster size) and the one-CTA
    oracle change nothing on the CPU: the plain version, no launch
    counted."""
    C, X = diag_blocked_microbench.inputs(8, 2, "cpu")
    km.reset_launches()
    ref = pk.blocked_microbench_plain(variant, C, X, 2, 3)
    for got in (pk.blocked_microbench(variant, C, X, 2, 3),
                pk.blocked_microbench(variant, C, X, 2, 3, cluster=5),
                pk._blocked_microbench_cta(variant, C, X, 2, 3)):
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    counts = km.launch_counts()
    assert counts["blocked_microbench"] == 0
    assert counts["_blocked_microbench_cta"] == 0


@pytest.mark.parametrize("fn", [pk.blocked_microbench,
                                pk._blocked_microbench_cta])
def test_bad_microbench_arguments_raise(fn):
    C, X = diag_blocked_microbench.inputs(8, 2, "cpu")
    for bad in (3, 16):
        with pytest.raises(ValueError, match="bb"):
            fn("stacked_mm", C, X.repeat(bad, 1)[:bad * 9], bad, 1)
    with pytest.raises(ValueError, match="k >= 1"):
        fn("gdot", C, X, 2, 0)
    with pytest.raises(ValueError, match=r"\(bb n, n\)"):
        fn("swap", C, X, 4, 1)
    with pytest.raises(ValueError, match=r"\(bb n, n\)"):
        fn("swap", C[:, :8], X, 2, 1)
    with pytest.raises(ValueError, match="variant"):
        fn("transpose", C, X, 2, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        fn("swap", C.to("meta"), X.to("meta"), 2, 1)
