"""The launch geometry of the chain probes' Hopper kernels
(csrc/chain_cluster.cu), on the CPU.

The float32 chain runs K members per thread-block cluster on the cluster
engine's left product, so its split is `ops.march.blocked_geometry` /
`fitted_geometry` with kernel="chain" (the march's split: the same bands,
ring and shared memory), fitted against the chain kernel's own occupancy
query; the C entry recomputes the split from (n, cluster, kc) and refuses a
launch whose numbers differ, so these tests hold the kernel's split too.
The bf16 chain holds two buffers of K members' bf16 x in one CTA's shared
memory. On CPU tensors every chain wrapper, the one-CTA oracles included,
runs its plain version and launches nothing."""
import numpy as np
import pytest
import torch

from vch_tpu_torch.ops import march as km
from vch_tpu_torch.ops import probe_kernels as pk
from vch_tpu_torch.ops.march import (BLOCKED_SMEM_LIMIT, blocked_geometry,
                                     fitted_geometry)
from vch_tpu_torch.probes import diag_interleave

H100_SMS = 132


def _resident(geo):
    """A stand-in occupancy: one cluster for every two clusters' worth of
    SMs, so that large batches must shrink their clusters."""
    return max(0, H100_SMS // (2 * geo.cluster))


@pytest.mark.parametrize("B", [1, 8, 32, 512])
@pytest.mark.parametrize("K", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [9, 17, 65, 129, 257])
def test_the_chain_geometry_fits_a_block(n, K, B):
    """Shared memory within a block's limit, at most 16 CTAs and at most n,
    the march's split of the same block; fitted to a residency, every
    cluster resident at once or the cluster down to 1; a batch that is not
    whole clusters of K raises."""
    if B % K:
        with pytest.raises(ValueError, match=f"B % {K} == 0"):
            blocked_geometry(n, n, B, H100_SMS, members=K, kernel="chain")
        return
    g = blocked_geometry(n, n, B, H100_SMS, members=K, kernel="chain")
    assert BLOCKED_SMEM_LIMIT == 228_352
    assert g.smem_bytes <= BLOCKED_SMEM_LIMIT
    assert 1 <= g.cluster <= min(16, n) and g.members == K
    assert g == blocked_geometry(n, n, B, H100_SMS, members=K)
    assert sum(rows for _, rows in g.bands) == n
    f = fitted_geometry(n, n, B, H100_SMS, _resident, members=K,
                        kernel="chain")
    assert f.smem_bytes <= BLOCKED_SMEM_LIMIT and f.cluster <= g.cluster
    assert _resident(f) >= B // K or f.cluster == 1


@pytest.mark.parametrize("n,B,K,C", [(65, 1, 1, 16), (65, 32, 8, 16),
                                     (65, 32, 4, 16), (65, 32, 2, 8),
                                     (65, 32, 1, 4), (65, 8, 8, 16)])
def test_the_chain_cluster_at_the_probes_shapes(n, B, K, C):
    """diag_march_sol's chain (one member) on 16 CTAs, diag_interleave's
    B = 32 at each width on the SM rule: B / K clusters of C with
    (B / K) C <= 132."""
    g = blocked_geometry(n, n, B, H100_SMS, members=K, kernel="chain")
    assert g.cluster == C and (B // K) * C <= H100_SMS


def test_the_chain_is_a_cluster_kernel_of_every_width():
    names = km._kernel_names("chain")
    assert sorted(names) == list(pk.MEMBER_BLOCKS)
    assert all("chain" in v for v in names.values())
    assert km.CLUSTER_KERNELS["chain"][1] == "vch_chain_cluster_max_clusters"
    with pytest.raises(ValueError, match="members per cluster"):
        blocked_geometry(65, 65, 48, H100_SMS, members=3, kernel="chain")


def test_resident_clusters_asks_the_chain_kernel(monkeypatch):
    """`resident_clusters(..., kernel="chain")` calls the chain kernel's own
    occupancy query with (members, segment, n, m, cluster, kc, smem)."""
    calls = []

    class Lib:
        @staticmethod
        def vch_chain_cluster_max_clusters(*args):
            calls.append(args)
            return 7

    monkeypatch.setattr(km._build, "load", lambda: Lib)
    g = blocked_geometry(65, 65, 32, H100_SMS, members=8, kernel="chain")
    try:
        # device -1: torch.cuda.device leaves the current device alone
        got = km.resident_clusters(-1, 65, 65, g.cluster, g.kc, g.smem_bytes,
                                   8, False, "chain")
    finally:
        km.resident_clusters.cache_clear()
    assert got == 7
    assert calls == [(8, 0, 65, 65, g.cluster, g.kc, g.smem_bytes)]


@pytest.mark.parametrize("K", [1, 2, 4, 8])
def test_the_bf16_chain_shared_memory(K):
    """Two buffers of K members' (80, 88) bf16 tiles at n = 65: 225,280
    bytes at K = 8, within a block's 232,448; n = 80 is the largest n it
    takes, n = 64 needs no padding beyond the row's 8."""
    assert pk.bf16_chain_smem_bytes(65, K) == 2 * K * 80 * 88 * 2
    assert pk.bf16_chain_smem_bytes(80, K) == pk.bf16_chain_smem_bytes(65, K)
    assert pk.bf16_chain_smem_bytes(64, K) == 2 * K * 64 * 72 * 2
    assert pk.bf16_chain_smem_bytes(pk.BF16_CHAIN_MAX_N, K) \
        <= pk.SMEM_PER_BLOCK
    assert pk.bf16_chain_smem_bytes(65, 8) == 225_280
    assert pk.SMEM_PER_BLOCK == 232_448 and pk.BF16_CHAIN_MAX_N == 80


def test_the_chain_oracles_run_the_plain_versions_on_cpu_tensors():
    """The one-CTA oracles and a cluster size given to the float32 chain
    change nothing on the CPU: plain versions, no launch counted."""
    A, X = diag_interleave.inputs(8, 8, "cpu")
    km.reset_launches()
    assert torch.equal(pk._matmul_chain_cta(A, X, 4, 5),
                       pk.matmul_chain_plain(A, X, 4, 5))
    assert torch.equal(pk._matmul_chain_bf16_cta(A, X, 2, 5),
                       pk.matmul_chain_bf16_plain(A, X, 2, 5))
    assert torch.equal(pk.matmul_chain(A, X, 8, 5, cluster=3),
                       pk.matmul_chain_plain(A, X, 8, 5))
    counts = km.launch_counts()
    names = ("matmul_chain", "_matmul_chain_cta", "matmul_chain_bf16",
             "_matmul_chain_bf16_cta")
    assert all(counts[k] == 0 for k in names), counts
    with pytest.raises(ValueError, match="split"):
        pk._matmul_chain_cta(A, X[:6], 4, 1)
    with pytest.raises(ValueError, match="L >= 1"):
        pk._matmul_chain_bf16_cta(A, X, 2, 0)


def test_the_bf16_plain_chain_is_bf16_operands_in_float32():
    """Each link of the plain bf16 chain rounds both operands to bf16 and
    multiplies in the tensors' dtype: the same as float64 products of the
    rounded operands, rounded to float32, to float32's precision."""
    A, X = diag_interleave.inputs(8, 2, "cpu")
    out = pk.matmul_chain_bf16_plain(A, X, 2, 1)
    rb = lambda t: t.to(torch.bfloat16).double()
    ref = (rb(A) @ rb(X)).float()
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-6)
