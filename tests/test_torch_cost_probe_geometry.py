"""The launch geometry of the raw Schur solve's two cost probes on Hopper
(csrc/solve2d_cluster.cu `schur_probe_cluster_kernel`), their wrappers'
and their one-CTA oracles' plain path and their argument checks, on the
CPU.

`ops.solve_kernels.schur_nodots` and `schur_mmonly` run one member per
thread-block cluster on the cluster engine, so their split is
`ops.march.blocked_geometry` / `fitted_geometry` with one member and
kernel="schur_probe" (the raw Schur solve's split: the same bands, ring
and shared memory), fitted against the probes' own occupancy query, which
returns the clusters of whichever probe kernel holds fewer;
`solve_geometry(..., cluster=C)` forces C CTAs. The C entries recompute
the split from (n, m, cluster, kc) and refuse a launch whose numbers
differ, so these tests hold the kernels' split too. On CPU tensors the
wrappers and the oracles `_schur_nodots_cta`, `_schur_mmonly_cta` run the
plain versions and launch nothing; a bad shape raises on either route."""
from types import SimpleNamespace

import pytest
import torch

from vch_tpu_torch.ops import _build
from vch_tpu_torch.ops import march as km
from vch_tpu_torch.ops import solve_kernels as sk
from vch_tpu_torch.ops.march import (BLOCKED_SMEM_LIMIT, blocked_geometry,
                                     fitted_geometry)
from vch_tpu_torch.probes import diag_kernel_cost as probe

H100_SMS = 132
WHAT = "the raw Schur solve's cost probes"
WRAPPERS = {"nodots": (sk.schur_nodots, sk._schur_nodots_cta,
                       sk.schur_nodots_plain),
            "mmonly": (sk.schur_mmonly, sk._schur_mmonly_cta,
                       sk.schur_mmonly_plain)}


def _geometry(n, B, **kw):
    return blocked_geometry(n, n, B, H100_SMS, members=1,
                            kernel="schur_probe", **kw)


@pytest.fixture
def card(monkeypatch):
    """An H100's SM count and a stand-in for the probes' occupancy query:
    `card(resident)` makes resident_clusters answer resident(C) for a
    cluster of C CTAs and records each query's kernel."""
    asked = []

    def install(resident):
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda idx: SimpleNamespace(
                                multi_processor_count=H100_SMS))

        def query(idx, n, m, C, kc, smem, members, segment, kernel):
            asked.append(kernel)
            return resident(C)

        monkeypatch.setattr(km, "resident_clusters", query)
        return asked

    sk.solve_geometry.cache_clear()
    yield install
    sk.solve_geometry.cache_clear()


def test_the_probes_at_the_scripts_shape():
    """n = 65, B = 32 (diag_kernel_cost's default): 4 CTAs a member, 128 of
    the 132 SMs, bands of 17 and 16 rows, a 32-row ring of 23,552 bytes:
    the raw Schur solve's split at the same shape."""
    g = _geometry(65, 32)
    assert (g.members, g.cluster, g.rows_max, g.rows_pad, g.m_pad, g.kc) == \
        (1, 4, 17, 20, 68, 32)
    assert g.bands == ((0, 17), (17, 16), (33, 16), (49, 16))
    assert g.smem_bytes == 23_552 and 32 * g.cluster <= H100_SMS
    assert g == blocked_geometry(65, 65, 32, H100_SMS, members=1,
                                 kernel="raw_schur_solve")


def test_the_probes_at_the_scan_paths_shape():
    """n = 129, B = 128 (the scan path's batch): one CTA a member, the
    whole field its band, two passes of units, 68,608 bytes."""
    g = _geometry(129, 128)
    assert (g.cluster, g.bands, g.kc, g.passes, g.smem_bytes) == \
        (1, ((0, 129),), 32, 2, 68_608)


@pytest.mark.parametrize("n,B,resident,C", [
    (65, 32, {4: 33}, 4),             # every cluster of 4 resident
    (65, 32, {4: 30, 3: 44}, 3),      # 30 of 32: down one CTA
    (65, 1, {16: 7}, 16),             # one member on 16 CTAs
    (129, 128, {1: 132}, 1),
    (17, 4, {16: 8}, 16)])
def test_solve_geometry_fits_the_probes_own_residency(card, n, B, resident,
                                                      C):
    """`solve_geometry(..., "schur_probe")` is launch_geometry on the card's
    SM count, shrunk until the probes' own query holds every cluster at
    once; it asks no other kernel's query."""
    asked = card(lambda c: resident.get(c, 0))
    g = sk.solve_geometry(n, n, B, 0, "schur_probe")
    assert g.cluster == C and g.members == 1
    assert g == _geometry(n, B, cluster=C)
    assert asked and set(asked) == {"schur_probe"}


def test_a_card_that_holds_no_probe_cluster_raises(card):
    card(lambda c: 0)
    with pytest.raises(RuntimeError, match=f"{WHAT}: a cluster of 1 CTAs"):
        sk.solve_geometry(65, 65, 32, 0, "schur_probe")


@pytest.mark.parametrize("C", range(1, 17))
def test_the_probes_cluster_override(monkeypatch, C):
    """Every cluster size 1-16 the card tests and chip_smoke.py sweep at
    n = 65, B = 1: a valid split, taken without asking the card."""
    def no_card(*a):
        raise AssertionError("the override asked the card")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_card)
    monkeypatch.setattr(km, "resident_clusters", no_card)
    sk.solve_geometry.cache_clear()
    try:
        g = sk.solve_geometry(65, 65, 1, 0, "schur_probe", C)
    finally:
        sk.solve_geometry.cache_clear()
    assert g.cluster == C and len(g.bands) == C and g.members == 1
    assert sum(rows for _, rows in g.bands) == 65
    assert g.smem_bytes <= BLOCKED_SMEM_LIMIT
    assert g == _geometry(65, 1, cluster=C)


@pytest.mark.parametrize("n,C", [(65, 17), (65, 0), (9, 10)])
def test_a_probe_cluster_past_sixteen_or_n_raises(n, C):
    with pytest.raises(ValueError, match="cluster size"):
        sk.solve_geometry(n, n, 1, 0, "schur_probe", C)


def test_resident_clusters_asks_the_probes_query(monkeypatch):
    """`resident_clusters(..., kernel="schur_probe")` calls the probes'
    own occupancy query with (members, segment, n, m, cluster, kc, smem),
    not row 10's."""
    calls = []

    class Lib:
        @staticmethod
        def vch_schur_probe_cluster_max_clusters(*args):
            calls.append(args)
            return 5

        @staticmethod
        def vch_schur_raw_cluster_max_clusters(*args):
            raise AssertionError("asked the raw Schur solve's query")

    monkeypatch.setattr(km._build, "load", lambda: Lib)
    g = _geometry(65, 32)
    try:
        # device -1: torch.cuda.device leaves the current device alone
        got = km.resident_clusters(-1, 65, 65, g.cluster, g.kc, g.smem_bytes,
                                   1, False, "schur_probe")
    finally:
        km.resident_clusters.cache_clear()
    assert got == 5
    assert calls == [(1, 0, 65, 65, g.cluster, g.kc, g.smem_bytes)]
    assert km.CLUSTER_KERNELS["schur_probe"] == (
        {1: WHAT}, "vch_schur_probe_cluster_max_clusters")


@pytest.mark.parametrize("n,B,C", [(3600, 128, 1), (7200, 1, 16)])
def test_a_probe_ring_too_large_for_shared_memory_raises(n, B, C):
    """Past the ring's limit the geometry raises a ValueError that names the
    probes and the bytes a CTA would need; nothing falls back to the
    one-CTA kernel."""
    with pytest.raises(ValueError, match=(
            f"{WHAT} on an \\({n}, {n}\\) grid in clusters of {C} needs "
            f"[0-9]+ bytes of shared memory per CTA \\(at most "
            f"{BLOCKED_SMEM_LIMIT}\\)")):
        _geometry(n, B)


@pytest.mark.parametrize("members,B,match", [
    (1, 0, f"{WHAT} takes B % 1 == 0"),
    (8, 8, r"the cluster schur_probe is built for \(1,\) members")])
def test_a_bad_probe_batch_or_block_raises(members, B, match):
    with pytest.raises(ValueError, match=match):
        blocked_geometry(65, 65, B, H100_SMS, members=members,
                         kernel="schur_probe")


def test_a_probe_cluster_the_card_cannot_hold_shrinks_to_one_cta():
    g = fitted_geometry(65, 65, 32, H100_SMS, lambda geo: 0, members=1,
                        kernel="schur_probe")
    assert g.cluster == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(WRAPPERS))
def test_the_probes_and_their_oracles_run_plain_on_cpu_tensors(name, dtype):
    """The cluster wrapper (with or without a cluster size) and the one-CTA
    oracle change nothing on the CPU: the plain version, no launch
    counted."""
    wrapper, oracle, plain = WRAPPERS[name]
    args = probe.probe_args(8, 3, "cpu", dtype)
    km.reset_launches()
    ref = plain(*args, n_iter=2)
    for got in (wrapper(*args, n_iter=2), wrapper(*args, n_iter=2, cluster=5),
                oracle(*args, n_iter=2)):
        assert got.dtype == dtype and torch.equal(got, ref)
    counts = km.launch_counts()
    assert counts[wrapper.__name__] == counts[oracle.__name__] == 0
    assert not any(counts.values())


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_a_probe_of_zero_trips_returns_its_start(name):
    """nodots from x0 = 0, mmonly from v = rhs: zero trips leave them."""
    wrapper, oracle, _ = WRAPPERS[name]
    args = probe.probe_args(8, 2, "cpu")
    start = torch.zeros_like(args[8]) if name == "nodots" else args[8]
    for fn in (wrapper, oracle):
        assert torch.equal(fn(*args, n_iter=0), start)


@pytest.mark.parametrize("fn", [f for fs in WRAPPERS.values()
                                for f in fs[:2]])
def test_bad_probe_arguments_raise(fn):
    """On either route: rhs not (n, m) or (B, n, m), an operator or a field
    of another shape, a negative trip count; a device that is neither the
    CPU nor CUDA."""
    args = probe.probe_args(8, 2, "cpu")
    bad = lambda i, t: args[:i] + (t,) + args[i + 1:]
    with pytest.raises(ValueError, match="rhs must be"):
        fn(*bad(8, args[8].reshape(-1)), n_iter=1)
    with pytest.raises(ValueError, match=r"Lx has shape \(8, 8\)"):
        fn(*bad(0, args[0][:8, :8]), n_iter=1)
    with pytest.raises(ValueError, match=r"VyT has shape \(9, 8\)"):
        fn(*bad(5, args[5][:, :8]), n_iter=1)
    with pytest.raises(ValueError, match=r"f1 has shape \(9, 9\)"):
        fn(*bad(6, args[6][0]), n_iter=1)
    with pytest.raises(ValueError, match=r"f2 has shape \(1, 9, 9\)"):
        fn(*bad(7, args[7][:1]), n_iter=1)
    with pytest.raises(ValueError, match="n_iter must be >= 0"):
        fn(*args, n_iter=-1)
    meta = tuple(a.to("meta") if torch.is_tensor(a) else a for a in args)
    with pytest.raises(ValueError, match="unsupported device"):
        fn(*meta, n_iter=1)


def test_the_probes_build_as_their_oracles():
    """Both probe objects (the cluster kernels and the one-CTA oracles)
    compile with -fmad=false, as the raw Schur solve and its oracle; the
    raw adjoint oracle keeps nvcc's default contraction in the object
    without a variant; 43 objects in all (the while probe's own,
    while_fused.cu, with probes.cu's default contraction, the cluster
    march's and the cluster sweep's five bf16 forms each, and the cluster
    march's five fwd_mm forms)."""
    assert ("-DVCH_VARIANT=4", "-fmad=false") in _build.SOURCES["solve2d.cu"]
    assert ("-DVCH_VARIANT=4", "-fmad=false") in \
        _build.SOURCES["solve2d_cluster.cu"]
    assert ("-DVCH_VARIANT=1", "-fmad=false") in _build.SOURCES["solve2d.cu"]
    assert () in _build.SOURCES["solve2d.cu"]
    assert sum(len(objs) for objs in _build.SOURCES.values()) == 43
    assert _build.SOURCES["while_fused.cu"] == _build.SOURCES["probes.cu"]
    assert sk._CLUSTER_SOLVES["schur_nodots"][0] == \
        sk._CLUSTER_SOLVES["schur_mmonly"][0] == "schur_probe"
    names = {fn.__name__ for fn in km.WRAPPERS}
    assert {"schur_nodots", "schur_mmonly", "_schur_nodots_cta",
            "_schur_mmonly_cta", "bicgstab_schur"} <= names
