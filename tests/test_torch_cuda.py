"""The CUDA kernels of vch_tpu_torch against their plain PyTorch versions,
and the wrappers' routing and input checks.

This file imports neither JAX nor vch_tpu, so it also runs on a machine
with a card and no JAX: `python -m pytest --noconftest tests/test_torch_cuda.py`.
Tests that need the card are marked `cuda` and skip without one.

Tolerances on the card: phi 1e-5 absolute, and Newton totals within one
solve per member (float32 sums in another order: a step that converges
right at the tolerance may take one more iteration); r 2e-3 relative, the
float32 noise floor of the adjoint on small grids (chip_smoke.py records
it at larger ones). The member-blocked kernels compute each member with the
same arithmetic as the per-member kernels, so those two agree exactly, as
do the cluster marches (whole, blocked, segment), sweeps (whole, blocked,
segment), solves (spectral and raw Schur, spectral and raw adjoint) and the raw
Schur solve's two cost probes and their one-CTA oracles at every batch and
cluster size; so are the march's bf16 forms (fused_solve_precision
"bf16x3", "default") among themselves, each within 1e-5 of its plain
version at the same mode, and the sweep's bf16 forms
(adjoint_solve_precision "bf16x3"), each within 2e-3 relative of its plain
version, and the march's fwd_mm forms (fwd_mm "bf16x3": every product
on mma.sync) among themselves, each no farther from the plain float64
march at its modes than twice the plain float32 ones on the card and on
the CPU (+1e-6), a one-pass control farther. The one-member march's
per-member flag: an active member bit for bit
the launch without it, an inactive one nsolve 0 and first_bad -1.
The 1D march: phi 1e-5 absolute on a
short march, Newton counts and first_bad equal, and bit-equal results for
every members-per-cluster grouping, cluster size and batch. The operator applies: no farther from float64
than twice the plain float32 version plus 1e-5 on smooth fields, two
launches bit-equal and each member of a batch bit-equal to its one-member
launch (the solve kernels' own gates are in chip_smoke.py).
The cost probes: the float32 chain and the blocked primitives no farther
from float64 than twice the plain float32 version plus 1e-5, every
interleave width bit-equal, the cluster chain and the cluster microbench
bit-equal to their one-CTA oracles at every cluster size; the bf16 chain against its bf16-emulated
plain version at BF16_CHAIN_TOL and bit-equal to the wmma chain; the while
probe with its script's gates, bit-equal to its one-CTA oracle (phi and trip
counts, NaN input too) and within 1e-6 relative of its plain version.
"""
import numpy as np
import pytest
import torch

from vch_tpu_torch.config import DELTA_SEP, ForwardSolverConfig2D
from vch_tpu_torch.models.adjoint2d import AdjointSolver2D
from vch_tpu_torch.models.forward2d import ForwardSolver2D
from vch_tpu_torch.ops import march as km
from vch_tpu_torch.ops.probe_kernels import BF16_CHAIN_TOL
from vch_tpu_torch.ops.potential import init_phi_random_2d

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (python chip_smoke.py)")
    return torch.device("cuda")


def _problem(device, n=17, B=3, T=0.05, seed=0, m=None):
    m = n if m is None else m
    cfg = ForwardSolverConfig2D(Nx=n - 1, Ny=m - 1, T=T, dtype="float32",
                                newton_tol=2e-4)
    fwd = ForwardSolver2D(cfg, device=device)
    adj = AdjointSolver2D(cfg, device=device)
    rng = np.random.default_rng(seed)
    phi0 = np.stack([init_phi_random_2d(n - 1, m - 1, DELTA_SEP, seed=42 + i)
                     for i in range(B)])
    u = 0.1 * rng.standard_normal((B, fwd.M + 1, n, m))
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return fwd, adj, f32(phi0), f32(u), f32


def _march_args(fwd, phi0, u):
    return (fwd.dts, phi0, u, fwd.Lx, fwd.LyT, fwd.Vx_inv, fwd.Vy_inv_T,
            fwd.Vx, fwd.VyT, fwd.lam, fwd.wts)


_KW = dict(tau=0.05, c1=0.75, c2=1.0, kappa=1e-4, gamma=10.0,
           delta_sep=DELTA_SEP, area=1.0, newton_tol=2e-4, newton_rtol=1e-5,
           newton_max_iter=500, n_trips=3, stagnation_exit=True)


def test_cpu_tensors_run_the_plain_versions():
    fwd, adj, phi0, u, f32 = _problem(torch.device("cpu"), B=2)
    before = (km.march_fused_2d.launches, km.adjoint_fused_2d.launches)
    hist, ns, bad = fwd.march_fused_batch(u, phi0)
    r = adj.adjoint_fused_batch(hist, f32([1.0, 2.0]), f32([3.0, 4.0]),
                                torch.zeros_like(hist), torch.zeros_like(phi0))
    assert (km.march_fused_2d.launches, km.adjoint_fused_2d.launches) == before
    ref = km.march_fused_2d_plain(*_march_args(fwd, phi0, u),
                                  **dict(_KW, solve_prec="bf16x3"))
    assert torch.equal(hist, ref[0]) and torch.equal(ns, ref[1])
    assert r.shape == hist.shape and bool(torch.isfinite(r).all())


def _segment_args(fwd, phi0, u, K, start=0, carry=None):
    """A K-step segment from step `start`: the carry from phi0 (w = 0, mu
    from phi0, m0 its mass) unless given as (mu, w, m0)."""
    if carry is None:
        w = torch.zeros_like(phi0)
        carry = (fwd.initialize_mu(phi0, w), w,
                 torch.sum(fwd.wts * phi0, dim=(-2, -1)))
    mu, w, m0 = carry
    return (fwd.dts[start:start + K], phi0, mu, w, m0,
            u[:, start:start + K + 1].contiguous()) + fwd._ops()


def test_segment_wrappers_run_the_plain_version_on_cpu_tensors():
    fwd, _, phi0, u, _ = _problem(torch.device("cpu"), B=2, T=0.02)
    sargs = _segment_args(fwd, phi0, u, fwd.M)
    before = (km.march_fused_2d_segment.launches,
              km._march_fused_2d_segment_cta.launches)
    ref = km.march_fused_2d_segment_plain(*sargs, **_KW)
    for fn in (km.march_fused_2d_segment, km._march_fused_2d_segment_cta):
        for a, b in zip(fn(*sargs, **_KW), ref):
            assert torch.equal(a, b)
    assert (km.march_fused_2d_segment.launches,
            km._march_fused_2d_segment_cta.launches) == before
    assert "_march_fused_2d_segment_cta" in km.launch_counts()


def test_wrappers_reject_other_devices():
    fwd, adj, phi0, u, _ = _problem(torch.device("cpu"), B=1)
    meta = lambda t: t.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        km.march_fused_2d(*[meta(t) for t in _march_args(fwd, phi0, u)],
                          **_KW)


@pytest.mark.cuda
@pytest.mark.parametrize("n,B", [(65, 1), (65, 8), (65, 128), (129, 1),
                                 (129, 8), (129, 128)])
def test_one_member_march_equals_the_one_cta_oracle(cuda, n, B):
    """The whole march (one member per thread-block cluster) gives the
    one-CTA kernel's history, Newton counts and first_bad bit for bit."""
    fwd, _, phi0, u, _ = _problem(cuda, n=n, B=B, T=0.03)
    args = _march_args(fwd, phi0, u)
    before = (km.march_fused_2d.launches, km._march_fused_2d_cta.launches)
    kc = km.march_fused_2d(*args, **_KW)
    ko = km._march_fused_2d_cta(*args, **_KW)
    torch.cuda.synchronize()
    assert (km.march_fused_2d.launches,
            km._march_fused_2d_cta.launches) == (before[0] + 1, before[1] + 1)
    for a, b in zip(kc, ko):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_one_member_march_bits_do_not_depend_on_the_cluster_size(
        cuda, monkeypatch):
    fwd, _, phi0, u, _ = _problem(cuda, n=33, m=29, B=2, T=0.03)
    args = _march_args(fwd, phi0, u)
    ref = km._march_fused_2d_cta(*args, **_KW)
    for C in range(1, 17):
        _segment_geometry(monkeypatch, lambda n, m, B, sms, members:
                          km.blocked_geometry(n, m, B, sms, cluster=C,
                                              members=members))
        out = km.march_fused_2d(*args, **_KW)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            assert torch.equal(a, b), C


@pytest.mark.cuda
@pytest.mark.parametrize("n,flags", [(65, [1, 0, 1, 0]), (129, [1] * 128)])
def test_one_member_march_active_flag(cuda, n, flags):
    """Row 1 with the per-member flag (chip_smoke.py phase 14c's shapes):
    an active member bit for bit the launch without a flag and the one-CTA
    oracle; an inactive one nsolve 0 and first_bad -1; one launch."""
    B = len(flags)
    fwd, _, phi0, u, _ = _problem(cuda, n=n, B=B, T=0.03)
    args = _march_args(fwd, phi0, u)
    ref = km.march_fused_2d(*args, **_KW)
    oracle = km._march_fused_2d_cta(*args, **_KW)
    active = torch.tensor(flags, dtype=torch.int32, device=cuda)
    before = km.march_fused_2d.launches
    out = km.march_fused_2d(*args, active=active, **_KW)
    torch.cuda.synchronize()
    assert km.march_fused_2d.launches == before + 1
    for b, on in enumerate(flags):
        if on:
            for a, r, o in zip(out, ref, oracle):
                assert torch.equal(a[b], r[b]) and torch.equal(a[b], o[b])
        else:
            assert int(out[1][b]) == 0 and int(out[2][b]) == -1


@pytest.mark.cuda
def test_one_member_march_flag_is_refused_elsewhere(cuda):
    """The blocked, segment and one-CTA marches raise when given the flag,
    as does a flag of another type, shape or device; nothing launches."""
    fwd, _, phi0, u, _ = _problem(cuda, n=33, B=8, T=0.03)
    args = _march_args(fwd, phi0, u)
    act = torch.ones(8, dtype=torch.int32, device=cuda)
    before = km.launch_counts()
    with pytest.raises(ValueError, match="active"):
        km.march_fused_2d_blocked(*args, block_b=8, active=act, **_KW)
    with pytest.raises(ValueError, match="active"):
        km._march_fused_2d_cta(*args, active=act, **_KW)
    seg = (fwd.dts[:2], phi0, phi0, phi0, phi0.sum((1, 2)), u[:, :3]) \
        + tuple(args[3:])
    for fn in (km.march_fused_2d_segment, km._march_fused_2d_segment_cta):
        with pytest.raises(ValueError, match="active"):
            fn(*seg, active=act, **_KW)
    for bad in (act.float(), act[:7], act.cpu()):
        with pytest.raises(ValueError, match="active"):
            km.march_fused_2d(*args, active=bad, **_KW)
    assert km.launch_counts() == before


@pytest.mark.cuda
def test_march_kernel_matches_plain(cuda):
    fwd, _, phi0, u, _ = _problem(cuda, n=33, B=4, T=0.1)
    args = _march_args(fwd, phi0, u)
    before = km.march_fused_2d.launches
    kh, kns, kbad = km.march_fused_2d(*args, **_KW)
    assert km.march_fused_2d.launches == before + 1
    ph, pns, pbad = km.march_fused_2d_plain(*args, **_KW)
    torch.cuda.synchronize()
    assert (kh - ph).abs().max().item() <= 1e-5
    assert torch.equal(kh[:, 0], phi0)
    assert torch.equal(kbad, pbad) and (kbad == -1).all()
    assert (kns - pns).abs().max().item() <= 1


@pytest.mark.cuda
def test_march_kernel_sanitizer_flags_nonfinite_member(cuda):
    fwd, _, phi0, u, _ = _problem(cuda, B=3)
    phi0[1, 3, 3] = float("nan")
    kw = dict(_KW, newton_max_iter=3)
    _, _, kbad = km.march_fused_2d(*_march_args(fwd, phi0, u), **kw)
    _, _, pbad = km.march_fused_2d_plain(*_march_args(fwd, phi0, u), **kw)
    assert kbad.tolist() == [-1, 0, -1] == pbad.tolist()


@pytest.mark.cuda
def test_adjoint_kernel_matches_plain(cuda):
    fwd, adj, phi0, u, f32 = _problem(cuda, n=33, B=3, T=0.1)
    hist, _, _ = fwd.march_fused_batch(u, phi0)
    rng = np.random.default_rng(3)
    phiQ = f32(0.3 * rng.standard_normal(tuple(hist.shape)))
    phiT = f32(0.7 * rng.standard_normal(tuple(phi0.shape)))
    b1, b2 = f32([5.0, 0.3, 1.0]), f32([10.0, 13.0, 2.0])
    before = km.adjoint_fused_2d.launches
    kr = adj.adjoint_fused_batch(hist, b1, b2, phiQ, phiT)
    assert km.adjoint_fused_2d.launches == before + 1
    adj.entries = km.PLAIN
    pr = adj.adjoint_fused_batch(hist, b1, b2, phiQ, phiT)
    torch.cuda.synchronize()
    assert (kr[:, -1] == 0).all()
    rel = (kr - pr).abs().max().item() / pr.abs().max().item()
    assert rel <= 2e-3, rel


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda):
    fwd, _, phi0, u, _ = _problem(cuda, B=2)
    args = list(_march_args(fwd, phi0, u))
    with pytest.raises(TypeError, match="float32"):
        km.march_fused_2d(*[a.double() for a in args], **_KW)
    bad_u = args[:]
    bad_u[2] = u.transpose(-1, -2)
    with pytest.raises(ValueError, match="contiguous"):
        km.march_fused_2d(*bad_u, **_KW)
    bad_shape = args[:]
    bad_shape[2] = u[:, :-1].contiguous()
    with pytest.raises(ValueError, match="shape"):
        km.march_fused_2d(*bad_shape, **_KW)
    bad_dev = args[:]
    bad_dev[3] = args[3].cpu()
    with pytest.raises(ValueError, match="expected"):
        km.march_fused_2d(*bad_dev, **_KW)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 16, 64])
@pytest.mark.parametrize("n,m", [(33, 29), (65, 65), (97, 97)])
def test_blocked_kernels_equal_the_per_member_kernels(cuda, n, m, B):
    """The blocked march (eight members on a thread-block cluster) gives
    each member the history, Newton count and first_bad of the one-member
    march bit for bit; so does the blocked sweep."""
    fwd, adj, phi0, u, f32 = _problem(cuda, n=n, m=m, B=B,
                                      T=0.05 if n < 97 else 0.02)
    args = _march_args(fwd, phi0, u)
    before = km.march_fused_2d_blocked.launches
    bh, bns, bbad = km.march_fused_2d_blocked(*args, block_b=8, **_KW)
    assert km.march_fused_2d_blocked.launches == before + 1
    kh, kns, kbad = km.march_fused_2d(*args, **_KW)
    torch.cuda.synchronize()
    assert torch.equal(bh, kh) and torch.equal(bns, kns)
    assert torch.equal(bbad, kbad)
    b1 = f32(np.linspace(0.3, 5.0, B))
    b2 = f32(np.linspace(13.0, 10.0, B))
    phiT = 0.1 * phi0
    aargs = (adj.dts, kh, torch.zeros_like(kh), phiT, b1, b2) + adj._ops()
    br = km.adjoint_fused_2d_blocked(*aargs, block_b=8, **adj._kw())
    kr = km.adjoint_fused_2d(*aargs, **adj._kw())
    torch.cuda.synchronize()
    assert torch.equal(br, kr)


# the bf16 forms of the cluster march (fused_solve_precision "bf16x3" and
# "default"): each against its plain version at the same mode
_BF16_FORMS = {"one_member": dict(n=33, m=33, B=4),
               "blocked_8": dict(n=33, m=29, B=16, block_b=8),
               "blocked_4": dict(n=33, m=29, B=8, block_b=4),
               "blocked_2": dict(n=33, m=29, B=8, block_b=2),
               "segment": dict(n=65, m=65, B=2)}


def _bf16_march(fwd, phi0, u, form, kw, plain=False):
    """A form's kernel (or plain version) result at kw's solve_prec."""
    args = _march_args(fwd, phi0, u)
    if form.startswith("blocked"):
        fn = (km.march_fused_2d_blocked_plain if plain
              else km.march_fused_2d_blocked)
        return fn(*args, block_b=_BF16_FORMS[form]["block_b"], **kw)
    if form == "segment":
        fn = (km.march_fused_2d_segment_plain if plain
              else km.march_fused_2d_segment)
        return fn(*_segment_args(fwd, phi0, u, fwd.M), **kw)
    return (km.march_fused_2d_plain if plain else km.march_fused_2d)(*args,
                                                                    **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16x3", "default"])
@pytest.mark.parametrize("form", list(_BF16_FORMS))
def test_bf16_march_matches_plain(cuda, form, mode):
    """The bf16 forms (apply_S on mma.sync) against their plain versions at
    the same mode: phi within 1e-5, Newton solves within one a member,
    first_bad equal; one launch of the bf16 form beside the float32 one,
    whose bits it does not give."""
    shape = _BF16_FORMS[form]
    fwd, _, phi0, u, _ = _problem(cuda, n=shape["n"], m=shape["m"],
                                  B=shape["B"], T=0.05)
    kw = dict(_KW, solve_prec=mode)
    before = (km.launch_counts(), km.bf16_launch_counts())
    kern = _bf16_march(fwd, phi0, u, form, kw)
    f32 = _bf16_march(fwd, phi0, u, form, _KW)
    plain = _bf16_march(fwd, phi0, u, form, kw, plain=True)
    torch.cuda.synchronize()
    after = (km.launch_counts(), km.bf16_launch_counts())
    assert [sum(a.values()) - sum(b.values())
            for a, b in zip(after, before)] == [2, 1]
    phi_k, phi_p = (kern[0], plain[0])
    assert (phi_k - phi_p).abs().max().item() <= 1e-5
    ns_k, ns_p, bad_k, bad_p = kern[-2], plain[-2], kern[-1], plain[-1]
    assert (ns_k - ns_p).abs().max().item() <= 1
    assert torch.equal(bad_k, bad_p) and (bad_k == -1).all()
    assert not torch.equal(phi_k, f32[0])


@pytest.mark.cuda
@pytest.mark.parametrize("field,delta", [("smem_bytes", 16), ("kc", -4)])
def test_bf16_c_entry_refuses_a_geometry_not_its_own(cuda, monkeypatch,
                                                     field, delta):
    """The bf16 march recomputes its staging from (n, m, cluster, kc,
    passes) and refuses shared-memory bytes other than its own."""
    fwd, _, phi0, u, _ = _problem(cuda, n=33, m=29, B=8, T=0.02)

    def bad(n, m, B, sms):
        g = km.blocked_geometry(n, m, B, sms, solve_passes=3)
        return g._replace(**{field: getattr(g, field) + delta})
    _with_geometry(monkeypatch, bad)
    with pytest.raises(RuntimeError, match="launch failed"):
        km.march_fused_2d_blocked(*_march_args(fwd, phi0, u),
                                  **dict(_KW, solve_prec="bf16x3"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16x3", "default"])
def test_bf16_blocked_march_equals_the_one_member_march(cuda, mode):
    """The bf16 forms sum each product in the same k-tile order whatever
    the block: the blocked march (8, 4, 2 members a cluster) gives each
    member the one-member bf16 march's history, Newton count and first_bad
    bit for bit."""
    fwd, _, phi0, u, _ = _problem(cuda, n=33, m=29, B=16, T=0.05)
    args = _march_args(fwd, phi0, u)
    kw = dict(_KW, solve_prec=mode)
    ref = km.march_fused_2d(*args, **kw)
    for bb in (8, 4, 2):
        out = km.march_fused_2d_blocked(*args, block_b=bb, **kw)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            assert torch.equal(a, b), bb


@pytest.mark.cuda
def test_bf16_march_bits_do_not_depend_on_the_cluster_size(cuda,
                                                          monkeypatch):
    fwd, _, phi0, u, _ = _problem(cuda, n=33, m=29, B=2, T=0.03)
    args = _march_args(fwd, phi0, u)
    kw = dict(_KW, solve_prec="bf16x3")
    ref = km.march_fused_2d(*args, **kw)
    for C in range(1, 17):
        _segment_geometry(monkeypatch, lambda n, m, B, sms, members:
                          km.blocked_geometry(n, m, B, sms, cluster=C,
                                              members=members,
                                              solve_passes=3))
        out = km.march_fused_2d(*args, **kw)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            assert torch.equal(a, b), C


# the fwd_mm forms of the cluster march (fwd_mm "bf16x3": every product of
# the march on mma.sync, apply_S at fused_solve_precision "bf16x3" or
# "default"): each against the plain float64 march at the same modes
_FWD16_FORMS = {"one_member": dict(n=33, m=33, B=4),
                "blocked_8": dict(n=33, m=29, B=16, block_b=8),
                "blocked_4": dict(n=33, m=29, B=8, block_b=4),
                "blocked_2": dict(n=33, m=29, B=8, block_b=2),
                "segment": dict(n=33, m=33, B=4)}


def _fwd16_case(cuda, form, T=0.04):
    shape = _FWD16_FORMS[form]
    fwd, _, phi0, u, _ = _problem(cuda, n=shape["n"], m=shape["m"],
                                  B=shape["B"], T=T)
    return fwd, phi0, u


def _fwd16_f64_distances(fwd, phi0, u, form, kw, kern):
    """(the kernel's max|dphi| from the plain float64 march at kw's modes,
    the farther of the plain float32 marches' on the card and on the
    CPU): chip_smoke's phase 2r gate holds the first within twice the
    second."""
    f64 = lambda t: t.double()
    plain64 = _fwd16_plain(form, [f64(a) for a in _fwd16_args(fwd, phi0, u,
                                                                form)], kw)
    plains = [_fwd16_plain(form, _fwd16_args(fwd, phi0, u, form), kw),
              _fwd16_plain(form, [a.cpu() for a in _fwd16_args(
                  fwd, phi0, u, form)], kw)]
    dist = lambda out: (out[0].double().to(plain64[0].device)
                        - plain64[0]).abs().max().item()
    return dist(kern), max(dist(p) for p in plains)


def _fwd16_args(fwd, phi0, u, form):
    if form == "segment":
        return list(_segment_args(fwd, phi0, u, fwd.M))
    return list(_march_args(fwd, phi0, u))


def _fwd16_plain(form, args, kw):
    if form.startswith("blocked"):
        return km.march_fused_2d_blocked_plain(
            *args, block_b=_FWD16_FORMS[form]["block_b"], **kw)
    if form == "segment":
        return km.march_fused_2d_segment_plain(*args, **kw)
    return km.march_fused_2d_plain(*args, **kw)


def _fwd16_march(fwd, phi0, u, form, kw):
    args = _fwd16_args(fwd, phi0, u, form)
    if form.startswith("blocked"):
        return km.march_fused_2d_blocked(
            *args, block_b=_FWD16_FORMS[form]["block_b"], **kw)
    if form == "segment":
        return km.march_fused_2d_segment(*args, **kw)
    return km.march_fused_2d(*args, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("solve_prec", ["bf16x3", "default"])
@pytest.mark.parametrize("form", list(_FWD16_FORMS))
def test_fwd_mm_march_matches_plain(cuda, form, solve_prec):
    """The fwd_mm forms at fwd_mm "bf16x3": no farther from the plain
    float64 march at the same modes than twice the farther plain float32
    one (+1e-6; chip_smoke's phase 2r gate); first_bad -1; one launch of
    the fwd_mm form (counted in bf16_launches and fwd16_launches), whose
    bits are not the bf16 form's (fwd_mm "highest")."""
    fwd, phi0, u = _fwd16_case(cuda, form)
    kw = dict(_KW, solve_prec=solve_prec, fwd_mm="bf16x3")
    counts = lambda: (sum(km.launch_counts().values()),
                      sum(km.bf16_launch_counts().values()),
                      sum(km.fwd16_launch_counts().values()))
    before = counts()
    kern = _fwd16_march(fwd, phi0, u, form, kw)
    bf16 = _fwd16_march(fwd, phi0, u, form, dict(kw, fwd_mm="highest"))
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [2, 2, 1]
    assert bool(torch.isfinite(kern[0]).all()) and (kern[-1] == -1).all()
    assert not torch.equal(kern[0], bf16[0])
    d_kern, d_plain = _fwd16_f64_distances(fwd, phi0, u, form, kw, kern)
    assert d_kern <= 2 * d_plain + 1e-6, (d_kern, d_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["one_member", "blocked_8", "segment"])
def test_fwd_mm_gate_fails_a_one_pass_march(cuda, monkeypatch, form):
    """A control of test_fwd_mm_march_matches_plain's gate (and of
    chip_smoke's phase 2r): the fwd_mm form made to run the march's other
    products at one pass (no fwd_mm selects it; apply_S stays at
    "bf16x3"'s three) lies farther from the float64 march than twice the
    farther plain float32 fwd_mm march, where the three-pass form does
    not."""
    fwd, phi0, u = _fwd16_case(cuda, form)
    kw = dict(_KW, solve_prec="bf16x3", fwd_mm="bf16x3")
    three = _fwd16_march(fwd, phi0, u, form, kw)
    d_three, d_plain = _fwd16_f64_distances(fwd, phi0, u, form, kw, three)
    monkeypatch.setattr(km, "fwd_passes",
                        lambda mode: 1 if mode == "bf16x3" else 0)
    before = sum(km.fwd16_launch_counts().values())
    one = _fwd16_march(fwd, phi0, u, form, kw)
    torch.cuda.synchronize()
    assert sum(km.fwd16_launch_counts().values()) == before + 1
    assert bool(torch.isfinite(one[0]).all())
    assert not torch.equal(one[0], three[0])
    monkeypatch.undo()
    d_one, _ = _fwd16_f64_distances(fwd, phi0, u, form, kw, one)
    assert d_three <= 2 * d_plain + 1e-6, (d_three, d_plain)
    assert d_one > 2 * d_plain + 1e-6, (d_one, d_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("solve_prec", ["bf16x3", "default"])
def test_fwd_mm_blocked_march_equals_the_one_member_march(cuda, solve_prec):
    """The fwd_mm forms sum each product in the same k-tile order whatever
    the block: the blocked march (8, 4, 2 members a cluster) gives each
    member the one-member fwd_mm march's history, Newton count and
    first_bad bit for bit."""
    fwd, _, phi0, u, _ = _problem(cuda, n=33, m=29, B=16, T=0.04)
    args = _march_args(fwd, phi0, u)
    kw = dict(_KW, solve_prec=solve_prec, fwd_mm="bf16x3")
    ref = km.march_fused_2d(*args, **kw)
    for bb in (8, 4, 2):
        out = km.march_fused_2d_blocked(*args, block_b=bb, **kw)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            assert torch.equal(a, b), bb


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["one_member", "segment"])
def test_fwd_mm_march_bits_do_not_depend_on_the_cluster_size(cuda,
                                                             monkeypatch,
                                                             form):
    fwd, _, phi0, u, _ = _problem(cuda, n=33, m=29, B=2, T=0.03)
    kw = dict(_KW, solve_prec="default", fwd_mm="bf16x3")
    args = (_segment_args(fwd, phi0, u, fwd.M) if form == "segment"
            else _march_args(fwd, phi0, u))
    fn = (km.march_fused_2d_segment if form == "segment"
          else km.march_fused_2d)
    ref = fn(*args, **kw)
    for C in (1, 2, 3, 4, 8, 16):
        _segment_geometry(monkeypatch, lambda n, m, B, sms, members:
                          km.blocked_geometry(n, m, B, sms, cluster=C,
                                              members=members,
                                              solve_passes=1, fwd_passes=3))
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            assert torch.equal(a, b), C


@pytest.mark.cuda
@pytest.mark.parametrize("oracle", ["_march_fused_2d_cta",
                                    "_march_fused_2d_segment_cta"])
def test_fwd_mm_oracles_refuse_on_the_card(cuda, oracle):
    """The one-CTA oracles compute full float32 only: fwd_mm "bf16x3"
    raises on CUDA tensors before a launch."""
    fwd, _, phi0, u, _ = _problem(cuda, n=17, B=1, T=0.02)
    args = (_segment_args(fwd, phi0, u, fwd.M) if "segment" in oracle
            else _march_args(fwd, phi0, u))
    fn = getattr(km, oracle)
    before = fn.launches
    with pytest.raises(ValueError, match="full float32"):
        fn(*args, **dict(_KW, fwd_mm="bf16x3"))
    assert fn.launches == before


@pytest.mark.cuda
def test_fwd_mm_c_entry_refuses_one_pass_staging(cuda, monkeypatch):
    """At solve_prec "default" with fwd_mm "bf16x3" apply_S runs one pass
    and every other product three: the fwd_mm march refuses a geometry
    whose staging is sized for apply_S's one pass (at n = 129, one member
    a cluster of 16: 43,776 bytes against the 87,552 of three passes,
    both above the ring's 37,888)."""
    fwd, _, phi0, u, _ = _problem(cuda, n=129, B=1, T=0.01)
    _segment_geometry(monkeypatch, lambda n, m, B, sms, members:
                      km.blocked_geometry(n, m, B, sms, members=members,
                                          solve_passes=1))
    with pytest.raises(RuntimeError, match="launch failed"):
        km.march_fused_2d(*_march_args(fwd, phi0, u),
                          **dict(_KW, solve_prec="default", fwd_mm="bf16x3"))


def _with_geometry(monkeypatch, make):
    """Make the cluster march launch on make(n, m, B, sms)."""
    def launch_geometry(n, m, B, device, **kw):
        sms = torch.cuda.get_device_properties(
            torch.device(device)).multi_processor_count
        return make(n, m, B, sms)
    monkeypatch.setattr(km, "launch_geometry", launch_geometry)


@pytest.mark.cuda
def test_blocked_march_bits_do_not_depend_on_the_cluster_size(cuda,
                                                               monkeypatch):
    fwd, _, phi0, u, _ = _problem(cuda, n=33, m=29, B=8, T=0.03)
    args = _march_args(fwd, phi0, u)
    ref = km.march_fused_2d(*args, **_KW)
    for C in (1, 2, 4, 8, 16):
        _with_geometry(monkeypatch, lambda n, m, B, sms: km.blocked_geometry(
            n, m, B, sms, cluster=C))
        out = km.march_fused_2d_blocked(*args, **_KW)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            assert torch.equal(a, b), C


@pytest.mark.cuda
@pytest.mark.parametrize("field,delta", [("smem_bytes", 16), ("kc", -4),
                                         ("cluster", 1)])
def test_blocked_c_entry_refuses_a_geometry_not_its_own(cuda, monkeypatch,
                                                        field, delta):
    """The C entry recomputes the geometry from (n, m, cluster, kc) and
    refuses a launch whose shared-memory bytes differ from its own."""
    fwd, _, phi0, u, _ = _problem(cuda, n=33, m=29, B=8, T=0.02)

    def bad(n, m, B, sms):
        g = km.blocked_geometry(n, m, B, sms)
        return g._replace(**{field: getattr(g, field) + delta})
    _with_geometry(monkeypatch, bad)
    with pytest.raises(RuntimeError, match="launch failed"):
        km.march_fused_2d_blocked(*_march_args(fwd, phi0, u), **_KW)


@pytest.mark.cuda
def test_lean_one_member_march_equals_the_held_one(cuda):
    """A launch of the one-CTA oracle with more CTAs than SMs takes its lean
    form (field pointers formed at use); it computes what the other does,
    and so does the cluster march beyond the clusters the card holds."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    fwd, _, phi0, u, _ = _problem(cuda, B=sms + 4, T=0.03)
    lean = km._march_fused_2d_cta(*_march_args(fwd, phi0, u), **_KW)
    held = km._march_fused_2d_cta(
        *_march_args(fwd, phi0[:4], u[:4].contiguous()), **_KW)
    waves = km.march_fused_2d(*_march_args(fwd, phi0, u), **_KW)
    for a, b in zip(waves, lean):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    for a, b in zip(lean, held):
        assert torch.equal(a[:4], b)


@pytest.mark.cuda
def test_segment_kernels_match_plain(cuda):
    fwd, adj, phi0, u, f32 = _problem(cuda, n=33, B=3, T=0.05)
    K = 3
    w = torch.zeros_like(phi0)
    mu = fwd.initialize_mu(phi0, w)
    m0 = torch.sum(fwd.wts * phi0, dim=(-2, -1))
    sargs = (fwd.dts[:K], phi0, mu, w, m0, u[:, :K + 1].contiguous()) + \
        fwd._ops()
    before = km.march_fused_2d_segment.launches
    ks = km.march_fused_2d_segment(*sargs, **_KW)
    assert km.march_fused_2d_segment.launches == before + 1
    ps = km.march_fused_2d_segment_plain(*sargs, **_KW)
    torch.cuda.synchronize()
    assert ks[0].shape == (3, K, 33, 33)
    for a, b in zip(ks[:4], ps[:4]):
        assert (a - b).abs().max().item() <= 1e-5
    assert (ks[4] - ps[4]).abs().max().item() <= 1
    hist = torch.cat([phi0[:, None], ks[0]], dim=1)
    b1, b2 = f32([5.0, 0.3, 1.0]), f32([10.0, 13.0, 2.0])
    p, q, r = adj.terminal(hist[:, K], 0.1 * phi0, b2)
    aargs = (adj.dts[:K], hist, torch.zeros_like(hist), p, q, r, b1) + \
        adj._ops()
    before = km.adjoint_fused_2d_segment.launches
    kr = km.adjoint_fused_2d_segment(*aargs, **adj._kw())
    assert km.adjoint_fused_2d_segment.launches == before + 1
    pr = km.adjoint_fused_2d_segment_plain(*aargs, **adj._kw())
    torch.cuda.synchronize()
    for a, b in zip(kr, pr):
        assert (a - b).abs().max().item() <= 2e-3 * b.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,B", [(33, 29, 1), (33, 29, 2), (33, 29, 4),
                                   (65, 65, 1), (65, 65, 2), (65, 65, 4),
                                   (257, 257, 1), (257, 257, 2),
                                   (257, 257, 4), (257, 257, 32)])
def test_cluster_segment_march_equals_the_one_cta_oracle(cuda, n, m, B):
    """The segment march (one member per thread-block cluster) gives the
    one-CTA segment kernel's history, carry out, Newton counts and
    first_bad bit for bit, launch for launch."""
    fwd, _, phi0, u, _ = _problem(cuda, n=n, m=m, B=B,
                                  T=0.03 if n < 257 else 0.02)
    sargs = _segment_args(fwd, phi0, u, fwd.M)
    before = (km.march_fused_2d_segment.launches,
              km._march_fused_2d_segment_cta.launches)
    ks = km.march_fused_2d_segment(*sargs, **_KW)
    ko = km._march_fused_2d_segment_cta(*sargs, **_KW)
    torch.cuda.synchronize()
    assert (km.march_fused_2d_segment.launches,
            km._march_fused_2d_segment_cta.launches) == (before[0] + 1,
                                                          before[1] + 1)
    assert ks[0].shape == (B, fwd.M, n, m)
    for a, b in zip(ks, ko):
        assert torch.equal(a, b)


def _segment_geometry(monkeypatch, make):
    """Make the segment march launch on make(n, m, B, sms, members)."""
    def launch_geometry(n, m, B, device, members=km.BLOCK_MEMBERS, **kw):
        sms = torch.cuda.get_device_properties(
            torch.device(device)).multi_processor_count
        return make(n, m, B, sms, members)
    monkeypatch.setattr(km, "launch_geometry", launch_geometry)


@pytest.mark.cuda
def test_cluster_segment_bits_do_not_depend_on_the_cluster_size(cuda,
                                                                monkeypatch):
    fwd, _, phi0, u, _ = _problem(cuda, n=33, m=29, B=2, T=0.03)
    sargs = _segment_args(fwd, phi0, u, fwd.M)
    ref = km._march_fused_2d_segment_cta(*sargs, **_KW)
    for C in range(1, 17):
        _segment_geometry(monkeypatch, lambda n, m, B, sms, members:
                          km.blocked_geometry(n, m, B, sms, cluster=C,
                                              members=members))
        out = km.march_fused_2d_segment(*sargs, **_KW)
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            assert torch.equal(a, b), C


@pytest.mark.cuda
def test_chained_cluster_segments_give_the_whole_march(cuda):
    """Two chained segments: the whole march's Newton counts, no bad step,
    its history within 1e-5 (mu at t = 0 is formed outside the kernel)."""
    fwd, _, phi0, u, _ = _problem(cuda, n=65, B=3, T=0.06)
    K = fwd.M // 2
    wh, wns, wbad = km.march_fused_2d(*_march_args(fwd, phi0, u), **_KW)
    w = torch.zeros_like(phi0)
    m0 = torch.sum(fwd.wts * phi0, dim=(-2, -1))
    phi, carry = phi0, (fwd.initialize_mu(phi0, w), w, m0)
    frames, ns = [], torch.zeros_like(wns)
    for start in (0, K):
        out = km.march_fused_2d_segment(
            *_segment_args(fwd, phi, u, K, start, carry), **_KW)
        frames.append(out[0])
        phi, carry = out[1], (out[2], out[3], m0)
        ns += out[4]
        assert (out[5] == -1).all()
    torch.cuda.synchronize()
    hist = torch.cat([phi0[:, None]] + frames, dim=1)
    assert torch.equal(ns, wns) and (wbad == -1).all()
    assert (hist - wh).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("field,delta", [("smem_bytes", 16), ("kc", -4),
                                         ("cluster", 1)])
def test_segment_c_entry_refuses_a_geometry_not_its_own(cuda, monkeypatch,
                                                        field, delta):
    fwd, _, phi0, u, _ = _problem(cuda, n=33, m=29, B=2, T=0.02)

    def bad(n, m, B, sms, members):
        g = km.blocked_geometry(n, m, B, sms, members=members)
        return g._replace(**{field: getattr(g, field) + delta})
    _segment_geometry(monkeypatch, bad)
    with pytest.raises(RuntimeError, match="launch failed"):
        km.march_fused_2d_segment(*_segment_args(fwd, phi0, u, fwd.M), **_KW)


@pytest.mark.cuda
def test_blocked_wrappers_reject_unbuilt_and_indivisible_blocks(cuda):
    """block_b = 2 and 4 run: the march bit for bit the one-member march and
    its one-CTA oracle, member for member; the sweep (the cluster sweep)
    bit for bit the one-CTA sweep. A block of 3 and a batch that does not
    divide by the block raise, for the march and for the sweep."""
    fwd, adj, phi0, u, f32 = _problem(cuda, n=65, B=8, T=0.05)
    args = _march_args(fwd, phi0, u)
    kh, kns, kbad = km.march_fused_2d(*args, **_KW)
    oh, ons, obad = km._march_fused_2d_cta(*args, **_KW)
    b1, b2 = f32(np.linspace(0.3, 5.0, 8)), f32(np.linspace(13.0, 10.0, 8))
    aargs = (adj.dts, kh, torch.zeros_like(kh), 0.1 * phi0, b1, b2) + \
        adj._ops()
    kr = km._adjoint_fused_2d_cta(*aargs, **adj._kw())
    torch.cuda.synchronize()
    for a, b in ((kh, oh), (kns, ons), (kbad, obad)):
        assert torch.equal(a, b)
    for block_b in (2, 4):
        before = (km.march_fused_2d_blocked.launches,
                  km.adjoint_fused_2d_blocked.launches)
        bh, bns, bbad = km.march_fused_2d_blocked(*args, block_b=block_b,
                                                  **_KW)
        br = km.adjoint_fused_2d_blocked(*aargs, block_b=block_b,
                                         **adj._kw())
        torch.cuda.synchronize()
        assert (km.march_fused_2d_blocked.launches,
                km.adjoint_fused_2d_blocked.launches) == (before[0] + 1,
                                                          before[1] + 1)
        for a, b in ((bh, kh), (bns, kns), (bbad, kbad)):
            assert torch.equal(a, b), block_b
        assert torch.equal(br, kr), block_b
    fwd6, adj6, phi6, u6, f6 = _problem(cuda, B=6)
    args6 = _march_args(fwd6, phi6, u6)
    h6 = km.march_fused_2d(*args6, **_KW)[0]
    aargs6 = (adj6.dts, h6, torch.zeros_like(h6), 0.1 * phi6,
              f6([1.0] * 6), f6([10.0] * 6)) + adj6._ops()
    with pytest.raises(ValueError, match="built for block_b"):
        km.march_fused_2d_blocked(*args6, block_b=3, **_KW)
    with pytest.raises(ValueError, match="B % block_b"):
        km.march_fused_2d_blocked(*args6, block_b=4, **_KW)
    with pytest.raises(ValueError, match="built for block_b"):
        km.adjoint_fused_2d_blocked(*aargs6, block_b=3, **adj6._kw())
    with pytest.raises(ValueError, match="B % block_b"):
        km.adjoint_fused_2d_blocked(*aargs6, block_b=4, **adj6._kw())


def _sweep_inputs(device, n, B, T, zero_dt=True, seed=5):
    """A float32 sweep's inputs of B members on an (n, n) grid: the march's
    history under a seeded control, seeded targets and weights, the dts
    with step 1 set to 0 (zero_dt: that step copies the next level).
    Returns (adj, the whole sweep's arguments)."""
    fwd, adj, phi0, u, f32 = _problem(device, n=n, B=B, T=T)
    hist = km.march_fused_2d(*_march_args(fwd, phi0, u), **_KW)[0]
    rng = np.random.default_rng(seed)
    dts = adj.dts.clone()
    if zero_dt:
        dts[1] = 0.0
    phiQ = f32(0.3 * rng.standard_normal(tuple(hist.shape)))
    aargs = (dts, hist, phiQ, 0.1 * phi0, f32(np.linspace(0.3, 5.0, B)),
             f32(np.linspace(13.0, 10.0, B))) + adj._ops()
    return adj, aargs


def _segment_sweep_args(adj, aargs, K):
    """The last K steps of a whole sweep's arguments as a segment, from
    the terminal carry."""
    dts, hist, phiQ, phiT, b1, b2, *ops = aargs
    M = dts.shape[0]
    p, q, r = adj.terminal(hist[:, M], phiT, b2)
    sl = slice(M - K, M + 1)
    return (dts[M - K:], hist[:, sl].contiguous(), phiQ[:, sl].contiguous(),
            p, q, r, b1) + tuple(ops)


@pytest.mark.cuda
@pytest.mark.parametrize("n,B", [(65, 1), (65, 2), (65, 4), (257, 1),
                                 (257, 2), (257, 8)])
def test_cluster_segment_sweep_equals_the_one_cta_oracle(cuda, n, B):
    """The segment sweep (one member per thread-block cluster) gives the
    one-CTA segment sweep's r and (p_f, q_f, r_f) carry bit for bit, a
    zero dt step included."""
    adj, aargs = _sweep_inputs(cuda, n, B, T=0.04 if n < 257 else 0.03)
    sargs = _segment_sweep_args(adj, aargs, aargs[0].shape[0])
    before = (km.adjoint_fused_2d_segment.launches,
              km._adjoint_fused_2d_segment_cta.launches)
    ks = km.adjoint_fused_2d_segment(*sargs, **adj._kw())
    ko = km._adjoint_fused_2d_segment_cta(*sargs, **adj._kw())
    torch.cuda.synchronize()
    assert (km.adjoint_fused_2d_segment.launches,
            km._adjoint_fused_2d_segment_cta.launches) == (before[0] + 1,
                                                          before[1] + 1)
    assert ks[0].shape == (B, sargs[0].shape[0], n, n)
    assert bool(torch.isfinite(ks[0]).all())
    assert torch.equal(ks[0][:, 1], ks[0][:, 2])     # the zero-dt copy
    for a, b in zip(ks, ko):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("block_b", [8, 4, 2])
@pytest.mark.parametrize("n", [65, 257])
def test_cluster_blocked_sweep_equals_the_one_cta_oracle(cuda, n, block_b):
    """The blocked sweep (block_b members on a thread-block cluster) gives
    each member the one-CTA sweep's r bit for bit, a zero dt step
    included."""
    adj, aargs = _sweep_inputs(cuda, n, 8, T=0.04 if n < 257 else 0.03)
    before = km.adjoint_fused_2d_blocked.launches
    br = km.adjoint_fused_2d_blocked(*aargs, block_b=block_b, **adj._kw())
    assert km.adjoint_fused_2d_blocked.launches == before + 1
    kr = km._adjoint_fused_2d_cta(*aargs, **adj._kw())
    torch.cuda.synchronize()
    assert bool(torch.isfinite(br).all()) and (br[:, -1] == 0).all()
    assert torch.equal(br[:, 1], br[:, 2])           # the zero-dt copy
    assert torch.equal(br, kr)


def _sweep_geometry(monkeypatch, make):
    """Make the cluster sweep launch on make(n, m, B, sms, members)."""
    def launch_geometry(n, m, B, device, members=km.BLOCK_MEMBERS, **kw):
        assert kw.get("kernel") == "sweep"
        sms = torch.cuda.get_device_properties(
            torch.device(device)).multi_processor_count
        return make(n, m, B, sms, members)
    monkeypatch.setattr(km, "launch_geometry", launch_geometry)


@pytest.mark.cuda
def test_cluster_sweep_bits_do_not_depend_on_the_cluster_size(cuda,
                                                              monkeypatch):
    adj, aargs = _sweep_inputs(cuda, 33, 8, T=0.04)
    ref = km._adjoint_fused_2d_cta(*aargs, **adj._kw())
    sargs = _segment_sweep_args(adj, aargs, 3)
    sref = km._adjoint_fused_2d_segment_cta(*sargs, **adj._kw())
    for C in range(1, 17):
        _sweep_geometry(monkeypatch, lambda n, m, B, sms, members:
                        km.blocked_geometry(n, m, B, sms, cluster=C,
                                            members=members, kernel="sweep"))
        out = km.adjoint_fused_2d_segment(*sargs, **adj._kw())
        torch.cuda.synchronize()
        for a, b in zip(out, sref):
            assert torch.equal(a, b), C
        if C & (C - 1) == 0:
            br = km.adjoint_fused_2d_blocked(*aargs, **adj._kw())
            torch.cuda.synchronize()
            assert torch.equal(br, ref), C


@pytest.mark.cuda
@pytest.mark.parametrize("segment", [False, True])
@pytest.mark.parametrize("field,delta", [("smem_bytes", 16), ("kc", -4),
                                         ("cluster", 1)])
def test_sweep_c_entry_refuses_a_geometry_not_its_own(cuda, monkeypatch,
                                                      field, delta, segment):
    """The C entries recompute the geometry from (n, m, cluster, kc) and
    refuse a launch whose shared-memory bytes differ from their own."""
    adj, aargs = _sweep_inputs(cuda, 33, 8, T=0.02, zero_dt=False)

    def bad(n, m, B, sms, members):
        g = km.blocked_geometry(n, m, B, sms, members=members, kernel="sweep")
        return g._replace(**{field: getattr(g, field) + delta})
    _sweep_geometry(monkeypatch, bad)
    with pytest.raises(RuntimeError, match="launch failed"):
        if segment:
            km.adjoint_fused_2d_segment(
                *_segment_sweep_args(adj, aargs, 2), **adj._kw())
        else:
            km.adjoint_fused_2d_blocked(*aargs, **adj._kw())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 128])
@pytest.mark.parametrize("n", [65, 129])
def test_one_member_sweep_equals_the_one_cta_oracle(cuda, n, B):
    """The whole sweep (one member per thread-block cluster) gives the
    one-CTA sweep's r bit for bit, a zero dt step included."""
    adj, aargs = _sweep_inputs(cuda, n, B, T=0.04 if n < 129 else 0.03)
    before = (km.adjoint_fused_2d.launches, km._adjoint_fused_2d_cta.launches)
    kr = km.adjoint_fused_2d(*aargs, **adj._kw())
    ko = km._adjoint_fused_2d_cta(*aargs, **adj._kw())
    torch.cuda.synchronize()
    assert (km.adjoint_fused_2d.launches,
            km._adjoint_fused_2d_cta.launches) == (before[0] + 1,
                                                   before[1] + 1)
    assert bool(torch.isfinite(kr).all()) and (kr[:, -1] == 0).all()
    assert torch.equal(kr[:, 1], kr[:, 2])           # the zero-dt copy
    assert torch.equal(kr, ko)


@pytest.mark.cuda
def test_one_member_sweep_bits_do_not_depend_on_the_cluster_size(
        cuda, monkeypatch):
    """The whole one-member sweep on forced clusters of 1, 2, 4 and 16 (and
    every size between) gives the one-CTA sweep's r bit for bit."""
    adj, aargs = _sweep_inputs(cuda, 65, 2, T=0.04)
    ref = km._adjoint_fused_2d_cta(*aargs, **adj._kw())
    for C in range(1, 17):
        _sweep_geometry(monkeypatch, lambda n, m, B, sms, members:
                        km.blocked_geometry(n, m, B, sms, cluster=C,
                                            members=members, kernel="sweep"))
        out = km.adjoint_fused_2d(*aargs, **adj._kw())
        torch.cuda.synchronize()
        assert torch.equal(out, ref), C


@pytest.mark.cuda
@pytest.mark.parametrize("field,delta", [("smem_bytes", 16), ("kc", -4),
                                         ("cluster", 1)])
def test_one_member_sweep_c_entry_refuses_a_geometry_not_its_own(
        cuda, monkeypatch, field, delta):
    adj, aargs = _sweep_inputs(cuda, 33, 2, T=0.02, zero_dt=False)

    def bad(n, m, B, sms, members):
        g = km.blocked_geometry(n, m, B, sms, members=members, kernel="sweep")
        return g._replace(**{field: getattr(g, field) + delta})
    _sweep_geometry(monkeypatch, bad)
    with pytest.raises(RuntimeError, match="launch failed"):
        km.adjoint_fused_2d(*aargs, **adj._kw())


# the bf16 forms of the cluster sweep (adjoint_solve_precision "bf16x3"):
# each against its plain version at "bf16x3"
_SWEEP16_FORMS = {"one_member": dict(n=33, B=4), "blocked_8": dict(n=33, B=16),
                  "blocked_4": dict(n=33, B=8), "blocked_2": dict(n=33, B=8),
                  "segment": dict(n=65, B=2)}


def _bf16_sweep(adj, aargs, form, prec, plain=False, cast=list):
    """A sweep form's kernel (or plain version) result at `prec`, on its
    arguments passed through `cast` (the plain version's in float64 or on
    the CPU)."""
    kw = dict(adj._kw(), solve_prec=prec)
    if form.startswith("blocked"):
        fn = (km.adjoint_fused_2d_blocked_plain if plain
              else km.adjoint_fused_2d_blocked)
        return fn(*cast(aargs), block_b=int(form[-1]), **kw)
    if form == "segment":      # the last K = M - 1 steps, the zero dt first
        fn = (km.adjoint_fused_2d_segment_plain if plain
              else km.adjoint_fused_2d_segment)
        K = aargs[0].shape[0] - 1
        return fn(*cast(_segment_sweep_args(adj, aargs, K)), **kw)[0]
    return (km.adjoint_fused_2d_plain if plain
            else km.adjoint_fused_2d)(*cast(aargs), **kw)


def _f64_distances(adj, aargs, form, kern):
    """(the kernel's, the farther plain float32 bf16x3 sweep's, on the card
    or on the CPU) largest relative distance from the float64 plain sweep,
    on the same inputs: chip_smoke's _adjoint_gate reference (one plain
    sweep's distance is no stable reference at n = 65)."""
    rel = lambda a, b: ((a.to(b).double() - b).abs().max()
                        / b.abs().max()).item()
    r64 = _bf16_sweep(adj, aargs, form, "highest", plain=True,
                      cast=lambda a: [t.double() for t in a])
    plains = (_bf16_sweep(adj, aargs, form, "bf16x3", plain=True),
              _bf16_sweep(adj, aargs, form, "bf16x3", plain=True,
                          cast=lambda a: [t.cpu() for t in a]))
    return rel(kern, r64), max(rel(p, r64) for p in plains)


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(_SWEEP16_FORMS))
def test_bf16_sweep_matches_plain(cuda, form):
    """The sweep's bf16 forms (apply_At on mma.sync) against their plain
    versions at "bf16x3": r within test_adjoint_kernel_matches_plain's 2e-3
    relative, and no farther from the float64 sweep than twice the farther
    plain float32 one (+1e-6; chip_smoke's _adjoint_gate); the zero-dt
    copy kept;
    one launch of the bf16 form beside the float32 one, whose bits it does
    not give."""
    shape = _SWEEP16_FORMS[form]
    adj, aargs = _sweep_inputs(cuda, shape["n"], shape["B"], T=0.04)
    before = (km.launch_counts(), km.bf16_launch_counts())
    kern = _bf16_sweep(adj, aargs, form, "bf16x3")
    f32 = _bf16_sweep(adj, aargs, form, "highest")
    plain = _bf16_sweep(adj, aargs, form, "bf16x3", plain=True)
    torch.cuda.synchronize()
    after = (km.launch_counts(), km.bf16_launch_counts())
    assert [sum(a.values()) - sum(b.values())
            for a, b in zip(after, before)] == [2, 1]
    assert bool(torch.isfinite(kern).all())
    zero = 0 if form == "segment" else 1             # the zero-dt copy
    assert torch.equal(kern[:, zero], kern[:, zero + 1])
    rel = (kern - plain).abs().max().item() / plain.abs().max().item()
    assert rel <= 2e-3, rel
    assert not torch.equal(kern, f32)
    d_kern, d_plain = _f64_distances(adj, aargs, form, kern)
    assert d_kern <= 2 * d_plain + 1e-6, (d_kern, d_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["one_member", "blocked_8", "segment"])
def test_bf16_sweep_gate_fails_a_one_pass_sweep(cuda, monkeypatch, form):
    """A control of the float64 clause of test_bf16_sweep_matches_plain
    (and of chip_smoke's phase 2q): the bf16 sweep made to run At's
    products at one pass (product16's hi x hi alone; no solve precision
    selects it) lies farther from the float64 sweep than twice the farther
    plain float32 bf16x3 sweep, where the three-pass form does not. At n = 33,
    M = 4: where the float32 noise floor is low enough to see a pass."""
    B = {"one_member": 4, "blocked_8": 16, "segment": 4}[form]
    adj, aargs = _sweep_inputs(cuda, 33, B, T=0.04)
    three = _bf16_sweep(adj, aargs, form, "bf16x3")
    monkeypatch.setattr(km, "sweep_passes",
                        lambda prec: 1 if prec == "bf16x3" else 0)
    one = _bf16_sweep(adj, aargs, form, "bf16x3")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(one).all()) and not torch.equal(one, three)
    d_three, d_plain = _f64_distances(adj, aargs, form, three)
    d_one, _ = _f64_distances(adj, aargs, form, one)
    assert d_three <= 2 * d_plain + 1e-6, (d_three, d_plain)
    assert d_one > 2 * d_plain + 1e-6, (d_one, d_plain)


def _sweep16_geometry(monkeypatch, make):
    """Make the bf16 cluster sweep launch on make(n, m, B, sms, members)."""
    def launch_geometry(n, m, B, device, members=km.BLOCK_MEMBERS, **kw):
        assert kw.get("kernel") == "sweep" and kw.get("solve_passes") == 3
        sms = torch.cuda.get_device_properties(
            torch.device(device)).multi_processor_count
        return make(n, m, B, sms, members)
    monkeypatch.setattr(km, "launch_geometry", launch_geometry)


@pytest.mark.cuda
def test_bf16_blocked_sweep_equals_the_one_member_sweep(cuda):
    """The bf16 forms sum each product in the same k-tile order whatever
    the block: the blocked sweep (8, 4, 2 members a cluster) gives each
    member the one-member bf16 sweep's r bit for bit."""
    adj, aargs = _sweep_inputs(cuda, 33, 16, T=0.04)
    kw = dict(adj._kw(), solve_prec="bf16x3")
    ref = km.adjoint_fused_2d(*aargs, **kw)
    for bb in (8, 4, 2):
        out = km.adjoint_fused_2d_blocked(*aargs, block_b=bb, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), bb


@pytest.mark.cuda
def test_bf16_sweep_bits_do_not_depend_on_the_cluster_size(cuda,
                                                           monkeypatch):
    """The whole and the segment bf16 sweep on forced clusters of every
    size 1-16, the blocked one on 1, 2, 4, 8 and 16: the bits of the
    launch on its own geometry."""
    adj, aargs = _sweep_inputs(cuda, 33, 8, T=0.04)
    kw = dict(adj._kw(), solve_prec="bf16x3")
    sargs = _segment_sweep_args(adj, aargs, 3)
    ref = km.adjoint_fused_2d(*aargs, **kw)
    sref = km.adjoint_fused_2d_segment(*sargs, **kw)
    for C in range(1, 17):
        _sweep16_geometry(monkeypatch, lambda n, m, B, sms, members:
                          km.blocked_geometry(n, m, B, sms, cluster=C,
                                              members=members, kernel="sweep",
                                              solve_passes=3))
        out = km.adjoint_fused_2d(*aargs, **kw)
        seg = km.adjoint_fused_2d_segment(*sargs, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), C
        for a, b in zip(seg, sref):
            assert torch.equal(a, b), C
        if C & (C - 1) == 0:
            br = km.adjoint_fused_2d_blocked(*aargs, **kw)
            torch.cuda.synchronize()
            assert torch.equal(br, ref), C


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["one_member", "blocked_8", "segment"])
def test_bf16_sweep_c_entry_refuses_a_geometry_not_its_own(cuda, monkeypatch,
                                                           form):
    """The bf16 sweep recomputes its staging from (n, m, cluster, kc) at
    three passes and refuses shared-memory bytes other than its own."""
    adj, aargs = _sweep_inputs(cuda, 33, 8, T=0.03, zero_dt=False)

    def bad(n, m, B, sms, members):
        g = km.blocked_geometry(n, m, B, sms, members=members, kernel="sweep",
                                solve_passes=3)
        return g._replace(smem_bytes=g.smem_bytes + 16)
    _sweep16_geometry(monkeypatch, bad)
    with pytest.raises(RuntimeError, match="launch failed"):
        _bf16_sweep(adj, aargs, form, "bf16x3")


def _solve_inputs(device, dtype, n=65, B=4, seed=0):
    """A Newton state and an adjoint step of B members on an (n, n) grid
    (as tests/test_torch_solve.py builds them): the operators, the Schur
    solve's (denom, d, rhs) and the adjoint solve's (isd, fpp, rhs, x0),
    (n, n) fields when B is None."""
    from vch_tpu_torch.ops.linsolve import make_spectral_op_2d, ops_2d
    h = 1.0 / (n - 1)
    ops = ops_2d(make_spectral_op_2d(n - 1, n - 1, h, h, dtype=dtype,
                                     device=device))
    rng = np.random.default_rng(seed)
    lam = ops.lam.cpu().double().numpy()
    sh = (B or 1, n, n)
    dt, tau, c1, c2, kappa = 1e-2, 0.05, 0.75, 1.0, 1e-4
    phi = np.clip(0.5 * rng.standard_normal(sh), -0.95, 0.95)
    d = 2 * c1 / (1 - np.clip(phi * phi, 0, 1 - 1e-4))
    denom = (1 / dt + 0.5 * kappa * lam ** 2
             - (tau / dt + d.mean(axis=(1, 2), keepdims=True)) * lam)
    fpp = 2 * c1 / (1 - phi * phi) - 2 * c2
    dena = (1 - tau * lam + 0.5 * dt * lam ** 2
            - 0.5 * dt * fpp.mean(axis=(1, 2), keepdims=True) * lam)
    t = lambda a: torch.as_tensor(a if B else a[0], dtype=dtype,
                                  device=device).contiguous()
    fields = dict(schur=(t(denom), t(d), t(rng.standard_normal(sh))),
                  adjoint=(t(1 / np.sqrt(np.abs(dena))), t(fpp),
                           t(rng.standard_normal(sh)),
                           t(rng.standard_normal(sh))))
    scal = dict(schur=((1 / dt, tau / dt, 0.5 * kappa), 4),
                adjoint=((tau, 0.5 * dt), 5))
    return ops, fields, scal


def _solve_call(name, ops, fields, scal, fn):
    spectral = (ops.Vx_inv, ops.Vy_inv_T, ops.Vx, ops.VyT, ops.lam)
    raw = (ops.Lx, ops.LyT, ops.Vx_inv, ops.Vy_inv_T, ops.Vx, ops.VyT)
    kind = "schur" if "schur" in name else "adjoint"
    vals, n_iter = scal[kind]
    return fn(*(spectral if "spectral" in name else raw), *fields[kind],
              *vals, n_iter=n_iter)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [None, 4])
@pytest.mark.parametrize("name", ["bicgstab_schur_spectral", "bicgstab_schur",
                                  "bicgstab_adjoint_spectral",
                                  "bicgstab_adjoint"])
def test_solve_kernel_matches_plain(cuda, name, B):
    """Each per-solve kernel at n = 65, one (n, n) solve and a batch of
    four, against its plain version on the same float32 inputs on the card:
    within 2x the plain version's distance from the float64 plain version
    (plus 1e-6); and within 1e-4 of the plain version relative to its
    largest entry for the Schur solves, 2e-3 for the spectral adjoint solve
    (the adjoint bound of the tests above: on these random inputs two
    float32 adjoint solves differ by 1-2e-4 at n = 65). On them the raw
    adjoint solve's float32 result is 0.3-0.6 from float64 (the
    condition-1e6 operator applied in the raw basis; measured on the CPU),
    so it has the float64-referenced gate only."""
    from vch_tpu_torch.ops import solve_kernels as sk
    ops, fields, scal = _solve_inputs(cuda, torch.float32, B=B)
    ops64, fields64, _ = _solve_inputs(cuda, torch.float64, B=B)
    wrapper, plain = getattr(sk, name), getattr(sk, name + "_plain")
    before = wrapper.launches
    out = _solve_call(name, ops, fields, scal, wrapper)
    assert wrapper.launches == before + 1
    ref = _solve_call(name, ops, fields, scal, plain)
    ref64 = _solve_call(name, ops64, fields64, scal, plain)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    dist = lambda a, b: ((a.double() - b.double()).abs().max()
                         / b.double().abs().max()).item()
    assert dist(out, ref64) <= 2 * dist(ref, ref64) + 1e-6
    if name != "bicgstab_adjoint":
        assert dist(out, ref) <= (1e-4 if "schur" in name else 2e-3)


@pytest.mark.cuda
def test_solve_kernels_reject_what_they_do_not_take(cuda):
    from vch_tpu_torch.ops import solve_kernels as sk
    ops, fields, scal = _solve_inputs(cuda, torch.float32, n=33, B=2)
    bad = dict(fields, schur=(fields["schur"][0].double(),)
               + fields["schur"][1:])
    with pytest.raises(TypeError, match="float32"):
        _solve_call("bicgstab_schur_spectral", ops, bad, scal,
                    sk.bicgstab_schur_spectral)
    bad = dict(fields, adjoint=fields["adjoint"][:3]
               + (fields["adjoint"][3][:1],))
    with pytest.raises(ValueError, match="shape"):
        _solve_call("bicgstab_adjoint", ops, bad, scal, sk.bicgstab_adjoint)


# the cluster solves (one member per thread-block cluster) and their one-CTA
# oracles: each wrapper, its oracle, its kernel in CLUSTER_KERNELS, and its
# scalars' index among the wrapper's trailing scalar arguments that the
# per-step solvers pass as 0-d tensors on the card
CLUSTER_SOLVES = {
    "bicgstab_adjoint_spectral": ("_bicgstab_adjoint_spectral_cta", "solve"),
    "bicgstab_schur_spectral": ("_bicgstab_schur_spectral_cta",
                                "schur_solve"),
    "bicgstab_adjoint": ("_bicgstab_adjoint_cta", "raw_solve"),
    "bicgstab_schur": ("_bicgstab_schur_cta", "raw_schur_solve")}


def _cluster_solve(name, ops, fields, scal, oracle=False):
    from vch_tpu_torch.ops import solve_kernels as sk
    fn = getattr(sk, CLUSTER_SOLVES[name][0] if oracle else name)
    return _solve_call(name, ops, fields, scal, fn)


def _on_device(scal, device):
    """The solves' scalars as the per-step solvers pass them: the marcher's
    1/dt and tau/dt and the sweep's dt/2 as 0-d tensors on the card."""
    (s_vals, s_trips), (a_vals, a_trips) = scal["schur"], scal["adjoint"]
    t = lambda v: torch.tensor(v, device=device)
    return dict(schur=((t(s_vals[0]), t(s_vals[1]), s_vals[2]), s_trips),
                adjoint=((a_vals[0], t(a_vals[1])), a_trips))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CLUSTER_SOLVES))
@pytest.mark.parametrize("n,B", [(65, None), (65, 1), (65, 4), (17, 3),
                                 (129, 8), (257, None), (33, 4), (129, 128),
                                 (257, 1)])
def test_cluster_adjoint_solve_equals_the_one_cta_oracle(cuda, n, B, name):
    """Each cluster solve (the spectral and the raw adjoint step solve, the
    spectral and the raw Schur solve; one member per thread-block cluster)
    gives its
    one-CTA oracle's result bit for bit; the scalars the per-step solvers
    pass as 0-d tensors on the card, passed so and as numbers, give the
    same bits."""
    from vch_tpu_torch.ops import solve_kernels as sk
    ops, fields, scal = _solve_inputs(cuda, torch.float32, n=n, B=B)
    oracle = CLUSTER_SOLVES[name][0]
    wrapper, cta = getattr(sk, name), getattr(sk, oracle)
    before = (wrapper.launches, cta.launches)
    k = _cluster_solve(name, ops, fields, scal)
    o = _cluster_solve(name, ops, fields, scal, oracle=True)
    kt = _cluster_solve(name, ops, fields, _on_device(scal, cuda))
    torch.cuda.synchronize()
    assert (wrapper.launches, cta.launches) == (before[0] + 2,
                                                before[1] + 1)
    kind = "schur" if "schur" in name else "adjoint"
    assert k.shape == fields[kind][2].shape
    assert bool(torch.isfinite(k).all())
    assert torch.equal(k, o) and torch.equal(kt, k)


def _solve_geometry(monkeypatch, make):
    """Make the cluster solves launch on make(n, m, B, sms, kernel)."""
    from vch_tpu_torch.ops import solve_kernels as sk

    def solve_geometry(n, m, B, device_index, kernel="solve"):
        sms = torch.cuda.get_device_properties(
            device_index).multi_processor_count
        return make(n, m, B, sms, kernel)
    monkeypatch.setattr(sk, "solve_geometry", solve_geometry)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CLUSTER_SOLVES))
def test_cluster_adjoint_solve_bits_do_not_depend_on_the_cluster_size(
        cuda, monkeypatch, name):
    ops, fields, scal = _solve_inputs(cuda, torch.float32, n=65, B=2)
    ref = _cluster_solve(name, ops, fields, scal, oracle=True)
    for C in range(1, 17):
        _solve_geometry(monkeypatch, lambda n, m, B, sms, kernel:
                        km.blocked_geometry(n, m, B, sms, cluster=C,
                                            members=1, kernel=kernel))
        out = _cluster_solve(name, ops, fields, scal)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), C


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CLUSTER_SOLVES))
@pytest.mark.parametrize("field,delta", [("smem_bytes", 16), ("kc", -4),
                                         ("cluster", 1)])
def test_cluster_adjoint_solve_refuses_a_geometry_not_its_own(
        cuda, monkeypatch, field, delta, name):
    ops, fields, scal = _solve_inputs(cuda, torch.float32, n=33, B=2)

    def bad(n, m, B, sms, kernel):
        assert kernel == CLUSTER_SOLVES[name][1]
        g = km.blocked_geometry(n, m, B, sms, members=1, kernel=kernel)
        return g._replace(**{field: getattr(g, field) + delta})
    _solve_geometry(monkeypatch, bad)
    with pytest.raises(RuntimeError, match="launch failed"):
        _cluster_solve(name, ops, fields, scal)


def _config3(cuda, variant="spectral"):
    from vch_tpu_torch.config import OptimizationConfig
    from vch_tpu_torch.control.problems import ControlProblem2D
    cfg = ForwardSolverConfig2D(Nx=64, Ny=64, T=1.0, dtype="float32",
                                newton_tol=2e-4, pallas_variant=variant)
    prob = ControlProblem2D(cfg, OptimizationConfig.defaults_2d(),
                            device=cuda)
    assert prob.solver.entries is km.KERNELS
    assert prob.adjoint.entries is km.KERNELS
    return prob


@pytest.mark.cuda
@pytest.mark.parametrize("variant,solve", [
    ("spectral", "bicgstab_adjoint_spectral"), ("raw", "bicgstab_adjoint")])
def test_config3_sweeps_run_m_cluster_solves(cuda, variant, solve):
    """Config 3 (64 x 64, T = 1, M = 100, float32) through ControlProblem2D,
    on each pallas_variant: the solvers' entries are the kernels, and one
    PGD iteration's sweep launches the variant's cluster solve M times and
    its one-CTA oracle never."""
    from vch_tpu_torch.ops import solve_kernels as sk
    prob = _config3(cuda, variant)
    km.reset_launches()
    res = prob.optimize(max_iter=1, verbose=False)
    torch.cuda.synchronize()
    counts = km.launch_counts()
    assert counts[solve] == prob.solver.M == 100
    assert counts[CLUSTER_SOLVES[solve][0]] == 0
    assert counts["march_fused_2d"] == sum(res.ls_trials_per_iter)
    assert np.isfinite(res.cost_history).all()
    assert getattr(sk, solve) in km.KERNELS


@pytest.mark.cuda
def test_config3_constructor_runs_a_cluster_schur_solve_per_newton_solve(
        cuda):
    """Config 3's constructor (the baseline march on the per-step marcher)
    launches the cluster Schur solve once per Newton solve, its one-CTA
    oracle never."""
    km.reset_launches()
    prob = _config3(cuda)
    torch.cuda.synchronize()
    counts = km.launch_counts()
    assert counts["bicgstab_schur_spectral"] == prob.newton_solves > 0
    assert counts["_bicgstab_schur_spectral_cta"] == 0


@pytest.mark.cuda
def test_config3_raw_constructor_runs_a_cluster_raw_schur_solve_per_newton(
        cuda):
    """Config 3's constructor on pallas_variant "raw" launches the cluster
    raw Schur solve (row 10) once per Newton solve, its one-CTA oracle and
    the spectral Schur solve never."""
    km.reset_launches()
    prob = _config3(cuda, "raw")
    torch.cuda.synchronize()
    counts = km.launch_counts()
    assert counts["bicgstab_schur"] == prob.newton_solves > 0
    assert counts["_bicgstab_schur_cta"] == 0
    assert counts["bicgstab_schur_spectral"] == 0


# --------------------------------------------------------------------------
# the 1D march, the operator applies, the batched raw Schur solve


def _problem_1d(device, N=64, B=5, T=0.06, seed=0, dtype="float32"):
    from vch_tpu_torch.config import ForwardSolverConfig1D
    from vch_tpu_torch.models.forward1d import ForwardSolver1D
    from vch_tpu_torch.ops.potential import init_phi_random_1d
    cfg = ForwardSolverConfig1D(N=N, T=T, dt_initial=T / 6, dtype=dtype,
                                newton_tol=2e-4, linsolve_1d="spectral")
    fwd = ForwardSolver1D(cfg, device=device)
    if dtype == "float64":      # the float32 path's exits and trips
        fwd._rtol, fwd._stagnation = cfg.newton_rtol, True
        fwd._krylov_fixed = cfg.krylov_fixed_iters
        fwd.entries = km.PLAIN
    rng = np.random.default_rng(seed)
    phi0 = np.stack([init_phi_random_1d(N, DELTA_SEP, amp=0.01, seed=42 + i)
                     for i in range(B)])
    u = 0.05 * rng.standard_normal((B, fwd.M + 1, N + 1))
    as_t = lambda a: torch.as_tensor(a, dtype=fwd.dtype, device=device)
    return fwd, as_t(phi0), as_t(u)


def test_1d_cpu_tensors_run_the_plain_version():
    fwd, phi0, u = _problem_1d(torch.device("cpu"), B=2)
    before = km.march_fused_1d.launches
    hist, ns, bad = fwd.march_fused_batch(u, phi0)
    assert km.march_fused_1d.launches == before
    assert fwd.M == 6 and hist.shape == (2, fwd.M + 1, 65) and torch.equal(hist[:, 0], phi0)
    assert ns.dtype == torch.float32 and bad.dtype == torch.float32
    assert (bad == -1).all() and (ns >= fwd.M).all()


@pytest.mark.cuda
@pytest.mark.parametrize("N,B,T", [(64, 5, 0.06), (128, 3, 0.06),
                                   (512, 3, 0.012)])
def test_march_1d_kernel_matches_plain_for_every_grouping(cuda, N, B, T):
    fwd, phi0, u = _problem_1d(cuda, N=N, B=B, T=T)
    fwd.entries = km.PLAIN
    ph, pns, pbad = fwd.march_fused_batch(u, phi0)
    fwd.entries = km.KERNELS
    before = km.march_fused_1d.launches
    kh, kns, kbad = fwd.march_fused_batch(u, phi0)
    torch.cuda.synchronize()
    assert km.march_fused_1d.launches == before + 1
    assert torch.equal(kh[:, 0], phi0) and torch.equal(kbad, pbad)
    if N <= 128:
        assert (kh - ph).abs().max().item() <= 1e-5
        assert torch.equal(kns, pns)
    else:
        # the Laplacian's entries grow as N^2: on a rough field two float32
        # marches differ by more than 1e-5, so both are held to float64
        fwd64, phi0_64, u64 = _problem_1d(cuda, N=N, B=B, T=T,
                                          dtype="float64")
        h64 = fwd64.march_fused_batch(u64, phi0_64)[0]
        err_k = (kh.double() - h64).abs().max().item()
        err_p = (ph.double() - h64).abs().max().item()
        assert err_k <= 2 * err_p + 1e-6, (err_k, err_p)
        assert (kns - pns).abs().max().item() <= fwd.M
    cfg = fwd.config
    kw = dict(tau=cfg.tau, c1=cfg.c1, c2=cfg.c2, kappa=cfg.kappa,
              gamma=cfg.gamma, delta_sep=DELTA_SEP, Lx_len=cfg.Lx,
              newton_tol=cfg.newton_tol, newton_rtol=fwd._rtol,
              newton_max_iter=cfg.newton_max_iter,
              n_trips=cfg.krylov_fixed_iters, stagnation_exit=True)
    args = (fwd.dts, phi0, u, fwd.LT, fwd.VinvT, fwd.VT, fwd.lam[None],
            fwd.wts[None])
    for group in (1, 2, 4):       # B is not a multiple of 2 or 4
        gh, gns, gbad = km.march_fused_1d(*args, group=group, **kw)
        torch.cuda.synchronize()
        assert torch.equal(gh, kh), group
        assert torch.equal(gns, kns) and torch.equal(gbad, kbad), group


def _march1d_kw(fwd):
    cfg = fwd.config
    return dict(tau=cfg.tau, c1=cfg.c1, c2=cfg.c2, kappa=cfg.kappa,
                gamma=cfg.gamma, delta_sep=DELTA_SEP, Lx_len=cfg.Lx,
                newton_tol=cfg.newton_tol, newton_rtol=fwd._rtol,
                newton_max_iter=cfg.newton_max_iter,
                n_trips=cfg.krylov_fixed_iters, stagnation_exit=True)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [64, 128, 512])
def test_march_1d_bits_do_not_depend_on_cluster_members_or_batch(
        cuda, monkeypatch, N):
    """Every cluster size up to the chunk count, several members per
    cluster, and a member marched in a batch of one: the same bits."""
    fwd, phi0, u = _problem_1d(cuda, N=N, B=7, T=0.02)
    args = (fwd.dts, phi0, u, fwd.LT, fwd.VinvT, fwd.VT, fwd.lam[None],
            fwd.wts[None])
    kw = _march1d_kw(fwd)
    ref = km.march_fused_1d(*args, **kw)
    one = km.march_fused_1d(fwd.dts, phi0[3:4].contiguous(),
                            u[3:4].contiguous(), *args[3:], **kw)
    torch.cuda.synchronize()
    for a, b in zip(one, ref):
        assert torch.equal(a, b[3:4])
    nch = max(1, (N + 1) // km.MARCH_1D_CHUNK)
    fitted = km.march1d_geometry
    for C in sorted({1, 2, 3, min(nch, 16)} & set(range(1, min(nch, 16) + 1))):
        for members in (None, 3):
            monkeypatch.setattr(km, "march1d_geometry",
                                lambda n, B, res, cluster=None, members=None,
                                C=C, mb=members: fitted(n, B, res, C,
                                                        members or mb))
            out = km.march_fused_1d(*args, **kw)
            torch.cuda.synchronize()
            for a, b in zip(out, ref):
                assert torch.equal(a, b), (C, members)


@pytest.mark.cuda
def test_march_1d_kernel_flags_a_diverged_member(cuda):
    fwd, phi0, u = _problem_1d(cuda, B=3)
    phi0[1, 7] = float("nan")
    kh, kns, kbad = fwd.march_fused_batch(u, phi0)
    fwd.entries = km.PLAIN
    ph, pns, pbad = fwd.march_fused_batch(u, phi0)
    torch.cuda.synchronize()
    assert kbad.tolist() == [-1.0, 0.0, -1.0] and torch.equal(kbad, pbad)
    assert torch.equal(kns, pns)
    assert (kh[[0, 2]] - ph[[0, 2]]).abs().max().item() <= 1e-5


def _apply_inputs(device, n=33, m=29, B=3, seed=0):
    from vch_tpu_torch.ops.linsolve import make_spectral_op_2d, ops_2d
    op = ops_2d(make_spectral_op_2d(n - 1, m - 1, 1.0 / (n - 1),
                                    1.0 / (m - 1), dtype=torch.float32,
                                    device=device))
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    x = np.linspace(0, 1, n)[:, None]
    y = np.linspace(0, 1, m)[None, :]
    v = f32(np.stack([np.cos(np.pi * (b + 1) * x) * np.cos(np.pi * y)
                      + 0.1 * rng.standard_normal((n, m)) for b in range(B)]))
    d = f32(1.5 + rng.random((B, n, m)))
    return op, v, d


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("n,m", [(33, 29), (65, 65), (129, 129), (257, 257)])
def test_apply_kernels_match_plain(cuda, batched, n, m):
    """The three applies, each on its thread-block cluster, against
    float64, the spectral solve with a shared and a per-member denom; two
    launches give the same bits, and each member of a batch of 4 the bits
    of its own one-member launch."""
    from vch_tpu_torch.ops import solve_kernels as sk
    op, v, d = _apply_inputs(cuda, n=n, m=m, B=4)
    if not batched:
        v, d = v[0].contiguous(), d[0].contiguous()
    denom = 1.0 + op.lam.abs()
    cases = [
        (sk.schur_apply, sk.schur_apply_plain,
         (op.Lx, op.LyT, d, v, 100.0, 5.0, 5e-5)),
        (sk.adjoint_apply, sk.adjoint_apply_plain,
         (op.Lx, op.LyT, d - 2.0, v, 0.05, 5e-3)),
        (sk.spectral_solve, sk.spectral_solve_plain,
         (op.Vx_inv, op.Vy_inv_T, op.Vx, op.VyT, denom, v)),
        (sk.spectral_solve, sk.spectral_solve_plain,
         (op.Vx_inv, op.Vy_inv_T, op.Vx, op.VyT, d * denom, v)),
    ]
    for wrapper, plain, args in cases:
        before = wrapper.launches
        k = wrapper(*args)
        assert wrapper.launches == before + 1
        p = plain(*args)
        p64 = plain(*[a.double() if torch.is_tensor(a) else a for a in args])
        again = wrapper(*args)
        members = [wrapper(*[a[b].contiguous() if torch.is_tensor(a)
                             and a.dim() == 3 else a for a in args])
                   for b in range(v.shape[0] if batched else 0)]
        torch.cuda.synchronize()
        scale = p64.abs().max().item()
        err_k = (k.double() - p64).abs().max().item() / scale
        err_p = (p.double() - p64).abs().max().item() / scale
        assert err_k <= 2 * err_p + 1e-5, (wrapper.__name__, err_k, err_p)
        assert torch.equal(k, again), wrapper.__name__
        for b, one in enumerate(members):
            assert torch.equal(k[b], one), (wrapper.__name__, b)


@pytest.mark.cuda
def test_apply_scalars_as_tensors_and_numbers_agree(cuda):
    """The Schur apply's scalars by value (numbers) and from a device array
    (0-d tensors) give the same bits."""
    from vch_tpu_torch.ops import solve_kernels as sk
    op, v, d = _apply_inputs(cuda, n=65, m=65, B=2)
    num = sk.schur_apply(op.Lx, op.LyT, d, v, 100.0, 5.0, 5e-5)
    ten = sk.schur_apply(op.Lx, op.LyT, d, v,
                         *[torch.tensor(x, device=cuda)
                           for x in (100.0, 5.0, 5e-5)])
    assert torch.equal(num, ten)


@pytest.mark.cuda
def test_raw_schur_solve_on_a_batch_of_8(cuda):
    """The batched launch of the raw Schur solve (B thread-block clusters,
    one member each): the counterpart of vch_tpu's member-tiled
    bicgstab_schur_pallas_batched. Bit for bit its one-CTA oracle, and a
    member does not depend on the batch."""
    from vch_tpu_torch.ops import solve_kernels as sk
    op, v, d = _apply_inputs(cuda, n=33, m=33, B=8)
    inv_dt, tau_dt, hk = 100.0, 5.0, 5e-5
    dbar = d.mean(dim=(-2, -1), keepdim=True)
    denom = inv_dt + hk * op.lam ** 2 - (tau_dt + dbar) * op.lam
    args = (op.Lx, op.LyT, op.Vx_inv, op.Vy_inv_T, op.Vx, op.VyT, denom, d, v,
            inv_dt, tau_dt, hk)
    before = sk.bicgstab_schur.launches
    k = sk.bicgstab_schur(*args, n_iter=4)
    p = sk.bicgstab_schur_plain(*args, n_iter=4)
    p64 = sk.bicgstab_schur_plain(
        *[a.double() if torch.is_tensor(a) else a for a in args], n_iter=4)
    one = sk.bicgstab_schur(*[a[3].contiguous() if torch.is_tensor(a)
                              and a.dim() == 3 else a for a in args],
                            n_iter=4)
    o = sk._bicgstab_schur_cta(*args, n_iter=4)
    torch.cuda.synchronize()
    assert sk.bicgstab_schur.launches == before + 2
    scale = p64.abs().max().item()
    err_k = (k.double() - p64).abs().max().item() / scale
    err_p = (p.double() - p64).abs().max().item() / scale
    assert err_k <= 2 * err_p + 1e-5, (err_k, err_p)
    assert torch.equal(k[3], one)     # a member does not depend on the batch
    assert torch.equal(k, o)          # the batch is its oracle's


@pytest.mark.cuda
@pytest.mark.parametrize("name,n,B,iters", [("nodots", 65, 4, 10),
                                            ("mmonly", 65, 4, 1),
                                            ("mmonly", 129, 2, 4)])
def test_probe_kernels_match_plain(cuda, name, n, B, iters):
    """The cost probes of the raw Schur solve on the probe script's inputs,
    gated against float64 as the solve kernels are (mmonly at n = 65 for one
    link: ten fall below float32's range on these inputs)."""
    from vch_tpu_torch.ops import solve_kernels as sk
    from vch_tpu_torch.probes.diag_kernel_cost import probe_args
    wrapper = getattr(sk, f"schur_{name}")
    plain = getattr(sk, f"schur_{name}_plain")
    args = probe_args(n - 1, B, cuda)
    args64 = probe_args(n - 1, B, cuda, dtype=torch.float64)
    before = wrapper.launches
    k = wrapper(*args, n_iter=iters)
    p = plain(*args, n_iter=iters)
    p64 = plain(*args64, n_iter=iters)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.isfinite(k).all()
    scale = p64.abs().max().item()
    assert scale > 0
    err_k = (k.double() - p64).abs().max().item() / scale
    err_p = (p.double() - p64).abs().max().item() / scale
    assert err_k <= 2 * err_p + 1e-5, (err_k, err_p)


# each cost probe's trips for the bit tests: mmonly's chain of 0.01-scaled
# operators stays inside float32's range for four links at n = 65
_PROBE_TRIPS = {"nodots": 10, "mmonly": 2}


def _probe_pair(name):
    from vch_tpu_torch.ops import solve_kernels as sk
    return getattr(sk, f"schur_{name}"), getattr(sk, f"_schur_{name}_cta")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4, 32])
@pytest.mark.parametrize("n", [17, 65, 129])
@pytest.mark.parametrize("name", list(_PROBE_TRIPS))
def test_schur_probe_equals_its_one_cta_oracle(cuda, name, n, B):
    """Each cost probe on its cluster kernel (one member per thread-block
    cluster, on its launch geometry) bit for bit its one-CTA kernel of
    solve2d.cu on the probe script's inputs; a member of the batch bit for
    bit its one-member launch; one launch counted a call, none of the
    oracle's."""
    from vch_tpu_torch.probes.diag_kernel_cost import probe_args
    wrapper, oracle = _probe_pair(name)
    iters = _PROBE_TRIPS[name]
    args = probe_args(n - 1, B, cuda)
    ref = oracle(*args, n_iter=iters)
    before = (wrapper.launches, oracle.launches)
    out = wrapper(*args, n_iter=iters)
    last = wrapper(*[a[-1:].contiguous() if torch.is_tensor(a)
                     and a.dim() == 3 else a for a in args], n_iter=iters)
    torch.cuda.synchronize()
    assert (wrapper.launches, oracle.launches) == (before[0] + 2, before[1])
    assert torch.isfinite(out).all() and out.abs().max().item() > 0
    assert torch.equal(out, ref)
    assert torch.equal(out[-1:], last)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_PROBE_TRIPS))
def test_schur_probe_bits_at_every_cluster_size(cuda, name):
    """One member at n = 65 on one cluster of every size 1-16 gives the
    one-CTA kernel's bits (products k ascending in one FMA chain, whatever
    the bands; every elementwise pass rounds alike, -fmad=false on both
    sides)."""
    from vch_tpu_torch.probes.diag_kernel_cost import probe_args
    wrapper, oracle = _probe_pair(name)
    iters = _PROBE_TRIPS[name]
    args = probe_args(64, 1, cuda)
    ref = oracle(*args, n_iter=iters)
    differ = [C for C in range(1, 17)
              if not torch.equal(wrapper(*args, n_iter=iters, cluster=C),
                                 ref)]
    torch.cuda.synchronize()
    assert differ == []


@pytest.mark.cuda
def test_schur_probes_refuse_a_member_that_does_not_fit(cuda):
    """A cluster past 16 CTAs, or a member whose ring needs more shared
    memory than a CTA has (a 9 x 7168 grid), raises with its bytes;
    nothing falls back to the one-CTA kernel."""
    from vch_tpu_torch.ops import solve_kernels as sk
    from vch_tpu_torch.probes.diag_kernel_cost import probe_args
    args = probe_args(64, 1, cuda)
    before = (sk._schur_nodots_cta.launches, sk._schur_mmonly_cta.launches)
    for wrapper, _ in map(_probe_pair, _PROBE_TRIPS):
        with pytest.raises(ValueError, match="cluster size"):
            wrapper(*args, n_iter=1, cluster=17)
    z = lambda *s: torch.zeros(s, device=cuda)
    wide = (z(9, 9), z(7168, 7168), z(9, 9), z(7168, 7168), z(9, 9),
            z(7168, 7168), z(1, 9, 7168) + 1, z(1, 9, 7168), z(1, 9, 7168),
            100.0, 5.0, 4.5e-4)
    for wrapper, _ in map(_probe_pair, _PROBE_TRIPS):
        with pytest.raises(ValueError, match="bytes of shared memory"):
            wrapper(*wide, n_iter=1)
    assert (sk._schur_nodots_cta.launches,
            sk._schur_mmonly_cta.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["spectral", "raw"])
def test_scan_marcher_and_sweep_on_the_per_solve_kernels(cuda, variant):
    """The batched per-step marcher and sweep at B = 4 on the per-solve
    kernels (one launch per Newton round and per sweep step for the whole
    batch) against the same path on the plain versions."""
    from vch_tpu_torch.ops import solve_kernels as sk
    cfg = ForwardSolverConfig2D(Nx=16, Ny=16, T=0.05, dtype="float32",
                                newton_tol=2e-4, pallas_variant=variant)
    fwd = ForwardSolver2D(cfg, device=cuda)
    adj = AdjointSolver2D(cfg, device=cuda)
    assert fwd._use_pallas and adj._use_pallas
    _, _, phi0, u, f32 = _problem(cuda, n=17, B=4, T=0.05)
    schur, adjoint = ((sk.bicgstab_schur_spectral, sk.bicgstab_adjoint_spectral)
                      if variant == "spectral"
                      else (sk.bicgstab_schur, sk.bicgstab_adjoint))
    s0, a0 = schur.launches, adjoint.launches
    kh, kns, kbad = fwd._march_batch(u, phi0)
    b = f32(np.array([5.0, 1.0, 0.3, 2.0]))
    zero = torch.zeros_like(kh)
    kr = adj._run_batch(kh, adj.dts, b, 2.0 * b, zero, zero[:, 0])[2]
    torch.cuda.synchronize()
    assert schur.launches > s0 and adjoint.launches == a0 + fwd.M
    fwd.entries = adj.entries = km.PLAIN
    ph, pns, pbad = fwd._march_batch(u, phi0)
    pr = adj._run_batch(kh, adj.dts, b, 2.0 * b, zero, zero[:, 0])[2]
    torch.cuda.synchronize()
    # the sweep's float64 reference: the plain versions with the same trips
    adj64 = AdjointSolver2D(ForwardSolverConfig2D(
        Nx=16, Ny=16, T=0.05, pallas_variant=variant), device=cuda)
    adj64._krylov_fixed, adj64._use_pallas = adj._krylov_fixed, True
    adj64.entries = km.PLAIN
    b64, z64 = b.double(), zero.double()
    r64 = adj64._run_batch(kh.double(), adj64.dts, b64, 2.0 * b64, z64,
                           z64[:, 0])[2]
    torch.cuda.synchronize()
    assert torch.equal(kbad, pbad) and (kbad == -1).all()
    assert (kns - pns).abs().max().item() <= 1
    assert (kh - ph).abs().max().item() <= 1e-5
    assert torch.isfinite(kr).all()
    scale = r64.abs().max().item()
    err_k = (kr.double() - r64).abs().max().item() / scale
    err_p = (pr.double() - r64).abs().max().item() / scale
    assert err_k <= 2 * err_p + 1e-4, (err_k, err_p)


def _f64_gate(k, p, p64, slack=1e-5):
    """The kernel no farther from float64 than twice the plain float32
    version plus `slack`, relative to the float64 scale."""
    scale = p64.abs().max().item()
    err_k = (k.double() - p64).abs().max().item() / scale
    err_p = (p.double() - p64).abs().max().item() / scale
    assert scale > 0 and err_k <= 2 * err_p + slack, (err_k, err_p)


@pytest.mark.cuda
def test_matmul_chain_matches_plain(cuda):
    """The float32 chain on diag_interleave's inputs at n = 65 for every
    interleave width (bit-equal: a member's products sum in one order
    whatever the tiling), and on diag_march_sol's over three links (later
    links fall below float32's range on its 0.01-scaled operator)."""
    from vch_tpu_torch.ops import probe_kernels as pk
    from vch_tpu_torch.probes import diag_interleave, diag_march_sol
    A, X = diag_interleave.inputs(64, 16, cuda)
    A64, X64 = diag_interleave.inputs(64, 16, cuda, torch.float64)
    before = pk.matmul_chain.launches
    outs = [pk.matmul_chain(A, X, K, 40) for K in (1, 2, 4, 8)]
    torch.cuda.synchronize()
    assert pk.matmul_chain.launches == before + 4
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert torch.isfinite(outs[0]).all()
    _f64_gate(outs[0], pk.matmul_chain_plain(A, X, 1, 40),
              pk.matmul_chain_plain(A64, X64, 1, 40))
    a, v = diag_march_sol.chain_inputs(64, cuda)
    a64, v64 = diag_march_sol.chain_inputs(64, cuda, torch.float64)
    _f64_gate(pk.matmul_chain(a, v, 1, 3), pk.matmul_chain_plain(a, v, 1, 3),
              pk.matmul_chain_plain(a64, v64, 1, 3))



@pytest.mark.cuda
def test_matmul_chain_bf16_matches_the_emulated_plain_version(cuda):
    """The tensor-core chain against bf16-rounded operands multiplied in
    float32 (chip_smoke.py states the tolerance: two float32 accumulation
    orders can flip one bf16 rounding, which then carries forward), and the
    same bits for every interleave width."""
    from vch_tpu_torch.ops import probe_kernels as pk
    from vch_tpu_torch.probes import diag_interleave
    A, X = diag_interleave.inputs(64, 16, cuda)
    before = pk.matmul_chain_bf16.launches
    outs = [pk.matmul_chain_bf16(A, X, K, 40) for K in (1, 2, 4, 8)]
    p = pk.matmul_chain_bf16_plain(A, X, 1, 40)
    torch.cuda.synchronize()
    assert pk.matmul_chain_bf16.launches == before + 4
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert torch.isfinite(outs[0]).all()
    for o in outs:
        rel = (o - p).abs().max().item() / p.abs().max().item()
        assert rel <= BF16_CHAIN_TOL, rel


@pytest.mark.cuda
@pytest.mark.parametrize("n", [9, 17, 33, 65, 80])
def test_matmul_chain_bf16_equals_the_wmma_chain(cuda, n):
    """The mma.sync chain (x in shared memory across links) bit for bit
    the wmma chain of probes.cu at every K: the same bf16 roundings and the
    same k-tile order into float32 accumulators. Past n = 80 it refuses."""
    from vch_tpu_torch.ops import probe_kernels as pk
    from vch_tpu_torch.probes import diag_interleave
    A, X = diag_interleave.inputs(n - 1, 8, cuda)
    for K in (1, 2, 4, 8):
        before = pk.matmul_chain_bf16.launches
        out = pk.matmul_chain_bf16(A, X, K, 9)
        assert pk.matmul_chain_bf16.launches == before + 1
        assert torch.equal(out, pk._matmul_chain_bf16_cta(A, X, K, 9)), K
    big = torch.zeros((81, 81), device=cuda)
    with pytest.raises(ValueError, match="n <= 80"):
        pk.matmul_chain_bf16(big, big[None], 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [17, 65, 129])
def test_matmul_chain_equals_its_one_cta_oracle(cuda, n, K):
    """The float32 chain, K members per thread-block cluster, bit for bit
    the one-CTA chain of probes.cu: on its launch geometry at B = 32 and on
    one cluster of every size 1-16 (up to n); one launch counted a call."""
    from vch_tpu_torch.ops import probe_kernels as pk
    from vch_tpu_torch.probes import diag_interleave
    A, X = diag_interleave.inputs(n - 1, 32, cuda)
    ref = pk._matmul_chain_cta(A, X, K, 40)
    before = pk.matmul_chain.launches
    assert torch.equal(pk.matmul_chain(A, X, K, 40), ref)
    sizes = range(1, min(16, n) + 1)
    differ = [C for C in sizes if not torch.equal(
        pk.matmul_chain(A, X[:K], K, 40, cluster=C), ref[:K])]
    torch.cuda.synchronize()
    assert differ == []
    assert pk.matmul_chain.launches == before + 1 + len(sizes)


@pytest.mark.cuda
@pytest.mark.parametrize("bb", [2, 8])
@pytest.mark.parametrize("variant", ["serial_one", "member_mm", "left_mm",
                                     "stacked_mm", "swap", "swap_mm", "gdot",
                                     "member_dot"])
def test_blocked_microbench_matches_plain(cuda, variant, bb):
    """Each primitive on diag_blocked_microbench's inputs at n = 65, 16
    steps, gated against float64; swap bit-equal; gdot and member_dot
    return X unchanged, with the per-member sums as close to float64 as
    the plain version's."""
    from vch_tpu_torch.ops import probe_kernels as pk
    from vch_tpu_torch.probes import diag_blocked_microbench as mb
    C, X = mb.inputs(64, bb, cuda)
    C64, X64 = mb.inputs(64, bb, cuda, torch.float64)
    before = pk.blocked_microbench.launches
    k, ks = pk.blocked_microbench(variant, C, X, bb, 16)
    p, ps = pk.blocked_microbench_plain(variant, C, X, bb, 16)
    p64, ps64 = pk.blocked_microbench_plain(variant, C64, X64, bb, 16)
    torch.cuda.synchronize()
    assert pk.blocked_microbench.launches == before + 1
    assert torch.isfinite(k).all()
    if variant == "swap":
        assert torch.equal(k, p)
    elif variant in ("gdot", "member_dot"):
        assert torch.equal(k, X)
        _f64_gate(ks, ps, ps64)
    else:
        _f64_gate(k, p, p64)
        if variant == "stacked_mm":
            # one stacked product sums each member as the per-member one does
            assert torch.equal(
                k, pk.blocked_microbench("member_mm", C, X, bb, 16)[0])


_MICRO_VARIANTS = ["serial_one", "member_mm", "left_mm", "stacked_mm", "swap",
                   "swap_mm", "gdot", "member_dot"]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", _MICRO_VARIANTS)
@pytest.mark.parametrize("bb", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [17, 65])
def test_blocked_microbench_equals_its_one_cta_oracle(cuda, n, bb, variant):
    """The microbench on one thread-block cluster (its launch geometry: 16
    CTAs at these n) bit for bit the one-CTA kernel of probes.cu, out and
    sums, 16 steps; one launch counted a call, none of the oracle's."""
    from vch_tpu_torch.ops import probe_kernels as pk
    from vch_tpu_torch.probes import diag_blocked_microbench as mb
    C, X = mb.inputs(n - 1, bb, cuda)
    ref = pk._blocked_microbench_cta(variant, C, X, bb, 16)
    before = (pk.blocked_microbench.launches,
              pk._blocked_microbench_cta.launches)
    out, sums = pk.blocked_microbench(variant, C, X, bb, 16)
    torch.cuda.synchronize()
    assert (pk.blocked_microbench.launches,
            pk._blocked_microbench_cta.launches) == (before[0] + 1, before[1])
    assert pk.probe_geometry("micro", n, bb, bb, cuda.index or 0).cluster == 16
    assert torch.equal(out, ref[0]) and torch.equal(sums, ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", _MICRO_VARIANTS)
@pytest.mark.parametrize("bb", [1, 8])
def test_blocked_microbench_bits_at_every_cluster_size(cuda, bb, variant):
    """Every cluster size 1-16 at n = 65 gives the one-CTA kernel's bits
    (products sum k ascending in one FMA chain, reductions in block_sum's
    order, whatever the bands); with one member the reductions' eight warp
    pairs lie on ranks w % C. The stacked product equals the per-member one
    at every size."""
    from vch_tpu_torch.ops import probe_kernels as pk
    from vch_tpu_torch.probes import diag_blocked_microbench as mb
    C, X = mb.inputs(64, bb, cuda)
    ref = pk._blocked_microbench_cta(variant, C, X, bb, 16)
    differ = []
    for c in range(1, 17):
        out, sums = pk.blocked_microbench(variant, C, X, bb, 16, cluster=c)
        if not (torch.equal(out, ref[0]) and torch.equal(sums, ref[1])):
            differ.append(c)
        if variant == "stacked_mm":
            assert torch.equal(out, pk.blocked_microbench(
                "member_mm", C, X, bb, 16, cluster=c)[0]), c
    torch.cuda.synchronize()
    assert differ == []


@pytest.mark.cuda
def test_blocked_microbench_refuses_a_block_that_does_not_fit(cuda):
    """A cluster past 16 CTAs, or a block whose ring needs more shared
    memory than a CTA has, raises with its bytes; nothing falls back to
    the one-CTA kernel."""
    from vch_tpu_torch.ops import probe_kernels as pk
    C = torch.zeros((65, 65), device=cuda)
    X = torch.zeros((8 * 65, 65), device=cuda)
    before = pk._blocked_microbench_cta.launches
    with pytest.raises(ValueError, match="cluster size"):
        pk.blocked_microbench("stacked_mm", C, X, 8, 1, cluster=17)
    big = torch.zeros((1000, 1000), device=cuda)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        pk.blocked_microbench("swap", big, big.repeat(8, 1), 8, 1)
    assert pk._blocked_microbench_cta.launches == before


@pytest.mark.cuda
def test_while_probe_matches_plain_and_reference(cuda):
    """The entry point's own gates (the script's: max |diff| < 1e-4 and
    trip counts equal, against the float64 loop and the plain version);
    a field whose carry does not fit shared memory is refused."""
    from vch_tpu_torch.ops import probe_kernels as pk
    from vch_tpu_torch.probes import probe_while
    before = pk.while_probe.launches
    res = probe_while.run(B=3, M=3, n=65, reps=1, device=cuda)
    assert pk.while_probe.launches > before
    assert res["ns"] == res["ns_expected"] and res["ns"][0] > 3
    with pytest.raises(ValueError, match="registers: n\\^2 = 10404 exceeds"):
        pk.while_probe(torch.zeros((1, 102, 102), device=cuda), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 3])
@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("n", [9, 17, 65, 101])
def test_while_fused_is_bit_for_bit_its_one_cta_oracle(cuda, n, B, M):
    """Row 19 (csrc/while_fused.cu, phi in registers, one reduction a trip)
    against the one-CTA kernel of probes.cu, phi and ns bit for bit, with a
    NaN-seeded member at B = 3 (NaN at the same places, ns = 50 M); the
    finite members against the plain version (phi within 1e-6 relative, ns
    equal) and the float64 reference (the script's 1e-4); one launch each."""
    from vch_tpu_torch.ops import probe_kernels as pk
    from vch_tpu_torch.probes import probe_while
    x = probe_while.inputs(B, n, cuda)
    if B == 3:
        x[2, n // 2, n // 3] = float("nan")
    before = (pk.while_probe.launches, pk._while_probe_cta.launches)
    out, ns = pk.while_probe(x, M)
    ref, ns_ref = pk._while_probe_cta(x, M)
    torch.cuda.synchronize()
    assert (pk.while_probe.launches, pk._while_probe_cta.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(ns, ns_ref)
    fin = min(B, 2)
    if B == 3:
        assert int(ns[2]) == 50 * M
        assert torch.equal(torch.isnan(out[2]), torch.isnan(x[2]))
    plain, ns_plain = pk.while_probe_plain(x[:fin], M)
    assert torch.equal(ns[:fin], ns_plain)
    assert ((out[:fin] - plain).abs().max()
            <= 1e-6 * plain.abs().max()), n
    ref64, ns64 = probe_while.reference(x[:fin].cpu().numpy(), M)
    assert np.array_equal(ns[:fin].cpu().numpy(), ns64)
    assert np.abs(out[:fin].cpu().numpy() - ref64).max() < probe_while.TOL


@pytest.mark.cuda
def test_while_fused_refuses_a_failed_launch(cuda, monkeypatch):
    """A launch the C entry refuses raises, counted, with no fallback to the
    plain version or to the oracle; a float64 field is refused before any
    launch."""
    from vch_tpu_torch.ops import _build
    from vch_tpu_torch.ops import probe_kernels as pk
    lib = _build.load()

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def vch_while_fused(*args):
            return 1                      # cudaErrorInvalidValue

    x = torch.ones((1, 9, 9), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        pk.while_probe(x.double(), 1)
    monkeypatch.setattr(_build, "load", lambda: Refusing())
    before = (pk.while_probe.launches, pk._while_probe_cta.launches)
    with pytest.raises(RuntimeError, match="while_probe launch failed"):
        pk.while_probe(x, 1)
    assert (pk.while_probe.launches, pk._while_probe_cta.launches) == (
        before[0] + 1, before[1])
