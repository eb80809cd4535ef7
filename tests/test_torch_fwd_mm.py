"""Port parity for `fwd_mm`: the fused 2D march's other products (the
Laplacians of the residuals, mu0, lap_mu_old, lap_phi_old and Kpp dphi;
the right-hand side's transform to_s and dphi's transform back from_s) at
vch_tpu's "bf16x3", against vch_tpu's Pallas marches in interpret mode on
the same seeded numpy inputs (test_torch_solve_precision.py's, with the
stagnation exit on and at most 30 Newton iterations a step: its own
float64 settings run every step to 500 iterations, since the bf16x3
residual cannot reach newton_tol 1e-6).

The bf16x3 residual's noise floor lies near 1e-3 on these inputs (583 at
a step's start, ~4e-3 after one Newton iteration, then 0.8-1.7e-3 at
random). A Newton loop left to stop at that floor (the stagnation exit)
is chaotic in float64: vch_tpu's own march, given phi0 times 1 + 1e-15,
moves 4.7e-8 and changes a member's Newton count (the segment march 2.9e-8,
37 solves against 33). So the float64 cases stop Newton at newton_tol 1e-2,
above the floor: one solve a step, every decision taken with a margin.
There the bf16x3 march lies ~8e-7 from the "highest" one.

Tolerances, each beside its case:
  - the three plain marches (whole B = 3, blocked B = 8 in blocks of 8, 4
    and 2, segment B = 3) against vch_tpu's at fwd_mm "bf16x3", solve_prec
    "highest" (apply_S inherits the three passes) and "bf16x3": 1e-10
    relative in float64 with Newton counts and first_bad equal (both sides
    split and multiply alike; only summation order differs), 1e-4 in
    float32 at _setup's newton_tol 2e-4, the floor's chaos included (Newton
    counts, which it moves, are not compared there);
  - fwd_mm "default", "highest" and None give the same march bit for bit,
    as vch_tpu's do (its `_make_mm` knows only "bf16x3").
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vch_tpu.ops.pallas_march import march_fused_2d as jax_march
from vch_tpu.ops.pallas_march import \
    march_fused_2d_blocked as jax_march_blocked
from vch_tpu.ops.pallas_march import \
    march_fused_2d_segment as jax_march_segment

from test_torch_solve_precision import (DTYPES, _jax_ops, _segment_carry,
                                        _setup, _torch_ops)
from vch_tpu_torch.ops import march as km
from vch_tpu_torch.ops.march import (BLOCKED_SMEM_LIMIT, bf16_staging,
                                     blocked_geometry)

torch.set_num_threads(2)

TOL = {"float64": 1e-10, "float32": 1e-4}
F64_NEWTON_TOL = 1e-2
H100_SMS = 132


def _inputs(dtype_name, B):
    """_setup's inputs with the stagnation exit on and newton_max_iter 30
    (float64: newton_tol F64_NEWTON_TOL, above the bf16x3 floor), with
    numpy (j) and torch (t) converters of its dtype."""
    np_dt, op_np, wts, dts, phi0, u, kw = _setup(dtype_name, B)
    kw = dict(kw, stagnation_exit=True, newton_max_iter=30)
    if dtype_name == "float64":
        kw["newton_tol"] = F64_NEWTON_TOL
    tdt = DTYPES[dtype_name][1]
    j = lambda a: jnp.asarray(a, np_dt)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=tdt)
    return op_np, wts, dts, phi0, u, kw, j, t, tdt


def _march_pair(form, dtype_name, solve_prec, fwd_mm="bf16x3", block_b=8):
    """(vch_tpu's outputs, the port's) of one form on the same inputs: the
    history (the segment: hist, phi_f, mu_f, w_f), then nsolve and
    first_bad."""
    B = 8 if form == "blocked" else 3
    op_np, wts, dts, phi0, u, kw, j, t, tdt = _inputs(dtype_name, B)
    jops, tops = _jax_ops(op_np, j(0).dtype), _torch_ops(op_np, tdt)
    prec = dict(solve_prec=solve_prec, fwd_mm=fwd_mm)
    if form == "segment":
        mu0, w0 = _segment_carry(op_np, phi0, kw)
        m0 = np.einsum("bij,ij->b", phi0, wts)
        jout = jax_march_segment(j(dts), j(phi0), j(mu0), j(w0), j(m0), j(u),
                                 *jops, j(wts), interpret=True, **prec, **kw)
        tout = km.march_fused_2d_segment(t(dts), t(phi0), t(mu0), t(w0),
                                         t(m0), t(u), *tops, t(wts), **prec,
                                         **kw)
        return jout, tout
    if form == "blocked":
        jout = jax_march_blocked(j(dts), j(phi0), j(u), *jops, j(wts),
                                 interpret=True, block_b=block_b, **prec,
                                 **kw)
        tout = km.march_fused_2d_blocked(t(dts), t(phi0), t(u), *tops,
                                         t(wts), block_b=block_b, **prec,
                                         **kw)
        return jout, tout
    jout = jax_march(j(dts), j(phi0), j(u), *jops, j(wts), interpret=True,
                     **prec, **kw)
    tout = km.march_fused_2d(t(dts), t(phi0), t(u), *tops, t(wts), **prec,
                             **kw)
    return jout, tout


def _fields(form, out):
    return out[:4] if form == "segment" else out[:1]


@pytest.mark.parametrize("form,block_b", [("whole", None), ("blocked", 8),
                                          ("blocked", 4), ("blocked", 2),
                                          ("segment", None)])
@pytest.mark.parametrize("solve_prec", ["highest", "bf16x3"])
@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
def test_plain_marches_match_vch_tpu_at_fwd_bf16x3(form, block_b, solve_prec,
                                                   dtype_name):
    jout, tout = _march_pair(form, dtype_name, solve_prec,
                             block_b=block_b or 8)
    for ja, ta in zip(_fields(form, jout), _fields(form, tout)):
        ja, ta = np.asarray(ja), ta.numpy()
        assert ta.shape == ja.shape and np.isfinite(ta).all()
        if dtype_name == "float64":
            assert np.abs(ta - ja).max() <= TOL[dtype_name] * np.abs(ja).max()
        else:
            assert np.abs(ta - ja).max() <= TOL[dtype_name]
    assert (tout[-1].numpy() == -1).all() and (tout[-2].numpy() > 0).all()
    if dtype_name == "float64":
        np.testing.assert_array_equal(tout[-2].numpy(), np.asarray(jout[-2]))
        np.testing.assert_array_equal(tout[-1].numpy(), np.asarray(jout[-1]))


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
def test_fwd_bf16x3_is_not_the_full_precision_march(dtype_name):
    """The bf16x3 products move the march: its history differs from the
    "highest" march's, and in float64 by more than the parity tolerance
    above (the fault: the port's wrappers took no fwd_mm)."""
    _, fwd = _march_pair("whole", dtype_name, "highest")
    _, full = _march_pair("whole", dtype_name, "highest", fwd_mm="highest")
    gap = (fwd[0] - full[0]).abs().max().item()
    assert gap > 1e3 * TOL["float64"] * full[0].abs().max().item()


@pytest.mark.parametrize("form", ["whole", "blocked", "segment"])
def test_full_precision_fwd_modes_are_bit_identical(form):
    """fwd_mm "default", "highest" and None give the same march bit for
    bit in the port, as "default" and "highest" do in vch_tpu (float32,
    solve_prec "bf16x3", vch_tpu's default)."""
    runs = {m: _march_pair(form, "float32", "bf16x3", fwd_mm=m)
            for m in ("highest", "default", None)}
    ref_j, ref_t = runs["highest"]
    for mode, (jout, tout) in runs.items():
        for a, b in zip(tout, ref_t):
            assert torch.equal(a, b), mode
        if mode is not None:
            for a, b in zip(jout, ref_j):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("solve_prec,fwd_mm,krylov,fwd", [
    ("highest", "highest", 0, 0), ("highest", "bf16x3", 3, 3),
    ("bf16x3", "bf16x3", 3, 3), ("bf16x3", "highest", 3, 0),
    ("default", "bf16x3", 1, 3), ("default", "highest", 1, 0),
    (None, "bf16x3", 3, 3), ("high", "bf16x3", 3, 3),
    ("bf16x3", "default", 3, 0), ("highest", None, 0, 0)])
def test_pass_mapping(solve_prec, fwd_mm, krylov, fwd):
    """apply_S's passes are the solve precision's, or the march's own
    where that has none (pallas_march.py:207-214); the march's other
    products take three passes at "bf16x3" and none at any other fwd_mm,
    "default" included (pallas_march.py:54)."""
    assert km.krylov_passes(solve_prec, fwd_mm) == krylov
    assert km.fwd_passes(fwd_mm) == fwd


def test_default_solve_with_fwd_bf16x3_routes_one_and_three_passes(
        monkeypatch):
    """At solve_prec "default" with fwd_mm "bf16x3" the plain march builds
    apply_S's product at one pass and every other product at three (vch_tpu
    on the CPU computes "default" as "highest", so this is held on the
    port's routing, as test_default_mode_is_one_bf16_pass does), and the
    march differs from both neighbours: one pass everywhere is not it, nor
    three in apply_S."""
    seen = []
    real = km._passes_mm

    def spy(dtype, passes):
        seen.append(passes)
        return real(dtype, passes)

    monkeypatch.setattr(km, "_passes_mm", spy)
    _, mixed = _march_pair("whole", "float32", "default")
    assert seen and set(seen[0::2]) == {3} and set(seen[1::2]) == {1}
    monkeypatch.setattr(km, "_passes_mm", real)
    _, three = _march_pair("whole", "float32", "bf16x3")
    _, one = _march_pair("whole", "float32", "default", fwd_mm="highest")
    assert torch.isfinite(mixed[0]).all() and (mixed[-1] == -1).all()
    assert not torch.equal(mixed[0], three[0])
    assert not torch.equal(mixed[0], one[0])


@pytest.mark.parametrize("oracle", ["_march_fused_2d_cta",
                                    "_march_fused_2d_segment_cta"])
def test_one_cta_oracles_refuse_fwd_bf16x3(oracle):
    """The one-CTA oracles compute full float32 only: fwd_mm "bf16x3"
    raises, on any device, before anything runs; the full-precision modes
    run."""
    op_np, wts, dts, phi0, u, kw, j, t, tdt = _inputs("float32", 1)
    ops = (*_torch_ops(op_np, torch.float32), t(wts))
    args = ((t(dts), t(phi0), t(u)) + ops if oracle == "_march_fused_2d_cta"
            else (t(dts), t(phi0), t(phi0), t(phi0), t(phi0.sum((1, 2))),
                  t(u)) + ops)
    fn = getattr(km, oracle)
    before = fn.launches
    with pytest.raises(ValueError, match="full float32"):
        fn(*args, fwd_mm="bf16x3", **kw)
    assert fn.launches == before
    for ok in ("highest", "default", None):
        assert fn(*args, fwd_mm=ok, **kw)[0].shape[0] == 1


@pytest.mark.parametrize("n", [65, 129, 257])
@pytest.mark.parametrize("members", [1, 2, 4, 8])
@pytest.mark.parametrize("krylov", [1, 3])
def test_fwd_geometry_stages_three_passes(n, members, krylov):
    """At fwd_mm "bf16x3" product16's staging is sized for three passes
    whatever apply_S's passes (one at solve_prec "default"): the shared
    memory is the larger of the ring and the three-pass staging, within
    the limit, with the ring and cluster split of the float32 march."""
    g = blocked_geometry(n, n, 4 * members, H100_SMS, members=members,
                         solve_passes=krylov, fwd_passes=3)
    ring = blocked_geometry(n, n, 4 * members, H100_SMS, members=members)
    staging = bf16_staging(n, n, members, g.rows_max, 3)
    assert g.smem_bytes == max(ring.smem_bytes, staging[2])
    assert g.smem_bytes <= BLOCKED_SMEM_LIMIT
    assert g._replace(smem_bytes=ring.smem_bytes, solve_passes=0,
                      fwd_passes=0) == ring
    if krylov == 1:
        one = blocked_geometry(n, n, 4 * members, H100_SMS, members=members,
                               solve_passes=1)
        assert one.smem_bytes <= g.smem_bytes


def test_only_the_march_takes_fwd_passes():
    """The cluster march takes fwd passes, 3 (or 1, a test's control, its
    staging then at apply_S's passes); the sweep and other counts raise."""
    with pytest.raises(ValueError, match="fwd passes"):
        blocked_geometry(65, 65, 8, H100_SMS, members=8, kernel="sweep",
                         solve_passes=3, fwd_passes=3)
    with pytest.raises(ValueError, match="fwd passes"):
        blocked_geometry(65, 65, 8, H100_SMS, members=8, solve_passes=3,
                         fwd_passes=2)
    for krylov in (1, 3):
        control = blocked_geometry(65, 65, 8, H100_SMS, members=8,
                                   solve_passes=krylov, fwd_passes=1)
        assert control.smem_bytes == blocked_geometry(
            65, 65, 8, H100_SMS, members=8, solve_passes=krylov).smem_bytes


@pytest.mark.parametrize("n,m", [(17, 17), (33, 29)])
def test_fwd_operator_fragments_follow_the_four(n, m):
    """At fwd_mm "bf16x3" the fragment buffer holds apply_S's four copies
    as before (the sweep's offsets stay), then Lx's (the LEFT product's
    rows) and Ly = LyT^T's (the RIGHT product's), laid out as the four are
    (test_torch_bf16_geometry.py checks that layout lane by lane)."""
    rng = np.random.default_rng(1)
    mk = lambda r: torch.tensor(rng.standard_normal((r, r)),
                                dtype=torch.float32)
    Vx, Vxi, VyT, VyiT, Lx, LyT = mk(n), mk(n), mk(m), mk(m), mk(n), mk(m)
    four = km._bf16_operators(Vx, Vxi, VyT, VyiT)
    six = km._bf16_operators(Vx, Vxi, VyT, VyiT, Lx, LyT)
    ln = (n + 8) * -(-n // 16) * 32
    lm = (m + 8) * -(-m // 16) * 32
    assert four.numel() == 2 * ln + 2 * lm and six.numel() == 3 * ln + 3 * lm
    assert torch.equal(six[:four.numel()], four)
    laps = km._bf16_operators(Lx, Lx, LyT, LyT)
    assert torch.equal(six[four.numel():four.numel() + ln], laps[:ln])
    assert torch.equal(six[four.numel() + ln:],
                       laps[2 * ln:2 * ln + lm])
    ops = (Lx, LyT, Vxi, VyiT, Vx, VyT)
    assert torch.equal(km._solve_operands(3, ops, fwd=3)[0], six)
    assert torch.equal(km._solve_operands(1, ops)[0], four)
