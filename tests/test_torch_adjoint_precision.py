"""Port parity for `adjoint_solve_precision`: the fused 2D sweep's Krylov
operator (apply_At's four products) at "bf16x3", against vch_tpu's Pallas
sweeps in interpret mode at solve_prec="bf16x3" on the same seeded numpy
inputs (test_torch_march.py's).

Tolerances, each beside its case:
  - the three plain sweeps (whole, blocked at 2 and 4, segment) against
    vch_tpu's at "bf16x3": 1e-10 relative in float64 (both sides split and
    multiply alike; only summation order differs) and 1e-4 in float32
    (test_torch_march.py's r gate); the float64 cases tell "bf16x3" from
    "highest", which differ by ~5e-7 relative there;
  - every other precision gives the "highest" sweep bit for bit (vch_tpu
    offers no one-pass sweep);
  - AdjointSolver2D's r against vch_tpu's `adjoint_fused_batch`: 1e-4
    relative in float32.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vch_tpu.config import ForwardSolverConfig2D as JaxConfig2D
from vch_tpu.models.adjoint2d import AdjointSolver2D as JaxAdjoint2D
from vch_tpu.ops import pallas_march as pm

from test_torch_march import (N, PHYS, T, _adjoint_inputs, _jax_ops,
                              _torch_ops)
from vch_tpu_torch.config import ForwardSolverConfig2D
from vch_tpu_torch.models.adjoint2d import AdjointSolver2D
from vch_tpu_torch.ops import march as tm
from vch_tpu_torch.ops.march import (BLOCKED_SMEM_LIMIT, bf16_staging,
                                     blocked_geometry)
from vch_tpu_torch.parallel.batch import (BatchedProblem2D,
                                          LowMemBatchedProblem2D, sweep_2d)

torch.set_num_threads(2)

TOL = {"float64": 1e-10, "float32": 1e-4}
KW = dict(tau=PHYS["tau"], gamma=PHYS["gamma"], c1=PHYS["c1"],
          c2=PHYS["c2"], n_trips=5)
H100_SMS = 132


def _rel(a, b):
    b = np.asarray(b)
    return np.abs(np.asarray(a) - b).max() / np.abs(b).max()


def _inputs(dtype_name, members=None):
    """test_torch_march.py's adjoint inputs, cut or tiled to `members`."""
    np_dt, op_np, dts, hist, phi_Q, phi_T, b1, b2 = _adjoint_inputs(
        dtype_name)
    if members is not None:
        pick = np.arange(members) % hist.shape[0]
        hist, phi_Q, phi_T = hist[pick], phi_Q[pick], phi_T[pick]
        b1, b2 = b1[pick] * (1 + 0.1 * np.arange(members)), b2[pick]
    tdt = torch.float64 if np_dt == np.float64 else torch.float32
    j = lambda a: jnp.asarray(a, np_dt)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=tdt)
    return op_np, np_dt, tdt, j, t, (dts, hist, phi_Q, phi_T, b1, b2)


# ---- the three plain sweeps against vch_tpu at "bf16x3" --------------------

@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
def test_whole_sweep_matches_vch_tpu_bf16x3(dtype_name):
    op_np, np_dt, tdt, j, t, data = _inputs(dtype_name)
    jr = pm.adjoint_fused_2d(*map(j, data), *_jax_ops(op_np, np_dt),
                             interpret=True, solve_prec="bf16x3", **KW)
    before = tm.adjoint_fused_2d.launches
    tr = tm.adjoint_fused_2d(*map(t, data), *_torch_ops(op_np, tdt),
                             solve_prec="bf16x3", **KW)
    assert tm.adjoint_fused_2d.launches == before     # the plain version
    assert (tr[:, -1] == 0).all()
    assert _rel(tr.numpy(), jr) <= TOL[dtype_name]
    # the knob moved the result: "highest" lies ~5e-7 away in float64
    if dtype_name == "float64":
        high = tm.adjoint_fused_2d(*map(t, data), *_torch_ops(op_np, tdt),
                                   **KW)
        assert _rel(high.numpy(), jr) > 1e-8


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
@pytest.mark.parametrize("block_b", [2, 4])
def test_blocked_sweep_matches_vch_tpu_bf16x3(dtype_name, block_b):
    op_np, np_dt, tdt, j, t, data = _inputs(dtype_name, members=4)
    jr = pm.adjoint_fused_2d_blocked(*map(j, data), *_jax_ops(op_np, np_dt),
                                     interpret=True, solve_prec="bf16x3",
                                     block_b=block_b, **KW)
    tr = tm.adjoint_fused_2d_blocked(*map(t, data), *_torch_ops(op_np, tdt),
                                     solve_prec="bf16x3", block_b=block_b,
                                     **KW)
    assert _rel(tr.numpy(), jr) <= TOL[dtype_name]


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
def test_segment_sweep_matches_vch_tpu_bf16x3(dtype_name):
    """A K = 3 segment of the last levels from a seeded (p, q, r) carry:
    r of its levels and the carry out."""
    op_np, np_dt, tdt, j, t, data = _inputs(dtype_name)
    dts, hist, phi_Q, _, b1, _ = data
    K, M = 3, len(dts)
    rng = np.random.default_rng(11)
    carry = [s * rng.standard_normal(hist[:, 0].shape)
             for s in (0.5, 2.0, 0.1)]
    sl = slice(M - K, M + 1)
    seg = (dts[M - K:], hist[:, sl], phi_Q[:, sl], *carry, b1)
    jout = pm.adjoint_fused_2d_segment(*map(j, seg), *_jax_ops(op_np, np_dt),
                                       interpret=True, solve_prec="bf16x3",
                                       **KW)
    tout = tm.adjoint_fused_2d_segment(*map(t, seg), *_torch_ops(op_np, tdt),
                                       solve_prec="bf16x3", **KW)
    assert tout[0].shape == (hist.shape[0], K, N + 1, N + 1)
    for a, b in zip(tout, jout):
        assert _rel(a.numpy(), b) <= TOL[dtype_name]


@pytest.mark.parametrize("prec", [None, "highest", "default", "high"])
def test_other_precisions_are_the_highest_sweep(prec):
    """vch_tpu's sweep runs "bf16x3" or full precision (pallas_march.py:677,
    no one-pass form): every other value is "highest", bit for bit, on the
    whole, blocked and segment sweeps."""
    assert tm.sweep_passes(prec) == 0 and tm.sweep_passes("bf16x3") == 3
    op_np, np_dt, tdt, j, t, data = _inputs("float64", members=2)
    ops = _torch_ops(op_np, tdt)
    args = (*map(t, data), *ops)
    for fn, kw in ((tm.adjoint_fused_2d, {}),
                   (tm.adjoint_fused_2d_blocked, {"block_b": 2})):
        assert torch.equal(fn(*args, solve_prec=prec, **kw, **KW),
                           fn(*args, **kw, **KW))
    dts, hist, phi_Q, _, b1, _ = map(t, data)
    seg = (dts[-2:], hist[:, -3:], phi_Q[:, -3:], hist[:, -1], hist[:, -2],
           hist[:, -3], b1)
    for a, b in zip(tm.adjoint_fused_2d_segment(*seg, *ops, solve_prec=prec,
                                                **KW),
                    tm.adjoint_fused_2d_segment(*seg, *ops, **KW)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["bf16x3", "default", "high"])
def test_one_cta_oracles_refuse_bf16x3(mode):
    """The one-CTA sweep oracles, as the march's, take "highest" or None
    only: any other mode raises before anything runs."""
    op_np, np_dt, tdt, j, t, data = _inputs("float32")
    args = (*map(t, data), *_torch_ops(op_np, tdt))
    with pytest.raises(ValueError, match="full float32 only"):
        tm._adjoint_fused_2d_cta(*args, solve_prec=mode, **KW)
    dts, hist, phi_Q, _, b1, _ = map(t, data)
    seg = (dts[-1:], hist[:, -2:], phi_Q[:, -2:], hist[:, -1], hist[:, -1],
           hist[:, -1], b1)
    with pytest.raises(ValueError, match="full float32 only"):
        tm._adjoint_fused_2d_segment_cta(*seg, *_torch_ops(op_np, tdt),
                                         solve_prec=mode, **KW)
    # "highest" still runs there (the plain version on CPU tensors)
    assert tm._adjoint_fused_2d_cta(*args, solve_prec="highest",
                                    **KW).shape == data[1].shape


# ---- the model -------------------------------------------------------------

class _Spy:
    """Records each sweep entry a solver calls with its solve precision."""

    def __init__(self):
        self.calls = []

    def entries(self):
        def wrap(fn):
            def call(*a, **k):
                self.calls.append((fn.__name__,
                                   k.get("solve_prec", "highest")))
                return fn(*a, **k)
            return call
        return tm.KERNELS._replace(
            adjoint=wrap(tm.adjoint_fused_2d),
            adjoint_blocked=wrap(tm.adjoint_fused_2d_blocked),
            adjoint_segment=wrap(tm.adjoint_fused_2d_segment))


@pytest.mark.parametrize("batch,block,entry", [
    (3, 0, "adjoint_fused_2d"), (4, 2, "adjoint_fused_2d_blocked")])
def test_adjoint_solver_honours_the_knob(batch, block, entry):
    """AdjointSolver2D at adjoint_solve_precision="bf16x3" hands "bf16x3" to
    the whole and the blocked sweep (vch_tpu/models/adjoint2d.py:195, :202),
    and its float32 r lies within 1e-4 of vch_tpu's."""
    kw = dict(Nx=N, Ny=N, T=T, dtype="float32", fused_march_block=block,
              adjoint_solve_precision="bf16x3")
    _, np_dt, tdt, j, t, data = _inputs("float32", members=batch)
    dts, hist, phi_Q, phi_T, b1, b2 = data
    jr = JaxAdjoint2D(JaxConfig2D(**kw)).adjoint_fused_batch(
        j(hist), j(dts), j(b1), j(b2), j(phi_Q), j(phi_T), interpret=True)
    adj = AdjointSolver2D(ForwardSolverConfig2D(**kw), device="cpu")
    spy = _Spy()
    adj.entries = spy.entries()
    tr = adj.adjoint_fused_batch(t(hist), t(b1), t(b2), t(phi_Q), t(phi_T))
    assert spy.calls == [(entry, "bf16x3")]
    assert _rel(tr.numpy(), jr) <= 1e-4


def test_batched_problems_route_the_knob():
    """Through the batched problems: the full-memory problem's sweep gets
    "bf16x3"; the low-memory problem's segment sweep gets "highest", as
    vch_tpu's low-memory path passes no precision (lowmem.py:541)."""
    cfg = ForwardSolverConfig2D(Nx=N, Ny=N, T=T, dtype="float32",
                                newton_tol=2e-4,
                                adjoint_solve_precision="bf16x3")
    sc = sweep_2d(cfg, b3_values=[1e-4, 3e-4], kappa_values=[0.0, 1e-3])
    full = BatchedProblem2D(cfg, device="cpu", fused_march=True)
    low = LowMemBatchedProblem2D(cfg, K=2, device="cpu", fused_march=True)
    seen = {}
    for name, prob in (("full", full), ("low", low)):
        spy = _Spy()
        prob.adj.entries = spy.entries()
        out = prob.run(sc, max_iter=1, verbose=False)
        assert np.isfinite(out["cost_history"]).all()
        seen[name] = set(spy.calls)
    assert seen["full"] == {("adjoint_fused_2d", "bf16x3")}
    assert seen["low"] == {("adjoint_fused_2d_segment", "highest")}


# ---- the bf16 sweep's geometry ---------------------------------------------

@pytest.mark.parametrize("n", [65, 129, 257])
@pytest.mark.parametrize("members", [1, 2, 4, 8])
def test_sweep_geometry_fits_at_three_passes(n, members):
    """The bf16 sweep's shared memory is the larger of the sweep's ring and
    product16's staging at three passes, within the limit, with the ring
    and cluster split of the float32 sweep."""
    g = blocked_geometry(n, n, 4 * members, H100_SMS, members=members,
                         kernel="sweep", solve_passes=3)
    ring = blocked_geometry(n, n, 4 * members, H100_SMS, members=members,
                            kernel="sweep")
    staging = bf16_staging(n, n, members, g.rows_max, 3)
    assert staging is not None
    assert g.smem_bytes == max(ring.smem_bytes, staging[2])
    assert g.smem_bytes <= BLOCKED_SMEM_LIMIT
    assert g._replace(smem_bytes=ring.smem_bytes, solve_passes=0) == ring


# ---- vch_tpu's parameter names ---------------------------------------------

# vch_tpu parameters the port's wrappers do not take: `interpret` runs a
# Pallas kernel on the host (the port routes by the tensors' device)
ALLOWED = {"interpret"}
GUARDED = ("march_fused_2d", "march_fused_2d_segment",
           "march_fused_2d_blocked", "adjoint_fused_2d",
           "adjoint_fused_2d_segment", "adjoint_fused_2d_blocked")


def test_vch_tpu_parameter_names_are_the_ports():
    """Every parameter of vch_tpu's six 2D march and sweep functions is one
    of the port wrapper's, save ALLOWED; an entry of ALLOWED that no
    function misses any more is stale and fails too."""
    missing = {}
    for name in GUARDED:
        theirs = inspect.signature(getattr(pm, name)).parameters
        ours = inspect.signature(getattr(tm, name)).parameters
        for p in set(theirs) - set(ours):
            missing.setdefault(p, []).append(name)
    assert set(missing) == ALLOWED, missing
