"""The two cost probes of the raw Schur solve
(ops.solve_kernels.schur_nodots and schur_mmonly, the counterparts of
scripts/diag_kernel_cost.py:131 and :176) and their entry point, on the
CPU.

The plain versions are held against the same recurrences built from
vch_tpu's operator kernels in interpret mode (schur_apply_pallas,
pallas_kernels.py:101, for S and spectral_solve_pallas, :478, for M) on the
script's seeded inputs: to 1e-10 of their scale in float64 and 1e-5 in
float32 (sums in another order). Three trips / links at a 17 x 17 grid keep
mmonly's chain (each link scales by ~1e-4 on these 0.01-scaled operators)
inside float32's range.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vch_tpu.ops import pallas_kernels as pk

from vch_tpu_torch.ops import march as km
from vch_tpu_torch.ops import solve_kernels as sk
from vch_tpu_torch.probes import diag_kernel_cost as probe

torch.set_num_threads(2)

N, B, ITERS = 16, 2, 3


def _jax_ops(args, dtype):
    """S and M of member b through vch_tpu's Pallas operator kernels."""
    j = lambda t: jnp.asarray(t.numpy(), dtype)
    op, den, d = j(args[0]), j(args[6]), j(args[7])
    inv_dt, tau_dt, hk = args[9:]
    S = lambda b, v: pk.schur_apply_pallas(op, op, d[b], v, inv_dt, tau_dt,
                                           hk, interpret=True)
    M = lambda b, v: pk.spectral_solve_pallas(op, op, op, op, den[b], v,
                                              interpret=True)
    return S, M, j(args[8])


def _jax_nodots(args, dtype, n_iter):
    S, M, rhs = _jax_ops(args, dtype)
    out = []
    for b in range(rhs.shape[0]):
        dot = 0.5
        r = rhs[b]
        x = p = v = jnp.zeros_like(r)
        rho = alpha = omega = 1.0
        for _ in range(n_iter):
            beta = (dot / rho) * (alpha / omega)
            p = r + beta * (p - omega * v)
            phat = M(b, p)
            v = S(b, phat)
            alpha_n = dot / dot
            s = r - alpha_n * v
            shat = M(b, s)
            t = S(b, shat)
            omega_n = dot / dot
            x = x + alpha_n * phat + omega_n * shat
            r = s - omega_n * t
            rho, alpha, omega = dot, alpha_n, omega_n
        out.append(x)
    return np.stack([np.asarray(o) for o in out])


def _jax_mmonly(args, dtype, n_iter):
    S, M, rhs = _jax_ops(args, dtype)
    out = []
    for b in range(rhs.shape[0]):
        v = rhs[b]
        for _ in range(n_iter):
            v = M(b, S(b, M(b, S(b, v))))
        out.append(np.asarray(v))
    return np.stack(out)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("name", ["nodots", "mmonly"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
def test_probe_plain_matches_vch_tpu_operator_recurrence(name, dtype, tol):
    args = probe.probe_args(N, B, "cpu", dtype)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    ref = (_jax_nodots if name == "nodots" else _jax_mmonly)(args, jdt, ITERS)
    plain = getattr(sk, f"schur_{name}_plain")(*args, n_iter=ITERS)
    assert plain.dtype == dtype and plain.shape == (B, N + 1, N + 1)
    assert np.isfinite(ref).all() and np.abs(ref).max() > 0
    assert _rel(plain.numpy(), ref) <= tol, _rel(plain.numpy(), ref)


def test_probe_wrappers_run_the_plain_versions_on_cpu_tensors():
    args = probe.probe_args(N, B, "cpu", torch.float32)
    km.reset_launches()
    for name in ("nodots", "mmonly"):
        out = getattr(sk, f"schur_{name}")(*args, n_iter=ITERS)
        ref = getattr(sk, f"schur_{name}_plain")(*args, n_iter=ITERS)
        assert torch.equal(out, ref)
    counts = km.launch_counts()
    assert counts["schur_nodots"] == counts["schur_mmonly"] == 0
    # one member is the B = 1 case of the batch
    one = tuple(a[:1] if torch.is_tensor(a) and a.dim() == 3 else a
                for a in args)
    assert _rel(sk.schur_nodots(*one, n_iter=ITERS).numpy(),
                sk.schur_nodots(*args, n_iter=ITERS)[:1].numpy()) <= 1e-6


def test_the_three_probes_share_the_one_cta_design():
    """The three probes share one design, now the cluster one: the probe's
    `full` is the solvers' raw Schur solve `bicgstab_schur`, as the
    script's is its production kernel, beside nodots and mmonly on the
    same cluster engine (reduction_share divides two of them); on CPU
    tensors it runs bicgstab_schur_plain and counts no launch."""
    assert probe.PROBES == {"full": sk.bicgstab_schur,
                            "nodots": sk.schur_nodots,
                            "mmonly": sk.schur_mmonly}
    assert probe.PROBES["full"] is sk.bicgstab_schur
    args = probe.probe_args(N, B, "cpu", torch.float32)
    km.reset_launches()
    out = probe.PROBES["full"](*args, n_iter=ITERS)
    assert torch.equal(out, sk.bicgstab_schur_plain(*args, n_iter=ITERS))
    assert not any(km.launch_counts().values())


def test_sass_diff_splits_a_listing_by_function_without_addresses():
    """probes/sass_diff.py compares two trees' SASS function by function;
    the instruction lines it reports leave out addresses and encodings."""
    from vch_tpu_torch.probes import sass_diff
    listing = """
\tcode for sm_90a
\t\tFunction : _Zkernel_a
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe20000000800 */
        /*0010*/                   FFMA R2, R3, R4, R2 ;    /* 0x0000000403027223 */
\t\tFunction : _Zkernel_b
        /*0000*/                   EXIT ;                   /* 0x000000000000794d */
"""
    funcs = sass_diff.functions(listing)
    assert list(funcs) == ["_Zkernel_a", "_Zkernel_b"]
    assert sass_diff.instructions(funcs["_Zkernel_a"]) == [
        "LDC R1, c[0x0][0x28] ;", "FFMA R2, R3, R4, R2 ;"]
    assert sass_diff.instructions(funcs["_Zkernel_b"]) == ["EXIT ;"]


def test_probe_inputs_are_the_scripts():
    """scripts/diag_kernel_cost.py:46-52: seed 0, in its order."""
    args = probe.probe_args(8, 3, "cpu", torch.float64)
    rng = np.random.default_rng(0)
    op = rng.standard_normal((9, 9)) * 0.01
    den = 1.0 + np.abs(rng.standard_normal((9, 9)))
    d = 1.0 + np.abs(rng.standard_normal((3, 9, 9)))
    rhs = rng.standard_normal((3, 9, 9))
    for a in args[:6]:
        np.testing.assert_array_equal(a.numpy(), op)
    np.testing.assert_array_equal(args[6].numpy(), np.broadcast_to(den,
                                                                   (3, 9, 9)))
    np.testing.assert_array_equal(args[7].numpy(), d)
    np.testing.assert_array_equal(args[8].numpy(), rhs)
    assert args[9:] == (100.0, 5.0, 4.5e-4)
    assert all(a.is_contiguous() for a in args[:9])


def test_probe_entry_point_needs_the_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.run(n=8, b=2, iters=1, reps=1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            probe.main(["--n", "8", "--b", "2"])
