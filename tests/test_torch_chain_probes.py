"""The four cost probes of ops.probe_kernels (counterparts of
scripts/diag_blocked_microbench.py, probe_pallas_while.py, diag_march_sol.py
and diag_interleave.py) and their entry points, on the CPU.

The plain versions are held against the scripts' own Pallas kernels where a
script exposes them (diag_blocked_microbench's `build`, probe_pallas_while's
`run`, in interpret mode), and against the kernel bodies restated in
jax.numpy where its pallas_call sits inside `main()` (the chains), all in
float32 at n = 9. Tolerances: 1e-6 of the scale for products summed in
another order (4e-6 over the chains' 40 links); bit-equal where no sum is
taken; the while probe with the script's own gates.
"""
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vch_tpu_torch.ops import march as km
from vch_tpu_torch.ops import probe_kernels as pk
from vch_tpu_torch.probes import (diag_blocked_microbench, diag_interleave,
                                  diag_march_sol, probe_while)

torch.set_num_threads(2)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")
N = 9


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_probe_script_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _microbench_inputs(n, bb):
    """The script's main(): C, G, GT, X from seed 0, in its order."""
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    G = np.zeros((bb, bb * n), np.float32)
    for b in range(bb):
        G[b, b * n:(b + 1) * n] = 1.0
    X = (rng.standard_normal((bb * n, n)) * 0.1).astype(np.float32)
    return q.astype(np.float32), G, G.T.copy(), X


@pytest.mark.parametrize("variant", pk.VARIANTS)
def test_microbench_plain_matches_the_scripts_kernel(variant):
    bb, k = 2, 3
    C, G, GT, X = _microbench_inputs(N, bb)
    build = _script("diag_blocked_microbench").build
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(build(variant, N, bb, k)(
            jnp.asarray(C), jnp.asarray(G), jnp.asarray(GT), jnp.asarray(X)))
    out, sums = pk.blocked_microbench_plain(variant, torch.from_numpy(C),
                                            torch.from_numpy(X), bb, k)
    assert out.dtype == torch.float32 and out.shape == (bb * N, N)
    assert ref.dtype == np.float32 and np.isfinite(ref).all()
    if variant in ("swap", "gdot", "member_dot"):
        # no sum reaches the output: the same bits
        np.testing.assert_array_equal(out.numpy(), ref)
    else:
        assert _rel(out.numpy(), ref) <= 1e-6, _rel(out.numpy(), ref)
    if variant in ("gdot", "member_dot"):
        # both factors round to 1 in float32 on these inputs: X comes back
        np.testing.assert_array_equal(out.numpy(), X)
        ref_sums = (X.astype(np.float64).reshape(bb, N, N) ** 2).sum((1, 2))
        np.testing.assert_allclose(sums.numpy(), ref_sums, rtol=1e-6)
    else:
        assert not sums.any()


def test_microbench_inputs_are_the_scripts():
    C, _, _, X = _microbench_inputs(N, 8)
    tC, tX = diag_blocked_microbench.inputs(N - 1, 8, "cpu")
    np.testing.assert_array_equal(tC.numpy(), C)
    np.testing.assert_array_equal(tX.numpy(), X)


def test_microbench_stacked_and_per_member_products_agree():
    C, _, _, X = _microbench_inputs(N, 4)
    C, X = torch.from_numpy(C).double(), torch.from_numpy(X).double()
    run = lambda v: pk.blocked_microbench_plain(v, C, X, 4, 5)[0]
    assert _rel(run("stacked_mm"), run("member_mm")) <= 1e-14
    # swap then product = the transposed product; serial_one moves member 0
    X3 = X.reshape(4, N, N)
    ref = X3.transpose(1, 2) @ C
    assert _rel(pk.blocked_microbench_plain("swap_mm", C, X, 4, 1)[0],
                ref.reshape(4 * N, N)) <= 1e-14
    one = pk.blocked_microbench_plain("serial_one", C, X, 4, 5)[0]
    assert torch.equal(one[N:], X[N:])


def test_while_plain_matches_the_scripts_kernel():
    mod = _script("probe_pallas_while")
    out, ns, x = mod.run(B=2, M=3, n=N, interpret=True)
    ref, ns_ref = mod.reference(np.asarray(x), M=3)
    plain, ns_plain = pk.while_probe_plain(torch.tensor(x), 3)
    # the script's gates, for the plain version and the Pallas kernel
    assert np.abs(plain.numpy() - ref).max() < 1e-4
    assert (ns_plain.numpy() == ns_ref).all()
    assert np.abs(out - ref).max() < 1e-4 and (ns == ns_ref).all()
    assert ns_plain.dtype == torch.int32 and ns_plain.shape == (2, 1)
    np.testing.assert_allclose(plain.numpy(), out, rtol=1e-6, atol=1e-12)
    # the port's restated reference and input
    r2, n2 = probe_while.reference(np.asarray(x), 3)
    np.testing.assert_array_equal(r2, ref)
    np.testing.assert_array_equal(n2, ns_ref)
    np.testing.assert_array_equal(probe_while.inputs(2, N, "cpu").numpy(), x)
    # data-dependent trips: the first step runs until the norm is small,
    # the later ones leave after one trip
    assert ns_ref[0, 0] > 3


def _jax_chains(A, X, K, L, bf16):
    """diag_interleave.py's kernel body restated: cell g runs the K chains
    X[k::K][:groups], each L links of A @ x, HIGHEST, or DEFAULT as bf16
    operands with float32 accumulation."""
    groups = X.shape[0] // K
    A_ = jnp.asarray(A)
    if bf16:
        A_ = A_.astype(jnp.bfloat16).astype(jnp.float32)
    out = np.empty_like(X)
    for k in range(K):
        x = jnp.asarray(X[k::K][:groups])
        for _ in range(L):
            if bf16:
                x = x.astype(jnp.bfloat16).astype(jnp.float32)
            x = jnp.einsum("ij,gjk->gik", A_, x,
                           precision=jax.lax.Precision.HIGHEST)
        out[k::K][:groups] = np.asarray(x)
    return out


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("bf16", [False, True])
def test_chain_plain_matches_the_restated_kernel_body(K, bf16):
    A, X = (t.numpy() for t in diag_interleave.inputs(N - 1, 8, "cpu"))
    L = 40
    ref = _jax_chains(A, X, K, L, bf16)
    plain = (pk.matmul_chain_bf16_plain if bf16 else pk.matmul_chain_plain)(
        torch.from_numpy(A), torch.from_numpy(X), K, L)
    assert plain.dtype == torch.float32 and np.isfinite(ref).all()
    # 0.999 Q keeps the norm: the chain neither under- nor overflows
    assert 0.5 < np.abs(ref).max() / np.abs(X).max() < 2
    # highest: 40 links, each ~1e-7 from summing in another order; bf16:
    # both sides round float32 values that agree to ~1e-7, so a rounding
    # flips only where a value lies that close to a tie
    assert _rel(plain.numpy(), ref) <= (1e-5 if bf16 else 4e-6)


def test_chain_is_the_same_for_every_interleave_width():
    A, X = diag_interleave.inputs(N - 1, 8, "cpu", torch.float64)
    outs = [pk.matmul_chain_plain(A, X, K, 7) for K in (1, 2, 4, 8)]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    np.testing.assert_allclose(
        outs[0].numpy(),
        np.linalg.matrix_power(A.numpy(), 7) @ X.numpy(), rtol=1e-12,
        atol=1e-12)


def test_interleave_inputs_are_the_scripts():
    n1 = N
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((n1, n1)))
    A, X = diag_interleave.inputs(N - 1, 4, "cpu")
    np.testing.assert_array_equal(A.numpy(), (q * 0.999).astype(np.float32))
    np.testing.assert_array_equal(
        X.numpy(), rng.standard_normal((4, n1, n1)).astype(np.float32))


def test_march_sol_counts_and_inputs_are_the_scripts():
    src = open(os.path.join(SCRIPTS, "diag_march_sol.py")).read()
    expr = re.search(r"^\s*mm_per_solve = (.+)$", src, re.M).group(1)
    for trips in (1, 3, 5, 10):
        assert diag_march_sol.mm_per_solve(trips) == eval(
            expr, {}, {"trips": trips})
    assert diag_march_sol.mm_per_solve(3) == 40
    amort = int(re.search(r"^\s*AMORT = (\d+)", src, re.M).group(1))
    assert diag_march_sol.AMORT == amort == 2000
    a, v = diag_march_sol.chain_inputs(N - 1, "cpu")
    np.testing.assert_array_equal(
        a.numpy(), (np.random.default_rng(0).standard_normal((N, N))
                    * 1e-2).astype(np.float32))
    assert v.shape == (1, N, N) and bool((v == 1).all())
    # the chain on these inputs over three links, as the gate on the card
    # takes it: float32 against float64
    a64, v64 = diag_march_sol.chain_inputs(N - 1, "cpu", torch.float64)
    out = pk.matmul_chain(a, v, 1, 3)
    ref = pk.matmul_chain_plain(a64, v64, 1, 3)
    assert _rel(out.numpy(), ref.numpy()) <= 1e-6


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    A, X = diag_interleave.inputs(N - 1, 4, "cpu")
    C, Xs = diag_blocked_microbench.inputs(N - 1, 2, "cpu")
    x = probe_while.inputs(2, N, "cpu")
    km.reset_launches()
    assert torch.equal(pk.matmul_chain(A, X, 2, 3),
                       pk.matmul_chain_plain(A, X, 2, 3))
    assert torch.equal(pk.matmul_chain_bf16(A, X, 4, 3),
                       pk.matmul_chain_bf16_plain(A, X, 4, 3))
    for got, ref in zip(pk.blocked_microbench("gdot", C, Xs, 2, 2),
                        pk.blocked_microbench_plain("gdot", C, Xs, 2, 2)):
        assert torch.equal(got, ref)
    for got, ref in zip(pk.while_probe(x, 2), pk.while_probe_plain(x, 2)):
        assert torch.equal(got, ref)
    counts = km.launch_counts()
    names = ("matmul_chain", "matmul_chain_bf16", "blocked_microbench",
             "while_probe")
    assert all(counts[k] == 0 for k in names), counts


@pytest.mark.parametrize("bad", [3, 16])
def test_unsupported_member_blocks_raise(bad):
    C, X = diag_blocked_microbench.inputs(N - 1, 1, "cpu")
    Xb = X.repeat(bad, 1)
    with pytest.raises(ValueError, match="bb"):
        pk.blocked_microbench("stacked_mm", C, Xb, bad, 2)
    A, Xc = diag_interleave.inputs(N - 1, 48, "cpu")
    with pytest.raises(ValueError, match="K"):
        pk.matmul_chain(A, Xc, bad, 2)
    with pytest.raises(ValueError, match="K"):
        pk.matmul_chain_bf16(A, Xc, bad, 2)


def test_wrappers_reject_what_they_do_not_take():
    A, X = diag_interleave.inputs(N - 1, 6, "cpu")
    C, Xs = diag_blocked_microbench.inputs(N - 1, 2, "cpu")
    with pytest.raises(ValueError, match="split"):
        pk.matmul_chain(A, X, 4, 2)          # 6 members, chains of 4
    with pytest.raises(ValueError, match="L >= 1"):
        pk.matmul_chain(A, X, 2, 0)
    with pytest.raises(ValueError, match="variant"):
        pk.blocked_microbench("transpose", C, Xs, 2, 1)
    with pytest.raises(ValueError, match="k >= 1"):
        pk.blocked_microbench("swap", C, Xs, 2, 0)
    with pytest.raises(ValueError, match=r"\(bb n, n\)"):
        pk.blocked_microbench("swap", C, Xs, 4, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        pk.matmul_chain(A.to("meta"), X.to("meta"), 2, 1)


@pytest.mark.parametrize("entry,kw", [
    (diag_march_sol, dict(n=16, b=2, amort=1, reps=1)),
    (diag_interleave, dict(n=8, members=4, length=2, reps=1)),
    (diag_blocked_microbench, dict(n=8, bb=2, k=2, reps=1)),
    (probe_while, dict(B=1, M=1, n=9)),
])
def test_entry_points_need_the_card(entry, kw):
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.run(device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            entry.main([])
