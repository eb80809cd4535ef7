"""The while probe's two CUDA schedules (kernel-table row 19), emulated in
numpy float32 on the CPU, where no kernel runs.

`oracle` restates csrc/probes.cu `while_kernel`: per outer trip, a trial pass
with two CTA reductions (sum trial^2, sum phi^2) per inner trial, then the
update pass with a third (the norm). `fused` restates csrc/while_fused.cu
`while_fused_kernel`: one pass and one two-value reduction a trip, the
update pass also summing the next trip's first trial, the next trip's
sum phi^2 carried from this trip's norm, a rejected trial summing its
trial^2 alone. Both use the kernels' arithmetic exactly: thread tid of
NT = 256 owns the elements e = tid + k NT, accumulates its partial sums in
ascending k with one fused multiply-add per element, `block_sum` reduces by
the xor-shuffle tree within each warp and then a serial sum of the 8 warps'
lane-0 values from 0, trial factors are 1 - 0.3 alpha rounded as two
float32 operations. (The FMA is emulated in float64, whose product of two
float32 values is exact; both schedules share it.)

Gates: phi bit for bit and ns equal between the two schedules at n = 9, 17,
65 and 101, M = 1 and 3, on three members of which one carries a NaN (NaN
at the same places, ns = 50 M); the fused schedule takes one reduction a
trip plus one a launch (finite input) where the oracle takes three; both
give the script's trip counts, and phi within 1e-6 relative of the plain
PyTorch version (`while_probe_plain`, float32 sums in torch's order).
"""
import numpy as np
import pytest
import torch

from vch_tpu_torch.ops import probe_kernels as pk
from vch_tpu_torch.probes import probe_while

NT = 256
LANE = np.arange(NT)
F32 = np.float32


class Field:
    """One member's field in the kernels' thread layout: (KM, NT) float32,
    element e = tid + k NT at [k, tid], zero past n^2, with its mask."""

    def __init__(self, x: np.ndarray):
        nn = x.size
        km = -(-nn // NT)
        flat = np.zeros(km * NT, F32)
        flat[:nn] = x.ravel()
        self.v = flat.reshape(km, NT)
        self.valid = (np.arange(km * NT) < nn).reshape(km, NT)
        self.nn = nn

    def values(self):
        return self.v.ravel()[: self.nn]


def fma(a, b, c):
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(F32)


def partials(terms, valid):
    """Each thread's `s += t * t` over its elements in ascending k."""
    s = np.zeros(NT, F32)
    for k in range(terms.shape[0]):
        s = np.where(valid[k], fma(terms[k], terms[k], s), s)
    return s


class Reducer:
    """common.cuh block_sum on one value a thread; counts its calls (a
    block_sum<2> counts once)."""

    def __init__(self):
        self.calls = 0

    def __call__(self, *parts):
        self.calls += 1
        return tuple(self._one(p) for p in parts)

    @staticmethod
    def _one(v):
        for off in (16, 8, 4, 2, 1):
            v = (v + v[LANE ^ off]).astype(F32)
        s = F32(0)
        for w in range(NT // 32):
            s = F32(s + v[32 * w])
        return s


def factor(alpha):
    """__fsub_rn(1, __fmul_rn(0.3f, alpha))."""
    return F32(F32(1) - F32(F32(0.3) * alpha))


def done_after(sp):
    return bool(np.sqrt(sp) < F32(1e-3))


def oracle(x, M, red):
    """probes.cu while_kernel on one member."""
    phi = Field(x)
    count = 0
    for _ in range(M):
        trips, done = 0, False
        while not done and trips < 50:
            alpha, acc, j = F32(1), False, 0
            while not acc and j < 12:
                t = (phi.v * factor(alpha)).astype(F32)
                st, = red(partials(t, phi.valid))
                sp, = red(partials(phi.v, phi.valid))
                acc = bool(st <= sp)
                if not acc:
                    alpha = F32(alpha * F32(0.5))
                j += 1
            phi.v = (phi.v * factor(alpha)).astype(F32)
            s2, = red(partials(phi.v, phi.valid))
            trips += 1
            done = done_after(s2)
        count += trips
    return phi.values(), count


def fused(x, M, red):
    """while_fused.cu while_fused_kernel on one member."""
    phi = Field(x)
    f1 = factor(F32(1))
    st, sp = red(partials((phi.v * f1).astype(F32), phi.valid),
                 partials(phi.v, phi.valid))
    count = 0
    for _ in range(M):
        trips, done = 0, False
        while not done and trips < 50:
            alpha = F32(1)
            acc = bool(st <= sp)
            j = 1
            while not acc and j < 12:
                alpha = F32(alpha * F32(0.5))
                t = (phi.v * factor(alpha)).astype(F32)
                s, = red(partials(t, phi.valid))
                acc = bool(s <= sp)
                j += 1
            if not acc:
                alpha = F32(alpha * F32(0.5))
            phi.v = (phi.v * factor(alpha)).astype(F32)
            st, sp = red(partials((phi.v * f1).astype(F32), phi.valid),
                         partials(phi.v, phi.valid))
            trips += 1
            done = done_after(sp)
        count += trips
    return phi.values(), count


def _members(n):
    """The script's input at B = 3, member 2 seeded with one NaN."""
    x = probe_while.inputs(3, n, "cpu").numpy().copy()
    x[2, n // 2, n // 3] = np.nan
    return x


@pytest.mark.parametrize("M", [1, 3])
@pytest.mark.parametrize("n", [9, 17, 65, 101])
def test_fused_schedule_is_the_oracles_bits(n, M):
    x = _members(n)
    _, ns_ref = probe_while.reference(x[:2], M)
    plain, ns_plain = pk.while_probe_plain(torch.as_tensor(x[:2]), M)
    with np.errstate(invalid="ignore", over="ignore"):
        for b in range(3):
            r_old, r_new = Reducer(), Reducer()
            phi_old, ns_old = oracle(x[b], M, r_old)
            phi_new, ns_new = fused(x[b], M, r_new)
            assert np.array_equal(phi_old.view(np.uint32),
                                  phi_new.view(np.uint32)), (n, M, b)
            assert ns_old == ns_new, (n, M, b)
            if b == 2:
                assert ns_new == 50 * M
                assert np.array_equal(np.isnan(phi_new),
                                      np.isnan(x[b].ravel()))
                continue
            assert ns_new == ns_ref[b, 0] == int(ns_plain[b, 0])
            # finite input: every inner trial accepts alpha = 1
            assert r_old.calls == 3 * ns_old
            assert r_new.calls == ns_new + 1
            p = plain[b].numpy().ravel()
            assert np.abs(phi_new - p).max() <= 1e-6 * np.abs(p).max()


def test_fused_schedule_at_the_scripts_shape():
    """B = 2, M = 3, n = 65: 34 trips a member (32, then 1 and 1), 35
    reductions where the oracle takes 102."""
    x = probe_while.inputs(2, 65, "cpu").numpy()
    for b in range(2):
        r_old, r_new = Reducer(), Reducer()
        ns_old = oracle(x[b], 3, r_old)[1]
        ns_new = fused(x[b], 3, r_new)[1]
        assert ns_old == ns_new == 34
        assert (r_old.calls, r_new.calls) == (102, 35)
