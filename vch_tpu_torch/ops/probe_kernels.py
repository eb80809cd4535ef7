"""The kernels of the port's cost probes, counterparts of the four TPU
probes under scripts/ that reach pl.pallas_call:

  matmul_chain        K interleaved chains x <- A x of L links, full float32,
                      K members per thread-block cluster on the cluster
                      engine's left product (`csrc/chain_cluster.cu`;
                      scripts/diag_march_sol.py:86 at K = 1 on one member;
                      the HIGHEST arm of scripts/diag_interleave.py:86);
  matmul_chain_bf16   the same with bf16 operands on the tensor cores
                      (mma.sync, x resident in shared memory; the DEFAULT
                      arm of diag_interleave.py:86);
  blocked_microbench  k dependent steps of one of eight primitives on a
                      (bb n, n) stack of bb members on one thread-block
                      cluster, on the cluster engine
                      (`csrc/micro_cluster.cu`;
                      scripts/diag_blocked_microbench.py:100);
  while_probe         per member, M steps of nested data-dependent loops
                      with a carry across steps, in registers, one CTA
                      reduction a trip (`csrc/while_fused.cu`;
                      scripts/probe_pallas_while.py:67).

The first designs of the four, K or bb members or one member per CTA in
`csrc/probes.cu`, stay as their bit oracles `_matmul_chain_cta`,
`_matmul_chain_bf16_cta`, `_blocked_microbench_cta` and
`_while_probe_cta`, which the card
tests and chip_smoke.py hold the new kernels against; no entry point calls
them. Each wrapper routes by the tensors' device: on CUDA tensors it
launches its hand-written kernel (float32; a failed build, fit or launch
raises), on CPU tensors it runs its plain PyTorch version `<name>_plain`,
which computes the same function in the tensors' dtype. Each wrapper counts
its launches in `.launches`. No solver reaches these kernels; the bf16
chain is the package's only reduced-precision product.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from vch_tpu_torch.ops import _build

VARIANTS = ("serial_one", "member_mm", "left_mm", "stacked_mm", "swap",
            "swap_mm", "gdot", "member_dot")   # the order of probes.cu's enum
MEMBER_BLOCKS = (1, 2, 4, 8)    # members per block the probe kernels are
                                # built for
# The gate of the bf16 chain against its plain version over 40 links, as
# max |kernel - plain| / max |plain|: the tensor cores and the plain float32
# product sum each link in another order, so a value near a bf16 tie can
# round the other way, and the flip carries forward through the later links.
# Measured 7.8e-3 at n = 65, B = 32 on diag_interleave's inputs (H100 80GB
# HBM3, 700 W); the gate allows 2.5x.
BF16_CHAIN_TOL = 2e-2
# The bf16 chain keeps every warp's A fragments in registers and x in
# shared memory: n up to 80 (five 16-row tiles), 2 K pad16(n) (pad16(n) + 8)
# bf16 of shared memory within a block's 232,448 bytes.
BF16_CHAIN_MAX_N = 80
SMEM_PER_BLOCK = 232_448


def _check_block(what, k):
    if k not in MEMBER_BLOCKS:
        raise ValueError(f"{what} must be one of {MEMBER_BLOCKS}, got {k}")


def _check_chain(A, X, K, L):
    _check_block("K (chains per cluster or CTA)", K)
    if X.dim() != 3 or X.shape[1:] != A.shape or A.shape[0] != A.shape[1]:
        raise ValueError(f"X must be (B, n, n) for A (n, n), got "
                         f"{tuple(X.shape)} and {tuple(A.shape)}")
    if X.shape[0] % K:
        raise ValueError(f"B = {X.shape[0]} members do not split into "
                         f"chains of K = {K} per block")
    if L < 1:
        raise ValueError(f"the chain needs L >= 1 links, got {L}")


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def matmul_chain_plain(A, X, K: int, L: int):
    """Plain PyTorch version of `matmul_chain`."""
    _check_chain(A, X, K, L)
    for _ in range(L):
        X = torch.matmul(A, X)
    return X


def matmul_chain_bf16_plain(A, X, K: int, L: int):
    """Plain PyTorch version of `matmul_chain_bf16`: each link's operands
    rounded to bf16, the product in the tensors' dtype."""
    _check_chain(A, X, K, L)
    Ab = _bf16(A)
    for _ in range(L):
        X = torch.matmul(Ab, _bf16(X))
    return X


def bf16_chain_smem_bytes(n: int, K: int) -> int:
    """Dynamic shared memory of one CTA of the bf16 chain: two buffers of K
    members' bf16 x, n padded to a multiple of 16, rows padded by 8 more
    (225,280 bytes at n = 65, K = 8)."""
    np_ = -(-n // 16) * 16
    return 2 * K * np_ * (np_ + 8) * 2


@lru_cache(maxsize=64)
def probe_geometry(kernel: str, n: int, B: int, members: int,
                   device_index: int, cluster: int | None = None):
    """The cluster geometry of a cluster probe (`kernel`: "chain", the
    float32 chain, or "micro", the microbench, whose B is its one block's
    members) for B members of (n, n), `members` per cluster, on CUDA device
    `device_index`: `ops.march.launch_geometry` fitted to that kernel's own
    residency (16 CTAs at n = 65 for one cluster), or with `cluster` CTAs
    (`ops.march.blocked_geometry`'s override). A block that does not fit
    raises (ValueError or RuntimeError, with its shared-memory bytes)."""
    from vch_tpu_torch.ops import march   # ops.march imports this module
    if cluster is None:
        return march.launch_geometry(n, n, B, torch.device("cuda",
                                                          device_index),
                                     members=members, kernel=kernel)
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return march.blocked_geometry(n, n, B, sms, cluster=cluster,
                                  members=members, kernel=kernel)


def _chain_buffers(A, X):
    B, n = X.shape[0], X.shape[1]
    _build.check_cuda([("A", A, (n, n)), ("X", X, (B, n, n))], X.device)
    return B, n, _build.load(), torch.empty_like(X), \
        torch.cuda.current_stream(X.device).cuda_stream


def matmul_chain(A, X, K: int, L: int, cluster: int | None = None):
    """out_b = A^L X_b for each member of X (B, n, n), one link x <- A x
    after another in full float32, K members' chains on each of B / K
    thread-block clusters (member g K + k is chain k of cluster g; K in 1,
    2, 4, 8). A is (n, n). On CUDA tensors every link is the cluster
    engine's left product (`csrc/chain_cluster.cu`) on `probe_geometry`'s
    clusters (`cluster`: that many CTAs each), bit for bit what the one-CTA
    kernel `_matmul_chain_cta` computes. Every K and every cluster size
    gives the same bits: a member's products sum in one order whatever the
    tiling."""
    if not _build.on_cuda("matmul_chain", X):
        return matmul_chain_plain(A, X, K, L)
    _check_chain(A, X, K, L)
    B, n, lib, out, stream = _chain_buffers(A, X)
    geo = probe_geometry("chain", n, B, K, X.device.index, cluster)
    work = torch.empty_like(X)
    err = lib.vch_matmul_chain_cluster(
        A.data_ptr(), X.data_ptr(), out.data_ptr(), work.data_ptr(), B, n, K,
        int(L), geo.cluster, geo.kc, geo.smem_bytes, stream)
    matmul_chain.launches += 1
    _build.raise_on(lib, err, "matmul_chain")
    return out


matmul_chain.launches = 0


def _launch_chain_cta(wrapper, A, X, K, L, bf16):
    B, n, lib, out, stream = _chain_buffers(A, X)
    work = torch.empty_like(X)
    err = lib.vch_matmul_chain(A.data_ptr(), X.data_ptr(), out.data_ptr(),
                               work.data_ptr(), B, n, K, int(L), int(bf16),
                               stream)
    wrapper.launches += 1
    _build.raise_on(lib, err, wrapper.__name__)
    return out


def _matmul_chain_cta(A, X, K: int, L: int):
    """The one-CTA float32 chain of csrc/probes.cu (K members per CTA on
    common.cuh's products): the bit oracle of `matmul_chain`. Arguments and
    result as `matmul_chain`'s."""
    if not _build.on_cuda("_matmul_chain_cta", X):
        return matmul_chain_plain(A, X, K, L)
    _check_chain(A, X, K, L)
    return _launch_chain_cta(_matmul_chain_cta, A, X, K, L, bf16=False)


_matmul_chain_cta.launches = 0


def matmul_chain_bf16(A, X, K: int, L: int):
    """`matmul_chain` with each link's operands rounded to bf16 (round to
    nearest even) and multiplied on the tensor cores, accumulating in
    float32; out is the last link's float32 value: the counterpart of a
    DEFAULT-precision float32 product on the TPU. A probe only: no solver
    path may reach it. On CUDA tensors one CTA holds K members
    (`csrc/chain_cluster.cu` chain_mma_kernel: mma.sync, bf16(A) in
    registers, x in bf16 in shared memory between links), so n is at most
    BF16_CHAIN_MAX_N and `bf16_chain_smem_bytes(n, K)` at most a block's
    SMEM_PER_BLOCK bytes; larger ones raise."""
    if not _build.on_cuda("matmul_chain_bf16", X):
        return matmul_chain_bf16_plain(A, X, K, L)
    _check_chain(A, X, K, L)
    n = X.shape[1]
    smem = bf16_chain_smem_bytes(n, K)
    if n > BF16_CHAIN_MAX_N or smem > SMEM_PER_BLOCK:
        raise ValueError(f"the bf16 chain takes n <= {BF16_CHAIN_MAX_N} and "
                         f"at most {SMEM_PER_BLOCK} bytes of shared memory "
                         f"a CTA: n = {n}, K = {K} needs {smem}")
    B, n, lib, out, stream = _chain_buffers(A, X)
    err = lib.vch_matmul_chain_mma(A.data_ptr(), X.data_ptr(),
                                   out.data_ptr(), B, n, K, int(L), stream)
    matmul_chain_bf16.launches += 1
    _build.raise_on(lib, err, "matmul_chain_bf16")
    return out


matmul_chain_bf16.launches = 0


def _matmul_chain_bf16_cta(A, X, K: int, L: int):
    """The wmma bf16 chain of csrc/probes.cu (bf16(A) and x in shared
    memory, x back in device memory after every link), the first design of
    `matmul_chain_bf16`, kept beside it as its oracle. Arguments and result
    as `matmul_chain_bf16`'s."""
    if not _build.on_cuda("_matmul_chain_bf16_cta", X):
        return matmul_chain_bf16_plain(A, X, K, L)
    _check_chain(A, X, K, L)
    return _launch_chain_cta(_matmul_chain_bf16_cta, A, X, K, L, bf16=True)


_matmul_chain_bf16_cta.launches = 0


def _check_micro(variant, C, X, bb, k):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    _check_block("bb (members per cluster or CTA)", bb)
    n = C.shape[0]
    if C.shape != (n, n) or X.shape != (bb * n, n):
        raise ValueError(f"C must be (n, n) and X (bb n, n), got "
                         f"{tuple(C.shape)} and {tuple(X.shape)} for bb = {bb}")
    if k < 1:
        raise ValueError(f"the microbench needs k >= 1 steps, got {k}")


def blocked_microbench_plain(variant: str, C, X, bb: int, k: int):
    """Plain PyTorch version of `blocked_microbench`."""
    _check_micro(variant, C, X, bb, k)
    n = C.shape[0]
    X3 = X.reshape(bb, n, n)
    sums = torch.zeros(bb, dtype=X.dtype, device=X.device)
    for _ in range(k):
        if variant == "serial_one":
            X3 = torch.cat([(X3[0] @ C)[None], X3[1:]])
        elif variant == "member_mm":
            X3 = X3 @ C
        elif variant == "left_mm":
            X3 = C @ X3
        elif variant == "stacked_mm":
            X3 = (X3.reshape(bb * n, n) @ C).reshape(bb, n, n)
        elif variant == "swap":
            X3 = X3.transpose(1, 2) * 1.0000001
        elif variant == "swap_mm":
            X3 = X3.transpose(1, 2) @ C
        else:
            sums = (X3 * X3).sum((1, 2))
            if variant == "gdot":
                X3 = X3 * (1.0 + 1e-12 * sums)[:, None, None]
            else:
                fac = 1.0
                for s in sums:
                    fac = fac + 1e-12 * s
                X3 = X3 * fac
    return X3.reshape(bb * n, n).contiguous(), sums


def _micro_buffers(C, X, bb):
    n = C.shape[0]
    _build.check_cuda([("C", C, (n, n)), ("X", X, (bb * n, n))], X.device)
    return (n, _build.load(), torch.empty_like(X), torch.empty_like(X),
            torch.empty(bb, dtype=torch.float32, device=X.device),
            torch.cuda.current_stream(X.device).cuda_stream)


def blocked_microbench(variant: str, C, X, bb: int, k: int,
                       cluster: int | None = None):
    """k dependent steps of one primitive on the (bb n, n) stack X of bb
    members (bb in 1, 2, 4, 8) with the shared (n, n) C; `variant` is one
    of VARIANTS:
      serial_one  X_0 <- X_0 C, the other members unchanged;
      member_mm   X_b <- X_b C;            left_mm   X_b <- C X_b;
      stacked_mm  X <- X C as one (bb n, n) product;
      swap        X_b <- X_b^T * 1.0000001; swap_mm  X_b <- X_b^T C;
      gdot        X_b <- X_b (1 + 1e-12 ||X_b||^2), per member;
      member_dot  X <- X (1 + sum_b 1e-12 ||X_b||^2), one factor.
    Returns (out (bb n, n), sums (bb,)): sums are the last step's ||X_b||^2
    for gdot and member_dot, zeros for the others. On CUDA tensors the
    block runs on one thread-block cluster (`csrc/micro_cluster.cu`) on
    `probe_geometry`'s cluster (`cluster`: that many CTAs), bit for bit
    what the one-CTA kernel `_blocked_microbench_cta` computes."""
    if not _build.on_cuda("blocked_microbench", X):
        return blocked_microbench_plain(variant, C, X, bb, k)
    _check_micro(variant, C, X, bb, k)
    n, lib, out, work, sums, stream = _micro_buffers(C, X, bb)
    geo = probe_geometry("micro", n, bb, bb, X.device.index, cluster)
    err = lib.vch_blocked_microbench_cluster(
        VARIANTS.index(variant), C.data_ptr(), X.data_ptr(), out.data_ptr(),
        work.data_ptr(), sums.data_ptr(), n, bb, int(k), geo.cluster, geo.kc,
        geo.smem_bytes, stream)
    blocked_microbench.launches += 1
    _build.raise_on(lib, err, "blocked_microbench")
    return out, sums


blocked_microbench.launches = 0


def _blocked_microbench_cta(variant: str, C, X, bb: int, k: int):
    """The one-CTA microbench of csrc/probes.cu (the bb members in one CTA
    on common.cuh's products and block_sum): the bit oracle of
    `blocked_microbench`. Arguments and result as `blocked_microbench`'s."""
    if not _build.on_cuda("_blocked_microbench_cta", X):
        return blocked_microbench_plain(variant, C, X, bb, k)
    _check_micro(variant, C, X, bb, k)
    n, lib, out, work, sums, stream = _micro_buffers(C, X, bb)
    err = lib.vch_blocked_microbench(VARIANTS.index(variant), C.data_ptr(),
                                     X.data_ptr(), out.data_ptr(),
                                     work.data_ptr(), sums.data_ptr(), n, bb,
                                     int(k), stream)
    _blocked_microbench_cta.launches += 1
    _build.raise_on(lib, err, "_blocked_microbench_cta")
    return out, sums


_blocked_microbench_cta.launches = 0


def _check_while(x, M):
    if x.dim() != 3 or x.shape[1] != x.shape[2] or M < 1:
        raise ValueError(f"x must be (B, n, n) and M >= 1, got "
                         f"{tuple(x.shape)}, M = {M}")


def while_probe_plain(x, M: int):
    """Plain PyTorch version of `while_probe`, in x's dtype."""
    _check_while(x, M)
    one = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)
    out = x.clone()
    ns = torch.zeros((x.shape[0], 1), dtype=torch.int32)
    for b in range(x.shape[0]):
        phi = out[b]
        for _ in range(M):
            trips, done = 0, False
            while not done and trips < 50:
                alpha, acc, j = one(1.0), False, 0
                while not acc and j < 12:
                    trial = phi * (1.0 - 0.3 * alpha)
                    acc = bool((trial * trial).sum() <= (phi * phi).sum())
                    if not acc:
                        alpha = alpha * 0.5
                    j += 1
                phi = phi * (1.0 - 0.3 * alpha)
                trips += 1
                done = bool(torch.sqrt((phi * phi).sum()) < 1e-3)
            ns[b, 0] += trips
        out[b] = phi
    return out, ns.to(x.device)


def while_probe(x, M: int):
    """Per member of x (B, n, n), M steps of nested data-dependent loops
    with phi carried across the steps: each step runs outer trips (at most
    50) of an inner line search (at most 12 trips: trial = phi (1 - 0.3
    alpha), accepted when sum trial^2 <= sum phi^2, else alpha halves) and
    phi <- phi (1 - 0.3 alpha), until ||phi|| < 1e-3. Returns (phi (B, n,
    n), ns (B, 1) int32, the outer trips summed over the steps). On CUDA
    csrc/while_fused.cu: one CTA per member carries phi in registers and
    takes one reduction a trip, so n^2 is bounded
    (`vch_while_fused_max_elems`, 10240: n <= 101); bit for bit the one-CTA
    kernel of probes.cu, `_while_probe_cta`."""
    if not _build.on_cuda("while_probe", x):
        return while_probe_plain(x, M)
    lib, out, ns, stream = _while_buffers(x, M)
    if x.shape[1] ** 2 > lib.vch_while_fused_max_elems():
        raise ValueError(f"while_probe carries phi in registers: n^2 = "
                         f"{x.shape[1] ** 2} exceeds "
                         f"{lib.vch_while_fused_max_elems()}")
    err = lib.vch_while_fused(x.data_ptr(), out.data_ptr(), ns.data_ptr(),
                              x.shape[0], x.shape[1], int(M), stream)
    while_probe.launches += 1
    _build.raise_on(lib, err, "while_probe")
    return out, ns.reshape(-1, 1)


while_probe.launches = 0


def _while_buffers(x, M):
    """The checks of a while-probe launch, then (library, out, ns,
    stream)."""
    _check_while(x, M)
    B, n = x.shape[0], x.shape[1]
    _build.check_cuda([("x", x, (B, n, n))], x.device)
    out = torch.empty_like(x)
    ns = torch.empty(B, dtype=torch.int32, device=x.device)
    return (_build.load(), out, ns,
            torch.cuda.current_stream(x.device).cuda_stream)


def _while_probe_cta(x, M: int):
    """The one-CTA while probe of csrc/probes.cu (phi in static shared
    memory, three block reductions a trip): the bit oracle of
    `while_probe`. Arguments and result as `while_probe`'s."""
    if not _build.on_cuda("_while_probe_cta", x):
        return while_probe_plain(x, M)
    lib, out, ns, stream = _while_buffers(x, M)
    if x.shape[1] ** 2 > lib.vch_while_max_elems():
        raise ValueError(f"_while_probe_cta carries phi in static shared "
                         f"memory: n^2 = {x.shape[1] ** 2} exceeds "
                         f"{lib.vch_while_max_elems()}")
    err = lib.vch_while_probe(x.data_ptr(), out.data_ptr(), ns.data_ptr(),
                              x.shape[0], x.shape[1], int(M), stream)
    _while_probe_cta.launches += 1
    _build.raise_on(lib, err, "_while_probe_cta")
    return out, ns.reshape(-1, 1)


_while_probe_cta.launches = 0
