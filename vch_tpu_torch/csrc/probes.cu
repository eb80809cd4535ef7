// Kernel cost probes on one CTA: the counterparts of the four TPU probes
// under scripts/ that reach pl.pallas_call, each on the one-CTA tile code of
// common.cuh, which the bit oracles of the cluster kernels still run (the
// march, the sweep and the solves themselves run on cluster.cuh's engine):
//   - chain_kernel<K>: K members' chains x <- A x per CTA, L links each;
//     since rows 20 and 21 "highest" of PERF.md's kernel table moved to
//     chain_cluster.cu, only the bit oracle of that kernel;
//   - chain_bf16_kernel<K>: the same chains with bf16 operands on the tensor
//     cores; since row 21 "bf16" moved to chain_cluster.cu, only the oracle
//     of that kernel;
//   - micro_kernel<VAR, BB>: k dependent steps of one primitive on BB
//     members in one CTA; since row 18 moved to micro_cluster.cu, only the
//     bit oracle of that kernel;
//   - while_kernel: nested data-dependent loops with a carry in shared
//     memory across steps; since row 19 moved to while_fused.cu (phi in
//     registers, one reduction a trip), only the bit oracle of that kernel.
// Every array is float32 in device memory; the wrappers are in
// vch_tpu_torch/ops/probe_kernels.py.
#include <cuda_bf16.h>
#include <mma.h>

#include "common.cuh"

namespace vch {

// --------------------------------------------------------------------------
// The serial product chain (rows 20 and 21 "highest").
//
// Replaces scripts/diag_march_sol.py:86 (`chain`, kernel at :76): L =
// mm_per_solve * AMORT dependent x <- a @ x products at HIGHEST precision in
// one cell, the march's serial-product floor; and the HIGHEST arm of
// scripts/diag_interleave.py:86 (kernel factory at :56): K independent
// chains of L links per cell, B / K cells. CTA g holds the chains of members
// g K .. g K + K - 1, which is the script's X[k::K][:groups] mapping (chain k
// of cell g is member g K + k).
//
// What bounds it on an H100: operations, in one CTA. A 65^3 product is 0.55
// MFLOP, ~1 us at one SM's share of the FP32 peak (67 TFLOP/s / 132), but
// each link depends on the last, so the chain runs at the latency of
// gemm_l's tile walk (global loads of each 48 x 16 stage, two barriers per
// stage), not at the FMA rate.
//
// Design: each link is exactly gemm_l<K>(A, X) of common.cuh, the product
// the march and the solves run, with the K fields side by side (K chains
// interleaved in one CTA: one tile walk over the stacked width). Operands
// ping-pong between `out` and `work`, ordered so that the last link writes
// `out`; nothing is copied between links.
template <int K>
__global__ void __launch_bounds__(NT)
    chain_kernel(const float* A, const float* X, float* out, float* work,
                 int n, int L) {
  __shared__ Smem sm;
  const size_t nn = (size_t)n * n;
  const size_t off = (size_t)blockIdx.x * K * nn;
  const float* src = X + off;
  for (int l = 0; l < L; ++l) {
    float* dst = (((L - 1 - l) & 1) ? work : out) + off;
    gemm_l<K>(A, src, nn, n, n, n, sm,
              [&](int b, int e, float v) { dst[b * nn + e] = v; });
    src = dst;
  }
}

// --------------------------------------------------------------------------
// The bf16 chain (row 21 "bf16").
//
// Replaces the Precision.DEFAULT arm of scripts/diag_interleave.py:86: on
// the TPU a DEFAULT-precision float32 product rounds both operands to bf16
// once and accumulates in float32. Each link here rounds A and x to bf16
// (round to nearest even) and multiplies them on the tensor cores with
// nvcuda::wmma 16 x 16 x 16 fragments and float accumulators; the float32
// result is stored for the next link. This is the only reduced-precision
// product in the package and no solver path reaches it: every solve keeps
// full float32 FMA (the repo's invariant 1, ROADMAP "No TF32"), because the
// adjoint's condition ~1e6 does not survive 8-bit mantissas.
//
// What bounds it: operations on the tensor cores, far from their rate: a
// 65^3 link is 0.55 MFLOP, 80^3 with the padding. Design: n is padded to a
// multiple of 16 (65 -> 80) in shared memory: bf16(A) once per launch, the
// K members' bf16(x) once per link; the 8 warps share the K (np/16)^2 output
// tiles; each tile's accumulator goes through a per-warp 16 x 16 float
// scratch to the valid elements of the destination.
namespace wm = nvcuda::wmma;
constexpr int WT = 16;                  // wmma tile edge

__host__ __device__ constexpr int pad16(int n) { return (n + WT - 1) / WT * WT; }

constexpr size_t bf16_chain_smem(int n, int K) {
  return (size_t)pad16(n) * pad16(n) * (1 + K) * sizeof(__nv_bfloat16) +
         (size_t)NWARP * WT * WT * sizeof(float);
}

template <int K>
__global__ void __launch_bounds__(NT)
    chain_bf16_kernel(const float* A, const float* X, float* out, float* work,
                      int n, int L) {
  extern __shared__ __align__(128) unsigned char dsm[];
  const int np = pad16(n), nt = np / WT, pp = np * np;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(dsm);
  __nv_bfloat16* Xs = As + pp;          // K members, (np, np) each
  float* scr = reinterpret_cast<float*>(Xs + (size_t)K * pp) +
               (threadIdx.x >> 5) * WT * WT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t nn = (size_t)n * n;
  const size_t off = (size_t)blockIdx.x * K * nn;
  for (int e = tid; e < pp; e += NT) {
    const int i = e / np, j = e - i * np;
    As[e] = __float2bfloat16_rn(i < n && j < n ? A[i * n + j] : 0.f);
  }
  const float* src = X + off;
  for (int l = 0; l < L; ++l) {
    float* dst = (((L - 1 - l) & 1) ? work : out) + off;
    for (int e = tid; e < K * pp; e += NT) {
      const int b = e / pp, r = e - b * pp, i = r / np, j = r - i * np;
      Xs[e] = __float2bfloat16_rn(i < n && j < n ? src[b * nn + i * n + j]
                                                 : 0.f);
    }
    __syncthreads();
    for (int t = warp; t < K * nt * nt; t += NWARP) {
      const int b = t / (nt * nt), tt = t - b * nt * nt;
      const int ti = tt / nt, tj = tt - ti * nt;
      wm::fragment<wm::accumulator, WT, WT, WT, float> acc;
      wm::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < nt; ++kk) {
        wm::fragment<wm::matrix_a, WT, WT, WT, __nv_bfloat16, wm::row_major>
            fa;
        wm::fragment<wm::matrix_b, WT, WT, WT, __nv_bfloat16, wm::row_major>
            fb;
        wm::load_matrix_sync(fa, As + ti * WT * np + kk * WT, np);
        wm::load_matrix_sync(fb, Xs + (size_t)b * pp + kk * WT * np + tj * WT,
                             np);
        wm::mma_sync(acc, fa, fb, acc);
      }
      wm::store_matrix_sync(scr, acc, WT, wm::mem_row_major);
      __syncwarp();
      for (int e = lane; e < WT * WT; e += 32) {
        const int i = ti * WT + e / WT, j = tj * WT + e % WT;
        if (i < n && j < n) dst[b * nn + i * n + j] = scr[e];
      }
      __syncwarp();
    }
    __syncthreads();                    // dst complete before the next read
    src = dst;
  }
}

// --------------------------------------------------------------------------
// The member-blocked primitives (row 18, now micro_cluster.cu's cluster
// kernel, whose bit oracle this one-CTA kernel is).
//
// Replaces scripts/diag_blocked_microbench.py:100 (`build`, kernel at :56):
// one cell applies one step to the (BB n, n) stack X of BB members k times
// (fori_loop at :96), in eight variants:
//   serial_one   X_0 <- X_0 C, the other members unchanged;
//   member_mm    X_b <- X_b C, one product per member;
//   left_mm      X_b <- C X_b, one product per member;
//   stacked_mm   X <- X C as one (BB n, n) product;
//   swap         X_b <- X_b^T * 1.0000001, elementwise;
//   swap_mm      X_b <- X_b^T C as one stacked product;
//   gdot         X_b <- X_b (1 + 1e-12 ||X_b||^2), per member;
//   member_dot   X <- X (1 + sum_b 1e-12 ||X_b||^2), one factor for all
//                members (the script's functools.reduce at :89-92).
// The last step's per-member sums ||X_b||^2 go to `sums` (zeros for the
// variants without reductions): on these inputs both factors round to 1 in
// float32, so gdot and member_dot return X unchanged and the sums are what
// shows that the reductions ran.
//
// What bounds it on an H100: the products' operations at a latency far above
// the FMA rate (one CTA, dependent steps), as chain_kernel; swap by bytes.
//
// Design: the products are common.cuh's building blocks themselves, mapped
// as the blocked march maps them: gemm_r<1> per member (serial_one,
// member_mm), gemm_l<1> per member (left_mm), gemm_r<BB> (stacked_mm). The
// member-local transpose of swap_mm is folded into the stacked product's
// operand read (gemm_rt below): on this card a transpose inside a product is
// an index map, not a relayout. gdot and member_dot reduce with
// member_sums<BB> / block_sum<BB>. Steps ping-pong between `out` and `work`
// so that the last writes `out`; serial_one copies the other members to
// `out` once.
enum {
  SERIAL_ONE = 0, MEMBER_MM, LEFT_MM, STACKED_MM, SWAP, SWAP_MM, GDOT,
  MEMBER_DOT, N_VARIANTS
};

// C_b = X_b^T A for each (n, n) member X_b = X + b * xs, as one product of
// the transposed members stacked with A; epi(b, idx, C_b[idx]). gemm_r with
// the transpose in the operand index.
template <int BB, class Epi>
__device__ void gemm_rt(const float* X, size_t xs, const float* A, int n,
                        Smem& sm, Epi epi) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int tall = BB * n;
  const int nti = (tall + TILE - 1) / TILE, ntj = (n + TILE - 1) / TILE;
  auto a_at = [&](int i, int k) {
    if (i >= tall || k >= n) return 0.f;
    int li;
    const int b = split<BB>(i, n, li);
    return X[b * xs + (size_t)k * n + li];       // (X_b^T)[li, k]
  };
  auto b_at = [&](int k, int j) {
    return (k < n && j < n) ? A[(size_t)k * n + j] : 0.f;
  };
  for (int t = 0; t < nti * ntj; ++t) {
    const int i0 = (t / ntj) * TILE, j0 = (t % ntj) * TILE;
    float acc[MR][MR] = {};
    gemm_acc(acc, a_at, b_at, n, i0, j0, sm);
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int c = 0; c < MR; ++c) {
        const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * c;
        if (i < tall && j < n) {
          int li;
          const int b = split<BB>(i, n, li);
          epi(b, li * n + j, acc[r][c]);
        }
      }
  }
  __syncthreads();
}

template <int VAR, int BB>
__global__ void __launch_bounds__(NT)
    micro_kernel(const float* C, const float* X, float* out, float* work,
                 float* sums, int n, int k) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const size_t nn = (size_t)n * n;
  const int total = BB * (int)nn;
  float s[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) s[b] = 0.f;
  if constexpr (VAR == SERIAL_ONE)
    for (int e = (int)nn + tid; e < total; e += NT) out[e] = X[e];
  const float* src = X;
  for (int step = 0; step < k; ++step) {
    float* dst = ((k - 1 - step) & 1) ? work : out;
    auto put = [&](int b, int e, float v) { dst[b * nn + e] = v; };
    if constexpr (VAR == SERIAL_ONE) {
      gemm_r<1>(src, 0, C, n, n, n, sm, put);
    } else if constexpr (VAR == MEMBER_MM) {
      for (int b = 0; b < BB; ++b)
        gemm_r<1>(src + b * nn, 0, C, n, n, n, sm,
                  [&](int, int e, float v) { dst[b * nn + e] = v; });
    } else if constexpr (VAR == LEFT_MM) {
      for (int b = 0; b < BB; ++b)
        gemm_l<1>(C, src + b * nn, 0, n, n, n, sm,
                  [&](int, int e, float v) { dst[b * nn + e] = v; });
    } else if constexpr (VAR == STACKED_MM) {
      gemm_r<BB>(src, nn, C, n, n, n, sm, put);
    } else if constexpr (VAR == SWAP) {
      for (int e = tid; e < total; e += NT) {
        const int b = e / (int)nn, r = e - b * (int)nn, i = r / n,
                  j = r - i * n;
        dst[e] = __fmul_rn(src[b * nn + (size_t)j * n + i], 1.0000001f);
      }
      __syncthreads();
    } else if constexpr (VAR == SWAP_MM) {
      gemm_rt<BB>(src, nn, C, n, sm, put);
    } else {                            // GDOT, MEMBER_DOT
      member_sums<BB>(s, (int)nn, sm, [&](int b, int e) {
        const float v = src[b * nn + e];
        return v * v;
      });
      float fac[BB];
      if constexpr (VAR == GDOT) {
#pragma unroll
        for (int b = 0; b < BB; ++b)
          fac[b] = __fadd_rn(1.f, __fmul_rn(1e-12f, s[b]));
      } else {
        float f = 1.f;
#pragma unroll
        for (int b = 0; b < BB; ++b) f = __fadd_rn(f, __fmul_rn(1e-12f, s[b]));
#pragma unroll
        for (int b = 0; b < BB; ++b) fac[b] = f;
      }
#pragma unroll
      for (int b = 0; b < BB; ++b)
        for (int e = tid; e < (int)nn; e += NT)
          dst[b * nn + e] = __fmul_rn(src[b * nn + e], fac[b]);
      __syncthreads();
    }
    src = dst;
  }
  if (tid == 0)
#pragma unroll
    for (int b = 0; b < BB; ++b) sums[b] = s[b];
}

// --------------------------------------------------------------------------
// In-kernel control flow (row 19).
//
// Replaces scripts/probe_pallas_while.py:67 (kernel at :19): per member b, at
// grid step m = 0 the carry is loaded from x_b and ns_b set to 0; each of M
// steps runs an outer loop of at most 50 trips, each with an inner loop of at
// most 12 trips (trial = phi (1 - 0.3 alpha), accept when sum trial^2 <=
// sum phi^2, else halve alpha), then phi <- phi (1 - 0.3 alpha), leaving
// when ||phi|| < 1e-3; each step's outer trips are added to ns_b.
//
// What bounds it: operations, three block reductions per outer trip on n^2
// elements; far below any rate, it checks constructs, not speed. Design: one
// CTA per member; the script's sequential grid dimension m becomes a loop in
// the block, and phi is carried across the M steps in static shared memory
// (WHILE_MAX_ELEMS floats: 65^2 is 16.9 KB; larger n is refused). Each
// thread only ever touches its own elements e = tid, tid + NT, ..., so the
// carry needs no barrier of its own; every predicate comes from
// block_sum<1>, which every thread receives identically, so both loops are
// CTA-uniform. ns_b is written once, at the end.
constexpr int WHILE_MAX_ELEMS = 10240;

__global__ void __launch_bounds__(NT)
    while_kernel(const float* x, float* out, int* ns, int n, int M) {
  __shared__ Smem sm;
  __shared__ float phi[WHILE_MAX_ELEMS];
  const int tid = threadIdx.x, nn = n * n;
  const size_t mo = (size_t)blockIdx.x * nn;
  int count = 0;
  for (int m = 0; m < M; ++m) {
    if (m == 0) {
      for (int e = tid; e < nn; e += NT) phi[e] = x[mo + e];
      count = 0;
    }
    int trips = 0;
    bool done = false;
    while (!done && trips < 50) {
      float alpha = 1.f;
      bool acc = false;
      for (int j = 0; !acc && j < 12; ++j) {
        const float f = __fsub_rn(1.f, __fmul_rn(0.3f, alpha));
        float st[1] = {0.f}, sp[1] = {0.f};
        for (int e = tid; e < nn; e += NT) {
          const float p = phi[e], t = __fmul_rn(p, f);
          st[0] += t * t;
          sp[0] += p * p;
        }
        block_sum<1>(st, sm);
        block_sum<1>(sp, sm);
        acc = st[0] <= sp[0];
        if (!acc) alpha *= 0.5f;
      }
      const float f = __fsub_rn(1.f, __fmul_rn(0.3f, alpha));
      float s2[1] = {0.f};
      for (int e = tid; e < nn; e += NT) {
        const float p = __fmul_rn(phi[e], f);
        phi[e] = p;
        s2[0] += p * p;
      }
      block_sum<1>(s2, sm);
      ++trips;
      done = sqrtf(s2[0]) < 1e-3f;
    }
    count += trips;
  }
  for (int e = tid; e < nn; e += NT) out[mo + e] = phi[e];
  if (tid == 0) ns[blockIdx.x] = count;
}

// --------------------------------------------------------------------------
// launchers

template <int K>
int launch_chain(int groups, int bf16, const float* A, const float* X,
                 float* out, float* work, int n, int L, cudaStream_t s) {
  if (bf16) {
    const size_t smem = bf16_chain_smem(n, K);
    cudaError_t err = cudaFuncSetAttribute(
        chain_bf16_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    chain_bf16_kernel<K><<<groups, NT, smem, s>>>(A, X, out, work, n, L);
  } else {
    chain_kernel<K><<<groups, NT, 0, s>>>(A, X, out, work, n, L);
  }
  return (int)cudaGetLastError();
}

template <int VAR>
int launch_micro(int bb, const float* C, const float* X, float* out,
                 float* work, float* sums, int n, int k, cudaStream_t s) {
  switch (bb) {
    case 1: micro_kernel<VAR, 1><<<1, NT, 0, s>>>(C, X, out, work, sums, n, k);
      break;
    case 2: micro_kernel<VAR, 2><<<1, NT, 0, s>>>(C, X, out, work, sums, n, k);
      break;
    case 4: micro_kernel<VAR, 4><<<1, NT, 0, s>>>(C, X, out, work, sums, n, k);
      break;
    case 8: micro_kernel<VAR, 8><<<1, NT, 0, s>>>(C, X, out, work, sums, n, k);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace vch

extern "C" int vch_while_max_elems() { return vch::WHILE_MAX_ELEMS; }

// K-interleaved chains: B / K CTAs, CTA g holding members g K .. g K + K - 1
// of the (B, n, n) batch X; L >= 1 links out_b = A^L X_b, full float32
// (bf16 = 0) or bf16 operands on the tensor cores (bf16 = 1). work is a
// second (B, n, n) buffer.
extern "C" int vch_matmul_chain(const float* A, const float* X, float* out,
                                float* work, int B, int n, int K, int L,
                                int bf16, void* stream) {
  if (!A || !X || !out || !work || B <= 0 || n <= 1 || L < 1 ||
      (K != 1 && K != 2 && K != 4 && K != 8) || B % K != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int g = B / K;
  switch (K) {
    case 1: return vch::launch_chain<1>(g, bf16, A, X, out, work, n, L, s);
    case 2: return vch::launch_chain<2>(g, bf16, A, X, out, work, n, L, s);
    case 4: return vch::launch_chain<4>(g, bf16, A, X, out, work, n, L, s);
    default: return vch::launch_chain<8>(g, bf16, A, X, out, work, n, L, s);
  }
}

// One CTA: k >= 1 steps of `variant` (0 serial_one .. 7 member_dot, the
// order of the enum) on the (bb n, n) stack X, bb in {1, 2, 4, 8}; out and
// work are (bb n, n), sums (bb,).
extern "C" int vch_blocked_microbench(int variant, const float* C,
                                      const float* X, float* out, float* work,
                                      float* sums, int n, int bb, int k,
                                      void* stream) {
  if (!C || !X || !out || !work || !sums || n <= 1 || k < 1 ||
      variant < 0 || variant >= vch::N_VARIANTS)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case vch::SERIAL_ONE:
      return vch::launch_micro<vch::SERIAL_ONE>(bb, C, X, out, work, sums, n, k, s);
    case vch::MEMBER_MM:
      return vch::launch_micro<vch::MEMBER_MM>(bb, C, X, out, work, sums, n, k, s);
    case vch::LEFT_MM:
      return vch::launch_micro<vch::LEFT_MM>(bb, C, X, out, work, sums, n, k, s);
    case vch::STACKED_MM:
      return vch::launch_micro<vch::STACKED_MM>(bb, C, X, out, work, sums, n, k, s);
    case vch::SWAP:
      return vch::launch_micro<vch::SWAP>(bb, C, X, out, work, sums, n, k, s);
    case vch::SWAP_MM:
      return vch::launch_micro<vch::SWAP_MM>(bb, C, X, out, work, sums, n, k, s);
    case vch::GDOT:
      return vch::launch_micro<vch::GDOT>(bb, C, X, out, work, sums, n, k, s);
    default:
      return vch::launch_micro<vch::MEMBER_DOT>(bb, C, X, out, work, sums, n, k, s);
  }
}

// One CTA per member of the (B, n, n) batch x: M steps of the nested loops;
// out (B, n, n), ns (B,) int32 outer trips per member.
extern "C" int vch_while_probe(const float* x, float* out, int* ns, int B,
                               int n, int M, void* stream) {
  if (!x || !out || !ns || B <= 0 || n <= 0 || M < 1 ||
      n * n > vch::WHILE_MAX_ELEMS)
    return (int)cudaErrorInvalidValue;
  vch::while_kernel<<<B, vch::NT, 0, (cudaStream_t)stream>>>(x, out, ns, n, M);
  return (int)cudaGetLastError();
}
