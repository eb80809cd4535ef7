// The chain probes on Hopper designs: the counterparts of the TPU's serial
// product chain and interleaved chains (rows 20 and 21 of PERF.md's kernel
// table). Their first kernels (probes.cu chain_kernel<K>,
// chain_bf16_kernel<K>) stay as the bit oracles; the wrappers are in
// vch_tpu_torch/ops/probe_kernels.py.
//   - chain_cluster_kernel<K>: K members' chains x <- A x in full float32,
//     K members per thread-block cluster, every link the cluster engine's
//     left product (rows 20 and 21 "highest");
//   - chain_mma_kernel<RT>: the same chains with bf16 operands on the
//     tensor cores through mma.sync, K members per CTA, x resident in
//     shared memory across the links (row 21 "bf16").
#include "cluster.cuh"

namespace vch {
namespace chain {

using namespace cluster;

// --------------------------------------------------------------------------
// The float32 chain (rows 20 and 21 "highest").
//
// Replaces scripts/diag_march_sol.py:86 (`chain`, kernel at :74): L =
// mm_per_solve * AMORT dependent x <- a @ x products at HIGHEST precision in
// one cell, the march's serial-product floor; and the HIGHEST arm of
// scripts/diag_interleave.py:86 (kernel factory at :58): K independent
// chains of L links per cell, B / K cells. Cluster g holds the chains of
// members g K .. g K + K - 1, the script's X[k::K][:groups] mapping (chain
// k of cell g is member g K + k).
//
// What bounds it on an H100: each link depends on the last, so the chain
// runs at the latency of one product, not at the FMA rate: a 65^3 link is
// 0.55 MFLOP, ~1 us at one SM's share of the FP32 peak.
//
// Design: each link is exactly cluster::Block<K>::gemm_l_to, the left
// product the cluster march and sweep run (rows 1-6): a cluster barrier (the
// peers' bands of x are written), then CTA r computes its band of rows of
// the K members side by side, A's band and x's k rows streaming through the
// cp.async ring into 4 x 4 register units. With one field per member
// (fields = 1) the member stride is n^2, so X, out and work are used in
// place; operands ping-pong between out and work, ordered so that the last
// link writes out. Every output sums k ascending in one FMA chain from
// zero, as common.cuh's gemm_l does, so the bits are chain_kernel<K>'s at
// every cluster size. The engine's reductions are not used: no static
// shared memory.
template <int K>
__global__ void __launch_bounds__(NT)
    chain_cluster_kernel(const float* A, const float* X, float* out,
                         float* work, int n, int L, BGeom g) {
  extern __shared__ float4 smem4[];
  Block<K> blk(g, n, n, 1, out, reinterpret_cast<float*>(smem4), nullptr);
  const size_t off = (size_t)blk.b0 * n * n;
  const float* src = X + off;
  for (int l = 0; l < L; ++l) {
    float* dst = (((L - 1 - l) & 1) ? work : out) + off;
    blk.gemm_l_to(A, src, dst);
    src = dst;
  }
}

// Per device: the attributes set so far on chain_cluster_kernel<K>.
template <int K>
LaunchState (&launch_state())[16] {
  static LaunchState state[16];
  return state;
}

template <int K>
int max_clusters_of(int n, int C, int kc, int smem_bytes) {
  return cluster::max_clusters<K>((const void*)chain_cluster_kernel<K>,
                                  launch_state<K>(), n, n, C, kc, smem_bytes);
}

template <int K>
int launch_cluster(const float* A, const float* X, float* out, float* work,
                   int B, int n, int L, int C, int kc, int smem_bytes,
                   cudaStream_t stream) {
  BGeom g;
  int err = check_geometry<K>(n, n, C, kc, smem_bytes, g);
  if (err) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  err = configure((const void*)chain_cluster_kernel<K>, launch_state<K>(),
                  cfg, attr, B / K, C, smem_bytes, stream);
  if (err) return err;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, chain_cluster_kernel<K>, A,
                                           X, out, work, n, L, g);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------------------
// The bf16 chain (row 21 "bf16").
//
// Replaces the Precision.DEFAULT arm of scripts/diag_interleave.py:86: on
// the TPU a DEFAULT-precision float32 product rounds both operands to bf16
// once and accumulates in float32. Each link here rounds A and x to bf16
// (round to nearest even) and multiplies them on the tensor cores with
// float32 accumulators; out is the last link's float32 value. A probe
// only: no solver path reaches it (ROADMAP "No TF32").
//
// What bounds it: a 65^3 link is 0.55 MFLOP (80^3 with the padding), far
// below the tensor cores' rate; the chain is bound by each link's latency.
// The first design paid a global round trip of x, two CTA barriers and a
// per-warp float scratch for every 16 x 16 tile, every link.
//
// Design: one CTA per K members; n is padded to NP = 16 RT (65 -> 80).
//   - bf16(A) is loaded once per launch into registers: every warp holds the
//     mma A fragments of all RT x RT tiles (ldmatrix, 4 registers a tile:
//     100 at RT = 5), so a warp owns every row tile of the columns it
//     computes and no A operand is read from shared memory again;
//   - x lives in shared memory as bf16, double-buffered, K members' (NP, NP)
//     tiles with a row stride of NP + 8 elements (rows on distinct banks
//     for ldmatrix): a warp takes a 16-column slab of one member, loads its
//     B fragments with ldmatrix.trans, one per k tile, and runs
//     mma.sync.m16n8k16 bf16 -> f32 over the RT row tiles, k tiles
//     ascending from a zero accumulator;
//   - the accumulators are rounded to bf16 and written straight into the
//     other buffer, zero outside the (n, n) field, so one __syncthreads per
//     link orders the links; only the last link's float32 accumulators go
//     to out.
// Shared memory: 2 K NP (NP + 8) bf16, 225,280 bytes at K = 8, n = 65.
// ldmatrix and mma.sync come from mma_bf16.cuh. Each output sums its k tiles in the order of the wmma kernel, whose
// 16 x 16 x 16 step is two m16n8k16 steps on this card, and rounds each
// link's float32 sum to bf16 once, as that kernel does.
constexpr int MMA_MAX_RT = 5;         // row tiles of 16: n <= 80

constexpr size_t mma_smem_bytes(int n, int K) {
  return (size_t)2 * K * mma_np(n) * (mma_np(n) + 8) * sizeof(__nv_bfloat16);
}

template <int RT>
__global__ void __launch_bounds__(NT, 1)
    chain_mma_kernel(const float* A, const float* X, float* out, int n,
                     int K, int L) {
  constexpr int NPAD = 16 * RT, XS = NPAD + 8, PP = NPAD * XS;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* const buf0 = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* const buf1 = buf0 + (size_t)K * PP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t nn = (size_t)n * n;
  const size_t off = (size_t)blockIdx.x * K * nn;
  // bf16(A) into buffer 1 (free until link 0's epilogue), the K members'
  // bf16(x) into buffer 0, both zero outside the (n, n) field
  for (int e = tid; e < PP; e += NT) {
    const int i = e / XS, j = e - i * XS;
    buf1[e] = __float2bfloat16_rn(i < n && j < n ? A[i * n + j] : 0.f);
  }
  for (int e = tid; e < K * PP; e += NT) {
    const int b = e / PP, r = e - b * PP, i = r / XS, j = r - i * XS;
    buf0[e] = __float2bfloat16_rn(
        i < n && j < n ? X[off + b * nn + (size_t)i * n + j] : 0.f);
  }
  __syncthreads();
  // A's fragments: tile (ti, kk) rows ti 16 + (lane % 16), columns
  // kk 16 + 8 (lane / 16): a0..a3 in mma's order
  unsigned a[RT][RT][4];
#pragma unroll
  for (int ti = 0; ti < RT; ++ti)
#pragma unroll
    for (int kk = 0; kk < RT; ++kk)
      ldsm_x4(a[ti][kk],
              buf1 + (ti * 16 + (lane & 15)) * XS + kk * 16 + (lane >> 4) * 8);
  __syncthreads();                    // buffer 1 is link 0's output
  const int gr = lane >> 2, gc = (lane & 3) * 2;   // accumulator layout
  for (int l = 0; l < L; ++l) {
    const __nv_bfloat16* src = (l & 1) ? buf1 : buf0;
    __nv_bfloat16* dst = (l & 1) ? buf0 : buf1;
    const bool last = l == L - 1;
    for (int s = warp; s < K * RT; s += NWARP) {   // 16-column slabs
      const int b = s / RT, j0 = (s - b * RT) * 16;
      const __nv_bfloat16* xb = src + (size_t)b * PP;
      float acc[RT][2][4];
#pragma unroll
      for (int ti = 0; ti < RT; ++ti)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[ti][h][q] = 0.f;
#pragma unroll
      for (int kk = 0; kk < RT; ++kk) {
        // B fragments of the slab's two 8-column tiles: x rows kk 16 +
        // (lane % 16), columns j0 + 8 (lane / 16), transposed
        unsigned bf[4];
        ldsm_x4_trans(bf, xb + (kk * 16 + (lane & 15)) * XS + j0 +
                              (lane >> 4) * 8);
#pragma unroll
        for (int ti = 0; ti < RT; ++ti) {
          mma_bf16(acc[ti][0], a[ti][kk], bf[0], bf[1]);
          mma_bf16(acc[ti][1], a[ti][kk], bf[2], bf[3]);
        }
      }
      if (last) {
        float* ob = out + off + b * nn;
#pragma unroll
        for (int ti = 0; ti < RT; ++ti)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int i = ti * 16 + gr + 8 * hr, j = j0 + 8 * h + gc;
              if (i >= n) continue;
              if (j < n) ob[(size_t)i * n + j] = acc[ti][h][2 * hr];
              if (j + 1 < n) ob[(size_t)i * n + j + 1] = acc[ti][h][2 * hr + 1];
            }
      } else {
        __nv_bfloat16* db = dst + (size_t)b * PP;
#pragma unroll
        for (int ti = 0; ti < RT; ++ti)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int i = ti * 16 + gr + 8 * hr, j = j0 + 8 * h + gc;
              const bool row = i < n;
              const float v0 = row && j < n ? acc[ti][h][2 * hr] : 0.f;
              const float v1 = row && j + 1 < n ? acc[ti][h][2 * hr + 1] : 0.f;
              *reinterpret_cast<__nv_bfloat162*>(db + i * XS + j) =
                  __floats2bfloat162_rn(v0, v1);
            }
      }
    }
    __syncthreads();                  // dst complete before the next link
  }
}

template <int RT>
int launch_mma(const float* A, const float* X, float* out, int B, int n,
               int K, int L, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(n, K);
  const cudaError_t err = cudaFuncSetAttribute(
      chain_mma_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  chain_mma_kernel<RT><<<B / K, NT, smem, stream>>>(A, X, out, n, K, L);
  return (int)cudaGetLastError();
}

inline bool chain_args_ok(const float* A, const float* X, const float* out,
                          int B, int n, int K, int L) {
  return A && X && out && B > 0 && n > 1 && L >= 1 &&
         (K == 1 || K == 2 || K == 4 || K == 8) && B % K == 0;
}

}  // namespace chain
}  // namespace vch

// How many clusters of `cluster` CTAs of the float32 chain with `members`
// members per cluster (1, 2, 4, 8) can be resident at once on the current
// card with this geometry; a negative CUDA error code on failure. The
// signature of the other cluster kernels' queries (segment must be 0, m
// must be n).
extern "C" int vch_chain_cluster_max_clusters(int members, int segment,
                                              int n, int m, int cluster,
                                              int kc, int smem_bytes) {
  using namespace vch::chain;
  if (segment || m != n) return -(int)cudaErrorInvalidValue;
  switch (members) {
    case 1: return max_clusters_of<1>(n, cluster, kc, smem_bytes);
    case 2: return max_clusters_of<2>(n, cluster, kc, smem_bytes);
    case 4: return max_clusters_of<4>(n, cluster, kc, smem_bytes);
    case 8: return max_clusters_of<8>(n, cluster, kc, smem_bytes);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// K-interleaved float32 chains on clusters: B / K clusters of `cluster`
// CTAs, cluster g holding members g K .. g K + K - 1 of the (B, n, n) batch
// X; L >= 1 links out_b = A^L X_b; work is a second (B, n, n) buffer. The
// geometry (cluster, kc, smem_bytes) is ops/march.py blocked_geometry's for
// kernel "chain", checked here against the kernel's own.
extern "C" int vch_matmul_chain_cluster(const float* A, const float* X,
                                        float* out, float* work, int B, int n,
                                        int K, int L, int cluster, int kc,
                                        int smem_bytes, void* stream) {
  using namespace vch::chain;
  if (!chain_args_ok(A, X, out, B, n, K, L) || !work)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 1: return launch_cluster<1>(A, X, out, work, B, n, L, cluster, kc,
                                     smem_bytes, s);
    case 2: return launch_cluster<2>(A, X, out, work, B, n, L, cluster, kc,
                                     smem_bytes, s);
    case 4: return launch_cluster<4>(A, X, out, work, B, n, L, cluster, kc,
                                     smem_bytes, s);
    default: return launch_cluster<8>(A, X, out, work, B, n, L, cluster, kc,
                                      smem_bytes, s);
  }
}

// The bf16 chains on the tensor cores: B / K CTAs, CTA g holding members
// g K .. g K + K - 1 of X (B, n, n); L >= 1 links; n <= 80 and
// 2 K pad16(n) (pad16(n) + 8) bf16 of shared memory within the card's
// 232,448 bytes a block.
extern "C" int vch_matmul_chain_mma(const float* A, const float* X,
                                    float* out, int B, int n, int K, int L,
                                    void* stream) {
  using namespace vch::chain;
  if (!chain_args_ok(A, X, out, B, n, K, L) ||
      vch::mma_np(n) > 16 * MMA_MAX_RT ||
      mma_smem_bytes(n, K) > 232448)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (vch::mma_np(n) / 16) {
    case 1: return launch_mma<1>(A, X, out, B, n, K, L, s);
    case 2: return launch_mma<2>(A, X, out, B, n, K, L, s);
    case 3: return launch_mma<3>(A, X, out, B, n, K, L, s);
    case 4: return launch_mma<4>(A, X, out, B, n, K, L, s);
    default: return launch_mma<5>(A, X, out, B, n, K, L, s);
  }
}
