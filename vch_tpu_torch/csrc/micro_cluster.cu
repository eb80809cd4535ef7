// The member-blocked primitives on a Hopper design: the counterpart of the
// TPU's member-blocked microbench (row 18 of PERF.md's kernel table). Its
// first kernel (probes.cu micro_kernel<VAR, BB>, one CTA) stays as the bit
// oracle; the wrapper is blocked_microbench in
// vch_tpu_torch/ops/probe_kernels.py.
#include <climits>

#include "cluster.cuh"

namespace vch {
namespace micro {

using namespace cluster;

// the order of probes.cu's enum and of ops/probe_kernels.py VARIANTS
enum {
  SERIAL_ONE = 0, MEMBER_MM, LEFT_MM, STACKED_MM, SWAP, SWAP_MM, GDOT,
  MEMBER_DOT, N_VARIANTS
};

// --------------------------------------------------------------------------
// Replaces scripts/diag_blocked_microbench.py:100 (`build`, kernel at :56):
// one cell applies one step to the (BB n, n) stack X of BB members k times
// (fori_loop at :96), in eight variants (probes.cu lists them); the last
// step's per-member sums ||X_b||^2 go to `sums` (zeros for the variants
// without reductions).
//
// What bounds it on an H100: each step depends on the last, so a launch
// runs at the latency of k steps, not at a rate: a product step is 2 n^3
// FLOPs a member (0.55 MFLOP at n = 65), a few microseconds of one cluster's
// SMs; swap, gdot and member_dot move BB n^2 floats a step.
//
// Design: the block of BB members on one thread-block cluster of C CTAs, on
// cluster.cuh's engine with one field per member, so the member stride is
// n^2 and X, out and work are the engine's fields as they lie; CTA r owns
// band r of rows of every member. The variants map as the blocked march
// maps its primitives, the probe's per-member products kept apart from its
// stacked ones:
//   serial_one  member 0's right product on a Block<1> view (band-local: no
//               cluster barrier); members 1.. are copied to out once;
//   member_mm   BB right products on Block<1> views, one after another;
//   left_mm     BB left products on Block<1> views, each after the engine's
//               cluster barrier;
//   stacked_mm  Block<BB>::gemm_r, one pass over the members' stacked bands;
//   swap_mm     the same stacked right product with X_b^T read into the A
//               slab (product<false, true>), after a cluster barrier: row
//               li of X_b^T is column li of X_b, which crosses every band;
//   swap        X_b^T * 1.0000001 over every thread of the cluster, after a
//               cluster barrier;
//   gdot, member_dot  Block<BB>::reduce (pair reductions broadcast through
//               DSMEM, in block_sum's order), then the factor and the scale
//               pass over the cluster, as probes.cu computes them.
// Steps ping-pong between out and work so that the last writes out. Every
// product output sums k ascending in one FMA chain from zero, as common.cuh's
// products do, and the reductions keep block_sum's order, so out and sums
// are micro_kernel<VAR, BB>'s bits at every cluster size.
template <int VAR, int BB>
__global__ void __launch_bounds__(NT)
    micro_cluster_kernel(const float* Cm, const float* X, float* out,
                         float* work, float* sums, int n, int k, BGeom g) {
  extern __shared__ float4 smem4[];
  __shared__ float red[1][BB][NWARP];
  __shared__ float ssum[BB];
  float* const smem = reinterpret_cast<float*>(smem4);
  Block<BB> blk(g, n, n, 1, out, smem, red);
  const BGeom g1 = make_bgeom<1>(n, n, g.band.C, g.kc);   // one member
  Block<1> one(g1, n, n, 1, out, smem, nullptr);
  const int nn = n * n, total = BB * nn;
  const int first = blk.rank * NT + blk.tid, stride = blk.C * NT;
  if (blk.tid < BB) ssum[blk.tid] = 0.f;
  if constexpr (VAR == SERIAL_ONE)
    for (int e = nn + first; e < total; e += stride) out[e] = X[e];
  const float* src = X;
  for (int step = 0; step < k; ++step) {
    float* dst = ((k - 1 - step) & 1) ? work : out;
    if constexpr (VAR == SERIAL_ONE) {
      one.gemm_r_to(src, Cm, dst);
    } else if constexpr (VAR == MEMBER_MM) {
      for (int b = 0; b < BB; ++b)
        one.gemm_r_to(src + (size_t)b * nn, Cm, dst + (size_t)b * nn);
    } else if constexpr (VAR == LEFT_MM) {
      for (int b = 0; b < BB; ++b)
        one.gemm_l_to(Cm, src + (size_t)b * nn, dst + (size_t)b * nn);
    } else if constexpr (VAR == STACKED_MM) {
      blk.gemm_r_to(src, Cm, dst);
    } else if constexpr (VAR == SWAP_MM) {
      blk.cluster.sync();
      blk.template product<false, true>(
          Cm, src, [](int, int) { return None{}; },
          [=](int b, int e, float x, None) { dst[(size_t)b * nn + e] = x; });
    } else if constexpr (VAR == SWAP) {
      blk.cluster.sync();
      for (int e = first; e < total; e += stride) {
        const int b = e / nn, r = e - b * nn, i = r / n, j = r - i * n;
        dst[e] = __fmul_rn(src[(size_t)b * nn + (size_t)j * n + i],
                           1.0000001f);
      }
    } else {                            // GDOT, MEMBER_DOT
      blk.template reduce<1, false>(
          0.f, blk.all, [&](int b, int e) { return src[(size_t)b * nn + e]; },
          [](int, int, float v, float (&p)[1]) { p[0] += v * v; },
          [&](int b, const float (&v)[1]) { ssum[b] = v[0]; });
      float f = 1.f;
      if constexpr (VAR == MEMBER_DOT) {
#pragma unroll
        for (int b = 0; b < BB; ++b)
          f = __fadd_rn(f, __fmul_rn(1e-12f, ssum[b]));
      }
      for (int e = first; e < total; e += stride) {
        const float fac =
            VAR == GDOT ? __fadd_rn(1.f, __fmul_rn(1e-12f, ssum[e / nn])) : f;
        dst[e] = __fmul_rn(src[e], fac);
      }
    }
    src = dst;
  }
  if (blk.rank == 0 && blk.tid < BB) sums[blk.tid] = ssum[blk.tid];
}

// --------------------------------------------------------------------------
// launchers

struct Launch {
  const float *Cm, *X;
  float *out, *work, *sums;
  int n, k, cluster, kc, smem_bytes;
  cudaStream_t stream;
};

// Per device: the attributes set so far on micro_cluster_kernel<VAR, BB>.
template <int VAR, int BB>
LaunchState (&launch_state())[16] {
  static LaunchState state[16];
  return state;
}

template <int VAR, int BB>
int launch_one(const Launch& a) {
  BGeom g;
  int err = check_geometry<BB>(a.n, a.n, a.cluster, a.kc, a.smem_bytes, g);
  if (err) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  err = configure((const void*)micro_cluster_kernel<VAR, BB>,
                  launch_state<VAR, BB>(), cfg, attr, 1, a.cluster,
                  a.smem_bytes, a.stream);
  if (err) return err;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, micro_cluster_kernel<VAR, BB>,
                                           a.Cm, a.X, a.out, a.work, a.sums,
                                           a.n, a.k, g);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int VAR, int BB>
int clusters_one(int n, int C, int kc, int smem_bytes) {
  return max_clusters<BB>((const void*)micro_cluster_kernel<VAR, BB>,
                          launch_state<VAR, BB>(), n, n, C, kc, smem_bytes);
}

template <int VAR>
int launch_bb(int bb, const Launch& a) {
  switch (bb) {
    case 1: return launch_one<VAR, 1>(a);
    case 2: return launch_one<VAR, 2>(a);
    case 4: return launch_one<VAR, 4>(a);
    default: return launch_one<VAR, 8>(a);
  }
}

template <int VAR>
int clusters_bb(int bb, int n, int C, int kc, int smem_bytes) {
  switch (bb) {
    case 1: return clusters_one<VAR, 1>(n, C, kc, smem_bytes);
    case 2: return clusters_one<VAR, 2>(n, C, kc, smem_bytes);
    case 4: return clusters_one<VAR, 4>(n, C, kc, smem_bytes);
    default: return clusters_one<VAR, 8>(n, C, kc, smem_bytes);
  }
}

inline bool block_ok(int bb) {
  return bb == 1 || bb == 2 || bb == 4 || bb == 8;
}

}  // namespace micro
}  // namespace vch

// How many clusters of `cluster` CTAs of the microbench with `members`
// members per cluster (1, 2, 4, 8) can be resident at once on the current
// card with this geometry: the fewest of its eight variants' kernels (each
// has its own registers); a negative CUDA error code on failure. The
// signature of the other cluster kernels' queries (segment must be 0, m
// must be n).
extern "C" int vch_micro_cluster_max_clusters(int members, int segment,
                                              int n, int m, int cluster,
                                              int kc, int smem_bytes) {
  using namespace vch::micro;
  if (segment || m != n || !block_ok(members))
    return -(int)cudaErrorInvalidValue;
  const int b = members, C = cluster, sm = smem_bytes;
  const int each[N_VARIANTS] = {
      clusters_bb<SERIAL_ONE>(b, n, C, kc, sm),
      clusters_bb<MEMBER_MM>(b, n, C, kc, sm),
      clusters_bb<LEFT_MM>(b, n, C, kc, sm),
      clusters_bb<STACKED_MM>(b, n, C, kc, sm),
      clusters_bb<SWAP>(b, n, C, kc, sm),
      clusters_bb<SWAP_MM>(b, n, C, kc, sm),
      clusters_bb<GDOT>(b, n, C, kc, sm),
      clusters_bb<MEMBER_DOT>(b, n, C, kc, sm)};
  int fewest = INT_MAX;
  for (int c : each) {
    if (c < 0) return c;
    fewest = c < fewest ? c : fewest;
  }
  return fewest;
}

// One cluster of `cluster` CTAs: k >= 1 steps of `variant` (0 serial_one ..
// 7 member_dot, the order of the enum) on the (bb n, n) stack X, bb in
// {1, 2, 4, 8}; out and work are (bb n, n), sums (bb,). The geometry
// (cluster, kc, smem_bytes) is ops/march.py blocked_geometry's for kernel
// "micro" with bb members, checked here against the kernel's own.
extern "C" int vch_blocked_microbench_cluster(
    int variant, const float* C, const float* X, float* out, float* work,
    float* sums, int n, int bb, int k, int cluster, int kc, int smem_bytes,
    void* stream) {
  using namespace vch::micro;
  if (!C || !X || !out || !work || !sums || n <= 1 || k < 1 ||
      variant < 0 || variant >= N_VARIANTS || !block_ok(bb))
    return (int)cudaErrorInvalidValue;
  const Launch a{C, X, out, work, sums, n, k, cluster, kc, smem_bytes,
                 (cudaStream_t)stream};
  switch (variant) {
    case SERIAL_ONE: return launch_bb<SERIAL_ONE>(bb, a);
    case MEMBER_MM: return launch_bb<MEMBER_MM>(bb, a);
    case LEFT_MM: return launch_bb<LEFT_MM>(bb, a);
    case STACKED_MM: return launch_bb<STACKED_MM>(bb, a);
    case SWAP: return launch_bb<SWAP>(bb, a);
    case SWAP_MM: return launch_bb<SWAP_MM>(bb, a);
    case GDOT: return launch_bb<GDOT>(bb, a);
    default: return launch_bb<MEMBER_DOT>(bb, a);
  }
}
