// The three operator applies of the 2D Newton and adjoint systems, each as
// a kernel of its own.
//
// Replaces three TPU kernels of vch_tpu/ops/pallas_kernels.py, each one
// pallas_call per apply (vmap over members):
//   - :101 schur_apply_pallas (body :85-98): S v = inv_dt v - L[(tau_dt + d)
//     v - (kappa/2) L v], L v = Lx v + v LyT;
//   - :133 adjoint_apply_pallas (body :119-130): A v = v - tau w + (dt/2)
//     (L w - f'' w), w = L v;
//   - :478 spectral_solve_pallas (body :466-475): Vx ((Vx^-1 v Vy^-T) /
//     denom) Vy^T, the exact solve of a polynomial in L whose symbol on the
//     eigenvalue grid is denom.
//
// What bounds them on an H100: four dependent (n x n)(n x m) products, 8 n^3
// FLOP per member: 2.2 MFLOP at n = m = 65, 136 MFLOP at n = 257, below what
// a launch's fixed latency lets the card use at the small sizes and far
// below the card's FP32 rate at all of them. The bound is then one member's
// chain of four products on the SMs it runs on, and the latency between
// them.
//
// All three (rows 13-15) run one member on a thread-block cluster of C CTAs
// (C from n alone: 4 at n <= 96, 8 at n <= 192, else 16, the non-portable
// size), launched with cudaLaunchKernelEx. CTA r of a cluster owns a band
// of about n / C rows of every field of its member, in its own shared
// memory:
//   - a right product X Op (Op = LyT, VyiT, VyT) is band-local: CTA r forms
//     X[band_r, :] Op, streaming Op's rows from L2;
//   - a left product Op X (Op = Lx, Vxi, Vx) sums over the peers' bands:
//     CTA r forms sum_p Op[band_r, band_p] X[band_p, :], reading X[band_p, :]
//     from peer p's shared memory (distributed shared memory) after a
//     cluster barrier, p in rank order.
// So the chain stays on chip: the intermediates live in shared memory, with
// one cluster barrier between the two halves of each apply, one after the
// field is loaded and one before exit (a CTA's shared memory must outlive
// its peers' reads). The product engine is tile4.cuh's. Each product is
// register-blocked: a thread accumulates 4 x 4 outputs per unit (one to
// four units) from float4 shared-memory reads of a k-major A slab and a
// row-major B slab; the slabs of chunk c + 1 load
// while chunk c's FMAs run (operator rows from L2 by 4-byte cp.async into a
// two-stage ring, a peer's band through registers), so a chunk's load
// latency is hidden behind the previous chunk's arithmetic. Ragged edges are
// padded in shared memory only (rows to a multiple of 4, columns to m rounded
// up to 4); the padded outputs are computed and dropped. Every output sums
// its k terms in ascending order whatever B is, and C depends on n alone, so
// a member's result is bit-identical at every batch size. Full float32 FMA
// throughout: no tensor cores, no TF32.
#include <mutex>

#include "tile4.cuh"

namespace vch {

enum { SCHUR_APPLY = 0, ADJOINT_APPLY = 1, SPECTRAL_SOLVE = 2 };

// Scalars: from a device array when scal is set (0-d tensors), else by value.
struct Scalars {
  const float* scal;
  float sv[3];
  __device__ __forceinline__ float operator[](int i) const {
    return scal ? scal[i] : sv[i];
  }
};

constexpr int MAX_CLUSTER = 16;
constexpr int MAX_UNITS = 4;    // 4 x 4 output units per thread, at most
constexpr int MAX_CHUNK = 4;    // bands' worth of operator rows per chunk

// Shared memory of one CTA: `fields` bands (rmax x mpad), a two-stage ring
// of B slabs (stage x mpad) and of k-major A slabs (stage x rpad).
inline size_t cluster_smem_bytes(const Geom& g, int fields) {
  return 4 * ((size_t)fields * g.rmax * g.mpad +
              2 * (size_t)g.stage * (g.mpad + g.rpad));
}


struct ClusterArgs {
  Scalars s;                      // Schur: inv_dt, tau_dt, kappa/2
  const float *A1, *B1, *A2, *B2; // Schur, adjoint: Lx, LyT, -, -;
                                  // spectral: Vxi, VyiT, Vx, VyT
  const float *f1, *v;            // d, f'' or denom; the field
  float* out;
  int n, m, f1_shared;
  Geom g;
};

template <int VAR, int S>
__global__ void __launch_bounds__(NT, 1) cluster_apply_kernel(ClusterArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const Geom g = a.g;
  const int n = a.n, m = a.m, tid = threadIdx.x;
  const int r = (int)cluster.block_rank(), b = blockIdx.x / g.C;
  const int r0 = band_start(g, r), R = band_rows(g, r);
  const int band = g.rmax * g.mpad;
  constexpr int NF = VAR == SPECTRAL_SOLVE ? 3 : 2;
  float* V = smem;                 // the field
  float* T = V + band;             // the intermediate the peers read
  float* X = T + band;             // spectral: the left product's result
  const Ring ring{smem + NF * band + 2 * g.stage * g.mpad, smem + NF * band,
                  g.stage * g.rpad, g.stage * g.mpad};
  const size_t mo = (size_t)b * n * m, ro = (size_t)r0 * m;
  const float* v = a.v + mo + ro;
  const float* f1 = a.f1 + (a.f1_shared ? 0 : mo) + ro;
  float* out = a.out + mo + ro;
  const Units<S> u(g);

  for (int e = tid, i = tid / m, j = tid - (tid / m) * m; e < R * m;
       e += NT) {
    V[i * g.mpad + j] = v[e];
    j += NT % m;
    i += NT / m;
    if (j >= m) {
      j -= m;
      ++i;
    }
  }
  cluster.sync();
  Acc<S> acc;
  if constexpr (VAR == SCHUR_APPLY) {
    const float inv_dt = a.s[0], tau_dt = a.s[1], hk = a.s[2];
    Acc<S> acc2;
    left_product<S>(acc, a.A1, V, n, r0, R, g, u, ring, cluster);
    right_product<S>(acc2, V, a.B1, m, R, g, u, ring);
    add_to<S>(acc, acc2);
    each_output<S>(acc, u, R, m, [&](int i, int j, float l) {
      T[i * g.mpad + j] = (tau_dt + f1[i * m + j]) * V[i * g.mpad + j] -
                          hk * l;
    });
    cluster.sync();
    left_product<S>(acc, a.A1, T, n, r0, R, g, u, ring, cluster);
    right_product<S>(acc2, T, a.B1, m, R, g, u, ring);
    add_to<S>(acc, acc2);
    each_output<S>(acc, u, R, m, [&](int i, int j, float l) {
      out[i * m + j] = inv_dt * V[i * g.mpad + j] - l;
    });
  } else if constexpr (VAR == ADJOINT_APPLY) {
    // T = w = L v, which the peers read; then L w
    const float tau = a.s[0], half_dt = a.s[1];
    Acc<S> acc2;
    left_product<S>(acc, a.A1, V, n, r0, R, g, u, ring, cluster);
    right_product<S>(acc2, V, a.B1, m, R, g, u, ring);
    add_to<S>(acc, acc2);
    each_output<S>(acc, u, R, m,
                   [&](int i, int j, float l) { T[i * g.mpad + j] = l; });
    cluster.sync();
    left_product<S>(acc, a.A1, T, n, r0, R, g, u, ring, cluster);
    right_product<S>(acc2, T, a.B1, m, R, g, u, ring);
    add_to<S>(acc, acc2);
    each_output<S>(acc, u, R, m, [&](int i, int j, float l) {
      const float w = T[i * g.mpad + j];
      out[i * m + j] = V[i * g.mpad + j] - tau * w +
                       half_dt * (l - f1[i * m + j] * w);
    });
  } else {
    left_product<S>(acc, a.A1, V, n, r0, R, g, u, ring, cluster);
    each_output<S>(acc, u, R, m,
              [&](int i, int j, float x) { X[i * g.mpad + j] = x; });
    __syncthreads();
    right_product<S>(acc, X, a.B1, m, R, g, u, ring);
    each_output<S>(acc, u, R, m, [&](int i, int j, float x) {
      T[i * g.mpad + j] = x / f1[i * m + j];
    });
    cluster.sync();
    left_product<S>(acc, a.A2, T, n, r0, R, g, u, ring, cluster);
    each_output<S>(acc, u, R, m,
              [&](int i, int j, float x) { X[i * g.mpad + j] = x; });
    __syncthreads();
    right_product<S>(acc, X, a.B2, m, R, g, u, ring);
    each_output<S>(acc, u, R, m,
              [&](int i, int j, float x) { out[i * m + j] = x; });
  }
  cluster.sync();   // peers may still read this CTA's bands
}

// Per device, what has been set up for one kernel instantiation: the
// dynamic shared-memory limit and the last geometry found to fit.
struct LaunchState {
  size_t smem_set = 0;
  bool nonportable = false;
  size_t fit_smem = 0;
  int fit_C = 0;
};

std::mutex launch_mutex;

template <int VAR, int S>
int launch_cluster(int B, const ClusterArgs& a, size_t smem,
                   cudaStream_t stream) {
  static LaunchState state[16];
  auto kern = cluster_apply_kernel<VAR, S>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 16) return (int)cudaErrorInvalidDevice;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.g.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(B * a.g.C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  {
    std::lock_guard<std::mutex> lock(launch_mutex);
    LaunchState& st = state[dev];
    if (smem > st.smem_set) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      st.smem_set = smem;
    }
    if (a.g.C > 8 && !st.nonportable) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
      st.nonportable = true;
    }
    if (st.fit_smem != smem || st.fit_C != a.g.C) {
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (clusters <= 0) return (int)cudaErrorLaunchOutOfResources;
      st.fit_smem = smem;
      st.fit_C = a.g.C;
    }
  }
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int VAR>
int launch_cluster_s(int S, int B, const ClusterArgs& a, size_t smem,
                     cudaStream_t stream) {
  switch (S) {
    case 1: return launch_cluster<VAR, 1>(B, a, smem, stream);
    case 2: return launch_cluster<VAR, 2>(B, a, smem, stream);
    case 3: return launch_cluster<VAR, 3>(B, a, smem, stream);
    default: return launch_cluster<VAR, 4>(B, a, smem, stream);
  }
}

}  // namespace vch

// One batch of applies. variant: 0 Schur (f1 = d; scalars inv_dt, tau_dt,
// kappa/2; needs Lx, LyT), 1 adjoint (f1 = f''(phi_n); scalars tau, dt/2;
// needs Lx, LyT), 2 spectral solve (f1 = denom; needs the four transforms).
// v and out are (B, n, m); f1 is (B, n, m), or (n, m) for all members with
// f1_shared. The scalars come from the device array scal when it is set,
// else from s0, s1, s2. The cluster geometry is that of
// ops/solve_kernels.py apply_geometry (cluster size, 4 x 4 units per
// thread, chunk factor f, dynamic shared-memory bytes), checked here
// against the kernel's own.
extern "C" int vch_apply_2d(
    int variant, const float* scal, float s0, float s1, float s2,
    const float* Lx, const float* LyT, const float* Vxi, const float* VyiT,
    const float* Vx, const float* VyT, const float* f1, const float* v,
    float* out, int B, int n, int m, int f1_shared, int cluster,
    int per_thread, int chunk, int smem_bytes, void* stream) {
  using namespace vch;
  const bool spectral = variant == SPECTRAL_SOLVE;
  if (variant < 0 || variant > 2 || B <= 0 || n <= 1 || m <= 1 || !f1 ||
      !v || !out || (!spectral && (!Lx || !LyT)) ||
      (spectral && (!Vxi || !VyiT || !Vx || !VyT)))
    return (int)cudaErrorInvalidValue;
  const Scalars s{scal, {s0, s1, s2}};
  const cudaStream_t st = (cudaStream_t)stream;
  if (cluster < 1 || cluster > MAX_CLUSTER || cluster > n || chunk < 1 ||
      chunk > MAX_CHUNK)
    return (int)cudaErrorInvalidValue;
  const Geom g = make_geom(n, m, cluster, chunk);
  const size_t smem = cluster_smem_bytes(g, spectral ? 3 : 2);
  if (per_thread < 1 || per_thread > MAX_UNITS ||
      g.units > per_thread * NT || g.units <= (per_thread - 1) * NT ||
      g.rmax * g.mpad > PF_MAX * 4 * NT || smem != (size_t)smem_bytes)
    return (int)cudaErrorInvalidValue;
  const ClusterArgs a{s, spectral ? Vxi : Lx, spectral ? VyiT : LyT, Vx,
                      VyT, f1, v, out, n, m, f1_shared, g};
  switch (variant) {
    case SCHUR_APPLY:
      return launch_cluster_s<SCHUR_APPLY>(per_thread, B, a, smem, st);
    case ADJOINT_APPLY:
      return launch_cluster_s<ADJOINT_APPLY>(per_thread, B, a, smem, st);
    default:
      return launch_cluster_s<SPECTRAL_SOLVE>(per_thread, B, a, smem, st);
  }
}
