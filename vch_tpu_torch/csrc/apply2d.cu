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
// The adjoint apply (row 14) keeps the PR-4 design: one CTA per member on
// common.cuh's 48 x 48 SIMT tiles, its intermediate in a global workspace,
// summing in the order of the solve kernels of solve2d.cu.
//
// The Schur apply and the spectral solve (rows 13 and 15) run one member on
// a thread-block cluster of C CTAs (C from n alone: 4 at n <= 96, 8 at
// n <= 192, else 16, the non-portable size), launched with
// cudaLaunchKernelEx. CTA r of a cluster owns a band of about
// n / C rows of every field of its member, in its own shared memory:
//   - a right product X Op (Op = LyT, VyiT, VyT) is band-local: CTA r forms
//     X[band_r, :] Op, streaming Op's rows from L2;
//   - a left product Op X (Op = Lx, Vxi, Vx) sums over the peers' bands:
//     CTA r forms sum_p Op[band_r, band_p] X[band_p, :], reading X[band_p, :]
//     from peer p's shared memory (distributed shared memory) after a
//     cluster barrier, p in rank order.
// So the chain stays on chip: the intermediates live in shared memory, with
// one cluster barrier between the two halves of each apply, one after the
// field is loaded and one before exit (a CTA's shared memory must outlive
// its peers' reads). Each product is register-blocked: a thread accumulates
// 4 x 4 outputs per unit (one to four units) from float4 shared-memory reads
// of a k-major A slab and a row-major B slab; the slabs of chunk c + 1 load
// while chunk c's FMAs run (operator rows from L2 by 4-byte cp.async into a
// two-stage ring, a peer's band through registers), so a chunk's load
// latency is hidden behind the previous chunk's arithmetic. Ragged edges are
// padded in shared memory only (rows to a multiple of 4, columns to m rounded
// up to 4); the padded outputs are computed and dropped. Every output sums
// its k terms in ascending order whatever B is, and C depends on n alone, so
// a member's result is bit-identical at every batch size. Full float32 FMA
// throughout: no tensor cores, no TF32.
#include <cooperative_groups.h>

#include <mutex>

#include "common.cuh"

namespace cg = cooperative_groups;

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

// ---- row 14: one CTA per member ---------------------------------------

struct AdjointArgs {
  Scalars s;                      // tau, dt/2
  const float *Lx, *LyT, *fpp, *v;
  float *out, *work;              // work: one (n, m) field per member
  int n, m, f1_shared;
};

__global__ void __launch_bounds__(NT) adjoint_apply_kernel(AdjointArgs a) {
  __shared__ Smem sm;
  const int n = a.n, m = a.m, nm = n * m;
  const size_t mo = (size_t)blockIdx.x * nm;
  const float* v = a.v + mo;
  const float* fpp = a.fpp + (a.f1_shared ? 0 : mo);
  float* out = a.out + mo;
  float* T1 = a.work + mo;
  const float tau = a.s[0], half_dt = a.s[1];
  lap_gemm<1>(a.Lx, a.LyT, v, 0, n, m, sm,
              [&](int, int e, float l) { T1[e] = l; });
  lap_gemm<1>(a.Lx, a.LyT, T1, 0, n, m, sm, [&](int, int e, float l) {
    const float w = T1[e];
    out[e] = v[e] - tau * w + half_dt * (l - fpp[e] * w);
  });
}

// ---- rows 13 and 15: one member per cluster ---------------------------

constexpr int MAX_CLUSTER = 16;
constexpr int MAX_UNITS = 4;    // 4 x 4 output units per thread, at most
constexpr int PF_MAX = 12;      // float4s of a peer band per thread in flight
constexpr int MAX_CHUNK = 4;    // bands' worth of operator rows per chunk

// The cluster's split of an (n, m) member, the same on host and device (the
// Python wrapper computes it too, ops/solve_kernels.py apply_geometry). A
// chunk of a left product is one peer band; of a right product, ks = f rmax
// rows of the operator (f = 4, 3, 2 or 1, the largest whose ring fits in
// shared memory): fewer chunks cost fewer barriers and round trips.
struct Geom {
  int C, q, rem;      // band p: rows [p q + min(p, rem), ...), q + (p < rem)
  int rmax, rpad;     // rows of the largest band; padded to a multiple of 4
  int mpad;           // m padded to a multiple of 4: every row stride
  int units;          // 4 x 4 output units of a band
  int ks, stage;      // rows per right chunk; rows of a ring stage
};

__host__ __device__ inline Geom make_geom(int n, int m, int C, int f) {
  Geom g;
  g.C = C;
  g.q = n / C;
  g.rem = n % C;
  g.rmax = g.q + (g.rem > 0);
  g.rpad = (g.rmax + 3) & ~3;
  g.mpad = (m + 3) & ~3;
  g.units = (g.rpad / 4) * (g.mpad / 4);
  g.ks = f * g.rmax < m ? f * g.rmax : m;
  g.stage = g.ks > g.rmax ? g.ks : g.rmax;
  return g;
}

__host__ __device__ inline int band_start(const Geom& g, int p) {
  return p * g.q + (p < g.rem ? p : g.rem);
}

__host__ __device__ inline int band_rows(const Geom& g, int p) {
  return g.q + (p < g.rem);
}

// Shared memory of one CTA: `fields` bands (rmax x mpad), a two-stage ring
// of B slabs (stage x mpad) and of k-major A slabs (stage x rpad).
inline size_t cluster_smem_bytes(const Geom& g, int fields) {
  return 4 * ((size_t)fields * g.rmax * g.mpad +
              2 * (size_t)g.stage * (g.mpad + g.rpad));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This thread's output units: unit u = tid + s NT covers band rows
// aoff[s] .. +3 and columns boff[s] .. +3; the first nu are valid. The warp
// computes its first nw slots (nw is the same in every lane); a lane's slot
// past its nu reads unit 0's operands and its outputs are dropped, so the
// product loop has no branch per unit.
template <int S>
struct Units {
  int aoff[S], boff[S], nu, nw;
  __device__ explicit Units(const Geom& g) {
    const int cgs = g.mpad / 4, warp0 = threadIdx.x & ~31;
    nu = nw = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int u = threadIdx.x + s * NT;
      const bool ok = u < g.units;
      aoff[s] = ok ? 4 * (u / cgs) : 0;
      boff[s] = ok ? 4 * (u % cgs) : 0;
      if (ok) nu = s + 1;
      if (warp0 + s * NT < g.units) nw = s + 1;
    }
  }
};

template <int S>
using Acc = float[S][4][4];

template <int S>
__device__ __forceinline__ void zero(Acc<S>& acc) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[s][i][j] = 0.f;
}

// acc[0:NS] += As^T Bs over kc k-steps: As k-major (row stride rpad), Bs
// row-major (row stride mpad); k ascending. No branch inside, so the loads
// of every slot and the next k-step issue ahead of the FMAs.
template <int S, int NS>
__device__ __forceinline__ void mma_slots(Acc<S>& acc, const float* As,
                                          const float* Bs, int kc,
                                          const Geom& g, const Units<S>& u) {
#pragma unroll 2
  for (int k = 0; k < kc; ++k) {
    const float* ak = As + k * g.rpad;
    const float* bk = Bs + k * g.mpad;
    float4 a[NS], b[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      a[s] = *reinterpret_cast<const float4*>(ak + u.aoff[s]);
      b[s] = *reinterpret_cast<const float4*>(bk + u.boff[s]);
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float av[4] = {a[s].x, a[s].y, a[s].z, a[s].w};
      const float bv[4] = {b[s].x, b[s].y, b[s].z, b[s].w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[s][i][j] = fmaf(av[i], bv[j], acc[s][i][j]);
    }
  }
}

// The warp's nw slots, chosen once per chunk (warp-uniform).
template <int S, int NS = S>
__device__ __forceinline__ void mma_chunk(Acc<S>& acc, const float* As,
                                          const float* Bs, int kc,
                                          const Geom& g, const Units<S>& u) {
  if constexpr (NS > 0) {
    if (u.nw == NS)
      mma_slots<S, NS>(acc, As, Bs, kc, g, u);
    else
      mma_chunk<S, NS - 1>(acc, As, Bs, kc, g, u);
  }
}

// The shared-memory ring both products stream through.
struct Ring {
  float *A, *B;       // two stages each
  int a_stage, b_stage;
};

// acc = Op[r0:r0+R, :] X, X's rows spread over the cluster: band p of X is
// the `field` band of rank p (the same shared-memory offset in every CTA).
// Op (n x n) row-major in device memory. Chunk p = peer p's band.
template <int S>
__device__ void left_product(Acc<S>& acc, const float* __restrict__ Op,
                             float* field, int n, int r0, int R,
                             const Geom& g, const Units<S>& u, const Ring& ring,
                             cg::cluster_group& cluster) {
  const int tid = threadIdx.x;
  float4 pf[PF_MAX];
  zero(acc);
  auto issue_a = [&](int p, int st) {     // As[k][i] = Op[r0 + i][p0 + k]
    const int p0 = band_start(g, p), kc = band_rows(g, p);
    float* As = ring.A + st * ring.a_stage;
    const float* src = Op + (size_t)r0 * n + p0;
    for (int e = tid; e < R * kc; e += NT) {
      const int i = e / kc, k = e - i * kc;
      cp_async4(As + k * g.rpad + i, src + (size_t)i * n + k);
    }
    cp_async_commit();
  };
  auto fetch_b = [&](int p) {             // peer p's band into registers
    const float4* src =
        reinterpret_cast<const float4*>(cluster.map_shared_rank(field, p));
    const int cnt = band_rows(g, p) * g.mpad / 4;
#pragma unroll
    for (int t = 0; t < PF_MAX; ++t) {
      const int e = tid + t * NT;
      if (e < cnt) pf[t] = src[e];
    }
  };
  auto store_b = [&](int p, int st) {
    float4* dst = reinterpret_cast<float4*>(ring.B + st * ring.b_stage);
    const int cnt = band_rows(g, p) * g.mpad / 4;
#pragma unroll
    for (int t = 0; t < PF_MAX; ++t) {
      const int e = tid + t * NT;
      if (e < cnt) dst[e] = pf[t];
    }
  };
  issue_a(0, 0);
  fetch_b(0);
  store_b(0, 0);
  for (int p = 0; p < g.C; ++p) {
    const bool next = p + 1 < g.C;
    if (next) {
      issue_a(p + 1, (p + 1) & 1);
      fetch_b(p + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mma_chunk<S>(acc, ring.A + (p & 1) * ring.a_stage,
                 ring.B + (p & 1) * ring.b_stage, band_rows(g, p), g, u);
    if (next) store_b(p + 1, (p + 1) & 1);
    __syncthreads();
  }
}

// acc = X[0:R, :] Op, X this CTA's band (row stride mpad) and Op (m x m)
// row-major in device memory, in chunks of ks rows of Op.
template <int S>
__device__ void right_product(Acc<S>& acc, const float* X,
                              const float* __restrict__ Op, int m, int R,
                              const Geom& g, const Units<S>& u,
                              const Ring& ring) {
  const int tid = threadIdx.x;
  const int nch = (m + g.ks - 1) / g.ks;
  const int dk = NT / m, dj = NT - dk * m;
  zero(acc);
  auto issue = [&](int c, int st) {
    const int k0 = c * g.ks, kc = min(g.ks, m - k0);
    float* Bs = ring.B + st * ring.b_stage;
    float* As = ring.A + st * ring.a_stage;
    const float* src = Op + (size_t)k0 * m;
    int k = tid / m, j = tid - (tid / m) * m;
    for (int e = tid; e < kc * m; e += NT) {   // Bs[k][j] = Op[k0 + k][j]
      cp_async4(Bs + k * g.mpad + j, src + e);
      j += dj;
      k += dk;
      if (j >= m) {
        j -= m;
        ++k;
      }
    }
    cp_async_commit();
    for (int e = tid; e < R * kc; e += NT) {   // As[k][i] = X[i][k0 + k]
      const int i = e / kc, kk = e - i * kc;
      As[kk * g.rpad + i] = X[i * g.mpad + k0 + kk];
    }
  };
  issue(0, 0);
  for (int c = 0; c < nch; ++c) {
    const bool next = c + 1 < nch;
    if (next) {
      issue(c + 1, (c + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mma_chunk<S>(acc, ring.A + (c & 1) * ring.a_stage,
                 ring.B + (c & 1) * ring.b_stage,
                 min(g.ks, m - c * g.ks), g, u);
    __syncthreads();
  }
}

// f(i, j, x) for every valid output (band row i < R, column j < m) of the
// units.
template <int S, class F>
__device__ __forceinline__ void each_output(const Acc<S>& a,
                                            const Units<S>& u, int R, int m,
                                            F f) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (s >= u.nu) continue;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int i = u.aoff[s] + ii, j = u.boff[s] + jj;
        if (i < R && j < m) f(i, j, a[s][ii][jj]);
      }
  }
}

// a += b: the Laplacian's two products, each rounded, then added.
template <int S>
__device__ __forceinline__ void add_to(Acc<S>& a, const Acc<S>& b) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[s][i][j] += b[s][i][j];
}

struct ClusterArgs {
  Scalars s;                      // Schur: inv_dt, tau_dt, kappa/2
  const float *A1, *B1, *A2, *B2; // Schur: Lx, LyT, -, -; spectral: Vxi,
                                  // VyiT, Vx, VyT
  const float *f1, *v;            // d or denom; the field
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
  constexpr int NF = VAR == SCHUR_APPLY ? 2 : 3;
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
// else from s0, s1, s2. The adjoint apply takes work, one (n, m) field per
// member; the other two take the cluster geometry of
// ops/solve_kernels.py apply_geometry (cluster size, 4 x 4 units per
// thread, chunk factor f, dynamic shared-memory bytes), checked here
// against the kernel's own, and no workspace.
extern "C" int vch_apply_2d(
    int variant, const float* scal, float s0, float s1, float s2,
    const float* Lx, const float* LyT, const float* Vxi, const float* VyiT,
    const float* Vx, const float* VyT, const float* f1, const float* v,
    float* out, float* work, int B, int n, int m, int f1_shared, int cluster,
    int per_thread, int chunk, int smem_bytes, void* stream) {
  using namespace vch;
  const bool spectral = variant == SPECTRAL_SOLVE;
  if (variant < 0 || variant > 2 || B <= 0 || n <= 1 || m <= 1 || !f1 ||
      !v || !out || (!spectral && (!Lx || !LyT)) ||
      (spectral && (!Vxi || !VyiT || !Vx || !VyT)))
    return (int)cudaErrorInvalidValue;
  const Scalars s{scal, {s0, s1, s2}};
  const cudaStream_t st = (cudaStream_t)stream;
  if (variant == ADJOINT_APPLY) {
    if (!work) return (int)cudaErrorInvalidValue;
    const AdjointArgs a{s, Lx, LyT, f1, v, out, work, n, m, f1_shared};
    adjoint_apply_kernel<<<B, NT, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
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
  return spectral ? launch_cluster_s<SPECTRAL_SOLVE>(per_thread, B, a, smem, st)
                  : launch_cluster_s<SCHUR_APPLY>(per_thread, B, a, smem, st);
}
