// The register-blocked FP32 product engine of the cluster kernels.
//
// A thread-block cluster of C CTAs splits an (n, m) field into C bands of
// rows (Geom: band p holds rows band_start(g, p) .. + band_rows(g, p)).
// A product accumulates 4 x 4 output units per thread (Units, Acc) from
// float4 shared-memory reads of a k-major A slab and a row-major B slab
// (mma_slots, mma_chunk: k ascending, one FMA chain per output, no branch
// per unit), the slabs streaming through a two-stage shared-memory ring
// filled by cp.async (Ring). left_product and right_product are the two
// products of one member's band (apply2d.cu); each_output and add_to are
// their epilogue helpers. The cluster march and sweep (cluster.cuh) run a
// block's stacked products on the same units and slot loop. Full
// float32 FMA: no tensor cores, no TF32.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace vch {

namespace cg = cooperative_groups;

constexpr int PF_MAX = 12;      // float4s of a peer band per thread in flight

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

// This thread's output units: unit u = first + tid + s NT covers rows
// aoff[s] .. +3 and columns boff[s] .. +3 of the product; the first nu are
// valid. The warp computes its first nw slots (nw is the same in every
// lane); a lane's slot past its nu reads unit 0's operands and its outputs
// are dropped, so the product loop has no branch per unit. A product with
// more units than S NT runs in passes, `first` the pass's first unit.
template <int S>
struct Units {
  int aoff[S], boff[S], nu, nw;
  __device__ explicit Units(const Geom& g, int first = 0) {
    const int cgs = g.mpad / 4, warp0 = first + (threadIdx.x & ~31);
    nu = nw = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int u = first + threadIdx.x + s * NT;
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

}  // namespace vch
