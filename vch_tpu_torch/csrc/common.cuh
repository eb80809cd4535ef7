// Shared device building blocks of the fused march and adjoint kernels.
//
// One CTA of NT threads owns BB scenario members (BB = 1: the per-member
// kernels; BB > 1: the member-blocked ones) for the whole time loop. Every
// field is an (n, m) row-major float32 array in device memory (the members'
// workspace or an input); member b's copy of a field lies at `base + b * ms`
// for the field's member stride ms. The operator matrices are shared by all
// CTAs and stay L2-resident. The building blocks are
//   - gemm_l / gemm_r / lap_gemm: CTA-wide tiled SIMT FP32 products (no
//     tensor cores, no TF32: full float32 FMA) with an elementwise epilogue
//     functor epi(b, idx, value) applied to every valid output element of
//     every member. gemm_l is a shared operator times each member's field,
//     run as one product over the members' fields stacked side by side;
//     gemm_r is each member's field times a shared operator, run as one
//     product over the fields stacked one above the other; lap_gemm runs
//     its two products per member tile. Each output element sums its k
//     terms in the same order whatever the tiling, so a member's products
//     are bit-identical for every BB;
//   - block_sum / block_min: CTA-wide reductions of BB per-member values
//     whose results every thread receives identically, so every loop
//     predicate built from them is CTA-uniform and every thread takes the
//     same branch around the __syncthreads() inside the building blocks.
//     Per-member partial sums are taken over e = tid, tid + NT, ... of the
//     member's own field, the same for every BB, so a member's reductions are
//     bit-identical for every BB too.
// Epilogues must not write a field that the same product reads (other tiles
// still read it); each building block ends with __syncthreads(), so its
// outputs are visible to the whole CTA when it returns.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vch {

constexpr int NT = 256;                 // threads per CTA (16 x 16)
constexpr int MR = 3;                   // per-thread micro-tile edge
constexpr int TILE = 16 * MR;           // CTA output tile edge (48)
constexpr int KT = 16;                  // k depth of one shared-memory stage
constexpr int NWARP = NT / 32;
constexpr int MAX_BB = 8;               // members per CTA, at most

struct Smem {
  float As[KT][TILE + 1];               // A tile, k-major (+1: no bank clash)
  float Bs[KT][TILE];
  float red[MAX_BB][NWARP];
};

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;     // propagates NaN like jnp.min
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;     // propagates NaN like jnp.maximum
}

__device__ __forceinline__ float nan_clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);   // jnp.clip keeps NaN
}

// Per-member sums over the CTA, in place; every thread gets the same values
// (same order).
template <int BB>
__device__ __forceinline__ void block_sum(float (&v)[BB], Smem& sm) {
#pragma unroll
  for (int b = 0; b < BB; ++b)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[b] += __shfl_xor_sync(0xffffffffu, v[b], off);
  __syncthreads();                      // previous readers of sm.red are done
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int b = 0; b < BB; ++b) sm.red[b][threadIdx.x >> 5] = v[b];
  __syncthreads();
#pragma unroll
  for (int b = 0; b < BB; ++b) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) s += sm.red[b][w];
    v[b] = s;
  }
}

// Per-member NaN-propagating minima over the CTA, in place.
template <int BB>
__device__ __forceinline__ void block_min(float (&v)[BB], Smem& sm) {
#pragma unroll
  for (int b = 0; b < BB; ++b)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[b] = nan_min(v[b], __shfl_xor_sync(0xffffffffu, v[b], off));
  __syncthreads();
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int b = 0; b < BB; ++b) sm.red[b][threadIdx.x >> 5] = v[b];
  __syncthreads();
#pragma unroll
  for (int b = 0; b < BB; ++b) {
    float s = sm.red[b][0];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) s = nan_min(s, sm.red[b][w]);
    v[b] = s;
  }
}

// Member and in-member index of a stacked index g (len per member).
template <int BB>
__device__ __forceinline__ int split(int g, int len, int& local) {
  if (BB == 1) {
    local = g;
    return 0;
  }
  const int b = g / len;
  local = g - b * len;
  return b;
}

// acc += A[i0:i0+TILE, :K] * B[:K, j0:j0+TILE] for this thread's MR x MR
// outputs (rows i0 + ty + 16 r, columns j0 + tx + 16 c); a_at(i, k) and
// b_at(k, j) return the operands, zero outside the product.
template <class AAt, class BAt>
__device__ __forceinline__ void gemm_acc(float (&acc)[MR][MR], AAt a_at,
                                         BAt b_at, int K, int i0, int j0,
                                         Smem& sm) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int k0 = 0; k0 < K; k0 += KT) {
    for (int e = tid; e < TILE * KT; e += NT) {
      const int kk = e % KT, ii = e / KT;
      sm.As[kk][ii] = a_at(i0 + ii, k0 + kk);
    }
    for (int e = tid; e < KT * TILE; e += NT) {
      const int jj = e % TILE, kk = e / TILE;
      sm.Bs[kk][jj] = b_at(k0 + kk, j0 + jj);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      float a[MR], b[MR];
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        a[r] = sm.As[kk][ty + 16 * r];
        b[r] = sm.Bs[kk][tx + 16 * r];
      }
#pragma unroll
      for (int r = 0; r < MR; ++r)
#pragma unroll
        for (int c = 0; c < MR; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
}

// C_b = A (rows x K) * X_b (K x cols), X_b = X + b * xs, as one product of A
// with the members' fields side by side; epi(b, idx, C_b[idx]).
template <int BB, class Epi>
__device__ void gemm_l(const float* A, const float* X, size_t xs, int rows,
                       int K, int cols, Smem& sm, Epi epi) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int wide = BB * cols;
  const int nti = (rows + TILE - 1) / TILE, ntj = (wide + TILE - 1) / TILE;
  auto a_at = [&](int i, int k) {
    return (i < rows && k < K) ? A[(size_t)i * K + k] : 0.f;
  };
  auto b_at = [&](int k, int j) {
    if (k >= K || j >= wide) return 0.f;
    int lj;
    const int b = split<BB>(j, cols, lj);
    return X[b * xs + (size_t)k * cols + lj];
  };
  for (int t = 0; t < nti * ntj; ++t) {
    const int i0 = (t / ntj) * TILE, j0 = (t % ntj) * TILE;
    float acc[MR][MR] = {};
    gemm_acc(acc, a_at, b_at, K, i0, j0, sm);
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int c = 0; c < MR; ++c) {
        const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * c;
        if (i < rows && j < wide) {
          int lj;
          const int b = split<BB>(j, cols, lj);
          epi(b, i * cols + lj, acc[r][c]);
        }
      }
  }
  __syncthreads();
}

// C_b = X_b (rows x K) * A (K x cols), X_b = X + b * xs, as one product of
// the members' fields stacked (BB rows x K) with A; epi(b, idx, C_b[idx]).
template <int BB, class Epi>
__device__ void gemm_r(const float* X, size_t xs, const float* A, int rows,
                       int K, int cols, Smem& sm, Epi epi) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int tall = BB * rows;
  const int nti = (tall + TILE - 1) / TILE, ntj = (cols + TILE - 1) / TILE;
  auto a_at = [&](int i, int k) {
    if (i >= tall || k >= K) return 0.f;
    int li;
    const int b = split<BB>(i, rows, li);
    return X[b * xs + (size_t)li * K + k];
  };
  auto b_at = [&](int k, int j) {
    return (k < K && j < cols) ? A[(size_t)k * cols + j] : 0.f;
  };
  for (int t = 0; t < nti * ntj; ++t) {
    const int i0 = (t / ntj) * TILE, j0 = (t % ntj) * TILE;
    float acc[MR][MR] = {};
    gemm_acc(acc, a_at, b_at, K, i0, j0, sm);
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int c = 0; c < MR; ++c) {
        const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * c;
        if (i < tall && j < cols) {
          int li;
          const int b = split<BB>(i, rows, li);
          epi(b, li * cols + j, acc[r][c]);
        }
      }
  }
  __syncthreads();
}

// 2D Neumann Laplacian of each member's (n, m) field V_b = V + b * vs:
// epi(b, idx, (Lx V_b)[idx] + (V_b LyT)[idx]), the two products rounded
// separately and then added, as Lx@v + v@LyT.
template <int BB, class Epi>
__device__ void lap_gemm(const float* Lx, const float* LyT, const float* V,
                         size_t vs, int n, int m, Smem& sm, Epi epi) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nti = (n + TILE - 1) / TILE, ntj = (m + TILE - 1) / TILE;
  const int per = nti * ntj;
  for (int t = 0; t < BB * per; ++t) {
    const int b = BB == 1 ? 0 : t / per, tt = t - b * per;
    const int i0 = (tt / ntj) * TILE, j0 = (tt % ntj) * TILE;
    const float* v = V + b * vs;
    auto lx_at = [&](int i, int k) {
      return (i < n && k < n) ? Lx[(size_t)i * n + k] : 0.f;
    };
    auto v_kj = [&](int k, int j) {
      return (k < n && j < m) ? v[(size_t)k * m + j] : 0.f;
    };
    auto v_ik = [&](int i, int k) {
      return (i < n && k < m) ? v[(size_t)i * m + k] : 0.f;
    };
    auto ly_at = [&](int k, int j) {
      return (k < m && j < m) ? LyT[(size_t)k * m + j] : 0.f;
    };
    float a1[MR][MR] = {}, a2[MR][MR] = {};
    gemm_acc(a1, lx_at, v_kj, n, i0, j0, sm);
    gemm_acc(a2, v_ik, ly_at, m, i0, j0, sm);
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int c = 0; c < MR; ++c) {
        const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * c;
        if (i < n && j < m) epi(b, i * m + j, a1[r][c] + a2[r][c]);
      }
  }
  __syncthreads();
}

// Per-member partial sums of f(b, e) over the CTA's share of each member's
// elements, reduced with block_sum.
template <int BB, class F>
__device__ __forceinline__ void member_sums(float (&out)[BB], int nm,
                                            Smem& sm, F f) {
#pragma unroll
  for (int b = 0; b < BB; ++b) {
    float p = 0.f;
    for (int e = threadIdx.x; e < nm; e += NT) p += f(b, e);
    out[b] = p;
  }
  block_sum<BB>(out, sm);
}

template <int BB>
__device__ __forceinline__ bool any_of(const bool (&v)[BB]) {
  bool a = false;
#pragma unroll
  for (int b = 0; b < BB; ++b) a = a || v[b];
  return a;
}

constexpr float EPS_DIV = 1e-30f;

// Krylov vectors of one blocked solve, each a member-strided field: iterate,
// residual, search directions, the shadow residual R0, the best iterate BX,
// and the preconditioned copies PH and SH of P and S (PH == P and SH == S
// are allowed: no preconditioner). Member b's copy is at ptr + b * ms.
struct KBufs {
  float *X, *R, *P, *V, *R0, *BX, *S, *T, *PH, *SH;
  size_t ms;
};

// Fixed-trip BiCGStab with best-iterate return and the (50 eps)^2 ||b||^2
// noise-floor freeze: the CUDA counterpart of the fori_loop bodies at
// pallas_march.py:228-256 and :698-724, run in masked lockstep over the
// CTA's members (pallas_march.py:1441-1475). On entry X, R = R0, P = V = 0
// and BX are set and r2[b] = ||R0_b||^2. A masked trip of the Pallas body
// (residual at the floor, or a non-finite new residual) repeats identically
// until the budget ends, so a member leaves there: its vectors are no longer
// updated (the stacked products still overwrite its V and T, which nothing
// reads afterwards) and only BX is read after the solve. The loop ends when
// no member is left.
//   prec(b, e, v):          right preconditioner value of member b, element e;
//   apply(Y, OUT):          OUT_b = A_b Y_b for every member.
template <int BB, class Prec, class Apply>
__device__ void bicgstab_fixed(const KBufs& k, int nm, float (&r2)[BB],
                               const float (&floor2)[BB], int n_trips,
                               Prec prec, Apply apply, Smem& sm) {
  const int tid = threadIdx.x;
  const size_t ms = k.ms;
  float rho[BB], alpha[BB], omega[BB], best_r2[BB];
  bool live[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) {
    rho[b] = alpha[b] = omega[b] = 1.f;
    best_r2[b] = r2[b];
    live[b] = true;
  }
  for (int trip = 0; trip < n_trips; ++trip) {
#pragma unroll
    for (int b = 0; b < BB; ++b) live[b] = live[b] && r2[b] > floor2[b];
    if (!any_of<BB>(live)) break;
    float rho_new[BB], beta[BB];
    member_sums<BB>(rho_new, nm, sm, [&](int b, int e) {
      return k.R0[b * ms + e] * k.R[b * ms + e];
    });
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      beta[b] = (rho_new[b] / (rho[b] + EPS_DIV)) *
                (alpha[b] / (omega[b] + EPS_DIV));
      if (!live[b]) continue;
      const size_t o = b * ms;
      for (int e = tid; e < nm; e += NT) {
        const float p = k.R[o + e] + beta[b] * (k.P[o + e] - omega[b] * k.V[o + e]);
        k.P[o + e] = p;
        k.PH[o + e] = prec(b, e, p);
      }
    }
    __syncthreads();
    apply(k.PH, k.V);
    float alpha_n[BB];
    member_sums<BB>(alpha_n, nm, sm, [&](int b, int e) {
      return k.R0[b * ms + e] * k.V[b * ms + e];
    });
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      alpha_n[b] = rho_new[b] / (alpha_n[b] + EPS_DIV);
      if (!live[b]) continue;
      const size_t o = b * ms;
      for (int e = tid; e < nm; e += NT) {
        const float s = k.R[o + e] - alpha_n[b] * k.V[o + e];
        k.S[o + e] = s;
        k.SH[o + e] = prec(b, e, s);
      }
    }
    __syncthreads();
    apply(k.SH, k.T);
    float ts[BB], tt[BB], omega_n[BB], r2n[BB];
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const size_t o = b * ms;
      float pts = 0.f, ptt = 0.f;
      for (int e = tid; e < nm; e += NT) {
        const float t = k.T[o + e];
        pts += t * k.S[o + e];
        ptt += t * t;
      }
      ts[b] = pts;
      tt[b] = ptt;
    }
    block_sum<BB>(ts, sm);
    block_sum<BB>(tt, sm);
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      omega_n[b] = ts[b] / (tt[b] + EPS_DIV);
      float rr = 0.f;
      if (live[b]) {
        const size_t o = b * ms;
        for (int e = tid; e < nm; e += NT) {
          k.X[o + e] = k.X[o + e] + alpha_n[b] * k.PH[o + e] +
                       omega_n[b] * k.SH[o + e];
          const float r = k.S[o + e] - omega_n[b] * k.T[o + e];
          k.R[o + e] = r;
          rr += r * r;
        }
      }
      r2n[b] = rr;
    }
    block_sum<BB>(r2n, sm);
    bool improved = false;
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      if (!live[b]) continue;
      if (!isfinite(r2n[b])) {
        live[b] = false;
        continue;
      }
      rho[b] = rho_new[b];
      alpha[b] = alpha_n[b];
      omega[b] = omega_n[b];
      if (r2n[b] < best_r2[b]) {
        best_r2[b] = r2n[b];
        improved = true;
        const size_t o = b * ms;
        for (int e = tid; e < nm; e += NT) k.BX[o + e] = k.X[o + e];
      }
      r2[b] = r2n[b];
    }
    if (improved) __syncthreads();
  }
}

// Workspace fields per member, (n, m) each.
constexpr int FWD_FIELDS = 33;
constexpr int ADJ_FIELDS = 20;

}  // namespace vch
