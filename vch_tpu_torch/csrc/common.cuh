// Shared device building blocks of the fused march and adjoint kernels.
//
// One CTA of NT threads owns one scenario member for the whole time loop.
// Every field is an (n, m) row-major float32 array in device memory (the
// member's workspace or an input); the operator matrices are shared by all
// CTAs and stay L2-resident. The building blocks are
//   - gemm / lap_gemm: a CTA-wide tiled SIMT FP32 product C = A * B (no
//     tensor cores, no TF32: full float32 FMA) with an elementwise epilogue
//     functor epi(idx, value) applied to every valid output element;
//   - block_sum / block_min: CTA-wide reductions whose result every thread
//     receives identically, so every loop predicate built from them is
//     CTA-uniform and every thread takes the same branch around the
//     __syncthreads() inside the building blocks.
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

struct Smem {
  float As[KT][TILE + 1];               // A tile, k-major (+1: no bank clash)
  float Bs[KT][TILE];
  float red[NWARP];
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

// Sum over the CTA; every thread returns the same value (same order).
__device__ __forceinline__ float block_sum(float v, Smem& sm) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();                      // previous readers of sm.red are done
  if ((threadIdx.x & 31) == 0) sm.red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) s += sm.red[w];
  return s;
}

// NaN-propagating minimum over the CTA; identical in every thread.
__device__ __forceinline__ float block_min(float v, Smem& sm) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sm.red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = sm.red[0];
#pragma unroll
  for (int w = 1; w < NWARP; ++w) s = nan_min(s, sm.red[w]);
  return s;
}

// acc += A[i0:i0+TILE, :K] * B[:K, j0:j0+TILE] for this thread's MR x MR
// outputs (rows i0 + ty + 16 r, columns j0 + tx + 16 c). A is rows x K, B is
// K x cols, both row-major; the ragged edges load as zeros.
__device__ __forceinline__ void gemm_acc(float (&acc)[MR][MR], const float* A,
                                         const float* B, int rows, int K,
                                         int cols, int i0, int j0, Smem& sm) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int k0 = 0; k0 < K; k0 += KT) {
    for (int e = tid; e < TILE * KT; e += NT) {
      const int kk = e % KT, ii = e / KT;
      const int gi = i0 + ii, gk = k0 + kk;
      sm.As[kk][ii] = (gi < rows && gk < K) ? A[(size_t)gi * K + gk] : 0.f;
    }
    for (int e = tid; e < KT * TILE; e += NT) {
      const int jj = e % TILE, kk = e / TILE;
      const int gk = k0 + kk, gj = j0 + jj;
      sm.Bs[kk][jj] = (gk < K && gj < cols) ? B[(size_t)gk * cols + gj] : 0.f;
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

// C = A (rows x K) * B (K x cols); epi(idx, C[idx]) for every valid idx.
template <class Epi>
__device__ void gemm(const float* A, const float* B, int rows, int K,
                     int cols, Smem& sm, Epi epi) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nti = (rows + TILE - 1) / TILE, ntj = (cols + TILE - 1) / TILE;
  for (int t = 0; t < nti * ntj; ++t) {
    const int i0 = (t / ntj) * TILE, j0 = (t % ntj) * TILE;
    float acc[MR][MR] = {};
    gemm_acc(acc, A, B, rows, K, cols, i0, j0, sm);
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int c = 0; c < MR; ++c) {
        const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * c;
        if (i < rows && j < cols) epi(i * cols + j, acc[r][c]);
      }
  }
  __syncthreads();
}

// 2D Neumann Laplacian of an (n, m) field: epi(idx, (Lx v)[idx] + (v LyT)[idx]),
// the two products rounded separately and then added, as Lx@v + v@LyT.
template <class Epi>
__device__ void lap_gemm(const float* Lx, const float* LyT, const float* v,
                         int n, int m, Smem& sm, Epi epi) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nti = (n + TILE - 1) / TILE, ntj = (m + TILE - 1) / TILE;
  for (int t = 0; t < nti * ntj; ++t) {
    const int i0 = (t / ntj) * TILE, j0 = (t % ntj) * TILE;
    float a1[MR][MR] = {}, a2[MR][MR] = {};
    gemm_acc(a1, Lx, v, n, n, m, i0, j0, sm);
    gemm_acc(a2, v, LyT, n, m, m, i0, j0, sm);
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int c = 0; c < MR; ++c) {
        const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * c;
        if (i < n && j < m) epi(i * m + j, a1[r][c] + a2[r][c]);
      }
  }
  __syncthreads();
}

constexpr float EPS_DIV = 1e-30f;

// Krylov vectors of one solve: iterate, residual, search directions, the
// shadow residual R0, the best iterate BX, and the preconditioned copies PH
// and SH of P and S (PH == P and SH == S are allowed: no preconditioner).
struct KBufs {
  float *X, *R, *P, *V, *R0, *BX, *S, *T, *PH, *SH;
};

// Fixed-trip BiCGStab with best-iterate return and the (50 eps)^2 ||b||^2
// noise-floor freeze: the CUDA counterpart of the fori_loop bodies at
// pallas_march.py:228-256 and :698-724. On entry X, R = R0, P = V = 0 and BX
// are set and r2 = ||R0||^2. A masked trip of the Pallas body (residual at
// the floor, or a non-finite new residual) repeats identically until the
// budget ends, so the loop leaves there; only BX is read afterwards.
//   prec(e, v):          right preconditioner value of element e;
//   apply(Y, OUT, f):    OUT = A Y, calling f(e, OUT[e]) on every element.
template <class Prec, class Apply>
__device__ void bicgstab_fixed(const KBufs& k, int nm, float r2, float floor2,
                               int n_trips, Prec prec, Apply apply,
                               Smem& sm) {
  const int tid = threadIdx.x;
  float rho = 1.f, alpha = 1.f, omega = 1.f, best_r2 = r2;
  for (int trip = 0; trip < n_trips; ++trip) {
    if (!(r2 > floor2)) break;
    float part = 0.f;
    for (int e = tid; e < nm; e += NT) part += k.R0[e] * k.R[e];
    const float rho_new = block_sum(part, sm);
    const float beta = (rho_new / (rho + EPS_DIV)) * (alpha / (omega + EPS_DIV));
    for (int e = tid; e < nm; e += NT) {
      const float p = k.R[e] + beta * (k.P[e] - omega * k.V[e]);
      k.P[e] = p;
      k.PH[e] = prec(e, p);
    }
    __syncthreads();
    float pv = 0.f;
    apply(k.PH, k.V, [&](int e, float o) { pv += k.R0[e] * o; });
    const float alpha_n = rho_new / (block_sum(pv, sm) + EPS_DIV);
    for (int e = tid; e < nm; e += NT) {
      const float s = k.R[e] - alpha_n * k.V[e];
      k.S[e] = s;
      k.SH[e] = prec(e, s);
    }
    __syncthreads();
    float ts = 0.f, tt = 0.f;
    apply(k.SH, k.T, [&](int e, float o) {
      ts += o * k.S[e];
      tt += o * o;
    });
    const float ts_sum = block_sum(ts, sm);
    const float tt_sum = block_sum(tt, sm);
    const float omega_n = ts_sum / (tt_sum + EPS_DIV);
    float rr = 0.f;
    for (int e = tid; e < nm; e += NT) {
      k.X[e] = k.X[e] + alpha_n * k.PH[e] + omega_n * k.SH[e];
      const float r = k.S[e] - omega_n * k.T[e];
      k.R[e] = r;
      rr += r * r;
    }
    const float r2n = block_sum(rr, sm);
    if (!isfinite(r2n)) break;
    rho = rho_new;
    alpha = alpha_n;
    omega = omega_n;
    if (r2n < best_r2) {
      best_r2 = r2n;
      for (int e = tid; e < nm; e += NT) k.BX[e] = k.X[e];
      __syncthreads();
    }
    r2 = r2n;
  }
}

// Workspace fields per member, (n, m) each.
constexpr int FWD_FIELDS = 33;
constexpr int ADJ_FIELDS = 19;

}  // namespace vch
