// The cluster engine of the whole-march and whole-sweep kernels
// (march2d_blocked.cu, adjoint2d_cluster.cu): a block of MB members of a
// batch on one thread-block cluster of C CTAs, every member field an
// (n, m) row-major float32 array in a global workspace.
//
// CTA r owns a band of rows of all MB members' fields (tile4.cuh's split):
//   - a right product X_b Op is band-local: the members' bands stacked
//     (MB R rows) times Op, one operator slab feeding all of them;
//   - a left product Op X_b takes the members side by side (MB m columns):
//     Op[band_r, :] times their whole fields, which the peers wrote, read
//     from the workspace after a cluster barrier;
// each through tile4.cuh's engine (4 x 4 register units, float4 slab reads,
// a two-stage cp.async ring), in passes of S NT units. Every product output
// sums its k terms in ascending order in one FMA chain, as common.cuh's
// one-CTA products do, so a member's products do not depend on the cluster
// size nor on the batch.
//
// Reductions reproduce common.cuh's block_sum / block_min order: its thread
// t sums e = t, t + 256, ... of the member's whole field, then a warp xor
// tree, then the eight warps in order. Here (member b, warp w) is one of
// 8 MB pairs, each owned by one warp of the cluster (with one member, pair
// w on rank w % C, so the eight chains run on up to eight SMs); its lane l
// sums the elements of thread 32 w + l of the one-CTA kernel over the whole
// field, the warp tree follows, lane 0's value goes to every CTA's shared
// memory (distributed shared memory), and after a cluster barrier each CTA
// adds the eight warp values in order. So every CTA holds the same
// per-member scalars, in shared memory, and takes the same branches.
// Elementwise passes run in the same pair layout with several members, and
// over every thread of the cluster with one. Whatever reads an element in
// another layout than the one that wrote it, or in a peer's band, waits at
// a cluster barrier first: every left product and every reduction starts
// with one. Full float32 FMA: no tensor cores, no TF32; but product16, the
// march's Krylov operator at a bf16 fused_solve_precision (and every product
// of the march at fwd_mm "bf16x3"), which stages the field as bf16 (hi, lo)
// in the ring's shared memory and multiplies on mma.sync with float32
// accumulators.
#pragma once

#include <mutex>

#include "mma_bf16.cuh"
#include "tile4.cuh"

namespace vch {
namespace cluster {

constexpr int S = 3;           // 4 x 4 units per thread per pass
constexpr int EB = 4;          // outputs of a unit row whose loads go first
constexpr int MAX_C = 16;      // CTAs per cluster, at most (non-portable)
constexpr int CTL_BYTES = 4096;   // static shared memory reserved for Ctl
constexpr size_t SMEM_LIMIT = 232448 - CTL_BYTES;

// The cluster's split of a block of MB members, the same on host and
// device (the Python wrapper computes it too, ops/march.py
// blocked_geometry): band = one member's split (tile4.cuh), kc the most k
// rows of a ring stage, units the 4 x 4 output units of one product of the
// block.
struct BGeom {
  Geom band;
  int kc, units;
};

template <int MB>
__host__ __device__ inline BGeom make_bgeom(int n, int m, int C, int kc) {
  BGeom g;
  g.band = make_geom(n, m, C, 1);
  g.kc = kc;
  g.units = MB * g.band.units;
  return g;
}

// Dynamic shared memory of one CTA: a two-stage ring of A slabs (kc x
// (MB rpad + 4)) and B slabs (kc x MB mpad), wide enough for both products.
template <int MB>
inline size_t blocked_smem_bytes(const BGeom& g) {
  return 4 * 2 * (size_t)g.kc * (MB * (g.band.rpad + g.band.mpad) + 4);
}

// What a pass or an epilogue loads for one element, ahead of its stores.
template <int N>
struct Vals {
  float v[N];
};
struct None {};
template <class In>
struct WithT {                    // a Laplacian's first product, and In
  float t;
  In in;
};
struct All {                      // every member
  __device__ __forceinline__ bool operator()(int) const { return true; }
};

template <int MB>
__device__ __forceinline__ bool any_member(const int (&v)[MB]) {
  bool a = false;
#pragma unroll
  for (int b = 0; b < MB; ++b) a = a || v[b];
  return a;
}

// f(r, c) for e = tid, tid + NT, ... < rows cols, (r, c) = divmod(e, cols),
// without a division per element.
template <class F>
__device__ __forceinline__ void each_rc(int rows, int cols, F f) {
  const int dr = NT / cols, dc = NT - dr * cols;
  int r = threadIdx.x / cols, c = threadIdx.x - r * cols;
  while (r < rows) {
    f(r, c);
    c += dc;
    r += dr;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// One CTA's view of its block of MB members: the products, elementwise
// passes and reductions above. Every method is force-inlined into the
// kernel, so the state below lives in registers; `red` (two reductions'
// warp values) lies in the kernel's static shared memory. A kernel's own
// struct derives from it.
template <int MB>
struct Block {
  // elements per lane whose loads go first: one member's reduction chains
  // run on eight warps of the cluster only, so each lane loads further ahead
  static constexpr int U = MB == 1 ? 8 : 4;
  const BGeom& g;
  float (*red)[MB][NWARP];
  cg::cluster_group cluster;
  int tid, lane, gw, pw, n, m, nm, C, rank, b0, r0, R, rpad, mpad, units;
  int kcmax, a_stage, b_stage;
  size_t FS;
  float *ringA, *ringB, *W;
  All all;

  // fields: the workspace's fields per member (member b0's first at work
  // + b0 fields n m)
  __device__ __forceinline__ Block(const BGeom& geo, int n_, int m_,
                                   int fields, float* work, float* smem,
                                   float (*red_)[MB][NWARP])
      : g(geo), red(red_), cluster(cg::this_cluster()) {
    const Geom& gb = g.band;
    tid = threadIdx.x;
    lane = tid & 31;
    n = n_;
    m = m_;
    nm = n * m;
    C = gb.C;
    rank = (int)cluster.block_rank();
    gw = rank * NWARP + (tid >> 5);         // this warp in the cluster
    // the first (member, warp) pair this warp owns
    pw = MB == 1 ? (tid >> 5) * C + rank : gw;
    b0 = (blockIdx.x / C) * MB;             // the block's first member
    r0 = band_start(gb, rank);
    R = band_rows(gb, rank);
    rpad = gb.rpad;
    mpad = gb.mpad;
    units = g.units;
    kcmax = g.kc;
    a_stage = kcmax * (MB * rpad + 4);
    b_stage = kcmax * MB * mpad;
    ringA = smem;
    ringB = smem + 2 * a_stage;
    FS = (size_t)fields * nm;               // member stride of a field
    W = work + b0 * FS;
  }

  __device__ __forceinline__ float* F(int slot) const {
    return W + (size_t)slot * nm;
  }

  // ---- products --------------------------------------------------------
  // LEFT: out_b[r0 + i, j] = sum_k Op[r0 + i, k] X_b[k, j] (K = n), X_b's
  // rows from every band; RIGHT: out_b[r0 + i, j] = sum_k X_b[r0 + i, k]
  // Op[k, j] (K = m), X_b's rows of this band. X is a field of the block
  // (member b at X + b FS). The epilogue is ld(b, e), which loads what
  // output e needs, and st(b, e, value, loaded), run on four outputs of a
  // unit's row at a time, their loads first. The RIGHT A slab's k stride
  // is MB rpad + 4 floats, so its transposing writes do not all fall in one
  // shared-memory bank. XT (RIGHT, square fields only): X_b^T Op, the
  // transpose in the A slab's read (row r0 + i of X_b^T is column r0 + i
  // of X_b, which crosses every band: the caller waits at a cluster
  // barrier first).
  template <bool LEFT, bool XT = false, class Ld, class St>
  __device__ __forceinline__ void product(const float* __restrict__ Op,
                                          const float* X, Ld ld, St st) {
    const int K = LEFT ? n : m;
    const int nch = (K + kcmax - 1) / kcmax, kc = (K + nch - 1) / nch;
    Geom pg = g.band;
    pg.rpad = LEFT ? rpad : MB * rpad + 4;  // A's k stride
    pg.mpad = LEFT ? MB * mpad : mpad;      // B's k stride; 4 x 4 columns
    pg.units = units;
    const int sa = pg.rpad, sb = pg.mpad;
    auto issue = [&](int ch, int st_) {
      const int k0 = ch * kc, kk = min(kc, K - k0);
      float* As = ringA + st_ * a_stage;
      float* Bs = ringB + st_ * b_stage;
      if (LEFT) {
        const float* src = Op + (size_t)r0 * n + k0;     // As[k][i]
        each_rc(R, kk, [&](int i, int k) {
          cp_async4(As + k * sa + i, src + (size_t)i * n + k);
        });
#pragma unroll 1
        for (int b = 0; b < MB; ++b) {                   // Bs[k][b mpad + j]
          const float* xb = X + b * FS + (size_t)k0 * m;
          float* db = Bs + b * mpad;
          each_rc(kk, m, [&](int k, int j) {
            cp_async4(db + k * sb + j, xb + k * m + j);
          });
        }
      } else {
#pragma unroll 1
        for (int b = 0; b < MB; ++b) {                   // As[k][b rpad + i]
          if constexpr (XT) {                            // X_b[k0 + k][r0 + i]
            const float* xb = X + b * FS + (size_t)k0 * m + r0;
            float* da = As + b * rpad;
            each_rc(kk, R, [&](int k, int i) {
              cp_async4(da + k * sa + i, xb + k * m + i);
            });
          } else {
            const float* xb = X + b * FS + (size_t)r0 * m + k0;
            float* da = As + b * rpad;
            each_rc(R, kk, [&](int i, int k) {
              cp_async4(da + k * sa + i, xb + i * m + k);
            });
          }
        }
        const float* src = Op + (size_t)k0 * m;          // Bs[k][j]
        each_rc(kk, m, [&](int k, int j) {
          cp_async4(Bs + k * sb + j, src + k * m + j);
        });
      }
      cp_async_commit();
    };
    for (int first = 0; first < units; first += S * NT) {
      const Units<S> u(pg, first);
      Acc<S> acc;
      zero<S>(acc);
      issue(0, 0);
      for (int ch = 0; ch < nch; ++ch) {
        if (ch + 1 < nch) {
          issue(ch + 1, (ch + 1) & 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        mma_chunk<S>(acc, ringA + (ch & 1) * a_stage,
                     ringB + (ch & 1) * b_stage, min(kc, K - ch * kc), pg, u);
        __syncthreads();
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (s >= u.nu) continue;
        const int b = LEFT ? u.boff[s] / mpad : u.aoff[s] / rpad;
        const int i0 = LEFT ? u.aoff[s] : u.aoff[s] - b * rpad;
        const int j0 = LEFT ? u.boff[s] - b * mpad : u.boff[s];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          if (i0 + ii >= R) continue;
          const int e0 = (r0 + i0 + ii) * m + j0;
#pragma unroll
          for (int j1 = 0; j1 < 4; j1 += EB) {
            decltype(ld(b, e0)) in[EB];
#pragma unroll
            for (int jj = 0; jj < EB; ++jj)
              if (j0 + j1 + jj < m) in[jj] = ld(b, e0 + j1 + jj);
#pragma unroll
            for (int jj = 0; jj < EB; ++jj)
              if (j0 + j1 + jj < m)
                st(b, e0 + j1 + jj, acc[s][ii][j1 + jj], in[jj]);
          }
        }
      }
    }
  }

  // Op X_b after a cluster barrier (the peers' rows of X are written)
  template <class Ld, class St>
  __device__ __forceinline__ void gemm_l(const float* Op, const float* X,
                                         Ld ld, St st) {
    cluster.sync();
    product<true>(Op, X, ld, st);
  }
  // X_b Op on this band's rows, which this CTA wrote (the barrier: the
  // first chunk's loads must see every thread's last epilogue)
  template <class Ld, class St>
  __device__ __forceinline__ void gemm_r(const float* X, const float* Op,
                                         Ld ld, St st) {
    __syncthreads();
    product<false>(Op, X, ld, st);
  }
  // A product whose epilogue stores its value into field D
  __device__ __forceinline__ void gemm_l_to(const float* Op, const float* X,
                                            float* D) {
    const size_t fs = FS;
    gemm_l(Op, X, [](int, int) { return None{}; },
           [=](int b, int e, float x, None) { D[b * fs + e] = x; });
  }
  __device__ __forceinline__ void gemm_r_to(const float* X, const float* Op,
                                            float* D) {
    const size_t fs = FS;
    gemm_r(X, Op, [](int, int) { return None{}; },
           [=](int b, int e, float x, None) { D[b * fs + e] = x; });
  }
  // st(b, e, (Lx V_b)[e] + (V_b LyT)[e], ld(b, e)), each product rounded,
  // then added; the first goes through field T, which nothing else reads
  // or writes meanwhile
  template <class Ld, class St>
  __device__ __forceinline__ void lap(const float* Lx, const float* LyT,
                                      const float* V, float* T, Ld ld,
                                      St st) {
    const size_t fs = FS;
    gemm_l_to(Lx, V, T);
    gemm_r(V, LyT, [&](int b, int e) {
      return WithT<decltype(ld(b, e))>{T[b * fs + e], ld(b, e)};
    }, [&](int b, int e, float x, const auto& in) {
      st(b, e, in.t + x, in.in);
    });
  }

  // ---- bf16 products on the tensor cores ---------------------------------
  // The products of the march's Krylov operator at fused_solve_precision
  // "bf16x3" (passes 3) or "default" (passes 1), and at fwd_mm "bf16x3"
  // every other product of the march (passes 3), vch_tpu's _make_mm
  // (pallas_march.py:47-75): operand a = hi + lo, each half rounded to bf16
  // (nearest even); out = d0 + (d1 + d2), d0 = hi hi, d1 = lo hi, d2 = hi
  // lo, each a separate float32 accumulator over k ascending (passes 1: d0
  // alone). The same LEFT / RIGHT outputs, epilogue and band as `product`,
  // computed transposed or not so that the field is the mma A operand:
  //   LEFT:  out_b^T[j, i] = sum_k X_b^T[j, k] Op^T[k, i]: M = the members'
  //          columns stacked (q = b m + j), N = this band's rows;
  //   RIGHT: out_b[i, j] = sum_k X_b[r0 + i, k] Op[k, j]: M = the members'
  //          band rows stacked (q = b R + i), N = the columns.
  // The field is split into (hi, lo) as it is staged into shared memory
  // (bf16, its own layout, rows 8 elements apart from a multiple of 16 so
  // that ldmatrix reads no bank twice), in slabs of jt 16-row M tiles with
  // every k; a warp takes one M tile and up to four 8-column N tiles. Op is
  // the operator's fragment copy (the wrapper's, made once per launch):
  // (rows + 8, ceil(K / 16), 4) uint4, row r of Op (LEFT) or of Op^T
  // (RIGHT), k tile kt, lane t%4 = {hi(k 2t, 2t+1), hi(2t+8, 2t+9), lo(..),
  // lo(..)} of that tile, zero past K and past the rows: one 16-byte read a
  // lane gives a B fragment's hi and lo.
  template <bool LEFT, class Ld, class St>
  __device__ __forceinline__ void product16(const uint4* __restrict__ Op,
                                            const float* X, int passes,
                                            int jt, Ld ld, St st) {
    constexpr int TW = 4;                       // N tiles of a warp's item
    const bool three = passes == 3;
    const int K = LEFT ? n : m, KT = (K + 15) >> 4, KP = KT << 4;
    const int QD = LEFT ? m : R;                // M rows of one member
    const int Q = MB * QD, NN = LEFT ? R : m;   // M and N extents
    const int MT = (Q + 15) >> 4, NTT = (NN + 7) >> 3;
    const int NG = (NTT + TW - 1) / TW;         // N groups of an M tile
    const int JW = jt << 4;
    const int LS = LEFT ? JW + 8 : KP + 8;      // slab row stride (bf16)
    __nv_bfloat16* const sh = reinterpret_cast<__nv_bfloat16*>(ringA);
    __nv_bfloat16* const sl = sh + (LEFT ? KP : JW) * LS;
    const int warp = tid >> 5, gr = lane >> 2, tc = lane & 3;
    const int orow = LEFT ? r0 : 0;             // Op's row of N index 0
    auto put = [&](int off, float v0, float v1) {
      const __nv_bfloat16 h0 = __float2bfloat16_rn(v0);
      const __nv_bfloat16 h1 = __float2bfloat16_rn(v1);
      *reinterpret_cast<__nv_bfloat162*>(sh + off) = __halves2bfloat162(h0, h1);
      if (three)
        *reinterpret_cast<__nv_bfloat162*>(sl + off) = __floats2bfloat162_rn(
            v0 - __bfloat162float(h0), v1 - __bfloat162float(h1));
    };
    for (int mt0 = 0; mt0 < MT; mt0 += jt) {
      const int q0 = mt0 << 4;
      if (mt0) __syncthreads();                 // the last slab is read
      if constexpr (LEFT) {                     // slab[k][q - q0]
        each_rc(KP, JW / 2, [&](int k, int p) {
          const int q = q0 + 2 * p;
          float v[2] = {0.f, 0.f};
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (k < K && q + h < Q) {
              const int b = (q + h) / QD;
              v[h] = X[b * FS + (size_t)k * m + (q + h - b * QD)];
            }
          put(k * LS + 2 * p, v[0], v[1]);
        });
      } else {                                  // slab[q - q0][k]
        each_rc(JW, KP / 2, [&](int qq, int p) {
          const int q = q0 + qq, k = 2 * p;
          float v[2] = {0.f, 0.f};
          if (q < Q) {
            const int b = q / QD;
            const float* xr = X + b * FS + (size_t)(r0 + q - b * QD) * m;
            if (k < K) v[0] = xr[k];
            if (k + 1 < K) v[1] = xr[k + 1];
          }
          put(qq * LS + k, v[0], v[1]);
        });
      }
      __syncthreads();
      const int items = min(jt, MT - mt0) * NG;
      for (int item = warp; item < items; item += NWARP) {
        const int mi = item / NG, ng = item - mi * NG;
        const int n0 = ng * NTT / NG, cnt = (ng + 1) * NTT / NG - n0;
        const int c0 = mi << 4;
        // ldmatrix row addresses: LEFT the transposed 8 x 8 quarters of
        // slab rows k (a0..a3: k +0/+0/+8/+8, q +0/+8/+0/+8); RIGHT slab
        // rows q (q +0/+8/+0/+8, k +0/+0/+8/+8)
        const int aoff = LEFT
            ? ((lane & 7) + ((lane >> 4) << 3)) * LS + c0 +
                  (((lane >> 3) & 1) << 3)
            : (c0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LS +
                  ((lane >> 4) << 3);
        const int astep = LEFT ? 16 * LS : 16;
        const uint4* ob = Op + ((size_t)(orow + 8 * n0 + gr) * KT) * 4 + tc;
        float acc[TW][3][4];
#pragma unroll
        for (int j = 0; j < TW; ++j)
#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[j][p][v] = 0.f;
        for (int kt = 0; kt < KT; ++kt) {
          unsigned ah[4], al[4];
          if constexpr (LEFT) {
            ldsm_x4_trans(ah, sh + aoff + kt * astep);
            if (three) ldsm_x4_trans(al, sl + aoff + kt * astep);
          } else {
            ldsm_x4(ah, sh + aoff + kt * astep);
            if (three) ldsm_x4(al, sl + aoff + kt * astep);
          }
#pragma unroll
          for (int j = 0; j < TW; ++j) {
            if (j >= cnt) continue;
            const uint4 bv = __ldg(ob + ((size_t)(8 * j) * KT + kt) * 4);
            mma_bf16(acc[j][0], ah, bv.x, bv.y);
            if (three) {
              mma_bf16(acc[j][1], al, bv.x, bv.y);
              mma_bf16(acc[j][2], ah, bv.z, bv.w);
            }
          }
        }
        // accumulator v: M row gr (+8 for v >= 2), N column 2 tc (+1 odd v)
#pragma unroll
        for (int j = 0; j < TW; ++j) {
          if (j >= cnt) continue;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int q = q0 + c0 + gr + ((v >> 1) << 3);
            const int c = 8 * (n0 + j) + 2 * tc + (v & 1);
            if (q >= Q || c >= NN) continue;
            const float x = three ? acc[j][0][v] + (acc[j][1][v] + acc[j][2][v])
                                  : acc[j][0][v];
            const int b = q / QD, r = q - b * QD;
            const int e = LEFT ? (r0 + c) * m + r : (r0 + r) * m + c;
            st(b, e, x, ld(b, e));
          }
        }
      }
    }
  }
  // Op X_b on bf16 after a cluster barrier (gemm_l's)
  template <class Ld, class St>
  __device__ __forceinline__ void gemm16_l(const uint4* Op, const float* X,
                                           int passes, int jt, Ld ld, St st) {
    cluster.sync();
    product16<true>(Op, X, passes, jt, ld, st);
  }
  // X_b Op on bf16 on this band's rows (gemm_r's barrier)
  template <class Ld, class St>
  __device__ __forceinline__ void gemm16_r(const float* X, const uint4* Op,
                                           int passes, int jt, Ld ld, St st) {
    __syncthreads();
    product16<false>(Op, X, passes, jt, ld, st);
  }
  __device__ __forceinline__ void gemm16_l_to(const uint4* Op, const float* X,
                                              float* D, int passes, int jt) {
    const size_t fs = FS;
    gemm16_l(Op, X, passes, jt, [](int, int) { return None{}; },
             [=](int b, int e, float x, None) { D[b * fs + e] = x; });
  }

  // ---- elementwise passes and reductions ----------------------------------
  // For every element of every member with on(b): with MB members, pair
  // (b, w) is owned by warp pw of the cluster, its lane l takes e = 32 w + l,
  // + NT, ...; with one member, CTA r's thread t takes e = r NT + t,
  // + C NT, .... ld(b, e) loads what element e needs and st(b, e, loaded)
  // computes and stores, U elements' loads at a time before their stores.
  template <class On, class Ld, class St>
  __device__ __forceinline__ void each_elem(On on, Ld ld, St st) {
    if constexpr (MB == 1) {
      if (!on(0)) return;
      const int stride = C * NT;
      int e = rank * NT + tid;
      for (; e + (U - 1) * stride < nm; e += U * stride) {
        decltype(ld(0, e)) in[U];
#pragma unroll
        for (int q = 0; q < U; ++q) in[q] = ld(0, e + q * stride);
#pragma unroll
        for (int q = 0; q < U; ++q) st(0, e + q * stride, in[q]);
      }
      for (; e < nm; e += stride) st(0, e, ld(0, e));
    } else {
      for (int pr = pw; pr < MB * NWARP; pr += C * NWARP) {
        const int b = pr / NWARP;
        if (!on(b)) continue;
        int e = (pr % NWARP) * 32 + lane;
        for (; e + (U - 1) * NT < nm; e += U * NT) {
          decltype(ld(b, e)) in[U];
#pragma unroll
          for (int q = 0; q < U; ++q) in[q] = ld(b, e + q * NT);
#pragma unroll
          for (int q = 0; q < U; ++q) st(b, e + q * NT, in[q]);
        }
        for (; e < nm; e += NT) st(b, e, ld(b, e));
      }
    }
  }
  // Per-member reductions of NV values: acc(b, e, loaded, p) adds element
  // e's terms into the partials p (from init; init alone where !on(b)) in
  // common.cuh's block_sum (MIN false) or block_min order, U elements'
  // loads ahead; fin(b, v) then runs on thread b of every CTA with the
  // results, and the CTA syncs. Starts with a cluster barrier: the inputs
  // may lie in the peers' bands.
  template <int NV, bool MIN, class On, class Ld, class Ac, class Fin>
  __device__ __forceinline__ void reduce(float init, On on, Ld ld, Ac acc,
                                         Fin fin) {
    cluster.sync();
    for (int pr = pw; pr < MB * NWARP; pr += C * NWARP) {
      const int b = pr / NWARP, w = pr % NWARP;
      float p[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) p[v] = init;
      if (on(b)) {
        int e = w * 32 + lane;
        for (; e + (U - 1) * NT < nm; e += U * NT) {
          decltype(ld(b, e)) in[U];
#pragma unroll
          for (int q = 0; q < U; ++q) in[q] = ld(b, e + q * NT);
#pragma unroll
          for (int q = 0; q < U; ++q) acc(b, e + q * NT, in[q], p);
        }
        for (; e < nm; e += NT) acc(b, e, ld(b, e), p);
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float o = __shfl_xor_sync(0xffffffffu, p[v], off);
          p[v] = MIN ? nan_min(p[v], o) : p[v] + o;
        }
        p[v] = __shfl_sync(0xffffffffu, p[v], 0);
        if (lane < C) *cluster.map_shared_rank(&red[v][b][w], lane) = p[v];
      }
    }
    cluster.sync();
    if (tid < MB) {
      const int b = tid;
      float out[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float s = MIN ? red[v][b][0] : 0.f;
#pragma unroll
        for (int w = MIN ? 1 : 0; w < NWARP; ++w)
          s = MIN ? nan_min(s, red[v][b][w]) : s + red[v][b][w];
        out[v] = s;
      }
      fin(b, out);
    }
    __syncthreads();
  }
};

// Per device: the dynamic shared-memory limit set so far and the
// non-portable cluster attribute, for one kernel.
struct LaunchState {
  size_t smem_set = 0;
  bool nonportable = false;
};

inline std::mutex& launch_mutex() {
  static std::mutex mu;
  return mu;
}

// The launch configuration of `clusters` clusters of C CTAs of `kernel`;
// sets the kernel's attributes for it once per device (state: the
// kernel's own, one per device).
inline int configure(const void* kernel, LaunchState (&state)[16],
                     cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                     int clusters, int C, size_t smem, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 16) return (int)cudaErrorInvalidDevice;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  std::lock_guard<std::mutex> lock(launch_mutex());
  LaunchState& st = state[dev];
  if (smem > st.smem_set) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    st.smem_set = smem;
  }
  if (C > 8 && !st.nonportable) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return (int)err;
    st.nonportable = true;
  }
  return 0;
}

// The geometry the kernel recomputes from (n, m, C, kc): 0 if the caller's
// smem_bytes is its own and fits, else cudaErrorInvalidValue.
template <int MB>
int check_geometry(int n, int m, int C, int kc, int smem_bytes, BGeom& g) {
  if (n <= 1 || m <= 1 || C < 1 || C > MAX_C || C > n || kc < 4 || kc % 4)
    return (int)cudaErrorInvalidValue;
  g = make_bgeom<MB>(n, m, C, kc);
  const size_t smem = blocked_smem_bytes<MB>(g);
  if (smem != (size_t)smem_bytes || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// M tiles of a slab of product16's staging: `tiles` in the fewest slabs of
// at most `most`, as even as they go
inline int slab_tiles(int tiles, int most) {
  const int slabs = (tiles + most - 1) / most;
  return (tiles + slabs - 1) / slabs;
}

// product16's staging for a block of MB members on geometry g (ops/march.py
// blocked_geometry computes it too): the M tiles of a LEFT and of a RIGHT
// slab, and the bytes of the larger (the (hi, lo) arrays at passes 3, hi
// alone at 1), each slab as wide as fits in SMEM_LIMIT. False where not even
// one tile fits.
template <int MB>
bool staging16(const BGeom& g, int n, int m, int passes, int& jt_left,
               int& jt_right, size_t& bytes) {
  const long arr = passes == 3 ? 2 : 1;
  const long kpn = mma_np(n), kpm = mma_np(m);
  const long most_l = ((long)SMEM_LIMIT / (2 * arr * kpn) - 8) / 16;
  const long most_r = (long)SMEM_LIMIT / (2 * arr * 16 * (kpm + 8));
  if (most_l < 1 || most_r < 1) return false;
  jt_left = slab_tiles((MB * m + 15) / 16, (int)most_l);
  jt_right = slab_tiles((MB * g.band.rmax + 15) / 16, (int)most_r);
  const size_t left = 2 * arr * kpn * (16 * jt_left + 8);
  const size_t right = 2 * arr * 16 * jt_right * (kpm + 8);
  bytes = left > right ? left : right;
  return true;
}

// check_geometry for the bf16 march: its shared memory is the larger of the
// ring and product16's staging.
template <int MB>
int check_geometry16(int n, int m, int C, int kc, int smem_bytes, int passes,
                     BGeom& g, int& jt_left, int& jt_right) {
  if (n <= 1 || m <= 1 || C < 1 || C > MAX_C || C > n || kc < 4 || kc % 4 ||
      (passes != 1 && passes != 3))
    return (int)cudaErrorInvalidValue;
  g = make_bgeom<MB>(n, m, C, kc);
  size_t smem = 0;
  if (!staging16<MB>(g, n, m, passes, jt_left, jt_right, smem))
    return (int)cudaErrorInvalidValue;
  const size_t ring = blocked_smem_bytes<MB>(g);
  if (ring > smem) smem = ring;
  if (smem != (size_t)smem_bytes || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// product16's fragment copies of a Krylov operator's four matrices, one
// buffer in the order Vx, Vx_inv (n + 8 rows of ceil(n / 16) k tiles), Vy,
// Vy_inv (m + 8 rows of ceil(m / 16)), each (row, k tile) four uint4
// (ops/march.py _bf16_operators makes it); all null for a null buffer.
struct Ops16 {
  const uint4 *vx, *vxi, *vy, *vyi;
};
inline Ops16 ops16_of(const void* buf, int n, int m) {
  const uint4* p = static_cast<const uint4*>(buf);
  if (!p) return Ops16{nullptr, nullptr, nullptr, nullptr};
  const size_t ln = (size_t)(n + 8) * ((n + 15) / 16) * 4;
  const size_t lm = (size_t)(m + 8) * ((m + 15) / 16) * 4;
  return Ops16{p, p + ln, p + 2 * ln, p + 2 * ln + lm};
}

// The fwd_mm march's two further fragment copies, after ops16_of's four in
// the same buffer: Lx (n + 8 rows of ceil(n / 16) k tiles) and Ly = LyT^T
// (m + 8 rows of ceil(m / 16)); all null for a null buffer. (Ops16 stays as
// it was: the sweep's kernel arguments hold one.)
struct FwdOps16 {
  const uint4 *lx, *ly;
};
inline FwdOps16 fwd_ops16_of(const void* buf, int n, int m) {
  const uint4* p = static_cast<const uint4*>(buf);
  if (!p) return FwdOps16{nullptr, nullptr};
  const size_t ln = (size_t)(n + 8) * ((n + 15) / 16) * 4;
  const size_t lm = (size_t)(m + 8) * ((m + 15) / 16) * 4;
  return FwdOps16{p + 2 * ln + 2 * lm, p + 3 * ln + 2 * lm};
}

// cudaOccupancyMaxActiveClusters of `kernel` on clusters of C CTAs with
// smem_bytes each; a negative CUDA error code on failure.
inline int occupancy(const void* kernel, LaunchState (&state)[16], int C,
                     int smem_bytes) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int err = configure(kernel, state, cfg, attr, 1, C, smem_bytes, 0);
  if (err) return -err;
  int clusters = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, kernel,
                                                       &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

// How many clusters of C CTAs of `kernel` (MB members per cluster) can be
// resident at once on the current card with this geometry
// (cudaOccupancyMaxActiveClusters); a negative CUDA error code on failure.
template <int MB>
int max_clusters(const void* kernel, LaunchState (&state)[16], int n, int m,
                 int C, int kc, int smem_bytes) {
  BGeom g;
  const int err = check_geometry<MB>(n, m, C, kc, smem_bytes, g);
  return err ? -err : occupancy(kernel, state, C, smem_bytes);
}

}  // namespace cluster
}  // namespace vch
