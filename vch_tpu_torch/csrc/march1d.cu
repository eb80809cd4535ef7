// Whole batched 1D forward march of the viscous Cahn–Hilliard system, on
// thread-block clusters with the operators held in shared memory.
//
// Replaces the TPU kernel vch_tpu/ops/pallas_march.py:1183 march_fused_1d
// (body _march1d_kernel_factory, :897-1180). Per time step and member: the w
// CN update, then the member's own Newton loop from (phi_old, mu_old) — CN
// residual, fixed-trip BiCGStab on the Schur system in the cosine basis
// (pointwise 1/denom preconditioner, best iterate, noise-floor freeze), the
// step ceiling min(1, 0.9 alpha_max), the 1D Armijo (eta 1e-3, in-bounds
// guard, trial step alpha0 0.5^j, at most 12 trials, no best-trial fallback:
// a failed line search ends that member's Newton loop) — then clip, the
// uniform mass projection and the first-bad-step sanitizer. The members of
// a cluster run in masked lockstep, each with its own Newton, Armijo and
// Krylov trip counts; a cluster whose members have all converged leaves the
// loop. An accepted trial's residual is the next round's residual, so it is
// handed on and not computed again.
//
// What bounds it on an H100: every product is a member's length-n vector
// times an (n, n) operator (LT, VinvT or VT; 1.05 MB each at n = 513), about
// 26 of them per one-iteration step, between reductions whose results the
// next product needs. All members share the three operators: that is what
// the TPU kernel builds on with (B, n) x (n, n) products.
//
// Design: the operators stay and the members' vectors move.
//   - A cluster of C CTAs owns a group of MB members (ops/march.py
//     march1d_geometry). The columns are cut into chunks of 32 (the last
//     also takes the n % 32 columns past them), and CTA r owns a band of
//     whole chunks: every field's band columns, of every
//     member, and the band's columns of LT, VinvT and VT for all n rows,
//     loaded into shared memory once per launch (at n = 513, C = 16: 32 or
//     33 columns, 203 KB). Where the bands do not fit, the operator rows
//     stream with the inputs through the ring instead.
//   - A product (MB x n)(n x band) takes its inputs, every member's whole
//     vector, after a cluster barrier from the L2-resident workspace in
//     k-chunks through a two-stage cp.async ring (one CTA barrier per
//     chunk, the next chunk's loads in flight); each thread computes
//     units of 8 members x 1 column in registers, k ascending in one FMA
//     chain per output, so a member's bits depend neither on its cluster's
//     members, nor on C, nor on the batch. The products' shared-memory
//     reads and the ring's per-chunk barrier bound the kernel (PERF.md).
//   - Elementwise passes are band-local. A reduction sums each chunk of a
//     member over a warp (lane l the chunk's columns l and l + 32, in that
//     order, then a xor tree), sends the chunk's value to every CTA of the
//     cluster (distributed shared memory, two buffers used in turn), and
//     after one cluster barrier adds the chunks in ascending order: every
//     CTA holds the same per-member scalars and takes the same branches,
//     and the order does not depend on C.
// Member state lives in a workspace (B, F1_COUNT, npad), npad = n rounded up
// to 32; full float32 FMA, no tensor cores, no TF32. Compiled with
// -fmad=false (ops/_build.py): the products' explicit fmaf are its only
// FMAs. An elementwise expression appears in several unrolled copies (the
// elements loaded ahead), and nvcc may fuse an a*b + c*d differently in
// each: a member's bits then depended on which copy its column fell in,
// that is on its place in the cluster.
#include <mutex>

#include "tile4.cuh"

namespace vch {
namespace m1d {

constexpr int CH = 32;            // columns per chunk
constexpr int MG = 8;             // members per product unit
constexpr int MB_MAX = 64;        // members per cluster, at most
constexpr int NV = 2;             // values per reduction, at most
constexpr int MAX_C = 16;         // CTAs per cluster, at most (non-portable)
constexpr int U = 4;              // elements (pairs) per thread loaded ahead
constexpr int CTL_BYTES = 8192;   // static shared memory reserved for Ctl
constexpr size_t SMEM_LIMIT = 232448 - CTL_BYTES;

struct Fwd1dConst {
  float tau, c1, two_c1, two_c2, neg_kappa, half_kappa, gamma;
  float log_lo, log_hi, lo, hi, Lx_len;
  float newton_tol, newton_rtol, floor_fac;
};
constexpr int FWD1D_NCONST = sizeof(Fwd1dConst) / sizeof(float);

// workspace field slots, npad floats each
enum {
  G_PHI_OLD, G_MU_OLD, G_W_OLD, G_W_NEW, G_LMU_OLD, G_LPHI_OLD,
  G_QUAD,                         // 2 sets of (phi, mu, Rphi, Rmu)
  G_DPHI = G_QUAD + 8, G_DMU, G_D,
  G_X, G_R, G_P, G_V, G_R0, G_BX, G_S, G_T, G_PH, G_SH,
  G_T1,
  F1_COUNT
};
enum { S_CUR, S_TRIAL };          // the buffer sets
enum { OP_L, OP_VINV, OP_V };     // the operators

// The cluster's split, the same on host and device (ops/march.py
// march1d_geometry computes it too): nch = max(1, n / 32) chunks of 32
// columns, the last with the rest; rank p owns q chunks, one more for the
// last rem ranks; wmax the widest band; mbp the members padded to MG; kc k
// rows per ring stage; res: the operator bands stay in shared memory.
struct Geom1 {
  int n, C, nch, q, rem, wmax, mb, mbp, kc, res;
};

__host__ __device__ inline int chunk_first(const Geom1& g, int p) {
  const int extra = p - (g.C - g.rem);
  return p * g.q + (extra > 0 ? extra : 0);
}

__host__ __device__ inline int chunk_count(const Geom1& g, int p) {
  return g.q + (p >= g.C - g.rem);
}

__host__ __device__ inline int band_cols(const Geom1& g, int p) {
  const int end = chunk_first(g, p) + chunk_count(g, p);
  return (end == g.nch ? g.n : CH * end) - CH * chunk_first(g, p);
}

__host__ __device__ inline Geom1 make_geom1(int n, int C, int mb, int kc,
                                            int res) {
  Geom1 g;
  g.n = n;
  g.C = C;
  g.nch = n / CH > 1 ? n / CH : 1;
  g.q = g.nch / C;
  g.rem = g.nch % C;
  g.wmax = 0;
  for (int p = 0; p < C; ++p) {
    const int w = band_cols(g, p);
    g.wmax = w > g.wmax ? w : g.wmax;
  }
  g.mb = mb;
  g.mbp = (mb + MG - 1) / MG * MG;
  g.kc = kc;
  g.res = res;
  return g;
}

// Dynamic shared memory of one CTA, in floats: the input ring (two stages
// of mbp x kc), the reduction exchange (two buffers of NV x mb x nch), and
// the operator bands (3 x n x wmax) or their ring (two stages of kc x wmax).
__host__ __device__ inline size_t smem_floats(const Geom1& g) {
  const size_t ops = g.res ? (size_t)3 * g.n * g.wmax
                           : (size_t)2 * g.kc * g.wmax;
  return (size_t)2 * g.mbp * g.kc + (size_t)2 * NV * g.mb * g.nch + ops;
}

struct Ctl {
  float m0[MB_MAX], pmass[MB_MAX];
  int nsolve[MB_MAX], bad[MB_MAX];
  float norm_R[MB_MAX], norm0[MB_MAX], prev[MB_MAX], norm_t[MB_MAX];
  int done[MB_MAX], act[MB_MAX];
  float alpha0[MB_MAX], alpha[MB_MAX], acc_norm[MB_MAX], outside[MB_MAX];
  int searching[MB_MAX], accepted[MB_MAX];
  float dbar[MB_MAX], floor2[MB_MAX], r2[MB_MAX];
  float rho[MB_MAX], kalpha[MB_MAX], omega[MB_MAX], best_r2[MB_MAX];
  float rho_new[MB_MAX], beta[MB_MAX], alpha_n[MB_MAX], omega_n[MB_MAX];
  int live[MB_MAX], improved[MB_MAX];
};
static_assert(sizeof(Ctl) <= CTL_BYTES, "Ctl outgrew its reserve");

struct Args {
  const float *dts, *phi0, *u, *LT, *VinvT, *VT, *lam, *wts;
  float *hist, *nsolve, *bad, *work;
  int B, M, n, max_iter, n_trips, stagnation;
  Fwd1dConst c;
  Geom1 g;
};

template <int N>
struct Vals {
  float v[N];
};
struct None {};

__device__ __forceinline__ float flog1d(float phi, const Fwd1dConst& c) {
  const float ph = nan_clamp(phi, c.log_lo, c.log_hi);
  return logf((1.f + ph) / (1.f - ph));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}


// One CTA's view of its cluster's group of members. Every method is
// force-inlined into the kernel; the per-member scalars live in `ctl`, the
// same in every CTA of the cluster.
struct March1d {
  const Args& a;
  const Fwd1dConst& c;
  const Geom1& g;
  Ctl& ctl;
  cg::cluster_group cluster;
  int tid, lane, warp, n, C, rank, b0, nb, c0, w, ch0, nchr, npad, par;
  size_t FS;
  float *ringV, *red, *ops, *W;
  const float* opg[3];

  __device__ __forceinline__ March1d(const Args& args, Ctl& ctl_, float* smem)
      : a(args), c(args.c), g(args.g), ctl(ctl_),
        cluster(cg::this_cluster()) {
    tid = threadIdx.x;
    lane = tid & 31;
    warp = tid >> 5;
    n = a.n;
    C = g.C;
    rank = (int)cluster.block_rank();
    b0 = (blockIdx.x / C) * g.mb;
    nb = min(g.mb, a.B - b0);
    ch0 = chunk_first(g, rank);
    nchr = chunk_count(g, rank);
    c0 = CH * ch0;
    w = band_cols(g, rank);
    npad = (n + CH - 1) / CH * CH;
    par = 0;
    FS = (size_t)F1_COUNT * npad;
    ringV = smem;
    red = ringV + 2 * g.mbp * g.kc;
    ops = red + 2 * NV * g.mb * g.nch;
    W = a.work + b0 * FS;
    opg[OP_L] = a.LT;
    opg[OP_VINV] = a.VinvT;
    opg[OP_V] = a.VT;
  }

  __device__ __forceinline__ float* F(int slot) const {
    return W + (size_t)slot * npad;
  }
  __device__ __forceinline__ float* Q(int q, int f) const {
    return F(G_QUAD + 4 * q + f);           // f: 0 phi, 1 mu, 2 Rphi, 3 Rmu
  }

  // ---- set-up: the operator bands and a zero input ring -----------------
  __device__ __forceinline__ void setup() {
    for (int e = tid; e < 2 * g.mbp * g.kc; e += NT) ringV[e] = 0.f;
    if (g.res) {
      for (int o = 0; o < 3; ++o) {
        const float* src = opg[o] + c0;
        float* dst = ops + (size_t)o * n * w;
        for (int e = tid; e < n * w; e += NT) {
          const int k = e / w, j = e - k * w;
          dst[e] = src[(size_t)k * n + j];
        }
      }
    }
    __syncthreads();
  }

  // ---- products ----------------------------------------------------------
  // out_b[col] = sum_k X_b[k] Op[k][col] for the band's columns of every
  // member b < nb, k ascending in one FMA chain; X is a field slot. The
  // epilogue: ld(b, col) loads what output (b, col) needs, then
  // st(b, col, value, loaded), the loads of a unit's eight members first.
  // Starts with a cluster barrier (every band of X written, every earlier
  // product done in every CTA), unless `sync` is false: X was whole at the
  // last cluster barrier, and no product since then reads the field the
  // epilogue writes. Ends with a CTA barrier.
  template <class Ld, class St>
  __device__ __forceinline__ void product(int op, int xslot, Ld ld, St st,
                                          bool sync = true) {
    if (sync) cluster.sync();
    const int kc = g.kc, nkc = (n + kc - 1) / kc;
    const int nmg = (nb + MG - 1) / MG, units = nmg * w;
    const float* X = F(xslot);
    const float* Og = opg[op];
    float* ringA = ops;                     // streaming: two kc x w stages
    const float* band = ops + (size_t)op * n * w;
    // chunk ch into stage ch & 1; this thread copies quad qd of members
    // b = b_first, + bstep, ...
    const int q4 = kc / 4, qd = tid % q4, b_first = tid / q4, bstep = NT / q4;
    auto issue = [&](int ch) {
      if (ch < nkc) {
        const int k0 = ch * kc, st_ = ch & 1;
        float* V = ringV + st_ * g.mbp * kc + 4 * qd;
        const float* src = X + k0 + 4 * qd;
        for (int b = b_first; b < nb; b += bstep)
          cp_async16(V + b * kc, src + b * FS);
        if (!g.res) {
          const int kk = min(kc, n - k0);
          float* A = ringA + st_ * kc * w;
          for (int e = tid; e < kk * w; e += NT) {
            const int k = e / w, j = e - k * w;
            cp_async4(A + e, Og + (size_t)(k0 + k) * n + c0 + j);
          }
        }
      }
      cp_async_commit();
    };
    for (int first = 0; first < units; first += NT) {
      const int u = first + tid;
      const bool valid = u < units;
      // a warp with no unit reads nothing: shared-memory reads bound the
      // product
      const bool busy = first + (tid & ~31) < units;
      const int mg = valid ? u / w : 0, jj = valid ? u - mg * w : 0;
      float acc[MG];
#pragma unroll
      for (int b = 0; b < MG; ++b) acc[b] = 0.f;
      issue(0);
      for (int ch = 0; ch < nkc; ++ch) {
        // chunk ch is in; every thread is past chunk ch - 1, whose stage
        // the load of chunk ch + 1 then takes
        cp_async_wait<0>();
        __syncthreads();
        issue(ch + 1);
        const int k0 = ch * kc, kk_n = min(kc, n - k0), st_c = ch & 1;
        const float* A = (g.res ? band + (size_t)k0 * w
                                : ringA + st_c * kc * w) + jj;
        const float* V = ringV + st_c * g.mbp * kc + mg * MG * kc;
        const int kk4 = busy ? kk_n & ~3 : 0;
        // the eight members' chains advance together, one k at a time
#pragma unroll 2
        for (int kk = 0; kk < kk4; kk += 4) {
          float a[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = A[(kk + i) * w];
          float4 v[MG];
#pragma unroll
          for (int b = 0; b < MG; ++b)
            v[b] = *reinterpret_cast<const float4*>(V + b * kc + kk);
#pragma unroll
          for (int b = 0; b < MG; ++b) acc[b] = fmaf(v[b].x, a[0], acc[b]);
#pragma unroll
          for (int b = 0; b < MG; ++b) acc[b] = fmaf(v[b].y, a[1], acc[b]);
#pragma unroll
          for (int b = 0; b < MG; ++b) acc[b] = fmaf(v[b].z, a[2], acc[b]);
#pragma unroll
          for (int b = 0; b < MG; ++b) acc[b] = fmaf(v[b].w, a[3], acc[b]);
        }
        for (int kk = kk4; busy && kk < kk_n; ++kk) {
          const float ak = A[kk * w];
#pragma unroll
          for (int b = 0; b < MG; ++b)
            acc[b] = fmaf(V[b * kc + kk], ak, acc[b]);
        }
      }
      cp_async_wait<0>();
      __syncthreads();                      // the ring is free again
      if (valid) {
        const int col = c0 + jj;
        decltype(ld(0, col)) in[MG];
#pragma unroll
        for (int b = 0; b < MG; ++b)
          if (mg * MG + b < nb) in[b] = ld(mg * MG + b, col);
#pragma unroll
        for (int b = 0; b < MG; ++b)
          if (mg * MG + b < nb) st(mg * MG + b, col, acc[b], in[b]);
      }
    }
    __syncthreads();
  }

  // A product whose epilogue stores its value into field slot d
  __device__ __forceinline__ void product_to(int op, int xslot, int d,
                                             bool sync = true) {
    float* D = F(d);
    const size_t fs = FS;
    product(op, xslot, [](int, int) { return None{}; },
            [=](int b, int j, float x, None) { D[b * fs + j] = x; }, sync);
  }

  // ---- elementwise passes and reductions --------------------------------
  // st(b, col, ld(b, col)) for every band element of every member with
  // on(b), U elements' loads ahead of their stores; ends with a CTA
  // barrier.
  template <class On, class Ld, class St>
  __device__ __forceinline__ void each_elem(On on, Ld ld, St st) {
    const int tot = nb * w;
    for (int e0 = tid; e0 < tot; e0 += U * NT) {
      decltype(ld(0, 0)) in[U];
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const int e = e0 + q * NT;
        if (e < tot) {
          const int b = e / w;
          if (on(b)) in[q] = ld(b, c0 + e - b * w);
        }
      }
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const int e = e0 + q * NT;
        if (e < tot) {
          const int b = e / w;
          if (on(b)) st(b, c0 + e - b * w, in[q]);
        }
      }
    }
    __syncthreads();
  }

  // Per-member reductions of NV values: acc(b, col, loaded, p) adds column
  // col's terms into the partials p (from init; init alone where !on(b) or
  // past n); each chunk's partials go through a warp xor tree to every CTA,
  // then fin(b, v) runs on thread b of every CTA with the chunks summed (or
  // their NaN-propagating minimum, MIN) in ascending order, and the CTA
  // syncs. The inputs are band-local (a CTA barrier orders them); the
  // exchange alternates between two buffers, so the one written here was
  // last read before the previous reduction's cluster barrier.
  template <int NVR, bool MIN, class On, class Ld, class Ac, class Fin>
  __device__ __forceinline__ void reduce(float init, On on, Ld ld, Ac acc,
                                         Fin fin) {
    __syncthreads();
    float* rb = red + par * NV * g.mb * g.nch;
    par ^= 1;
    const int pairs = nb * nchr;
    const int tail = ch0 + nchr == g.nch ? n - CH * g.nch : 0;
    for (int p0 = warp; p0 < pairs; p0 += U * NWARP) {
      decltype(ld(0, 0)) in[U];
      bool use[U];
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const int pr = p0 + q * NWARP;
        const int b = pr / nchr, col = CH * (ch0 + pr - b * nchr) + lane;
        use[q] = pr < pairs && col < n && on(b);
        if (use[q]) in[q] = ld(b, col);
      }
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const int pr = p0 + q * NWARP;
        if (pr >= pairs) continue;
        const int b = pr / nchr, ch = ch0 + pr - b * nchr;
        float p[NVR];
#pragma unroll
        for (int v = 0; v < NVR; ++v) p[v] = init;
        if (use[q]) acc(b, CH * ch + lane, in[q], p);
        // the last chunk's columns past 32 chunks: lane l also takes
        // column l + 32 of it, after column l
        if (ch == g.nch - 1 && lane < tail && on(b))
          acc(b, CH * ch + CH + lane, ld(b, CH * ch + CH + lane), p);
#pragma unroll
        for (int v = 0; v < NVR; ++v) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const float o = __shfl_xor_sync(0xffffffffu, p[v], off);
            p[v] = MIN ? nan_min(p[v], o) : p[v] + o;
          }
          p[v] = __shfl_sync(0xffffffffu, p[v], 0);
          if (lane < C)
            *cluster.map_shared_rank(rb + (v * g.mb + b) * g.nch + ch,
                                     lane) = p[v];
        }
      }
    }
    cluster.sync();
    if (tid < nb) {
      const int b = tid;
      float out[NVR];
#pragma unroll
      for (int v = 0; v < NVR; ++v) {
        const float* r = rb + (v * g.mb + b) * g.nch;
        float s = MIN ? r[0] : 0.f;
        for (int ch = MIN ? 1 : 0; ch < g.nch; ++ch)
          s = MIN ? nan_min(s, r[ch]) : s + r[ch];
        out[v] = s;
      }
      fin(b, out);
    }
    __syncthreads();
  }

  __device__ __forceinline__ bool any_of(const int* v) const {
    bool any = false;
    for (int b = 0; b < nb; ++b) any = any || v[b] != 0;
    return any;
  }

  // CN residuals of buffer set q against the step's frozen old level; the
  // per-member norms land in norm. The set was whole at the last cluster
  // barrier, and no product since reads Rphi or Rmu.
  __device__ __forceinline__ void resid(int q, float* norm, float inv_dt,
                                        float tau_dt) {
    const float *phi = Q(q, 0), *mu = Q(q, 1);
    float *rp = Q(q, 2), *rm = Q(q, 3);
    const float *phi_old = F(G_PHI_OLD), *mu_old = F(G_MU_OLD);
    const float *w_old = F(G_W_OLD), *w_new = F(G_W_NEW);
    const float *lmu_old = F(G_LMU_OLD), *lphi_old = F(G_LPHI_OLD);
    const size_t fs = FS;
    const Fwd1dConst& k = c;
    product(OP_L, G_QUAD + 4 * q + 1, [&](int b, int j) {
      const size_t i = b * fs + j;
      return Vals<3>{{phi[i], phi_old[i], lmu_old[i]}};
    }, [&](int b, int j, float l, const Vals<3>& in) {
      rm[b * fs + j] = (in.v[0] - in.v[1]) * inv_dt - 0.5f * (l + in.v[2]);
    }, false);
    product(OP_L, G_QUAD + 4 * q, [&](int b, int j) {
      const size_t i = b * fs + j;
      return Vals<7>{{phi[i], phi_old[i], lphi_old[i], mu[i], mu_old[i],
                      w_new[i], w_old[i]}};
    }, [&](int b, int j, float l, const Vals<7>& in) {
      const float ph = in.v[0], po = in.v[1];
      rp[b * fs + j] = tau_dt * (ph - po) - k.half_kappa * (l + in.v[2]) +
                       k.c1 * flog1d(ph, k) + (-k.two_c2 * po) -
                       0.5f * (in.v[3] + in.v[4]) -
                       0.5f * (in.v[5] + in.v[6]);
    }, false);
    reduce<2, false>(0.f, [](int) { return true; }, [&](int b, int j) {
      return Vals<2>{{rp[b * fs + j], rm[b * fs + j]}};
    }, [](int, int, const Vals<2>& in, float (&p)[2]) {
      p[0] += in.v[0] * in.v[0];
      p[1] += in.v[1] * in.v[1];
    }, [&](int b, const float (&v)[2]) { norm[b] = sqrtf(v[0] + v[1]); });
  }

  // The Schur solve in the cosine basis -> (dphi, dmu) of the current set
  __device__ __forceinline__ void schur_solve(float inv_dt, float tau_dt) {
    float *X = F(G_X), *Rr = F(G_R), *P = F(G_P), *V = F(G_V);
    float *R0 = F(G_R0), *BX = F(G_BX), *Sv = F(G_S), *T = F(G_T);
    float *PH = F(G_PH), *SH = F(G_SH), *T1 = F(G_T1);
    float *dfield = F(G_D), *dphi = F(G_DPHI), *dmu = F(G_DMU);
    const float *phi = Q(S_CUR, 0), *rp = Q(S_CUR, 2), *rm = Q(S_CUR, 3);
    const float* lam = a.lam;
    const size_t fs = FS;
    const Fwd1dConst& k = c;
    auto all = [](int) { return true; };
    auto poly = [&](float l) {
      return (inv_dt - tau_dt * l) + (k.half_kappa * l) * l;
    };
    reduce<1, false>(0.f, all, [&](int b, int j) {
      return Vals<1>{{phi[b * fs + j]}};
    }, [&](int b, int j, const Vals<1>& in, float (&p)[1]) {
      const float ph = in.v[0];
      const float d = k.two_c1 / (1.f - ph * ph);
      dfield[b * fs + j] = d;
      p[0] += d;
    }, [&](int b, const float (&v)[1]) { ctl.dbar[b] = v[0] / (float)n; });
    auto prec = [&](int b, float l, float v) {
      return v / (poly(l) - ctl.dbar[b] * l);
    };
    // S yh = poly yh - lam to_s(d from_s(yh))
    auto apply_S = [&](int yslot, float* OUT) {
      const float* Y = F(yslot);
      product(OP_V, yslot, [&](int b, int j) {
        return Vals<1>{{dfield[b * fs + j]}};
      }, [&](int b, int j, float v, const Vals<1>& in) {
        T1[b * fs + j] = in.v[0] * v;
      });
      product(OP_VINV, G_T1, [&](int b, int j) {
        return Vals<2>{{lam[j], Y[b * fs + j]}};
      }, [&](int b, int j, float v, const Vals<2>& in) {
        const float l = in.v[0];
        OUT[b * fs + j] = poly(l) * in.v[1] - l * v;
      });
    };
    // b = to_s(L Rphi - Rmu); x0 = 0 (Rphi was whole at dbar's barrier)
    product(OP_L, G_QUAD + 4 * S_CUR + 2, [&](int b, int j) {
      return Vals<1>{{rm[b * fs + j]}};
    }, [&](int b, int j, float l, const Vals<1>& in) {
      T1[b * fs + j] = l - in.v[0];
    }, false);
    product(OP_VINV, G_T1, [](int, int) { return None{}; },
            [&](int b, int j, float v, None) {
              const size_t i = b * fs + j;
              R0[i] = v;
              Rr[i] = v;
              X[i] = 0.f;
              BX[i] = 0.f;
              P[i] = 0.f;
              V[i] = 0.f;
            });
    reduce<1, false>(0.f, all, [&](int b, int j) {
      return Vals<1>{{R0[b * fs + j]}};
    }, [](int, int, const Vals<1>& in, float (&p)[1]) {
      p[0] += in.v[0] * in.v[0];
    }, [&](int b, const float (&v)[1]) {
      ctl.floor2[b] = k.floor_fac * nan_max(v[0], EPS_DIV);
      ctl.r2[b] = v[0];
      ctl.rho[b] = ctl.kalpha[b] = ctl.omega[b] = 1.f;
      ctl.best_r2[b] = v[0];
      ctl.live[b] = 1;
    });
    auto live = [&](int b) { return ctl.live[b] != 0; };
    // fixed-trip BiCGStab in masked lockstep (common.cuh bicgstab_fixed)
    for (int trip = 0; trip < a.n_trips; ++trip) {
      if (tid < nb)
        ctl.live[tid] = ctl.live[tid] && ctl.r2[tid] > ctl.floor2[tid];
      __syncthreads();
      if (!any_of(ctl.live)) break;
      reduce<1, false>(0.f, all, [&](int b, int j) {
        return Vals<2>{{R0[b * fs + j], Rr[b * fs + j]}};
      }, [](int, int, const Vals<2>& in, float (&p)[1]) {
        p[0] += in.v[0] * in.v[1];
      }, [&](int b, const float (&v)[1]) {
        ctl.rho_new[b] = v[0];
        ctl.beta[b] = (v[0] / (ctl.rho[b] + EPS_DIV)) *
                      (ctl.kalpha[b] / (ctl.omega[b] + EPS_DIV));
      });
      each_elem(live, [&](int b, int j) {
        const size_t o = b * fs + j;
        return Vals<4>{{Rr[o], P[o], V[o], lam[j]}};
      }, [&](int b, int j, const Vals<4>& in) {
        const size_t o = b * fs + j;
        const float p =
            in.v[0] + ctl.beta[b] * (in.v[1] - ctl.omega[b] * in.v[2]);
        P[o] = p;
        PH[o] = prec(b, in.v[3], p);
      });
      apply_S(G_PH, V);
      reduce<1, false>(0.f, all, [&](int b, int j) {
        return Vals<2>{{R0[b * fs + j], V[b * fs + j]}};
      }, [](int, int, const Vals<2>& in, float (&p)[1]) {
        p[0] += in.v[0] * in.v[1];
      }, [&](int b, const float (&v)[1]) {
        ctl.alpha_n[b] = ctl.rho_new[b] / (v[0] + EPS_DIV);
      });
      each_elem(live, [&](int b, int j) {
        const size_t o = b * fs + j;
        return Vals<3>{{Rr[o], V[o], lam[j]}};
      }, [&](int b, int j, const Vals<3>& in) {
        const size_t o = b * fs + j;
        const float sv = in.v[0] - ctl.alpha_n[b] * in.v[1];
        Sv[o] = sv;
        SH[o] = prec(b, in.v[2], sv);
      });
      apply_S(G_SH, T);
      reduce<2, false>(0.f, all, [&](int b, int j) {
        return Vals<2>{{T[b * fs + j], Sv[b * fs + j]}};
      }, [](int, int, const Vals<2>& in, float (&p)[2]) {
        const float t = in.v[0];
        p[0] += t * in.v[1];
        p[1] += t * t;
      }, [&](int b, const float (&v)[2]) {
        ctl.omega_n[b] = v[0] / (v[1] + EPS_DIV);
      });
      reduce<1, false>(0.f, live, [&](int b, int j) {
        const size_t o = b * fs + j;
        return Vals<5>{{X[o], PH[o], SH[o], Sv[o], T[o]}};
      }, [&](int b, int j, const Vals<5>& in, float (&p)[1]) {
        const size_t o = b * fs + j;
        X[o] = in.v[0] + ctl.alpha_n[b] * in.v[1] + ctl.omega_n[b] * in.v[2];
        const float r = in.v[3] - ctl.omega_n[b] * in.v[4];
        Rr[o] = r;
        p[0] += r * r;
      }, [&](int b, const float (&v)[1]) {
        ctl.improved[b] = 0;
        if (!ctl.live[b]) return;
        const float r2n = v[0];
        if (!isfinite(r2n)) {
          ctl.live[b] = 0;
          return;
        }
        ctl.rho[b] = ctl.rho_new[b];
        ctl.kalpha[b] = ctl.alpha_n[b];
        ctl.omega[b] = ctl.omega_n[b];
        if (r2n < ctl.best_r2[b]) {
          ctl.best_r2[b] = r2n;
          ctl.improved[b] = 1;
        }
        ctl.r2[b] = r2n;
      });
      if (any_of(ctl.improved))
        each_elem([&](int b) { return ctl.improved[b] != 0; },
                  [&](int b, int j) { return Vals<1>{{X[b * fs + j]}}; },
                  [&](int b, int j, const Vals<1>& in) {
                    BX[b * fs + j] = in.v[0];
                  });
    }
    // dphi = from_s(best x); dmu = 2 (Kpp dphi + Rphi)
    product_to(OP_V, G_BX, G_DPHI);
    product(OP_L, G_DPHI, [&](int b, int j) {
      const size_t i = b * fs + j;
      return Vals<3>{{dfield[i], dphi[i], rp[i]}};
    }, [&](int b, int j, float l, const Vals<3>& in) {
      const float kpp = -k.half_kappa * l + (tau_dt + in.v[0]) * in.v[1];
      dmu[b * fs + j] = 2.f * (kpp + in.v[2]);
    });
  }

  __device__ __forceinline__ void run() {
    float *phi_old = F(G_PHI_OLD), *mu_old = F(G_MU_OLD);
    float *w_old = F(G_W_OLD), *w_new = F(G_W_NEW);
    float *lmu_old = F(G_LMU_OLD), *lphi_old = F(G_LPHI_OLD);
    float *cphi = Q(S_CUR, 0), *cmu = Q(S_CUR, 1);
    const float *dphi = F(G_DPHI), *dmu = F(G_DMU);
    const float* wts = a.wts;
    const size_t fs = FS, hs = (size_t)(a.M + 1) * n;
    float* hist = a.hist + b0 * hs;
    const float* ub = a.u + b0 * hs;
    const Fwd1dConst& k = c;
    auto all = [](int) { return true; };
    setup();
    cluster.sync();   // every CTA has started: its shared memory may be written

    // ---- initial state: w0 = 0, mu0 = -kappa L phi0 + c1 f_log(phi0)
    // - 2 c2 phi0, m0 = sum(wts phi0) ----
    reduce<1, false>(0.f, all, [&](int b, int j) {
      return Vals<2>{{a.phi0[(size_t)(b0 + b) * n + j], wts[j]}};
    }, [&](int b, int j, const Vals<2>& in, float (&p)[1]) {
      const float ph = in.v[0];
      phi_old[b * fs + j] = ph;
      w_old[b * fs + j] = 0.f;
      hist[b * hs + j] = ph;
      p[0] += in.v[1] * ph;
    }, [&](int b, const float (&v)[1]) {
      ctl.m0[b] = v[0];
      ctl.nsolve[b] = 0;
      ctl.bad[b] = -1;
    });
    product(OP_L, G_PHI_OLD, [&](int b, int j) {
      return Vals<1>{{phi_old[b * fs + j]}};
    }, [&](int b, int j, float l, const Vals<1>& in) {
      const float ph = in.v[0];
      mu_old[b * fs + j] = k.neg_kappa * l + k.c1 * flog1d(ph, k) - k.two_c2 * ph;
    }, false);                            // phi_old whole at m0's barrier

    for (int step = 0; step < a.M; ++step) {
      const float dt = a.dts[step];
      const float inv_dt = 1.f / dt;
      const float tau_dt = k.tau * inv_dt;
      const float gamma_dt = k.gamma * inv_dt;
      // after the last reduction of the previous step (no product since)
      each_elem(all, [&](int b, int j) {
        const float* un = ub + b * hs + (size_t)step * n;
        const size_t o = b * fs + j;
        return Vals<5>{{w_old[o], un[j + n], un[j], phi_old[o], mu_old[o]}};
      }, [&](int b, int j, const Vals<5>& in) {
        const size_t o = b * fs + j;
        w_new[o] = ((gamma_dt - 0.5f) * in.v[0] + 0.5f * (in.v[1] + in.v[2])) /
                   (gamma_dt + 0.5f);
        // the Newton iterate starts from (phi_old, mu_old)
        cphi[o] = in.v[3];
        cmu[o] = in.v[4];
      });
      product_to(OP_L, G_MU_OLD, G_LMU_OLD);
      product_to(OP_L, G_PHI_OLD, G_LPHI_OLD, false);

      // ---- Newton in masked lockstep: each member's own trip count ----
      resid(S_CUR, ctl.norm_R, inv_dt, tau_dt);
      if (tid < nb) {
        ctl.norm0[tid] = ctl.norm_R[tid];
        ctl.prev[tid] = INFINITY;
        ctl.done[tid] = 0;
      }
      __syncthreads();
      for (int it = 0; it < a.max_iter; ++it) {
        if (tid < nb) {
          const int b = tid;
          bool conv = ctl.norm_R[b] < k.newton_tol;
          if (k.newton_rtol > 0.f)
            conv = conv || ctl.norm_R[b] < k.newton_rtol * ctl.norm0[b];
          if (a.stagnation && it > 0) conv = conv || ctl.norm_R[b] >= ctl.prev[b];
          ctl.done[b] = ctl.done[b] || conv;
          ctl.act[b] = !ctl.done[b];
        }
        __syncthreads();
        if (!any_of(ctl.act)) break;
        schur_solve(inv_dt, tau_dt);

        // step ceiling: alpha0 = min(1, 0.9 alpha_max), 1 when alpha_max
        // is not finite or not positive
        reduce<2, true>(INFINITY, all, [&](int b, int j) {
          return Vals<2>{{dphi[b * fs + j], cphi[b * fs + j]}};
        }, [&](int, int, const Vals<2>& in, float (&p)[2]) {
          const float dp = in.v[0], ph = in.v[1];
          p[0] = nan_min(p[0], dp > 0.f ? (k.hi - ph) / dp : INFINITY);
          p[1] = nan_min(p[1], dp < 0.f ? (k.lo - ph) / dp : INFINITY);
        }, [&](int b, const float (&v)[2]) {
          float amax = nan_min(v[0], v[1]);
          if (!isfinite(amax) || amax <= 0.f) amax = 1.f;
          ctl.alpha0[b] = fminf(1.f, 0.9f * amax);
          ctl.acc_norm[b] = 0.f;
          ctl.searching[b] = ctl.act[b];
          ctl.accepted[b] = 0;
        });

        // Armijo on the residual norm, in lockstep over the active members
        float fac = 1.f;
        for (int j = 0; j < 12 && any_of(ctl.searching); ++j) {
          float *tphi = Q(S_TRIAL, 0), *tmu = Q(S_TRIAL, 1);
          if (tid < nb) ctl.alpha[tid] = ctl.alpha0[tid] * fac;
          __syncthreads();
          reduce<1, false>(0.f, [&](int b) { return ctl.searching[b] != 0; },
                           [&](int b, int jc) {
            const size_t o = b * fs + jc;
            return Vals<4>{{cphi[o], dphi[o], cmu[o], dmu[o]}};
          }, [&](int b, int jc, const Vals<4>& in, float (&p)[1]) {
            const size_t o = b * fs + jc;
            const float pt = in.v[0] + ctl.alpha[b] * in.v[1];
            tphi[o] = pt;
            tmu[o] = in.v[2] + ctl.alpha[b] * in.v[3];
            p[0] += fabsf(pt) < k.hi ? 0.f : 1.f;   // NaN counts as outside
          }, [&](int b, const float (&v)[1]) { ctl.outside[b] = v[0]; });
          resid(S_TRIAL, ctl.norm_t, inv_dt, tau_dt);
          if (tid < nb) {
            const int b = tid;
            ctl.improved[b] = 0;           // here: take the trial set
            if (ctl.searching[b] && ctl.outside[b] == 0.f &&
                ctl.norm_t[b] <= (1.f - 1e-3f * ctl.alpha[b]) * ctl.norm_R[b]) {
              ctl.accepted[b] = 1;
              ctl.searching[b] = 0;
              ctl.acc_norm[b] = ctl.norm_t[b];
              ctl.improved[b] = 1;
            }
          }
          __syncthreads();
          if (any_of(ctl.improved)) {
            // the trial set becomes the current one (no product since the
            // residual's reduction)
            const float *s0 = Q(S_TRIAL, 0), *s1 = Q(S_TRIAL, 1),
                        *s2 = Q(S_TRIAL, 2), *s3 = Q(S_TRIAL, 3);
            float *d0 = Q(S_CUR, 0), *d1 = Q(S_CUR, 1), *d2 = Q(S_CUR, 2),
                  *d3 = Q(S_CUR, 3);
            each_elem([&](int b) { return ctl.improved[b] != 0; },
                      [&](int b, int jc) {
                        const size_t o = b * fs + jc;
                        return Vals<4>{{s0[o], s1[o], s2[o], s3[o]}};
                      },
                      [&](int b, int jc, const Vals<4>& in) {
                        const size_t o = b * fs + jc;
                        d0[o] = in.v[0];
                        d1[o] = in.v[1];
                        d2[o] = in.v[2];
                        d3[o] = in.v[3];
                      });
          }
          fac *= 0.5f;
        }
        if (tid < nb) {
          const int b = tid;
          if (ctl.act[b]) {
            ++ctl.nsolve[b];
            ctl.prev[b] = ctl.norm_R[b];
            if (ctl.accepted[b])
              ctl.norm_R[b] = ctl.acc_norm[b];
            else
              ctl.done[b] = 1;    // a failed line search ends the loop
          }
        }
        __syncthreads();
      }

      // ---- clip + uniform mass projection + sanitizer ----
      reduce<1, false>(0.f, all, [&](int b, int j) {
        return Vals<2>{{cphi[b * fs + j], wts[j]}};
      }, [&](int, int, const Vals<2>& in, float (&p)[1]) {
        p[0] += in.v[1] * nan_clamp(in.v[0], k.lo, k.hi);
      }, [&](int b, const float (&v)[1]) {
        const float mass_error = v[0] - ctl.m0[b];
        ctl.pmass[b] = mass_error / k.Lx_len;      // the uniform shift
        if (!isfinite(mass_error) && ctl.bad[b] < 0) ctl.bad[b] = step;
      });
      each_elem(all, [&](int b, int j) {
        const size_t o = b * fs + j;
        return Vals<3>{{cphi[o], cmu[o], w_new[o]}};
      }, [&](int b, int j, const Vals<3>& in) {
        const size_t o = b * fs + j;
        const float pc = nan_clamp(in.v[0], k.lo, k.hi) - ctl.pmass[b];
        phi_old[o] = pc;
        hist[b * hs + (size_t)(step + 1) * n + j] = pc;
        mu_old[o] = in.v[1];
        w_old[o] = in.v[2];
      });
    }
    if (rank == 0 && tid < nb) {
      a.nsolve[b0 + tid] = (float)ctl.nsolve[tid];
      a.bad[b0 + tid] = (float)ctl.bad[tid];
    }
    cluster.sync();   // no CTA leaves while a peer may still write its red
  }
};

__global__ void __launch_bounds__(NT, 1) march1d_kernel(Args a) {
  extern __shared__ float4 smem4[];
  __shared__ Ctl ctl;
  March1d(a, ctl, reinterpret_cast<float*>(smem4)).run();
}

// Per device: the dynamic shared-memory limit set so far and the
// non-portable cluster attribute.
struct LaunchState {
  size_t smem_set = 0;
  bool nonportable = false;
};

static std::mutex launch_mutex;

// The launch configuration of `clusters` clusters of C CTAs; sets the
// kernel's attributes for it once per device.
int configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
              int clusters, int C, size_t smem, cudaStream_t stream) {
  static LaunchState state[16];
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
  std::lock_guard<std::mutex> lock(launch_mutex);
  LaunchState& st = state[dev];
  if (smem > st.smem_set) {
    err = cudaFuncSetAttribute(march1d_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    st.smem_set = smem;
  }
  if (C > 8 && !st.nonportable) {
    err = cudaFuncSetAttribute(march1d_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return (int)err;
    st.nonportable = true;
  }
  return 0;
}

// The geometry the kernel recomputes from (n, C, mb, kc, res): 0 if the
// caller's smem_bytes is its own and fits, else cudaErrorInvalidValue.
int check_geometry(int n, int C, int mb, int kc, int res, int smem_bytes,
                   Geom1& g) {
  const int nch = n / CH > 1 ? n / CH : 1;
  if (n <= 1 || C < 1 || C > MAX_C || C > nch || mb < 1 || mb > MB_MAX ||
      kc < 4 || kc > CH || kc % 4 || CH % kc || (res != 0 && res != 1))
    return (int)cudaErrorInvalidValue;
  g = make_geom1(n, C, mb, kc, res);
  const size_t smem = 4 * smem_floats(g);
  if (smem != (size_t)smem_bytes || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace m1d
}  // namespace vch

extern "C" int vch_march_1d_workspace_fields() { return vch::m1d::F1_COUNT; }

// How many clusters of `cluster` CTAs of the 1D march with this geometry
// can be resident at once on the current card; a negative CUDA error code
// on failure.
extern "C" int vch_march1d_max_clusters(int n, int cluster, int members,
                                        int kc, int resident,
                                        int smem_bytes) {
  using namespace vch::m1d;
  Geom1 g;
  int err = check_geometry(n, cluster, members, kc, resident, smem_bytes, g);
  if (err) return -err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  err = configure(cfg, attr, 1, cluster, smem_bytes, 0);
  if (err) return -err;
  int clusters = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&clusters, march1d_kernel, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

// The whole batched 1D march, `members` members per cluster of `cluster`
// CTAs (ceil(B / members) clusters), ring stages of kc rows, on the
// geometry of ops/march.py
// march1d_geometry, checked here against the kernel's own. u is
// (B, M+1, n) in core layout, hist (B, M+1, n) with phi0 first; nsolve and
// first_bad are (B,) float32; work holds B x vch_march_1d_workspace_fields()
// fields of n rounded up to 32 floats.
extern "C" int vch_march_fused_1d(
    const float* dts, const float* phi0, const float* u, const float* LT,
    const float* VinvT, const float* VT, const float* lam, const float* wts,
    float* hist, float* nsolve, float* first_bad, float* work, int B, int M,
    int n, const float* consts, int nconst, int max_iter, int n_trips,
    int stagnation, int cluster, int members, int kc, int resident,
    int smem_bytes, void* stream) {
  using namespace vch::m1d;
  if (nconst != FWD1D_NCONST || B <= 0 || M <= 0 || max_iter < 0 ||
      n_trips < 0)
    return (int)cudaErrorInvalidValue;
  Args a{dts, phi0, u, LT, VinvT, VT, lam, wts, hist, nsolve, first_bad,
         work, B, M, n, max_iter, n_trips, stagnation, {}, {}};
  int err = check_geometry(n, cluster, members, kc, resident, smem_bytes,
                           a.g);
  if (err) return err;
  float* dst = reinterpret_cast<float*>(&a.c);
  for (int i = 0; i < FWD1D_NCONST; ++i) dst[i] = consts[i];
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  err = configure(cfg, attr, (B + members - 1) / members, cluster,
                  smem_bytes, (cudaStream_t)stream);
  if (err) return err;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, march1d_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
