// The 2D adjoint (p, q, r) sweep on thread-block clusters: a block of MB
// members per cluster, MB = 8, 4 or 2 for the member-blocked sweep, MB = 1
// for the whole one-member sweep and for a K-step segment.
//
// Replaces three TPU kernels of vch_tpu/ops/pallas_march.py:
//   - :751 adjoint_fused_2d (factory :567-748): one member per program, the
//     terminal solve, r of every level; here adjoint_cluster_kernel<1,
//     false>, one member per cluster;
//   - :1905 adjoint_fused_2d_blocked (factory :1727): block_b members per
//     program in masked lockstep; here adjoint_cluster_kernel<block_b,
//     false> for block_b = 8, 4 or 2;
//   - :819 adjoint_fused_2d_segment (the carry-in factory :567-748): one
//     member per program, the (p, q, r) carry of the segment's last level in
//     instead of the terminal solve, (p, q, r) of its first level out, r of
//     its K levels in forward order; here adjoint_cluster_kernel<1, true>,
//     one member per cluster.
// Each computes, member for member and bit for bit, what the one-CTA sweep
// of adjoint2d.cu computes (its segment flag included): the terminal solve
// (I - tau L) p_T = b2 (phi(T) - phi_Omega) exact in the cosine basis and
// q_T = -L p_T, or the carry; then per reverse step f'' and
// isd = 1 / sqrt|poly - (dt/2) mean(f'') lam|, rhs = B(phi_{n+1}) p_{n+1} +
// (dt/2) b1 (src_n + src_{n+1}), the split-preconditioned spectral
// BiCGStab solve (warm start p_{n+1}, n_trips trips, best iterate,
// noise-floor freeze), p_n = from_s(isd best), q_n = -L p_n and the r CN
// recursion; dt <= 1e-14 copies the next level.
//
// What bounds it on an H100: per step a chain of 16 + 8 n_trips dependent
// dense (n x n)(n x m) products per member (56 at five trips) and about 25
// reductions whose results every later step needs; no Newton or Armijo
// loop. The MB members of a block share each operator slab, so a block's
// products are MB times as wide as one member's; with one member (the
// segment sweep at 257 x 257, B = 1 .. 32; the whole sweep at a batch
// below the SM count) a cluster of up to 16 SMs shortens each link of the
// chain instead. At config 4's B = 128 the whole sweep takes clusters of 1:
// one member per SM, as the one-CTA sweep, on this engine's products.
//
// Design: cluster.cuh's engine, as the cluster march (march2d_blocked.cu)
// runs it. Member state lives in the global workspace (B, 20, n, m) as in
// adjoint2d.cu; a Laplacian's first product goes through the T2 field,
// free at every Laplacian. The step's solve is adjoint_solve.cuh's, which
// the per-step solve kernel (solve2d_cluster.cu) runs too. Every product output sums its k terms in
// ascending order in one FMA chain, a Laplacian adds its two rounded
// products and every reduction follows common.cuh's block_sum order, as
// adjoint2d.cu does; both are compiled with -fmad=false (ops/_build.py), so
// each elementwise expression, written here as there, rounds the same. So a
// member's bits depend neither on the cluster size nor on the batch, and
// equal the one-CTA sweep's. Full float32 FMA: no tensor cores, no TF32.
//
// The bf16 forms, adjoint_bf16_kernel<MB, SEG> (one object each,
// -DVCH_PREC=1): the same sweep with the Krylov operator At's four products
// on bf16 mma.sync at vch_tpu's adjoint_solve_precision "bf16x3"
// (pallas_march.py:677-686): three single passes on the (hi, lo) split
// summed d0 + (d1 + d2) (cluster.cuh product16). Every other product (bt,
// y0, p_n, the Laplacians, the terminal solve) stays full float32, as in
// vch_tpu. Each product sums its k tiles in ascending order from zero
// whatever the tiling, so these forms too give a member the same bits at
// every cluster size and block. The float32 kernels are left as they were:
// the bf16 path is its own kernel and AdjArgs16, and the float32 objects
// keep their SASS.
#include <type_traits>

#include "adjoint_solve.cuh"

namespace vch {
namespace sweep {

using namespace cluster;

// The sweep's fields in the shared solve (adjoint_solve.cuh)
struct SweepSlots {
  enum { ISD = A_ISD, FPP = A_FPP, X = A_X, RR = A_RR, PK = A_PK, V = A_V,
         R0 = A_R0, BX = A_BX, S = A_S, T = A_T, Z = A_Z, T1 = A_T1,
         T2 = A_T2 };
};

// The bf16 sweep's arguments: At's four operators as product16's fragment
// copies, the passes (3: "bf16x3"; 1: one pass, which no solve precision
// selects, since vch_tpu offers no one-pass sweep: a control for the tests,
// a deliberately coarser At) and product16's slab widths.
struct AdjArgs16 : AdjArgs {
  Ops16 ops16;
  int passes, jt_left, jt_right;
};

template <bool BF16>
using AdjArgsOf = std::conditional_t<BF16, AdjArgs16, AdjArgs>;

// One CTA's view of its block of MB members; SEG: a segment with the
// carry in and out; BF16: the solve's At on product16 (the rest as
// without). Every method is force-inlined into the kernel, so the state
// below lives in registers; the per-member scalars live in `ctl`, in
// shared memory.
template <int MB, bool SEG, bool BF16 = false>
struct Sweep : adj::Solve<MB, AdjArgsOf<BF16>, SweepSlots, false, BF16> {
  using Base = adj::Solve<MB, AdjArgsOf<BF16>, SweepSlots, false, BF16>;
  using Base::nm;
  using Base::b0;
  using Base::FS;
  using Base::all;
  using Base::cluster;
  using Base::F;
  using Base::each_elem;
  using Base::gemm_l_to;
  using Base::gemm_r;
  using Base::gemm_r_to;
  using Base::a;
  using Base::c;
  using Base::ctl;
  size_t HS, RS;

  __device__ __forceinline__ Sweep(const AdjArgsOf<BF16>& args,
                                   const BGeom& g,
                                   adj::Ctl<MB>& ctl_, float* smem)
      : Base(args, g, ctl_, smem, A_COUNT) {
    HS = (size_t)(a.M + 1) * nm;                // member stride of hist, phiQ
    RS = (size_t)(SEG ? a.M : a.M + 1) * nm;    // and of r
  }

  // the Laplacian through the T2 field, free at every Laplacian
  template <class Ld, class St>
  __device__ __forceinline__ void lap(const float* V, Ld ld, St st) {
    Base::lap(a.Lx, a.LyT, V, F(A_T2), ld, st);
  }

  __device__ __forceinline__ void run() {
    float *P = F(A_P), *Q = F(A_Q), *R = F(A_R), *PN = F(A_PN), *QN = F(A_QN);
    float *W1 = F(A_W1), *RHS = F(A_RHS), *FPP = F(A_FPP), *ISD = F(A_ISD);
    float *Z = F(A_Z), *T1 = F(A_T1), *T2 = F(A_T2);
    const auto solve_fields = this->fields();
    const float* lam = a.lam;
    const float* hb = a.hist + b0 * HS;
    const float* qb = a.phiQ + b0 * HS;
    float* rb = a.r + b0 * RS;
    const size_t fs = FS, hs = HS, rs = RS;
    const AdjConst& k = c;
    const int M = a.M;

    if constexpr (SEG) {
      // the carry of the segment's last level
      each_elem(all, [&](int b, int e) {
        const size_t g = (size_t)(b0 + b) * nm + e;
        return Vals<3>{{a.p0[g], a.q0[g], a.r0[g]}};
      }, [&](int b, int e, const Vals<3>& in) {
        const size_t o = b * fs + e;
        P[o] = in.v[0];
        Q[o] = in.v[1];
        R[o] = in.v[2];
      });
    } else {
      // terminal: (I - tau L) p_T = b2 (phi(T) - phi_Omega); q_T; r_T = 0
      each_elem(all, [&](int b, int e) {
        return Vals<2>{{hb[b * hs + (size_t)M * nm + e],
                        a.phiT[(size_t)(b0 + b) * nm + e]}};
      }, [&](int b, int e, const Vals<2>& in) {
        const size_t o = b * fs + e;
        T1[o] = a.b2[b0 + b] * (in.v[0] - in.v[1]);
        rb[b * rs + (size_t)M * nm + e] = 0.f;
        R[o] = 0.f;
      });
      gemm_l_to(a.Vxi, T1, T2);
      gemm_r(T2, a.VyiT, [&](int, int e) { return Vals<1>{{lam[e]}}; },
             [&](int b, int e, float v, const Vals<1>& in) {
               Z[b * fs + e] = v / (1.f - k.tau * in.v[0]);
             });
      gemm_l_to(a.Vx, Z, T1);
      gemm_r_to(T1, a.VyT, P);
      lap(P, [](int, int) { return None{}; },
          [&](int b, int e, float l, None) { Q[b * fs + e] = -l; });
    }

    for (int nstep = M - 1; nstep >= 0; --nstep) {
      const float dt = a.dts[nstep];
      float* rf = rb + (size_t)nstep * nm;    // member b's frame at + b rs
      if (dt <= 1e-14f) {               // copy the next level
        cluster.sync();                 // R's bands were written by their CTAs
        each_elem(all, [&](int b, int e) { return Vals<1>{{R[b * fs + e]}}; },
                  [&](int b, int e, const Vals<1>& in) {
                    rf[b * rs + e] = in.v[0];
                  });
        continue;
      }
      const float half_dt = 0.5f * dt;
      const float* hn = hb + (size_t)nstep * nm;    // phi_n; phi_{n+1} at + nm
      const float* qn = qb + (size_t)nstep * nm;

      // f''(phi_n), its mean and the preconditioner scale isd
      this->template reduce<1, false>(0.f, all, [&](int b, int e) {
        return Vals<1>{{hn[b * hs + e]}};
      }, [&](int b, int e, const Vals<1>& in, float (&p)[1]) {
        const float f = fpp(in.v[0], k);
        FPP[b * fs + e] = f;
        p[0] += f;
      }, [&](int b, const float (&v)[1]) {
        ctl.hdt_fbar[b] = half_dt * (v[0] / (float)nm);
      });
      each_elem(all, [&](int, int e) { return Vals<1>{{lam[e]}}; },
                [&](int b, int e, const Vals<1>& in) {
        const float l = in.v[0];
        const float poly = (1.f - k.tau * l) + (half_dt * l) * l;
        ISD[b * fs + e] = 1.f / sqrtf(fabsf(poly - ctl.hdt_fbar[b] * l));
      });

      // rhs = B(phi_{n+1}) p_{n+1} + (dt/2) b1 (src_n + src_{n+1})
      lap(P, [](int, int) { return None{}; },
          [&](int b, int e, float l, None) { W1[b * fs + e] = l; });
      lap(W1, [&](int b, int e) {
        const size_t i = b * fs + e, h = b * hs + e;
        return Vals<6>{{W1[i], P[i], hn[h], hn[h + nm], qn[h], qn[h + nm]}};
      }, [&](int b, int e, float l, const Vals<6>& in) {
        const float w1 = in.v[0];
        const float Bp = in.v[1] - k.tau * w1 - half_dt * l +
                         (half_dt * fpp(in.v[3], k)) * w1;
        const float src = (in.v[2] - in.v[4]) + (in.v[3] - in.v[5]);
        RHS[b * fs + e] = Bp + (half_dt * a.b1[b0 + b]) * src;
      });

      // the solve of A(phi_n) p_n = rhs warm started from p_{n+1}:
      // p_n = from_s(isd best) into PN
      this->solve(solve_fields, RHS, P, PN, k.tau, half_dt);

      // q_n = -L p_n; r CN recursion
      const float den = k.gamma + half_dt;
      const float ca = (k.gamma - half_dt) / den, cb = half_dt / den;
      lap(PN, [&](int b, int e) {
        const size_t i = b * fs + e;
        return Vals<2>{{R[i], Q[i]}};
      }, [&](int b, int e, float l, const Vals<2>& in) {
        const size_t i = b * fs + e;
        const float q = -l;
        QN[i] = q;
        const float r = ca * in.v[0] + cb * (q + in.v[1]);
        R[i] = r;
        rf[b * rs + e] = r;
      });
      float* tmp = P;
      P = PN;
      PN = tmp;
      tmp = Q;
      Q = QN;
      QN = tmp;
    }
    if constexpr (SEG) {
      cluster.sync();                   // P, Q, R's bands: their CTAs wrote them
      each_elem(all, [&](int b, int e) {
        const size_t o = b * fs + e;
        return Vals<3>{{P[o], Q[o], R[o]}};
      }, [&](int b, int e, const Vals<3>& in) {
        const size_t g = (size_t)(b0 + b) * nm + e;
        a.p_f[g] = in.v[0];
        a.q_f[g] = in.v[1];
        a.r_f[g] = in.v[2];
      });
    }
    cluster.sync();   // no CTA leaves while a peer may still write its Ctl
  }
};

template <int MB, bool SEG>
__global__ void __launch_bounds__(NT, 1)
    adjoint_cluster_kernel(AdjArgs a, BGeom g) {
  extern __shared__ float4 smem4[];
  __shared__ adj::Ctl<MB> ctl;
  Sweep<MB, SEG>(a, g, ctl, reinterpret_cast<float*>(smem4)).run();
}

// adjoint_cluster_kernel with At's products on bf16 mma.sync
// (adjoint_solve_precision "bf16x3").
template <int MB, bool SEG>
__global__ void __launch_bounds__(NT, 1)
    adjoint_bf16_kernel(AdjArgs16 a, BGeom g) {
  extern __shared__ float4 smem4[];
  __shared__ adj::Ctl<MB> ctl;
  Sweep<MB, SEG, true>(a, g, ctl, reinterpret_cast<float*>(smem4)).run();
}

// Per device: the attributes set so far on adjoint_cluster_kernel<MB, SEG>
// (BF16: on adjoint_bf16_kernel<MB, SEG>).
template <int MB, bool SEG, bool BF16 = false>
LaunchState (&launch_state())[16] {
  static LaunchState state[16];
  return state;
}

// How many clusters of C CTAs can be resident at once on the current card
// with this geometry (cudaOccupancyMaxActiveClusters); a negative CUDA error
// code on failure.
template <int MB, bool SEG>
int max_clusters(int n, int m, int C, int kc, int smem_bytes) {
  return cluster::max_clusters<MB>(
      (const void*)adjoint_cluster_kernel<MB, SEG>, launch_state<MB, SEG>(),
      n, m, C, kc, smem_bytes);
}

// One launch of B members (B % MB == 0) on the caller's geometry, checked
// against the kernel's own.
template <int MB, bool SEG>
int launch(AdjArgs a, int B, const float* consts, int nconst, int C, int kc,
           int smem_bytes, void* stream) {
  if (!set_consts(a, consts, nconst) || B <= 0 || B % MB || a.M <= 0)
    return (int)cudaErrorInvalidValue;
  BGeom g;
  int err = check_geometry<MB>(a.n, a.m, C, kc, smem_bytes, g);
  if (err) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  err = configure((const void*)adjoint_cluster_kernel<MB, SEG>,
                  launch_state<MB, SEG>(), cfg, attr, B / MB, C, smem_bytes,
                  (cudaStream_t)stream);
  if (err) return err;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, adjoint_cluster_kernel<MB, SEG>, a, g);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// max_clusters of adjoint_bf16_kernel<MB, SEG>, whose smem_bytes are its
// geometry's at three passes or at one.
template <int MB, bool SEG>
int max_clusters16(int n, int m, int C, int kc, int smem_bytes) {
  BGeom g;
  int jl, jr;
  int err = check_geometry16<MB>(n, m, C, kc, smem_bytes, 3, g, jl, jr);
  if (err) err = check_geometry16<MB>(n, m, C, kc, smem_bytes, 1, g, jl, jr);
  return err ? -err
             : occupancy((const void*)adjoint_bf16_kernel<MB, SEG>,
                         launch_state<MB, SEG, true>(), C, smem_bytes);
}

// launch on adjoint_bf16_kernel<MB, SEG>: a.ops16 and a.passes set by the
// caller; the geometry checked against product16's staging at a.passes.
template <int MB, bool SEG>
int launch16(AdjArgs16 a, int B, const float* consts, int nconst, int C,
             int kc, int smem_bytes, void* stream) {
  if (!set_consts(a, consts, nconst) || B <= 0 || B % MB || a.M <= 0 ||
      !a.ops16.vx)
    return (int)cudaErrorInvalidValue;
  BGeom g;
  int err = check_geometry16<MB>(a.n, a.m, C, kc, smem_bytes, a.passes, g,
                                 a.jt_left, a.jt_right);
  if (err) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  err = configure((const void*)adjoint_bf16_kernel<MB, SEG>,
                  launch_state<MB, SEG, true>(), cfg, attr, B / MB, C,
                  smem_bytes, (cudaStream_t)stream);
  if (err) return err;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, adjoint_bf16_kernel<MB, SEG>, a, g);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace sweep
}  // namespace vch

// Compiled once per instantiation, in parallel (ops/_build.py): the object
// of -DVCH_BB=MB (1: the whole one-member sweep; -DVCH_SEG=1: the segment
// sweep) holds
// adjoint_cluster_kernel<MB, SEG> and its launch and occupancy functions,
// with -DVCH_PREC=1 adjoint_bf16_kernel<MB, SEG> and its own instead; the
// -DVCH_BB=8 float32 object also holds the C entries, which dispatch to the
// others by member count and passes.
#ifndef VCH_BB
#define VCH_BB 8
#endif
#ifndef VCH_SEG
#define VCH_SEG 0
#endif
#ifndef VCH_PREC
#define VCH_PREC 0
#endif

namespace vch {
namespace sweep {
#if VCH_PREC
template int launch16<VCH_BB, (VCH_SEG != 0)>(AdjArgs16, int, const float*,
                                              int, int, int, int, void*);
template int max_clusters16<VCH_BB, (VCH_SEG != 0)>(int, int, int, int,
                                                    int);
#else
template int launch<VCH_BB, (VCH_SEG != 0)>(AdjArgs, int, const float*, int,
                                            int, int, int, void*);
template int max_clusters<VCH_BB, (VCH_SEG != 0)>(int, int, int, int, int);
#endif
}  // namespace sweep
}  // namespace vch

#if VCH_BB == 8 && !VCH_SEG && !VCH_PREC
namespace vch {
namespace sweep {
#define VCH_EXTERN(MB, SEG)                                                  \
  extern template int launch<MB, SEG>(AdjArgs, int, const float*, int, int,  \
                                      int, int, void*);                      \
  extern template int max_clusters<MB, SEG>(int, int, int, int, int);
#define VCH_EXTERN16(MB, SEG)                                                \
  extern template int launch16<MB, SEG>(AdjArgs16, int, const float*, int,   \
                                        int, int, int, void*);               \
  extern template int max_clusters16<MB, SEG>(int, int, int, int, int);
VCH_EXTERN(4, false)
VCH_EXTERN(2, false)
VCH_EXTERN(1, false)
VCH_EXTERN(1, true)
VCH_EXTERN16(8, false)
VCH_EXTERN16(4, false)
VCH_EXTERN16(2, false)
VCH_EXTERN16(1, false)
VCH_EXTERN16(1, true)
#undef VCH_EXTERN
#undef VCH_EXTERN16

// a with product16's fragment copies of At's operators (cluster.cuh
// ops16_of) at `passes`
AdjArgs16 with_ops16(const AdjArgs& a, const void* ops16, int passes) {
  AdjArgs16 a16;
  static_cast<AdjArgs&>(a16) = a;
  a16.ops16 = ops16_of(ops16, a.n, a.m);
  a16.passes = passes;
  a16.jt_left = a16.jt_right = 0;
  return a16;
}

// The sweep of B members, `members` per cluster, on the float32 kernel
// (passes 0) or on the bf16 one (passes 3 or 1, At's operators from ops16).
int launch_whole(int members, const AdjArgs& a, int B, const float* consts,
                 int nconst, int C, int kc, int smem_bytes, const void* ops16,
                 int passes, void* stream) {
  if (passes) {
    const AdjArgs16 a16 = with_ops16(a, ops16, passes);
    switch (members) {
      case 8: return launch16<8, false>(a16, B, consts, nconst, C, kc,
                                        smem_bytes, stream);
      case 4: return launch16<4, false>(a16, B, consts, nconst, C, kc,
                                        smem_bytes, stream);
      case 2: return launch16<2, false>(a16, B, consts, nconst, C, kc,
                                        smem_bytes, stream);
      case 1: return launch16<1, false>(a16, B, consts, nconst, C, kc,
                                        smem_bytes, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (members) {
    case 8: return launch<8, false>(a, B, consts, nconst, C, kc, smem_bytes,
                                    stream);
    case 4: return launch<4, false>(a, B, consts, nconst, C, kc, smem_bytes,
                                    stream);
    case 2: return launch<2, false>(a, B, consts, nconst, C, kc, smem_bytes,
                                    stream);
    case 1: return launch<1, false>(a, B, consts, nconst, C, kc, smem_bytes,
                                    stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
}  // namespace sweep
}  // namespace vch

// How many clusters of `cluster` CTAs of the sweep with `members` members
// per cluster (8, 4, 2: the blocked sweep; 1: the whole one-member sweep,
// with segment != 0 the segment sweep) can be resident at once on the current card with this geometry; a
// negative CUDA error code on failure.
extern "C" int vch_adjoint_cluster_max_clusters(int members, int segment,
                                                int n, int m, int cluster,
                                                int kc, int smem_bytes) {
  using namespace vch::sweep;
  if (segment)
    return members == 1 ? max_clusters<1, true>(n, m, cluster, kc, smem_bytes)
                        : -(int)cudaErrorInvalidValue;
  switch (members) {
    case 8: return max_clusters<8, false>(n, m, cluster, kc, smem_bytes);
    case 4: return max_clusters<4, false>(n, m, cluster, kc, smem_bytes);
    case 2: return max_clusters<2, false>(n, m, cluster, kc, smem_bytes);
    case 1: return max_clusters<1, false>(n, m, cluster, kc, smem_bytes);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// The same for the bf16 sweep, whose shared memory is the larger of the
// ring and product16's staging (at three passes or at one).
extern "C" int vch_adjoint16_max_clusters(int members, int segment, int n,
                                          int m, int cluster, int kc,
                                          int smem_bytes) {
  using namespace vch::sweep;
  if (segment)
    return members == 1 ? max_clusters16<1, true>(n, m, cluster, kc,
                                                  smem_bytes)
                        : -(int)cudaErrorInvalidValue;
  switch (members) {
    case 8: return max_clusters16<8, false>(n, m, cluster, kc, smem_bytes);
    case 4: return max_clusters16<4, false>(n, m, cluster, kc, smem_bytes);
    case 2: return max_clusters16<2, false>(n, m, cluster, kc, smem_bytes);
    case 1: return max_clusters16<1, false>(n, m, cluster, kc, smem_bytes);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// The member-blocked sweep of B members (B % members == 0, members 8, 4 or
// 2) on clusters of `cluster` CTAs, with ring stages of kc rows and
// smem_bytes of dynamic shared memory per CTA: the geometry of
// ops/march.py blocked_geometry, checked here against the kernel's own.
// passes 0: At in full float32; 3 ("bf16x3"; 1: the tests' one-pass
// control, AdjArgs16): on bf16 mma.sync from ops16, product16's fragment
// copies of its operators (cluster.cuh ops16_of).
// Arguments otherwise as vch_adjoint_fused_2d (adjoint2d.cu); r is
// (B, M+1, n, m) with r_T = 0 last, work (B, 20, n, m).
extern "C" int vch_adjoint_fused_2d_blocked(
    const float* dts, const float* hist, const float* phiQ, const float* phiT,
    const float* b1, const float* b2, const float* Lx, const float* LyT,
    const float* Vxi, const float* VyiT, const float* Vx, const float* VyT,
    const float* lam, float* r, float* work, int B, int M, int n, int m,
    const float* consts, int nconst, int n_trips, int members, int cluster,
    int kc, int smem_bytes, const void* ops16, int passes, void* stream) {
  using namespace vch::sweep;
  if (members == 1) return (int)cudaErrorInvalidValue;
  const vch::AdjArgs a{dts, hist, phiQ, phiT, b1, b2, Lx, LyT, Vxi, VyiT,
                       Vx, VyT, lam, nullptr, nullptr, nullptr, r, nullptr,
                       nullptr, nullptr, work, M, n, m, n_trips, {}};
  return launch_whole(members, a, B, consts, nconst, cluster, kc, smem_bytes,
                      ops16, passes, stream);
}

// The whole sweep of B members, one member per cluster of `cluster` CTAs:
// what vch_adjoint_fused_2d (adjoint2d.cu) computes, bit for bit (passes
// 0); the geometry, ops16 and passes as vch_adjoint_fused_2d_blocked's,
// checked against the kernel's own, arguments otherwise as
// vch_adjoint_fused_2d's.
extern "C" int vch_adjoint_fused_2d_cluster(
    const float* dts, const float* hist, const float* phiQ, const float* phiT,
    const float* b1, const float* b2, const float* Lx, const float* LyT,
    const float* Vxi, const float* VyiT, const float* Vx, const float* VyT,
    const float* lam, float* r, float* work, int B, int M, int n, int m,
    const float* consts, int nconst, int n_trips, int cluster, int kc,
    int smem_bytes, const void* ops16, int passes, void* stream) {
  using namespace vch::sweep;
  const vch::AdjArgs a{dts, hist, phiQ, phiT, b1, b2, Lx, LyT, Vxi, VyiT,
                       Vx, VyT, lam, nullptr, nullptr, nullptr, r, nullptr,
                       nullptr, nullptr, work, M, n, m, n_trips, {}};
  return launch_whole(1, a, B, consts, nconst, cluster, kc, smem_bytes,
                      ops16, passes, stream);
}

// One K-step segment of B members, one member per cluster of `cluster`
// CTAs: what vch_adjoint_fused_2d_segment (adjoint2d.cu) computes, bit for
// bit (passes 0); the geometry, ops16 and passes as
// vch_adjoint_fused_2d_cluster's, arguments otherwise as
// vch_adjoint_fused_2d_segment's.
extern "C" int vch_adjoint_fused_2d_segment_cluster(
    const float* dts, const float* hist, const float* phiQ, const float* p0,
    const float* q0, const float* r0, const float* b1, const float* Lx,
    const float* LyT, const float* Vxi, const float* VyiT, const float* Vx,
    const float* VyT, const float* lam, float* r, float* p_f, float* q_f,
    float* r_f, float* work, int B, int K, int n, int m, const float* consts,
    int nconst, int n_trips, int cluster, int kc, int smem_bytes,
    const void* ops16, int passes, void* stream) {
  using namespace vch::sweep;
  const vch::AdjArgs a{dts, hist, phiQ, nullptr, b1, nullptr, Lx, LyT, Vxi,
                       VyiT, Vx, VyT, lam, p0, q0, r0, r, p_f, q_f, r_f,
                       work, K, n, m, n_trips, {}};
  if (passes)
    return launch16<1, true>(with_ops16(a, ops16, passes), B, consts, nconst,
                             cluster, kc, smem_bytes, stream);
  return launch<1, true>(a, B, consts, nconst, cluster, kc, smem_bytes,
                         stream);
}
#endif  // VCH_BB == 8 && !VCH_SEG && !VCH_PREC
