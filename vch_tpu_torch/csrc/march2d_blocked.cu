// The 2D forward march on thread-block clusters: a block of MB members per
// cluster, MB = 8, 4 or 2 for the member-blocked march, MB = 1 for the
// whole one-member march and for a K-step segment.
//
// Replaces three TPU kernels of vch_tpu/ops/pallas_march.py:
//   - :393 march_fused_2d: one member per program; here
//     march_blocked_kernel<1, false>, one member per cluster;
//   - :1649 march_fused_2d_blocked (factory :1271): block_b members per
//     program in masked lockstep; here march_blocked_kernel<block_b, false>
//     for block_b = 8, 4 or 2;
//   - :479 march_fused_2d_segment (the factory's segment=True): one member
//     per program with the (mu, w, global m0) carry in, (phi, mu, w) out and
//     only the post-step states in the history; here
//     march_blocked_kernel<1, true>, one member per cluster.
// Each computes, member for member and bit for bit, what the one-member
// march of march2d.cu computes (its segment flag included): the w CN update
// and mu_init, each member's own Newton loop (dense-stencil CN residual,
// fixed-trip BiCGStab on the Schur system in the cosine basis with best
// iterate and noise-floor freeze, step ceiling, Armijo with at most 12
// halvings, best-trial fallback), then clip, interior mass correction and
// the first-bad-step sanitizer; the same history, Newton counts and
// first_bad.
//
// What bounds it on an H100: per Newton iteration about 40 dependent dense
// (n x n)(n x m) products per member, in a sequential chain broken by
// reductions whose results every later step needs. The MB members of a
// block share each operator slab, so a block's products are MB times as
// wide as one member's; the work is the chain's length times that width.
// With one member (the segment march at 257 x 257, B = 2 .. 32; the whole
// march of one scenario at 65 x 65) a cluster of up to 16 SMs shortens
// each link of the chain instead.
//
// Design: cluster.cuh's engine. Block k of MB members runs on a cluster of
// C CTAs (C from the number of blocks and the card's SMs, ops/march.py
// blocked_geometry), CTA r owning a band of rows of all MB members'
// fields; member state lives in the global workspace (B, 33, n, m) as in
// march2d.cu; a Laplacian's first product goes through the T2 field, free
// at every Laplacian. Products, reductions and elementwise passes follow
// the one-member march's order exactly, as cluster.cuh sets out, so a
// member's bits depend neither on the cluster size nor on the batch. Full
// float32 FMA: no tensor cores, no TF32.
//
// The bf16 forms, march_bf16_kernel<MB, SEG> (one object each, -DVCH_PREC=1):
// the same march with the Krylov operator apply_S's four products on bf16
// mma.sync, vch_tpu's fused_solve_precision (pallas_march.py:207-214): at
// "bf16x3" (its default) three single passes on the (hi, lo) split summed
// d0 + (d1 + d2) (pallas_march.py:47-75), at "default" the one pass hi hi
// (cluster.cuh product16). Every other product (the right-hand side's
// transform and Laplacian, from_s, the residuals, the Armijo trials) stays
// full float32, as in vch_tpu. Each product sums its k tiles in ascending
// order from zero whatever the tiling, so these forms too give a member the
// same bits at every cluster size and block. The float32 kernels above are
// left as they were: the bf16 path is its own kernel and Args16, and the
// float32 objects keep their SASS.
//
// The fwd_mm forms, march_fwd16_kernel<MB, SEG> (one object each,
// -DVCH_PREC=2): vch_tpu's march at fwd_mm "bf16x3" (pallas_march.py:132,
// :1318), whose `mm` computes every product of the march: besides apply_S
// (at its own passes: 3, or 1 at fused_solve_precision "default"), the
// Laplacians (mu0, lap_mu_old, lap_phi_old, both of every residual, Kpp
// dphi: Lx V and V LyT each rounded, then added, as Base::lap), the
// right-hand side's transform to_s and dphi's transform back from_s, all on
// product16 at the launch's fwd passes: three (one only in a test's
// control, which vch_tpu has no mode for). Its staging is sized for the
// larger of the two pass counts (check_geometry16 at 3 wherever either is
// 3). A compile-time flag, not a run-time branch: the bf16 and float32
// forms keep their SASS.
#include <type_traits>

#include "cluster.cuh"

namespace vch {
namespace blocked {

using namespace cluster;

struct FwdConst {
  float tau, c1, two_c1, two_c2, neg_kappa, half_kappa, gamma;
  float log_lo, log_hi, lo, hi, dsep2, interior_thr, area;
  float newton_tol, newton_rtol, floor_fac;
};
constexpr int FWD_NCONST = sizeof(FwdConst) / sizeof(float);

// workspace field slots, as march2d.cu's
enum {
  F_PHI_OLD, F_MU_OLD, F_W_OLD, F_W_NEW, F_LMU_OLD, F_LPHI_OLD,
  F_QUAD,                         // 3 sets of (phi, mu, Rphi, Rmu)
  F_DPHI = F_QUAD + 12, F_DMU, F_D,
  F_X, F_R, F_P, F_V, F_R0, F_BX, F_S, F_T, F_PH, F_SH,
  F_T1, F_T2,
  F_COUNT
};
static_assert(F_COUNT == FWD_FIELDS, "FWD_FIELDS out of date");
enum { Q_CUR, Q_TRIAL, Q_BEST };

__device__ __forceinline__ float flog(float phi, const FwdConst& c) {
  const float ph = nan_clamp(phi, c.log_lo, c.log_hi);
  return logf((1.f + ph) / (1.f - ph));
}


// Per-member control state, the same in every CTA of a cluster.
template <int MB>
struct Ctl {
  float red[2][MB][NWARP];        // warp values of a reduction
  float m0[MB], pmass[MB], pint[MB];
  int nsolve[MB], bad[MB];
  float norm_R[MB], norm0[MB], prev[MB], norm_t[MB];
  int done[MB], act[MB];
  float alpha[MB], best_norm[MB], acc_norm[MB];
  int searching[MB], accepted[MB], to_best[MB], to_cur[MB], fallback[MB];
  float dbar[MB], floor2[MB], r2[MB];
  float rho[MB], kalpha[MB], omega[MB], best_r2[MB];
  float rho_new[MB], beta[MB], alpha_n[MB], omega_n[MB];
  int live[MB], improved[MB];
};
static_assert(sizeof(Ctl<8>) <= CTL_BYTES, "Ctl outgrew its reserve");

struct Args {
  const float *dts, *phi0, *u;
  const float *Lx, *LyT, *Vxi, *VyiT, *Vx, *VyT, *lam, *wts;
  const float *mu0, *w0, *m0;     // segment carry in (SEG)
  float *hist, *phi_f, *mu_f, *w_f;   // phi_f, mu_f, w_f: SEG only
  int *nsolve, *bad;
  float* work;
  int M, n, m, max_iter, n_trips, stagnation;
  FwdConst c;
  BGeom g;
  // one flag a member, or null (every member active): the one-member whole
  // march (MB == 1, !SEG) skips a member whose flag is 0
  const int* active;
};

// The bf16 march's arguments: apply_S's four operators as product16's
// fragment copies (Vx, Vx_inv; Vy, Vy_inv: the transposes of VyT, VyiT),
// the passes (3: "bf16x3", 1: "default") and product16's slab widths.
struct Args16 : Args {
  const uint4 *vx, *vxi, *vy, *vyi;
  int passes, jt_left, jt_right;
};

// The fwd_mm march's arguments: besides Args16's, product16's fragment
// copies of Lx (the LEFT product's) and of Ly = LyT^T (the RIGHT
// product's), and the passes of every product but apply_S's (3; 1 only as
// a test's control).
struct ArgsF16 : Args16 {
  const uint4 *lx, *ly;
  int fwd;
};

template <bool BF16, bool FWD16 = false>
using ArgsOf = std::conditional_t<
    FWD16, ArgsF16, std::conditional_t<BF16, Args16, Args>>;


// One CTA's view of its block of MB members; SEG: a segment with the
// carry in and out, the history its K post-step states; BF16: apply_S's
// four products on product16 (the rest as without); FWD16 (with BF16): the
// Laplacians, to_s and from_s too, at the fwd passes. Every method is
// force-inlined into the kernel, so the state below lives in registers; the
// per-member scalars live in `ctl`, in shared memory.
template <int MB, bool SEG, bool BF16 = false, bool FWD16 = false>
struct March : Block<MB> {
  static_assert(BF16 || !FWD16, "the fwd_mm form is a bf16 form");
  using Base = Block<MB>;
  using Base::tid;
  using Base::nm;
  using Base::rank;
  using Base::b0;
  using Base::FS;
  using Base::all;
  using Base::cluster;
  using Base::F;
  using Base::each_elem;
  using Base::gemm_l_to;
  using Base::gemm_r;
  using Base::gemm_r_to;
  const ArgsOf<BF16, FWD16>& a;
  const FwdConst& c;
  Ctl<MB>& ctl;
  size_t HS, US;

  __device__ __forceinline__ March(const ArgsOf<BF16, FWD16>& args,
                                   Ctl<MB>& ctl_,
                                   float* smem)
      : Base(args.g, args.n, args.m, F_COUNT, args.work, smem, ctl_.red),
        a(args), c(args.c), ctl(ctl_) {
    HS = (size_t)(SEG ? a.M : a.M + 1) * nm;    // member stride of hist
    US = SEG ? (size_t)(a.M + 1) * nm : HS;     // and of u
  }

  __device__ __forceinline__ float* Q(int q, int f) const {
    return F(F_QUAD + 4 * q + f);           // f: 0 phi, 1 mu, 2 Rphi, 3 Rmu
  }

  // the Laplacian through the T2 field, free at every Laplacian; FWD16:
  // both products on product16 at the fwd passes, Base::lap's T + x
  template <class Ld, class St>
  __device__ __forceinline__ void lap(const float* V, Ld ld, St st) {
    if constexpr (FWD16) {
      float* T = F(F_T2);
      const size_t fs = FS;
      this->gemm16_l_to(a.lx, V, T, a.fwd, a.jt_left);
      this->gemm16_r(V, a.ly, a.fwd, a.jt_right, [&](int b, int e) {
        return WithT<decltype(ld(b, e))>{T[b * fs + e], ld(b, e)};
      }, [&](int b, int e, float x, const auto& in) {
        st(b, e, in.t + x, in.in);
      });
    } else {
      Base::lap(a.Lx, a.LyT, V, F(F_T2), ld, st);
    }
  }

  // copy buffer set `from` into set `to` for the members flagged in which
  __device__ __forceinline__ void take(int from, int to,
                                       const int (&which)[MB]) {
    if (!any_member<MB>(which)) return;
    const float *s0 = Q(from, 0), *s1 = Q(from, 1), *s2 = Q(from, 2),
                *s3 = Q(from, 3);
    float *d0 = Q(to, 0), *d1 = Q(to, 1), *d2 = Q(to, 2), *d3 = Q(to, 3);
    const size_t fs = FS;
    each_elem([&](int b) { return which[b] != 0; },
              [&](int b, int e) {
                const size_t o = b * fs + e;
                return Vals<4>{{s0[o], s1[o], s2[o], s3[o]}};
              },
              [&](int b, int e, const Vals<4>& in) {
                const size_t o = b * fs + e;
                d0[o] = in.v[0];
                d1[o] = in.v[1];
                d2[o] = in.v[2];
                d3[o] = in.v[3];
              });
    __syncthreads();
  }

  // CN residuals of buffer set q against the step's frozen old level; the
  // per-member norms land in norm
  __device__ __forceinline__ void resid(int q, float* norm, float inv_dt,
                                        float tau_dt) {
    const float *phi = Q(q, 0), *mu = Q(q, 1);
    float *rp = Q(q, 2), *rm = Q(q, 3);
    const float *phi_old = F(F_PHI_OLD), *mu_old = F(F_MU_OLD);
    const float *w_old = F(F_W_OLD), *w_new = F(F_W_NEW);
    const float *lmu_old = F(F_LMU_OLD), *lphi_old = F(F_LPHI_OLD);
    const size_t fs = FS;
    const FwdConst& k = c;
    lap(mu, [&](int b, int e) {
      const size_t i = b * fs + e;
      return Vals<3>{{phi[i], phi_old[i], lmu_old[i]}};
    }, [&](int b, int e, float l, const Vals<3>& in) {
      rm[b * fs + e] = (in.v[0] - in.v[1]) * inv_dt - 0.5f * (l + in.v[2]);
    });
    lap(phi, [&](int b, int e) {
      const size_t i = b * fs + e;
      return Vals<7>{{phi[i], phi_old[i], lphi_old[i], mu[i], mu_old[i],
                      w_new[i], w_old[i]}};
    }, [&](int b, int e, float l, const Vals<7>& in) {
      const float ph = in.v[0], po = in.v[1];
      rp[b * fs + e] = tau_dt * (ph - po) - k.half_kappa * (l + in.v[2]) +
                       k.c1 * flog(ph, k) + (-k.two_c2 * po) -
                       0.5f * (in.v[3] + in.v[4]) - 0.5f * (in.v[5] + in.v[6]);
    });
    this->template reduce<2, false>(0.f, all, [&](int b, int e) {
      return Vals<2>{{rp[b * fs + e], rm[b * fs + e]}};
    }, [](int, int, const Vals<2>& in, float (&p)[2]) {
      p[0] += in.v[0] * in.v[0];
      p[1] += in.v[1] * in.v[1];
    }, [&](int b, const float (&v)[2]) { norm[b] = sqrtf(v[0] + v[1]); });
  }

  // The Schur solve in the cosine basis -> (dphi, dmu) of the current set
  __device__ __forceinline__ void schur_solve(float inv_dt, float tau_dt) {
    float *X = F(F_X), *Rr = F(F_R), *P = F(F_P), *V = F(F_V);
    float *R0 = F(F_R0), *BX = F(F_BX), *Sv = F(F_S), *T = F(F_T);
    float *PH = F(F_PH), *SH = F(F_SH), *T1 = F(F_T1), *T2 = F(F_T2);
    float *dfield = F(F_D), *dphi = F(F_DPHI), *dmu = F(F_DMU);
    const float *phi = Q(Q_CUR, 0), *rp = Q(Q_CUR, 2), *rm = Q(Q_CUR, 3);
    const float* lam = a.lam;
    const size_t fs = FS;
    const FwdConst& k = c;
    auto poly = [&](float l) {
      return (inv_dt - tau_dt * l) + (k.half_kappa * l) * l;
    };
    this->template reduce<1, false>(0.f, all, [&](int b, int e) {
      return Vals<1>{{phi[b * fs + e]}};
    }, [&](int b, int e, const Vals<1>& in, float (&p)[1]) {
      const float ph = in.v[0];
      const float d = k.two_c1 / (1.f - nan_clamp(ph * ph, 0.f, k.dsep2));
      dfield[b * fs + e] = d;
      p[0] += d;
    }, [&](int b, const float (&v)[1]) { ctl.dbar[b] = v[0] / (float)nm; });
    auto prec = [&](int b, float l, float v) {
      return v / (poly(l) - ctl.dbar[b] * l);
    };
    auto apply_S = [&](const float* Y, float* OUT) {
      if constexpr (BF16) {
        this->gemm16_l_to(a.vx, Y, T1, a.passes, a.jt_left);
        this->gemm16_r(T1, a.vy, a.passes, a.jt_right, [&](int b, int e) {
          return Vals<1>{{dfield[b * fs + e]}};
        }, [&](int b, int e, float v, const Vals<1>& in) {
          T2[b * fs + e] = in.v[0] * v;
        });
        this->gemm16_l_to(a.vxi, T2, T1, a.passes, a.jt_left);
        this->gemm16_r(T1, a.vyi, a.passes, a.jt_right, [&](int b, int e) {
          return Vals<2>{{lam[e], Y[b * fs + e]}};
        }, [&](int b, int e, float v, const Vals<2>& in) {
          const float l = in.v[0];
          OUT[b * fs + e] = poly(l) * in.v[1] - l * v;
        });
      } else {
        gemm_l_to(a.Vx, Y, T1);
        gemm_r(T1, a.VyT, [&](int b, int e) {
          return Vals<1>{{dfield[b * fs + e]}};
        }, [&](int b, int e, float v, const Vals<1>& in) {
          T2[b * fs + e] = in.v[0] * v;
        });
        gemm_l_to(a.Vxi, T2, T1);
        gemm_r(T1, a.VyiT, [&](int b, int e) {
          return Vals<2>{{lam[e], Y[b * fs + e]}};
        }, [&](int b, int e, float v, const Vals<2>& in) {
          const float l = in.v[0];
          OUT[b * fs + e] = poly(l) * in.v[1] - l * v;
        });
      }
    };
    // b = to_s(L Rphi - Rmu); x0 = 0
    lap(rp, [&](int b, int e) { return Vals<1>{{rm[b * fs + e]}}; },
        [&](int b, int e, float l, const Vals<1>& in) {
          T1[b * fs + e] = l - in.v[0];
        });
    if constexpr (FWD16) {
      this->gemm16_l_to(a.vxi, T1, T2, a.fwd, a.jt_left);
      this->gemm16_r(T2, a.vyi, a.fwd, a.jt_right,
                     [](int, int) { return None{}; },
                     [&](int b, int e, float v, None) {
                       const size_t i = b * fs + e;
                       R0[i] = v;
                       Rr[i] = v;
                       X[i] = 0.f;
                       BX[i] = 0.f;
                       P[i] = 0.f;
                       V[i] = 0.f;
                     });
    } else {
      gemm_l_to(a.Vxi, T1, T2);
      gemm_r(T2, a.VyiT, [](int, int) { return None{}; },
             [&](int b, int e, float v, None) {
               const size_t i = b * fs + e;
               R0[i] = v;
               Rr[i] = v;
               X[i] = 0.f;
               BX[i] = 0.f;
               P[i] = 0.f;
               V[i] = 0.f;
             });
    }
    this->template reduce<1, false>(0.f, all, [&](int b, int e) {
      return Vals<1>{{R0[b * fs + e]}};
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
      if (tid < MB)
        ctl.live[tid] = ctl.live[tid] && ctl.r2[tid] > ctl.floor2[tid];
      __syncthreads();
      if (!any_member<MB>(ctl.live)) break;
      this->template reduce<1, false>(0.f, all, [&](int b, int e) {
        return Vals<2>{{R0[b * fs + e], Rr[b * fs + e]}};
      }, [](int, int, const Vals<2>& in, float (&p)[1]) {
        p[0] += in.v[0] * in.v[1];
      }, [&](int b, const float (&v)[1]) {
        ctl.rho_new[b] = v[0];
        ctl.beta[b] = (v[0] / (ctl.rho[b] + EPS_DIV)) *
                      (ctl.kalpha[b] / (ctl.omega[b] + EPS_DIV));
      });
      each_elem(live, [&](int b, int e) {
        const size_t o = b * fs + e;
        return Vals<4>{{Rr[o], P[o], V[o], lam[e]}};
      }, [&](int b, int e, const Vals<4>& in) {
        const size_t o = b * fs + e;
        const float p =
            in.v[0] + ctl.beta[b] * (in.v[1] - ctl.omega[b] * in.v[2]);
        P[o] = p;
        PH[o] = prec(b, in.v[3], p);
      });
      apply_S(PH, V);
      this->template reduce<1, false>(0.f, all, [&](int b, int e) {
        return Vals<2>{{R0[b * fs + e], V[b * fs + e]}};
      }, [](int, int, const Vals<2>& in, float (&p)[1]) {
        p[0] += in.v[0] * in.v[1];
      }, [&](int b, const float (&v)[1]) {
        ctl.alpha_n[b] = ctl.rho_new[b] / (v[0] + EPS_DIV);
      });
      each_elem(live, [&](int b, int e) {
        const size_t o = b * fs + e;
        return Vals<3>{{Rr[o], V[o], lam[e]}};
      }, [&](int b, int e, const Vals<3>& in) {
        const size_t o = b * fs + e;
        const float sv = in.v[0] - ctl.alpha_n[b] * in.v[1];
        Sv[o] = sv;
        SH[o] = prec(b, in.v[2], sv);
      });
      apply_S(SH, T);
      this->template reduce<2, false>(0.f, all, [&](int b, int e) {
        return Vals<2>{{T[b * fs + e], Sv[b * fs + e]}};
      }, [](int, int, const Vals<2>& in, float (&p)[2]) {
        const float t = in.v[0];
        p[0] += t * in.v[1];
        p[1] += t * t;
      }, [&](int b, const float (&v)[2]) {
        ctl.omega_n[b] = v[0] / (v[1] + EPS_DIV);
      });
      this->template reduce<1, false>(0.f, live, [&](int b, int e) {
        const size_t o = b * fs + e;
        return Vals<5>{{X[o], PH[o], SH[o], Sv[o], T[o]}};
      }, [&](int b, int e, const Vals<5>& in, float (&p)[1]) {
        const size_t o = b * fs + e;
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
      if (any_member<MB>(ctl.improved))
        each_elem([&](int b) { return ctl.improved[b] != 0; },
                  [&](int b, int e) { return Vals<1>{{X[b * fs + e]}}; },
                  [&](int b, int e, const Vals<1>& in) {
                    BX[b * fs + e] = in.v[0];
                  });
    }
    // dphi = from_s(best x); dmu = 2 (Kpp dphi + Rphi)
    if constexpr (FWD16) {
      this->gemm16_l_to(a.vx, BX, T1, a.fwd, a.jt_left);
      this->gemm16_r(T1, a.vy, a.fwd, a.jt_right,
                     [](int, int) { return None{}; },
                     [&](int b, int e, float v, None) {
                       dphi[b * fs + e] = v;
                     });
    } else {
      gemm_l_to(a.Vx, BX, T1);
      gemm_r_to(T1, a.VyT, dphi);
    }
    lap(dphi, [&](int b, int e) {
      const size_t i = b * fs + e;
      return Vals<3>{{dfield[i], dphi[i], rp[i]}};
    }, [&](int b, int e, float l, const Vals<3>& in) {
      const float kpp = -k.half_kappa * l + (tau_dt + in.v[0]) * in.v[1];
      dmu[b * fs + e] = 2.f * (kpp + in.v[2]);
    });
  }

  __device__ __forceinline__ void run() {
    float *phi_old = F(F_PHI_OLD), *mu_old = F(F_MU_OLD);
    float *w_old = F(F_W_OLD), *w_new = F(F_W_NEW);
    float *lmu_old = F(F_LMU_OLD), *lphi_old = F(F_LPHI_OLD);
    const float *dphi = F(F_DPHI), *dmu = F(F_DMU);
    const float* wts = a.wts;
    float* hist = a.hist + b0 * HS;
    const float* ub = a.u + b0 * US;
    const size_t fs = FS, hs = HS, us = US;
    const FwdConst& k = c;
    constexpr int hoff = SEG ? 0 : 1;       // frame of the state after step 0

    if constexpr (SEG) {
      // ---- initial state: phi0 and the carry (mu0, w0, the global m0) ----
      each_elem(all, [&](int b, int e) {
        const size_t g = (size_t)(b0 + b) * nm + e;
        return Vals<3>{{a.phi0[g], a.mu0[g], a.w0[g]}};
      }, [&](int b, int e, const Vals<3>& in) {
        const size_t o = b * fs + e;
        phi_old[o] = in.v[0];
        mu_old[o] = in.v[1];
        w_old[o] = in.v[2];
      });
      if (tid < MB) {
        ctl.m0[tid] = a.m0[b0 + tid];
        ctl.nsolve[tid] = 0;
        ctl.bad[tid] = -1;
      }
      __syncthreads();
    } else {
      // ---- initial state: w0 = 0, mu0 = -kappa L phi0 + f'(phi0), m0 ----
      this->template reduce<1, false>(0.f, all, [&](int b, int e) {
        return Vals<2>{{a.phi0[(size_t)(b0 + b) * nm + e], wts[e]}};
      }, [&](int b, int e, const Vals<2>& in, float (&p)[1]) {
        const float ph = in.v[0];
        phi_old[b * fs + e] = ph;
        hist[b * hs + e] = ph;
        w_old[b * fs + e] = 0.f;
        p[0] += in.v[1] * ph;
      }, [&](int b, const float (&v)[1]) {
        ctl.m0[b] = v[0];
        ctl.nsolve[b] = 0;
        ctl.bad[b] = -1;
      });
      lap(phi_old,
          [&](int b, int e) { return Vals<1>{{phi_old[b * fs + e]}}; },
          [&](int b, int e, float l, const Vals<1>& in) {
            const float ph = in.v[0];
            mu_old[b * fs + e] =
                k.neg_kappa * l + k.c1 * flog(ph, k) - k.two_c2 * ph;
          });
    }

    for (int step = 0; step < a.M; ++step) {
      const float dt = a.dts[step];
      const float inv_dt = 1.f / dt;
      const float tau_dt = k.tau * inv_dt;
      const float gamma_dt = k.gamma * inv_dt;
      each_elem(all, [&](int b, int e) {
        const float* un = ub + b * us + (size_t)step * nm;
        return Vals<3>{{w_old[b * fs + e], un[e + nm], un[e]}};
      }, [&](int b, int e, const Vals<3>& in) {
        w_new[b * fs + e] =
            ((gamma_dt - 0.5f) * in.v[0] + 0.5f * (in.v[1] + in.v[2])) /
            (gamma_dt + 0.5f);
      });
      lap(mu_old, [](int, int) { return None{}; },
          [&](int b, int e, float l, None) { lmu_old[b * fs + e] = l; });
      {
        float *qphi = Q(Q_CUR, 0), *qmu = Q(Q_CUR, 1);
        lap(phi_old, [&](int b, int e) {
          return Vals<2>{{phi_old[b * fs + e], w_new[b * fs + e]}};
        }, [&](int b, int e, float l, const Vals<2>& in) {
          const size_t i = b * fs + e;
          const float ph = in.v[0];
          lphi_old[i] = l;
          qphi[i] = ph;
          qmu[i] = k.neg_kappa * l + k.c1 * flog(ph, k) - k.two_c2 * ph - in.v[1];
        });
      }

      // ---- Newton in masked lockstep: each member's own trip count ----
      if (tid < MB) {
        ctl.norm_R[tid] = 0.f;
        ctl.norm0[tid] = ctl.prev[tid] = INFINITY;
        ctl.done[tid] = 0;
      }
      __syncthreads();
      for (int it = 0; it < a.max_iter; ++it) {
        if (it == 0) resid(Q_CUR, ctl.norm_R, inv_dt, tau_dt);
        if (tid < MB) {
          const int b = tid;
          if (it == 0) ctl.norm0[b] = ctl.norm_R[b];
          bool conv = ctl.norm_R[b] < k.newton_tol;
          if (k.newton_rtol > 0.f)
            conv = conv || ctl.norm_R[b] < k.newton_rtol * ctl.norm0[b];
          if (a.stagnation && it > 0) conv = conv || ctl.norm_R[b] >= ctl.prev[b];
          ctl.done[b] = ctl.done[b] || conv;
          ctl.act[b] = !ctl.done[b];
        }
        __syncthreads();
        if (!any_member<MB>(ctl.act)) break;
        schur_solve(inv_dt, tau_dt);

        // step ceiling of each member
        {
          const float* phi = Q(Q_CUR, 0);
          this->template reduce<2, true>(INFINITY, all, [&](int b, int e) {
            return Vals<2>{{dphi[b * fs + e], phi[b * fs + e]}};
          }, [&](int, int, const Vals<2>& in, float (&p)[2]) {
            const float dp = in.v[0], ph = in.v[1];
            p[0] = nan_min(p[0], dp > 0.f ? (k.hi - ph) / dp : INFINITY);
            p[1] = nan_min(p[1], dp < 0.f ? (k.lo - ph) / dp : INFINITY);
          }, [&](int b, const float (&v)[2]) {
            float amax = nan_min(2.f, nan_min(0.9f * v[0], 0.9f * v[1]));
            if (!isfinite(amax) || amax <= 0.f) amax = 1.f;
            ctl.alpha[b] = fminf(1.f, amax);
            ctl.best_norm[b] = INFINITY;
            ctl.acc_norm[b] = 0.f;
            ctl.searching[b] = ctl.act[b];
            ctl.accepted[b] = 0;
          });
        }

        // Armijo on the residual norm, in lockstep over the active
        // members; every exit leaves the residual of the returned iterate
        // in the current set for the next Newton iteration
        for (int j = 0; j < 12 && any_member<MB>(ctl.searching); ++j) {
          const float *phi = Q(Q_CUR, 0), *mu = Q(Q_CUR, 1);
          float *tphi = Q(Q_TRIAL, 0), *tmu = Q(Q_TRIAL, 1);
          each_elem([&](int b) { return ctl.searching[b] != 0; },
                    [&](int b, int e) {
                      const size_t o = b * fs + e;
                      return Vals<4>{{phi[o], dphi[o], mu[o], dmu[o]}};
                    },
                    [&](int b, int e, const Vals<4>& in) {
                      const size_t o = b * fs + e;
                      tphi[o] = in.v[0] + ctl.alpha[b] * in.v[1];
                      tmu[o] = in.v[2] + ctl.alpha[b] * in.v[3];
                    });
          resid(Q_TRIAL, ctl.norm_t, inv_dt, tau_dt);
          if (tid < MB) {
            const int b = tid;
            ctl.to_best[b] = ctl.to_cur[b] = 0;
            if (ctl.searching[b]) {
              const float nt = ctl.norm_t[b];
              if (nt < ctl.best_norm[b]) {
                ctl.best_norm[b] = nt;
                ctl.to_best[b] = 1;
              }
              if (nt <= (1.f - 1e-4f * ctl.alpha[b]) * ctl.norm_R[b]) {
                ctl.accepted[b] = ctl.to_cur[b] = 1;
                ctl.searching[b] = 0;
                ctl.acc_norm[b] = nt;
                ctl.to_best[b] = 0;     // taken now; the best set is moot
              } else {
                ctl.alpha[b] = ctl.alpha[b] * 0.5f;
              }
            }
          }
          __syncthreads();
          take(Q_TRIAL, Q_BEST, ctl.to_best);
          take(Q_TRIAL, Q_CUR, ctl.to_cur);
        }
        if (tid < MB) {
          const int b = tid;
          ctl.fallback[b] = 0;
          if (ctl.act[b]) {
            const float norm_prev = ctl.norm_R[b];
            if (ctl.accepted[b]) {
              ctl.norm_R[b] = ctl.acc_norm[b];
            } else if (ctl.best_norm[b] < ctl.norm_R[b]) {
              ctl.fallback[b] = 1;
              ctl.norm_R[b] = ctl.best_norm[b];
            }
            ctl.prev[b] = norm_prev;
            ++ctl.nsolve[b];
          }
        }
        __syncthreads();
        take(Q_BEST, Q_CUR, ctl.fallback);
      }

      // ---- clip + interior mass correction + sanitizer ----
      const float *phn = Q(Q_CUR, 0), *mun = Q(Q_CUR, 1);
      this->template reduce<2, false>(0.f, all, [&](int b, int e) {
        return Vals<2>{{phn[b * fs + e], wts[e]}};
      }, [&](int, int, const Vals<2>& in, float (&p)[2]) {
        const float pc = nan_clamp(in.v[0], k.lo, k.hi);
        p[0] += in.v[1] * pc;
        p[1] += fabsf(pc) < k.interior_thr ? in.v[1] : 0.f;
      }, [&](int b, const float (&v)[2]) {
        ctl.pmass[b] = v[0] - ctl.m0[b];    // the mass error
        ctl.pint[b] = v[1];
        if (!isfinite(ctl.pmass[b]) && ctl.bad[b] < 0) ctl.bad[b] = step;
      });
      each_elem(all, [&](int b, int e) {
        const size_t o = b * fs + e;
        return Vals<3>{{phn[o], mun[o], w_new[o]}};
      }, [&](int b, int e, const Vals<3>& in) {
        const size_t o = b * fs + e;
        const float mass_error = ctl.pmass[b];
        const float Wint = ctl.pint[b];
        const bool needs_fix = fabsf(mass_error) > 1e-16f;
        float pc = nan_clamp(in.v[0], k.lo, k.hi);
        if (needs_fix) {
          if (Wint > 0.f) {
            if (fabsf(pc) < k.interior_thr) pc = pc - mass_error / Wint;
          } else {
            pc = nan_clamp(pc - mass_error / k.area, k.lo, k.hi);
          }
        }
        phi_old[o] = pc;
        hist[b * hs + (size_t)(step + hoff) * nm + e] = pc;
        mu_old[o] = in.v[1];
        w_old[o] = in.v[2];
      });
      __syncthreads();
    }
    if constexpr (SEG) {
      // the carry out: each element is the thread's own last store
      each_elem(all, [&](int b, int e) {
        const size_t o = b * fs + e;
        return Vals<3>{{phi_old[o], mu_old[o], w_old[o]}};
      }, [&](int b, int e, const Vals<3>& in) {
        const size_t g = (size_t)(b0 + b) * nm + e;
        a.phi_f[g] = in.v[0];
        a.mu_f[g] = in.v[1];
        a.w_f[g] = in.v[2];
      });
    }
    if (rank == 0 && tid < MB) {
      a.nsolve[b0 + tid] = ctl.nsolve[tid];
      a.bad[b0 + tid] = ctl.bad[tid];
    }
    cluster.sync();   // no CTA leaves while a peer may still write its Ctl
  }
};

template <int MB, bool SEG>
__global__ void __launch_bounds__(NT, 1) march_blocked_kernel(Args a) {
  extern __shared__ float4 smem4[];
  __shared__ Ctl<MB> ctl;
  if constexpr (MB == 1 && !SEG) {
    // an inactive member: every CTA of its cluster reads the same flag and
    // leaves before the first cluster barrier or DSMEM access; rank 0
    // reports no Newton solve and no bad step, and no hist row is written
    const int b = blockIdx.x / a.g.band.C;
    if (a.active != nullptr && a.active[b] == 0) {
      if (cg::this_cluster().block_rank() == 0 && threadIdx.x == 0) {
        a.nsolve[b] = 0;
        a.bad[b] = -1;
      }
      return;
    }
  }
  March<MB, SEG>(a, ctl, reinterpret_cast<float*>(smem4)).run();
}

// march_blocked_kernel with apply_S's products on bf16 mma.sync
// (fused_solve_precision "bf16x3" or "default"); the same flag rule.
template <int MB, bool SEG>
__global__ void __launch_bounds__(NT, 1) march_bf16_kernel(Args16 a) {
  extern __shared__ float4 smem4[];
  __shared__ Ctl<MB> ctl;
  if constexpr (MB == 1 && !SEG) {
    const int b = blockIdx.x / a.g.band.C;
    if (a.active != nullptr && a.active[b] == 0) {
      if (cg::this_cluster().block_rank() == 0 && threadIdx.x == 0) {
        a.nsolve[b] = 0;
        a.bad[b] = -1;
      }
      return;
    }
  }
  March<MB, SEG, true>(a, ctl, reinterpret_cast<float*>(smem4)).run();
}

// march_bf16_kernel with every product of the march on bf16 mma.sync
// (fwd_mm "bf16x3"); the same flag rule.
template <int MB, bool SEG>
__global__ void __launch_bounds__(NT, 1) march_fwd16_kernel(ArgsF16 a) {
  extern __shared__ float4 smem4[];
  __shared__ Ctl<MB> ctl;
  if constexpr (MB == 1 && !SEG) {
    const int b = blockIdx.x / a.g.band.C;
    if (a.active != nullptr && a.active[b] == 0) {
      if (cg::this_cluster().block_rank() == 0 && threadIdx.x == 0) {
        a.nsolve[b] = 0;
        a.bad[b] = -1;
      }
      return;
    }
  }
  March<MB, SEG, true, true>(a, ctl, reinterpret_cast<float*>(smem4)).run();
}


// Per device: the attributes set so far on march_blocked_kernel<MB, SEG>
// (BF16: on march_bf16_kernel<MB, SEG>; FWD16: on march_fwd16_kernel).
template <int MB, bool SEG, bool BF16 = false, bool FWD16 = false>
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
      (const void*)march_blocked_kernel<MB, SEG>, launch_state<MB, SEG>(), n,
      m, C, kc, smem_bytes);
}

// One launch of B members (B % MB == 0) on the caller's geometry, checked
// against the kernel's own.
template <int MB, bool SEG>
int launch(Args a, int B, const float* consts, int nconst, int cluster,
           int kc, int smem_bytes, void* stream) {
  if (nconst != FWD_NCONST || B <= 0 || B % MB || a.M <= 0)
    return (int)cudaErrorInvalidValue;
  int err = check_geometry<MB>(a.n, a.m, cluster, kc, smem_bytes, a.g);
  if (err) return err;
  float* dst = reinterpret_cast<float*>(&a.c);
  for (int i = 0; i < FWD_NCONST; ++i) dst[i] = consts[i];
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  err = configure((const void*)march_blocked_kernel<MB, SEG>,
                  launch_state<MB, SEG>(), cfg, attr, B / MB, cluster,
                  smem_bytes, (cudaStream_t)stream);
  if (err) return err;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, march_blocked_kernel<MB, SEG>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// max_clusters of march_bf16_kernel<MB, SEG>, whose smem_bytes are its
// geometry's at three passes or at one.
template <int MB, bool SEG>
int max_clusters16(int n, int m, int C, int kc, int smem_bytes) {
  BGeom g;
  int jl, jr;
  int err = check_geometry16<MB>(n, m, C, kc, smem_bytes, 3, g, jl, jr);
  if (err) err = check_geometry16<MB>(n, m, C, kc, smem_bytes, 1, g, jl, jr);
  return err ? -err
             : occupancy((const void*)march_bf16_kernel<MB, SEG>,
                         launch_state<MB, SEG, true>(), C, smem_bytes);
}

// launch on march_bf16_kernel<MB, SEG>: a.passes and the operators set by
// the caller; the geometry checked against product16's staging.
template <int MB, bool SEG>
int launch16(Args16 a, int B, const float* consts, int nconst, int cluster,
             int kc, int smem_bytes, void* stream) {
  if (nconst != FWD_NCONST || B <= 0 || B % MB || a.M <= 0 || !a.vx)
    return (int)cudaErrorInvalidValue;
  int err = check_geometry16<MB>(a.n, a.m, cluster, kc, smem_bytes, a.passes,
                                 a.g, a.jt_left, a.jt_right);
  if (err) return err;
  float* dst = reinterpret_cast<float*>(&a.c);
  for (int i = 0; i < FWD_NCONST; ++i) dst[i] = consts[i];
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  err = configure((const void*)march_bf16_kernel<MB, SEG>,
                  launch_state<MB, SEG, true>(), cfg, attr, B / MB, cluster,
                  smem_bytes, (cudaStream_t)stream);
  if (err) return err;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, march_bf16_kernel<MB, SEG>,
                                           a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// max_clusters of march_fwd16_kernel<MB, SEG>, whose smem_bytes are its
// geometry's at three passes or (the control) at one.
template <int MB, bool SEG>
int max_clusters_fwd16(int n, int m, int C, int kc, int smem_bytes) {
  BGeom g;
  int jl, jr;
  int err = check_geometry16<MB>(n, m, C, kc, smem_bytes, 3, g, jl, jr);
  if (err) err = check_geometry16<MB>(n, m, C, kc, smem_bytes, 1, g, jl, jr);
  return err ? -err
             : occupancy((const void*)march_fwd16_kernel<MB, SEG>,
                         launch_state<MB, SEG, true, true>(), C, smem_bytes);
}

// launch on march_fwd16_kernel<MB, SEG>: a.passes (apply_S's) and a.fwd
// (the other products'), each 3 or 1, and the six operators set by the
// caller; the geometry checked against product16's staging at the larger.
template <int MB, bool SEG>
int launch_fwd16(ArgsF16 a, int B, const float* consts, int nconst,
                 int cluster, int kc, int smem_bytes, void* stream) {
  if (nconst != FWD_NCONST || B <= 0 || B % MB || a.M <= 0 || !a.vx ||
      !a.lx || (a.passes != 1 && a.passes != 3) ||
      (a.fwd != 1 && a.fwd != 3))
    return (int)cudaErrorInvalidValue;
  const int staged = a.passes == 3 || a.fwd == 3 ? 3 : 1;
  int err = check_geometry16<MB>(a.n, a.m, cluster, kc, smem_bytes, staged,
                                 a.g, a.jt_left, a.jt_right);
  if (err) return err;
  float* dst = reinterpret_cast<float*>(&a.c);
  for (int i = 0; i < FWD_NCONST; ++i) dst[i] = consts[i];
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  err = configure((const void*)march_fwd16_kernel<MB, SEG>,
                  launch_state<MB, SEG, true, true>(), cfg, attr, B / MB,
                  cluster, smem_bytes, (cudaStream_t)stream);
  if (err) return err;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, march_fwd16_kernel<MB, SEG>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace blocked
}  // namespace vch

// Compiled once per instantiation, in parallel (ops/_build.py): the object
// of -DVCH_BB=MB (-DVCH_SEG=1: the segment march) holds
// march_blocked_kernel<MB, SEG> and its launch and occupancy functions,
// with -DVCH_PREC=1 march_bf16_kernel<MB, SEG> and its own instead, with
// -DVCH_PREC=2 march_fwd16_kernel<MB, SEG> and its own; the -DVCH_BB=8
// float32 object also holds the C entries, which dispatch to the others by
// member count and passes.
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
namespace blocked {
#if VCH_PREC == 2
template int launch_fwd16<VCH_BB, (VCH_SEG != 0)>(ArgsF16, int, const float*,
                                                  int, int, int, int, void*);
template int max_clusters_fwd16<VCH_BB, (VCH_SEG != 0)>(int, int, int, int,
                                                        int);
#elif VCH_PREC
template int launch16<VCH_BB, (VCH_SEG != 0)>(Args16, int, const float*, int,
                                              int, int, int, void*);
template int max_clusters16<VCH_BB, (VCH_SEG != 0)>(int, int, int, int,
                                                    int);
#else
template int launch<VCH_BB, (VCH_SEG != 0)>(Args, int, const float*, int,
                                            int, int, int, void*);
template int max_clusters<VCH_BB, (VCH_SEG != 0)>(int, int, int, int, int);
#endif
}  // namespace blocked
}  // namespace vch

#if VCH_BB == 8 && !VCH_SEG && !VCH_PREC
namespace vch {
namespace blocked {
#define VCH_EXTERN(MB, SEG)                                                  \
  extern template int launch<MB, SEG>(Args, int, const float*, int, int,     \
                                      int, int, void*);                      \
  extern template int max_clusters<MB, SEG>(int, int, int, int, int);
#define VCH_EXTERN16(MB, SEG)                                                \
  extern template int launch16<MB, SEG>(Args16, int, const float*, int, int, \
                                        int, int, void*);                    \
  extern template int max_clusters16<MB, SEG>(int, int, int, int, int);
VCH_EXTERN(4, false)
VCH_EXTERN(2, false)
VCH_EXTERN(1, false)
VCH_EXTERN(1, true)
#define VCH_EXTERN_FWD16(MB, SEG)                                            \
  extern template int launch_fwd16<MB, SEG>(ArgsF16, int, const float*, int, \
                                            int, int, int, void*);           \
  extern template int max_clusters_fwd16<MB, SEG>(int, int, int, int, int);
VCH_EXTERN16(8, false)
VCH_EXTERN16(4, false)
VCH_EXTERN16(2, false)
VCH_EXTERN16(1, false)
VCH_EXTERN16(1, true)
VCH_EXTERN_FWD16(8, false)
VCH_EXTERN_FWD16(4, false)
VCH_EXTERN_FWD16(2, false)
VCH_EXTERN_FWD16(1, false)
VCH_EXTERN_FWD16(1, true)
#undef VCH_EXTERN
#undef VCH_EXTERN16
#undef VCH_EXTERN_FWD16

// a with product16's fragment copies of apply_S's operators (cluster.cuh
// ops16_of); passes 0: none (the float32 march).
Args16 with_ops16(const Args& a, const void* ops16, int passes) {
  Args16 a16;
  static_cast<Args&>(a16) = a;
  const Ops16 o = ops16_of(ops16, a.n, a.m);
  a16.vx = o.vx;
  a16.vxi = o.vxi;
  a16.vy = o.vy;
  a16.vyi = o.vyi;
  a16.passes = passes;
  a16.jt_left = a16.jt_right = 0;
  return a16;
}

// a with the fwd_mm march's six fragment copies (cluster.cuh
// fwd_ops16_of): apply_S's four at `passes`, Lx's and Ly's, the other
// products at `fwd`.
ArgsF16 with_fwd_ops16(const Args& a, const void* ops16, int passes,
                       int fwd) {
  ArgsF16 f;
  static_cast<Args16&>(f) = with_ops16(a, ops16, passes);
  const FwdOps16 o = fwd_ops16_of(ops16, a.n, a.m);
  f.lx = o.lx;
  f.ly = o.ly;
  f.fwd = fwd;
  return f;
}

// The whole march of B members, `members` per cluster; passes 1 or 3 on
// the bf16 kernel, and with fwd 3 (or 1) on the fwd_mm kernel.
int launch_whole(int members, const Args& a, int B, const float* consts,
                 int nconst, int cluster, int kc, int smem_bytes,
                 const void* ops16, int passes, int fwd, void* stream) {
  if (fwd) {
    const ArgsF16 f = with_fwd_ops16(a, ops16, passes, fwd);
    switch (members) {
      case 8: return launch_fwd16<8, false>(f, B, consts, nconst, cluster,
                                            kc, smem_bytes, stream);
      case 4: return launch_fwd16<4, false>(f, B, consts, nconst, cluster,
                                            kc, smem_bytes, stream);
      case 2: return launch_fwd16<2, false>(f, B, consts, nconst, cluster,
                                            kc, smem_bytes, stream);
      case 1: return launch_fwd16<1, false>(f, B, consts, nconst, cluster,
                                            kc, smem_bytes, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (passes) {
    const Args16 a16 = with_ops16(a, ops16, passes);
    switch (members) {
      case 8: return launch16<8, false>(a16, B, consts, nconst, cluster, kc,
                                        smem_bytes, stream);
      case 4: return launch16<4, false>(a16, B, consts, nconst, cluster, kc,
                                        smem_bytes, stream);
      case 2: return launch16<2, false>(a16, B, consts, nconst, cluster, kc,
                                        smem_bytes, stream);
      case 1: return launch16<1, false>(a16, B, consts, nconst, cluster, kc,
                                        smem_bytes, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (members) {
    case 8: return launch<8, false>(a, B, consts, nconst, cluster, kc,
                                    smem_bytes, stream);
    case 4: return launch<4, false>(a, B, consts, nconst, cluster, kc,
                                    smem_bytes, stream);
    case 2: return launch<2, false>(a, B, consts, nconst, cluster, kc,
                                    smem_bytes, stream);
    case 1: return launch<1, false>(a, B, consts, nconst, cluster, kc,
                                    smem_bytes, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace blocked
}  // namespace vch

// How many clusters of `cluster` CTAs of the march with `members` members
// per cluster (8, 4, 2: the blocked march; 1: the one-member march, or with
// segment != 0 the segment march) can be resident at once on the current
// card with this geometry; a negative CUDA error code on failure.
extern "C" int vch_march_blocked_max_clusters(int members, int segment,
                                              int n, int m, int cluster,
                                              int kc, int smem_bytes) {
  using namespace vch::blocked;
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

// The same for the fwd_mm march, whose staging is at three passes (or at
// one: the control).
extern "C" int vch_march16f_max_clusters(int members, int segment, int n,
                                         int m, int cluster, int kc,
                                         int smem_bytes) {
  using namespace vch::blocked;
  if (segment)
    return members == 1 ? max_clusters_fwd16<1, true>(n, m, cluster, kc,
                                                      smem_bytes)
                        : -(int)cudaErrorInvalidValue;
  switch (members) {
    case 8: return max_clusters_fwd16<8, false>(n, m, cluster, kc,
                                                smem_bytes);
    case 4: return max_clusters_fwd16<4, false>(n, m, cluster, kc,
                                                smem_bytes);
    case 2: return max_clusters_fwd16<2, false>(n, m, cluster, kc,
                                                smem_bytes);
    case 1: return max_clusters_fwd16<1, false>(n, m, cluster, kc,
                                                smem_bytes);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// The same for the bf16 march, whose shared memory is the larger of the
// ring and product16's staging (at three passes or at one).
extern "C" int vch_march16_max_clusters(int members, int segment, int n,
                                        int m, int cluster, int kc,
                                        int smem_bytes) {
  using namespace vch::blocked;
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

// The member-blocked march of B members (B % members == 0, members 8, 4 or
// 2) on clusters of `cluster` CTAs, with ring stages of kc rows and
// smem_bytes of dynamic shared memory per CTA: the geometry of
// ops/march.py blocked_geometry, checked here against the kernel's own.
// passes 0: apply_S in full float32; 3 or 1 ("bf16x3", "default"): on
// bf16 mma.sync from ops16, product16's fragment copies of its operators
// (with_ops16); fwd 3 (fwd_mm "bf16x3", passes then 3 or 1; fwd 1: a
// test's control): every other product of the march on bf16 mma.sync too,
// ops16 holding Lx's and Ly's copies after the four (with_fwd_ops16); fwd
// 0: full float32. Arguments
// otherwise as vch_march_fused_2d (march2d.cu); hist is (B, M+1, n, m)
// with phi0 first, work (B, 33, n, m).
extern "C" int vch_march_fused_2d_blocked(
    const float* dts, const float* phi0, const float* u, const float* Lx,
    const float* LyT, const float* Vxi, const float* VyiT, const float* Vx,
    const float* VyT, const float* lam, const float* wts, float* hist,
    int* nsolve, int* first_bad, float* work, int B, int M, int n, int m,
    const float* consts, int nconst, int max_iter, int n_trips,
    int stagnation, int members, int cluster, int kc, int smem_bytes,
    const void* ops16, int passes, int fwd, void* stream) {
  using namespace vch::blocked;
  if (members == 1) return (int)cudaErrorInvalidValue;
  const Args a{dts, phi0, u, Lx, LyT, Vxi, VyiT, Vx, VyT, lam, wts,
               nullptr, nullptr, nullptr, hist, nullptr, nullptr, nullptr,
               nsolve, first_bad, work, M, n, m, max_iter, n_trips,
               stagnation, {}, {}};
  return launch_whole(members, a, B, consts, nconst, cluster, kc, smem_bytes,
                      ops16, passes, fwd, stream);
}

// The whole march with one member per cluster of `cluster` CTAs: what
// vch_march_fused_2d (march2d.cu) computes, bit for bit (passes 0);
// arguments as vch_march_fused_2d_blocked's for one member. active: (B,)
// flags, or null for all; an inactive member gets nsolve 0 and first_bad
// -1, and its hist rows are left as they were.
extern "C" int vch_march_fused_2d_cluster(
    const float* dts, const float* phi0, const float* u, const float* Lx,
    const float* LyT, const float* Vxi, const float* VyiT, const float* Vx,
    const float* VyT, const float* lam, const float* wts, float* hist,
    int* nsolve, int* first_bad, float* work, int B, int M, int n, int m,
    const float* consts, int nconst, int max_iter, int n_trips,
    int stagnation, int cluster, int kc, int smem_bytes, const int* active,
    const void* ops16, int passes, int fwd, void* stream) {
  using namespace vch::blocked;
  const Args a{dts, phi0, u, Lx, LyT, Vxi, VyiT, Vx, VyT, lam, wts,
               nullptr, nullptr, nullptr, hist, nullptr, nullptr, nullptr,
               nsolve, first_bad, work, M, n, m, max_iter, n_trips,
               stagnation, {}, {}, active};
  return launch_whole(1, a, B, consts, nconst, cluster, kc, smem_bytes,
                      ops16, passes, fwd, stream);
}

// One K-step segment of B members, one member per cluster of `cluster`
// CTAs, with the (mu0, w0, global m0) carry in and (phi_f, mu_f, w_f) out;
// hist is (B, K, n, m), the post-step states only; u (B, K+1, n, m). The
// geometry, ops16, passes and fwd as vch_march_fused_2d_cluster's;
// arguments otherwise as vch_march_fused_2d_segment (march2d.cu).
extern "C" int vch_march_fused_2d_segment_cluster(
    const float* dts, const float* phi0, const float* mu0, const float* w0,
    const float* m0, const float* u, const float* Lx, const float* LyT,
    const float* Vxi, const float* VyiT, const float* Vx, const float* VyT,
    const float* lam, const float* wts, float* hist, float* phi_f,
    float* mu_f, float* w_f, int* nsolve, int* first_bad, float* work, int B,
    int K, int n, int m, const float* consts, int nconst, int max_iter,
    int n_trips, int stagnation, int cluster, int kc, int smem_bytes,
    const void* ops16, int passes, int fwd, void* stream) {
  using namespace vch::blocked;
  const Args a{dts, phi0, u, Lx, LyT, Vxi, VyiT, Vx, VyT, lam, wts,
               mu0, w0, m0, hist, phi_f, mu_f, w_f,
               nsolve, first_bad, work, K, n, m, max_iter, n_trips,
               stagnation, {}, {}};
  if (fwd)
    return launch_fwd16<1, true>(with_fwd_ops16(a, ops16, passes, fwd), B,
                                 consts, nconst, cluster, kc, smem_bytes,
                                 stream);
  if (passes)
    return launch16<1, true>(with_ops16(a, ops16, passes), B, consts, nconst,
                             cluster, kc, smem_bytes, stream);
  return launch<1, true>(a, B, consts, nconst, cluster, kc, smem_bytes,
                         stream);
}
#endif  // VCH_BB == 8 && !VCH_SEG && !VCH_PREC
