// The split-preconditioned solve of one adjoint step on the cluster engine
// (cluster.cuh): one body for the cluster sweep (adjoint2d_cluster.cu),
// which runs it inside every reverse step, and the per-step solve kernels
// (solve2d_cluster.cu), which run it alone. Per member, from the fields ISD
// (1 / sqrt|denom| on the eigenvalue grid) and FPP (f''(phi_n)) of the
// workspace, in the cosine basis (RAW false: the sweep's and the spectral
// solve's operator):
//   bt = isd to_s(rhs), y0 = to_s(x0) / isd, r0 = bt - At y0;
//   n_trips trips of the fixed-trip BiCGStab on
//     At y = isd (poly z - (dt/2) to_s(f'' from_s(lam z))), z = isd y,
//   with the best iterate, the (50 eps)^2 ||bt||^2 noise-floor freeze and
//   a non-finite new residual rejected;
//   p = from_s(isd best);
// or in the raw basis (RAW true), with P^-1/2 v = from_s(isd to_s(v)):
//   bt = P^-1/2 rhs, y0 = P^1/2 x0, the same trips on
//     At y = P^-1/2 A P^-1/2 y, A v = v - tau L v + (dt/2)(L L v - f'' L v),
//   p = P^-1/2 best.
// It sums and rounds as the one-CTA kernels do (common.cuh's
// bicgstab_fixed in adjoint2d.cu's sweep and in solve2d.cu's
// ADJOINT_SPECTRAL and ADJOINT_RAW variants): products k ascending in one
// FMA chain, a Laplacian's two rounded products added, reductions in
// block_sum's order, every elementwise expression written alike. Built
// alike on both sides (ops/_build.py: the sweep and the spectral solve with
// -fmad=false, the raw solve with nvcc's default contraction), a member's
// bits are theirs, whatever the cluster size or the batch.
//
// BF16 (the cluster sweep's bf16 forms, adjoint_solve_precision "bf16x3";
// never with RAW): At's four products on cluster.cuh's product16 at
// Args::passes, three for vch_tpu's _make_mm (pallas_march.py:677-686; one
// only as the tests' control, adjoint2d_cluster.cu); every other product
// of the solve stays full float32. The float32 objects keep their SASS: the
// flag is `if constexpr`, default off.
#pragma once

#include "adjoint.cuh"
#include "cluster.cuh"

namespace vch {
namespace adj {

using namespace cluster;

// Per-member control state, the same in every CTA of a cluster.
template <int MB>
struct Ctl {
  float red[2][MB][NWARP];        // warp values of a reduction
  float hdt_fbar[MB], floor2[MB], r2[MB];
  float rho[MB], kalpha[MB], omega[MB], best_r2[MB];
  float rho_new[MB], beta[MB], alpha_n[MB], omega_n[MB];
  int live[MB], improved[MB];
};
static_assert(sizeof(Ctl<8>) <= CTL_BYTES, "Ctl outgrew its reserve");

// One CTA's view of its block of MB members, for the solve. Args: the
// kernel's arguments, with the operators Vxi, VyiT, Vx, VyT and lam (n, m)
// (RAW: Lx (n, n) and LyT (m, m) too), n, m, n_trips, work and c (an
// AdjConst: floor_fac); Slots: the workspace slots of the fields ISD, FPP,
// X, RR, PK, V, R0, BX, S, T, Z, T1, T2 (RAW: W and U too). Every method is
// force-inlined into the kernel, so the state below lives in registers; the
// per-member scalars live in `ctl`, in shared memory. BF16: Args also
// holds `ops16` (cluster.cuh Ops16) and product16's slab widths `jt_left`,
// `jt_right`.
template <int MB, class Args, class Slots, bool RAW = false,
          bool BF16 = false>
struct Solve : Block<MB> {
  static_assert(!(RAW && BF16), "the bf16 solve is the spectral one");
  using Base = Block<MB>;
  using Base::tid;
  using Base::FS;
  using Base::all;
  using Base::cluster;
  using Base::F;
  using Base::each_elem;
  using Base::gemm_l_to;
  using Base::gemm_r;
  using Base::gemm_r_to;
  const Args& a;
  const AdjConst& c;
  Ctl<MB>& ctl;

  __device__ __forceinline__ Solve(const Args& args, const BGeom& g,
                                   Ctl<MB>& ctl_, float* smem, int fields)
      : Base(g, args.n, args.m, fields, args.work, smem, ctl_.red),
        a(args), c(args.c), ctl(ctl_) {}

  // OUT_b = At_b Y_b, the split-preconditioned operator: apply_spectral
  // or apply_raw
  __device__ __forceinline__ void apply_At(const float* Y, float* OUT,
                                           float tau, float half_dt) {
    if constexpr (RAW)
      apply_raw(Y, OUT, tau, half_dt);
    else
      apply_spectral(Y, OUT, tau, half_dt);
  }

  // OUT_b = At_b Y_b in the cosine basis: isd (poly z - (dt/2)
  // to_s(fpp_n from_s(lam z))), z = isd y (BF16: its four products on
  // product16 at a.passes). Y's elements are read in the elementwise
  // layout: a Y whose last writer was a product's epilogue needs a cluster
  // barrier first.
  __device__ __forceinline__ void apply_spectral(const float* Y, float* OUT,
                                                 float tau, float half_dt) {
    const float *ISD = F(Slots::ISD), *FPP = F(Slots::FPP), *lam = a.lam;
    float *Z = F(Slots::Z), *T1 = F(Slots::T1), *T2 = F(Slots::T2);
    const size_t fs = FS;
    each_elem(all, [&](int b, int e) {
      const size_t i = b * fs + e;
      return Vals<3>{{lam[e], ISD[i], Y[i]}};
    }, [&](int b, int e, const Vals<3>& in) {
      Z[b * fs + e] = in.v[0] * (in.v[1] * in.v[2]);
    });
    if constexpr (BF16) {
      const Ops16& o = a.ops16;
      this->gemm16_l_to(o.vx, Z, T1, a.passes, a.jt_left);
      this->gemm16_r(T1, o.vy, a.passes, a.jt_right, [&](int b, int e) {
        return Vals<1>{{FPP[b * fs + e]}};
      }, [&](int b, int e, float v, const Vals<1>& in) {
        T2[b * fs + e] = in.v[0] * v;
      });
      this->gemm16_l_to(o.vxi, T2, T1, a.passes, a.jt_left);
      this->gemm16_r(T1, o.vyi, a.passes, a.jt_right, [&](int b, int e) {
        const size_t i = b * fs + e;
        return Vals<3>{{ISD[i], Y[i], lam[e]}};
      }, [&](int b, int e, float v, const Vals<3>& in) {
        const float s = in.v[0], l = in.v[2];
        const float poly = (1.f - tau * l) + (half_dt * l) * l;
        OUT[b * fs + e] = s * (poly * (s * in.v[1]) - half_dt * v);
      });
      return;
    }
    gemm_l_to(a.Vx, Z, T1);
    gemm_r(T1, a.VyT, [&](int b, int e) {
      return Vals<1>{{FPP[b * fs + e]}};
    }, [&](int b, int e, float v, const Vals<1>& in) {
      T2[b * fs + e] = in.v[0] * v;
    });
    gemm_l_to(a.Vxi, T2, T1);
    gemm_r(T1, a.VyiT, [&](int b, int e) {
      const size_t i = b * fs + e;
      return Vals<3>{{ISD[i], Y[i], lam[e]}};
    }, [&](int b, int e, float v, const Vals<3>& in) {
      const float s = in.v[0], l = in.v[2];
      const float poly = (1.f - tau * l) + (half_dt * l) * l;
      OUT[b * fs + e] = s * (poly * (s * in.v[1]) - half_dt * v);
    });
  }

  // st(b, e, (P^-1/2 V_b)[e]) (MUL) or st(b, e, (P^1/2 V_b)[e]), P^-1/2 V
  // = from_s(isd to_s(V)): the raw basis's split preconditioner, through
  // T1 and T2
  template <bool MUL, class St>
  __device__ __forceinline__ void phalf(const float* V, St st) {
    const float* ISD = F(Slots::ISD);
    float *T1 = F(Slots::T1), *T2 = F(Slots::T2);
    const size_t fs = FS;
    gemm_l_to(a.Vxi, V, T1);
    gemm_r(T1, a.VyiT, [&](int b, int e) {
      return Vals<1>{{ISD[b * fs + e]}};
    }, [&](int b, int e, float v, const Vals<1>& in) {
      T2[b * fs + e] = MUL ? v * in.v[0] : v / in.v[0];
    });
    gemm_l_to(a.Vx, T2, T1);
    gemm_r(T1, a.VyT, [](int, int) { return None{}; },
           [&](int b, int e, float v, None) { st(b, e, v); });
  }

  // OUT_b = At_b Y_b in the raw basis: P^-1/2 A P^-1/2 y, A v = v - tau w
  // + (dt/2)(L w - f'' w), w = L v; z = P^-1/2 y in Z, w in W, A z in U,
  // each Laplacian's first product through T1
  __device__ __forceinline__ void apply_raw(const float* Y, float* OUT,
                                            float tau, float half_dt) {
    const float* FPP = F(Slots::FPP);
    float *Z = F(Slots::Z), *T1 = F(Slots::T1), *W = F(Slots::W);
    float* U = F(Slots::U);
    const size_t fs = FS;
    phalf<true>(Y, [&](int b, int e, float v) { Z[b * fs + e] = v; });
    this->lap(a.Lx, a.LyT, Z, T1, [](int, int) { return None{}; },
              [&](int b, int e, float l, None) { W[b * fs + e] = l; });
    this->lap(a.Lx, a.LyT, W, T1, [&](int b, int e) {
      const size_t i = b * fs + e;
      return Vals<3>{{W[i], Z[i], FPP[i]}};
    }, [&](int b, int e, float l, const Vals<3>& in) {
      const float w = in.v[0];
      U[b * fs + e] = in.v[1] - tau * w + half_dt * (l - in.v[2] * w);
    });
    phalf<true>(U, [&](int b, int e, float v) { OUT[b * fs + e] = v; });
  }

  // Fixed-trip BiCGStab in masked lockstep (common.cuh bicgstab_fixed with
  // no preconditioner: PH is P, SH is S). On entry X, RR = R0, P = V = 0,
  // BX and ctl's r2, floor2 and Krylov scalars are set.
  __device__ __forceinline__ void bicgstab(float tau, float half_dt) {
    float *X = F(Slots::X), *RR = F(Slots::RR), *PK = F(Slots::PK);
    float *V = F(Slots::V), *R0 = F(Slots::R0), *BX = F(Slots::BX);
    float *Sv = F(Slots::S), *T = F(Slots::T);
    const size_t fs = FS;
    auto live = [&](int b) { return ctl.live[b] != 0; };
    for (int trip = 0; trip < a.n_trips; ++trip) {
      if (tid < MB)
        ctl.live[tid] = ctl.live[tid] && ctl.r2[tid] > ctl.floor2[tid];
      __syncthreads();
      if (!any_member<MB>(ctl.live)) break;
      this->template reduce<1, false>(0.f, all, [&](int b, int e) {
        return Vals<2>{{R0[b * fs + e], RR[b * fs + e]}};
      }, [](int, int, const Vals<2>& in, float (&p)[1]) {
        p[0] += in.v[0] * in.v[1];
      }, [&](int b, const float (&v)[1]) {
        ctl.rho_new[b] = v[0];
        ctl.beta[b] = (v[0] / (ctl.rho[b] + EPS_DIV)) *
                      (ctl.kalpha[b] / (ctl.omega[b] + EPS_DIV));
      });
      each_elem(live, [&](int b, int e) {
        const size_t o = b * fs + e;
        return Vals<3>{{RR[o], PK[o], V[o]}};
      }, [&](int b, int e, const Vals<3>& in) {
        PK[b * fs + e] =
            in.v[0] + ctl.beta[b] * (in.v[1] - ctl.omega[b] * in.v[2]);
      });
      apply_At(PK, V, tau, half_dt);
      this->template reduce<1, false>(0.f, all, [&](int b, int e) {
        return Vals<2>{{R0[b * fs + e], V[b * fs + e]}};
      }, [](int, int, const Vals<2>& in, float (&p)[1]) {
        p[0] += in.v[0] * in.v[1];
      }, [&](int b, const float (&v)[1]) {
        ctl.alpha_n[b] = ctl.rho_new[b] / (v[0] + EPS_DIV);
      });
      each_elem(live, [&](int b, int e) {
        const size_t o = b * fs + e;
        return Vals<2>{{RR[o], V[o]}};
      }, [&](int b, int e, const Vals<2>& in) {
        Sv[b * fs + e] = in.v[0] - ctl.alpha_n[b] * in.v[1];
      });
      apply_At(Sv, T, tau, half_dt);
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
        return Vals<4>{{X[o], PK[o], Sv[o], T[o]}};
      }, [&](int b, int e, const Vals<4>& in, float (&p)[1]) {
        const size_t o = b * fs + e;
        X[o] = in.v[0] + ctl.alpha_n[b] * in.v[1] + ctl.omega_n[b] * in.v[2];
        const float r = in.v[2] - ctl.omega_n[b] * in.v[3];
        RR[o] = r;
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
  }

  // The fields the whole solve uses, which its caller forms once, ahead
  // of any step loop: formed inside the solve at every step, they took
  // registers the sweep's steps needed (ptxas spilled more, and the
  // segment sweep ran 5% slower on an H100).
  struct Fields {
    const float* ISD;
    float *X, *RR, *PK, *V, *R0, *BX, *T, *Z, *T1;
  };
  __device__ __forceinline__ Fields fields() const {
    return Fields{F(Slots::ISD), F(Slots::X), F(Slots::RR), F(Slots::PK),
                  F(Slots::V),   F(Slots::R0), F(Slots::BX), F(Slots::T),
                  F(Slots::Z),   F(Slots::T1)};
  }

  // The whole solve: OUT = from_s(isd best), warm started from X0, on ISD
  // and FPP as set. RHS, X0 and OUT are fields of the block (member b at
  // + b FS); RHS and X0 are read only by left products, after their
  // barrier, and OUT is written band by band by the last product.
  __device__ __forceinline__ void solve(const Fields& f, const float* RHS,
                                        const float* X0, float* OUT,
                                        float tau, float half_dt) {
    const float* ISD = f.ISD;
    float *X = f.X, *RR = f.RR, *PK = f.PK, *V = f.V, *R0 = f.R0;
    float *BX = f.BX, *T = f.T, *Z = f.Z, *T1 = f.T1;
    const size_t fs = FS;
    const AdjConst& k = c;

    // bt = isd to_s(rhs) (raw: P^-1/2 rhs; kept in R0 until r0 is
    // formed), its floor
    if constexpr (RAW) {
      phalf<true>(RHS, [&](int b, int e, float v) { R0[b * fs + e] = v; });
    } else {
      gemm_l_to(a.Vxi, RHS, T1);
      gemm_r(T1, a.VyiT, [&](int b, int e) {
        return Vals<1>{{ISD[b * fs + e]}};
      }, [&](int b, int e, float v, const Vals<1>& in) {
        R0[b * fs + e] = in.v[0] * v;
      });
    }
    this->template reduce<1, false>(0.f, all, [&](int b, int e) {
      return Vals<1>{{R0[b * fs + e]}};
    }, [](int, int, const Vals<1>& in, float (&p)[1]) {
      p[0] += in.v[0] * in.v[0];
    }, [&](int b, const float (&v)[1]) {
      ctl.floor2[b] = k.floor_fac * nan_max(v[0], EPS_DIV);
    });
    // y0 = to_s(x0) / isd (raw: P^1/2 x0; warm start and initial best
    // iterate)
    if constexpr (RAW) {
      phalf<false>(X0, [&](int b, int e, float y) {
        const size_t i = b * fs + e;
        X[i] = y;
        BX[i] = y;
      });
    } else {
      gemm_l_to(a.Vxi, X0, T1);
      gemm_r(T1, a.VyiT, [&](int b, int e) {
        return Vals<1>{{ISD[b * fs + e]}};
      }, [&](int b, int e, float v, const Vals<1>& in) {
        const size_t i = b * fs + e;
        const float y = v / in.v[0];
        X[i] = y;
        BX[i] = y;
      });
    }
    // r0 = bt - At y0 (At y0 lands in T, which every trip overwrites)
    cluster.sync();                   // y0's bands were written by their CTAs
    apply_At(X, T, tau, half_dt);
    this->template reduce<1, false>(0.f, all, [&](int b, int e) {
      const size_t i = b * fs + e;
      return Vals<2>{{R0[i], T[i]}};
    }, [&](int b, int e, const Vals<2>& in, float (&p)[1]) {
      const size_t i = b * fs + e;
      const float r = in.v[0] - in.v[1];
      R0[i] = r;
      RR[i] = r;
      PK[i] = 0.f;
      V[i] = 0.f;
      p[0] += r * r;
    }, [&](int b, const float (&v)[1]) {
      ctl.r2[b] = v[0];
      ctl.rho[b] = ctl.kalpha[b] = ctl.omega[b] = 1.f;
      ctl.best_r2[b] = v[0];
      ctl.live[b] = 1;
    });
    bicgstab(tau, half_dt);

    // p = from_s(isd * best) (raw: P^-1/2 best)
    if constexpr (RAW) {
      phalf<true>(BX, [&](int b, int e, float v) { OUT[b * fs + e] = v; });
    } else {
      each_elem(all, [&](int b, int e) {
        const size_t i = b * fs + e;
        return Vals<2>{{ISD[i], BX[i]}};
      }, [&](int b, int e, const Vals<2>& in) {
        Z[b * fs + e] = in.v[0] * in.v[1];
      });
      gemm_l_to(a.Vx, Z, T1);
      gemm_r_to(T1, a.VyT, OUT);
    }
  }
};

}  // namespace adj
}  // namespace vch
