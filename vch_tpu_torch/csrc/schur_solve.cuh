// The Newton Schur solve on the cluster engine (cluster.cuh): the body of
// the per-solve Schur kernels (solve2d_cluster.cu). Per member, from the
// caller's fields DEN (the preconditioner symbol on the eigenvalue grid) and
// D (the Jacobian diagonal) and the right-hand side RHS, in the cosine basis
// (RAW false: the spectral solve):
//   b = to_s(rhs), x0 = 0;
//   n_trips trips of the fixed-trip BiCGStab on
//     S yh = poly yh - lam to_s(d from_s(yh)),
//     poly = 1/dt - (tau/dt) lam + (kappa/2) lam^2,
//   right-preconditioned by the pointwise divide by DEN, with the best
//   iterate, the (50 eps)^2 ||b||^2 noise-floor freeze and a non-finite new
//   residual rejected;
//   out = from_s(best);
// or in the raw basis (RAW true), b = rhs, x0 = 0, the same trips on
//     S v = (1/dt) v - L((tau/dt + d) v - (kappa/2) L v), L v = Lx v + v LyT,
//   right-preconditioned by M^-1 v = from_s(to_s(v) / DEN), out = best.
// The spectral loop is the cluster march's in-kernel Schur solve
// (march2d_blocked.cu, which forms DEN and D from phi and mean(d) instead).
// It sums and rounds as the one-CTA kernels do (solve2d.cu's SCHUR_SPECTRAL
// and SCHUR_RAW variants, common.cuh's bicgstab_fixed): products k
// ascending in one FMA chain, a Laplacian's two rounded products added,
// reductions in block_sum's order, every elementwise expression written
// alike. Built with -fmad=false on both sides (ops/_build.py), a member's
// bits are that kernel's, whatever the cluster size or the batch. The raw
// solve's two cost probes (nodots, mmonly) run its operators here too, bit
// for bit solve2d.cu's SCHUR_NODOTS and SCHUR_MMONLY variants.
#pragma once

#include "cluster.cuh"

namespace vch {
namespace schur {

using namespace cluster;

// Per-member control state, the same in every CTA of a cluster.
template <int MB>
struct Ctl {
  float red[2][MB][NWARP];        // warp values of a reduction
  float floor2[MB], r2[MB];
  float rho[MB], kalpha[MB], omega[MB], best_r2[MB];
  float rho_new[MB], beta[MB], alpha_n[MB], omega_n[MB];
  int live[MB], improved[MB];
};
static_assert(sizeof(Ctl<8>) <= CTL_BYTES, "Ctl outgrew its reserve");

// One CTA's view of its block of MB members, for the solve. Args: the
// kernel's arguments, with the operators Vxi, VyiT, Vx, VyT and lam (n, m)
// (RAW: Lx (n, n) and LyT (m, m), lam unused), n, m, n_trips, work and
// floor_fac; Slots: the workspace slots of the fields X, RR, P, V, R0, BX,
// S, T, PH, SH, T1, T2. Every method is force-inlined into the kernel, so
// the state below lives in registers; the per-member scalars live in
// `ctl`, in shared memory.
template <int MB, class Args, class Slots, bool RAW = false>
struct Solve : Block<MB> {
  using Base = Block<MB>;
  using Base::tid;
  using Base::FS;
  using Base::all;
  using Base::F;
  using Base::each_elem;
  using Base::gemm_l_to;
  using Base::gemm_r;
  using Base::gemm_r_to;
  const Args& a;
  Ctl<MB>& ctl;

  __device__ __forceinline__ Solve(const Args& args, const BGeom& g,
                                   Ctl<MB>& ctl_, float* smem, int fields)
      : Base(g, args.n, args.m, fields, args.work, smem, ctl_.red),
        a(args), ctl(ctl_) {}

  // OUT_b = S_b Y_b = poly Y_b - lam to_s(D_b from_s(Y_b)). Y is read in
  // the last product's epilogue, after the first product's cluster barrier.
  __device__ __forceinline__ void apply_S(const float* D, const float* Y,
                                          float* OUT, float inv_dt,
                                          float tau_dt, float hk) {
    float *T1 = F(Slots::T1), *T2 = F(Slots::T2);
    const float* lam = a.lam;
    const size_t fs = FS;
    gemm_l_to(a.Vx, Y, T1);
    gemm_r(T1, a.VyT, [&](int b, int e) {
      return Vals<1>{{D[b * fs + e]}};
    }, [&](int b, int e, float v, const Vals<1>& in) {
      T2[b * fs + e] = in.v[0] * v;
    });
    gemm_l_to(a.Vxi, T2, T1);
    gemm_r(T1, a.VyiT, [&](int b, int e) {
      return Vals<2>{{lam[e], Y[b * fs + e]}};
    }, [&](int b, int e, float v, const Vals<2>& in) {
      const float l = in.v[0];
      const float poly = (inv_dt - tau_dt * l) + (hk * l) * l;
      OUT[b * fs + e] = poly * in.v[1] - l * v;
    });
  }

  // OUT_b = M_b^-1 V_b = from_s(to_s(V_b) / DEN_b), the raw basis's
  // preconditioner (OUT != V), through T1 and T2; OUT is written band by
  // band by the last product.
  __device__ __forceinline__ void precondition(const float* DEN,
                                               const float* V, float* OUT) {
    float *T1 = F(Slots::T1), *T2 = F(Slots::T2);
    const size_t fs = FS;
    gemm_l_to(a.Vxi, V, T1);
    gemm_r(T1, a.VyiT, [&](int b, int e) {
      return Vals<1>{{DEN[b * fs + e]}};
    }, [&](int b, int e, float v, const Vals<1>& in) {
      T2[b * fs + e] = v / in.v[0];
    });
    gemm_l_to(a.Vx, T2, T1);
    gemm_r_to(T1, a.VyT, OUT);
  }

  // OUT_b = S_b Y_b in the raw basis: (1/dt) Y - L U, U = (tau/dt + D) Y -
  // (kappa/2) L Y in T2 (free here: the preconditioner's last read of it
  // lies before the first Laplacian's cluster barrier), each Laplacian's
  // first product through T1. Y is read band-locally, in the epilogues.
  __device__ __forceinline__ void apply_S_raw(const float* D, const float* Y,
                                              float* OUT, float inv_dt,
                                              float tau_dt, float hk) {
    float *T1 = F(Slots::T1), *U = F(Slots::T2);
    const size_t fs = FS;
    this->lap(a.Lx, a.LyT, Y, T1, [&](int b, int e) {
      const size_t i = b * fs + e;
      return Vals<2>{{D[i], Y[i]}};
    }, [&](int b, int e, float l, const Vals<2>& in) {
      U[b * fs + e] = (tau_dt + in.v[0]) * in.v[1] - hk * l;
    });
    this->lap(a.Lx, a.LyT, U, T1, [&](int b, int e) {
      return Vals<1>{{Y[b * fs + e]}};
    }, [&](int b, int e, float l, const Vals<1>& in) {
      OUT[b * fs + e] = inv_dt * in.v[0] - l;
    });
  }

  // The whole solve: OUT = from_s(best) (RAW: best). DEN, D, RHS and OUT
  // are fields of the block (member b at + b FS); RHS is read only by a
  // left product, after its barrier (RAW: by an elementwise pass), and OUT
  // is written band by band by the last product (RAW: by an elementwise
  // pass).
  __device__ __forceinline__ void solve(const float* DEN, const float* D,
                                        const float* RHS, float* OUT,
                                        float inv_dt, float tau_dt,
                                        float hk) {
    float *X = F(Slots::X), *RR = F(Slots::RR), *P = F(Slots::P);
    float *V = F(Slots::V), *R0 = F(Slots::R0), *BX = F(Slots::BX);
    float *Sv = F(Slots::S), *T = F(Slots::T), *PH = F(Slots::PH);
    float *SH = F(Slots::SH), *T1 = F(Slots::T1);
    const size_t fs = FS;

    // b = to_s(rhs) (RAW: rhs) into R0 and RR; x0 = 0
    if constexpr (RAW) {
      each_elem(all, [&](int b, int e) {
        return Vals<1>{{RHS[b * fs + e]}};
      }, [&](int b, int e, const Vals<1>& in) {
        const size_t i = b * fs + e;
        R0[i] = in.v[0];
        RR[i] = in.v[0];
        X[i] = 0.f;
        BX[i] = 0.f;
        P[i] = 0.f;
        V[i] = 0.f;
      });
    } else {
      gemm_l_to(a.Vxi, RHS, T1);
      gemm_r(T1, a.VyiT, [](int, int) { return None{}; },
             [&](int b, int e, float v, None) {
               const size_t i = b * fs + e;
               R0[i] = v;
               RR[i] = v;
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
      ctl.floor2[b] = a.floor_fac * nan_max(v[0], EPS_DIV);
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
        return Vals<2>{{R0[b * fs + e], RR[b * fs + e]}};
      }, [](int, int, const Vals<2>& in, float (&p)[1]) {
        p[0] += in.v[0] * in.v[1];
      }, [&](int b, const float (&v)[1]) {
        ctl.rho_new[b] = v[0];
        ctl.beta[b] = (v[0] / (ctl.rho[b] + EPS_DIV)) *
                      (ctl.kalpha[b] / (ctl.omega[b] + EPS_DIV));
      });
      if constexpr (RAW) {
        each_elem(live, [&](int b, int e) {
          const size_t o = b * fs + e;
          return Vals<3>{{RR[o], P[o], V[o]}};
        }, [&](int b, int e, const Vals<3>& in) {
          P[b * fs + e] =
              in.v[0] + ctl.beta[b] * (in.v[1] - ctl.omega[b] * in.v[2]);
        });
        precondition(DEN, P, PH);
        apply_S_raw(D, PH, V, inv_dt, tau_dt, hk);
      } else {
        each_elem(live, [&](int b, int e) {
          const size_t o = b * fs + e;
          return Vals<4>{{RR[o], P[o], V[o], DEN[o]}};
        }, [&](int b, int e, const Vals<4>& in) {
          const size_t o = b * fs + e;
          const float p =
              in.v[0] + ctl.beta[b] * (in.v[1] - ctl.omega[b] * in.v[2]);
          P[o] = p;
          PH[o] = p / in.v[3];
        });
        apply_S(D, PH, V, inv_dt, tau_dt, hk);
      }
      this->template reduce<1, false>(0.f, all, [&](int b, int e) {
        return Vals<2>{{R0[b * fs + e], V[b * fs + e]}};
      }, [](int, int, const Vals<2>& in, float (&p)[1]) {
        p[0] += in.v[0] * in.v[1];
      }, [&](int b, const float (&v)[1]) {
        ctl.alpha_n[b] = ctl.rho_new[b] / (v[0] + EPS_DIV);
      });
      if constexpr (RAW) {
        each_elem(live, [&](int b, int e) {
          const size_t o = b * fs + e;
          return Vals<2>{{RR[o], V[o]}};
        }, [&](int b, int e, const Vals<2>& in) {
          Sv[b * fs + e] = in.v[0] - ctl.alpha_n[b] * in.v[1];
        });
        precondition(DEN, Sv, SH);
        apply_S_raw(D, SH, T, inv_dt, tau_dt, hk);
      } else {
        each_elem(live, [&](int b, int e) {
          const size_t o = b * fs + e;
          return Vals<3>{{RR[o], V[o], DEN[o]}};
        }, [&](int b, int e, const Vals<3>& in) {
          const size_t o = b * fs + e;
          const float sv = in.v[0] - ctl.alpha_n[b] * in.v[1];
          Sv[o] = sv;
          SH[o] = sv / in.v[2];
        });
        apply_S(D, SH, T, inv_dt, tau_dt, hk);
      }
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
    // out = from_s(best x) (RAW: best x, in the layout that wrote BX)
    if constexpr (RAW) {
      each_elem(all, [&](int b, int e) { return Vals<1>{{BX[b * fs + e]}}; },
                [&](int b, int e, const Vals<1>& in) {
                  OUT[b * fs + e] = in.v[0];
                });
    } else {
      gemm_l_to(a.Vx, BX, T1);
      gemm_r_to(T1, a.VyT, OUT);
    }
  }

  // The cost probe nodots of the raw solve (scripts/diag_kernel_cost.py
  // :131; solve2d.cu's solve_probe<SCHUR_NODOTS>): n_trips trips of the
  // loop above with every block dot product the constant 0.5, so beta =
  // (rho'/rho)(alpha/omega), alpha' = rho'/0.5 and omega' = 0.5/0.5, held
  // in registers by every thread alike; no reduction, freeze, live mask or
  // best iterate; OUT = the last X. Slots: X, RR, P, V, S, T, PH, SH, T1,
  // T2. X, RR, P and S are written and read only by elementwise passes, in
  // one layout; V and T, which apply_S_raw writes band by band, are read
  // in that layout after a cluster barrier.
  __device__ __forceinline__ void nodots(const float* DEN, const float* D,
                                         const float* RHS, float* OUT,
                                         float inv_dt, float tau_dt,
                                         float hk) {
    static_assert(RAW, "the cost probes run the raw operators");
    float *X = F(Slots::X), *RR = F(Slots::RR), *P = F(Slots::P);
    float *V = F(Slots::V), *Sv = F(Slots::S), *T = F(Slots::T);
    float *PH = F(Slots::PH), *SH = F(Slots::SH);
    const size_t fs = FS;
    each_elem(all, [&](int b, int e) { return Vals<1>{{RHS[b * fs + e]}}; },
              [&](int b, int e, const Vals<1>& in) {
                const size_t i = b * fs + e;
                X[i] = 0.f;
                RR[i] = in.v[0];
                P[i] = 0.f;
                V[i] = 0.f;
              });
    const float dot = 0.5f;               // every block dot product
    float rho = 1.f, alpha = 1.f, omega = 1.f;
    for (int trip = 0; trip < a.n_trips; ++trip) {
      const float rho_new = dot;
      const float beta = (rho_new / rho) * (alpha / omega);
      each_elem(all, [&](int b, int e) {
        const size_t o = b * fs + e;
        return Vals<3>{{RR[o], P[o], V[o]}};
      }, [&](int b, int e, const Vals<3>& in) {
        P[b * fs + e] = in.v[0] + beta * (in.v[1] - omega * in.v[2]);
      });
      precondition(DEN, P, PH);
      apply_S_raw(D, PH, V, inv_dt, tau_dt, hk);
      const float alpha_n = rho_new / dot;
      this->cluster.sync();               // V, written band by band
      each_elem(all, [&](int b, int e) {
        const size_t o = b * fs + e;
        return Vals<2>{{RR[o], V[o]}};
      }, [&](int b, int e, const Vals<2>& in) {
        Sv[b * fs + e] = in.v[0] - alpha_n * in.v[1];
      });
      precondition(DEN, Sv, SH);
      apply_S_raw(D, SH, T, inv_dt, tau_dt, hk);
      const float omega_n = dot / dot;
      this->cluster.sync();               // T, written band by band
      each_elem(all, [&](int b, int e) {
        const size_t o = b * fs + e;
        return Vals<5>{{X[o], PH[o], SH[o], Sv[o], T[o]}};
      }, [&](int b, int e, const Vals<5>& in) {
        const size_t o = b * fs + e;
        X[o] = in.v[0] + alpha_n * in.v[1] + omega_n * in.v[2];
        RR[o] = in.v[3] - omega_n * in.v[4];
      });
      rho = rho_new;
      alpha = alpha_n;
      omega = omega_n;
    }
    each_elem(all, [&](int b, int e) { return Vals<1>{{X[b * fs + e]}}; },
              [&](int b, int e, const Vals<1>& in) {
                OUT[b * fs + e] = in.v[0];
              });
  }

  // The cost probe mmonly (scripts/diag_kernel_cost.py:176; solve2d.cu's
  // solve_probe<SCHUR_MMONLY>): v <- M^-1 S v, 2 n_trips links from v =
  // RHS, through the slots X and T (and T1, T2): S into T, then M^-1 into X
  // or, on the last link, OUT. Every field a link reads in another CTA's
  // band, a left product reads after its own cluster barrier.
  __device__ __forceinline__ void mmonly(const float* DEN, const float* D,
                                         const float* RHS, float* OUT,
                                         float inv_dt, float tau_dt,
                                         float hk) {
    static_assert(RAW, "the cost probes run the raw operators");
    float *Y = F(Slots::X), *Z = F(Slots::T);
    const size_t fs = FS;
    const int links = 2 * a.n_trips;
    const float* y = RHS;
    for (int link = 0; link < links; ++link) {
      apply_S_raw(D, y, Z, inv_dt, tau_dt, hk);
      float* to = link + 1 < links ? Y : OUT;
      precondition(DEN, Z, to);
      y = to;
    }
    if (links == 0)
      each_elem(all, [&](int b, int e) {
        return Vals<1>{{RHS[b * fs + e]}};
      }, [&](int b, int e, const Vals<1>& in) {
        OUT[b * fs + e] = in.v[0];
      });
  }
};

}  // namespace schur
}  // namespace vch
