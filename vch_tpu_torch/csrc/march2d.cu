// Whole batched 2D forward march of the viscous Cahn–Hilliard system.
//
// Replaces two TPU kernels of vch_tpu/ops/pallas_march.py:
//   - :393 march_fused_2d (body _march_kernel_factory, :79-390): one member
//     per CTA, BB = 1;
//   - :479 march_fused_2d_segment (the factory's segment=True): one member
//     per CTA with the (mu, w, global m0) carry in, (phi, mu, w) out, and
//     only the post-step states in the history.
// Per time step and member: the w CN update and mu_init, then the member's
// own Newton loop — dense-stencil CN residual, fixed-trip BiCGStab on the
// Schur system in the cosine basis (best iterate, noise-floor freeze), step
// ceiling, Armijo with at most 12 halvings, best-trial fallback and the
// hand-off of the returned iterate's residual — then clip, interior mass
// correction and the first-bad-step sanitizer.
//
// What bounds it on an H100: dependent dense (n x n)(n x m) products, about
// 40 per Newton iteration, each 2.1 MFMA at n = m = 129, in a strictly
// sequential chain (every Krylov scalar and loop predicate needs the previous
// product), and the ~33 fields of per-member state: one 129 x 129 float32
// field is 66.6 KB while a CTA has at most 227 KB of shared memory.
//
// The member-blocked form (:1649 march_fused_2d_blocked) and the segment
// march the solvers run are march2d_blocked.cu's cluster kernel, which
// computes each member as this kernel does; this kernel's segment flag is
// that segment march's bit oracle (ops/march.py
// _march_fused_2d_segment_cta), reached by no solver.
//
// Design: a CTA walks the whole time loop for its BB members (the TPU's
// sequential (member, step) grid becomes a loop inside the CTA). Member
// state lives in a global workspace (B, FWD_FIELDS, n, m) allocated by the
// wrapper, hot in L1/L2; the six operator matrices are shared by all CTAs
// from L2. Products are SIMT FP32 FMA through 48 x 48 shared-memory tiles
// (ragged edges masked; no tensor cores, no TF32); with BB > 1 the
// left-multiplies run over the members' fields side by side and the
// right-multiplies over the fields stacked, which fills the tiles of small
// grids (65 = 48 + 17). Newton and Armijo run in masked lockstep: the CTA
// loops while any member is active, every predicate comes from a CTA-wide
// reduction that all threads receive identically, and a member whose own
// exit fired only stops updating its state and counters. A member's
// arithmetic does not depend on BB (see common.cuh), so its history and
// Newton count are those of the one-member kernel. Armijo's trial and best
// iterates live in their own buffer sets and are copied into the current
// set when taken.
#include "common.cuh"

namespace vch {

struct FwdConst {
  float tau, c1, two_c1, two_c2, neg_kappa, half_kappa, gamma;
  float log_lo, log_hi, lo, hi, dsep2, interior_thr, area;
  float newton_tol, newton_rtol, floor_fac;
};
constexpr int FWD_NCONST = sizeof(FwdConst) / sizeof(float);

// workspace field slots
enum {
  F_PHI_OLD, F_MU_OLD, F_W_OLD, F_W_NEW, F_LMU_OLD, F_LPHI_OLD,
  F_QUAD,                         // 3 sets of (phi, mu, Rphi, Rmu)
  F_DPHI = F_QUAD + 12, F_DMU, F_D,
  F_X, F_R, F_P, F_V, F_R0, F_BX, F_S, F_T, F_PH, F_SH,
  F_T1, F_T2,
  F_COUNT
};
static_assert(F_COUNT == FWD_FIELDS, "FWD_FIELDS out of date");
enum { Q_CUR, Q_TRIAL, Q_BEST };  // the buffer sets

__device__ __forceinline__ float flog(float phi, const FwdConst& c) {
  const float ph = nan_clamp(phi, c.log_lo, c.log_hi);
  return logf((1.f + ph) / (1.f - ph));
}

struct MarchArgs {
  const float *dts, *phi0, *u;
  const float *Lx, *LyT, *Vxi, *VyiT, *Vx, *VyT, *lam, *wts;
  const float *mu0, *w0, *m0;     // segment carry in (null: whole march)
  float *hist, *phi_f, *mu_f, *w_f;   // phi_f.. null: whole march
  int *nsolve, *bad;
  float* work;
  int M, n, m, max_iter, n_trips, stagnation;
  FwdConst c;
};

// LEAN: every field pointer is formed where it is used, from the workspace
// base kept in shared memory, which the compiler reads again after each
// barrier, so no pointer is held in registers across the building blocks.
// The one-member march then takes 128 registers with no spills and two
// CTAs share an SM; holding the 33 field pointers takes 221-232 registers
// and one CTA per SM, which is 4% faster while every CTA has an SM to
// itself (n = 129, B <= 128 on an H100; PERF.md). The blocked kernel holds
// them: formed at use, ptxas gives it 128 registers and spills.
template <int BB, bool LEAN>
__global__ void __launch_bounds__(NT) march_kernel(MarchArgs a) {
  __shared__ Smem sm;
  const FwdConst& c = a.c;
  const int tid = threadIdx.x, n = a.n, m = a.m, nm = n * m, M = a.M;
  const int b0 = blockIdx.x * BB;           // the CTA's first member
  const bool seg = a.mu0 != nullptr;
  const int frames = seg ? M : M + 1;       // hist frames per member
  const size_t FS = (size_t)F_COUNT * nm;   // member stride of a field
  const size_t HS = (size_t)frames * nm;    // member stride of hist and u
  const size_t US = (size_t)(M + 1) * nm;
  float* const W = a.work + b0 * FS;
  __shared__ float* work_base;
  if (LEAN) {
    if (tid == 0) work_base = W;
    __syncthreads();
  }
  auto F = [&](int slot) {
    return (LEAN ? work_base : W) + (size_t)slot * nm;
  };
  auto phi_old = [&] { return F(F_PHI_OLD); };
  auto mu_old = [&] { return F(F_MU_OLD); };
  auto w_old = [&] { return F(F_W_OLD); };
  auto w_new = [&] { return F(F_W_NEW); };
  auto lmu_old = [&] { return F(F_LMU_OLD); };
  auto lphi_old = [&] { return F(F_LPHI_OLD); };
  auto dphi = [&] { return F(F_DPHI); };
  auto dmu = [&] { return F(F_DMU); };
  auto dfield = [&] { return F(F_D); };
  auto T1 = [&] { return F(F_T1); };
  auto T2 = [&] { return F(F_T2); };
  auto kbufs = [&] {
    return KBufs{F(F_X), F(F_R), F(F_P), F(F_V), F(F_R0), F(F_BX),
                 F(F_S), F(F_T), F(F_PH), F(F_SH), FS};
  };
  const KBufs kb_held = kbufs();            // not formed when LEAN
  auto Qphi = [&](int q) { return F(F_QUAD + 4 * q); };
  auto Qmu = [&](int q) { return F(F_QUAD + 4 * q + 1); };
  auto Qrp = [&](int q) { return F(F_QUAD + 4 * q + 2); };
  auto Qrm = [&](int q) { return F(F_QUAD + 4 * q + 3); };
  const float* lam = a.lam;
  const float* wts = a.wts;
  float* hist = a.hist + b0 * HS;
  const float* ub = a.u + b0 * US;

  // ---- initial state: phi0, and (mu0, w0, m0) from the carry or from phi0:
  // w0 = 0, mu0 = -kappa L phi0 + f'(phi0), m0 = sum(wts phi0) ----
  float m0[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) {
    const size_t o = b * FS;
    const float* p0 = a.phi0 + (size_t)(b0 + b) * nm;
    float part = 0.f;
    for (int e = tid; e < nm; e += NT) {
      const float ph = p0[e];
      phi_old()[o + e] = ph;
      if (seg) {
        mu_old()[o + e] = a.mu0[(size_t)(b0 + b) * nm + e];
        w_old()[o + e] = a.w0[(size_t)(b0 + b) * nm + e];
      } else {
        hist[b * HS + e] = ph;
        w_old()[o + e] = 0.f;
      }
      part += wts[e] * ph;
    }
    m0[b] = part;
  }
  if (seg) {
#pragma unroll
    for (int b = 0; b < BB; ++b) m0[b] = a.m0[b0 + b];
    __syncthreads();
  } else {
    block_sum<BB>(m0, sm);
    lap_gemm<BB>(a.Lx, a.LyT, phi_old(), FS, n, m, sm, [&](int b, int e, float l) {
      const float ph = phi_old()[b * FS + e];
      mu_old()[b * FS + e] = c.neg_kappa * l + c.c1 * flog(ph, c) - c.two_c2 * ph;
    });
  }

  int nsolve_total[BB], bad[BB];
#pragma unroll
  for (int b = 0; b < BB; ++b) {
    nsolve_total[b] = 0;
    bad[b] = -1;
  }
  const int hoff = seg ? 0 : 1;             // frame of the state after step 0

  for (int step = 0; step < M; ++step) {
    const float dt = a.dts[step];
    const float inv_dt = 1.f / dt;
    const float tau_dt = c.tau * inv_dt;
    const float gamma_dt = c.gamma * inv_dt;
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const size_t o = b * FS;
      const float* un = ub + b * US + (size_t)step * nm;
      const float* unp1 = un + nm;
      for (int e = tid; e < nm; e += NT)
        w_new()[o + e] = ((gamma_dt - 0.5f) * w_old()[o + e] +
                        0.5f * (unp1[e] + un[e])) / (gamma_dt + 0.5f);
    }
    __syncthreads();
    lap_gemm<BB>(a.Lx, a.LyT, mu_old(), FS, n, m, sm,
                 [&](int b, int e, float l) { lmu_old()[b * FS + e] = l; });
    {
      float *qphi = Qphi(Q_CUR), *qmu = Qmu(Q_CUR);
      lap_gemm<BB>(a.Lx, a.LyT, phi_old(), FS, n, m, sm, [&](int b, int e, float l) {
        const size_t i = b * FS + e;
        const float ph = phi_old()[i];
        lphi_old()[i] = l;
        qphi[i] = ph;
        qmu[i] = c.neg_kappa * l + c.c1 * flog(ph, c) - c.two_c2 * ph - w_new()[i];
      });
    }

    // CN residuals of buffer set q vs the step's frozen old level; the
    // per-member norms land in norm
    auto resid = [&](int q, float (&norm)[BB]) {
      const float *phi = Qphi(q), *mu = Qmu(q);
      float *rp = Qrp(q), *rm = Qrm(q);
      lap_gemm<BB>(a.Lx, a.LyT, mu, FS, n, m, sm, [&](int b, int e, float l) {
        const size_t i = b * FS + e;
        rm[i] = (phi[i] - phi_old()[i]) * inv_dt - 0.5f * (l + lmu_old()[i]);
      });
      lap_gemm<BB>(a.Lx, a.LyT, phi, FS, n, m, sm, [&](int b, int e, float l) {
        const size_t i = b * FS + e;
        const float ph = phi[i], po = phi_old()[i];
        rp[i] = tau_dt * (ph - po) - c.half_kappa * (l + lphi_old()[i]) +
                c.c1 * flog(ph, c) + (-c.two_c2 * po) -
                0.5f * (mu[i] + mu_old()[i]) - 0.5f * (w_new()[i] + w_old()[i]);
      });
      float sp[BB], sm2[BB];
      member_sums<BB>(sp, nm, sm, [&](int b, int e) {
        const float v = rp[b * FS + e];
        return v * v;
      });
      member_sums<BB>(sm2, nm, sm, [&](int b, int e) {
        const float v = rm[b * FS + e];
        return v * v;
      });
#pragma unroll
      for (int b = 0; b < BB; ++b) norm[b] = sqrtf(sp[b] + sm2[b]);
    };

    auto poly = [&](int e) {
      const float l = lam[e];
      return (inv_dt - tau_dt * l) + (c.half_kappa * l) * l;
    };

    // Schur solve in the cosine basis -> (dphi, dmu) of the current set
    auto schur_solve = [&]() {
      const KBufs kb = LEAN ? kbufs() : kb_held;
      const float *phi = Qphi(Q_CUR), *rp = Qrp(Q_CUR), *rm = Qrm(Q_CUR);
      float dbar[BB];
      member_sums<BB>(dbar, nm, sm, [&](int b, int e) {
        const size_t i = b * FS + e;
        const float ph = phi[i];
        const float d = c.two_c1 / (1.f - nan_clamp(ph * ph, 0.f, c.dsep2));
        dfield()[i] = d;
        return d;
      });
#pragma unroll
      for (int b = 0; b < BB; ++b) dbar[b] = dbar[b] / (float)nm;
      auto prec = [&](int b, int e, float v) {
        return v / (poly(e) - dbar[b] * lam[e]);
      };
      auto apply_S = [&](const float* Y, float* OUT) {
        gemm_l<BB>(a.Vx, Y, FS, n, n, m, sm,
                   [&](int b, int e, float v) { T1()[b * FS + e] = v; });
        gemm_r<BB>(T1(), FS, a.VyT, n, m, m, sm, [&](int b, int e, float v) {
          T2()[b * FS + e] = dfield()[b * FS + e] * v;
        });
        gemm_l<BB>(a.Vxi, T2(), FS, n, n, m, sm,
                   [&](int b, int e, float v) { T1()[b * FS + e] = v; });
        gemm_r<BB>(T1(), FS, a.VyiT, n, m, m, sm, [&](int b, int e, float v) {
          const size_t i = b * FS + e;
          OUT[i] = poly(e) * Y[i] - lam[e] * v;
        });
      };
      // b = to_s(L Rphi - Rmu); x0 = 0
      lap_gemm<BB>(a.Lx, a.LyT, rp, FS, n, m, sm, [&](int b, int e, float l) {
        const size_t i = b * FS + e;
        T1()[i] = l - rm[i];
      });
      gemm_l<BB>(a.Vxi, T1(), FS, n, n, m, sm,
                 [&](int b, int e, float v) { T2()[b * FS + e] = v; });
      gemm_r<BB>(T2(), FS, a.VyiT, n, m, m, sm, [&](int b, int e, float v) {
        const size_t i = b * FS + e;
        kb.R0[i] = v;
        kb.R[i] = v;
        kb.X[i] = 0.f;
        kb.BX[i] = 0.f;
        kb.P[i] = 0.f;
        kb.V[i] = 0.f;
      });
      float bb[BB], floor2[BB];
      member_sums<BB>(bb, nm, sm, [&](int b, int e) {
        const float v = kb.R0[b * FS + e];
        return v * v;
      });
#pragma unroll
      for (int b = 0; b < BB; ++b) floor2[b] = c.floor_fac * nan_max(bb[b], EPS_DIV);
      bicgstab_fixed<BB>(kb, nm, bb, floor2, a.n_trips, prec, apply_S, sm);
      // dphi = from_s(best x); dmu = 2 (Kpp dphi + Rphi)
      gemm_l<BB>(a.Vx, kb.BX, FS, n, n, m, sm,
                 [&](int b, int e, float v) { T1()[b * FS + e] = v; });
      gemm_r<BB>(T1(), FS, a.VyT, n, m, m, sm,
                 [&](int b, int e, float v) { dphi()[b * FS + e] = v; });
      lap_gemm<BB>(a.Lx, a.LyT, dphi(), FS, n, m, sm, [&](int b, int e, float l) {
        const size_t i = b * FS + e;
        const float kpp = -c.half_kappa * l + (tau_dt + dfield()[i]) * dphi()[i];
        dmu()[i] = 2.f * (kpp + rp[i]);
      });
    };

    // copy buffer set `from` into set `to` for the members flagged in `which`
    auto take = [&](int from, int to, const bool (&which)[BB]) {
      if (!any_of<BB>(which)) return;
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        if (!which[b]) continue;
        auto copy = [&](int f) {
          const float* src = F(F_QUAD + 4 * from + f) + b * FS;
          float* dst = F(F_QUAD + 4 * to + f) + b * FS;
          for (int e = tid; e < nm; e += NT) dst[e] = src[e];
        };
        if (LEAN) {                         // unrolled, this loop spills
#pragma unroll 1
          for (int f = 0; f < 4; ++f) copy(f);
        } else {
          for (int f = 0; f < 4; ++f) copy(f);
        }
      }
      __syncthreads();
    };

    // ---- Newton in masked lockstep: each member's own trip count ----
    float norm_R[BB], norm0[BB], prev[BB];
    bool done[BB];
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      norm_R[b] = 0.f;
      norm0[b] = prev[b] = INFINITY;
      done[b] = false;
    }
    for (int it = 0; it < a.max_iter; ++it) {
      if (it == 0) {
        resid(Q_CUR, norm_R);
#pragma unroll
        for (int b = 0; b < BB; ++b) norm0[b] = norm_R[b];
      }
      bool act[BB];
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        bool conv = norm_R[b] < c.newton_tol;
        if (c.newton_rtol > 0.f) conv = conv || norm_R[b] < c.newton_rtol * norm0[b];
        if (a.stagnation && it > 0) conv = conv || norm_R[b] >= prev[b];
        done[b] = done[b] || conv;
        act[b] = !done[b];
      }
      if (!any_of<BB>(act)) break;
      schur_solve();

      // step ceiling of each member
      float alpha[BB], mneg[BB];
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        const size_t o = b * FS;
        const float* phi = Qphi(Q_CUR) + o;
        float mp = INFINITY, mn = INFINITY;
        for (int e = tid; e < nm; e += NT) {
          const float dp = dphi()[o + e], ph = phi[e];
          mp = nan_min(mp, dp > 0.f ? (c.hi - ph) / dp : INFINITY);
          mn = nan_min(mn, dp < 0.f ? (c.lo - ph) / dp : INFINITY);
        }
        alpha[b] = mp;
        mneg[b] = mn;
      }
      block_min<BB>(alpha, sm);
      block_min<BB>(mneg, sm);
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        float amax = nan_min(2.f, nan_min(0.9f * alpha[b], 0.9f * mneg[b]));
        if (!isfinite(amax) || amax <= 0.f) amax = 1.f;
        alpha[b] = fminf(1.f, amax);
      }

      // Armijo on the residual norm, in lockstep over the active members;
      // every exit leaves the residual of the returned iterate in the
      // current set for the next Newton iteration
      float best_norm[BB], acc_norm[BB];
      bool searching[BB], accepted[BB];
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        best_norm[b] = INFINITY;
        acc_norm[b] = 0.f;
        searching[b] = act[b];
        accepted[b] = false;
      }
      for (int j = 0; j < 12 && any_of<BB>(searching); ++j) {
        const float *phi = Qphi(Q_CUR), *mu = Qmu(Q_CUR);
        float *tphi = Qphi(Q_TRIAL), *tmu = Qmu(Q_TRIAL);
#pragma unroll
        for (int b = 0; b < BB; ++b) {
          if (!searching[b]) continue;
          const size_t o = b * FS;
          for (int e = tid; e < nm; e += NT) {
            tphi[o + e] = phi[o + e] + alpha[b] * dphi()[o + e];
            tmu[o + e] = mu[o + e] + alpha[b] * dmu()[o + e];
          }
        }
        __syncthreads();
        float norm_t[BB];
        resid(Q_TRIAL, norm_t);
        bool to_best[BB], to_cur[BB];
#pragma unroll
        for (int b = 0; b < BB; ++b) {
          to_best[b] = to_cur[b] = false;
          if (!searching[b]) continue;
          if (norm_t[b] < best_norm[b]) {
            best_norm[b] = norm_t[b];
            to_best[b] = true;
          }
          if (norm_t[b] <= (1.f - 1e-4f * alpha[b]) * norm_R[b]) {
            accepted[b] = to_cur[b] = true;
            searching[b] = false;
            acc_norm[b] = norm_t[b];
            to_best[b] = false;           // taken now; the best set is moot
          } else {
            alpha[b] = alpha[b] * 0.5f;
          }
        }
        take(Q_TRIAL, Q_BEST, to_best);
        take(Q_TRIAL, Q_CUR, to_cur);
      }
      bool fallback[BB];
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        fallback[b] = false;
        if (!act[b]) continue;
        const float norm_prev = norm_R[b];
        if (accepted[b]) {
          norm_R[b] = acc_norm[b];
        } else if (best_norm[b] < norm_R[b]) {
          fallback[b] = true;
          norm_R[b] = best_norm[b];
        }
        prev[b] = norm_prev;
        ++nsolve_total[b];
      }
      take(Q_BEST, Q_CUR, fallback);
    }

    // ---- clip + interior mass correction + sanitizer ----
    const float *phn = Qphi(Q_CUR), *mun = Qmu(Q_CUR);
    float pmass[BB], pint[BB];
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const size_t o = b * FS;
      float sm_ = 0.f, si = 0.f;
      for (int e = tid; e < nm; e += NT) {
        const float pc = nan_clamp(phn[o + e], c.lo, c.hi);
        sm_ += wts[e] * pc;
        si += fabsf(pc) < c.interior_thr ? wts[e] : 0.f;
      }
      pmass[b] = sm_;
      pint[b] = si;
    }
    block_sum<BB>(pmass, sm);
    block_sum<BB>(pint, sm);
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const size_t o = b * FS;
      const float mass_error = pmass[b] - m0[b];
      const float Wint = pint[b];
      const bool needs_fix = fabsf(mass_error) > 1e-16f;
      const float shift_int = mass_error / Wint;
      const float shift_all = mass_error / c.area;
      float* frame = hist + b * HS + (size_t)(step + hoff) * nm;
      for (int e = tid; e < nm; e += NT) {
        float pc = nan_clamp(phn[o + e], c.lo, c.hi);
        if (needs_fix) {
          if (Wint > 0.f) {
            if (fabsf(pc) < c.interior_thr) pc = pc - shift_int;
          } else {
            pc = nan_clamp(pc - shift_all, c.lo, c.hi);
          }
        }
        phi_old()[o + e] = pc;
        frame[e] = pc;
        mu_old()[o + e] = mun[o + e];
        w_old()[o + e] = w_new()[o + e];
      }
      if (!isfinite(mass_error) && bad[b] < 0) bad[b] = step;
    }
    __syncthreads();
  }
  if (seg) {
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const size_t o = b * FS, g = (size_t)(b0 + b) * nm;
      for (int e = tid; e < nm; e += NT) {
        a.phi_f[g + e] = phi_old()[o + e];
        a.mu_f[g + e] = mu_old()[o + e];
        a.w_f[g + e] = w_old()[o + e];
      }
    }
  }
  if (tid == 0) {
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      a.nsolve[b0 + b] = nsolve_total[b];
      a.bad[b0 + b] = bad[b];
    }
  }
}

// One launch of the BB-member kernel: B / BB CTAs.
template <int BB, bool LEAN>
int launch_march(int B, MarchArgs k, cudaStream_t s) {
  march_kernel<BB, LEAN><<<B / BB, NT, 0, s>>>(k);
  return (int)cudaGetLastError();
}

// Compiled with -DVCH_BB=1 (ops/_build.py): the object holds both
// one-member kernels and the C entry points.
#ifndef VCH_BB
#define VCH_BB 1
#endif
#if VCH_BB == 1
template int launch_march<1, true>(int, MarchArgs, cudaStream_t);
#endif
template int launch_march<VCH_BB, false>(int, MarchArgs, cudaStream_t);

}  // namespace vch

#if VCH_BB == 1
namespace vch {

namespace {

// More CTAs than the current card has SMs: the lean one-member kernel runs
// two of them per SM.
bool more_ctas_than_sms(int ctas) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return false;
  return ctas > sms;
}

int launch(int bb, int B, const MarchArgs& a, const float* consts, int nconst,
           void* stream) {
  if (nconst != FWD_NCONST || B <= 0 || a.M <= 0 || a.n <= 1 || a.m <= 1 ||
      bb <= 0 || B % bb)
    return (int)cudaErrorInvalidValue;
  MarchArgs k = a;
  float* dst = reinterpret_cast<float*>(&k.c);
  for (int i = 0; i < FWD_NCONST; ++i) dst[i] = consts[i];
  const cudaStream_t s = (cudaStream_t)stream;
  switch (bb) {
    case 1: return more_ctas_than_sms(B) ? launch_march<1, true>(B, k, s)
                                         : launch_march<1, false>(B, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace vch

extern "C" int vch_workspace_fields(int which) {
  return which == 0 ? vch::FWD_FIELDS : vch::ADJ_FIELDS;
}

extern "C" const char* vch_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The whole march (block_b = 1; the member-blocked form is
// vch_march_fused_2d_blocked, march2d_blocked.cu). hist is (B, M+1, n, m)
// with phi0 first.
extern "C" int vch_march_fused_2d(
    const float* dts, const float* phi0, const float* u, const float* Lx,
    const float* LyT, const float* Vxi, const float* VyiT, const float* Vx,
    const float* VyT, const float* lam, const float* wts, float* hist,
    int* nsolve, int* first_bad, float* work, int B, int M, int n, int m,
    const float* consts, int nconst, int max_iter, int n_trips,
    int stagnation, int block_b, void* stream) {
  vch::MarchArgs a{dts, phi0, u, Lx, LyT, Vxi, VyiT, Vx, VyT, lam, wts,
                   nullptr, nullptr, nullptr, hist, nullptr, nullptr, nullptr,
                   nsolve, first_bad, work, M, n, m, max_iter, n_trips,
                   stagnation, {}};
  return vch::launch(block_b, B, a, consts, nconst, stream);
}

// One K-step segment with the (mu0, w0, global m0) carry in and (phi_f,
// mu_f, w_f) out; hist is (B, K, n, m), the post-step states only.
extern "C" int vch_march_fused_2d_segment(
    const float* dts, const float* phi0, const float* mu0, const float* w0,
    const float* m0, const float* u, const float* Lx, const float* LyT,
    const float* Vxi, const float* VyiT, const float* Vx, const float* VyT,
    const float* lam, const float* wts, float* hist, float* phi_f,
    float* mu_f, float* w_f, int* nsolve, int* first_bad, float* work, int B,
    int K, int n, int m, const float* consts, int nconst, int max_iter,
    int n_trips, int stagnation, void* stream) {
  vch::MarchArgs a{dts, phi0, u, Lx, LyT, Vxi, VyiT, Vx, VyT, lam, wts,
                   mu0, w0, m0, hist, phi_f, mu_f, w_f,
                   nsolve, first_bad, work, K, n, m, max_iter, n_trips,
                   stagnation, {}};
  return vch::launch(1, B, a, consts, nconst, stream);
}
#endif  // VCH_BB == 1
