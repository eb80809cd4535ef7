// Whole batched 2D forward march of the viscous Cahn–Hilliard system.
//
// Replaces the TPU kernel vch_tpu/ops/pallas_march.py:393 march_fused_2d
// (body _march_kernel_factory, :79-390). Per time step and member: the w CN
// update and mu_init, then the member's own Newton loop — dense-stencil CN
// residual, fixed-trip BiCGStab on the Schur system in the cosine basis
// (best iterate, noise-floor freeze), step ceiling, Armijo with at most 12
// halvings, best-trial fallback and the hand-off of the returned iterate's
// residual — then clip, interior mass correction and the first-bad-step
// sanitizer.
//
// What bounds it on an H100: dependent dense (n x n)(n x m) products, about
// 40 per Newton iteration, each 2.1 MFMA at n = m = 129, in a strictly
// sequential chain (every Krylov scalar and loop predicate needs the previous
// product), and the ~33 fields of per-member state: one 129 x 129 float32
// field is 66.6 KB while a CTA has at most 227 KB of shared memory.
//
// Design: one CTA per member walks the whole time loop (the TPU's sequential
// (member, step) grid becomes a loop inside the CTA; at config 4, B = 128
// members fill 128 of the 132 SMs in one wave). Member state lives in a
// global workspace (B, FWD_FIELDS, n, m) allocated by the wrapper, hot in L1/L2;
// the six operator matrices (~400 KB) are shared by all CTAs from L2.
// Products are SIMT FP32 FMA through 48 x 48 shared-memory tiles (ragged
// edges masked; no tensor cores, no TF32). Every predicate comes from a
// CTA-wide reduction that all threads receive identically. Candidate
// iterates of Armijo rotate through three buffer sets by index, so no
// accepted or best trial is copied. Line-search buckets of 8-16 members
// leave most SMs idle; spreading one member over a thread-block cluster is
// later work.
#include "common.cuh"

namespace vch {
namespace {

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

__device__ __forceinline__ float flog(float phi, const FwdConst& c) {
  const float ph = nan_clamp(phi, c.log_lo, c.log_hi);
  return logf((1.f + ph) / (1.f - ph));
}

struct Ops {
  const float *Lx, *LyT, *Vxi, *VyiT, *Vx, *VyT, *lam, *wts;
};

__global__ void __launch_bounds__(NT)
march_kernel(const float* dts, const float* phi0, const float* u, Ops op,
             float* hist, int* nsolve_out, int* bad_out, float* work, int M,
             int n, int m, FwdConst c, int max_iter, int n_trips,
             int stagnation) {
  __shared__ Smem sm;
  const int b = blockIdx.x, tid = threadIdx.x, nm = n * m;
  float* W = work + (size_t)b * F_COUNT * nm;
  auto F = [&](int slot) { return W + (size_t)slot * nm; };
  float *phi_old = F(F_PHI_OLD), *mu_old = F(F_MU_OLD), *w_old = F(F_W_OLD);
  float *w_new = F(F_W_NEW), *lmu_old = F(F_LMU_OLD), *lphi_old = F(F_LPHI_OLD);
  float *dphi = F(F_DPHI), *dmu = F(F_DMU), *dfield = F(F_D);
  float *T1 = F(F_T1), *T2 = F(F_T2);
  const KBufs kb{F(F_X), F(F_R), F(F_P), F(F_V), F(F_R0), F(F_BX),
                 F(F_S), F(F_T), F(F_PH), F(F_SH)};
  auto Qphi = [&](int q) { return F(F_QUAD + 4 * q); };
  auto Qmu = [&](int q) { return F(F_QUAD + 4 * q + 1); };
  auto Qrp = [&](int q) { return F(F_QUAD + 4 * q + 2); };
  auto Qrm = [&](int q) { return F(F_QUAD + 4 * q + 3); };
  const float* p0 = phi0 + (size_t)b * nm;
  const float* ub = u + (size_t)b * (M + 1) * nm;
  float* hb = hist + (size_t)b * (M + 1) * nm;
  const float* lam = op.lam;
  const float* wts = op.wts;

  // ---- initial state: w0 = 0, mu0 = -kappa L phi0 + f'(phi0), m0 ----
  float part = 0.f;
  for (int e = tid; e < nm; e += NT) {
    const float ph = p0[e];
    phi_old[e] = ph;
    hb[e] = ph;
    w_old[e] = 0.f;
    part += wts[e] * ph;
  }
  const float m0 = block_sum(part, sm);
  lap_gemm(op.Lx, op.LyT, phi_old, n, m, sm, [&](int e, float l) {
    const float ph = phi_old[e];
    mu_old[e] = c.neg_kappa * l + c.c1 * flog(ph, c) - c.two_c2 * ph;
  });

  int nsolve_total = 0, bad = -1;
  int qc = 0, qt = 1, qb = 2;          // current / trial / best buffer sets

  for (int step = 0; step < M; ++step) {
    const float dt = dts[step];
    const float inv_dt = 1.f / dt;
    const float tau_dt = c.tau * inv_dt;
    const float gamma_dt = c.gamma * inv_dt;
    const float* un = ub + (size_t)step * nm;
    const float* unp1 = un + nm;
    for (int e = tid; e < nm; e += NT)
      w_new[e] = ((gamma_dt - 0.5f) * w_old[e] + 0.5f * (unp1[e] + un[e])) /
                 (gamma_dt + 0.5f);
    __syncthreads();
    lap_gemm(op.Lx, op.LyT, mu_old, n, m, sm,
             [&](int e, float l) { lmu_old[e] = l; });
    {
      float *qphi = Qphi(qc), *qmu = Qmu(qc);
      lap_gemm(op.Lx, op.LyT, phi_old, n, m, sm, [&](int e, float l) {
        const float ph = phi_old[e];
        lphi_old[e] = l;
        qphi[e] = ph;
        qmu[e] = c.neg_kappa * l + c.c1 * flog(ph, c) - c.two_c2 * ph -
                 w_new[e];
      });
    }

    // CN residuals of buffer set q vs the step's frozen old level
    auto resid = [&](int q) {
      const float *phi = Qphi(q), *mu = Qmu(q);
      float *rp = Qrp(q), *rm = Qrm(q);
      float pm = 0.f, pp = 0.f;
      lap_gemm(op.Lx, op.LyT, mu, n, m, sm, [&](int e, float l) {
        const float v = (phi[e] - phi_old[e]) * inv_dt - 0.5f * (l + lmu_old[e]);
        rm[e] = v;
        pm += v * v;
      });
      lap_gemm(op.Lx, op.LyT, phi, n, m, sm, [&](int e, float l) {
        const float ph = phi[e], po = phi_old[e];
        const float v = tau_dt * (ph - po) - c.half_kappa * (l + lphi_old[e]) +
                        c.c1 * flog(ph, c) + (-c.two_c2 * po) -
                        0.5f * (mu[e] + mu_old[e]) - 0.5f * (w_new[e] + w_old[e]);
        rp[e] = v;
        pp += v * v;
      });
      const float sp = block_sum(pp, sm);
      const float sm2 = block_sum(pm, sm);
      return sqrtf(sp + sm2);
    };

    // Schur solve in the cosine basis -> (dphi, dmu) for buffer set q
    auto schur_solve = [&](int q) {
      const float *phi = Qphi(q), *rp = Qrp(q), *rm = Qrm(q);
      float pd = 0.f;
      for (int e = tid; e < nm; e += NT) {
        const float ph = phi[e];
        const float d = c.two_c1 / (1.f - nan_clamp(ph * ph, 0.f, c.dsep2));
        dfield[e] = d;
        pd += d;
      }
      const float dbar = block_sum(pd, sm) / (float)nm;
      auto poly = [&](int e) {
        const float l = lam[e];
        return (inv_dt - tau_dt * l) + (c.half_kappa * l) * l;
      };
      auto prec = [&](int e, float v) { return v / (poly(e) - dbar * lam[e]); };
      auto apply_S = [&](const float* Y, float* OUT, auto&& f) {
        gemm(op.Vx, Y, n, n, m, sm, [&](int e, float a) { T1[e] = a; });
        gemm(T1, op.VyT, n, m, m, sm,
             [&](int e, float a) { T2[e] = dfield[e] * a; });
        gemm(op.Vxi, T2, n, n, m, sm, [&](int e, float a) { T1[e] = a; });
        gemm(T1, op.VyiT, n, m, m, sm, [&](int e, float a) {
          const float o = poly(e) * Y[e] - lam[e] * a;
          OUT[e] = o;
          f(e, o);
        });
      };
      // b = to_s(L Rphi - Rmu); x0 = 0
      lap_gemm(op.Lx, op.LyT, rp, n, m, sm,
               [&](int e, float l) { T1[e] = l - rm[e]; });
      gemm(op.Vxi, T1, n, n, m, sm, [&](int e, float a) { T2[e] = a; });
      float pb = 0.f;
      gemm(T2, op.VyiT, n, m, m, sm, [&](int e, float a) {
        kb.R0[e] = a;
        kb.R[e] = a;
        kb.X[e] = 0.f;
        kb.BX[e] = 0.f;
        kb.P[e] = 0.f;
        kb.V[e] = 0.f;
        pb += a * a;
      });
      const float bb = block_sum(pb, sm);
      const float floor2 = c.floor_fac * nan_max(bb, EPS_DIV);
      bicgstab_fixed(kb, nm, bb, floor2, n_trips, prec, apply_S, sm);
      // dphi = from_s(best x); dmu = 2 (Kpp dphi + Rphi)
      gemm(op.Vx, kb.BX, n, n, m, sm, [&](int e, float a) { T1[e] = a; });
      gemm(T1, op.VyT, n, m, m, sm, [&](int e, float a) { dphi[e] = a; });
      lap_gemm(op.Lx, op.LyT, dphi, n, m, sm, [&](int e, float l) {
        const float kpp = -c.half_kappa * l + (tau_dt + dfield[e]) * dphi[e];
        dmu[e] = 2.f * (kpp + rp[e]);
      });
    };

    auto step_ceiling = [&](int q) {
      const float* phi = Qphi(q);
      float mp = INFINITY, mn = INFINITY;
      for (int e = tid; e < nm; e += NT) {
        const float dp = dphi[e], ph = phi[e];
        mp = nan_min(mp, dp > 0.f ? (c.hi - ph) / dp : INFINITY);
        mn = nan_min(mn, dp < 0.f ? (c.lo - ph) / dp : INFINITY);
      }
      const float min_pos = block_min(mp, sm);
      const float min_neg = block_min(mn, sm);
      float amax = nan_min(2.f, nan_min(0.9f * min_pos, 0.9f * min_neg));
      if (!isfinite(amax) || amax <= 0.f) amax = 1.f;
      return fminf(1.f, amax);
    };

    // ---- Newton: this member's own trip count ----
    float norm_R = 0.f, norm0 = INFINITY, prev = INFINITY;
    int it = 0;
    while (it < max_iter) {
      if (it == 0) {
        norm_R = resid(qc);
        norm0 = norm_R;
      }
      bool conv = norm_R < c.newton_tol;
      if (c.newton_rtol > 0.f) conv = conv || norm_R < c.newton_rtol * norm0;
      if (stagnation && it > 0) conv = conv || norm_R >= prev;
      if (conv) break;
      schur_solve(qc);

      // Armijo on the residual norm; every exit keeps the residual of the
      // returned iterate in its buffer set for the next Newton iteration
      float alpha = step_ceiling(qc);
      float best_norm = INFINITY, acc_norm = 0.f;
      int q_acc = -1;
      for (int j = 0; j < 12; ++j) {
        const float *phi = Qphi(qc), *mu = Qmu(qc);
        float *tphi = Qphi(qt), *tmu = Qmu(qt);
        for (int e = tid; e < nm; e += NT) {
          tphi[e] = phi[e] + alpha * dphi[e];
          tmu[e] = mu[e] + alpha * dmu[e];
        }
        __syncthreads();
        const float norm_t = resid(qt);
        int q_last = qt;
        if (norm_t < best_norm) {
          best_norm = norm_t;
          const int tmp = qt; qt = qb; qb = tmp;
          q_last = qb;
        }
        if (norm_t <= (1.f - 1e-4f * alpha) * norm_R) {
          q_acc = q_last;
          acc_norm = norm_t;
          break;
        }
        alpha = alpha * 0.5f;
      }
      const float norm_prev = norm_R;
      if (q_acc >= 0) {
        if (q_acc == qt) { const int tmp = qc; qc = qt; qt = tmp; }
        else { const int tmp = qc; qc = qb; qb = tmp; }
        norm_R = acc_norm;
      } else if (best_norm < norm_R) {
        const int tmp = qc; qc = qb; qb = tmp;
        norm_R = best_norm;
      }
      prev = norm_prev;
      ++nsolve_total;
      ++it;
    }

    // ---- clip + interior mass correction + sanitizer ----
    const float *phn = Qphi(qc), *mun = Qmu(qc);
    float pmass = 0.f, pint = 0.f;
    for (int e = tid; e < nm; e += NT) {
      const float pc = nan_clamp(phn[e], c.lo, c.hi);
      pmass += wts[e] * pc;
      pint += fabsf(pc) < c.interior_thr ? wts[e] : 0.f;
    }
    const float mass_error = block_sum(pmass, sm) - m0;
    const float Wint = block_sum(pint, sm);
    const bool needs_fix = fabsf(mass_error) > 1e-16f;
    const float shift_int = mass_error / Wint;
    const float shift_all = mass_error / c.area;
    float* frame = hb + (size_t)(step + 1) * nm;
    for (int e = tid; e < nm; e += NT) {
      float pc = nan_clamp(phn[e], c.lo, c.hi);
      if (needs_fix) {
        if (Wint > 0.f) {
          if (fabsf(pc) < c.interior_thr) pc = pc - shift_int;
        } else {
          pc = nan_clamp(pc - shift_all, c.lo, c.hi);
        }
      }
      phi_old[e] = pc;
      frame[e] = pc;
      mu_old[e] = mun[e];
      w_old[e] = w_new[e];
    }
    __syncthreads();
    if (!isfinite(mass_error) && bad < 0) bad = step;
  }
  if (tid == 0) {
    nsolve_out[b] = nsolve_total;
    bad_out[b] = bad;
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

extern "C" int vch_march_fused_2d(
    const float* dts, const float* phi0, const float* u, const float* Lx,
    const float* LyT, const float* Vxi, const float* VyiT, const float* Vx,
    const float* VyT, const float* lam, const float* wts, float* hist,
    int* nsolve, int* first_bad, float* work, int B, int M, int n, int m,
    const float* consts, int nconst, int max_iter, int n_trips,
    int stagnation, void* stream) {
  using namespace vch;
  if (nconst != FWD_NCONST || B <= 0 || M <= 0 || n <= 1 || m <= 1)
    return (int)cudaErrorInvalidValue;
  FwdConst c;
  float* dst = reinterpret_cast<float*>(&c);
  for (int i = 0; i < FWD_NCONST; ++i) dst[i] = consts[i];
  const Ops op{Lx, LyT, Vxi, VyiT, Vx, VyT, lam, wts};
  march_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(
      dts, phi0, u, op, hist, nsolve, first_bad, work, M, n, m, c, max_iter,
      n_trips, stagnation);
  return (int)cudaGetLastError();
}
