// Whole batched 1D forward march of the viscous Cahn–Hilliard system.
//
// Replaces the TPU kernel vch_tpu/ops/pallas_march.py:1183 march_fused_1d
// (body _march1d_kernel_factory, :897-1180). Per time step and member: the w
// CN update, then the member's own Newton loop from (phi_old, mu_old) — CN
// residual, fixed-trip BiCGStab on the Schur system in the cosine basis
// (pointwise 1/denom preconditioner, best iterate, noise-floor freeze), the
// step ceiling min(1, 0.9 alpha_max), the 1D Armijo (eta 1e-3, in-bounds
// guard, trial step alpha0 0.5^j, at most 12 trials, no best-trial fallback:
// a failed line search ends that member's Newton loop) — then clip, the
// uniform mass projection and the first-bad-step sanitizer.
//
// The TPU kernel's grid is the time axis with the whole batch in each cell,
// so that its products are (B, n) x (n, n) tiles for the matrix unit, and its
// Newton and Armijo loops run in masked lockstep over the batch. Members are
// independent for the whole march, so here the grid is over members: a CTA
// walks all M steps for its G members (G = 1, 2 or 4) with their own Newton,
// Armijo and Krylov trip counts; within a CTA the G members run in masked
// lockstep, every predicate from a CTA-wide reduction that all threads
// receive identically. In the round that finds a member converged the TPU
// body still runs the Schur solve and discards it; a CTA whose members have
// all converged leaves the loop instead. An accepted trial's residual is the
// next round's residual (the same function of the same iterate), so it is
// handed on and not computed again.
//
// What bounds it on an H100: every product is a length-n vector times an
// (n, n) operator, 2 n^2 FLOP for 4 n^2 bytes of operator: at n = 513 each of
// the three operators is 1.05 MB, too large for shared memory, so they are
// read from L2 once per product and CTA. About 26 products per one-iteration
// step make the kernel bound by L2 traffic, not by FP32 rate; the G members
// of a CTA share each operator row they load, which divides that traffic by
// G. The wrapper's default G is the smallest that gives every CTA an SM of
// its own (B = 256 on 132 SMs: G = 2, 128 CTAs).
//
// Design of the product (vecmat): the G input vectors are staged in shared
// memory; warp w takes the operator's rows k = w, w + 8, ..., each read as
// coalesced 128-byte segments, four 32-column segments per pass, and keeps
// G x 4 partial sums per lane; the eight warps' partials are then added in
// warp order through shared memory. A member's sums are therefore taken in
// one fixed order whatever G is, so its history and counters do not depend
// on the grouping. Member state lives in a global workspace (slots, F1_COUNT,
// n), hot in L2; every product is full float32 FMA (no tensor cores, no
// TF32). A CTA's slots past the batch's end repeat the last member in a
// workspace of their own and write no output.
#include "common.cuh"

namespace vch {

struct Fwd1dConst {
  float tau, c1, two_c1, two_c2, neg_kappa, half_kappa, gamma;
  float log_lo, log_hi, lo, hi, Lx_len;
  float newton_tol, newton_rtol, floor_fac;
};
constexpr int FWD1D_NCONST = sizeof(Fwd1dConst) / sizeof(float);

// workspace field slots, n floats each
enum {
  G_PHI_OLD, G_MU_OLD, G_W_OLD, G_W_NEW, G_LMU_OLD, G_LPHI_OLD,
  G_QUAD,                         // 2 sets of (phi, mu, Rphi, Rmu)
  G_DPHI = G_QUAD + 8, G_DMU, G_D,
  G_X, G_R, G_P, G_V, G_R0, G_BX, G_S, G_T, G_PH, G_SH,
  G_T1,
  F1_COUNT
};
enum { S_CUR, S_TRIAL };          // the buffer sets

constexpr int SEG = 4;            // 32-column segments per pass
constexpr int CW = 32 * SEG;      // columns per pass

struct March1dArgs {
  const float *dts, *phi0, *u, *LT, *VinvT, *VT, *lam, *wts;
  float *hist, *nsolve, *bad, *work;
  int B, M, n, max_iter, n_trips, stagnation;
  Fwd1dConst c;
};

__device__ __forceinline__ float flog1d(float phi, const Fwd1dConst& c) {
  const float ph = nan_clamp(phi, c.log_lo, c.log_hi);
  return logf((1.f + ph) / (1.f - ph));
}

// y_g = v_g A for the CTA's G members: v_g = V + g * vs (n values), A (n, n)
// row-major, y_g[j] = sum_k v_g[k] A[k][j]; epi(g, j, y_g[j]) for every
// member and column. The inputs are staged in `sv` (G * n floats) first, so
// an epilogue may write the field the product reads. `part` holds
// NWARP * G * CW floats. Ends with __syncthreads().
template <int G, class Epi>
__device__ void vecmat(const float* V, size_t vs, const float* A, int n,
                       float* sv, float* part, Epi epi) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int g = 0; g < G; ++g)
    for (int e = tid; e < n; e += NT) sv[g * n + e] = V[g * vs + e];
  __syncthreads();
  for (int c0 = 0; c0 < n; c0 += CW) {
    float acc[G][SEG];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int s = 0; s < SEG; ++s) acc[g][s] = 0.f;
    const int j0 = c0 + lane;
#pragma unroll 4
    for (int k = warp; k < n; k += NWARP) {
      const float* row = A + (size_t)k * n + j0;
      float a[SEG];
#pragma unroll
      for (int s = 0; s < SEG; ++s)
        a[s] = (j0 + 32 * s < n) ? row[32 * s] : 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float x = sv[g * n + k];
#pragma unroll
        for (int s = 0; s < SEG; ++s) acc[g][s] = fmaf(x, a[s], acc[g][s]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int s = 0; s < SEG; ++s)
        part[(warp * G + g) * CW + lane + 32 * s] = acc[g][s];
    __syncthreads();
    for (int idx = tid; idx < G * CW; idx += NT) {
      const int g = idx / CW, jj = idx - g * CW, j = c0 + jj;
      if (j < n) {
        float y = 0.f;
#pragma unroll
        for (int w = 0; w < NWARP; ++w) y += part[(w * G + g) * CW + jj];
        epi(g, j, y);
      }
    }
    __syncthreads();
  }
}

template <int G>
__global__ void __launch_bounds__(NT) march1d_kernel(March1dArgs a) {
  __shared__ Smem sm;
  extern __shared__ float dyn[];
  const Fwd1dConst& c = a.c;
  const int tid = threadIdx.x, n = a.n, M = a.M;
  float* const sv = dyn;
  float* const part = dyn + G * n;
  const size_t FS = (size_t)F1_COUNT * n;   // member stride of a field
  const size_t HS = (size_t)(M + 1) * n;    // member stride of hist and u
  float* const W = a.work + (size_t)blockIdx.x * G * FS;
  auto F = [&](int slot) { return W + (size_t)slot * n; };
  float *phi_old = F(G_PHI_OLD), *mu_old = F(G_MU_OLD), *w_old = F(G_W_OLD),
        *w_new = F(G_W_NEW), *lmu_old = F(G_LMU_OLD),
        *lphi_old = F(G_LPHI_OLD), *dphi = F(G_DPHI), *dmu = F(G_DMU),
        *dfield = F(G_D), *T1 = F(G_T1);
  const KBufs kb{F(G_X), F(G_R), F(G_P), F(G_V), F(G_R0), F(G_BX),
                 F(G_S), F(G_T), F(G_PH), F(G_SH), FS};
  auto Qphi = [&](int q) { return F(G_QUAD + 4 * q); };
  auto Qmu = [&](int q) { return F(G_QUAD + 4 * q + 1); };
  auto Qrp = [&](int q) { return F(G_QUAD + 4 * q + 2); };
  auto Qrm = [&](int q) { return F(G_QUAD + 4 * q + 3); };
  const float* lam = a.lam;
  const float* wts = a.wts;
  auto lap = [&](const float* V, auto epi) {
    vecmat<G>(V, FS, a.LT, n, sv, part, epi);
  };
  auto to_s = [&](const float* V, auto epi) {
    vecmat<G>(V, FS, a.VinvT, n, sv, part, epi);
  };
  auto from_s = [&](const float* V, auto epi) {
    vecmat<G>(V, FS, a.VT, n, sv, part, epi);
  };

  // the CTA's members; a slot past the batch's end repeats the last member
  int mem[G];
  bool valid[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int b = blockIdx.x * G + g;
    valid[g] = b < a.B;
    mem[g] = valid[g] ? b : a.B - 1;
  }

  // ---- initial state: w0 = 0, mu0 = -kappa L phi0 + c1 f_log(phi0)
  // - 2 c2 phi0, m0 = sum(wts phi0) ----
  float m0[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const size_t o = g * FS;
    const float* p0 = a.phi0 + (size_t)mem[g] * n;
    float s = 0.f;
    for (int e = tid; e < n; e += NT) {
      const float ph = p0[e];
      phi_old[o + e] = ph;
      w_old[o + e] = 0.f;
      if (valid[g]) a.hist[mem[g] * HS + e] = ph;
      s += wts[e] * ph;
    }
    m0[g] = s;
  }
  block_sum<G>(m0, sm);
  lap(phi_old, [&](int g, int e, float l) {
    const size_t i = g * FS + e;
    const float ph = phi_old[i];
    mu_old[i] = c.neg_kappa * l + c.c1 * flog1d(ph, c) - c.two_c2 * ph;
  });

  int nsolve_total[G], bad[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    nsolve_total[g] = 0;
    bad[g] = -1;
  }

  for (int step = 0; step < M; ++step) {
    const float dt = a.dts[step];
    const float inv_dt = 1.f / dt;
    const float tau_dt = c.tau * inv_dt;
    const float gamma_dt = c.gamma * inv_dt;
    float *cphi = Qphi(S_CUR), *cmu = Qmu(S_CUR);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const size_t o = g * FS;
      const float* un = a.u + mem[g] * HS + (size_t)step * n;
      const float* unp1 = un + n;
      for (int e = tid; e < n; e += NT) {
        w_new[o + e] = ((gamma_dt - 0.5f) * w_old[o + e] +
                        0.5f * (unp1[e] + un[e])) / (gamma_dt + 0.5f);
        // the Newton iterate starts from (phi_old, mu_old)
        cphi[o + e] = phi_old[o + e];
        cmu[o + e] = mu_old[o + e];
      }
    }
    __syncthreads();
    lap(mu_old, [&](int g, int e, float l) { lmu_old[g * FS + e] = l; });
    lap(phi_old, [&](int g, int e, float l) { lphi_old[g * FS + e] = l; });

    // CN residuals of buffer set q vs the step's frozen old level; the
    // per-member norms land in norm
    auto resid = [&](int q, float (&norm)[G]) {
      const float *phi = Qphi(q), *mu = Qmu(q);
      float *rp = Qrp(q), *rm = Qrm(q);
      lap(mu, [&](int g, int e, float l) {
        const size_t i = g * FS + e;
        rm[i] = (phi[i] - phi_old[i]) * inv_dt - 0.5f * (l + lmu_old[i]);
      });
      lap(phi, [&](int g, int e, float l) {
        const size_t i = g * FS + e;
        const float ph = phi[i], po = phi_old[i];
        rp[i] = tau_dt * (ph - po) - c.half_kappa * (l + lphi_old[i]) +
                c.c1 * flog1d(ph, c) + (-c.two_c2 * po) -
                0.5f * (mu[i] + mu_old[i]) - 0.5f * (w_new[i] + w_old[i]);
      });
      float sp[G], sq[G];
      member_sums<G>(sp, n, sm, [&](int g, int e) {
        const float v = rp[g * FS + e];
        return v * v;
      });
      member_sums<G>(sq, n, sm, [&](int g, int e) {
        const float v = rm[g * FS + e];
        return v * v;
      });
#pragma unroll
      for (int g = 0; g < G; ++g) norm[g] = sqrtf(sp[g] + sq[g]);
    };

    auto poly = [&](int e) {
      const float l = lam[e];
      return (inv_dt - tau_dt * l) + (c.half_kappa * l) * l;
    };

    // Schur solve in the cosine basis -> (dphi, dmu) of the current set
    auto schur_solve = [&]() {
      const float *phi = Qphi(S_CUR), *rp = Qrp(S_CUR), *rm = Qrm(S_CUR);
      float dbar[G];
      member_sums<G>(dbar, n, sm, [&](int g, int e) {
        const size_t i = g * FS + e;
        const float ph = phi[i];
        const float d = c.two_c1 / (1.f - ph * ph);
        dfield[i] = d;
        return d;
      });
#pragma unroll
      for (int g = 0; g < G; ++g) dbar[g] = dbar[g] / (float)n;
      auto prec = [&](int g, int e, float v) {
        return v / (poly(e) - dbar[g] * lam[e]);
      };
      // S yh = poly yh - lam to_s(d from_s(yh))
      auto apply_S = [&](const float* Y, float* OUT) {
        from_s(Y, [&](int g, int e, float v) {
          T1[g * FS + e] = dfield[g * FS + e] * v;
        });
        to_s(T1, [&](int g, int e, float v) {
          const size_t i = g * FS + e;
          OUT[i] = poly(e) * Y[i] - lam[e] * v;
        });
      };
      // b = to_s(L Rphi - Rmu); x0 = 0
      lap(rp, [&](int g, int e, float l) {
        const size_t i = g * FS + e;
        T1[i] = l - rm[i];
      });
      to_s(T1, [&](int g, int e, float v) {
        const size_t i = g * FS + e;
        kb.R0[i] = v;
        kb.R[i] = v;
        kb.X[i] = 0.f;
        kb.BX[i] = 0.f;
        kb.P[i] = 0.f;
        kb.V[i] = 0.f;
      });
      float bb[G], floor2[G];
      member_sums<G>(bb, n, sm, [&](int g, int e) {
        const float v = kb.R0[g * FS + e];
        return v * v;
      });
#pragma unroll
      for (int g = 0; g < G; ++g)
        floor2[g] = c.floor_fac * nan_max(bb[g], EPS_DIV);
      bicgstab_fixed<G>(kb, n, bb, floor2, a.n_trips, prec, apply_S, sm);
      // dphi = from_s(best x); dmu = 2 (Kpp dphi + Rphi)
      from_s(kb.BX, [&](int g, int e, float v) { dphi[g * FS + e] = v; });
      lap(dphi, [&](int g, int e, float l) {
        const size_t i = g * FS + e;
        const float kpp = -c.half_kappa * l + (tau_dt + dfield[i]) * dphi[i];
        dmu[i] = 2.f * (kpp + rp[i]);
      });
    };

    // ---- Newton in masked lockstep: each member's own trip count ----
    float norm_R[G], norm0[G], prev[G];
    bool done[G];
    resid(S_CUR, norm_R);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      norm0[g] = norm_R[g];
      prev[g] = INFINITY;
      done[g] = false;
    }
    for (int it = 0; it < a.max_iter; ++it) {
      bool act[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        bool conv = norm_R[g] < c.newton_tol;
        if (c.newton_rtol > 0.f)
          conv = conv || norm_R[g] < c.newton_rtol * norm0[g];
        if (a.stagnation && it > 0) conv = conv || norm_R[g] >= prev[g];
        done[g] = done[g] || conv;
        act[g] = !done[g];
      }
      if (!any_of<G>(act)) break;
      schur_solve();

      // step ceiling: alpha0 = min(1, 0.9 alpha_max), 1 when alpha_max is
      // not finite or not positive
      float alpha0[G], mneg[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const size_t o = g * FS;
        float mp = INFINITY, mn = INFINITY;
        for (int e = tid; e < n; e += NT) {
          const float dp = dphi[o + e], ph = cphi[o + e];
          mp = nan_min(mp, dp > 0.f ? (c.hi - ph) / dp : INFINITY);
          mn = nan_min(mn, dp < 0.f ? (c.lo - ph) / dp : INFINITY);
        }
        alpha0[g] = mp;
        mneg[g] = mn;
      }
      block_min<G>(alpha0, sm);
      block_min<G>(mneg, sm);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float amax = nan_min(alpha0[g], mneg[g]);
        if (!isfinite(amax) || amax <= 0.f) amax = 1.f;
        alpha0[g] = fminf(1.f, 0.9f * amax);
      }

      // Armijo on the residual norm, in lockstep over the active members
      float acc_norm[G];
      bool searching[G], accepted[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        acc_norm[g] = 0.f;
        searching[g] = act[g];
        accepted[g] = false;
      }
      float fac = 1.f;
      for (int j = 0; j < 12 && any_of<G>(searching); ++j) {
        float *tphi = Qphi(S_TRIAL), *tmu = Qmu(S_TRIAL);
        float alpha[G], outside[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          alpha[g] = alpha0[g] * fac;
          float cnt = 0.f;
          if (searching[g]) {
            const size_t o = g * FS;
            for (int e = tid; e < n; e += NT) {
              const float pt = cphi[o + e] + alpha[g] * dphi[o + e];
              tphi[o + e] = pt;
              tmu[o + e] = cmu[o + e] + alpha[g] * dmu[o + e];
              cnt += fabsf(pt) < c.hi ? 0.f : 1.f;   // NaN counts as outside
            }
          }
          outside[g] = cnt;
        }
        block_sum<G>(outside, sm);     // also orders the trial set's writes
        float norm_t[G];
        resid(S_TRIAL, norm_t);
        bool any_taken = false;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (!searching[g]) continue;
          if (outside[g] == 0.f &&
              norm_t[g] <= (1.f - 1e-3f * alpha[g]) * norm_R[g]) {
            accepted[g] = true;
            searching[g] = false;
            acc_norm[g] = norm_t[g];
            any_taken = true;
            const size_t o = g * FS;     // the trial set becomes the current
            for (int f = 0; f < 4; ++f) {
              const float* src = F(G_QUAD + 4 * S_TRIAL + f) + o;
              float* dst = F(G_QUAD + 4 * S_CUR + f) + o;
              for (int e = tid; e < n; e += NT) dst[e] = src[e];
            }
          }
        }
        if (any_taken) __syncthreads();
        fac *= 0.5f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (!act[g]) continue;
        ++nsolve_total[g];
        prev[g] = norm_R[g];
        if (accepted[g])
          norm_R[g] = acc_norm[g];
        else
          done[g] = true;       // a failed line search ends the Newton loop
      }
    }

    // ---- clip + uniform mass projection + sanitizer ----
    float pmass[G];
    member_sums<G>(pmass, n, sm, [&](int g, int e) {
      return wts[e] * nan_clamp(cphi[g * FS + e], c.lo, c.hi);
    });
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const size_t o = g * FS;
      const float mass_error = pmass[g] - m0[g];
      const float shift = mass_error / c.Lx_len;
      float* frame = a.hist + mem[g] * HS + (size_t)(step + 1) * n;
      for (int e = tid; e < n; e += NT) {
        const float pc = nan_clamp(cphi[o + e], c.lo, c.hi) - shift;
        phi_old[o + e] = pc;
        if (valid[g]) frame[e] = pc;
        mu_old[o + e] = cmu[o + e];
        w_old[o + e] = w_new[o + e];
      }
      if (!isfinite(mass_error) && bad[g] < 0) bad[g] = step;
    }
    __syncthreads();
  }
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (!valid[g]) continue;
      a.nsolve[mem[g]] = (float)nsolve_total[g];
      a.bad[mem[g]] = (float)bad[g];
    }
  }
}

template <int G>
int launch_march1d(const March1dArgs& k, cudaStream_t s) {
  const size_t bytes = sizeof(float) * ((size_t)G * k.n + (size_t)NWARP * G * CW);
  if (bytes > 200 * 1024) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        march1d_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  march1d_kernel<G><<<(k.B + G - 1) / G, NT, bytes, s>>>(k);
  return (int)cudaGetLastError();
}

namespace {

// The smallest group that gives every CTA an SM of its own, 4 beyond that.
int auto_group(int B) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms <= 0)
    return 1;
  if (B <= sms) return 1;
  return (B + 1) / 2 <= sms ? 2 : 4;
}

}  // namespace
}  // namespace vch

extern "C" int vch_march_1d_workspace_fields() { return vch::F1_COUNT; }

// The whole batched 1D march. u is (B, M+1, n) in core layout, hist
// (B, M+1, n) with phi0 first; nsolve and first_bad are (B,) float32; work
// holds ceil(B / 4) * 4 * vch_march_1d_workspace_fields() fields of n floats.
// group: members per CTA (1, 2 or 4), or 0 for the automatic choice.
extern "C" int vch_march_fused_1d(
    const float* dts, const float* phi0, const float* u, const float* LT,
    const float* VinvT, const float* VT, const float* lam, const float* wts,
    float* hist, float* nsolve, float* first_bad, float* work, int B, int M,
    int n, const float* consts, int nconst, int max_iter, int n_trips,
    int stagnation, int group, void* stream) {
  if (nconst != vch::FWD1D_NCONST || B <= 0 || M <= 0 || n <= 1 ||
      max_iter < 0 || n_trips < 0)
    return (int)cudaErrorInvalidValue;
  vch::March1dArgs a{dts, phi0, u, LT, VinvT, VT, lam, wts, hist, nsolve,
                     first_bad, work, B, M, n, max_iter, n_trips, stagnation,
                     {}};
  float* dst = reinterpret_cast<float*>(&a.c);
  for (int i = 0; i < vch::FWD1D_NCONST; ++i) dst[i] = consts[i];
  const cudaStream_t s = (cudaStream_t)stream;
  switch (group == 0 ? vch::auto_group(B) : group) {
    case 1: return vch::launch_march1d<1>(a, s);
    case 2: return vch::launch_march1d<2>(a, s);
    case 4: return vch::launch_march1d<4>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
