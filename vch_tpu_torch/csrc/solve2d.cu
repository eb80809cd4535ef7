// The per-solve kernels of the 2D scan path: one whole fixed-trip BiCGStab
// solve per CTA, one CTA per member of a (B, n, m) batch.
//
// Replaces four TPU kernels of vch_tpu/ops/pallas_kernels.py, each one
// pallas_call per solve (vmap over members):
//   - :691 bicgstab_schur_spectral_pallas (body :601-688): the Newton Schur
//     solve S dphi = rhs in the cosine basis, x0 = 0; the preconditioner
//     is the pointwise divide by denom, each operator apply 4 products;
//   - :233 bicgstab_schur_pallas (body :150-230): the same solve in the raw
//     basis, preconditioner through the transforms (4 products) and the
//     Schur operator as two Laplacians (4 products);
//   - :798 bicgstab_adjoint_spectral_pallas (body :712-795): the
//     split-preconditioned adjoint step solve A(phi_n) p = rhs in the cosine
//     basis, warm started from x0, each apply 4 products;
//   - :581 bicgstab_adjoint_pallas (body :490-578): the same in the raw
//     basis, each apply P^-1/2 A P^-1/2 as 12 products;
// the solvers run all four on solve2d_cluster.cu's cluster kernels, and
// these four are only their bit oracles; and the two cost probes of
// scripts/diag_kernel_cost.py, which time the raw Schur solve (the
// script's "full", :65) in parts, now also only the bit oracles of their
// cluster kernels in solve2d_cluster.cu:
//   - :131 nodots: the raw Schur solve's trips with every block dot product
//     replaced by the constant 0.5, no freeze and no best iterate: its
//     products and elementwise passes without its block reductions;
//   - :176 mmonly: the chain v <- M(S(M(S(v)))) n_iter times, S the raw
//     Schur apply (4 products) and M the spectral preconditioner (4
//     products): the products alone, 16 per link as per trip of the solve.
// Each computes what the Pallas body computes: n_iter trips, the
// (50 eps)^2 max(||b||^2, 1e-30) noise-floor freeze, rejection of a
// non-finite new residual, the best iterate; the spectral forms transform
// the right-hand side, the warm start and the solution once, inside the
// kernel. A frozen or rejected trip of the Pallas loop repeats unchanged
// until the trip budget ends, so the kernel leaves the loop there (the
// generic bicgstab_fixed of common.cuh). Every product is full float32 FMA.
//
// What bounds it on an H100: a chain of dependent (n x n) x (n x m)
// products (8 per trip in the spectral forms, 16 and 24 in the raw ones)
// with a CTA-wide reduction between most of them; at n = m = 65 a spectral
// Schur solve of 4 trips is ~20 MFLOP, far below what one launch's fixed
// latency lets any kernel use, and a config-3 solve is one member: one
// CTA on one of the 132 SMs.
//
// Design: the one-member CTA of march2d.cu and adjoint2d.cu (common.cuh):
// the Krylov vectors in a global workspace (B, SOLVE_FIELDS, n, m),
// operators shared from L2, SIMT FP32 products through 48 x 48
// shared-memory tiles with fused elementwise epilogues, CTA-uniform
// predicates from block reductions. The raw Schur solve's preconditioner is
// not pointwise, so its elementwise preconditioner is the identity copy
// (P -> PH) and its operator functor first applies M^-1 to that copy in
// place (PH then holds phat, which the iterate update reads), then S.
#include "common.cuh"

namespace vch {

enum {
  K_X, K_R, K_P, K_V, K_R0, K_BX, K_S, K_T, K_PH, K_SH, K_T1, K_T2, K_Z,
  K_COUNT
};
constexpr int SOLVE_FIELDS = K_COUNT;

enum { SCHUR_SPECTRAL = 0, SCHUR_RAW = 1, ADJOINT_SPECTRAL = 2,
       ADJOINT_RAW = 3, SCHUR_NODOTS = 4, SCHUR_MMONLY = 5 };

struct SolveArgs {
  const float* scal;                    // Schur: inv_dt, tau_dt, kappa/2;
                                        // adjoint: tau, dt/2
  const float *Lx, *LyT, *Vxi, *VyiT, *Vx, *VyT, *lam;
  const float *f1, *f2, *rhs, *x0;      // Schur: denom, d; adjoint: isd, f''
  float *out, *work;
  int n, m, n_iter;
  float floor_fac;
};

// epi(e, (Vxi V VyiT)[e]) through the scratch field T1 (V must not be T1)
template <class Epi>
__device__ void to_s(const SolveArgs& a, const float* V, float* T1, Smem& sm,
                     Epi epi) {
  gemm_l<1>(a.Vxi, V, 0, a.n, a.n, a.m, sm,
            [&](int, int e, float v) { T1[e] = v; });
  gemm_r<1>(T1, 0, a.VyiT, a.n, a.m, a.m, sm,
            [&](int, int e, float v) { epi(e, v); });
}

// epi(e, (Vx V VyT)[e]) through T1
template <class Epi>
__device__ void from_s(const SolveArgs& a, const float* V, float* T1,
                       Smem& sm, Epi epi) {
  gemm_l<1>(a.Vx, V, 0, a.n, a.n, a.m, sm,
            [&](int, int e, float v) { T1[e] = v; });
  gemm_r<1>(T1, 0, a.VyT, a.n, a.m, a.m, sm,
            [&](int, int e, float v) { epi(e, v); });
}

// The Schur solves (VAR = SCHUR_SPECTRAL or SCHUR_RAW) of solve_kernel, on
// the CTA's member; F(slot) is the member's workspace field.
template <int VAR, class Slot>
__device__ void solve_schur(const SolveArgs& a, const KBufs& kb, Slot F,
                            Smem& sm) {
  const int tid = threadIdx.x, n = a.n, m = a.m, nm = n * m;
  const size_t mo = (size_t)blockIdx.x * nm;
  float *T1 = F(K_T1), *T2 = F(K_T2);
  const float *denom = a.f1 + mo, *d = a.f2 + mo, *rhs = a.rhs + mo;
  float* out = a.out + mo;
  const float* lam = a.lam;
  const float inv_dt = a.scal[0], tau_dt = a.scal[1], hk = a.scal[2];
  float r2[1], floor2[1];
  // b (spectral: to_s(rhs)) into R0; x0 = 0, so r0 = b
  auto init = [&](int e, float b) {
    kb.R0[e] = b;
    kb.R[e] = b;
    kb.X[e] = 0.f;
    kb.P[e] = 0.f;
    kb.V[e] = 0.f;
    kb.BX[e] = 0.f;
  };
  if constexpr (VAR == SCHUR_SPECTRAL) {
    to_s(a, rhs, T1, sm, init);
  } else {
    for (int e = tid; e < nm; e += NT) init(e, rhs[e]);
  }
  member_sums<1>(r2, nm, sm, [&](int, int e) {
    const float v = kb.R0[e];
    return v * v;
  });
  floor2[0] = a.floor_fac * nan_max(r2[0], EPS_DIV);
  if constexpr (VAR == SCHUR_SPECTRAL) {
    // Shat y = poly y - lam to_s(d from_s(y)), preconditioner y / denom
    auto apply = [&](float* Y, float* OUT) {
      from_s(a, Y, T1, sm, [&](int e, float v) { T2[e] = d[e] * v; });
      to_s(a, T2, T1, sm, [&](int e, float v) {
        const float l = lam[e];
        const float poly = (inv_dt - tau_dt * l) + (hk * l) * l;
        OUT[e] = poly * Y[e] - l * v;
      });
    };
    bicgstab_fixed<1>(kb, nm, r2, floor2, a.n_iter,
                      [&](int, int e, float v) { return v / denom[e]; },
                      apply, sm);
    from_s(a, kb.BX, T1, sm, [&](int e, float v) { out[e] = v; });
  } else {
    // Y <- M^-1 Y = from_s(to_s(Y) / denom), then
    // OUT = S Y = inv_dt Y - L((tau_dt + d) Y - (kappa/2) L Y)
    auto apply = [&](float* Y, float* OUT) {
      to_s(a, Y, T1, sm, [&](int e, float v) { T2[e] = v / denom[e]; });
      from_s(a, T2, T1, sm, [&](int e, float v) { Y[e] = v; });
      lap_gemm<1>(a.Lx, a.LyT, Y, 0, n, m, sm, [&](int, int e, float l) {
        T2[e] = (tau_dt + d[e]) * Y[e] - hk * l;
      });
      lap_gemm<1>(a.Lx, a.LyT, T2, 0, n, m, sm, [&](int, int e, float l) {
        OUT[e] = inv_dt * Y[e] - l;
      });
    };
    bicgstab_fixed<1>(kb, nm, r2, floor2, a.n_iter,
                      [](int, int, float v) { return v; }, apply, sm);
    for (int e = tid; e < nm; e += NT) out[e] = kb.BX[e];
  }
}

// The adjoint solves (VAR = ADJOINT_SPECTRAL or ADJOINT_RAW) of
// solve_kernel, on the CTA's member.
template <int VAR, class Slot>
__device__ void solve_adjoint(const SolveArgs& a, const KBufs& kb, Slot F,
                              Smem& sm) {
  const int tid = threadIdx.x, n = a.n, m = a.m, nm = n * m;
  const size_t mo = (size_t)blockIdx.x * nm;
  float *T1 = F(K_T1), *T2 = F(K_T2), *Z = F(K_Z);
  const float* lam = a.lam;
  float* out = a.out + mo;
  float r2[1], floor2[1];
  const float tau = a.scal[0], half_dt = a.scal[1];
  const float *isd = a.f1 + mo, *fpp = a.f2 + mo, *x0 = a.x0 + mo;
  const float* rhs = a.rhs + mo;
  float *Wl = F(K_PH), *U = F(K_SH);
  // P^-1/2 V (mul) or P^1/2 V (div) = from_s(to_s(V) isd^{+-1}) into epi
  auto phalf = [&](const float* V, bool mul, auto epi) {
    to_s(a, V, T1, sm, [&](int e, float v) {
      T2[e] = mul ? v * isd[e] : v / isd[e];
    });
    from_s(a, T2, T1, sm, epi);
  };
  auto apply_spectral = [&](float* Y, float* OUT) {
    // At y = isd (poly z - (dt/2) to_s(f'' from_s(lam z))), z = isd y
    for (int e = tid; e < nm; e += NT) Z[e] = lam[e] * (isd[e] * Y[e]);
    __syncthreads();
    from_s(a, Z, T1, sm, [&](int e, float v) { T2[e] = fpp[e] * v; });
    to_s(a, T2, T1, sm, [&](int e, float v) {
      const float l = lam[e], s = isd[e];
      const float poly = (1.f - tau * l) + (half_dt * l) * l;
      OUT[e] = s * (poly * (s * Y[e]) - half_dt * v);
    });
  };
  auto apply_raw = [&](float* Y, float* OUT) {
    // P^-1/2 A P^-1/2 y, A v = v - tau w + (dt/2)(L w - f'' w), w = L v
    phalf(Y, true, [&](int e, float v) { Z[e] = v; });
    lap_gemm<1>(a.Lx, a.LyT, Z, 0, n, m, sm,
                [&](int, int e, float l) { Wl[e] = l; });
    lap_gemm<1>(a.Lx, a.LyT, Wl, 0, n, m, sm, [&](int, int e, float l) {
      const float w = Wl[e];
      U[e] = Z[e] - tau * w + half_dt * (l - fpp[e] * w);
    });
    phalf(U, true, [&](int e, float v) { OUT[e] = v; });
  };
  auto apply = [&](float* Y, float* OUT) {
    if constexpr (VAR == ADJOINT_SPECTRAL)
      apply_spectral(Y, OUT);
    else
      apply_raw(Y, OUT);
  };

  // bt = P^-1/2 rhs into R0 (spectral: isd to_s(rhs)), the freeze floor
  if constexpr (VAR == ADJOINT_SPECTRAL)
    to_s(a, rhs, T1, sm, [&](int e, float v) { kb.R0[e] = isd[e] * v; });
  else
    phalf(rhs, true, [&](int e, float v) { kb.R0[e] = v; });
  member_sums<1>(floor2, nm, sm, [&](int, int e) {
    const float v = kb.R0[e];
    return v * v;
  });
  floor2[0] = a.floor_fac * nan_max(floor2[0], EPS_DIV);
  // y0 = P^1/2 x0 (spectral: to_s(x0) / isd): the iterate and best iterate
  auto start = [&](int e, float y) {
    kb.X[e] = y;
    kb.BX[e] = y;
  };
  if constexpr (VAR == ADJOINT_SPECTRAL)
    to_s(a, x0, T1, sm, [&](int e, float v) { start(e, v / isd[e]); });
  else
    phalf(x0, false, start);
  // r0 = bt - At y0 (At y0 lands in T, which every trip overwrites)
  apply(kb.X, kb.T);
  member_sums<1>(r2, nm, sm, [&](int, int e) {
    const float r0 = kb.R0[e] - kb.T[e];
    kb.R0[e] = r0;
    kb.R[e] = r0;
    kb.P[e] = 0.f;
    kb.V[e] = 0.f;
    return r0 * r0;
  });
  bicgstab_fixed<1>(kb, nm, r2, floor2, a.n_iter,
                    [](int, int, float v) { return v; }, apply, sm);
  // p = P^-1/2 best (spectral: from_s(isd best))
  if constexpr (VAR == ADJOINT_SPECTRAL) {
    for (int e = tid; e < nm; e += NT) Z[e] = isd[e] * kb.BX[e];
    __syncthreads();
    from_s(a, Z, T1, sm, [&](int e, float v) { out[e] = v; });
  } else {
    phalf(kb.BX, true, [&](int e, float v) { out[e] = v; });
  }
}

// The cost probes (VAR = SCHUR_NODOTS or SCHUR_MMONLY) of solve_kernel on
// the CTA's member, with the raw Schur solve's operator applies: S through
// two Laplacians, M^-1 through the transforms, in place.
template <int VAR, class Slot>
__device__ void solve_probe(const SolveArgs& a, Slot F, Smem& sm) {
  const int tid = threadIdx.x, n = a.n, m = a.m, nm = n * m;
  const size_t mo = (size_t)blockIdx.x * nm;
  float *T1 = F(K_T1), *T2 = F(K_T2);
  const float *denom = a.f1 + mo, *d = a.f2 + mo, *rhs = a.rhs + mo;
  float* out = a.out + mo;
  const float inv_dt = a.scal[0], tau_dt = a.scal[1], hk = a.scal[2];
  // OUT = S Y = inv_dt Y - L((tau_dt + d) Y - (kappa/2) L Y), OUT != Y, T2
  auto apply_S = [&](const float* Y, float* OUT) {
    lap_gemm<1>(a.Lx, a.LyT, Y, 0, n, m, sm, [&](int, int e, float l) {
      T2[e] = (tau_dt + d[e]) * Y[e] - hk * l;
    });
    lap_gemm<1>(a.Lx, a.LyT, T2, 0, n, m, sm, [&](int, int e, float l) {
      OUT[e] = inv_dt * Y[e] - l;
    });
  };
  // Y <- M^-1 Y = from_s(to_s(Y) / denom)
  auto apply_M = [&](float* Y) {
    to_s(a, Y, T1, sm, [&](int e, float v) { T2[e] = v / denom[e]; });
    from_s(a, T2, T1, sm, [&](int e, float v) { Y[e] = v; });
  };
  if constexpr (VAR == SCHUR_MMONLY) {
    float *Y = F(K_X), *Z = F(K_T);
    for (int e = tid; e < nm; e += NT) Y[e] = rhs[e];
    __syncthreads();
    for (int link = 0; link < 2 * a.n_iter; ++link) {
      apply_S(Y, Z);
      apply_M(Z);
      float* t = Y;                     // the same swap in every thread
      Y = Z;
      Z = t;
    }
    for (int e = tid; e < nm; e += NT) out[e] = Y[e];
  } else {
    float *X = F(K_X), *R = F(K_R), *P = F(K_P), *V = F(K_V), *S = F(K_S),
          *T = F(K_T), *PH = F(K_PH), *SH = F(K_SH);
    for (int e = tid; e < nm; e += NT) {
      X[e] = 0.f;
      R[e] = rhs[e];
      P[e] = 0.f;
      V[e] = 0.f;
    }
    __syncthreads();
    const float dot = 0.5f;             // every block dot product
    float rho = 1.f, alpha = 1.f, omega = 1.f;
    for (int trip = 0; trip < a.n_iter; ++trip) {
      const float rho_new = dot;
      const float beta = (rho_new / rho) * (alpha / omega);
      for (int e = tid; e < nm; e += NT) {
        const float p = R[e] + beta * (P[e] - omega * V[e]);
        P[e] = p;
        PH[e] = p;
      }
      __syncthreads();
      apply_M(PH);                      // phat
      apply_S(PH, V);
      const float alpha_n = rho_new / dot;
      for (int e = tid; e < nm; e += NT) {
        const float sv = R[e] - alpha_n * V[e];
        S[e] = sv;
        SH[e] = sv;
      }
      __syncthreads();
      apply_M(SH);                      // shat
      apply_S(SH, T);
      const float omega_n = dot / dot;
      for (int e = tid; e < nm; e += NT) {
        X[e] = X[e] + alpha_n * PH[e] + omega_n * SH[e];
        R[e] = S[e] - omega_n * T[e];
      }
      __syncthreads();
      rho = rho_new;
      alpha = alpha_n;
      omega = omega_n;
    }
    for (int e = tid; e < nm; e += NT) out[e] = X[e];
  }
}

template <int VAR>
__global__ void __launch_bounds__(NT) solve_kernel(SolveArgs a) {
  __shared__ Smem sm;
  constexpr bool SCHUR = VAR == SCHUR_SPECTRAL || VAR == SCHUR_RAW;
  constexpr bool PROBE = VAR == SCHUR_NODOTS || VAR == SCHUR_MMONLY;
  const int nm = a.n * a.m;
  float* W = a.work + (size_t)blockIdx.x * SOLVE_FIELDS * nm;
  auto F = [=](int slot) { return W + (size_t)slot * nm; };
  // the adjoint solves have no preconditioner copies (PH aliases P and SH
  // aliases S); the raw one uses those two slots for A's intermediates
  const KBufs kb{F(K_X), F(K_R), F(K_P), F(K_V), F(K_R0), F(K_BX),
                 F(K_S), F(K_T), SCHUR ? F(K_PH) : F(K_P),
                 SCHUR ? F(K_SH) : F(K_S), (size_t)SOLVE_FIELDS * nm};
  if constexpr (PROBE)
    solve_probe<VAR>(a, F, sm);
  else if constexpr (SCHUR)
    solve_schur<VAR>(a, kb, F, sm);
  else
    solve_adjoint<VAR>(a, kb, F, sm);
}

template <int VAR>
int launch_solve(int B, const SolveArgs& a, cudaStream_t s) {
  solve_kernel<VAR><<<B, NT, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace vch

// Compiled five times (ops/_build.py): each object of -DVCH_VARIANT=v,
// v = 0, 1, 2, built with -fmad=false, holds variant v alone, and the one
// of -DVCH_VARIANT=4, built so too, both probes (variants 4 and 5): each
// the bit oracle of a cluster kernel (solve2d_cluster.cu), which rounds as
// this one only where neither contracts an elementwise product into an
// FMA; the object without VCH_VARIANT holds the raw adjoint solve (variant
// 3) and the C entries, with nvcc's default contraction, as the raw
// adjoint cluster solve (its counterpart) is compiled.
#ifndef VCH_VARIANT
#define VCH_VARIANT -1
#endif

namespace vch {
#if VCH_VARIANT == 4
template int launch_solve<SCHUR_NODOTS>(int, const SolveArgs&, cudaStream_t);
template int launch_solve<SCHUR_MMONLY>(int, const SolveArgs&, cudaStream_t);
#elif VCH_VARIANT >= 0
template int launch_solve<VCH_VARIANT>(int, const SolveArgs&, cudaStream_t);
#else
extern template int launch_solve<SCHUR_SPECTRAL>(int, const SolveArgs&,
                                                 cudaStream_t);
extern template int launch_solve<SCHUR_RAW>(int, const SolveArgs&,
                                            cudaStream_t);
extern template int launch_solve<ADJOINT_SPECTRAL>(int, const SolveArgs&,
                                                   cudaStream_t);
extern template int launch_solve<SCHUR_NODOTS>(int, const SolveArgs&,
                                               cudaStream_t);
extern template int launch_solve<SCHUR_MMONLY>(int, const SolveArgs&,
                                               cudaStream_t);
#endif
}  // namespace vch

#if VCH_VARIANT < 0
extern "C" int vch_solve_workspace_fields() { return vch::SOLVE_FIELDS; }

// One batch of solves, one CTA per member. variant: 0 spectral Schur
// (f1 = denom, f2 = d; scal = inv_dt, tau_dt, kappa/2), 1 raw Schur (the
// same), 2 spectral adjoint (f1 = isd on the eigenvalue grid, f2 = f''(phi_n),
// x0 the warm start; scal = tau, dt/2), 3 raw adjoint (the same), 4 and 5
// the probes nodots and mmonly (the raw Schur solve's arguments). f1, f2,
// rhs, x0 and out are (B, n, m); scal is a device array; work holds
// B * vch_solve_workspace_fields() (n, m) fields.
extern "C" int vch_bicgstab_2d(
    int variant, const float* scal, const float* Lx, const float* LyT,
    const float* Vxi, const float* VyiT, const float* Vx, const float* VyT,
    const float* lam, const float* f1, const float* f2, const float* rhs,
    const float* x0, float* out, float* work, int B, int n, int m,
    int n_iter, float floor_fac, void* stream) {
  const bool spectral = variant == vch::SCHUR_SPECTRAL ||
                        variant == vch::ADJOINT_SPECTRAL;
  const bool adjoint = variant == vch::ADJOINT_SPECTRAL ||
                       variant == vch::ADJOINT_RAW;
  if (variant < 0 || variant > 5 || B <= 0 || n <= 1 || m <= 1 ||
      n_iter < 0 || !scal || !Vxi || !VyiT || !Vx || !VyT || !f1 || !f2 ||
      !rhs || !out || !work || (spectral && !lam) ||
      (!spectral && (!Lx || !LyT)) || (adjoint && !x0))
    return (int)cudaErrorInvalidValue;
  const vch::SolveArgs a{scal, Lx, LyT, Vxi, VyiT, Vx, VyT, lam, f1, f2,
                         rhs, x0, out, work, n, m, n_iter, floor_fac};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case vch::SCHUR_SPECTRAL: return vch::launch_solve<0>(B, a, s);
    case vch::SCHUR_RAW: return vch::launch_solve<1>(B, a, s);
    case vch::ADJOINT_SPECTRAL: return vch::launch_solve<2>(B, a, s);
    case vch::ADJOINT_RAW: return vch::launch_solve<3>(B, a, s);
    case vch::SCHUR_NODOTS: return vch::launch_solve<4>(B, a, s);
    default: return vch::launch_solve<5>(B, a, s);
  }
}
#endif  // VCH_VARIANT < 0
