// Whole batched 2D adjoint (p, q, r) sweep, one member per CTA; writes the
// gradient channel r.
//
// Replaces two TPU kernels of vch_tpu/ops/pallas_march.py:
//   - :751 adjoint_fused_2d (body _adjoint_kernel_factory, :567-748);
//   - :819 adjoint_fused_2d_segment (the factory's carry_in=True): the
//     (p, q, r) carry of the segment's last level in instead of the terminal
//     solve, (p, q, r) of its first level out, r of its K levels (no
//     terminal frame) in forward order.
// The whole sweep is row 2's kernel; the segment flag, and the whole sweep
// for the member-blocked form, are the bit oracles of the cluster sweep
// (adjoint2d_cluster.cu), which carries rows 4 and 6.
// Per member: the terminal solve (I - tau L) p_T = b2 (phi(T) - phi_Omega),
// exact in the cosine basis, and q_T = -L p_T; then per reverse step
// n = M-1 .. 0:
//   rhs = B(phi_{n+1}) p_{n+1} + (dt/2) b1 (src_n + src_{n+1}),
//   the split-preconditioned spectral BiCGStab solve of A(phi_n) p_n = rhs
//   (isd = 1 / sqrt|denom|, warm start p_{n+1}, best iterate, noise-floor
//   freeze), q_n = -L p_n and the r CN recursion; dt <= 1e-14 copies the
//   next level. Every product is full float32 (condition-1e6 operator).
// Compiled with -fmad=false (ops/_build.py), as the cluster sweep is: the
// only FMAs are the products' explicit ones, so an elementwise expression
// rounds the same in both kernels whatever the compiler's contraction.
//
// What bounds it on an H100: a chain of ~56 dependent dense products per
// step (each 2.1 MFMA at n = m = 129) with a CTA-wide reduction between
// most of them; the working set (20 fields, 1.3 MB per member at 129) does
// not fit a CTA's 227 KB of shared memory.
//
// Design: the same as march2d.cu — a CTA walks the reverse time loop for
// its member, state in a global workspace (B, ADJ_FIELDS, n, m), operators
// shared from L2, SIMT FP32 products through 48 x 48 shared-memory tiles
// with fused elementwise epilogues, CTA-uniform predicates from block-wide
// reductions. The preconditioner scale isd is stored once per step as a
// field, since it depends on the member's mean f''.
#include "adjoint.cuh"

namespace vch {

__global__ void __launch_bounds__(NT) adjoint_kernel(AdjArgs a) {
  constexpr int BB = 1;                 // members per CTA (common.cuh)
  __shared__ Smem sm;
  const AdjConst& c = a.c;
  const int tid = threadIdx.x, n = a.n, m = a.m, nm = n * m, M = a.M;
  const int b0 = blockIdx.x * BB;
  const bool seg = a.p0 != nullptr;
  const size_t FS = (size_t)A_COUNT * nm;     // member stride of a field
  const size_t HS = (size_t)(M + 1) * nm;     // ... of hist and phi_Q
  const size_t RS = (size_t)(seg ? M : M + 1) * nm;   // ... of r
  float* W = a.work + b0 * FS;
  auto F = [&](int slot) { return W + (size_t)slot * nm; };
  float *P = F(A_P), *Q = F(A_Q), *R = F(A_R), *PN = F(A_PN), *QN = F(A_QN);
  float *W1 = F(A_W1), *RHS = F(A_RHS), *FPP = F(A_FPP), *ISD = F(A_ISD);
  float *Z = F(A_Z), *T1 = F(A_T1), *T2 = F(A_T2);
  // no preconditioner copies: PH aliases P and SH aliases S
  const KBufs kb{F(A_X), F(A_RR), F(A_PK), F(A_V), F(A_R0), F(A_BX),
                 F(A_S), F(A_T), F(A_PK), F(A_S), FS};
  const float* hb = a.hist + b0 * HS;
  const float* qb = a.phiQ + b0 * HS;
  float* rb = a.r + b0 * RS;
  const float* lam = a.lam;

  if (seg) {
    // the carry of the segment's last level
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const size_t o = b * FS, g = (size_t)(b0 + b) * nm;
      for (int e = tid; e < nm; e += NT) {
        P[o + e] = a.p0[g + e];
        Q[o + e] = a.q0[g + e];
        R[o + e] = a.r0[g + e];
      }
    }
    __syncthreads();
  } else {
    // terminal: (I - tau L) p_T = b2 (phi(T) - phi_Omega); q_T; r_T = 0
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const size_t o = b * FS;
      const float b2 = a.b2[b0 + b];
      const float* phT = hb + b * HS + (size_t)M * nm;
      const float* tb = a.phiT + (size_t)(b0 + b) * nm;
      for (int e = tid; e < nm; e += NT) {
        T1[o + e] = b2 * (phT[e] - tb[e]);
        rb[b * RS + (size_t)M * nm + e] = 0.f;
        R[o + e] = 0.f;
      }
    }
    __syncthreads();
    gemm_l<BB>(a.Vxi, T1, FS, n, n, m, sm,
               [&](int b, int e, float v) { T2[b * FS + e] = v; });
    gemm_r<BB>(T2, FS, a.VyiT, n, m, m, sm, [&](int b, int e, float v) {
      Z[b * FS + e] = v / (1.f - c.tau * lam[e]);
    });
    gemm_l<BB>(a.Vx, Z, FS, n, n, m, sm,
               [&](int b, int e, float v) { T1[b * FS + e] = v; });
    gemm_r<BB>(T1, FS, a.VyT, n, m, m, sm,
               [&](int b, int e, float v) { P[b * FS + e] = v; });
    lap_gemm<BB>(a.Lx, a.LyT, P, FS, n, m, sm,
                 [&](int b, int e, float l) { Q[b * FS + e] = -l; });
  }

  for (int nstep = M - 1; nstep >= 0; --nstep) {
    const float dt = a.dts[nstep];
    if (dt <= 1e-14f) {               // copy the next level
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        float* rframe = rb + b * RS + (size_t)nstep * nm;
        for (int e = tid; e < nm; e += NT) rframe[e] = R[b * FS + e];
      }
      __syncthreads();
      continue;
    }
    const float half_dt = 0.5f * dt;
    auto poly = [&](int e) {
      const float l = lam[e];
      return (1.f - c.tau * l) + (half_dt * l) * l;
    };

    float fbar[BB];
    member_sums<BB>(fbar, nm, sm, [&](int b, int e) {
      const float f = fpp(hb[b * HS + (size_t)nstep * nm + e], c);
      FPP[b * FS + e] = f;
      return f;
    });
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const float hdt_fbar = half_dt * (fbar[b] / (float)nm);
      for (int e = tid; e < nm; e += NT)
        ISD[b * FS + e] = 1.f / sqrtf(fabsf(poly(e) - hdt_fbar * lam[e]));
    }
    __syncthreads();

    // rhs = B(phi_{n+1}) p_{n+1} + (dt/2) b1 (src_n + src_{n+1})
    lap_gemm<BB>(a.Lx, a.LyT, P, FS, n, m, sm,
                 [&](int b, int e, float l) { W1[b * FS + e] = l; });
    lap_gemm<BB>(a.Lx, a.LyT, W1, FS, n, m, sm, [&](int b, int e, float l) {
      const size_t i = b * FS + e;
      const size_t h = b * HS + (size_t)nstep * nm + e;
      const float w1 = W1[i];
      const float Bp = P[i] - c.tau * w1 - half_dt * l +
                       (half_dt * fpp(hb[h + nm], c)) * w1;
      const float src = (hb[h] - qb[h]) + (hb[h + nm] - qb[h + nm]);
      RHS[i] = Bp + (half_dt * a.b1[b0 + b]) * src;
    });

    // split-preconditioned operator in the cosine basis:
    // At y = isd (poly z - (dt/2) to_s(fpp_n from_s(lam z))), z = isd y
    auto apply_At = [&](const float* Y, float* OUT) {
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        const size_t o = b * FS;
        for (int e = tid; e < nm; e += NT)
          Z[o + e] = lam[e] * (ISD[o + e] * Y[o + e]);
      }
      __syncthreads();
      gemm_l<BB>(a.Vx, Z, FS, n, n, m, sm,
                 [&](int b, int e, float v) { T1[b * FS + e] = v; });
      gemm_r<BB>(T1, FS, a.VyT, n, m, m, sm, [&](int b, int e, float v) {
        T2[b * FS + e] = FPP[b * FS + e] * v;
      });
      gemm_l<BB>(a.Vxi, T2, FS, n, n, m, sm,
                 [&](int b, int e, float v) { T1[b * FS + e] = v; });
      gemm_r<BB>(T1, FS, a.VyiT, n, m, m, sm, [&](int b, int e, float v) {
        const size_t i = b * FS + e;
        const float s = ISD[i];
        OUT[i] = s * (poly(e) * (s * Y[i]) - half_dt * v);
      });
    };

    // bt = isd to_s(rhs) (kept in R0 until r0 is formed)
    gemm_l<BB>(a.Vxi, RHS, FS, n, n, m, sm,
               [&](int b, int e, float v) { T1[b * FS + e] = v; });
    gemm_r<BB>(T1, FS, a.VyiT, n, m, m, sm, [&](int b, int e, float v) {
      const size_t i = b * FS + e;
      kb.R0[i] = ISD[i] * v;
    });
    float floor2[BB];
    member_sums<BB>(floor2, nm, sm, [&](int b, int e) {
      const float v = kb.R0[b * FS + e];
      return v * v;
    });
#pragma unroll
    for (int b = 0; b < BB; ++b) floor2[b] = c.floor_fac * nan_max(floor2[b], EPS_DIV);
    // y0 = to_s(p_{n+1}) / isd (warm start and initial best iterate)
    gemm_l<BB>(a.Vxi, P, FS, n, n, m, sm,
               [&](int b, int e, float v) { T1[b * FS + e] = v; });
    gemm_r<BB>(T1, FS, a.VyiT, n, m, m, sm, [&](int b, int e, float v) {
      const size_t i = b * FS + e;
      const float y = v / ISD[i];
      kb.X[i] = y;
      kb.BX[i] = y;
    });
    // r0 = bt - At y0 (At y0 lands in T, which every trip overwrites)
    apply_At(kb.X, kb.T);
    float r2[BB];
    member_sums<BB>(r2, nm, sm, [&](int b, int e) {
      const size_t i = b * FS + e;
      const float r0 = kb.R0[i] - kb.T[i];
      kb.R0[i] = r0;
      kb.R[i] = r0;
      kb.P[i] = 0.f;
      kb.V[i] = 0.f;
      return r0 * r0;
    });
    bicgstab_fixed<BB>(kb, nm, r2, floor2, a.n_trips,
                       [](int, int, float v) { return v; }, apply_At, sm);

    // p_n = from_s(isd * best); q_n = -L p_n; r CN recursion
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const size_t o = b * FS;
      for (int e = tid; e < nm; e += NT) Z[o + e] = ISD[o + e] * kb.BX[o + e];
    }
    __syncthreads();
    gemm_l<BB>(a.Vx, Z, FS, n, n, m, sm,
               [&](int b, int e, float v) { T1[b * FS + e] = v; });
    gemm_r<BB>(T1, FS, a.VyT, n, m, m, sm,
               [&](int b, int e, float v) { PN[b * FS + e] = v; });
    const float den = c.gamma + half_dt;
    const float ca = (c.gamma - half_dt) / den, cb = half_dt / den;
    lap_gemm<BB>(a.Lx, a.LyT, PN, FS, n, m, sm, [&](int b, int e, float l) {
      const size_t i = b * FS + e;
      const float qn = -l;
      QN[i] = qn;
      const float r = ca * R[i] + cb * (qn + Q[i]);
      R[i] = r;
      rb[b * RS + (size_t)nstep * nm + e] = r;
    });
    float* tmp = P; P = PN; PN = tmp;
    tmp = Q; Q = QN; QN = tmp;
  }
  if (seg) {
#pragma unroll
    for (int b = 0; b < BB; ++b) {
      const size_t o = b * FS, g = (size_t)(b0 + b) * nm;
      for (int e = tid; e < nm; e += NT) {
        a.p_f[g + e] = P[o + e];
        a.q_f[g + e] = Q[o + e];
        a.r_f[g + e] = R[o + e];
      }
    }
  }
}

// One launch: B CTAs.
int launch_adjoint(int B, const AdjArgs& a, const float* consts, int nconst,
                   void* stream) {
  AdjArgs k = a;
  if (!set_consts(k, consts, nconst) || B <= 0 || a.M <= 0 || a.n <= 1 ||
      a.m <= 1)
    return (int)cudaErrorInvalidValue;
  adjoint_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(k);
  return (int)cudaGetLastError();
}

}  // namespace vch

// The whole sweep. r is (B, M+1, n, m) with r_T = 0 last.
extern "C" int vch_adjoint_fused_2d(
    const float* dts, const float* hist, const float* phiQ, const float* phiT,
    const float* b1, const float* b2, const float* Lx, const float* LyT,
    const float* Vxi, const float* VyiT, const float* Vx, const float* VyT,
    const float* lam, float* r, float* work, int B, int M, int n, int m,
    const float* consts, int nconst, int n_trips, void* stream) {
  vch::AdjArgs a{dts, hist, phiQ, phiT, b1, b2, Lx, LyT, Vxi, VyiT, Vx, VyT,
                 lam, nullptr, nullptr, nullptr, r, nullptr, nullptr, nullptr,
                 work, M, n, m, n_trips, {}};
  return vch::launch_adjoint(B, a, consts, nconst, stream);
}

// One K-step segment: (p0, q0, r0) at the segment's last level in, r
// (B, K, n, m) of its first K levels and (p_f, q_f, r_f) at its first
// level out; hist and phiQ are the segment's K+1 frames.
extern "C" int vch_adjoint_fused_2d_segment(
    const float* dts, const float* hist, const float* phiQ, const float* p0,
    const float* q0, const float* r0, const float* b1, const float* Lx,
    const float* LyT, const float* Vxi, const float* VyiT, const float* Vx,
    const float* VyT, const float* lam, float* r, float* p_f, float* q_f,
    float* r_f, float* work, int B, int K, int n, int m, const float* consts,
    int nconst, int n_trips, void* stream) {
  vch::AdjArgs a{dts, hist, phiQ, nullptr, b1, nullptr, Lx, LyT, Vxi, VyiT,
                 Vx, VyT, lam, p0, q0, r0, r, p_f, q_f, r_f,
                 work, K, n, m, n_trips, {}};
  return vch::launch_adjoint(B, a, consts, nconst, stream);
}
