// Whole batched 2D adjoint (p, q, r) sweep; writes the gradient channel r.
//
// Replaces the TPU kernel vch_tpu/ops/pallas_march.py:751 adjoint_fused_2d
// (body _adjoint_kernel_factory, :567-748). Per member: the terminal solve
// (I - tau L) p_T = b2 (phi(T) - phi_Omega), exact in the cosine basis, and
// q_T = -L p_T; then per reverse step n = M-1 .. 0:
//   rhs = B(phi_{n+1}) p_{n+1} + (dt/2) b1 (src_n + src_{n+1}),
//   the split-preconditioned spectral BiCGStab solve of A(phi_n) p_n = rhs
//   (isd = rsqrt|denom|, warm start p_{n+1}, best iterate, noise-floor
//   freeze), q_n = -L p_n and the r CN recursion; dt <= 1e-14 copies the
//   next level. Every product is full float32 (condition-1e6 operator).
//
// What bounds it on an H100: a chain of ~56 dependent dense products per
// step (each 2.1 MFMA at n = m = 129) with a CTA-wide reduction between
// most of them; the working set (19 fields, 1.3 MB per member at 129) does
// not fit a CTA's 227 KB of shared memory.
//
// Design: the same as march2d.cu — one CTA per member walks the reverse
// time loop, state in a global workspace (B, ADJ_FIELDS, n, m), operators
// shared from L2, SIMT FP32 products through 48 x 48 shared-memory tiles
// with fused elementwise epilogues, CTA-uniform predicates from block-wide
// reductions. The preconditioner coefficients (poly, isd) are recomputed
// per element from lam instead of being stored.
#include "common.cuh"

namespace vch {
namespace {

struct AdjConst {
  float tau, gamma, two_c1, two_c2, fpp_lo, fpp_hi, floor_fac;
};
constexpr int ADJ_NCONST = sizeof(AdjConst) / sizeof(float);

enum {
  A_P, A_Q, A_R, A_PN, A_QN, A_W1, A_RHS, A_FPP,
  A_X, A_RR, A_PK, A_V, A_R0, A_BX, A_S, A_T, A_Z, A_T1, A_T2,
  A_COUNT
};
static_assert(A_COUNT == ADJ_FIELDS, "ADJ_FIELDS out of date");

__device__ __forceinline__ float fpp(float phi, const AdjConst& c) {
  const float ph = nan_clamp(phi, c.fpp_lo, c.fpp_hi);
  return c.two_c1 / (1.f - ph * ph) - c.two_c2;
}

struct Ops {
  const float *Lx, *LyT, *Vxi, *VyiT, *Vx, *VyT, *lam;
};

__global__ void __launch_bounds__(NT)
adjoint_kernel(const float* dts, const float* hist, const float* phiQ,
               const float* phiT, const float* b1v, const float* b2v, Ops op,
               float* r_out, float* work, int M, int n, int m, AdjConst c,
               int n_trips) {
  __shared__ Smem sm;
  const int b = blockIdx.x, tid = threadIdx.x, nm = n * m;
  float* W = work + (size_t)b * A_COUNT * nm;
  auto F = [&](int slot) { return W + (size_t)slot * nm; };
  float *P = F(A_P), *Q = F(A_Q), *R = F(A_R), *PN = F(A_PN), *QN = F(A_QN);
  float *W1 = F(A_W1), *RHS = F(A_RHS), *FPP = F(A_FPP), *Z = F(A_Z);
  float *T1 = F(A_T1), *T2 = F(A_T2);
  // no preconditioner copies: PH aliases P and SH aliases S
  const KBufs kb{F(A_X), F(A_RR), F(A_PK), F(A_V), F(A_R0), F(A_BX),
                 F(A_S), F(A_T), F(A_PK), F(A_S)};
  const float* hb = hist + (size_t)b * (M + 1) * nm;
  const float* qb = phiQ + (size_t)b * (M + 1) * nm;
  const float* tb = phiT + (size_t)b * nm;
  float* rb = r_out + (size_t)b * (M + 1) * nm;
  const float* lam = op.lam;
  const float b1 = b1v[b], b2 = b2v[b];

  // ---- terminal: (I - tau L) p_T = b2 (phi(T) - phi_Omega); q_T; r_T = 0 --
  {
    const float* phT = hb + (size_t)M * nm;
    for (int e = tid; e < nm; e += NT) {
      T1[e] = b2 * (phT[e] - tb[e]);
      rb[(size_t)M * nm + e] = 0.f;
      R[e] = 0.f;
    }
    __syncthreads();
    gemm(op.Vxi, T1, n, n, m, sm, [&](int e, float a) { T2[e] = a; });
    gemm(T2, op.VyiT, n, m, m, sm,
         [&](int e, float a) { Z[e] = a / (1.f - c.tau * lam[e]); });
    gemm(op.Vx, Z, n, n, m, sm, [&](int e, float a) { T1[e] = a; });
    gemm(T1, op.VyT, n, m, m, sm, [&](int e, float a) { P[e] = a; });
    lap_gemm(op.Lx, op.LyT, P, n, m, sm, [&](int e, float l) { Q[e] = -l; });
  }

  for (int nstep = M - 1; nstep >= 0; --nstep) {
    const float dt = dts[nstep];
    float* rframe = rb + (size_t)nstep * nm;
    if (dt <= 1e-14f) {               // copy the next level
      for (int e = tid; e < nm; e += NT) rframe[e] = R[e];
      __syncthreads();
      continue;
    }
    const float half_dt = 0.5f * dt;
    const float* phi_n = hb + (size_t)nstep * nm;
    const float* phi_np1 = phi_n + nm;
    const float* pq_n = qb + (size_t)nstep * nm;
    const float* pq_np1 = pq_n + nm;

    float pf = 0.f;
    for (int e = tid; e < nm; e += NT) {
      const float f = fpp(phi_n[e], c);
      FPP[e] = f;
      pf += f;
    }
    const float fbar = block_sum(pf, sm) / (float)nm;
    const float hdt_fbar = half_dt * fbar;
    auto poly = [&](int e) {
      const float l = lam[e];
      return (1.f - c.tau * l) + (half_dt * l) * l;
    };
    auto isd = [&](int e) {
      return 1.f / sqrtf(fabsf(poly(e) - hdt_fbar * lam[e]));
    };

    // rhs = B(phi_{n+1}) p_{n+1} + (dt/2) b1 (src_n + src_{n+1})
    lap_gemm(op.Lx, op.LyT, P, n, m, sm, [&](int e, float l) { W1[e] = l; });
    const float hdt_b1 = half_dt * b1;
    lap_gemm(op.Lx, op.LyT, W1, n, m, sm, [&](int e, float l) {
      const float w1 = W1[e];
      const float Bp = P[e] - c.tau * w1 - half_dt * l +
                       (half_dt * fpp(phi_np1[e], c)) * w1;
      const float src = (phi_n[e] - pq_n[e]) + (phi_np1[e] - pq_np1[e]);
      RHS[e] = Bp + hdt_b1 * src;
    });

    // split-preconditioned operator in the cosine basis:
    // At y = isd (poly z - (dt/2) to_s(fpp_n from_s(lam z))), z = isd y
    auto apply_At = [&](const float* Y, float* OUT, auto&& f) {
      for (int e = tid; e < nm; e += NT) Z[e] = lam[e] * (isd(e) * Y[e]);
      __syncthreads();
      gemm(op.Vx, Z, n, n, m, sm, [&](int e, float a) { T1[e] = a; });
      gemm(T1, op.VyT, n, m, m, sm,
           [&](int e, float a) { T2[e] = FPP[e] * a; });
      gemm(op.Vxi, T2, n, n, m, sm, [&](int e, float a) { T1[e] = a; });
      gemm(T1, op.VyiT, n, m, m, sm, [&](int e, float a) {
        const float s = isd(e);
        const float o = s * (poly(e) * (s * Y[e]) - half_dt * a);
        OUT[e] = o;
        f(e, o);
      });
    };

    // bt = isd to_s(rhs) (kept in R0 until r0 is formed)
    gemm(op.Vxi, RHS, n, n, m, sm, [&](int e, float a) { T1[e] = a; });
    float pb = 0.f;
    gemm(T1, op.VyiT, n, m, m, sm, [&](int e, float a) {
      const float v = isd(e) * a;
      kb.R0[e] = v;
      pb += v * v;
    });
    const float floor2 = c.floor_fac * nan_max(block_sum(pb, sm), EPS_DIV);
    // y0 = to_s(p_{n+1}) / isd (warm start and initial best iterate)
    gemm(op.Vxi, P, n, n, m, sm, [&](int e, float a) { T1[e] = a; });
    gemm(T1, op.VyiT, n, m, m, sm, [&](int e, float a) {
      const float y = a / isd(e);
      kb.X[e] = y;
      kb.BX[e] = y;
    });
    // r0 = bt - At y0 (At y0 lands in T, which every trip overwrites)
    float pr = 0.f;
    apply_At(kb.X, kb.T, [&](int e, float o) {
      const float r0 = kb.R0[e] - o;
      kb.R0[e] = r0;
      kb.R[e] = r0;
      kb.P[e] = 0.f;
      kb.V[e] = 0.f;
      pr += r0 * r0;
    });
    const float r2 = block_sum(pr, sm);
    bicgstab_fixed(kb, nm, r2, floor2, n_trips,
                   [](int, float v) { return v; }, apply_At, sm);

    // p_n = from_s(isd * best); q_n = -L p_n; r CN recursion
    for (int e = tid; e < nm; e += NT) Z[e] = isd(e) * kb.BX[e];
    __syncthreads();
    gemm(op.Vx, Z, n, n, m, sm, [&](int e, float a) { T1[e] = a; });
    gemm(T1, op.VyT, n, m, m, sm, [&](int e, float a) { PN[e] = a; });
    const float den = c.gamma + half_dt;
    const float ca = (c.gamma - half_dt) / den, cb = half_dt / den;
    lap_gemm(op.Lx, op.LyT, PN, n, m, sm, [&](int e, float l) {
      const float qn = -l;
      QN[e] = qn;
      const float r = ca * R[e] + cb * (qn + Q[e]);
      R[e] = r;
      rframe[e] = r;
    });
    float* tmp = P; P = PN; PN = tmp;
    tmp = Q; Q = QN; QN = tmp;
  }
}

}  // namespace
}  // namespace vch

extern "C" int vch_adjoint_fused_2d(
    const float* dts, const float* hist, const float* phiQ, const float* phiT,
    const float* b1, const float* b2, const float* Lx, const float* LyT,
    const float* Vxi, const float* VyiT, const float* Vx, const float* VyT,
    const float* lam, float* r, float* work, int B, int M, int n, int m,
    const float* consts, int nconst, int n_trips, void* stream) {
  using namespace vch;
  if (nconst != ADJ_NCONST || B <= 0 || M <= 0 || n <= 1 || m <= 1)
    return (int)cudaErrorInvalidValue;
  AdjConst c;
  float* dst = reinterpret_cast<float*>(&c);
  for (int i = 0; i < ADJ_NCONST; ++i) dst[i] = consts[i];
  const Ops op{Lx, LyT, Vxi, VyiT, Vx, VyT, lam};
  adjoint_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(
      dts, hist, phiQ, phiT, b1, b2, op, r, work, M, n, m, c, n_trips);
  return (int)cudaGetLastError();
}
