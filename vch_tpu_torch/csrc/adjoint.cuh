// What the one-CTA sweep (adjoint2d.cu) and the cluster sweep
// (adjoint2d_cluster.cu) share: the kernel constants, the workspace's
// fields, f'' and the launch arguments.
#pragma once

#include "common.cuh"

namespace vch {

struct AdjConst {
  float tau, gamma, two_c1, two_c2, fpp_lo, fpp_hi, floor_fac;
};
constexpr int ADJ_NCONST = sizeof(AdjConst) / sizeof(float);

// workspace field slots of one member
enum {
  A_P, A_Q, A_R, A_PN, A_QN, A_W1, A_RHS, A_FPP, A_ISD,
  A_X, A_RR, A_PK, A_V, A_R0, A_BX, A_S, A_T, A_Z, A_T1, A_T2,
  A_COUNT
};
static_assert(A_COUNT == ADJ_FIELDS, "ADJ_FIELDS out of date");

__device__ __forceinline__ float fpp(float phi, const AdjConst& c) {
  const float ph = nan_clamp(phi, c.fpp_lo, c.fpp_hi);
  return c.two_c1 / (1.f - ph * ph) - c.two_c2;
}

struct AdjArgs {
  const float *dts, *hist, *phiQ, *phiT, *b1, *b2;
  const float *Lx, *LyT, *Vxi, *VyiT, *Vx, *VyT, *lam;
  const float *p0, *q0, *r0;            // segment carry in (null: terminal)
  float *r, *p_f, *q_f, *r_f;           // p_f.. null: whole sweep
  float* work;
  int M, n, m, n_trips;
  AdjConst c;
};

// Copies the caller's constants into a; false if their count is not
// ADJ_NCONST.
inline bool set_consts(AdjArgs& a, const float* consts, int nconst) {
  if (nconst != ADJ_NCONST) return false;
  float* dst = reinterpret_cast<float*>(&a.c);
  for (int i = 0; i < ADJ_NCONST; ++i) dst[i] = consts[i];
  return true;
}

}  // namespace vch
