// The three operator applies of the 2D Newton and adjoint systems, each as
// a kernel of its own: one CTA per member of a (B, n, m) batch.
//
// Replaces three TPU kernels of vch_tpu/ops/pallas_kernels.py, each one
// pallas_call per apply (vmap over members):
//   - :101 schur_apply_pallas (body :85-98): S v = inv_dt v - L[(tau_dt + d)
//     v - (kappa/2) L v], L v = Lx v + v LyT;
//   - :133 adjoint_apply_pallas (body :119-130): A v = v - tau w + (dt/2)
//     (L w - f'' w), w = L v;
//   - :478 spectral_solve_pallas (body :466-475): Vx ((Vx^-1 v Vy^-T) /
//     denom) Vy^T, the exact solve of a polynomial in L whose symbol on the
//     eigenvalue grid is denom.
// They are the operators inside the per-solve kernels of solve2d.cu, on the
// same device products (common.cuh), so an apply here sums in the order the
// solve kernels do.
//
// What bounds it on an H100: four dependent (n x n)(n x m) products, 8 n^3
// FLOP, in one CTA: at n = m = 65 that is 2.2 MFLOP, below what a launch's
// fixed latency lets any kernel use; at n = 257 one CTA on one of the 132 SMs
// is the limit (operations). Design: as solve2d.cu, SIMT FP32 products
// through 48 x 48 shared-memory tiles with the elementwise steps fused into
// their epilogues, two scratch fields per member in a global workspace.
#include "common.cuh"

namespace vch {

enum { SCHUR_APPLY = 0, ADJOINT_APPLY = 1, SPECTRAL_SOLVE = 2 };

struct ApplyArgs {
  const float* scal;              // Schur: inv_dt, tau_dt, kappa/2;
                                  // adjoint: tau, dt/2; spectral: unused
  const float *Lx, *LyT, *Vxi, *VyiT, *Vx, *VyT;
  const float *f1, *v;            // d, f'' or denom; the field
  float *out, *work;
  int n, m, f1_shared;
};

template <int VAR>
__global__ void __launch_bounds__(NT) apply_kernel(ApplyArgs a) {
  __shared__ Smem sm;
  const int n = a.n, m = a.m, nm = n * m;
  const size_t mo = (size_t)blockIdx.x * nm;
  const float* v = a.v + mo;
  const float* f1 = a.f1 + (a.f1_shared ? 0 : mo);
  float* out = a.out + mo;
  float* T1 = a.work + (size_t)blockIdx.x * 2 * nm;
  float* T2 = T1 + nm;
  if constexpr (VAR == SCHUR_APPLY) {
    const float inv_dt = a.scal[0], tau_dt = a.scal[1], hk = a.scal[2];
    lap_gemm<1>(a.Lx, a.LyT, v, 0, n, m, sm, [&](int, int e, float l) {
      T1[e] = (tau_dt + f1[e]) * v[e] - hk * l;
    });
    lap_gemm<1>(a.Lx, a.LyT, T1, 0, n, m, sm, [&](int, int e, float l) {
      out[e] = inv_dt * v[e] - l;
    });
  } else if constexpr (VAR == ADJOINT_APPLY) {
    const float tau = a.scal[0], half_dt = a.scal[1];
    lap_gemm<1>(a.Lx, a.LyT, v, 0, n, m, sm,
                [&](int, int e, float l) { T1[e] = l; });
    lap_gemm<1>(a.Lx, a.LyT, T1, 0, n, m, sm, [&](int, int e, float l) {
      const float w = T1[e];
      out[e] = v[e] - tau * w + half_dt * (l - f1[e] * w);
    });
  } else {
    gemm_l<1>(a.Vxi, v, 0, n, n, m, sm,
              [&](int, int e, float x) { T1[e] = x; });
    gemm_r<1>(T1, 0, a.VyiT, n, m, m, sm,
              [&](int, int e, float x) { T2[e] = x / f1[e]; });
    gemm_l<1>(a.Vx, T2, 0, n, n, m, sm,
              [&](int, int e, float x) { T1[e] = x; });
    gemm_r<1>(T1, 0, a.VyT, n, m, m, sm,
              [&](int, int e, float x) { out[e] = x; });
  }
}

template <int VAR>
int launch_apply(int B, const ApplyArgs& a, cudaStream_t s) {
  apply_kernel<VAR><<<B, NT, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace vch

// One batch of applies, one CTA per member. variant: 0 Schur (f1 = d; scal =
// inv_dt, tau_dt, kappa/2; needs Lx, LyT), 1 adjoint (f1 = f''(phi_n); scal =
// tau, dt/2; needs Lx, LyT), 2 spectral solve (f1 = denom; needs the four
// transforms). v and out are (B, n, m); f1 is (B, n, m), or (n, m) for all
// members with f1_shared; scal is a device array; work holds 2 B (n, m)
// fields.
extern "C" int vch_apply_2d(
    int variant, const float* scal, const float* Lx, const float* LyT,
    const float* Vxi, const float* VyiT, const float* Vx, const float* VyT,
    const float* f1, const float* v, float* out, float* work, int B, int n,
    int m, int f1_shared, void* stream) {
  const bool spectral = variant == vch::SPECTRAL_SOLVE;
  if (variant < 0 || variant > 2 || B <= 0 || n <= 1 || m <= 1 || !scal ||
      !f1 || !v || !out || !work || (!spectral && (!Lx || !LyT)) ||
      (spectral && (!Vxi || !VyiT || !Vx || !VyT)))
    return (int)cudaErrorInvalidValue;
  const vch::ApplyArgs a{scal, Lx, LyT, Vxi, VyiT, Vx, VyT, f1, v, out,
                         work, n, m, f1_shared};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case vch::SCHUR_APPLY: return vch::launch_apply<0>(B, a, s);
    case vch::ADJOINT_APPLY: return vch::launch_apply<1>(B, a, s);
    default: return vch::launch_apply<2>(B, a, s);
  }
}
