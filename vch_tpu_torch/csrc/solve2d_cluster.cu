// The per-step adjoint solve of the 2D scan path on thread-block clusters:
// one member of a (B, n, m) batch per cluster of C CTAs.
//
// Replaces vch_tpu/ops/pallas_kernels.py:798 bicgstab_adjoint_spectral_pallas
// (body :712-795), one pallas_call per solve (vmap over members): the
// split-preconditioned adjoint step solve A(phi_n) p = rhs in the cosine
// basis, warm started from x0; bt = isd to_s(rhs), y0 = to_s(x0) / isd,
// n_iter trips of the fixed-trip BiCGStab on At y = isd (poly (isd y) -
// (dt/2) to_s(f'' from_s(lam isd y))) with the best iterate, the (50 eps)^2
// noise-floor freeze and a non-finite new residual rejected, then
// p = from_s(isd best). The per-step sweep (models/adjoint2d.py) calls it
// once per reverse step for the whole batch: config 3's sweep is 100 calls
// of one member at n = 65.
//
// What bounds it on an H100: a chain of 10 + 8 n_iter dependent dense
// (n x n)(n x m) products (50 at five trips; 27 MFLOP at n = 65) with a
// cluster-wide reduction between most of them. One CTA per member (the
// one-CTA kernel of solve2d.cu, now this kernel's bit oracle) runs a
// config-3 solve on one SM of 132.
//
// Design: the cluster sweep's own solve (adjoint_solve.cuh, the body
// adjoint2d_cluster.cu runs inside every reverse step) on cluster.cuh's
// engine with one member per cluster: each product is split by bands of
// rows over the C CTAs (up to 16 at a batch of one), the eight reduction
// chains run on up to eight SMs, and the scalars every CTA branches on come
// through distributed shared memory. The sweep forms isd and f'' in the
// kernel; here they come from the caller, and one elementwise pass copies
// them into the workspace first, so that both kernels run one body. The
// scalars tau and dt/2 come by value or from device memory (a 0-d tensor
// on the card: the sweep's dt/2 is one), so a call needs no host sync.
// Compiled with -fmad=false, as the one-CTA ADJOINT_SPECTRAL variant is: a
// member's bits are that kernel's, whatever the cluster size or the batch.
// Full float32 FMA: no tensor cores, no TF32.
#include "adjoint_solve.cuh"

namespace vch {
namespace step {

using namespace cluster;

struct Args {
  const float *Vxi, *VyiT, *Vx, *VyT, *lam;   // (n, n), (m, m), (n, m)
  const float *isd, *fpp, *rhs, *x0;          // (B, n, m)
  const float *tau_p, *half_dt_p;   // device scalars, or null: c.tau, half_dt
  float half_dt;
  float *out, *work;
  int n, m, n_trips;
  AdjConst c;                       // tau and floor_fac (the rest unused)
};

// the workspace's fields of one member
struct Slots {
  enum { ISD, FPP, X, RR, PK, V, R0, BX, S, T, Z, T1, T2, COUNT };
};

struct StepSolve : adj::Solve<1, Args, Slots> {
  using Base = adj::Solve<1, Args, Slots>;
  using Base::nm;
  using Base::b0;
  using Base::all;
  using Base::cluster;
  using Base::F;
  using Base::each_elem;
  using Base::a;

  __device__ __forceinline__ StepSolve(const Args& args, const BGeom& g,
                                       adj::Ctl<1>& ctl_, float* smem)
      : Base(args, g, ctl_, smem, Slots::COUNT) {}

  __device__ __forceinline__ void run() {
    const size_t mo = (size_t)b0 * nm;    // the member's fields
    const float *isd = a.isd + mo, *fpp = a.fpp + mo;
    float *ISD = F(Slots::ISD), *FPP = F(Slots::FPP);
    each_elem(all, [&](int, int e) { return Vals<2>{{isd[e], fpp[e]}}; },
              [&](int, int e, const Vals<2>& in) {
                ISD[e] = in.v[0];
                FPP[e] = in.v[1];
              });
    const float tau = a.tau_p ? *a.tau_p : a.c.tau;
    const float half_dt = a.half_dt_p ? *a.half_dt_p : a.half_dt;
    // the copies are read after the first product's cluster barrier
    this->solve(this->fields(), a.rhs + mo, a.x0 + mo, a.out + mo, tau,
                half_dt);
    cluster.sync();   // no CTA leaves while a peer may still write its Ctl
  }
};

__global__ void __launch_bounds__(NT, 1)
    solve_cluster_kernel(Args a, BGeom g) {
  extern __shared__ float4 smem4[];
  __shared__ adj::Ctl<1> ctl;
  StepSolve(a, g, ctl, reinterpret_cast<float*>(smem4)).run();
}

// Per device: the attributes set so far on solve_cluster_kernel.
LaunchState (&launch_state())[16] {
  static LaunchState state[16];
  return state;
}

}  // namespace step
}  // namespace vch

extern "C" int vch_solve_cluster_workspace_fields() {
  return vch::step::Slots::COUNT;
}

// How many clusters of `cluster` CTAs of the per-step solve (members 1,
// segment 0: the arguments of the march's and the sweep's queries) can be
// resident at once on the current card with this geometry; a negative CUDA
// error code on failure.
extern "C" int vch_solve_cluster_max_clusters(int members, int segment,
                                              int n, int m, int cluster,
                                              int kc, int smem_bytes) {
  if (members != 1 || segment) return -(int)cudaErrorInvalidValue;
  return vch::cluster::max_clusters<1>(
      (const void*)vch::step::solve_cluster_kernel, vch::step::launch_state(),
      n, m, cluster, kc, smem_bytes);
}

// One batch of B per-step adjoint solves, one member per cluster of
// `cluster` CTAs, with ring stages of kc rows and smem_bytes of dynamic
// shared memory per CTA: the geometry of ops/march.py blocked_geometry with
// one member, checked here against the kernel's own. isd (on the
// eigenvalue grid), fpp, rhs, x0 and out are (B, n, m); tau and half_dt
// are read from tau_p and half_dt_p where those are not null; work holds
// B * vch_solve_cluster_workspace_fields() (n, m) fields. What
// vch_bicgstab_2d's variant 2 (solve2d.cu) computes, bit for bit.
extern "C" int vch_bicgstab_adjoint_spectral_cluster(
    const float* Vxi, const float* VyiT, const float* Vx, const float* VyT,
    const float* lam, const float* isd, const float* fpp, const float* rhs,
    const float* x0, const float* tau_p, const float* half_dt_p, float tau,
    float half_dt, float* out, float* work, int B, int n, int m, int n_iter,
    float floor_fac, int cluster, int kc, int smem_bytes, void* stream) {
  using namespace vch::cluster;
  if (B <= 0 || n_iter < 0 || !Vxi || !VyiT || !Vx || !VyT || !lam ||
      !isd || !fpp || !rhs || !x0 || !out || !work)
    return (int)cudaErrorInvalidValue;
  vch::step::Args a{Vxi, VyiT, Vx, VyT, lam, isd, fpp, rhs, x0, tau_p,
                    half_dt_p, half_dt, out, work, n, m, n_iter, {}};
  a.c.tau = tau;
  a.c.floor_fac = floor_fac;
  BGeom g;
  int err = check_geometry<1>(n, m, cluster, kc, smem_bytes, g);
  if (err) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  err = configure((const void*)vch::step::solve_cluster_kernel,
                  vch::step::launch_state(), cfg, attr, B, cluster,
                  smem_bytes, (cudaStream_t)stream);
  if (err) return err;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, vch::step::solve_cluster_kernel, a, g);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
