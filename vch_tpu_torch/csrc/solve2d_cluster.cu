// The per-solve kernels of the 2D scan path on thread-block clusters: one
// member of a (B, n, m) batch per cluster of C CTAs.
//
// Replaces four TPU kernels of vch_tpu/ops/pallas_kernels.py, each one
// pallas_call per solve (vmap over members), and the member-tiled form of
// one of them:
//   - :798 bicgstab_adjoint_spectral_pallas (body :712-795): the
//     split-preconditioned adjoint step solve A(phi_n) p = rhs in the cosine
//     basis, warm started from x0; bt = isd to_s(rhs), y0 = to_s(x0) / isd,
//     n_iter trips of the fixed-trip BiCGStab on At y = isd (poly (isd y) -
//     (dt/2) to_s(f'' from_s(lam isd y))) with the best iterate, the
//     (50 eps)^2 noise-floor freeze and a non-finite new residual rejected,
//     then p = from_s(isd best); here solve_cluster_kernel. The per-step
//     sweep (models/adjoint2d.py) calls it once per reverse step for the
//     whole batch: config 3's sweep is 100 calls of one member at n = 65;
//   - :581 bicgstab_adjoint_pallas (body :490-578): the same solve in the
//     raw basis, At = P^-1/2 A P^-1/2 with P^-1/2 v = from_s(isd to_s(v))
//     and A v = v - tau L v + (dt/2)(L L v - f'' L v), bt = P^-1/2 rhs,
//     y0 = P^1/2 x0, p = P^-1/2 best (pallas_variant "raw"); here
//     adjoint_raw_cluster_kernel;
//   - :691 bicgstab_schur_spectral_pallas (body :601-688): the Newton Schur
//     solve S dphi = rhs in the cosine basis, x0 = 0, S yh = poly yh -
//     lam to_s(d from_s(yh)), preconditioned by the pointwise divide by
//     denom, out = from_s(best); here schur_solve_cluster_kernel. The
//     per-step marcher (ops/linsolve.py) calls it once per Newton round;
//   - :233 bicgstab_schur_pallas (body :150-231): the same Newton Schur
//     solve in the raw basis (pallas_variant "raw"), b = rhs, x0 = 0, S v =
//     (1/dt) v - L((tau/dt + d) v - (kappa/2) L v) as two Laplacians,
//     right-preconditioned by M^-1 v = Vx((Vx^-1 v Vy^-T) / denom) Vy^T,
//     out = best; here schur_raw_cluster_kernel, which also takes the place
//     of :394 bicgstab_schur_pallas_batched (block_b members per program,
//     the batch padded): B clusters, one member each, no padding. Config 3
//     on the raw variant calls it once per Newton solve of its baseline
//     march;
// and two TPU kernels of scripts/diag_kernel_cost.py, the cost probes that
// time that raw Schur solve in parts (the script's "full", :65):
//   - :131 nodots: its trips with every block dot product the constant 0.5,
//     no freeze and no best iterate (its products and elementwise passes
//     without its reductions); here schur_probe_cluster_kernel<false>;
//   - :176 mmonly: v <- M^-1 S M^-1 S v n_iter times from v = rhs (its 16
//     products a trip alone); here schur_probe_cluster_kernel<true>.
//
// What bounds them on an H100: a chain of dependent dense (n x n)(n x m)
// products (spectral adjoint 10 + 8 n_iter, raw adjoint 24 + 24 n_iter,
// Schur 4 + 8 n_iter, raw Schur and either probe 16 n_iter; 27 MFLOP for
// the spectral adjoint at n = 65 and five trips) with a cluster-wide
// reduction between most of them (none in the probes). One CTA per
// member (the one-CTA kernels of solve2d.cu, now these kernels' bit
// oracles) runs a config-3 solve on one SM of 132.
//
// Design: cluster.cuh's engine with one member per cluster: each product is
// split by bands of rows over the C CTAs (up to 16 at a batch of one), the
// eight reduction chains run on up to eight SMs, and the scalars every CTA
// branches on come through distributed shared memory. The adjoint solves
// run the cluster sweep's own solve (adjoint_solve.cuh, the body
// adjoint2d_cluster.cu runs inside every reverse step; the raw one its raw
// operator): the sweep forms isd and f'' in the kernel, here they come from
// the caller, and one elementwise pass copies them into the workspace
// first, so that both kernels run one body. The Schur solves run
// schur_solve.cuh (the raw one its raw operator and preconditioner),
// reading denom, d and rhs from the caller's fields; the probes run its raw
// operator and preconditioner without its reductions. The
// scalars come by value or from device memory (a 0-d tensor on the card:
// the sweep's dt/2 and the marcher's 1/dt and tau/dt are), so a call needs
// no host sync.
//
// Compiled once per kernel (ops/_build.py): -DVCH_VARIANT=0 the Schur
// solve, 1 the raw Schur solve, 2 the spectral adjoint solve, 3 the raw one,
// 4 the two probes (solve2d.cu's variant numbers; its 4 and 5 are one
// object too), each object holding its kernels and C entries. Each
// compiles as its one-CTA oracle does, so that a member's bits are that
// kernel's, whatever the cluster size or the batch: the two Schur solves,
// the probes and the spectral adjoint solve with -fmad=false (an
// expression such as poly y - l v, or the raw operator's (tau/dt + d) y -
// (kappa/2) l, adds two products, which nvcc may fuse either way), the raw
// adjoint solve with nvcc's default contraction (none of its expressions
// adds two products, so both fuse alike; without contraction its float32
// result on rough inputs lay farther from float64). Full float32 FMA: no
// tensor cores, no TF32.
#include <climits>
#include <type_traits>

#include "adjoint_solve.cuh"
#include "schur_solve.cuh"

#ifndef VCH_VARIANT
#error "-DVCH_VARIANT=0 (Schur), 1 (raw Schur), 2, 3 (adjoint), 4 (probes)"
#endif

namespace vch {
namespace step {

using namespace cluster;

// One batch of B solves on `kernel`, one member per cluster of `cluster`
// CTAs, with ring stages of kc rows and smem_bytes of dynamic shared memory
// per CTA: the geometry of ops/march.py blocked_geometry with one member,
// checked here against the kernel's own.
template <class A>
int launch(void (*kernel)(A, BGeom), LaunchState (&state)[16], const A& a,
           int B, int cluster, int kc, int smem_bytes, void* stream) {
  BGeom g;
  int err = check_geometry<1>(a.n, a.m, cluster, kc, smem_bytes, g);
  if (err) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  err = configure((const void*)kernel, state, cfg, attr, B, cluster,
                  smem_bytes, (cudaStream_t)stream);
  if (err) return err;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a, g);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` CTAs of `kernel` (members 1, segment 0:
// the arguments of the march's and the sweep's queries) can be resident at
// once on the current card with this geometry; a negative CUDA error code
// on failure.
inline int resident(const void* kernel, LaunchState (&state)[16],
                    int members, int segment, int n, int m, int cluster,
                    int kc, int smem_bytes) {
  if (members != 1 || segment) return -(int)cudaErrorInvalidValue;
  return max_clusters<1>(kernel, state, n, m, cluster, kc, smem_bytes);
}

#if VCH_VARIANT != 4
// Per object: the attributes set so far on its kernel, per device.
static LaunchState (&launch_state())[16] {
  static LaunchState state[16];
  return state;
}
#endif

#if VCH_VARIANT <= 1 || VCH_VARIANT == 4

struct SchurArgs {
  const float *Vxi, *VyiT, *Vx, *VyT, *lam;   // (n, n), (m, m), (n, m)
  const float *denom, *d, *rhs;               // (B, n, m)
  const float* scal_p[3];   // device scalars, or null: scal
  float scal[3];            // inv_dt, tau_dt, kappa/2
  float *out, *work;
  int n, m, n_trips;
  float floor_fac;
};

// the workspace's fields of one member
struct SchurSlots {
  enum { X, RR, P, V, R0, BX, S, T, PH, SH, T1, T2, COUNT };
};

#if VCH_VARIANT == 0
__global__ void __launch_bounds__(NT, 1)
    schur_solve_cluster_kernel(SchurArgs a, BGeom g) {
  extern __shared__ float4 smem4[];
  __shared__ schur::Ctl<1> ctl;
  schur::Solve<1, SchurArgs, SchurSlots> s(
      a, g, ctl, reinterpret_cast<float*>(smem4), SchurSlots::COUNT);
  float v[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = a.scal_p[i] ? *a.scal_p[i] : a.scal[i];
  const size_t mo = (size_t)s.b0 * s.nm;    // the member's fields
  s.solve(a.denom + mo, a.d + mo, a.rhs + mo, a.out + mo, v[0], v[1], v[2]);
  s.cluster.sync();   // no CTA leaves while a peer may still write its Ctl
}
#else
struct SchurRawArgs : SchurArgs {
  const float *Lx, *LyT;                      // (n, n), (m, m)
};

// The raw Schur solve's and the probes' arguments
inline SchurRawArgs raw_args(const float* Lx, const float* LyT,
                             const float* Vxi, const float* VyiT,
                             const float* Vx, const float* VyT,
                             const float* denom, const float* d,
                             const float* rhs, const float* inv_dt_p,
                             const float* tau_dt_p, const float* hk_p,
                             float inv_dt, float tau_dt, float hk, float* out,
                             float* work, int n, int m, int n_iter,
                             float floor_fac) {
  SchurRawArgs a;
  static_cast<SchurArgs&>(a) = SchurArgs{
      Vxi, VyiT, Vx, VyT, nullptr, denom, d, rhs, {inv_dt_p, tau_dt_p, hk_p},
      {inv_dt, tau_dt, hk}, out, work, n, m, n_iter, floor_fac};
  a.Lx = Lx;
  a.LyT = LyT;
  return a;
}
#endif

#if VCH_VARIANT == 1
__global__ void __launch_bounds__(NT, 1)
    schur_raw_cluster_kernel(SchurRawArgs a, BGeom g) {
  extern __shared__ float4 smem4[];
  __shared__ schur::Ctl<1> ctl;
  schur::Solve<1, SchurRawArgs, SchurSlots, true> s(
      a, g, ctl, reinterpret_cast<float*>(smem4), SchurSlots::COUNT);
  float v[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = a.scal_p[i] ? *a.scal_p[i] : a.scal[i];
  const size_t mo = (size_t)s.b0 * s.nm;    // the member's fields
  s.solve(a.denom + mo, a.d + mo, a.rhs + mo, a.out + mo, v[0], v[1], v[2]);
  s.cluster.sync();   // no CTA leaves while a peer may still write its Ctl
}
#elif VCH_VARIANT == 4
// the workspace's fields of one member of a probe (mmonly uses X and T)
struct ProbeSlots {
  enum { X, RR, P, V, S, T, PH, SH, T1, T2, COUNT };
};

// The cost probes on the raw Schur solve's operators: nodots (MMONLY false)
// or mmonly, one member per cluster. They reduce nothing, so no CTA reads
// a peer's shared memory (its Ctl's warp values stay unused) and none
// waits for its peers before it leaves.
template <bool MMONLY>
__global__ void __launch_bounds__(NT, 1)
    schur_probe_cluster_kernel(SchurRawArgs a, BGeom g) {
  extern __shared__ float4 smem4[];
  __shared__ schur::Ctl<1> ctl;
  schur::Solve<1, SchurRawArgs, ProbeSlots, true> s(
      a, g, ctl, reinterpret_cast<float*>(smem4), ProbeSlots::COUNT);
  float v[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = a.scal_p[i] ? *a.scal_p[i] : a.scal[i];
  const size_t mo = (size_t)s.b0 * s.nm;    // the member's fields
  if constexpr (MMONLY)
    s.mmonly(a.denom + mo, a.d + mo, a.rhs + mo, a.out + mo, v[0], v[1],
             v[2]);
  else
    s.nodots(a.denom + mo, a.d + mo, a.rhs + mo, a.out + mo, v[0], v[1],
             v[2]);
}

// Per probe: the attributes set so far on its kernel, per device.
template <bool MMONLY>
LaunchState (&probe_state())[16] {
  static LaunchState state[16];
  return state;
}

#endif

#else

struct Args {
  const float *Vxi, *VyiT, *Vx, *VyT, *lam;   // (n, n), (m, m), (n, m)
  const float *isd, *fpp, *rhs, *x0;          // (B, n, m)
  const float *tau_p, *half_dt_p;   // device scalars, or null: c.tau, half_dt
  float half_dt;
  float *out, *work;
  int n, m, n_trips;
  AdjConst c;                       // tau and floor_fac (the rest unused)
};
struct RawArgs : Args {
  const float *Lx, *LyT;                      // (n, n), (m, m)
};

// the workspace's fields of one member
struct Slots {
  enum { ISD, FPP, X, RR, PK, V, R0, BX, S, T, Z, T1, T2, COUNT };
};
struct RawSlots : Slots {
  enum { W = Slots::COUNT, U, COUNT };
};

template <bool RAW>
using StepArgs = std::conditional_t<RAW, RawArgs, Args>;
template <bool RAW>
using StepSlots = std::conditional_t<RAW, RawSlots, Slots>;

template <bool RAW>
struct StepSolve : adj::Solve<1, StepArgs<RAW>, StepSlots<RAW>, RAW> {
  using Base = adj::Solve<1, StepArgs<RAW>, StepSlots<RAW>, RAW>;
  using Base::nm;
  using Base::b0;
  using Base::all;
  using Base::cluster;
  using Base::F;
  using Base::each_elem;
  using Base::a;

  __device__ __forceinline__ StepSolve(const StepArgs<RAW>& args,
                                       const BGeom& g, adj::Ctl<1>& ctl_,
                                       float* smem)
      : Base(args, g, ctl_, smem, StepSlots<RAW>::COUNT) {}

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

#if VCH_VARIANT == 2
__global__ void __launch_bounds__(NT, 1)
    solve_cluster_kernel(Args a, BGeom g) {
  extern __shared__ float4 smem4[];
  __shared__ adj::Ctl<1> ctl;
  StepSolve<false>(a, g, ctl, reinterpret_cast<float*>(smem4)).run();
}
#else
__global__ void __launch_bounds__(NT, 1)
    adjoint_raw_cluster_kernel(RawArgs a, BGeom g) {
  extern __shared__ float4 smem4[];
  __shared__ adj::Ctl<1> ctl;
  StepSolve<true>(a, g, ctl, reinterpret_cast<float*>(smem4)).run();
}
#endif

// The adjoint solves' arguments; tau and half_dt are read from tau_p and
// half_dt_p where those are not null.
inline Args adjoint_args(const float* Vxi, const float* VyiT,
                         const float* Vx, const float* VyT, const float* lam,
                         const float* isd, const float* fpp,
                         const float* rhs, const float* x0,
                         const float* tau_p, const float* half_dt_p,
                         float tau, float half_dt, float* out, float* work,
                         int n, int m, int n_iter, float floor_fac) {
  Args a{Vxi, VyiT, Vx, VyT, lam, isd, fpp, rhs, x0, tau_p, half_dt_p,
         half_dt, out, work, n, m, n_iter, {}};
  a.c.tau = tau;
  a.c.floor_fac = floor_fac;
  return a;
}

#endif  // VCH_VARIANT

}  // namespace step
}  // namespace vch

#if VCH_VARIANT == 0

extern "C" int vch_schur_cluster_workspace_fields() {
  return vch::step::SchurSlots::COUNT;
}

// The occupancy query of the Schur solve (vch_solve_cluster_max_clusters'
// arguments).
extern "C" int vch_schur_cluster_max_clusters(int members, int segment,
                                              int n, int m, int cluster,
                                              int kc, int smem_bytes) {
  return vch::step::resident(
      (const void*)vch::step::schur_solve_cluster_kernel,
      vch::step::launch_state(), members, segment, n, m, cluster, kc,
      smem_bytes);
}

// One batch of B spectral Newton Schur solves, one member per cluster of
// `cluster` CTAs (vch_bicgstab_adjoint_spectral_cluster's geometry). denom
// (the preconditioner symbol on the eigenvalue grid), d, rhs and out are
// (B, n, m); inv_dt, tau_dt and kappa/2 are read from inv_dt_p, tau_dt_p
// and hk_p where those are not null; work holds B *
// vch_schur_cluster_workspace_fields() (n, m) fields. What vch_bicgstab_2d's
// variant 0 (solve2d.cu) computes, bit for bit.
extern "C" int vch_bicgstab_schur_spectral_cluster(
    const float* Vxi, const float* VyiT, const float* Vx, const float* VyT,
    const float* lam, const float* denom, const float* d, const float* rhs,
    const float* inv_dt_p, const float* tau_dt_p, const float* hk_p,
    float inv_dt, float tau_dt, float hk, float* out, float* work, int B,
    int n, int m, int n_iter, float floor_fac, int cluster, int kc,
    int smem_bytes, void* stream) {
  if (B <= 0 || n_iter < 0 || !Vxi || !VyiT || !Vx || !VyT || !lam ||
      !denom || !d || !rhs || !out || !work)
    return (int)cudaErrorInvalidValue;
  const vch::step::SchurArgs a{
      Vxi, VyiT, Vx, VyT, lam, denom, d, rhs, {inv_dt_p, tau_dt_p, hk_p},
      {inv_dt, tau_dt, hk}, out, work, n, m, n_iter, floor_fac};
  return vch::step::launch(vch::step::schur_solve_cluster_kernel,
                           vch::step::launch_state(), a, B, cluster, kc,
                           smem_bytes, stream);
}

#elif VCH_VARIANT == 1

extern "C" int vch_schur_raw_cluster_workspace_fields() {
  return vch::step::SchurSlots::COUNT;
}

// The occupancy query of the raw Schur solve
// (vch_solve_cluster_max_clusters' arguments).
extern "C" int vch_schur_raw_cluster_max_clusters(int members, int segment,
                                                  int n, int m, int cluster,
                                                  int kc, int smem_bytes) {
  return vch::step::resident(
      (const void*)vch::step::schur_raw_cluster_kernel,
      vch::step::launch_state(), members, segment, n, m, cluster, kc,
      smem_bytes);
}

// One batch of B raw-basis Newton Schur solves, one member per cluster
// (vch_bicgstab_schur_spectral_cluster's arguments and geometry, with the
// Laplacian factors Lx (n, n) and LyT (m, m) first and no eigenvalue grid);
// work holds B * vch_schur_raw_cluster_workspace_fields() (n, m) fields.
// What vch_bicgstab_2d's variant 1 (solve2d.cu) computes, bit for bit.
extern "C" int vch_bicgstab_schur_raw_cluster(
    const float* Lx, const float* LyT, const float* Vxi, const float* VyiT,
    const float* Vx, const float* VyT, const float* denom, const float* d,
    const float* rhs, const float* inv_dt_p, const float* tau_dt_p,
    const float* hk_p, float inv_dt, float tau_dt, float hk, float* out,
    float* work, int B, int n, int m, int n_iter, float floor_fac,
    int cluster, int kc, int smem_bytes, void* stream) {
  if (B <= 0 || n_iter < 0 || !Lx || !LyT || !Vxi || !VyiT || !Vx || !VyT ||
      !denom || !d || !rhs || !out || !work)
    return (int)cudaErrorInvalidValue;
  const vch::step::SchurRawArgs a = vch::step::raw_args(
      Lx, LyT, Vxi, VyiT, Vx, VyT, denom, d, rhs, inv_dt_p, tau_dt_p, hk_p,
      inv_dt, tau_dt, hk, out, work, n, m, n_iter, floor_fac);
  return vch::step::launch(vch::step::schur_raw_cluster_kernel,
                           vch::step::launch_state(), a, B, cluster, kc,
                           smem_bytes, stream);
}

#elif VCH_VARIANT == 2

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
  return vch::step::resident((const void*)vch::step::solve_cluster_kernel,
                             vch::step::launch_state(), members, segment, n,
                             m, cluster, kc, smem_bytes);
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
  if (B <= 0 || n_iter < 0 || !Vxi || !VyiT || !Vx || !VyT || !lam ||
      !isd || !fpp || !rhs || !x0 || !out || !work)
    return (int)cudaErrorInvalidValue;
  const vch::step::Args a = vch::step::adjoint_args(
      Vxi, VyiT, Vx, VyT, lam, isd, fpp, rhs, x0, tau_p, half_dt_p, tau,
      half_dt, out, work, n, m, n_iter, floor_fac);
  return vch::step::launch(vch::step::solve_cluster_kernel,
                           vch::step::launch_state(), a, B, cluster, kc,
                           smem_bytes, stream);
}

#elif VCH_VARIANT == 3

extern "C" int vch_adjoint_raw_cluster_workspace_fields() {
  return vch::step::RawSlots::COUNT;
}

// The occupancy query of the raw adjoint solve
// (vch_solve_cluster_max_clusters' arguments).
extern "C" int vch_adjoint_raw_cluster_max_clusters(int members, int segment,
                                                    int n, int m,
                                                    int cluster, int kc,
                                                    int smem_bytes) {
  return vch::step::resident(
      (const void*)vch::step::adjoint_raw_cluster_kernel,
      vch::step::launch_state(), members, segment, n, m, cluster, kc,
      smem_bytes);
}

// One batch of B raw-basis adjoint step solves, one member per cluster
// (vch_bicgstab_adjoint_spectral_cluster's arguments and geometry, with the
// Laplacian factors Lx (n, n) and LyT (m, m) first); work holds B *
// vch_adjoint_raw_cluster_workspace_fields() (n, m) fields. What
// vch_bicgstab_2d's variant 3 (solve2d.cu) computes, bit for bit.
extern "C" int vch_bicgstab_adjoint_raw_cluster(
    const float* Lx, const float* LyT, const float* Vxi, const float* VyiT,
    const float* Vx, const float* VyT, const float* isd, const float* fpp,
    const float* rhs, const float* x0, const float* tau_p,
    const float* half_dt_p, float tau, float half_dt, float* out,
    float* work, int B, int n, int m, int n_iter, float floor_fac,
    int cluster, int kc, int smem_bytes, void* stream) {
  if (B <= 0 || n_iter < 0 || !Lx || !LyT || !Vxi || !VyiT || !Vx ||
      !VyT || !isd || !fpp || !rhs || !x0 || !out || !work)
    return (int)cudaErrorInvalidValue;
  vch::step::RawArgs a;
  static_cast<vch::step::Args&>(a) = vch::step::adjoint_args(
      Vxi, VyiT, Vx, VyT, nullptr, isd, fpp, rhs, x0, tau_p, half_dt_p, tau,
      half_dt, out, work, n, m, n_iter, floor_fac);
  a.Lx = Lx;
  a.LyT = LyT;
  return vch::step::launch(vch::step::adjoint_raw_cluster_kernel,
                           vch::step::launch_state(), a, B, cluster, kc,
                           smem_bytes, stream);
}

#else

extern "C" int vch_schur_probe_cluster_workspace_fields() {
  return vch::step::ProbeSlots::COUNT;
}

// The occupancy query of the two probes (vch_solve_cluster_max_clusters'
// arguments): the clusters of the one that holds fewer (each kernel has its
// own registers), so that one geometry serves both.
extern "C" int vch_schur_probe_cluster_max_clusters(int members, int segment,
                                                    int n, int m,
                                                    int cluster, int kc,
                                                    int smem_bytes) {
  using namespace vch::step;
  const int each[2] = {
      resident((const void*)schur_probe_cluster_kernel<false>,
               probe_state<false>(), members, segment, n, m, cluster, kc,
               smem_bytes),
      resident((const void*)schur_probe_cluster_kernel<true>,
               probe_state<true>(), members, segment, n, m, cluster, kc,
               smem_bytes)};
  int fewest = INT_MAX;
  for (int c : each) {
    if (c < 0) return c;
    fewest = c < fewest ? c : fewest;
  }
  return fewest;
}

// One batch of B cost probes on the raw Schur solve's operators, one
// member per cluster: nodots (n_iter trips) or mmonly (n_iter times two
// links), with vch_bicgstab_schur_raw_cluster's arguments and geometry;
// floor_fac is not read (the probes freeze nothing); work holds B *
// vch_schur_probe_cluster_workspace_fields() (n, m) fields. What
// vch_bicgstab_2d's variants 4 and 5 (solve2d.cu) compute, bit for bit.
template <bool MMONLY>
static int launch_probe(const float* Lx, const float* LyT, const float* Vxi,
                        const float* VyiT, const float* Vx, const float* VyT,
                        const float* denom, const float* d, const float* rhs,
                        const float* inv_dt_p, const float* tau_dt_p,
                        const float* hk_p, float inv_dt, float tau_dt,
                        float hk, float* out, float* work, int B, int n,
                        int m, int n_iter, int cluster, int kc,
                        int smem_bytes, void* stream) {
  if (B <= 0 || n_iter < 0 || !Lx || !LyT || !Vxi || !VyiT || !Vx || !VyT ||
      !denom || !d || !rhs || !out || !work)
    return (int)cudaErrorInvalidValue;
  using namespace vch::step;
  const SchurRawArgs a = raw_args(Lx, LyT, Vxi, VyiT, Vx, VyT, denom, d, rhs,
                                  inv_dt_p, tau_dt_p, hk_p, inv_dt, tau_dt,
                                  hk, out, work, n, m, n_iter, 0.f);
  return launch(schur_probe_cluster_kernel<MMONLY>, probe_state<MMONLY>(), a,
                B, cluster, kc, smem_bytes, stream);
}

extern "C" int vch_schur_nodots_cluster(
    const float* Lx, const float* LyT, const float* Vxi, const float* VyiT,
    const float* Vx, const float* VyT, const float* denom, const float* d,
    const float* rhs, const float* inv_dt_p, const float* tau_dt_p,
    const float* hk_p, float inv_dt, float tau_dt, float hk, float* out,
    float* work, int B, int n, int m, int n_iter, float /*floor_fac*/,
    int cluster, int kc, int smem_bytes, void* stream) {
  return launch_probe<false>(Lx, LyT, Vxi, VyiT, Vx, VyT, denom, d, rhs,
                             inv_dt_p, tau_dt_p, hk_p, inv_dt, tau_dt, hk,
                             out, work, B, n, m, n_iter, cluster, kc,
                             smem_bytes, stream);
}

extern "C" int vch_schur_mmonly_cluster(
    const float* Lx, const float* LyT, const float* Vxi, const float* VyiT,
    const float* Vx, const float* VyT, const float* denom, const float* d,
    const float* rhs, const float* inv_dt_p, const float* tau_dt_p,
    const float* hk_p, float inv_dt, float tau_dt, float hk, float* out,
    float* work, int B, int n, int m, int n_iter, float /*floor_fac*/,
    int cluster, int kc, int smem_bytes, void* stream) {
  return launch_probe<true>(Lx, LyT, Vxi, VyiT, Vx, VyT, denom, d, rhs,
                            inv_dt_p, tau_dt_p, hk_p, inv_dt, tau_dt, hk,
                            out, work, B, n, m, n_iter, cluster, kc,
                            smem_bytes, stream);
}

#endif  // VCH_VARIANT
