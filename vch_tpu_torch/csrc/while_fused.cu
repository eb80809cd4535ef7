// In-kernel control flow on a Hopper design: the counterpart of the TPU's
// while probe (row 19 of PERF.md's kernel table). Its first kernel
// (probes.cu while_kernel: one CTA per member, phi in static shared memory,
// three block reductions per outer trip) stays as the bit oracle; the
// wrapper is while_probe in vch_tpu_torch/ops/probe_kernels.py.
//
// Replaces scripts/probe_pallas_while.py:67 (kernel at :19): per member b,
// phi starts as x_b; each of M steps runs an outer loop of at most 50 trips,
// each with an inner loop of at most 12 trials (trial = phi (1 - 0.3 alpha),
// accepted when sum trial^2 <= sum phi^2, else alpha halves), then
// phi <- phi (1 - 0.3 alpha), leaving when ||phi|| < 1e-3; each step's outer
// trips are added to ns_b.
//
// What bounds it on an H100: latency, not bytes or FLOPs. A trip is a few
// operations on each of n^2 floats (4,225 at the script's n = 65), far below
// any rate; its time is the chain of CTA reductions, each a shuffle tree,
// two __syncthreads() and a serial sum of the 8 warps' partials. The oracle
// takes three such reductions and three passes over phi in shared memory a
// trip (the trial's sum trial^2 and sum phi^2, then the norm after the
// update).
//
// Design: one CTA of NT = 256 threads per member, as the oracle, with its
// partition of the elements (thread tid owns e = tid + k NT), but
//   - phi lives in registers: KM values a thread, the loops over them fully
//     unrolled and guarded by e < n^2 (KM = 40 holds n^2 <= 10,240, the
//     oracle's limit n <= 101; the launcher takes the smallest KM of
//     2, 8, 17, 40 that holds the field);
//   - one pass and one block_sum<2> a trip: the pass after the update
//     computes s2 = sum p^2 (the norm) together with the next trip's first
//     trial, sum (p f1)^2 with f1 = 1 - 0.3 * 1 as the oracle forms it. The
//     next trip's sum phi^2 is this s2: the same elements in the same
//     per-thread order under the same expression, so the same bits, and it
//     stays valid across the M steps, since phi does not change between
//     them. The first trip of a launch computes both sums in one pass;
//   - a rejected trial (only on non-finite input: with finite phi the trial
//     at alpha = 1 is never larger, as rounding is monotone) runs the
//     oracle's loop from j = 1, one pass and one block_sum<1> a trial for
//     sum trial^2 against the carried sum phi^2.
// So a trip takes 2 barriers and 1 pass where the oracle takes 6 and 3.
// ns_b is written once, at the end.
//
// Why no thread-block cluster: a member's reduction spread over a cluster's
// CTAs costs 1.5-1.6 us through distributed shared memory (PERF.md section
// 6, PR 18), inside one CTA a few tenths of a microsecond, and the field
// fits one CTA's registers. There is no product and no bulk copy here for
// TMA or wgmma to carry.
//
// Bits: builds with nvcc's default contraction, as probes.cu, so that each
// `s += t * t` and `s += p * p` fuses into the same FMA as the oracle's;
// every multiply the oracle rounds apart (__fmul_rn, __fsub_rn) is the same
// intrinsic here, and block_sum<2> reduces each of its two values exactly as
// block_sum<1> does. phi and ns are the oracle's bits.
#include "common.cuh"

namespace vch {
namespace whilef {

constexpr int MAX_ELEMS = 10240;        // 40 floats a thread: n <= 101

template <int KM>
__global__ void __launch_bounds__(NT)
    while_fused_kernel(const float* x, float* out, int* ns, int n, int M) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, nn = n * n;
  const size_t mo = (size_t)blockIdx.x * nn;
  const float f1 = __fsub_rn(1.f, __fmul_rn(0.3f, 1.f));
  float phi[KM];
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const int e = tid + k * NT;
    phi[k] = e < nn ? x[mo + e] : 0.f;
  }
  // the first trip's trial and sum phi^2, in one pass
  float v[2] = {0.f, 0.f};
#pragma unroll
  for (int k = 0; k < KM; ++k)
    if (tid + k * NT < nn) {
      const float p = phi[k], t = __fmul_rn(p, f1);
      v[0] += t * t;
      v[1] += p * p;
    }
  block_sum<2>(v, sm);
  float st = v[0], sp = v[1];           // this trip's sum trial^2, sum phi^2
  int count = 0;
  for (int m = 0; m < M; ++m) {
    int trips = 0;
    bool done = false;
    while (!done && trips < 50) {
      float alpha = 1.f;
      bool acc = st <= sp;
      for (int j = 1; !acc && j < 12; ++j) {
        alpha *= 0.5f;
        const float f = __fsub_rn(1.f, __fmul_rn(0.3f, alpha));
        float s[1] = {0.f};
#pragma unroll
        for (int k = 0; k < KM; ++k)
          if (tid + k * NT < nn) {
            const float t = __fmul_rn(phi[k], f);
            s[0] += t * t;
          }
        block_sum<1>(s, sm);
        acc = s[0] <= sp;
      }
      if (!acc) alpha *= 0.5f;
      const float f = __fsub_rn(1.f, __fmul_rn(0.3f, alpha));
      v[0] = v[1] = 0.f;
#pragma unroll
      for (int k = 0; k < KM; ++k)
        if (tid + k * NT < nn) {
          const float p = __fmul_rn(phi[k], f), t = __fmul_rn(p, f1);
          phi[k] = p;
          v[0] += t * t;
          v[1] += p * p;
        }
      block_sum<2>(v, sm);
      st = v[0];
      sp = v[1];
      ++trips;
      done = sqrtf(sp) < 1e-3f;
    }
    count += trips;
  }
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const int e = tid + k * NT;
    if (e < nn) out[mo + e] = phi[k];
  }
  if (tid == 0) ns[blockIdx.x] = count;
}

template <int KM>
int launch(const float* x, float* out, int* ns, int B, int n, int M,
           cudaStream_t s) {
  while_fused_kernel<KM><<<B, NT, 0, s>>>(x, out, ns, n, M);
  return (int)cudaGetLastError();
}

}  // namespace whilef
}  // namespace vch

extern "C" int vch_while_fused_max_elems() { return vch::whilef::MAX_ELEMS; }

// One CTA per member of the (B, n, n) batch x: M steps of the nested loops;
// out (B, n, n), ns (B,) int32 outer trips per member. n^2 <= 10,240.
extern "C" int vch_while_fused(const float* x, float* out, int* ns, int B,
                               int n, int M, void* stream) {
  using namespace vch;
  if (!x || !out || !ns || B <= 0 || n <= 0 || M < 1 ||
      n * n > whilef::MAX_ELEMS)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int nn = n * n;
  if (nn <= 2 * NT) return whilef::launch<2>(x, out, ns, B, n, M, s);
  if (nn <= 8 * NT) return whilef::launch<8>(x, out, ns, B, n, M, s);
  if (nn <= 17 * NT) return whilef::launch<17>(x, out, ns, B, n, M, s);
  return whilef::launch<40>(x, out, ns, B, n, M, s);
}
