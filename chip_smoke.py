#!/usr/bin/env python3
"""Smoke run of the vch_tpu_torch port on one CUDA card.

    python chip_smoke.py

Phases (each prints one line; any failure raises, so the exit code is not 0):
  0 device   — the card's name and power limit; no card is an error (never
               falls back to the CPU);
  1 build    — nvcc builds every kernel from vch_tpu_torch/csrc for sm_90a;
  2 kernels  — the per-member march and sweep (one member per
               thread-block cluster) against their plain PyTorch versions on
               the same inputs on the card, at n = 65 and n = 129 (both odd
               edges) and at config 4's smallest line-search bucket (n = 129,
               M = 100, B = 8), with kernel and plain times; then the march
               against its one-CTA oracle bit for bit and timed in turns
               with it at n = 65 and 129, B = 1, 8, 128 and at n = 129,
               B = 256 (past the clusters the card holds at once), M = 100,
               with the cluster geometry and the bound; the sweep against
               its one-CTA oracle of adjoint2d.cu likewise ("row 2"), with
               a zero dt step, at n = 65, B = 1 and n = 129, B = 1, 8, 128,
               at 129 x 1 also on clusters of 8 and 4;
  2b kernels — the member-blocked kernels (8 members on a thread-block
               cluster: the march and the sweep) against
               their plain versions and against the per-member kernels at
               n = 65, B = 8, at bench.py's headline shape n = 65, B = 512,
               M = 100, and at n = 65, B = 64, M = 100 (plain on the first 8
               members there), both bit for bit, timed in turns with them,
               with the march's and the sweep's cluster geometry and their
               bounds at each shape; the blocked march and sweep at
               block_b = 2, 4 and 8 (n = 65, B = 8) against the one-member
               kernels, bit for bit, with their times; the blocked
               march at the headline's straggler buckets (B = 128 and 256,
               M = 100) on its own cluster rule and on the one-member rule's
               search for resident clusters, in turns; the segment
               kernels chained over two segments, K = 5 at n = 65, B = 4,
               and K = 10 at phase 6's grid n = 257, B = 2, each launch
               against its plain version, each segment march launch (one
               member per thread-block cluster) against the one-CTA oracle
               of march2d.cu bit for bit, each segment sweep launch
               against that of adjoint2d.cu likewise, and the chain
               against the whole march and sweep; the segment march and
               its one-CTA oracle
               timed in turns at n = 257, K = 10, B = 1, 8 and 32
               (phase 6's batch and two of its straggler buckets), with the
               cluster geometry and the bound, and at B = 8, 32 on
               the cluster sizes the SM count alone gives and on smaller
               ones (the launch geometry takes the largest whose clusters
               the card holds all at once); the segment sweep and its
               one-CTA oracle likewise at n = 65, B = 4, K = 5 and at
               n = 257, K = 10, B = 1, 8 and 32, bit for bit with a
               zero dt step too, on the launch geometry and on two other
               cluster sizes; the one-member sweep (one member per
               cluster) against its one-CTA oracle, bit for bit, and both
               timed beside the blocked sweep at n = 65, B = 8, 64 and 512
               (the 64x64 routing arms);
  2c kernels — the four per-solve kernels (spectral and raw Schur and
               adjoint solves) against their plain versions on inputs from a
               real step at n = 65, 129 and 257, one solve and a batch of 4,
               and at the scan path's n = 129, B = 128, gated against
               float64, with kernel and plain CUDA-event times; the
               spectral and the raw Schur solve, the spectral and the raw
               adjoint solve (one member per thread-block cluster) each
               against its one-CTA oracle of solve2d.cu ("row 8", "row 10",
               "row 9", "row 11"), bit for bit, the scalars the per-step
               solvers pass as
               0-d tensors passed so and as numbers, timed in turns at
               n = 65, B = 1 (config 3's, also on clusters of 8 and 4),
               n = 129, B = 128 and n = 257, B = 1, with the geometry,
               trips and bound;
  2d kernels — the fused 1D march (a group of members per thread-block
               cluster, the operators' column bands in shared memory)
               against its plain version in float32 and both against the
               plain version in float64, at n = 129 and n = 513, B = 8,
               5-step and 100-step marches, and at B = 134 and 270 (the last
               cluster not full); one and three members per cluster, two
               other cluster sizes and single members marched alone, all
               bit-equal to the wrapper's own run, with its geometry;
  2e kernels — the three operator applies (Schur, adjoint, spectral solve)
               against their plain versions on fields from a real step at
               n = 65, 129 and 257, one field and a batch of 4, and the raw
               Schur solve on a batch of 8 (the counterpart of the TPU's
               member-tiled solve, "row 12"), gated against float64 and bit
               for bit against its one-CTA oracle, timed in turns with it;
               two launches bit-equal, and each member of a batch bit-equal
               to its one-member launch; beside each apply the time of the same
               function as torch.matmul calls, the kernel/library ratio, its
               bound, its cluster geometry and, at n = 257, its time on
               clusters of 8;
  3 slice    — BatchedProblem2D at 32x32 on the heterogeneous B = 16 sweep
               with one member per CTA, kernel path against plain path,
               2 PGD iterations;
  3b slices  — the same sweep with the blocked kernels (B = 16, 8 per CTA),
               and LowMemBatchedProblem2D with K = 4, each kernel path
               against its plain path, and the low-memory kernel path
               against the full-memory one;
  3c control — ControlProblem2D at 32x32, T = 0.25 (the golden config's
               grid), float32, 3 PGD iterations, kernel path against plain
               path, once with each pallas_variant;
  2f probes  — the probe entry point vch_tpu_torch.probes.diag_kernel_cost
               (the raw Schur solve bicgstab_schur and its nodots and
               mmonly probes, all three one member per thread-block
               cluster) at the script's default shape (n = 65, B = 32, 10
               trips) and at the scan path's (n = 129, B = 128, 4 trips),
               each probe kernel against its plain version, gated against
               float64, and bit for bit its one-CTA oracle of solve2d.cu
               ("rows 16-17"), at n = 65 also one member on one cluster of
               every size 1-16; each timed in turns with its oracle, with
               the probes' and full's cluster geometry;
  2g probes  — the four chain probe entry points (vch_tpu_torch.probes.
               diag_march_sol with its chain cut to CHAIN_AMORT = 200 solves'
               worth of links, diag_interleave, diag_blocked_microbench,
               probe_while) at the scripts' default shapes, launch counts
               read around each; each probe kernel (the float32 and bf16
               chains, the eight microbench variants, the while probe)
               against its plain version and the plain version in float64;
               the float32 chain (K members per thread-block cluster) bit
               for bit against its one-CTA oracle at every K, on its launch
               geometry and on one cluster of every size 1-16 at n = 17,
               65 and 129, the mma.sync bf16 chain against the wmma one
               likewise at every K; each microbench variant (bb members on
               one thread-block cluster) bit for bit its one-CTA oracle,
               out and sums, at bb = 8, k = 64 and on one cluster of every
               size 1-16 at bb = 8 and 1; rows 20, 21 and 18 timed in
               turns with their oracles, the float32 chain's time per link
               and each microbench variant's per step by cluster size; the
               while probe (phi in registers, one CTA reduction a trip) bit
               for bit its one-CTA oracle, phi and trip counts, at n = 9,
               17, 65, 101, B = 1, 2, 3 (one member NaN-seeded at B = 3)
               and M = 1, 3, and row 19 timed in turns with its oracle at
               the script's shape;
  3d slice   — BatchedProblem1D at N = 64 on a heterogeneous B = 16 sweep,
               kernel path against plain path, 3 PGD iterations;
  3e scan    — the scan path (fused_march=False: the batched per-step
               marcher and sweep on the per-solve kernels, one launch per
               Newton round or sweep step for the whole batch) of
               BatchedProblem2D and of LowMemBatchedProblem2D (K = 5) at
               32x32, T = 0.1, on a heterogeneous B = 8 sweep, each with
               both pallas_variants, kernel path against plain path over
               2 PGD iterations; the low-memory one's adjoint r gated
               against float64;
  4 config 4 — a main path: 128x128, T = 1 (M = 100), B = 128, float32,
               one warm-up iteration, then 3 timed PGD iterations with the
               kernel launch counters reset just before (per-member kernels);
               then the march kernel alone at that shape, with its cluster
               geometry and bound, and the one-member sweep alone on its
               history, with its bound, and its one-CTA oracle in turns
               with it, bit-gated;
  4s scan    — a main path: config 4's shape on the scan path
               (BatchedProblem2D(fused_march=False)), one warm-up and one
               timed PGD iteration, the spectral per-solve kernels at
               B = 128, with their launches' CUDA-event ms; peak memory
               over S and the first iteration's cost against the fused run
               of phase 4;
  5 headline — bench.py's configuration: 64x64, T = 1, B = 512, float32,
               one warm-up, then 3 timed PGD iterations (blocked kernels);
               the blocked kernels' launches and CUDA-event milliseconds
               inside the timed window, by batch, beside phase 2b's
               one-CTA sweep at B = 512;
  6 low mem  — config 5's grid: 256x256, T = 1, B = 32, K = 10, procedural
               ramp targets, routed by make_batched_problem_2d under the
               largest device-memory limit its full-memory estimate does
               not fit; one warm-up and one timed iteration (segment
               kernels), whose peak must stay within that limit; the
               segment kernels' launches and CUDA-event milliseconds inside
               the timed iteration, by batch, with their bounds at B = 32,
               beside phase 2b's segment sweep on its one-CTA oracle;
  7 memory   — peak device memory of the full-memory problem at config 4's
               grid, B = 64 and 128 at T = 1 and B = 128 at T = 0.1, over S
               (one trajectory-shaped array) and over the estimate
               make_batched_problem_2d routes by, which it must not exceed;
  8 config 3 — a main path: BASELINE config 3 (64x64, T = 1, M = 100,
               float32) through ControlProblem2D: constructor, one warm-up
               and 3 timed PGD iterations, verify_sparsity and
               second_order_check, launches counted in each window, the
               constructor's Schur solves timed by CUDA events; the four
               cluster solves' wrappers: host microseconds a call against
               the kernel's device microseconds;
  8r config 3 raw — a main path: config 3 on pallas_variant "raw" (the
               raw-basis solves): constructor, one warm-up and 3 timed PGD
               iterations, the raw adjoint solve's launches and CUDA-event
               ms, its cost history against the raw solves' plain path;
               the constructor's baseline march once more on the cluster
               raw Schur solve and on its one-CTA oracle, in turns, each
               solve under CUDA events, the histories bit-equal;
  9 config 2 — a main path: BASELINE config 2 at full width (1D, N = 512,
               T = 1, dt = 2e-3: M = 500, the 32 x 8 (b3, kappa) sweep:
               B = 256, float32) through BatchedProblem1D: one warm-up, then
               3 timed PGD iterations (the fused 1D march; the adjoint is the
               batched per-step sweep, which has no kernel); then the 1D
               march alone at that shape, with its geometry and bound, and
               on rings of 16 and 8 k rows a stage, bit for bit;
  10 config 1 — BASELINE config 1 (1D, N = 128, M = 100, one scenario,
               float32) through ControlProblem1D: constructor, one warm-up
               and 3 timed PGD iterations, verify_sparsity; it launches no
               kernel, as in vch_tpu;
  8x exact   — config 3 through ControlProblem2D(gradient_mode="exact"):
               constructor, one warm-up and 2 timed PGD iterations, launches
               counted in each window (the constructor's Schur solves, one
               one-member march a line-search trial, nothing else: the
               exact gradient is plain PyTorch), costs that never rise, the
               first iterate's float32 gradient against float64 on the card
               (EXACT_F32_REL), PGD iterations/s and the backward and trial
               seconds;
  10x exact  — config 1 likewise through ControlProblem1D, 3 timed
               iterations, no launch;
  2x exact   — the float64 ExactAdjoint2D on the card at 12 x 12 against
               central finite differences at two entries (1e-4);
  11 cli     — the command line, vch_tpu_torch.cli, with vch_tpu's
               defaults (newton_tol 1e-6): in process, `optimize2d` at
               config 3 (64x64, T = 1, 3 PGD iterations, --checkpoint; rows
               8, 1, 9 under CUDA events, launches gated: the baseline's
               Newton solves, each trial and the coercivity probe, M a
               sweep; costs that never rise, the checkpoint's u equal to
               the saved control, the config JSON reloaded), `sweep2d` at
               config 4's width (128x128, B = 128, 3 iterations, every
               member's cost falling; rows 1-2 only), `forward2d --n 128`
               (row 8 only), `optimize2d` at 32x32, T = 0.25, float32 on
               the card against --device cpu (2e-4); then `show-control`,
               `forward2d --n 128` and `optimize1d --max-iter 2` as
               processes of their own, each to exit 0; one line per
               command with its seconds, launches and rates;
  12 side    — the batch runner's side paths (vch_tpu/parallel/batch.py:
               168-1006), each run after `prewarm` with its launches
               counted: (a) at the headline (64x64, T = 1, B = 512, the
               heterogeneous (b3, kappa) grid 16 x 16 tiled, alpha_max
               2000) 3 PGD iterations in four modes, the plain search
               (straggler_batch "auto"), speculative=True,
               straggler_batch=100 (its sub-batches on row 1) and
               chunk_size=128, each mode's trial counts equal to the
               plain search's and its cost history within 1e-6, each
               counter above 0; (b) config 4 (128x128, B = 128):
               checkpoint at 2, resume to 4 against an uninterrupted 4
               with metrics (1e-6), and trial_memory_analysis's peak
               within the chooser's estimate; (c) the low-memory arm at
               256x256, K = 10, B = 8, resume likewise;
  13 mesh    — the multi-device paths on torch.distributed at world size
               1 on NCCL (the process group made here and destroyed at the
               end): (a) config 4 (128x128, B = 128) through
               BatchedProblem2D(use_mesh=True), 2 PGD iterations (after
               one untimed-for-the-rate first mesh run), bit for bit the
               run without a mesh (cost history, trials, Newton solves, u,
               phi), rows 1-2 launched; (b) GridShardedForward2D
               and GridShardedAdjoint2D at 256 x 256, T = 0.25, float32,
               against their float64 twin and the unsharded solvers on the
               card (each no farther from float64 than twice the unsharded
               one), no launch, collectives per Newton solve; (c)
               GridShardedProblem2D at 128 x 128, T = 1, 2 iterations,
               against ControlProblem2D's plain path (trials equal, costs
               2e-4); (d) GridShardedBatchedProblem2D on the (1, 1) mesh,
               B = 4, 1 iteration, against BatchedProblem2D(fused_march=
               False) likewise; (e) `sweep2d --mesh` and `optimize2d
               --grid-shard` at 32x32 on the card against --device cpu
               (processes of their own), 2e-4;
  4sp profile — phase 4s's scan path likewise, its baseline march and one
               sweep (a run of no PGD iteration);
  2e-dev     — the operator applies and their torch.matmul forms once more,
               one field at n = 65, 129, 257, and the cluster solves (rows
               8-11) and their one-CTA oracles at phase 2c's shapes (the
               raw Schur solve also at phase 2e's n = 65, B = 8, row 12),
               then rows 16-17, their oracles, their library forms (the
               plain versions' calls) and the probe's full at phase 2f's
               shapes, each timed on the device
               alone (calls in a CUDA graph), last because a capture
               leaves cuBLAS a workspace that phase 7 would count;
  2g-dev     — rows 20 and 21, their one-CTA oracles and their library
               form (L torch.matmul links) on the device alone likewise;
               then row 18's eight variants, their oracles and their
               library forms (the k steps as PyTorch calls); then row 19
               and its oracle (no library form).
It then prints the kernels' JSON line, the card's nvidia-smi name and power
limit, and last `{"ok": true, "device": {...}}`.
"""
import dataclasses
import json
import subprocess
import time

import numpy as np

from vch_tpu_torch.ops.probe_kernels import BF16_CHAIN_TOL
from vch_tpu_torch.probes._timing import (PEAK_BF16_FLOPS, PEAK_BYTES_PER_S,
                                          PEAK_FP32_FLOPS, graph_ms, time_ms)


_T0 = time.perf_counter()


def _log(phase, msg):
    """One line of a phase, ending with the seconds since the script
    started (the run must stay inside its time limit)."""
    print(f"[{phase}] {msg} | {time.perf_counter() - _T0:.1f} s", flush=True)


def _smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else "nvidia-smi: no output"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def _ptxas_summary(log):
    """ptxas's registers and spill stores of every kernel, by object:
    `[source VCH_BB=n] 128r/0s ...`, in the order ptxas lists them."""
    out, spill = [], "?"
    for ln in log.splitlines():
        if ln.startswith("["):
            out.append(ln.strip())
        elif "spill stores" in ln:
            spill = ln.split("bytes stack frame,")[1].split("bytes spill "
                                                            "stores")[0].strip()
        elif "registers" in ln:
            out.append(ln.split("Used")[1].split("registers")[0].strip()
                       + f"r/{spill}s")
    return " ".join(out)


def _ptxas_named(log, kernel):
    """ptxas's registers and spill stores of each instantiation of
    `kernel` (the whole identifier: its length leads it in the mangled
    name), by its template arguments (a bool as 0 or 1): `<0,1> 96r/0s
    ...`."""
    import re
    out, name, spill = [], None, "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = (m.group(1) if f"{len(kernel)}{kernel}" in m.group(1)
                    else None)
        elif name and "spill stores" in ln:
            spill = ln.split("bytes stack frame,")[1].split("bytes spill "
                                                            "stores")[0].strip()
        elif name and "Used" in ln and "registers" in ln:
            args = ",".join(re.findall(r"L[ib](\d+)E", name))
            out.append(f"<{args}> " + ln.split("Used")[1].split(
                "registers")[0].strip() + f"r/{spill}s")
            name = None
    return " ".join(out)


def device_share(torch, fn):
    """One call of fn under torch.profiler: host wall seconds, the summed
    device time of its kernels and copies, their ratio (the device's busy
    share; the rest is idle while the host prepares the next launch), and the
    five kernels with the most device time. A profiler that records no
    device time gives None where a number would be."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    rows = [(e.key, dev_us(e) / 1e6) for e in prof.key_averages()
            if dev_us(e) > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(t for _, t in rows)
    if not rows:
        return dict(wall_s=wall, device_s=None, busy_share=None, top=[])
    return dict(wall_s=wall, device_s=busy, busy_share=busy / wall,
                top=[(k[:60], t) for k, t in rows[:5]])


def _host_ms(torch, fn):
    """Host-clock ms of one synchronized call (the plain versions, whose
    Python loops make host time the honest measure); returns (ms, result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _rel(a, b, ref):
    return ((a.double() - b.double()).abs().max().item()
            / max(ref.double().abs().max().item(), 1e-300))


def _problem_inputs(torch, n, B, T, device, seed=0):
    """Solvers in float32 and float64 (the float64 ones on the plain
    versions, taking the float32 Newton exits) and seeded inputs, as tensors
    of both dtypes."""
    from vch_tpu_torch.config import DELTA_SEP, ForwardSolverConfig2D
    from vch_tpu_torch.control.targets import build_targets_2d
    from vch_tpu_torch.models.adjoint2d import AdjointSolver2D
    from vch_tpu_torch.models.forward2d import ForwardSolver2D
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.ops.potential import init_phi_random_2d

    solvers = {}
    for dt in ("float32", "float64"):
        cfg = ForwardSolverConfig2D(Nx=n - 1, Ny=n - 1, T=T, dtype=dt,
                                    newton_tol=2e-4)
        solvers[dt] = (ForwardSolver2D(cfg, device=device),
                       AdjointSolver2D(cfg, device=device))
    (fwd, _), (fwd64, adj64) = solvers["float32"], solvers["float64"]
    fwd64.entries = adj64.entries = km.PLAIN
    fwd64.rtol, fwd64.stagnation = fwd.rtol, fwd.stagnation
    M = fwd.M
    rng = np.random.default_rng(seed)
    phi0 = np.stack([init_phi_random_2d(n - 1, n - 1, DELTA_SEP, amp=0.1,
                                        seed=42 + i) for i in range(B)])
    u = 0.1 * rng.standard_normal((B, M + 1, n, n))
    phi_T, phi_Q = build_targets_2d(fwd.x, fwd.y, fwd.t_hist,
                                    init_phi_random_2d(n - 1, n - 1,
                                                       DELTA_SEP), 1.0, 1.0, T)
    host = dict(phi0=phi0, u=u, phiT=np.broadcast_to(phi_T, (B, n, n)),
                phiQ=np.broadcast_to(phi_Q, (B, M + 1, n, n)),
                b1=np.linspace(0.3, 5.0, B), b2=np.linspace(13.0, 10.0, B))
    as_dev = lambda dtype: {k: torch.as_tensor(np.ascontiguousarray(v),
                                               dtype=dtype, device=device)
                            for k, v in host.items()}
    return solvers, as_dev(torch.float32), as_dev(torch.float64)


def kernel_case(torch, n, B, T, device, seed=0, reps=3):
    """Phase 2 at one shape: each per-member kernel against its plain
    version on the same float32 inputs, and both against the plain version
    in float64 (the float32 noise floor the comparison has to be read
    against). Returns a dict of the measured numbers."""
    from vch_tpu_torch.ops import march as km

    solvers, x, x64 = _problem_inputs(torch, n, B, T, device, seed)
    (fwd, adj), (fwd64, adj64) = solvers["float32"], solvers["float64"]
    if fwd.config.resolved_fused_block() and B % 8 == 0:
        raise RuntimeError(f"n={n} B={B} would take the blocked kernels")
    M = fwd.M

    # forward march
    fwd.entries = km.KERNELS
    kh, kns, kbad = fwd.march_fused_batch(x["u"], x["phi0"])
    torch.cuda.synchronize()
    fwd.entries = km.PLAIN
    march_plain_ms, (ph, pns, pbad) = _host_ms(
        torch, lambda: fwd.march_fused_batch(x["u"], x["phi0"]))
    h64, _, _ = fwd64.march_fused_batch(x64["u"], x64["phi0"])
    if not torch.isfinite(kh).all():
        raise RuntimeError(f"n={n}: non-finite kernel phi")
    if not torch.equal(kbad, pbad):
        raise RuntimeError(f"n={n}: first_bad differs {kbad} vs {pbad}")

    # adjoint sweep, all on the plain float32 history
    args = lambda v, hist: (hist, v["b1"], v["b2"], v["phiQ"], v["phiT"])
    adj.entries = km.KERNELS
    kr = adj.adjoint_fused_batch(*args(x, ph))
    torch.cuda.synchronize()
    adj.entries = km.PLAIN
    adjoint_plain_ms, pr = _host_ms(
        torch, lambda: adj.adjoint_fused_batch(*args(x, ph)))
    r64 = adj64.adjoint_fused_batch(*args(x64, ph.double()))
    if not torch.isfinite(kr).all():
        raise RuntimeError(f"n={n}: non-finite kernel r")

    out = dict(n=n, B=B, M=M,
               max_abs_dphi=(kh - ph).abs().max().item(),
               dphi_kernel_vs_f64=(kh.double() - h64).abs().max().item(),
               dphi_plain_vs_f64=(ph.double() - h64).abs().max().item(),
               newton_kernel=kns.cpu().tolist(),
               newton_plain=pns.cpu().tolist(),
               max_abs_dr=(kr - pr).abs().max().item(),
               rel_dr=_rel(kr, pr, pr),
               rel_r_kernel_vs_f64=_rel(kr, r64, r64),
               rel_r_plain_vs_f64=_rel(pr, r64, r64))
    fwd.entries = adj.entries = km.KERNELS
    out["march_ms"] = time_ms(
        lambda: fwd.march_fused_batch(x["u"], x["phi0"]), reps)
    out["adjoint_ms"] = time_ms(
        lambda: adj.adjoint_fused_batch(*args(x, ph)), reps)
    out["march_plain_ms"] = march_plain_ms
    out["adjoint_plain_ms"] = adjoint_plain_ms
    return out


def check_kernel_case(c, short: bool):
    """Phase 2 gates, besides equal first_bad (checked in kernel_case).

    - Newton totals within 1%: a step that converges right at the tolerance
      may take one more iteration when sums run in another order.
    - Forward, short shapes: max|dphi| <= 1e-5. At the 100-step bucket
      shape any two float32 marches drift apart within the Newton
      tolerance's slack (plain vs kernel 7.8e-4, each ~5.8e-4 from the
      float64 march on the H100), so there the kernel must be as close to
      the float64 march as the plain float32 march is, within 2x.
    - Adjoint, every shape: the same float64-referenced gate, plus kernel
      vs plain <= 5e-3 relative. Two float32 sweeps of the condition-1e6
      operator differ by about the float32 noise floor whatever computes
      them: on the H100 at n = 129 the plain sweep on the card and on the
      CPU differ by 9.5e-4 (M = 5), and kernel and plain are each 2.3e-3
      from float64 at M = 100 (vch_tpu records 2.8e-3 float32 vs float64
      at 128^2). A 1e-4 bound, the TPU's own fused-vs-scan agreement,
      sits below that floor.
    """
    nk, npl = sum(c["newton_kernel"]), sum(c["newton_plain"])
    fails = []
    if abs(nk - npl) > 0.01 * npl:
        fails.append(f"Newton solves {nk} vs {npl}")
    if short and c["max_abs_dphi"] > 1e-5:
        fails.append(f"max|dphi| {c['max_abs_dphi']} > 1e-5")
    if not short and c["dphi_kernel_vs_f64"] > 2 * c["dphi_plain_vs_f64"] + 1e-6:
        fails.append("march kernel farther from float64 than plain f32")
    fails += _adjoint_gate(c)
    if fails:
        raise RuntimeError(f"n={c['n']} B={c['B']} M={c['M']}: "
                           + "; ".join(fails))


def _adjoint_gate(c):
    """The float64-referenced adjoint gate of check_kernel_case. Where the
    case also ran the plain sweep on the CPU (rel_r_plain_cpu_vs_f64), the
    kernel is held to twice the farther of the two plain float32 sweeps:
    at n = 65 one plain sweep's distance from float64 is not a stable
    reference (on the H100 the card's plain sweep read 1.07e-4 where
    the kernel read 1.9-2.6e-4, and ROADMAP records 2.1e-4 between any two
    float32 sweeps at n = 65)."""
    fails = []
    ref = max(c["rel_r_plain_vs_f64"], c.get("rel_r_plain_cpu_vs_f64", 0.0))
    if c["rel_r_kernel_vs_f64"] > 2 * ref + 1e-6:
        fails.append("adjoint kernel farther from float64 than plain f32")
    if c["rel_dr"] > 5e-3:
        fails.append(f"adjoint kernel vs plain rel {c['rel_dr']} > 5e-3")
    return fails


def _plain_on_cpu(solver, method, *args):
    """The plain version of `solver.method` on the CPU, on copies of args:
    a second float32 implementation (CPU library sums) for the adjoint
    gate's reference spread."""
    cpu = type(solver)(solver.config, device="cpu")
    return getattr(cpu, method)(*[a.cpu() for a in args])


def blocked_case(torch, n, B, T, device, plain_members, reps=3):
    """Phase 2b: the blocked kernels (the solvers' route at B % 8 == 0)
    against the per-member kernels on all B members, and against the plain
    versions in float32 and float64 on the first plain_members members.
    The blocked and the per-member kernels run in turns (per-member,
    blocked, blocked, per-member) for their CUDA-event times; the march's
    cluster geometry and its bound (_march_work on the measured Newton
    total) go with them."""
    from vch_tpu_torch.ops import march as km

    solvers, x, x64 = _problem_inputs(torch, n, B, T, device)
    (fwd, adj), (fwd64, adj64) = solvers["float32"], solvers["float64"]
    bb = fwd.config.resolved_fused_block()
    if bb != 8 or B % bb:
        raise RuntimeError(f"n={n} B={B}: expected the blocked route, "
                           f"block {bb}")
    M = fwd.M
    fargs = (fwd.dts, x["phi0"], x["u"]) + fwd._ops()
    bh, bns, bbad = fwd.march_fused_batch(x["u"], x["phi0"])     # blocked
    kh, kns, kbad = km.march_fused_2d(*fargs, **fwd._march_kw())
    torch.cuda.synchronize()
    aargs = lambda v, hist: (hist, v["b1"], v["b2"], v["phiQ"], v["phiT"])
    br = adj.adjoint_fused_batch(*aargs(x, kh))                 # blocked
    kr = km.adjoint_fused_2d(adj.dts, kh, x["phiQ"], x["phiT"], x["b1"],
                             x["b2"], *adj._ops(), **adj._kw())
    torch.cuda.synchronize()

    P = plain_members
    sub = lambda v: {k: t[:P].contiguous() for k, t in v.items()}
    xs, x64s = sub(x), sub(x64)
    fwd.entries = adj.entries = km.PLAIN
    march_plain_ms, (ph, pns, pbad) = _host_ms(
        torch, lambda: fwd.march_fused_batch(xs["u"], xs["phi0"]))
    adjoint_plain_ms, pr = _host_ms(
        torch, lambda: adj.adjoint_fused_batch(*aargs(xs, ph)))
    fwd.entries = adj.entries = km.KERNELS
    h64, _, _ = fwd64.march_fused_batch(x64s["u"], x64s["phi0"])
    r64 = adj64.adjoint_fused_batch(*aargs(x64s, ph.double()))
    # the blocked sweep on the plain history of the first members
    brs = adj.adjoint_fused_batch(*aargs(xs, ph))
    pr_cpu = _plain_on_cpu(adj, "adjoint_fused_batch", *aargs(xs, ph))
    torch.cuda.synchronize()
    if not (torch.isfinite(bh).all() and torch.isfinite(br).all()):
        raise RuntimeError(f"n={n} B={B}: non-finite blocked output")

    out = dict(n=n, B=B, M=M, block=bb, plain_members=P,
               blocked_equals_per_member=bool(
                   torch.equal(bh, kh) and torch.equal(bns, kns)
                   and torch.equal(bbad, kbad) and torch.equal(br, kr)),
               max_abs_dphi=(bh[:P] - ph).abs().max().item(),
               dphi_kernel_vs_f64=(bh[:P].double() - h64).abs().max().item(),
               dphi_plain_vs_f64=(ph.double() - h64).abs().max().item(),
               newton_blocked=bns[:P].cpu().tolist(),
               newton_plain=pns.cpu().tolist(),
               newton_blocked_total=int(bns.sum()),
               newton_per_member_total=int(kns.sum()),
               first_bad_equal=bool(torch.equal(bbad[:P], pbad)),
               max_abs_dr=(brs - pr).abs().max().item(),
               rel_dr=_rel(brs, pr, pr),
               rel_r_kernel_vs_f64=_rel(brs, r64, r64),
               rel_r_plain_vs_f64=_rel(pr, r64, r64),
               rel_r_plain_cpu_vs_f64=_rel(pr_cpu, r64.cpu(), r64),
               march_plain_ms=march_plain_ms,
               adjoint_plain_ms=adjoint_plain_ms)
    blocked_m = lambda: fwd.march_fused_batch(x["u"], x["phi0"])
    member_m = lambda: km.march_fused_2d(*fargs, **fwd._march_kw())
    blocked_a = lambda: adj.adjoint_fused_batch(*aargs(x, kh))
    member_a = lambda: km.adjoint_fused_2d(
        adj.dts, kh, x["phiQ"], x["phiT"], x["b1"], x["b2"], *adj._ops(),
        **adj._kw())
    for name, fn in (("per_member", member_m), ("blocked", blocked_m),
                     ("blocked", blocked_m), ("per_member", member_m)):
        out.setdefault(f"march_{name}_ms", []).append(time_ms(fn, reps))
    one_cta_a = lambda: km._adjoint_fused_2d_cta(
        adj.dts, kh, x["phiQ"], x["phiT"], x["b1"], x["b2"], *adj._ops(),
        **adj._kw())
    out["one_cta_equals_per_member"] = bool(torch.equal(one_cta_a(), kr))
    for name, fn in (("one_cta", one_cta_a), ("per_member", member_a),
                     ("blocked", blocked_a), ("blocked", blocked_a),
                     ("per_member", member_a), ("one_cta", one_cta_a)):
        out.setdefault(f"adjoint_{name}_ms", []).append(time_ms(fn, reps))
    out["march_geometry"] = _geometry(km, torch, device, n, B, 8)
    out["march_bound_ms"], out["march_bound_by"] = _bound(*_march_work(
        n, B, M, out["newton_blocked_total"],
        fwd.config.fused_krylov_fixed_iters))
    out["adjoint_bound_ms"], out["adjoint_bound_by"] = _bound(*_adjoint_work(
        n, B, M, fwd.config.adjoint_krylov_fixed_iters))
    out["adjoint_geometry"] = _geometry(km, torch, device, n, B, 8,
                                        kernel="sweep")
    return out


def _geometry(km, torch, device, n, B, members, segment=False,
              kernel="march"):
    """The launch geometry of a cluster kernel for B members of an (n, n)
    grid, `members` per cluster: cluster, CTAs, band rows, units, passes,
    ring rows, shared bytes and how many such clusters the card holds."""
    g = km.launch_geometry(n, n, B, device, members=members,
                           segment=segment, kernel=kernel)
    idx = torch.device(device).index or 0
    return dict(cluster=g.cluster, ctas=B // members * g.cluster,
                band_rows=[r for _, r in g.bands], units=g.units,
                passes=g.passes, kc=g.kc, smem_bytes=g.smem_bytes,
                resident_clusters=km.resident_clusters(
                    idx, n, n, g.cluster, g.kc, g.smem_bytes, members,
                    segment, kernel))


def check_blocked_case(c, short: bool):
    """Phase 2b gates for the blocked kernels: bit-equal to the per-member
    kernels on every member (their arithmetic per member does not depend on
    the members per CTA), per-member Newton counts equal to the plain
    version's, max|dphi| <= 1e-5 against the plain version on the short
    shape (the float64-referenced gate of phase 2 on the 100-step shape),
    and the phase-2 adjoint gate."""
    fails = []
    if not c["blocked_equals_per_member"]:
        fails.append("blocked differs from the per-member kernels")
    if not c["one_cta_equals_per_member"]:
        fails.append("the one-member sweep differs from its one-CTA oracle")
    if c["newton_blocked"] != c["newton_plain"]:
        fails.append(f"Newton counts {c['newton_blocked']} vs plain "
                     f"{c['newton_plain']}")
    if not c["first_bad_equal"]:
        fails.append("first_bad differs from plain")
    if short and c["max_abs_dphi"] > 1e-5:
        fails.append(f"max|dphi| {c['max_abs_dphi']} > 1e-5")
    if not short and c["dphi_kernel_vs_f64"] > 2 * c["dphi_plain_vs_f64"] + 1e-6:
        fails.append("blocked march farther from float64 than plain f32")
    fails += _adjoint_gate(c)
    if fails:
        raise RuntimeError(f"blocked n={c['n']} B={c['B']} M={c['M']}: "
                           + "; ".join(fails))


def segment_case(torch, device, n=65, B=4, K=5, T=0.1, reps=3):
    """Phase 2b: the segment kernels chained over M / K segments, as the
    low-memory path chains them, against the whole march and sweep kernels;
    each segment launch against its plain version on the same inputs, in
    float32 on the card and in float64 (and, for the sweep, in float32 on
    the CPU: the spread of two float32 implementations); each segment march
    launch against the one-CTA oracle on the same inputs, bit for bit."""
    from vch_tpu_torch.ops import march as km

    solvers, x, x64 = _problem_inputs(torch, n, B, T, device)
    (fwd, adj), (fwd64, adj64) = solvers["float32"], solvers["float64"]
    M = fwd.M
    if M % K or B % 8 == 0:
        raise RuntimeError("segment case: M must divide by K, and B must "
                           "take the per-member whole kernels")
    f64 = lambda args: [a.double() for a in args]
    dist = lambda a, b: (a.double() - b.double()).abs().max().item()
    wh, wns, _ = fwd.march_fused_batch(x["u"], x["phi0"])
    fwd.entries = km.PLAIN
    ph, _, _ = fwd.march_fused_batch(x["u"], x["phi0"])
    fwd.entries = km.KERNELS
    h64, _, _ = fwd64.march_fused_batch(x64["u"], x64["phi0"])
    phi = x["phi0"]
    w = torch.zeros_like(phi)
    mu = fwd.initialize_mu(phi, w)
    m0 = torch.sum(fwd.wts * phi, dim=(-2, -1))
    frames, ns, ns_plain = [], torch.zeros_like(wns), torch.zeros_like(wns)
    err_march, seg_ms, seg_plain_ms = 0.0, [], []
    mk64, mp64 = [0.0] * 4, [0.0] * 4     # (hist, phi, mu, w) vs float64
    oracle_equal = True
    for start in range(0, M, K):
        u_seg = x["u"][:, start:start + K + 1].contiguous()
        sargs = (fwd.dts[start:start + K], phi, mu, w, m0, u_seg)
        ks = km.march_fused_2d_segment(*sargs, *fwd._ops(), **fwd._march_kw())
        ko = km._march_fused_2d_segment_cta(*sargs, *fwd._ops(),
                                            **fwd._march_kw())
        oracle_equal &= all(torch.equal(a, b) for a, b in zip(ks, ko))
        ms, ps = _host_ms(torch, lambda: km.march_fused_2d_segment_plain(
            *sargs, *fwd._ops(), **fwd._march_kw()))
        ps64 = km.march_fused_2d_segment_plain(*f64(sargs), *fwd64._ops(),
                                               **fwd64._march_kw())
        seg_plain_ms.append(ms)
        seg_ms.append(time_ms(lambda: km.march_fused_2d_segment(
            *sargs, *fwd._ops(), **fwd._march_kw()), reps))
        err_march = max([err_march] + [dist(a, b)
                                       for a, b in zip(ks[:4], ps[:4])])
        for i in range(4):
            mk64[i] = max(mk64[i], dist(ks[i], ps64[i]))
            mp64[i] = max(mp64[i], dist(ps[i], ps64[i]))
        frames.append(ks[0])
        phi, mu, w = ks[1], ks[2], ks[3]
        ns += ks[4]
        ns_plain += ps[4]
    hist = torch.cat([x["phi0"][:, None]] + frames, dim=1)

    # the sweep: terminal solve, then the segments in reverse
    p, q, r = adj.terminal(wh[:, M], x["phiT"], x["b2"])
    parts, err_adj, rel_adj, aseg_ms, aseg_plain_ms = [], 0.0, 0.0, [], []
    sweep_oracle_equal = True
    ak64 = ap64 = apc64 = 0.0             # segment r vs float64, relative
    for start in reversed(range(0, M, K)):
        sl = slice(start, start + K + 1)
        aargs = (adj.dts[start:start + K], wh[:, sl].contiguous(),
                 x["phiQ"][:, sl].contiguous(), p, q, r, x["b1"])
        kseg = km.adjoint_fused_2d_segment(*aargs, *adj._ops(), **adj._kw())
        oseg = km._adjoint_fused_2d_segment_cta(*aargs, *adj._ops(),
                                                **adj._kw())
        sweep_oracle_equal &= all(torch.equal(a, b)
                                  for a, b in zip(kseg, oseg))
        ms, pseg = _host_ms(torch, lambda: km.adjoint_fused_2d_segment_plain(
            *aargs, *adj._ops(), **adj._kw()))
        pseg64 = km.adjoint_fused_2d_segment_plain(*f64(aargs), *adj64._ops(),
                                                   **adj64._kw())
        pseg_cpu = km.adjoint_fused_2d_segment_plain(
            *[a.cpu() for a in aargs + adj._ops()], **adj._kw())
        aseg_plain_ms.append(ms)
        aseg_ms.append(time_ms(lambda: km.adjoint_fused_2d_segment(
            *aargs, *adj._ops(), **adj._kw()), reps))
        err_adj = max(err_adj, dist(kseg[0], pseg[0]))
        rel_adj = max([rel_adj] + [_rel(a, b, b) for a, b in zip(kseg, pseg)])
        ak64 = max(ak64, _rel(kseg[0], pseg64[0], pseg64[0]))
        ap64 = max(ap64, _rel(pseg[0], pseg64[0], pseg64[0]))
        apc64 = max(apc64, _rel(pseg_cpu[0], pseg64[0].cpu(), pseg64[0]))
        parts.insert(0, kseg[0])
        p, q, r = kseg[1], kseg[2], kseg[3]
    wr = adj.adjoint_fused_batch(wh, x["b1"], x["b2"], x["phiQ"], x["phiT"])
    rseg = torch.cat(parts + [torch.zeros_like(wr[:, :1])], dim=1)
    adj.entries = km.PLAIN
    pr = adj.adjoint_fused_batch(wh, x["b1"], x["b2"], x["phiQ"], x["phiT"])
    r64 = adj64.adjoint_fused_batch(wh.double(), x64["b1"], x64["b2"],
                                    x64["phiQ"], x64["phiT"])
    pr_cpu = _plain_on_cpu(adj, "adjoint_fused_batch", wh, x["b1"],
                           x["b2"], x["phiQ"], x["phiT"])
    adj.entries = km.KERNELS
    torch.cuda.synchronize()
    return dict(n=n, B=B, M=M, K=K,
                cluster_equals_cta=bool(oracle_equal),
                sweep_cluster_equals_cta=bool(sweep_oracle_equal),
                max_abs_dphi_chain_vs_whole=dist(hist, wh),
                dphi_chain_vs_f64=dist(hist, h64),
                dphi_plain_vs_f64=dist(ph, h64),
                newton_chain=ns.cpu().tolist(), newton_whole=wns.cpu().tolist(),
                newton_plain=ns_plain.cpu().tolist(),
                max_abs_err_march=err_march,
                seg_march_kernel_vs_f64=mk64, seg_march_plain_vs_f64=mp64,
                max_abs_err_adjoint=err_adj, rel_err_adjoint=rel_adj,
                seg_r_kernel_vs_f64=ak64, seg_r_plain_vs_f64=ap64,
                seg_r_plain_cpu_vs_f64=apc64,
                rel_dr=_rel(rseg, wr, wr),
                rel_r_plain_vs_plain_cpu=_rel(pr.cpu(), pr_cpu, pr),
                rel_r_kernel_vs_f64=_rel(rseg, r64, r64),
                rel_r_plain_vs_f64=_rel(pr, r64, r64),
                rel_r_plain_cpu_vs_f64=_rel(pr_cpu, r64.cpu(), r64),
                march_ms=float(np.mean(seg_ms)),
                march_plain_ms=float(np.mean(seg_plain_ms)),
                adjoint_ms=float(np.mean(aseg_ms)),
                adjoint_plain_ms=float(np.mean(aseg_plain_ms)))


def check_segment_case(c, short: bool):
    """Phase 2b gates of the segment chain. Every segment march launch is
    bit for bit its one-CTA oracle's (history, carry out, Newton counts,
    first_bad), and so is every segment sweep launch (r and the carry
    out). Newton counts of the chain equal the whole march's and the
    plain segments', member for member.

    - Short case (n = 65): the chain reproduces the whole march's history
      within 1e-5 (mu at t = 0 is formed outside the kernel: roundoff, not
      bit equality); each segment launch is within 1e-5 of its plain
      version (phi, mu, w) and within 2e-3 of |out|max for (r, p, q, r_f),
      the bound of the card tests; the chained sweep passes the phase-2
      adjoint gate against the whole sweep.
    - Phase 6's grid (n = 257): any two float32 implementations drift apart
      there by more than 1e-5 (the Laplacian's entries grow as n^2, so its
      products cancel more), so every comparison is the float64-referenced
      one of phase 2's 100-step shape: each segment output and the chained
      history no farther from float64 than 2x the plain float32 version's
      distance, each segment's r and the chained sweep no farther than 2x
      the farther plain float32 sweep (card or CPU); the chained sweep is
      within 5e-3 of the whole sweep, or within 2x the distance between
      the two plain float32 sweeps where that is larger.
    """
    fails = []
    tag = f"n={c['n']} B={c['B']} K={c['K']}"
    if not c["cluster_equals_cta"]:
        fails.append("the cluster segment march differs from the one-CTA "
                     "oracle")
    if not c["sweep_cluster_equals_cta"]:
        fails.append("the cluster segment sweep differs from the one-CTA "
                     "oracle")
    if c["newton_chain"] != c["newton_whole"]:
        fails.append(f"Newton counts {c['newton_chain']} vs whole "
                     f"{c['newton_whole']}")
    if c["newton_chain"] != c["newton_plain"]:
        fails.append(f"Newton counts {c['newton_chain']} vs plain "
                     f"{c['newton_plain']}")
    if short:
        if c["max_abs_dphi_chain_vs_whole"] > 1e-5:
            fails.append(f"chain vs whole max|dphi| "
                         f"{c['max_abs_dphi_chain_vs_whole']} > 1e-5")
        if c["max_abs_err_march"] > 1e-5:
            fails.append(f"segment march vs plain {c['max_abs_err_march']}")
        if c["rel_err_adjoint"] > 2e-3:
            fails.append(f"segment adjoint vs plain rel "
                         f"{c['rel_err_adjoint']}")
        fails += _adjoint_gate(c)
    else:
        if c["dphi_chain_vs_f64"] > 2 * c["dphi_plain_vs_f64"] + 1e-6:
            fails.append("chained history farther from float64 than the "
                         "plain float32 march")
        for i, out in enumerate(("hist", "phi_f", "mu_f", "w_f")):
            if (c["seg_march_kernel_vs_f64"][i]
                    > 2 * c["seg_march_plain_vs_f64"][i] + 1e-6):
                fails.append(f"segment march {out} farther from float64 "
                             "than plain float32")
        if c["seg_r_kernel_vs_f64"] > 2 * max(
                c["seg_r_plain_vs_f64"], c["seg_r_plain_cpu_vs_f64"]) + 1e-6:
            fails.append("segment sweep farther from float64 than plain f32")
        ref = max(c["rel_r_plain_vs_f64"], c["rel_r_plain_cpu_vs_f64"])
        if c["rel_r_kernel_vs_f64"] > 2 * ref + 1e-6:
            fails.append("chained sweep farther from float64 than plain f32")
        ceiling = max(5e-3, 2 * c["rel_r_plain_vs_plain_cpu"])
        if c["rel_dr"] > ceiling:
            fails.append(f"chained vs whole sweep rel {c['rel_dr']} > "
                         f"{ceiling}")
    if fails:
        raise RuntimeError(f"segment chain {tag}: " + "; ".join(fails))


def segment_timing(torch, device, n=257, B=32, K=10, reps=1, clusters=()):
    """Phase 2b: one K-step segment march of B members from seeded initial
    conditions under a seeded control, on the cluster kernel and on the
    one-CTA oracle, bit-gated against each other and timed in turns
    (oracle, cluster, cluster, oracle; CUDA events), with the cluster
    geometry and the bound (_march_work on the measured Newton total);
    then on each cluster size of `clusters` in place of the launch
    geometry's, bit-gated and timed likewise, with how many such clusters
    the card holds at once."""
    from vch_tpu_torch.config import DELTA_SEP
    from vch_tpu_torch.models.forward2d import ForwardSolver2D
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.ops.potential import init_phi_random_2d

    fwd = ForwardSolver2D(_config(n - 1, T=K * 0.01), device=device)
    if fwd.M != K:
        raise RuntimeError(f"segment timing: {fwd.M} steps, expected {K}")
    rng = np.random.default_rng(0)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    phi0 = f32(np.stack([init_phi_random_2d(n - 1, n - 1, DELTA_SEP,
                                            amp=0.1, seed=42 + i)
                         for i in range(B)]))
    u = f32(0.1 * rng.standard_normal((B, K + 1, n, n)))
    w = torch.zeros_like(phi0)
    args = (fwd.dts, phi0, fwd.initialize_mu(phi0, w), w,
            torch.sum(fwd.wts * phi0, dim=(-2, -1)), u) + fwd._ops()
    new = lambda: km.march_fused_2d_segment(*args, **fwd._march_kw())
    old = lambda: km._march_fused_2d_segment_cta(*args, **fwd._march_kw())
    ks, ko = new(), old()
    torch.cuda.synchronize()
    out = dict(n=n, B=B, K=K,
               cluster_equals_cta=all(torch.equal(a, b)
                                      for a, b in zip(ks, ko)),
               newton_total=int(ks[4].sum()))
    for name, fn in (("cta", old), ("cluster", new), ("cluster", new),
                     ("cta", old)):
        out.setdefault(f"{name}_ms", []).append(time_ms(fn, reps))
    out["geometry"] = _geometry(km, torch, device, n, B,
                                km.SEGMENT_MEMBERS, segment=True)
    out["bound_ms"], out["bound_by"] = _bound(*_march_work(
        n, B, K, out["newton_total"], fwd.config.fused_krylov_fixed_iters,
        segment=True))
    fitted = km.launch_geometry
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    idx = torch.device(device).index or 0
    try:
        for C in clusters:
            gc = km.blocked_geometry(n, n, B, sms, cluster=C,
                                     members=km.SEGMENT_MEMBERS)
            km.launch_geometry = lambda *a, **k: gc
            kc_ = new()
            out.setdefault("other_clusters", []).append(dict(
                cluster=C, equal=all(torch.equal(a, b)
                                     for a, b in zip(kc_, ko)),
                ms=[time_ms(new, reps) for _ in range(2)],
                resident_clusters=km.resident_clusters(
                    idx, n, n, C, gc.kc, gc.smem_bytes, gc.members, True)))
    finally:
        km.launch_geometry = fitted
    del ks, ko, args, u
    return out


def _other_clusters(C, n, prefer):
    """Two cluster sizes other than the launch geometry's C: the first two
    of `prefer` (then C - 1, C + 1) that differ from it and fit n."""
    out = []
    for c in tuple(prefer) + (C - 1, C + 1):
        if c != C and 1 <= c <= min(16, n) and c not in out:
            out.append(c)
    return tuple(out[:2])


def sweep_segment_timing(torch, device, n=257, B=32, K=10, reps=1,
                         prefer=(8, 4)):
    """Phase 2b, row 6: one K-step segment sweep of B members, on the
    cluster kernel and on the one-CTA oracle, from a seeded march's history
    (seeded phi_Q, b1, b2 and terminal targets, the terminal carry), bit-
    gated against each other (r, p_f, q_f, r_f), once more with one dt set
    to 0 (that step copies the next level), and timed in turns (oracle,
    cluster, cluster, oracle; CUDA events), with the cluster geometry and
    the bound (_adjoint_work, trips in full); then on two other cluster
    sizes (`_other_clusters`), bit-gated and timed likewise."""
    from vch_tpu_torch.models.adjoint2d import AdjointSolver2D
    from vch_tpu_torch.ops import march as km

    fwd, margs = _seeded_march(torch, device, n, B, K * 0.01)
    if fwd.M != K:
        raise RuntimeError(f"sweep timing: {fwd.M} steps, expected {K}")
    hist = km.march_fused_2d(*margs, **fwd._march_kw())[0]
    adj = AdjointSolver2D(fwd.config, device=device)
    rng = np.random.default_rng(2)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    b1, b2 = f32(np.linspace(0.3, 5.0, B)), f32(np.linspace(13.0, 10.0, B))
    p, q, r = adj.terminal(hist[:, K], 0.1 * margs[1], b2)
    args = (adj.dts, hist, f32(0.3 * rng.standard_normal(tuple(hist.shape))),
            p, q, r, b1) + adj._ops()
    kw = adj._kw()
    zero = K // 2
    zdts = adj.dts.clone()
    zdts[zero] = 0.0
    zargs = (zdts,) + args[1:]
    new = lambda a=args: km.adjoint_fused_2d_segment(*a, **kw)
    old = lambda a=args: km._adjoint_fused_2d_segment_cta(*a, **kw)
    same = lambda x, y: all(torch.equal(u, v) for u, v in zip(x, y))
    ks, ko, zs, zo = new(), old(), new(zargs), old(zargs)
    torch.cuda.synchronize()
    out = dict(n=n, B=B, K=K, cluster_equals_cta=same(ks, ko),
               zero_dt_equals_cta=same(zs, zo),
               zero_dt_copies=bool(torch.equal(zs[0][:, zero],
                                               zs[0][:, zero + 1])),
               finite=all(bool(torch.isfinite(t).all()) for t in ks))
    for name, fn in (("cta", old), ("cluster", new), ("cluster", new),
                     ("cta", old)):
        out.setdefault(f"{name}_ms", []).append(time_ms(fn, reps))
    out["geometry"] = _geometry(km, torch, device, n, B, 1, segment=True,
                                kernel="sweep")
    out["bound_ms"], out["bound_by"] = _bound(*_adjoint_work(
        n, B, K, fwd.config.adjoint_krylov_fixed_iters, segment=True))
    fitted = km.launch_geometry
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    idx = torch.device(device).index or 0
    try:
        for C in _other_clusters(out["geometry"]["cluster"], n, prefer):
            gc = km.blocked_geometry(n, n, B, sms, cluster=C, members=1,
                                     kernel="sweep")
            km.launch_geometry = lambda *a, **k: gc
            out.setdefault("other_clusters", []).append(dict(
                cluster=C, equal=same(new(), ko),
                zero_dt_equal=same(new(zargs), zo),
                ms=[time_ms(new, reps) for _ in range(2)],
                resident_clusters=km.resident_clusters(
                    idx, n, n, C, gc.kc, gc.smem_bytes, 1, True, "sweep")))
    finally:
        km.launch_geometry = fitted
    del ks, ko, zs, zo, args, zargs, hist
    return out


def check_sweep_timing(c):
    """The gates of a cluster sweep's timing case (row 2's whole sweep, with
    M steps, or row 6's segment sweep, with K): bit for bit the one-CTA
    oracle with and without a zero dt step, at every cluster size tried; the
    zero dt step copies the next level; r finite."""
    fails = []
    if not (c["cluster_equals_cta"] and c["zero_dt_equals_cta"]):
        fails.append("the cluster sweep differs from the one-CTA oracle")
    if not all(o["equal"] and o["zero_dt_equal"]
               for o in c.get("other_clusters", ())):
        fails.append("the cluster sweep's bits depend on its cluster size")
    if not (c["zero_dt_copies"] and c["finite"]):
        fails.append("a zero dt step did not copy the next level, or r is "
                     "not finite")
    if fails:
        steps = f"K={c['K']}" if "K" in c else f"M={c['M']}"
        raise RuntimeError(f"sweep n={c['n']} B={c['B']} {steps}: "
                           + "; ".join(fails))


def _seeded_march(torch, device, n, B, T):
    """A float32 forward solver at (n - 1, T) and seeded inputs of B
    members: phi0 from init_phi_random_2d (seed 42 + i), u = 0.1 N(0, 1)."""
    from vch_tpu_torch.config import DELTA_SEP
    from vch_tpu_torch.models.forward2d import ForwardSolver2D
    from vch_tpu_torch.ops.potential import init_phi_random_2d

    fwd = ForwardSolver2D(_config(n - 1, T=T), device=device)
    rng = np.random.default_rng(0)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    phi0 = f32(np.stack([init_phi_random_2d(n - 1, n - 1, DELTA_SEP,
                                            amp=0.1, seed=42 + i)
                         for i in range(B)]))
    u = f32(0.1 * rng.standard_normal((B, fwd.M + 1, n, n)))
    return fwd, (fwd.dts, phi0, u) + fwd._ops()


def march_timing(torch, device, n, B, T=1.0, reps=1):
    """Row 1: the whole march of B members on the cluster kernel (one
    member per cluster, `march_fused_2d`) and on its one-CTA oracle
    (`_march_fused_2d_cta`, two CTAs per SM where B exceeds the SMs), from
    seeded inputs: bit-gated against each other (history, Newton counts,
    first_bad) and timed in turns (oracle, cluster, cluster, oracle; CUDA
    events), with the cluster geometry, how many clusters the card holds at
    once and the bound (_march_work on the measured Newton total)."""
    from vch_tpu_torch.ops import march as km

    fwd, args = _seeded_march(torch, device, n, B, T)
    new = lambda: km.march_fused_2d(*args, **fwd._march_kw())
    old = lambda: km._march_fused_2d_cta(*args, **fwd._march_kw())
    kc, ko = new(), old()
    torch.cuda.synchronize()
    out = dict(n=n, B=B, M=fwd.M,
               cluster_equals_cta=all(torch.equal(a, b)
                                      for a, b in zip(kc, ko)),
               finite=bool(torch.isfinite(kc[0]).all()),
               newton_total=int(kc[1].sum()))
    for name, fn in (("cta", old), ("cluster", new), ("cluster", new),
                     ("cta", old)):
        out.setdefault(f"{name}_ms", []).append(time_ms(fn, reps))
    out["geometry"] = _geometry(km, torch, device, n, B, 1)
    out["bound_ms"], out["bound_by"] = _bound(*_march_work(
        n, B, fwd.M, out["newton_total"], fwd.config.fused_krylov_fixed_iters))
    del kc, ko, args
    return out


def sweep_timing(torch, device, n, B, T=1.0, reps=1, clusters=()):
    """Row 2: the whole sweep of B members on the cluster kernel (one
    member per cluster, `adjoint_fused_2d`) and on its one-CTA oracle
    (`_adjoint_fused_2d_cta`), from a seeded march's history (seeded phi_Q,
    b1, b2 and terminal targets): bit-gated against each other (r), once
    more with one dt set to 0 (that step copies the next level), and timed
    in turns (oracle, cluster, cluster, oracle; CUDA events), with the
    cluster geometry, how many clusters the card holds at once and the
    bound (_adjoint_work, trips in full); then on the cluster sizes
    `clusters`, bit-gated and timed likewise."""
    from vch_tpu_torch.models.adjoint2d import AdjointSolver2D
    from vch_tpu_torch.ops import march as km

    fwd, margs = _seeded_march(torch, device, n, B, T)
    hist = km.march_fused_2d(*margs, **fwd._march_kw())[0]
    adj = AdjointSolver2D(fwd.config, device=device)
    rng = np.random.default_rng(2)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    args = (adj.dts, hist, f32(0.3 * rng.standard_normal(tuple(hist.shape))),
            0.1 * margs[1], f32(np.linspace(0.3, 5.0, B)),
            f32(np.linspace(13.0, 10.0, B))) + adj._ops()
    kw = adj._kw()
    zero = fwd.M // 2
    zdts = adj.dts.clone()
    zdts[zero] = 0.0
    zargs = (zdts,) + args[1:]
    new = lambda a=args: km.adjoint_fused_2d(*a, **kw)
    old = lambda a=args: km._adjoint_fused_2d_cta(*a, **kw)
    kr, ko, zr, zo = new(), old(), new(zargs), old(zargs)
    torch.cuda.synchronize()
    out = dict(n=n, B=B, M=fwd.M, cluster_equals_cta=bool(torch.equal(kr, ko)),
               zero_dt_equals_cta=bool(torch.equal(zr, zo)),
               zero_dt_copies=bool(torch.equal(zr[:, zero], zr[:, zero + 1])),
               finite=bool(torch.isfinite(kr).all()))
    for name, fn in (("cta", old), ("cluster", new), ("cluster", new),
                     ("cta", old)):
        out.setdefault(f"{name}_ms", []).append(time_ms(fn, reps))
    out["geometry"] = _geometry(km, torch, device, n, B, 1, kernel="sweep")
    out["bound_ms"], out["bound_by"] = _bound(*_adjoint_work(
        n, B, fwd.M, fwd.config.adjoint_krylov_fixed_iters))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    fitted, others = km.launch_geometry, []
    try:
        for C in clusters:
            if C == out["geometry"]["cluster"]:
                continue
            gc = km.blocked_geometry(n, n, B, sms, cluster=C, members=1,
                                     kernel="sweep")
            km.launch_geometry = lambda *a, **k: gc
            others.append(dict(cluster=C, equal=bool(torch.equal(new(), ko)),
                               zero_dt_equal=bool(torch.equal(new(zargs),
                                                              zo)),
                               ms=time_ms(new, reps)))
    finally:
        km.launch_geometry = fitted
    out["other_clusters"] = others
    del kr, ko, zr, zo, args, zargs, hist
    return out


def block_sizes_case(torch, device, n=65, B=8, T=0.1, reps=3):
    """Fault C2: the blocked march at block_b = 2 and 4 against block_b = 8,
    the one-member march and its one-CTA oracle, bit for bit (history,
    Newton counts, first_bad); the blocked sweep (the cluster sweep) at
    block_b = 2, 4 and 8 against the one-CTA one-member sweep bit for bit,
    and against the plain sweep in float64 on the march's history (the
    phase-2 adjoint gate: no farther from float64 than twice the
    one-member sweep plus 1e-6, and within 5e-3 of it); the CUDA-event
    times of each, and each block's sweep geometry."""
    from vch_tpu_torch.models.adjoint2d import AdjointSolver2D
    from vch_tpu_torch.ops import march as km

    fwd, args = _seeded_march(torch, device, n, B, T)
    kw = fwd._march_kw()
    ref = km.march_fused_2d(*args, **kw)
    oracle = km._march_fused_2d_cta(*args, **kw)
    hist = ref[0]
    rng = np.random.default_rng(1)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    adj = AdjointSolver2D(fwd.config, device=device)
    aargs = (adj.dts, hist, f32(0.3 * rng.standard_normal(tuple(hist.shape))),
             0.1 * args[1], f32(np.linspace(0.3, 5.0, B)),
             f32(np.linspace(13.0, 10.0, B))) + adj._ops()
    r1 = km.adjoint_fused_2d(*aargs, **adj._kw())
    r64 = km.adjoint_fused_2d_plain(*[t.double() for t in aargs],
                                    **adj._kw())
    rel = lambda x, y: _rel(x, y, y)
    out = dict(n=n, B=B, M=fwd.M,
               one_member_equals_cta=all(torch.equal(a, b)
                                         for a, b in zip(ref, oracle)),
               rel_r_one_member_vs_f64=rel(r1, r64),
               march_ms={"1": time_ms(lambda: km.march_fused_2d(*args, **kw),
                                      reps)},
               adjoint_ms={"1": time_ms(lambda: km.adjoint_fused_2d(
                   *aargs, **adj._kw()), reps)}, blocks={})
    for bb in (2, 4, 8):
        m = lambda: km.march_fused_2d_blocked(*args, block_b=bb, **kw)
        a = lambda: km.adjoint_fused_2d_blocked(*aargs, block_b=bb,
                                                **adj._kw())
        bm, br = m(), a()
        torch.cuda.synchronize()
        out["blocks"][bb] = dict(
            march_equals_one_member=all(torch.equal(x, y)
                                        for x, y in zip(bm, ref)),
            sweep_equals_one_member=bool(torch.equal(br, r1)),
            rel_r_vs_f64=rel(br, r64), rel_r_vs_one_member=rel(br, r1),
            geometry=km.launch_geometry(n, n, B, device,
                                        members=bb)._asdict(),
            sweep_geometry=_geometry(km, torch, device, n, B, bb,
                                     kernel="sweep"))
        out["blocks"][bb]["geometry"].pop("bands")
        out["march_ms"][str(bb)] = time_ms(m, reps)
        out["adjoint_ms"][str(bb)] = time_ms(a, reps)
    del ref, oracle, hist, aargs, args
    return out


def check_block_sizes_case(c):
    fails = []
    if not c["one_member_equals_cta"]:
        fails.append("the one-member march differs from its one-CTA oracle")
    for bb, d in c["blocks"].items():
        if not d["march_equals_one_member"]:
            fails.append(f"block {bb}: the march differs from the "
                         "one-member march")
        if not d["sweep_equals_one_member"]:
            fails.append(f"block {bb}: the cluster sweep differs from the "
                         "one-CTA sweep")
        if d["rel_r_vs_f64"] > 2 * c["rel_r_one_member_vs_f64"] + 1e-6:
            fails.append(f"block {bb}: the sweep is farther from float64 "
                         "than the one-member sweep")
        if d["rel_r_vs_one_member"] > 5e-3:
            fails.append(f"block {bb}: sweep vs one-member sweep rel "
                         f"{d['rel_r_vs_one_member']}")
    if fails:
        raise RuntimeError("block sizes 2, 4, 8: " + "; ".join(fails))


def blocked_rule_timing(torch, device, B, n=65, T=1.0, reps=1):
    """Row 3's cluster rule at one of the headline's straggler buckets: the
    blocked march (8 members per cluster) of B seeded members on the
    geometry of its former rule (clusters of 16, or 8 where 16 are not all
    resident) and on the launch geometry, which then shrinks the cluster
    one CTA at a time until every cluster is resident, bit-gated against
    each other and timed in turns (rule, search, search, rule)."""
    from vch_tpu_torch.ops import march as km

    fwd, args = _seeded_march(torch, device, n, B, T)
    kw = fwd._march_kw()
    idx = torch.device(device).index or 0
    held = lambda g: km.resident_clusters(idx, n, n, g.cluster, g.kc,
                                          g.smem_bytes)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rule = km.blocked_geometry(n, n, B, sms)
    if rule.cluster > 8 and held(rule) < B // 8:
        rule = km.blocked_geometry(n, n, B, sms, max_cluster=8)
    search = km.launch_geometry(n, n, B, device)
    fitted = km.launch_geometry

    def on(geo):
        def run():
            km.launch_geometry = lambda *a, **k: geo
            try:
                return km.march_fused_2d_blocked(*args, block_b=8, **kw)
            finally:
                km.launch_geometry = fitted
        return run

    a, b = on(rule)(), on(search)()
    torch.cuda.synchronize()
    out = dict(n=n, B=B, M=fwd.M, equal=all(torch.equal(x, y)
                                            for x, y in zip(a, b)),
               rule_cluster=rule.cluster, rule_resident=held(rule),
               search_cluster=search.cluster, search_resident=held(search),
               clusters=B // 8)
    for name, geo in (("rule", rule), ("search", search), ("search", search),
                      ("rule", rule)):
        out.setdefault(f"{name}_ms", []).append(time_ms(on(geo), reps))
    del a, b, args
    return out


SOLVE_KERNELS = ("bicgstab_schur_spectral", "bicgstab_schur",
                 "bicgstab_adjoint_spectral", "bicgstab_adjoint")


def _solve_call(name, ops, fields, scal, fn, n_iter=None):
    """One call of a per-solve kernel entry (wrapper or plain version) on
    the arguments of _solve_args; n_iter defaults to the solver's trips
    (krylov_fixed_iters 4 for the Schur solves, adjoint_krylov_fixed_iters
    5 for the adjoint ones)."""
    kind = "schur" if "schur" in name else "adjoint"
    mats = ((ops.Vx_inv, ops.Vy_inv_T, ops.Vx, ops.VyT, ops.lam)
            if "spectral" in name
            else (ops.Lx, ops.LyT, ops.Vx_inv, ops.Vy_inv_T, ops.Vx, ops.VyT))
    vals, trips = scal[kind]
    return fn(*mats, *fields[kind], *vals,
              n_iter=trips if n_iter is None else n_iter)


def _solve_args(torch, device, n, B, seed=0):
    """The per-solve kernels' arguments from a real step: B members
    marched two steps (T = 0.02) from seeded ICs under a seeded control by
    the march kernel; from the float32 history, formed in float64, the Schur
    solve of a Newton iteration of the last step (its residual at phi_M
    with mu from the energy gradient) and the adjoint solve of the sweep's
    last step (the terminal p as rhs source and warm start). Returns the
    operators and fields in float32 and float64 and the scalars; B = None
    gives one (n, n) solve (member 0)."""
    from vch_tpu_torch.config import DELTA_SEP
    from vch_tpu_torch.models.forward2d import (mu_residual_2d,
                                                phi_residual_2d)
    from vch_tpu_torch.ops.laplacian import apply_laplacian_2d
    from vch_tpu_torch.ops.potential import fpp_log

    solvers, x, x64 = _problem_inputs(torch, n, B or 1, 0.02, device, seed)
    (fwd, _), (fwd64, adj64) = solvers["float32"], solvers["float64"]
    hist, _, _ = fwd.march_fused_batch(x["u"], x["phi0"])
    h = hist.double()
    cfg, ops, M = fwd64.config, fwd64.op, fwd64.M
    dt = float(fwd64.dts[-1])
    lap = lambda v: apply_laplacian_2d(ops.Lx, ops.LyT, v)
    mean = lambda v: v.mean(dim=(-2, -1), keepdim=True)
    zero = torch.zeros_like(h[:, M])
    phi, phi_old = h[:, M], h[:, M - 1]
    mu, mu_old = fwd64.initialize_mu(phi, zero), fwd64.initialize_mu(
        phi_old, zero)
    Rphi = phi_residual_2d(ops, phi, phi_old, mu, mu_old, zero, zero, dt,
                           cfg.tau, cfg.c1, cfg.c2, cfg.kappa, DELTA_SEP)
    Rmu = mu_residual_2d(ops, phi, phi_old, mu, mu_old, dt)
    d = 2.0 * cfg.c1 / (1.0 - torch.clamp(phi * phi, 0.0,
                                          1.0 - DELTA_SEP ** 2))
    denom = (1.0 / dt + 0.5 * cfg.kappa * ops.lam ** 2
             - (cfg.tau / dt + mean(d)) * ops.lam)
    p, _, _ = adj64.terminal(phi, x64["phiT"], x64["b2"])
    half = 0.5 * dt
    fpp_n, fpp_np1 = (fpp_log(v, cfg.c1, cfg.c2) for v in (phi_old, phi))
    w1 = lap(p)
    src = (phi_old - x64["phiQ"][:, M - 1]) + (phi - x64["phiQ"][:, M])
    rhs_a = (p - cfg.tau * w1 - half * lap(w1) + half * fpp_np1 * w1
             + half * x64["b1"].reshape(-1, 1, 1) * src)
    dena = (1.0 - cfg.tau * ops.lam + half * ops.lam ** 2
            - half * mean(fpp_n) * ops.lam)
    f64 = dict(schur=(denom, d, lap(Rphi) - Rmu),
               adjoint=(torch.rsqrt(torch.abs(dena)), fpp_n, rhs_a, p))
    pick = (lambda t: t.contiguous()) if B else (lambda t: t[0].contiguous())
    f64 = {k: tuple(pick(t) for t in v) for k, v in f64.items()}
    f32 = {k: tuple(t.float() for t in v) for k, v in f64.items()}
    scal = dict(schur=((1.0 / dt, cfg.tau / dt, 0.5 * cfg.kappa),
                       cfg.krylov_fixed_iters),
                adjoint=((cfg.tau, half), cfg.adjoint_krylov_fixed_iters))
    return fwd.op, fwd64.op, f32, f64, scal


def _bound(flops, nbytes, peak_flops=PEAK_FP32_FLOPS):
    """(bound_ms, bound_by): the larger of operations over the peak for
    their type (FP32 unless given) and bytes over the memory rate."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _solve_work(name, n, B, trips):
    """(FLOPs, bytes) of one launch of a per-solve kernel on B members of
    an (n, n) grid running `trips` trips each: 2 n^3 FLOP per dense product
    (the elementwise work is left out), each input read and each output
    written once."""
    P = 2.0 * n ** 3
    products = {"bicgstab_schur_spectral": 4 + 8 * trips,
                "bicgstab_schur": 16 * trips,
                "bicgstab_adjoint_spectral": 10 + 8 * trips,
                "bicgstab_adjoint": 24 + 24 * trips}[name]
    fields = 3 if "schur" in name else 4             # per member, in
    mats = 5 if "spectral" in name else 6            # shared, (n, n)
    nbytes = 4 * n * n * (B * (fields + 1) + mats)
    return P * products * B, nbytes


def _march_work(n, B, M, newton, n_trips, segment=False):
    """(FLOPs, bytes) of a march launch over M steps: per step 8 products
    (two Laplacians of the old level, the first residual), per Newton
    iteration 8 + 8 n_trips (the Schur solve) + 4 (one Armijo trial's
    residual, the fewest there can be); Krylov trips counted in full (a
    freeze is not observed from outside the kernel). Bytes in: u, phi0
    (segment: and the mu, w carry), dts, the eight operator fields; out:
    the history (segment: and the final phi, mu, w)."""
    P = 2.0 * n ** 3
    flops = P * (B * M * 8 + newton * (12 + 8 * n_trips))
    fields = B * ((M + 1) + 3 + M + 3 if segment else 2 * (M + 1) + 1)
    return flops, 4 * (n * n * (fields + 8) + M + 3 * B)


def _adjoint_work(n, B, M, n_trips, segment=False):
    """(FLOPs, bytes) of a sweep launch over M steps: per step 16 + 8
    n_trips products (the rhs's two Laplacians, the rhs and warm-start
    transforms, r0's apply, the trips, p's synthesis and q's Laplacian),
    plus the terminal solve's 6 (whole sweep); trips in full. Bytes in: the
    history and phi_Q, phi_T (segment: the p, q, r carry), b1, b2, dts, the
    seven operator fields; out: r (segment: and the carry)."""
    P = 2.0 * n ** 3
    flops = P * B * (M * (16 + 8 * n_trips) + (0 if segment else 6))
    fields = B * (2 * (M + 1) + 3 + M + 3 if segment
                  else 2 * (M + 1) + 1 + M + 1)
    return flops, 4 * (n * n * (fields + 7) + M + 2 * B)


def solve_case(torch, device, n, B, reps=20):
    """Phase 2c at one shape: each per-solve kernel against its plain
    version on the same float32 inputs from a real step, both against the
    plain version in float64; CUDA-event ms of the kernel and of the plain
    version; for one (n, n) solve also the trips the kernel runs on these
    inputs (ops.solve_kernels.solve_trips)."""
    from vch_tpu_torch.ops import solve_kernels as sk

    ops32, ops64, f32, f64, scal = _solve_args(torch, device, n, B)
    out = dict(n=n, B=B or 1, batched=B is not None)
    for name in SOLVE_KERNELS:
        wrapper, plain = getattr(sk, name), getattr(sk, name + "_plain")
        k = _solve_call(name, ops32, f32, scal, wrapper)
        p = _solve_call(name, ops32, f32, scal, plain)
        p64 = _solve_call(name, ops64, f64, scal, plain)
        torch.cuda.synchronize()
        c = dict(finite=bool(torch.isfinite(k).all()),
                 max_abs_err=(k - p).abs().max().item(),
                 rel_kernel_vs_plain=_rel(k, p, p),
                 rel_kernel_vs_f64=_rel(k, p64, p64),
                 rel_plain_vs_f64=_rel(p, p64, p64),
                 ms=time_ms(lambda: _solve_call(
                     name, ops32, f32, scal, wrapper), reps),
                 plain_ms=time_ms(lambda: _solve_call(
                     name, ops32, f32, scal, plain), reps))
        if B is None:
            c["trips"] = int(_solve_call(
                name, ops32, f32, scal,
                lambda *a, n_iter: sk.solve_trips(name, *a, n_iter=n_iter)))
        out[name] = c
    return out


def check_solve_case(c):
    """Phase 2c gates, the float64-referenced pattern of phase 2b: each
    kernel's float32 result no farther from the float64 plain version than
    twice the plain float32 version is, plus 1e-5 (about a hundred float32
    ulps, so that a plain result that happens to sit very close to float64
    does not fail a kernel summing in another order), and finite."""
    fails = []
    for name in SOLVE_KERNELS:
        k = c[name]
        if not k["finite"]:
            fails.append(f"{name}: non-finite output")
        if k["rel_kernel_vs_f64"] > 2 * k["rel_plain_vs_f64"] + 1e-5:
            fails.append(f"{name}: {k['rel_kernel_vs_f64']} from float64, "
                         f"plain float32 {k['rel_plain_vs_f64']}")
    if fails:
        raise RuntimeError(f"solve kernels n={c['n']} B={c['B']}: "
                           + "; ".join(fails))


# the cluster solves of csrc/solve2d_cluster.cu: the kernel-table row, the
# one-CTA oracle and the kernel in CLUSTER_KERNELS of each wrapper
CLUSTER_SOLVES = {
    "bicgstab_schur_spectral": (8, "_bicgstab_schur_spectral_cta",
                                "schur_solve"),
    "bicgstab_adjoint_spectral": (9, "_bicgstab_adjoint_spectral_cta",
                                  "solve"),
    "bicgstab_adjoint": (11, "_bicgstab_adjoint_cta", "raw_solve"),
    "bicgstab_schur": (10, "_bicgstab_schur_cta", "raw_schur_solve")}


def _scalars_on_device(torch, device, name, scal, all_of_them=False):
    """scal with the scalars the per-step solvers pass as 0-d tensors on
    the card made so (the marcher's 1/dt and tau/dt, the sweep's dt/2;
    all_of_them: every scalar, as a CUDA graph's capture of a one-CTA
    oracle needs)."""
    kind = "schur" if "schur" in name else "adjoint"
    vals, trips = scal[kind]
    tensors = (0, 1) if kind == "schur" else (1,)
    on = lambda i, v: (torch.tensor(v, device=device)
                       if all_of_them or i in tensors else v)
    return dict(scal, **{kind: (tuple(on(i, v) for i, v in enumerate(vals)),
                                trips)})


def cluster_solve_timing(torch, device, name, n, B, reps=20, clusters=()):
    """Rows 8-11: the solve `name` (`bicgstab_schur_spectral`,
    `bicgstab_adjoint_spectral`, `bicgstab_schur`, `bicgstab_adjoint`) of
    B members on the
    inputs of a real step (_solve_args) on its cluster kernel (one member
    per cluster) and on its one-CTA oracle: bit-gated against each other,
    the scalars the per-step solvers pass as 0-d tensors on the card passed
    so and as numbers, bit-gated too; the cluster kernel against the plain
    version in float32 and float64 (phase 2c's gate); timed in turns
    (oracle, cluster, cluster, oracle; CUDA events) beside the plain
    version; the cluster geometry, the trips each member runs and the
    bound; then on the cluster sizes `clusters`, bit-gated and timed
    likewise."""
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.ops import solve_kernels as sk

    row, oracle, kernel = CLUSTER_SOLVES[name]
    ops32, ops64, f32, f64, scal = _solve_args(torch, device, n, B)
    scal_t = _scalars_on_device(torch, device, name, scal)
    call = lambda fn, sc=scal: _solve_call(name, ops32, f32, sc, fn)
    new = lambda: call(getattr(sk, name))
    new_t = lambda: call(getattr(sk, name), scal_t)
    old = lambda: call(getattr(sk, oracle))
    plain = getattr(sk, name + "_plain")
    k, kt, o = new(), new_t(), old()
    p = call(plain)
    p64 = _solve_call(name, ops64, f64, scal, plain)
    torch.cuda.synchronize()
    trips = _solve_call(name, ops32, f32, scal, lambda *a, n_iter: sk.
                        solve_trips(name, *a, n_iter=n_iter))
    trips = [int(t) for t in torch.as_tensor(trips).reshape(-1).tolist()]
    out = dict(row=row, name=name, n=n, B=B,
               cluster_equals_cta=bool(torch.equal(k, o)),
               tensor_scalar_equal=bool(torch.equal(kt, k)),
               finite=bool(torch.isfinite(k).all()),
               max_abs_err=(k - p).abs().max().item(),
               rel_kernel_vs_plain=_rel(k, p, p),
               rel_kernel_vs_f64=_rel(k, p64, p64),
               rel_plain_vs_f64=_rel(p, p64, p64), trips=trips)
    for label, fn in (("cta", old), ("cluster", new), ("cluster", new),
                      ("cta", old)):
        out.setdefault(f"{label}_ms", []).append(time_ms(fn, reps))
    out["plain_ms"] = time_ms(lambda: call(plain), max(1, reps // 4))
    g = km.launch_geometry(n, n, B, device, members=1, kernel=kernel)
    out["geometry"] = dict(cluster=g.cluster, ctas=B * g.cluster, kc=g.kc,
                           smem_bytes=g.smem_bytes,
                           resident_clusters=km.resident_clusters(
                               torch.device(device).index or 0, n, n,
                               g.cluster, g.kc, g.smem_bytes, 1, False,
                               kernel))
    flops = sum(_solve_work(name, n, 1, t)[0] for t in trips)
    out["bound_ms"], out["bound_by"] = _bound(flops,
                                              _solve_work(name, n, B, 0)[1])
    fitted, others = sk.solve_geometry, []
    try:
        for C in clusters:
            if C == g.cluster:
                continue
            gc = km.blocked_geometry(n, n, B, 1, cluster=C, members=1,
                                     kernel=kernel)
            sk.solve_geometry = lambda *a: gc
            others.append(dict(cluster=C, equal=bool(torch.equal(new(), o)),
                               ms=time_ms(new, reps)))
    finally:
        sk.solve_geometry = fitted
    out["other_clusters"] = others
    return out


def check_cluster_solve_timing(c):
    """A cluster solve's gates: bit for bit its one-CTA oracle (at every
    cluster size tried, and with the scalars as 0-d tensors), finite, and
    no farther from the float64 plain version than twice the plain float32
    version plus 1e-5 (phase 2c's gate)."""
    fails = []
    if not (c["cluster_equals_cta"] and c["tensor_scalar_equal"]
            and all(o["equal"] for o in c["other_clusters"])):
        fails.append("the cluster solve differs from its one-CTA oracle")
    if not c["finite"]:
        fails.append("non-finite output")
    if c["rel_kernel_vs_f64"] > 2 * c["rel_plain_vs_f64"] + 1e-5:
        fails.append(f"{c['rel_kernel_vs_f64']} from float64, plain float32 "
                     f"{c['rel_plain_vs_f64']}")
    if fails:
        raise RuntimeError(f"row {c['row']} n={c['n']} B={c['B']}: "
                           + "; ".join(fails))


def _cluster_solve_call(torch, device, name, n, B, all_on_device=False):
    """A call of the cluster solve `name` on a real step's B members at
    (n, n) (_solve_args), the scalars as the per-step solvers pass them
    (all_on_device: every scalar a 0-d tensor on the card, as a CUDA
    graph's capture of the oracle needs), and the same on its one-CTA
    oracle."""
    from vch_tpu_torch.ops import solve_kernels as sk

    ops32, _, f32, _, scal = _solve_args(torch, device, n, B)
    scal = _scalars_on_device(torch, device, name, scal, all_on_device)
    fn = lambda w: lambda: _solve_call(name, ops32, f32, scal, w)
    return (fn(getattr(sk, name)),
            fn(getattr(sk, CLUSTER_SOLVES[name][1])))


def solve_host_cost(torch, device, name, n=65, B=1, calls=200):
    """Phase 8: a cluster solve's wrapper at config 3's shape: host
    microseconds a call, `calls` calls enqueued without a sync, against the
    kernel's device microseconds a call, CUDA events over the same calls
    (the device's time where the host keeps ahead of it)."""
    new, _ = _cluster_solve_call(torch, device, name, n, B)
    new()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        new()
    host_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    device_us = 1e3 * time_ms(new, calls)
    return dict(name=name, n=n, B=B, calls=calls, host_us=host_us,
                device_us=device_us, host_over_device=host_us / device_us)


def cluster_solve_device_times(torch, device, shapes=((65, 1), (129, 128),
                                                      (257, 1))):
    """Rows 8-11 on the device alone: each cluster solve and its one-CTA
    oracle, mean ms of 20 calls captured in a CUDA graph (graph_ms), after
    phase 7 as every capture is; the raw Schur solve also at phase 2e's
    batch (n = 65, B = 8: row 12)."""
    out = []
    for name, (row, _, _) in CLUSTER_SOLVES.items():
        extra = ((65, 8),) if name == "bicgstab_schur" else ()
        for n, B in shapes + extra:
            new, old = _cluster_solve_call(torch, device, name, n, B,
                                           all_on_device=True)
            out.append(dict(row=row, n=n, B=B, cluster_device_ms=graph_ms(new),
                            cta_device_ms=graph_ms(old)))
    return out


def _problem_inputs_1d(torch, N, B, T, dt, device, seed=0):
    """1D solvers in float32 and float64 (the float64 one on the plain
    version, taking the float32 path's Newton exits and Krylov trips) and
    seeded inputs as tensors of both dtypes."""
    from vch_tpu_torch.config import DELTA_SEP, ForwardSolverConfig1D
    from vch_tpu_torch.models.forward1d import ForwardSolver1D
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.ops.potential import init_phi_random_1d

    fwd, fwd64 = (ForwardSolver1D(ForwardSolverConfig1D(
        N=N, T=T, dt_initial=dt, dtype=name, newton_tol=2e-4,
        linsolve_1d="spectral"), device=device)
        for name in ("float32", "float64"))
    fwd64.entries = km.PLAIN
    fwd64._rtol, fwd64._stagnation = fwd._rtol, fwd._stagnation
    fwd64._krylov_fixed = fwd._krylov_fixed
    rng = np.random.default_rng(seed)
    host = dict(
        phi0=np.stack([init_phi_random_1d(N, DELTA_SEP, amp=0.01, seed=42 + i)
                       for i in range(B)]),
        u=0.05 * rng.standard_normal((B, fwd.M + 1, N + 1)))
    as_dev = lambda dtype: {k: torch.as_tensor(v, dtype=dtype, device=device)
                            for k, v in host.items()}
    return fwd, fwd64, as_dev(torch.float32), as_dev(torch.float64)


def _march1d_direct(fwd, x, group=0):
    """The 1D march wrapper with an explicit members-per-cluster group (0:
    the geometry's)."""
    from vch_tpu_torch.config import DELTA_SEP
    from vch_tpu_torch.ops import march as km
    cfg = fwd.config
    return km.march_fused_1d(
        fwd.dts, x["phi0"], x["u"], fwd.LT, fwd.VinvT, fwd.VT, fwd.lam[None],
        fwd.wts[None], tau=cfg.tau, c1=cfg.c1, c2=cfg.c2, kappa=cfg.kappa,
        gamma=cfg.gamma, delta_sep=DELTA_SEP, Lx_len=float(cfg.Lx),
        newton_tol=cfg.newton_tol, newton_rtol=fwd._rtol,
        newton_max_iter=cfg.newton_max_iter, n_trips=fwd._krylov_fixed,
        stagnation_exit=fwd._stagnation, group=group)


def march1d_case(torch, device, N, B, T, dt, plain_members=8, reps=3,
                 cpu_reference=False):
    """Phase 2d at one shape: the 1D march kernel (the wrapper's own
    geometry) against its plain version in float32 and both against the
    plain version in float64 on the first plain_members members (with
    cpu_reference also the plain float32 version on the CPU: the spread of
    two float32 implementations); on all members, one and three members per
    cluster, two other cluster sizes (1, 2 or the chunk count, where the
    operator bands may stream), and the first and last members marched
    alone, each against the wrapper's own run bit for bit."""
    from vch_tpu_torch.ops import march as km

    fwd, fwd64, x, x64 = _problem_inputs_1d(torch, N, B, T, dt, device)
    kh, kns, kbad = fwd.march_fused_batch(x["u"], x["phi0"])
    torch.cuda.synchronize()
    same = lambda out, idx=slice(None): bool(
        torch.equal(out[0], kh[idx]) and torch.equal(out[1], kns[idx])
        and torch.equal(out[2], kbad[idx]))
    groups_equal = all(same(_march1d_direct(fwd, x, g)) for g in (1, 3))
    geo = km.march1d_launch_geometry(N + 1, B, device)
    top = min(16, max(1, (N + 1) // km.MARCH_1D_CHUNK))
    fitted = km.march1d_geometry
    clusters = sorted({1, 2, top} - {geo.cluster})[:2]
    for C in clusters:
        km.march1d_geometry = (lambda n, B_, res, cluster=None, members=None:
                               fitted(n, B_, res, C, members))
        try:
            groups_equal = groups_equal and same(_march1d_direct(fwd, x))
        finally:
            km.march1d_geometry = fitted
    for i in (0, B - 1):
        xi = {k: t[i:i + 1].contiguous() for k, t in x.items()}
        groups_equal = groups_equal and same(_march1d_direct(fwd, xi),
                                             slice(i, i + 1))
    P = min(plain_members, B)
    sub = lambda v: {k: t[:P].contiguous() for k, t in v.items()}
    xs, x64s = sub(x), sub(x64)
    fwd.entries = km.PLAIN
    plain_ms, (ph, pns, pbad) = _host_ms(
        torch, lambda: fwd.march_fused_batch(xs["u"], xs["phi0"]))
    fwd.entries = km.KERNELS
    h64, _, _ = fwd64.march_fused_batch(x64s["u"], x64s["phi0"])
    torch.cuda.synchronize()
    cpu_vs_f64 = None
    if cpu_reference:
        h_cpu = _plain_on_cpu(fwd, "march_fused_batch", xs["u"], xs["phi0"])[0]
        cpu_vs_f64 = (h_cpu.double() - h64.cpu()).abs().max().item()
    return dict(n=N + 1, B=B, M=fwd.M, plain_members=P,
                geometry=dict(cluster=geo.cluster, width=geo.width,
                              members=geo.members, clusters=geo.clusters,
                              resident=geo.resident, kc=geo.kc,
                              smem_bytes=geo.smem_bytes),
                other_clusters=clusters,
                dphi_plain_cpu_vs_f64=cpu_vs_f64,
                finite=bool(torch.isfinite(kh).all()),
                groups_bit_equal=groups_equal,
                max_abs_dphi=(kh[:P] - ph).abs().max().item(),
                dphi_kernel_vs_f64=(kh[:P].double() - h64).abs().max().item(),
                dphi_plain_vs_f64=(ph.double() - h64).abs().max().item(),
                newton_kernel=kns[:P].cpu().tolist(),
                newton_plain=pns.cpu().tolist(),
                newton_kernel_total=float(kns.sum()),
                first_bad_equal=bool(torch.equal(kbad[:P], pbad)),
                march_ms=time_ms(lambda: fwd.march_fused_batch(
                    x["u"], x["phi0"]), reps),
                march_plain_ms=plain_ms)


def check_march1d_case(c, short: bool):
    """Phase 2d gates: finite; first_bad equal to the plain version's; every
    grouping, cluster size and batch bit-equal (a member's sums are taken in
    one order whatever its cluster holds). Short marches at n = 129: max|dphi| <= 1e-5 and equal
    Newton counts. Elsewhere the float64-referenced gate of phase 2 (at
    n = 513 the Laplacian's entries are ~5e5, and two float32 marches of a
    rough field differ by ~4e-4 after five steps; over 100 steps any two
    float32 marches drift apart within the Newton tolerance's slack): the
    kernel no farther from the float64 march than twice the farther of the
    two plain float32 marches (on the card and on the CPU: one plain march's
    distance is one sample of that spread), plus 1e-6, and Newton totals
    within 1%."""
    fails = []
    if not c["finite"]:
        fails.append("non-finite phi")
    if not c["first_bad_equal"]:
        fails.append("first_bad differs from plain")
    if not c["groups_bit_equal"]:
        fails.append("a grouping changed a member's result")
    nk, npl = sum(c["newton_kernel"]), sum(c["newton_plain"])
    if short:
        if c["max_abs_dphi"] > 1e-5:
            fails.append(f"max|dphi| {c['max_abs_dphi']} > 1e-5")
        if c["newton_kernel"] != c["newton_plain"]:
            fails.append(f"Newton counts {c['newton_kernel']} vs "
                         f"{c['newton_plain']}")
    else:
        ref = max(c["dphi_plain_vs_f64"], c["dphi_plain_cpu_vs_f64"] or 0.0)
        if c["dphi_kernel_vs_f64"] > 2 * ref + 1e-6:
            fails.append("kernel farther from float64 than plain float32")
        if abs(nk - npl) > 0.01 * npl:
            fails.append(f"Newton solves {nk} vs {npl}")
    if fails:
        raise RuntimeError(f"1D march n={c['n']} B={c['B']} M={c['M']}: "
                           + "; ".join(fails) + f" | {c}")


def _march1d_work(n, B, M, newton, n_trips):
    """(FLOPs, bytes) of a 1D march launch: 2 n^2 FLOP per vector-operator
    product; per member one product at the start and four per step (the two
    Laplacians of the old level, the first residual), per Newton solve
    6 + 4 n_trips (right-hand side, the trips' operator applies, the step's
    synthesis and Laplacian, one Armijo trial's residual, the fewest there
    can be), Krylov trips counted in full. Bytes in: u, phi0, dts, the three
    operators, lam, wts; out: the history and the two counters."""
    flops = 2.0 * n * n * (B * (1 + 4 * M) + newton * (6 + 4 * n_trips))
    nbytes = 4 * (2 * B * (M + 1) * n + B * n + M + 3 * n * n + 2 * n + 2 * B)
    return flops, nbytes


APPLY_KERNELS = ("schur_apply", "adjoint_apply", "spectral_solve")


def _apply_args(name, ops, f):
    """One operator apply's arguments on the fields of _solve_args: the
    Schur operator on (d, p), the adjoint operator on (f'', p), the spectral
    solve on (denom, the Schur right-hand side)."""
    (denom, d, rhs), (_, fpp, _, p) = f["schur"], f["adjoint"]
    if name == "schur_apply":
        return (ops.Lx, ops.LyT, d, p)
    if name == "adjoint_apply":
        return (ops.Lx, ops.LyT, fpp, p)
    return (ops.Vx_inv, ops.Vy_inv_T, ops.Vx, ops.VyT, denom, rhs)


def _apply_as_matmuls(torch, name, args, scal):
    """The same function as plain torch.matmul calls: the yardstick beside
    each apply kernel (timed here, used nowhere in the package)."""
    mm = torch.matmul
    if name == "spectral_solve":
        Vxi, VyiT, Vx, VyT, denom, v = args
        return mm(mm(Vx, mm(mm(Vxi, v), VyiT) / denom), VyT)
    Lx, LyT, f1, v = args
    lap = lambda a: mm(Lx, a) + mm(a, LyT)
    if name == "schur_apply":
        inv_dt, tau_dt, hk = scal
        return inv_dt * v - lap((tau_dt + f1) * v - hk * lap(v))
    tau, half = scal
    w = lap(v)
    return v - tau * w + half * (lap(w) - f1 * w)


def _apply_work(name, n, B):
    """(FLOPs, bytes) of an apply on B members of an (n, n) grid: four
    products of 2 n^3 FLOP; in: the field, its coefficient, two or four
    operators; out: the result."""
    mats = 4 if name == "spectral_solve" else 2
    return 4 * 2.0 * n ** 3 * B, 4 * n * n * (3 * B + mats)


def apply_case(torch, device, n, B, reps=20):
    """Phase 2e at one shape: each operator apply against its plain version
    on float32 fields from a real step, both against the plain version in
    float64; whether two launches give the same bits and (for a batch)
    whether each member equals its own one-member launch; CUDA-event ms of
    the kernel, the plain version and the torch.matmul form per call (host
    launch cost included, as every `ms` of the kernels line), and their
    ratio, and the bound. For each (all three run on the cluster kernel)
    also the geometry (cluster size, band rows, shared-memory bytes per CTA)
    and, where the cluster is the non-portable 16, the kernel's time on
    clusters of 8."""
    from vch_tpu_torch.ops import solve_kernels as sk

    ops32, ops64, f32, f64, scal = _solve_args(torch, device, n, B)
    scalars = {"schur_apply": scal["schur"][0],
               "adjoint_apply": scal["adjoint"][0], "spectral_solve": ()}
    variants = {"schur_apply": sk._SCHUR_APPLY,
                "adjoint_apply": sk._ADJOINT_APPLY,
                "spectral_solve": sk._SPECTRAL_SOLVE}
    out = dict(n=n, B=B or 1, batched=B is not None)
    for name in APPLY_KERNELS:
        wrapper, plain = getattr(sk, name), getattr(sk, name + "_plain")
        a32, a64 = _apply_args(name, ops32, f32), _apply_args(name, ops64, f64)
        k = wrapper(*a32, *scalars[name])
        k2 = wrapper(*a32, *scalars[name])
        members = [wrapper(*[t[b].contiguous() if torch.is_tensor(t)
                             and t.dim() == 3 else t for t in a32],
                           *scalars[name]) for b in range(B or 0)]
        p = plain(*a32, *scalars[name])
        p64 = plain(*a64, *scalars[name])
        lib = _apply_as_matmuls(torch, name, a32, scalars[name])
        torch.cuda.synchronize()
        c = dict(
            finite=bool(torch.isfinite(k).all()),
            max_abs_err=(k - p).abs().max().item(),
            rel_kernel_vs_plain=_rel(k, p, p),
            rel_kernel_vs_f64=_rel(k, p64, p64),
            rel_plain_vs_f64=_rel(p, p64, p64),
            rel_matmuls_vs_plain=_rel(lib, p, p),
            launches_bit_equal=bool(torch.equal(k, k2)),
            members_equal_single_launch=all(
                bool(torch.equal(k[b], one)) for b, one in enumerate(members)),
            ms=time_ms(lambda: wrapper(*a32, *scalars[name]), reps),
            plain_ms=time_ms(lambda: plain(*a32, *scalars[name]), reps),
            library_ms=time_ms(lambda: _apply_as_matmuls(
                torch, name, a32, scalars[name]), reps))
        c["kernel_over_library"] = c["ms"] / c["library_ms"]
        c["bound_ms"], c["bound_by"] = _bound(*_apply_work(name, n, B or 1))
        if name in variants:
            g = sk.apply_geometry(name, n, n)
            c["geometry"] = dict(cluster=g.cluster,
                                 band_rows=[r for _, r in g.bands],
                                 per_thread=g.per_thread,
                                 chunk=g.chunk, smem_bytes=g.smem_bytes)
            if g.cluster > 8:
                mats = ((None, None) + a32[:4] if name == "spectral_solve"
                        else (a32[0], a32[1], None, None, None, None))
                c8 = lambda: sk._launch_apply(
                    wrapper, variants[name], scalars[name], mats, a32[-2],
                    a32[-1], cluster=8)
                # each output sums its k terms in one order whatever the
                # cluster size, so this is the same result
                c["cluster8_bit_equal"] = bool(torch.equal(c8(), k))
                c["ms_cluster8"] = time_ms(c8, reps)
        out[name] = c
    return out


def apply_device_times(torch, device, shapes=(65, 129, 257)):
    """Phase 2e-dev: each operator apply and its torch.matmul form on the
    device alone: mean ms of 20 calls captured in a CUDA graph, one field
    per shape. Run after every other phase: a capture on a side stream
    leaves cuBLAS a workspace on that stream, which would count in phase
    7's peak memory."""
    from vch_tpu_torch.ops import solve_kernels as sk

    out = []
    for n in shapes:
        ops32, _, f32, _, scal = _solve_args(torch, device, n, None)
        scalars = {"schur_apply": scal["schur"][0],
                   "adjoint_apply": scal["adjoint"][0],
                   "spectral_solve": ()}
        row = dict(n=n)
        for name in APPLY_KERNELS:
            a32, sc = _apply_args(name, ops32, f32), scalars[name]
            k = graph_ms(lambda: getattr(sk, name)(*a32, *sc))
            lib = graph_ms(lambda: _apply_as_matmuls(torch, name, a32, sc))
            row[name] = dict(device_ms=k, library_device_ms=lib,
                             kernel_over_library=k / lib)
        out.append(row)
    return out


def batched_schur_case(torch, device, n=65, B=8, reps=20):
    """Phase 2e, row 12: the raw Schur solve launched on a batch of B (B
    thread-block clusters, one member each), the counterpart of the TPU's
    member-tiled solve, against its plain version in float32 and float64,
    bit for bit against its one-CTA oracle, and each member against its own
    one-member launch; timed in turns with the oracle (oracle, cluster,
    cluster, oracle; CUDA events), with the cluster geometry."""
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.ops import solve_kernels as sk

    ops32, ops64, f32, f64, scal = _solve_args(torch, device, n, B)
    name = "bicgstab_schur"
    new = lambda: _solve_call(name, ops32, f32, scal, sk.bicgstab_schur)
    old = lambda: _solve_call(name, ops32, f32, scal, sk._bicgstab_schur_cta)
    k, o = new(), old()
    p = _solve_call(name, ops32, f32, scal, sk.bicgstab_schur_plain)
    p64 = _solve_call(name, ops64, f64, scal, sk.bicgstab_schur_plain)
    members = [_solve_call(name, ops32, {kind: tuple(t[b].contiguous()
                                                     for t in v)
                                         for kind, v in f32.items()},
                           scal, sk.bicgstab_schur) for b in range(B)]
    trips = _solve_call(name, ops32, f32, scal, lambda *a, n_iter:
                        sk.solve_trips(name, *a, n_iter=n_iter))
    torch.cuda.synchronize()
    out = dict(n=n, B=B, finite=bool(torch.isfinite(k).all()),
               max_abs_err=(k - p).abs().max().item(),
               rel_kernel_vs_plain=_rel(k, p, p),
               rel_kernel_vs_f64=_rel(k, p64, p64),
               rel_plain_vs_f64=_rel(p, p64, p64),
               cluster_equals_cta=bool(torch.equal(k, o)),
               member_equals_single_launch=all(
                   bool(torch.equal(k[b], one))
                   for b, one in enumerate(members)),
               trips=trips.flatten().cpu().tolist())
    for label, fn in (("cta", old), ("cluster", new), ("cluster", new),
                      ("cta", old)):
        out.setdefault(f"{label}_ms", []).append(time_ms(fn, reps))
    out["ms"] = float(np.mean(out["cluster_ms"]))
    out["plain_ms"] = time_ms(lambda: _solve_call(
        name, ops32, f32, scal, sk.bicgstab_schur_plain), reps)
    g = km.launch_geometry(n, n, B, device, members=1,
                           kernel="raw_schur_solve")
    out["geometry"] = dict(cluster=g.cluster, ctas=B * g.cluster, kc=g.kc,
                           smem_bytes=g.smem_bytes)
    return out


def check_apply_cases(applies, batched):
    """Phase 2e gates, the float64-referenced pattern of phase 2c: each
    kernel's float32 result finite and no farther from the float64 plain
    version than twice the plain float32 version plus 1e-5; two launches of
    an apply bit-equal, and each member of a batched apply bit-equal to its
    one-member launch; the batched Schur solve bit-equal to its one-CTA
    oracle, and each of its members to its one-member launch."""
    fails = []
    results = [(f"{name} n={c['n']} B={c['B']}", c[name])
               for c in applies for name in APPLY_KERNELS]
    results.append((f"batched bicgstab_schur B={batched['B']}", batched))
    for tag, k in results:
        if not k["finite"]:
            fails.append(f"{tag}: non-finite output")
        if k["rel_kernel_vs_f64"] > 2 * k["rel_plain_vs_f64"] + 1e-5:
            fails.append(f"{tag}: {k['rel_kernel_vs_f64']} from float64, "
                         f"plain float32 {k['rel_plain_vs_f64']}")
        if not k.get("launches_bit_equal", True):
            fails.append(f"{tag}: two launches differ")
        if not k.get("members_equal_single_launch", True):
            fails.append(f"{tag}: a member differs from its one-member "
                         "launch")
    if not batched["member_equals_single_launch"]:
        fails.append("a member of the batched solve differs from its "
                     "one-member launch")
    if not batched["cluster_equals_cta"]:
        fails.append("the batched solve differs from its one-CTA oracle")
    if fails:
        raise RuntimeError("apply kernels: " + "; ".join(fails))


def operator_calls(torch, device, n=65, B=4):
    """The three operator applies and the batched raw Schur solve have no
    caller in the solvers: their entry points are the wrappers themselves.
    Calls each once through its wrapper, as a user would, with the counts
    set to 0 just before, and returns the counts read just after."""
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.ops import solve_kernels as sk

    ops32, _, f32, _, scal = _solve_args(torch, device, n, B)
    km.reset_launches()
    outs = [sk.schur_apply(*_apply_args("schur_apply", ops32, f32),
                           *scal["schur"][0]),
            sk.adjoint_apply(*_apply_args("adjoint_apply", ops32, f32),
                             *scal["adjoint"][0]),
            sk.spectral_solve(*_apply_args("spectral_solve", ops32, f32)),
            _solve_call("bicgstab_schur", ops32, f32, scal,
                        sk.bicgstab_schur)]
    torch.cuda.synchronize()
    counts = km.launch_counts()
    if not all(bool(torch.isfinite(o).all()) for o in outs):
        raise RuntimeError("operator calls: non-finite output")
    return counts


def slice1d_case(torch, device, N=64, T=0.1, iters=3):
    """Phase 3d: the batched 1D PGD slice on a heterogeneous B = 16 sweep,
    kernel path (the fused 1D march) against plain path."""
    from vch_tpu_torch.config import ForwardSolverConfig1D
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.parallel.batch import BatchedProblem1D, sweep_1d

    cfg = ForwardSolverConfig1D(N=N, T=T, dtype="float32", newton_tol=2e-4)
    sc = sweep_1d(cfg, b3_values=np.logspace(-5, -2, 4),
                  kappa_values=np.logspace(-6, -3, 4))
    runs = {}
    for path in ("kernel", "plain"):
        prob = BatchedProblem1D(cfg, device=device)
        if not prob._use_fused_march:
            raise RuntimeError("the 1D slice did not take the fused march")
        if path == "plain":
            prob.solver.entries = km.PLAIN
        km.reset_launches()
        t0 = time.perf_counter()
        out = prob.run(sc, max_iter=iters, verbose=False)
        runs[path] = (out, prob.straggler_rounds, time.perf_counter() - t0,
                      km.launch_counts())
    (ko, ks, kt, kl), (po, ps, pt, pl) = runs["kernel"], runs["plain"]
    c0, c1 = po["cost_history"], ko["cost_history"]
    return dict(N=N, B=sc.batch, M=prob.solver.M, iters=iters,
                rel_cost=float((np.abs(c1 - c0) / np.abs(c0)).max()),
                straggler_rounds_kernel=ks, straggler_rounds_plain=ps,
                newton_kernel=ko["newton_solves"],
                newton_plain=po["newton_solves"], kernel_s=kt, plain_s=pt,
                launches=kl, plain_launches=pl, cost_history=c1.tolist(),
                finite=bool(np.isfinite(c1).all()))


def check_slice1d(c):
    """Phase 3d gates: finite costs; the kernel path's cost history within
    2e-4 relative of the plain path's; Newton solves within 1% (a step that
    converges right at the tolerance may take one more iteration when sums
    run in another order); the 1D march launched on the kernel path, nothing
    on the plain path."""
    fails = []
    if not c["finite"] or c["rel_cost"] > 2e-4:
        fails.append(f"cost history vs plain {c['rel_cost']}")
    if abs(c["newton_kernel"] - c["newton_plain"]) > 0.01 * c["newton_plain"]:
        fails.append(f"Newton solves {c['newton_kernel']} vs "
                     f"{c['newton_plain']}")
    if c["launches"]["march_fused_1d"] <= 0:
        fails.append("march_fused_1d never launched")
    fails += [f"plain path launched {k}"
              for k, v in c["plain_launches"].items() if v]
    if fails:
        raise RuntimeError("1D slice: " + "; ".join(fails) + f" | {c}")


def config2_problem(device):
    """BASELINE config 2 at full width (scripts/run_benchmarks.py:49-58): 1D,
    N = 512, T = 1, dt = 2e-3 (M = 500), float32, newton_tol 2e-4, the
    32 x 8 (b3, kappa_spar) sweep: B = 256."""
    from vch_tpu_torch.config import (ForwardSolverConfig1D,
                                      OptimizationConfig)
    from vch_tpu_torch.parallel.batch import BatchedProblem1D, sweep_1d

    cfg = ForwardSolverConfig1D(N=512, T=1.0, dt_initial=2e-3,
                                dtype="float32", newton_tol=2e-4)
    sc = sweep_1d(cfg, OptimizationConfig(),
                  b3_values=np.linspace(5e-4, 5e-3, 32),
                  kappa_values=np.linspace(1e-5, 2e-4, 8))
    return BatchedProblem1D(cfg, device=device), sc


def config1_run(torch, device, iters=3):
    """Phase 10: BASELINE config 1 (scripts/run_benchmarks.py:31-45 in
    float32: N = 128, T = 1, M = 100, the 1D optimizer defaults) through
    ControlProblem1D on the card: constructor, one warm-up PGD iteration,
    `iters` timed ones, verify_sparsity; the launch counts set to 0 before
    the constructor and read at the end."""
    from vch_tpu_torch.config import ForwardSolverConfig1D
    from vch_tpu_torch.control.problems import ControlProblem1D
    from vch_tpu_torch.ops import march as km

    km.reset_launches()
    t0 = time.perf_counter()
    prob = ControlProblem1D(ForwardSolverConfig1D(dtype="float32"),
                            device=device)
    torch.cuda.synchronize()
    constructor_s = time.perf_counter() - t0
    n0 = prob.newton_solves
    t0 = time.perf_counter()
    prob.optimize(max_iter=1, verbose=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    n1 = prob.newton_solves
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res = prob.optimize(max_iter=iters, verbose=False)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    sparsity = prob.verify_sparsity(res, verbose=False)
    ch = np.asarray(res.cost_history)
    return dict(N=prob.fwd_config.N, M=prob.solver.M, iters=iters,
                pgd_iters_per_s=iters / elapsed, elapsed_s=elapsed,
                constructor_s=constructor_s, warmup_s=warm_s,
                timers=dict(res.timers), ls_trials=res.ls_trials_per_iter,
                constructor_newton_solves=n0,
                newton_solves=prob.newton_solves - n1,
                cost_history=ch.tolist(), peak_bytes=peak,
                sparsity={k: (float(v) if isinstance(v, (float, np.floating))
                              else v) for k, v in sparsity.items()},
                launches=km.launch_counts(),
                device=str(prob.phi_hist0.device),
                finite=bool(np.isfinite(ch).all()))


def check_config1(c):
    """Phase 10 gates: finite costs, the last below the first; on the card;
    no kernel launched (the problem runs the per-step marcher and sweep)."""
    fails = [f"{k} launched {v} times" for k, v in c["launches"].items() if v]
    ch = c["cost_history"]
    if not c["finite"] or not ch[-1] < ch[0]:
        fails.append("did not descend")
    if not c["device"].startswith("cuda"):
        fails.append(f"ran on {c['device']}")
    if fails:
        raise RuntimeError("config 1: " + "; ".join(fails) + f" | {c}")


# the float32 exact gradient's gates against float64 on the card: 10x the
# CPU figures of tests/test_torch_exact_adjoint.py (max |g32 - g64| /
# max |g64| at the first iterate: 1.23e-2 at config 1's shape, 2.87e-3 at
# 32 x 32, T = 1)
EXACT_F32_REL = {"1d": 0.123, "2d": 2.87e-2}


def _window(torch, windows, name, fn):
    """fn() between two device synchronizations, every launch count set to
    0 just before; its seconds and the launches it made go to
    windows[name]."""
    from vch_tpu_torch.ops import march as km

    torch.cuda.synchronize()
    km.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    windows[name] = dict(s=time.perf_counter() - t0, launches={
        k: v for k, v in km.launch_counts().items() if v})
    return out


def exact_run(torch, device, dim, iters):
    """Phases 8x ("2d": BASELINE config 3, 64x64, T = 1, M = 100, float32,
    the 2D optimizer defaults, through ControlProblem2D) and 10x ("1d":
    config 1, N = 128, T = 1, M = 100, float32, through ControlProblem1D),
    each with gradient_mode "exact": the constructor, one warm-up PGD
    iteration and `iters` timed ones, every launch count set to 0 before
    each and read after; then the first iterate's exact gradient (u = 0)
    in float32 against the float64 ExactAdjoint of the same grid with
    Newton at 1e-10, both on the card, each timed."""
    import dataclasses as dc
    from vch_tpu_torch.config import (ForwardSolverConfig1D,
                                      OptimizationConfig)
    from vch_tpu_torch.control.problems import (ControlProblem1D,
                                                ControlProblem2D)
    from vch_tpu_torch.models.adjoint_exact1d import ExactAdjoint1D
    from vch_tpu_torch.models.adjoint_exact2d import ExactAdjoint2D

    if dim == "2d":
        cfg = _config(64)
        make = lambda: ControlProblem2D(cfg, OptimizationConfig.defaults_2d(),
                                        gradient_mode="exact", device=device)
        twin = lambda: ExactAdjoint2D(dc.replace(
            cfg, dtype="float64", newton_tol=1e-10), device=device)
    else:
        cfg = ForwardSolverConfig1D(dtype="float32")
        make = lambda: ControlProblem1D(cfg, gradient_mode="exact",
                                        device=device)
        twin = lambda: ExactAdjoint1D(dc.replace(
            cfg, dtype="float64", newton_tol=1e-10), device=device)
    w = {}
    prob = _window(torch, w, "constructor", make)
    w["constructor"]["newton_solves"] = prob.newton_solves
    warm = _window(torch, w, "warmup",
                   lambda: prob.optimize(max_iter=1, verbose=False))
    n0 = prob.newton_solves
    res = _window(torch, w, "timed",
                  lambda: prob.optimize(max_iter=iters, verbose=False))
    w["timed"]["newton_solves"] = prob.newton_solves - n0
    opt, u0 = prob.opt_config, prob.initial_control()
    g32, _ = _window(torch, w, "gradient_f32", lambda: prob._exact._grad(
        u0, prob._phi0_dev, opt.b1, opt.b2, opt.b3, prob.phi_Q_target,
        prob.phi_T_target))
    f64 = lambda t: t.to(torch.float64)
    g64, _ = _window(torch, w, "gradient_f64", lambda: twin()._grad(
        f64(u0), torch.as_tensor(prob.phi0, dtype=torch.float64,
                                 device=device), opt.b1, opt.b2, opt.b3,
        f64(prob.phi_Q_target), f64(prob.phi_T_target)))
    ch = np.asarray(res.cost_history)
    t = w["timed"]
    return dict(dim=dim, M=prob.solver.M, iters=iters,
                pgd_iters_per_s=iters / t["s"], elapsed_s=t["s"],
                constructor_s=w["constructor"]["s"],
                warmup_s=w["warmup"]["s"],
                timers={k: v for k, v in res.timers.items()},
                ls_trials=res.ls_trials_per_iter,
                warmup_ls_trials=warm.ls_trials_per_iter,
                newton_solves=t["newton_solves"],
                constructor_newton_solves=w["constructor"]["newton_solves"],
                cost_history=ch.tolist(),
                gradient_f32_s=w["gradient_f32"]["s"],
                gradient_f64_s=w["gradient_f64"]["s"],
                grad_rel_f64=float((f64(g32) - g64).abs().max()
                                   / g64.abs().max()),
                grad_gate=EXACT_F32_REL[dim],
                launches={k: v["launches"] for k, v in w.items()},
                device=str(prob.phi_hist0.device),
                finite=bool(np.isfinite(ch).all()
                            and torch.isfinite(g32).all()))


def check_exact_run(c):
    """Phases 8x and 10x gates: finite costs that never rise and fall in
    all; the float32 gradient within its gate of float64; on the card; in
    2D the constructor's baseline march on the spectral Schur kernel (one
    launch a Newton solve) and each line-search trial one launch of the
    one-member march, nothing else (the exact gradient is plain PyTorch, as
    vch_tpu's is XLA); in 1D no launch at all."""
    L = c["launches"]
    expect = {k: {} for k in L}
    if c["dim"] == "2d":
        expect["constructor"] = {"bicgstab_schur_spectral":
                                 c["constructor_newton_solves"]}
        expect["warmup"] = {"march_fused_2d": sum(c["warmup_ls_trials"])}
        expect["timed"] = {"march_fused_2d": sum(c["ls_trials"])}
    fails = [f"{w}: {k} launched {L[w].get(k, 0)}, expected {v.get(k, 0)}"
             for w, v in expect.items() for k in set(L[w]) | set(v)
             if L[w].get(k, 0) != v.get(k, 0)]
    ch = c["cost_history"]
    if not (c["finite"] and all(b <= a for a, b in zip(ch, ch[1:]))
            and ch[-1] < ch[0]):
        fails.append("costs rose or did not fall")
    if not c["grad_rel_f64"] < c["grad_gate"]:
        fails.append(f"float32 gradient {c['grad_rel_f64']} from float64")
    if not c["device"].startswith("cuda"):
        fails.append(f"ran on {c['device']}")
    if fails:
        raise RuntimeError(f"exact mode {c['dim']}: " + "; ".join(fails)
                           + f" | {c}")


def exact_fd_case(torch, device):
    """Phase 2x: the float64 ExactAdjoint2D on the card at 12 x 12,
    T = 0.05 (Newton 1e-11, Krylov 1e-12) against central differences of
    its own J (eps 1e-5) at two entries of a seeded control, vch_tpu's gate
    1e-4 relative."""
    from vch_tpu_torch.config import ForwardSolverConfig2D
    from vch_tpu_torch.models.adjoint_exact2d import ExactAdjoint2D

    t0 = time.perf_counter()
    ea = ExactAdjoint2D(ForwardSolverConfig2D(
        Nx=12, Ny=12, T=0.05, newton_tol=1e-11, krylov_tol=1e-12),
        device=device)
    M = ea.solver.M
    u = 0.1 * np.random.default_rng(0).standard_normal((M + 1, 13, 13))
    g = ea.gradient(u)[0].cpu().numpy()
    rows, eps = [], 1e-5
    for idx in ((1, 5, 7), (M, 8, 3)):
        up, um = u.copy(), u.copy()
        up[idx] += eps
        um[idx] -= eps
        fd = (ea.gradient(up)[1] - ea.gradient(um)[1]) / (2 * eps)
        pred = float(g[idx] * ea._wt_t[idx[0]] * ea._wxy[idx[1:]])
        rows.append(dict(entry=idx, fd=fd, pred=pred,
                         rel=abs(fd - pred) / max(abs(fd), 1e-8)))
    return dict(M=M, rows=rows, device=str(ea.device),
                s=time.perf_counter() - t0)


def exact_phases(device=None, name=None, smi=None):
    """Phases 8x, 10x and 2x, each logged, then gated. Alone on the card:
    `python -c "import chip_smoke; chip_smoke.exact_phases()"`."""
    import torch
    if device is None:
        device, name, smi = (torch.device("cuda", 0),
                             torch.cuda.get_device_name(0), _smi())
    c3x = exact_run(torch, device, "2d", iters=2)
    _log("8x", json.dumps(c3x) + f" | {name} | {smi}")
    check_exact_run(c3x)
    c1x = exact_run(torch, device, "1d", iters=3)
    _log("10x", json.dumps(c1x) + " | no kernel on this path, as in "
         f"vch_tpu | {name} | {smi}")
    check_exact_run(c1x)
    fdx = exact_fd_case(torch, device)
    _log("2x", json.dumps(fdx) + f" | {name} | {smi}")
    if not (fdx["device"].startswith("cuda")
            and all(r["rel"] < 1e-4 for r in fdx["rows"])):
        raise RuntimeError(f"exact gradient vs finite differences: {fdx}")


def _control_problem(device, cfg):
    from vch_tpu_torch.config import OptimizationConfig
    from vch_tpu_torch.control.problems import ControlProblem2D
    return ControlProblem2D(cfg, OptimizationConfig.defaults_2d(),
                            device=device)


def control_slice(torch, device, variant, n=32, T=0.25, iters=3):
    """Phase 3c: ControlProblem2D at the golden config's grid and horizon in
    float32, kernel path against plain path, for one pallas_variant. The
    kernel run counts launches from its constructor on (the baseline march
    is where the Schur kernel runs); the plain run swaps the solvers'
    entries to the plain versions and redoes the baseline on them."""
    from vch_tpu_torch.ops import march as km

    cfg = _config(n, T=T, pallas_variant=variant)
    runs = {}
    for path in ("kernel", "plain"):
        km.reset_launches()
        prob = _control_problem(device, cfg)
        if path == "plain":
            prob.solver.entries = prob.adjoint.entries = km.PLAIN
            prob.phi_hist0 = prob.solver.simulate(initial_phi=prob.phi0)[0]
            prob.newton_solves = prob.solver.last_stats.newton_solves
            km.reset_launches()
        t0 = time.perf_counter()
        res = prob.optimize(max_iter=iters, verbose=False)
        runs[path] = (res, prob.newton_solves, time.perf_counter() - t0,
                      km.launch_counts())
    (kr, kn, kt, kl), (pr, pn, pt, pl) = runs["kernel"], runs["plain"]
    c0, c1 = np.asarray(pr.cost_history), np.asarray(kr.cost_history)
    return dict(variant=variant, n=n, M=prob.solver.M, iters=iters,
                rel_cost=float((np.abs(c1 - c0) / np.abs(c0)).max()),
                cost_history=c1.tolist(), newton_kernel=kn, newton_plain=pn,
                ls_trials_kernel=kr.ls_trials_per_iter,
                ls_trials_plain=pr.ls_trials_per_iter,
                kernel_s=kt, plain_s=pt, launches=kl, plain_launches=pl,
                finite=bool(np.isfinite(c1).all()))


def check_control_slice(c):
    """Phase 3c gates: costs finite, the kernel path's cost history within
    2e-4 relative of the plain path's (float32 sums in another order),
    Newton solves within 1%, the variant's per-solve kernels and the march
    kernel launched on the kernel path, nothing launched on the plain
    path."""
    schur, adj = (("bicgstab_schur_spectral", "bicgstab_adjoint_spectral")
                  if c["variant"] == "spectral"
                  else ("bicgstab_schur", "bicgstab_adjoint"))
    fails = [f"{k} never launched" for k in (schur, adj, "march_fused_2d")
             if c["launches"][k] <= 0]
    fails += [f"plain path launched {k}"
              for k, v in c["plain_launches"].items() if v]
    if not c["finite"] or c["rel_cost"] > 2e-4:
        fails.append(f"cost history vs plain {c['rel_cost']}")
    if abs(c["newton_kernel"] - c["newton_plain"]) > 0.01 * c["newton_plain"]:
        fails.append(f"Newton solves {c['newton_kernel']} vs "
                     f"{c['newton_plain']}")
    if fails:
        raise RuntimeError(f"control slice {c['variant']}: " + "; ".join(fails)
                           + f" | {c}")


def config3_run(torch, device, iters=3):
    """Phase 8, the slice's main path: BASELINE config 3 (64x64, T = 1,
    M = 100, float32, newton_tol 2e-4, the 2D optimizer defaults) through
    ControlProblem2D on the card: the constructor (baseline march, the
    per-step marcher on the spectral Schur kernel), one warm-up PGD
    iteration, then `iters` timed ones, then the reference program's closing
    checks (verify_sparsity, second_order_check with 5 directions); every
    launch count reset to 0 before each of the four and read after it; last
    the constructor's baseline march once more with CUDA events around each
    Schur solve (row 8, EntryTimer)."""
    from vch_tpu_torch.ops import march as km

    cfg = _config(64)
    windows = {}

    def window(name, fn):
        torch.cuda.synchronize()
        km.reset_launches()
        n0 = prob.newton_solves if name != "constructor" else 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        windows[name] = dict(s=time.perf_counter() - t0,
                             launches=km.launch_counts())
        return out, n0

    prob = None
    prob, _ = window("constructor", lambda: _control_problem(device, cfg))
    windows["constructor"]["newton_solves"] = prob.newton_solves
    window("warmup", lambda: prob.optimize(max_iter=1, verbose=False))
    torch.cuda.reset_peak_memory_stats(device)
    res, n0 = window("timed", lambda: prob.optimize(max_iter=iters,
                                                    verbose=False))
    windows["timed"]["newton_solves"] = prob.newton_solves - n0
    peak = torch.cuda.max_memory_allocated(device)
    (sparsity, d2), _ = window("checks", lambda: (
        prob.verify_sparsity(res, verbose=False),
        prob.second_order_check(res, num_directions=5)))
    ch = np.asarray(res.cost_history)
    t = windows["timed"]
    entries_are_kernels = (prob.solver.entries is km.KERNELS
                           and prob.adjoint.entries is km.KERNELS)
    t8 = EntryTimer(torch, km.KERNELS.schur_spectral, batch_at=7)
    prob.solver.entries = km.KERNELS._replace(schur_spectral=t8)
    prob.solver.simulate(initial_phi=prob.phi0)
    prob.solver.entries = km.KERNELS
    return dict(n=prob.solver.config.Nx, M=prob.solver.M, iters=iters,
                pgd_iters_per_s=iters / t["s"], elapsed_s=t["s"],
                constructor_s=windows["constructor"]["s"],
                warmup_s=windows["warmup"]["s"],
                timers={k: v for k, v in res.timers.items()},
                ls_trials=res.ls_trials_per_iter,
                newton_solves=t["newton_solves"],
                constructor_newton_solves=windows["constructor"][
                    "newton_solves"],
                cost_history=ch.tolist(), peak_bytes=peak,
                sparsity={k: (float(v) if isinstance(v, (float, np.floating))
                              else v) for k, v in sparsity.items()},
                second_order=[float(v) for v in d2],
                checks_s=windows["checks"]["s"],
                launches={k: v["launches"] for k, v in windows.items()},
                constructor_schur_solve=t8.summary(),
                entries_are_kernels=entries_are_kernels,
                finite=bool(np.isfinite(ch).all()))


def check_config3(c):
    """Phase 8 gates: finite costs that fall; every Newton solve of the
    baseline march launched the spectral Schur kernel; every step of every
    sweep the spectral adjoint kernel (M per iteration); every line-search
    trial the one-member march at B = 1, and the coercivity probe one march
    over its 5 directions; nothing else launched, and the solvers on the
    kernel entries (so no plain version ran: on CUDA tensors a kernel entry
    launches or raises)."""
    L = c["launches"]
    expect = {
        "constructor": {"bicgstab_schur_spectral":
                        c["constructor_newton_solves"]},
        "timed": {"bicgstab_adjoint_spectral": c["M"] * c["iters"],
                  "march_fused_2d": sum(c["ls_trials"])},
        "checks": {"march_fused_2d": 1},
    }
    fails = []
    for window, want in expect.items():
        for k, v in L[window].items():
            if v != want.get(k, 0):
                fails.append(f"{window}: {k} launched {v}, expected "
                             f"{want.get(k, 0)}")
    if not c["entries_are_kernels"]:
        fails.append("solver entries are not the kernels")
    ch = c["cost_history"]
    if not c["finite"] or not ch[-1] < ch[0]:
        fails.append("did not descend")
    if not np.isfinite(c["second_order"]).all():
        fails.append("non-finite second-order estimates")
    if fails:
        raise RuntimeError("config 3: " + "; ".join(fails) + f" | {c}")


def config3_raw_run(torch, device, iters=3):
    """Phase 8r, rows 10 and 11's main path at full width: config 3 (64x64,
    T = 1, M = 100, float32, the 2D optimizer defaults) on pallas_variant
    "raw" through ControlProblem2D: the constructor (the baseline march on
    the raw Schur solve, row 10), one warm-up PGD iteration, then `iters`
    timed ones, every launch count reset to 0 just before them and read
    just after, with CUDA events around each raw adjoint solve
    (EntryTimer); then the constructor's baseline march once more on the
    cluster raw Schur solve and on its one-CTA oracle, in turns, each solve
    under CUDA events (`constructor_schur_solve`). Then the same problem on
    the raw solves' plain versions (rows 10 and 11 in the kernels' place,
    the baseline re-marched on them; the trial marches stay on the march
    kernel, which phases 2 and 3c hold against its plain version, so that
    the run stays within seconds)."""
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.ops import solve_kernels as sk

    cfg = _config(64, pallas_variant="raw")
    plain = km.KERNELS._replace(schur_raw=sk.bicgstab_schur_plain,
                                adjoint_raw=sk.bicgstab_adjoint_plain)
    out = {}
    for path in ("kernel", "plain"):
        torch.cuda.synchronize()
        km.reset_launches()
        t0 = time.perf_counter()
        prob = _control_problem(device, cfg)
        torch.cuda.synchronize()
        run = dict(constructor_s=time.perf_counter() - t0,
                   constructor_launches=km.launch_counts())
        if path == "plain":
            prob.solver.entries = prob.adjoint.entries = plain
            prob.phi_hist0 = prob.solver.simulate(initial_phi=prob.phi0)[0]
            prob.newton_solves = prob.solver.last_stats.newton_solves
        run["constructor_newton_solves"] = prob.newton_solves
        timer = EntryTimer(torch, prob.adjoint.entries.adjoint_raw,
                           batch_at=8)
        prob.adjoint.entries = prob.adjoint.entries._replace(
            adjoint_raw=timer)
        prob.optimize(max_iter=1, verbose=False)               # warm-up
        n0 = prob.newton_solves
        torch.cuda.synchronize()
        timer.clear()
        km.reset_launches()
        t0 = time.perf_counter()
        res = prob.optimize(max_iter=iters, verbose=False)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        ch = np.asarray(res.cost_history)
        run.update(pgd_iters_per_s=iters / elapsed, elapsed_s=elapsed,
                   launches=km.launch_counts(), raw_adjoint=timer.summary(),
                   newton_solves=prob.newton_solves - n0,
                   ls_trials=res.ls_trials_per_iter,
                   timers=dict(res.timers), cost_history=ch.tolist(),
                   finite=bool(np.isfinite(ch).all()))
        if path == "kernel":
            run["constructor_schur_solve"] = _constructor_raw_schur(torch,
                                                                    prob)
        out[path] = run
    c0 = np.asarray(out["plain"]["cost_history"])
    c1 = np.asarray(out["kernel"]["cost_history"])
    out.update(n=cfg.Nx, M=prob.solver.M, iters=iters,
               rel_cost=float((np.abs(c1 - c0) / np.abs(c0)).max()))
    return out


def _constructor_raw_schur(torch, prob):
    """Row 10 in config 3 raw's constructor: its baseline march re-run on
    the cluster raw Schur solve and on the one-CTA oracle, in turns
    (oracle, cluster, cluster, oracle), each solve under CUDA events
    (EntryTimer); the launches and ms of each run, and whether every run's
    history equals the first's bit for bit."""
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.ops import solve_kernels as sk

    fns = {"cluster": km.KERNELS.schur_raw, "cta": sk._bicgstab_schur_cta}
    entries, out, hists = prob.solver.entries, {}, []
    try:
        for label in ("cta", "cluster", "cluster", "cta"):
            timer = EntryTimer(torch, fns[label], batch_at=8)
            prob.solver.entries = entries._replace(schur_raw=timer)
            hists.append(prob.solver.simulate(initial_phi=prob.phi0)[0])
            t = timer.summary()
            out.setdefault(label, []).append(dict(launches=t["launches"],
                                                  ms=t["ms"]))
    finally:
        prob.solver.entries = entries
    out["histories_equal"] = all(bool(torch.equal(h, hists[0]))
                                 for h in hists)
    return out


def check_config3_raw(c):
    """Phase 8r gates: costs finite and falling, the kernel path's cost
    history within 2e-4 relative of the plain path's and its Newton solves
    within 1% (phase 3c's gates); on the kernel path the constructor
    launched the raw Schur kernel once per Newton solve and the timed run
    the raw adjoint kernel M times an iteration and the march kernel once a
    trial, nothing else; on the plain path no solve kernel; the
    constructor's march bit for bit alike on the cluster raw Schur solve
    and on its one-CTA oracle, with one solve per Newton solve."""
    fails = []
    k, p = c["kernel"], c["plain"]
    expect = {
        ("kernel", "constructor_launches"): {
            "bicgstab_schur": k["constructor_newton_solves"]},
        ("kernel", "launches"): {"bicgstab_adjoint": c["M"] * c["iters"],
                                 "march_fused_2d": sum(k["ls_trials"])},
        ("plain", "launches"): {"march_fused_2d": sum(p["ls_trials"])}}
    for (path, window), want in expect.items():
        for name, v in c[path][window].items():
            if v != want.get(name, 0):
                fails.append(f"{path} {window}: {name} launched {v}, "
                             f"expected {want.get(name, 0)}")
    if k["raw_adjoint"]["launches"] != c["M"] * c["iters"]:
        fails.append(f"timed {k['raw_adjoint']['launches']} raw solves")
    cs = k["constructor_schur_solve"]
    if not cs["histories_equal"]:
        fails.append("the constructor's march on the cluster raw Schur solve "
                     "differs from the march on its one-CTA oracle")
    if any(r["launches"] != k["constructor_newton_solves"]
           for label in ("cluster", "cta") for r in cs[label]):
        fails.append("a timed constructor march ran another number of raw "
                     "Schur solves")
    ch = k["cost_history"]
    if not (k["finite"] and p["finite"]) or not ch[-1] < ch[0]:
        fails.append("did not descend")
    if c["rel_cost"] > 2e-4:
        fails.append(f"cost history vs plain {c['rel_cost']}")
    if abs(k["newton_solves"] - p["newton_solves"]) > 0.01 * p["newton_solves"]:
        fails.append(f"Newton solves {k['newton_solves']} vs "
                     f"{p['newton_solves']}")
    if fails:
        raise RuntimeError("config 3 raw: " + "; ".join(fails) + f" | {c}")


def _slice_sweep(cfg, materialize=True, n_b3=4, n_ks=4):
    from vch_tpu_torch.parallel.batch import sweep_2d
    return sweep_2d(cfg, b3_values=np.logspace(-6, 0, n_b3),
                    kappa_values=np.logspace(-6, -1, n_ks),
                    materialize_phi_Q=materialize)


def slice_case(torch, device, n=32, T=0.1, iters=2, block=0, lowmem_K=None):
    """Phases 3 and 3b: the batched PGD slice, kernel path vs plain path,
    with one member per CTA (block=0), the blocked kernels (block=8), or
    the low-memory problem (lowmem_K)."""
    from vch_tpu_torch.config import ForwardSolverConfig2D
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.parallel.batch import (BatchedProblem2D,
                                              LowMemBatchedProblem2D)

    cfg = ForwardSolverConfig2D(Nx=n, Ny=n, T=T, dtype="float32",
                                newton_tol=2e-4, fused_march_block=block)
    sc = _slice_sweep(cfg)
    runs = {}
    for path in ("kernel", "plain"):
        prob = (LowMemBatchedProblem2D(cfg, K=lowmem_K, device=device)
                if lowmem_K else BatchedProblem2D(cfg, device=device))
        if path == "plain":
            prob.solver.entries = prob.adj.entries = km.PLAIN
        km.reset_launches()
        t0 = time.perf_counter()
        out = prob.run(sc, max_iter=iters, verbose=False)
        runs[path] = (out, prob.straggler_rounds, time.perf_counter() - t0,
                      km.launch_counts())
    (ko, ks, kt, kl), (po, ps, pt, _) = runs["kernel"], runs["plain"]
    c0, c1 = po["cost_history"], ko["cost_history"]
    return dict(block=block, lowmem_K=lowmem_K,
                rel_cost=float((np.abs(c1 - c0) / np.abs(c0)).max()),
                straggler_rounds_kernel=ks, straggler_rounds_plain=ps,
                newton_kernel=ko["newton_solves"],
                newton_plain=po["newton_solves"], kernel_s=kt, plain_s=pt,
                launches=kl, cost_history=c1.tolist(),
                finite=bool(np.isfinite(c1).all()))


def _scan_f64_twin(pipe32, device):
    """A float64 low-memory pipeline on the plain versions that takes the
    float32 scan path's algorithm: its Newton exits, its fixed Krylov trips
    and the per-solve solves' plain versions (the float64 reference of the
    scan arm's adjoint gate)."""
    from vch_tpu_torch.models.lowmem import LowMemPipeline2D
    from vch_tpu_torch.ops import march as km

    cfg64 = dataclasses.replace(pipe32.config, dtype="float64")
    pipe = LowMemPipeline2D(cfg64, K=pipe32.K, device=device)
    f32, a32 = pipe32.solver, pipe32.adjoint
    f64, a64 = pipe.solver, pipe.adjoint
    f64.rtol, f64.stagnation = f32.rtol, f32.stagnation
    f64.krylov_tol = f32.krylov_tol
    f64._krylov_fixed, a64._krylov_fixed = f32._krylov_fixed, a32._krylov_fixed
    f64._use_pallas = a64._use_pallas = True
    f64.entries = a64.entries = km.PLAIN
    return pipe


def _scan_adjoint_gate(torch, device, prob, sc, u):
    """The scan arm's adjoint r on the kernels, on the plain versions in
    float32 and in float64 (`_scan_f64_twin`), from the same control u:
    the numbers of the phase-2 adjoint gate."""
    from vch_tpu_torch.ops import march as km

    def r_of(pipe, dtype):
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                      device=device)
        uu, phi0, phiQ, phiT = t(u), t(sc.phi0), t(sc.phi_Q), t(sc.phi_T)
        b1, b2 = t(sc.b1), t(sc.b2)
        state = pipe.core.forward_ckpt(uu, phi0, phiQ, phiT)
        return pipe.core.adjoint_r(state, uu, phiQ, b1, b2, phiT)

    pipe = prob.pipe
    pipe.solver.entries = pipe.adjoint.entries = km.KERNELS
    rk = r_of(pipe, torch.float32)
    pipe.solver.entries = pipe.adjoint.entries = km.PLAIN
    rp = r_of(pipe, torch.float32)
    pipe.solver.entries = pipe.adjoint.entries = km.KERNELS
    r64 = r_of(_scan_f64_twin(pipe, device), torch.float64)
    torch.cuda.synchronize()
    return dict(max_abs_dr=(rk - rp).abs().max().item(), rel_dr=_rel(rk, rp, rp),
                rel_r_kernel_vs_f64=_rel(rk, r64, r64),
                rel_r_plain_vs_f64=_rel(rp, r64, r64),
                r_finite=bool(torch.isfinite(rk).all()))


def scan_slice_case(torch, device, variant="spectral", lowmem_K=None, n=32,
                    T=0.1, iters=2):
    """Phase 3e: the scan path (fused_march=False) of BatchedProblem2D, or
    of LowMemBatchedProblem2D with lowmem_K, at 32x32 on the heterogeneous
    B = 8 sweep, kernel path (the per-solve kernels, one member per cluster)
    against plain path, 2 PGD iterations; the low-memory one also gates its
    adjoint r against float64 on the kernel run's final control."""
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.parallel.batch import (BatchedProblem2D,
                                              LowMemBatchedProblem2D)

    cfg = _config(n, T=T, pallas_variant=variant)
    sc = _slice_sweep(cfg, n_b3=4, n_ks=2)
    runs = {}
    for path in ("kernel", "plain"):
        prob = (LowMemBatchedProblem2D(cfg, K=lowmem_K, device=device,
                                       fused_march=False)
                if lowmem_K else
                BatchedProblem2D(cfg, device=device, fused_march=False))
        if prob._use_fused_march or prob.straggler_batch is not None:
            raise RuntimeError("fused_march=False still takes the fused path")
        if path == "plain":
            prob.solver.entries = prob.adj.entries = km.PLAIN
        km.reset_launches()
        t0 = time.perf_counter()
        out = prob.run(sc, max_iter=iters, verbose=False)
        runs[path] = (prob, out, time.perf_counter() - t0, km.launch_counts())
    (kp, ko, kt, kl), (_, po, pt, pl) = runs["kernel"], runs["plain"]
    c0, c1 = po["cost_history"], ko["cost_history"]
    res = dict(variant=variant, lowmem_K=lowmem_K, n=n, B=sc.batch,
               M=kp.solver.M, iters=iters,
               rel_cost=float((np.abs(c1 - c0) / np.abs(c0)).max()),
               newton_kernel=ko["newton_solves"],
               newton_plain=po["newton_solves"], kernel_s=kt, plain_s=pt,
               launches={k: v for k, v in kl.items() if v},
               plain_launches={k: v for k, v in pl.items() if v},
               cost_history_mean=c1.mean(axis=1).tolist(),
               finite=bool(np.isfinite(c1).all()))
    if lowmem_K:
        res.update(_scan_adjoint_gate(torch, device, kp, sc, ko["u"]))
    return res


def check_scan_slice(c):
    """Phase 3e gates: the variant's two per-solve kernels launched on the
    kernel path and no whole-march kernel, nothing launched on the plain
    path, costs finite and falling, the kernel path's cost history within
    2e-4 relative of the plain path's, Newton solves within 1%; for the
    low-memory arm the phase-2 adjoint gate on r."""
    schur, adj = (("bicgstab_schur_spectral", "bicgstab_adjoint_spectral")
                  if c["variant"] == "spectral"
                  else ("bicgstab_schur", "bicgstab_adjoint"))
    fails = [f"{k} never launched" for k in (schur, adj)
             if c["launches"].get(k, 0) <= 0]
    fails += [f"{k} launched on the scan path" for k in c["launches"]
              if k not in (schur, adj)]
    fails += [f"plain path launched {k}" for k in c["plain_launches"]]
    ch = c["cost_history_mean"]
    if not c["finite"] or c["rel_cost"] > 2e-4 or not ch[-1] < ch[0]:
        fails.append(f"cost history vs plain {c['rel_cost']}")
    if abs(c["newton_kernel"] - c["newton_plain"]) > 0.01 * c["newton_plain"]:
        fails.append(f"Newton solves {c['newton_kernel']} vs "
                     f"{c['newton_plain']}")
    if c["lowmem_K"]:
        if not c["r_finite"]:
            fails.append("non-finite kernel r")
        fails += _adjoint_gate(c)
    if fails:
        raise RuntimeError(f"scan slice {c['variant']} K={c['lowmem_K']}: "
                           + "; ".join(fails) + f" | {c}")


def scan_full_width(torch, device, T=1.0, fused_mean_cost=None):
    """Phase 4s: the scan path at config 4's full width (128x128, B = 128,
    T = 1: M = 100, float32), BatchedProblem2D(fused_march=False): one
    warm-up and one timed PGD iteration, the launch counts read around the
    timed run and the solve launches' CUDA-event ms inside it (rows 8 and
    9, EntryTimer), peak memory over S; the relative difference of the first
    iteration's mean cost from the fused run of config 4 (information: the
    scan path takes krylov_fixed_iters = 4 forward trips, the fused march
    fused_krylov_fixed_iters = 3)."""
    from vch_tpu_torch.parallel.batch import BatchedProblem2D

    cfg = _config(128, T=T)
    prob = BatchedProblem2D(cfg, device=device, fused_march=False)
    if prob._use_fused_march or not prob.solver._use_pallas:
        raise RuntimeError("config 4's scan path is not on the per-solve "
                           "kernels")
    # CUDA events around every solve launch (rows 8 and 9) of the timed run
    t8 = EntryTimer(torch, prob.solver.entries.schur_spectral, batch_at=7)
    t9 = EntryTimer(torch, prob.adj.entries.adjoint_spectral, batch_at=7)
    prob.solver.entries = prob.solver.entries._replace(schur_spectral=t8)
    prob.adj.entries = prob.adj.entries._replace(adjoint_spectral=t9)
    sc = _bench_sweep(cfg, 128)
    res = pgd_run(torch, device, prob, sc, iters=1,
                  before_timed=lambda: (t8.clear(), t9.clear()))
    res.update(schur_solve=t8.summary(), adjoint_solve=t9.summary())
    res.update(T=T, S_bytes=_traj_bytes(cfg, 128, prob.solver.M),
               peak_over_S=res["peak_bytes"] / _traj_bytes(cfg, 128,
                                                           prob.solver.M))
    if fused_mean_cost is not None:
        res["rel_cost_vs_fused_config4"] = (
            abs(res["mean_cost_history"][1] - fused_mean_cost)
            / abs(fused_mean_cost))
    return prob, sc, res


def _probe_gate(torch, device, n, b, iters):
    """Each probe kernel against its plain version on the card and both
    against the plain version in float64, on the probe's inputs at its
    shape; mmonly also over one link, which stays inside float32's range
    where the whole chain does not (at n = 65 ten links of these
    0.01-scaled operators fall below it, and float32 gives 0 for a float64
    value of ~1e-51). Returns the numbers and the plain versions' ms."""
    from vch_tpu_torch.ops import solve_kernels as sk
    from vch_tpu_torch.probes.diag_kernel_cost import probe_args

    a32 = probe_args(n - 1, b, device)
    a64 = probe_args(n - 1, b, device, dtype=torch.float64)
    out = {}
    for name, links in (("nodots", iters), ("mmonly", iters), ("mmonly", 1)):
        wrapper = getattr(sk, f"schur_{name}")
        plain = getattr(sk, f"schur_{name}_plain")
        k = wrapper(*a32, n_iter=links)
        p = plain(*a32, n_iter=links)
        p64 = plain(*a64, n_iter=links)
        torch.cuda.synchronize()
        tag = name if links == iters else f"{name}_1"
        out[tag] = dict(n_iter=links, finite=bool(torch.isfinite(k).all()),
                        scale_f64=p64.abs().max().item(),
                        max_abs_err=(k - p).abs().max().item(),
                        rel_kernel_vs_plain=_rel(k, p, p64),
                        rel_kernel_vs_f64=_rel(k, p64, p64),
                        rel_plain_vs_f64=_rel(p, p64, p64))
        if links == iters:
            out[tag]["plain_ms"] = time_ms(
                lambda: plain(*a32, n_iter=links), 3)
    return out


PROBE_KERNELS = ("schur_nodots", "schur_mmonly")


def _probe_bits(torch, device, n, b, iters, every_cluster):
    """Rows 16-17 on their cluster kernels bit for bit against their
    one-CTA oracles on the probe's inputs at (n, b): nodots over the
    shape's trips, mmonly over its links and over one (`_probe_gate`); with
    every_cluster, also one member at n on one cluster of every size 1-16.
    Returns {tag: equal} and the cluster sizes that differ."""
    from vch_tpu_torch.ops import solve_kernels as sk
    from vch_tpu_torch.probes.diag_kernel_cost import probe_args

    args, one = probe_args(n - 1, b, device), probe_args(n - 1, 1, device)
    out, differ = {}, {}
    for name, links in (("nodots", iters), ("mmonly", iters), ("mmonly", 1)):
        new = getattr(sk, f"schur_{name}")
        old = getattr(sk, f"_schur_{name}_cta")
        tag = name if links == iters else f"{name}_1"
        out[tag] = bool(torch.equal(new(*args, n_iter=links),
                                    old(*args, n_iter=links)))
        if every_cluster and links == iters:
            ref = old(*one, n_iter=links)
            differ[name] = [C for C in range(1, 17) if not torch.equal(
                new(*one, n_iter=links, cluster=C), ref)]
    torch.cuda.synchronize()
    return out, differ


def probe_case(torch, device, n, b, iters, reps=20, every_cluster=False):
    """Phase 2f: the probe entry point (vch_tpu_torch.probes.
    diag_kernel_cost) at one shape, with the launch counts set to 0 just
    before it and read just after; then, their launches counted apart
    (`gate_launches`), the probe kernels' float64 gates, rows 16-17 bit for
    bit their one-CTA oracles (`_probe_bits`), each timed in turns with
    its oracle (oracle, cluster, cluster, oracle; CUDA events), and the
    cluster geometry of the probes and of `full`."""
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.ops import solve_kernels as sk
    from vch_tpu_torch.probes import diag_kernel_cost as probe

    km.reset_launches()
    res = probe.run(n - 1, b, iters, reps, device=device)
    res["launches"] = {k: v for k, v in km.launch_counts().items() if v}
    km.reset_launches()
    res["gate"] = _probe_gate(torch, device, n, b, iters)
    res["bits"], res["cluster_bits_differ"] = _probe_bits(
        torch, device, n, b, iters, every_cluster)
    args = probe.probe_args(n - 1, b, device)
    res["turns"] = {k: _turns(
        lambda k=k: getattr(sk, f"_{k}_cta")(*args, n_iter=iters),
        lambda k=k: getattr(sk, k)(*args, n_iter=iters), reps)
        for k in PROBE_KERNELS}
    res["gate_launches"] = {k: v for k, v in km.launch_counts().items() if v}
    idx = torch.device(device).index or 0
    res["geometry"] = {}
    for kernel in ("schur_probe", "raw_schur_solve"):
        g = sk.solve_geometry(n, n, b, idx, kernel)
        res["geometry"][kernel] = dict(
            cluster=g.cluster, ctas=b * g.cluster, kc=g.kc,
            smem_bytes=g.smem_bytes, resident_clusters=km.resident_clusters(
                idx, n, n, g.cluster, g.kc, g.smem_bytes, 1, False, kernel))
    return res


def check_probe_case(c):
    """Phase 2f gates: the entry point launched the cluster kernels of
    `full` (bicgstab_schur), nodots and mmonly, and no one-CTA oracle; the
    gates launched both probes' oracles; each probe kernel finite, no
    farther from float64 than twice the plain float32 version plus 1e-5
    (the phase-2c pattern; mmonly's one link is the relative test where the
    whole chain underflows) and bit for bit its oracle (at every cluster
    size tried); the script's five keys finite."""
    fails = [f"{k} never launched" for k in ("bicgstab_schur",
                                             "schur_nodots", "schur_mmonly")
             if c["launches"].get(k, 0) <= 0]
    fails += [f"the entry point launched {k}" for k in c["launches"]
              if k.endswith("_cta")]
    fails += [f"{k} never launched by the gates"
              for k in ("_schur_nodots_cta", "_schur_mmonly_cta")
              if c["gate_launches"].get(k, 0) <= 0]
    fails += [f"{tag}: the cluster kernel differs from its one-CTA oracle"
              for tag, equal in c["bits"].items() if not equal]
    fails += [f"{k}: clusters {v} differ from the one-CTA oracle"
              for k, v in c["cluster_bits_differ"].items() if v]
    for tag, g in c["gate"].items():
        if not g["finite"]:
            fails.append(f"{tag}: non-finite")
        if g["rel_kernel_vs_f64"] > 2 * g["rel_plain_vs_f64"] + 1e-5:
            fails.append(f"{tag}: {g['rel_kernel_vs_f64']} from float64, "
                         f"plain float32 {g['rel_plain_vs_f64']}")
    if c["gate"]["mmonly_1"]["scale_f64"] < 1e-30:
        fails.append("mmonly's one link left float32's range")
    keys = ("full_ms", "nodots_ms", "mmonly_ms", "full_us_per_member_trip",
            "reduction_share")
    if not all(np.isfinite(c[k]) for k in keys):
        fails.append("non-finite probe keys")
    if fails:
        raise RuntimeError(f"probe n={c['n']} b={c['b']}: " + "; ".join(fails)
                           + f" | {c}")


def probe_device_times(torch, device, shapes=((65, 32, 10), (129, 128, 4))):
    """Phase 2e-dev, rows 16-17: at phase 2f's shapes (n, B, trips), each
    probe's cluster kernel, its one-CTA oracle and its library form (the
    plain version's PyTorch calls, batched over B), and the probe's `full`
    (bicgstab_schur), each on the device alone (calls captured in one CUDA
    graph, `probes/_timing.py` graph_ms; the scalars 0-d tensors on the
    card, as a capture of the oracle needs). After phase 7, as every
    capture."""
    from vch_tpu_torch.ops import solve_kernels as sk
    from vch_tpu_torch.probes.diag_kernel_cost import probe_args

    out = []
    for n, B, iters in shapes:
        a = probe_args(n - 1, B, device)
        a = a[:9] + tuple(torch.tensor(v, device=device) for v in a[9:])
        reps = 20 if n == 65 else 5
        run = lambda fn: graph_ms(lambda: fn(*a, n_iter=iters), reps)
        row = dict(n=n, B=B, iters=iters, full_ms=run(sk.bicgstab_schur))
        for k in PROBE_KERNELS:
            row[k] = dict(ms=run(getattr(sk, k)),
                          oracle_ms=run(getattr(sk, f"_{k}_cta")),
                          library_ms=run(getattr(sk, f"{k}_plain")))
        row["reduction_share"] = 1.0 - row["schur_nodots"]["ms"] / \
            row["full_ms"]
        out.append(row)
    return out


# Phase 2g runs diag_march_sol's chain at 200 solves' worth of links, a
# tenth of the script's AMORT = 2000 (the entry point alone keeps 2000), so
# that the phase stays within ~60 s.
CHAIN_AMORT = 200

# Row 19 against its float32 plain version, relative to the plain field's
# largest |value| (the card test's gate; the kernel's products are the plain
# version's own roundings, so the measured difference is 0).
WHILE_REL_PLAIN = 1e-6


def _gate(torch, k, p, p64):
    """A kernel's output k against its plain version p on the same float32
    inputs and both against the plain version in float64."""
    return dict(finite=bool(torch.isfinite(k).all()),
                scale_f64=p64.abs().max().item(),
                max_abs_err=(k - p).abs().max().item(),
                rel_kernel_vs_plain=_rel(k, p, p64),
                rel_kernel_vs_f64=_rel(k, p64, p64),
                rel_plain_vs_f64=_rel(p, p64, p64))


def _chain_probe_gates(torch, device):
    """Each probe kernel of phase 2g against its plain version on the card
    and the plain version in float64, at the scripts' shapes, with the plain
    versions' CUDA-event ms: the chain over three links of diag_march_sol's
    inputs (its 0.01-scaled operator leaves float32's range after ~45), and
    at the phase's link count on one member of diag_interleave's inputs
    (0.999 Q keeps it in range: 0.999^8000 ~ 3e-4); both chains at
    diag_interleave's B = 32, L = 40 for every K; each microbench variant
    at bb = 8, k = 64; the while probe against the float64 plain version."""
    from vch_tpu_torch.ops import probe_kernels as pk
    from vch_tpu_torch.probes import diag_blocked_microbench as mb
    from vch_tpu_torch.probes import diag_interleave as di
    from vch_tpu_torch.probes import diag_march_sol as dm
    from vch_tpu_torch.probes import probe_while as pw

    f64 = torch.float64
    out = {}
    a, v = dm.chain_inputs(64, device)
    a64, v64 = dm.chain_inputs(64, device, f64)
    k3 = pk.matmul_chain(a, v, 1, 3)
    out["chain_3"] = _gate(torch, k3, pk.matmul_chain_plain(a, v, 1, 3),
                           pk.matmul_chain_plain(a64, v64, 1, 3))
    out["chain_3"]["equals_cta"] = torch.equal(
        k3, pk._matmul_chain_cta(a, v, 1, 3))
    links = dm.mm_per_solve(3) * CHAIN_AMORT
    out["chain_plain_ms"] = time_ms(
        lambda: pk.matmul_chain_plain(a, v, 1, links), 1)

    A, X = di.inputs(64, 32, device)
    A64, X64 = di.inputs(64, 32, device, f64)
    kl = pk.matmul_chain(A, X[:1], 1, links)
    out["chain_long"] = _gate(torch, kl,
                              pk.matmul_chain_plain(A, X[:1], 1, links),
                              pk.matmul_chain_plain(A64, X64[:1], 1, links))
    out["chain_long"]["equals_cta"] = torch.equal(
        kl, pk._matmul_chain_cta(A, X[:1], 1, links))
    p, p64 = (pk.matmul_chain_plain(A, X, 1, 40),
              pk.matmul_chain_plain(A64, X64, 1, 40))
    pb = pk.matmul_chain_bf16_plain(A, X, 1, 40)
    hi = [pk.matmul_chain(A, X, K, 40) for K in di.WIDTHS]
    lo = [pk.matmul_chain_bf16(A, X, K, 40) for K in di.WIDTHS]
    out["interleave"] = _gate(torch, hi[-1], p, p64)
    out["interleave"]["widths_equal"] = all(torch.equal(h, hi[0]) for h in hi)
    # each width on its launch geometry against the one-CTA oracle
    out["interleave"]["equals_cta"] = {
        K: torch.equal(h, pk._matmul_chain_cta(A, X, K, 40))
        for K, h in zip(di.WIDTHS, hi)}
    out["bf16"] = dict(_gate(torch, lo[-1], pb, p64),
                       rel_kernel_vs_plain=(lo[-1] - pb).abs().max().item()
                       / pb.abs().max().item(),
                       widths_equal=all(torch.equal(h, lo[0]) for h in lo),
                       equals_wmma={K: torch.equal(
                           h, pk._matmul_chain_bf16_cta(A, X, K, 40))
                           for K, h in zip(di.WIDTHS, lo)})
    # the float32 chain on one cluster of K members at every cluster size
    # that fits, at three grids, against the one-CTA oracle
    out["cluster_bits"] = {}
    for n in (17, 65, 129):
        An, Xn = di.inputs(n - 1, 8, device)
        for K in di.WIDTHS:
            ref = pk._matmul_chain_cta(An, Xn[:K], K, 40)
            Cs = range(1, min(16, n) + 1)
            out["cluster_bits"][f"{n}x{K}"] = dict(
                clusters=len(Cs), differ=[C for C in Cs if not torch.equal(
                    pk.matmul_chain(An, Xn[:K], K, 40, cluster=C), ref)])
    for key, fn in (("interleave", pk.matmul_chain_plain),
                    ("bf16", pk.matmul_chain_bf16_plain)):
        out[key]["plain_ms"] = time_ms(lambda: fn(A, X, 8, 40), 5)

    C, Xm = mb.inputs(64, 8, device)
    C64, Xm64 = mb.inputs(64, 8, device, f64)
    micro = {}
    for var in pk.VARIANTS:
        plain = lambda c, x, var=var: pk.blocked_microbench_plain(var, c, x, 8,
                                                                  64)
        (k, ks), (q, qs), (q64, qs64) = (pk.blocked_microbench(var, C, Xm, 8,
                                                               64),
                                         plain(C, Xm), plain(C64, Xm64))
        g = _gate(torch, k, q, q64)
        o, os_ = pk._blocked_microbench_cta(var, C, Xm, 8, 64)
        g["equals_cta"] = torch.equal(k, o) and torch.equal(ks, os_)
        if var == "swap":
            g["bit_equal_plain"] = torch.equal(k, q)
        if var in ("gdot", "member_dot"):
            g.update(unchanged=torch.equal(k, Xm),
                     sums=_gate(torch, ks, qs, qs64))
        g["plain_ms"] = time_ms(lambda: plain(C, Xm), 1)
        micro[var] = g
    out["microbench"] = micro
    out["stacked_equals_member"] = torch.equal(
        pk.blocked_microbench("stacked_mm", C, Xm, 8, 64)[0],
        pk.blocked_microbench("member_mm", C, Xm, 8, 64)[0])
    # each variant on one cluster of every size 1-16, blocks of 8 and of 1,
    # against the one-CTA oracle (out and sums), 16 steps
    out["micro_cluster_bits"] = {}
    for bb in (8, 1):
        Cb, Xb = mb.inputs(64, bb, device)
        for var in pk.VARIANTS:
            ref = pk._blocked_microbench_cta(var, Cb, Xb, bb, 16)
            out["micro_cluster_bits"][f"{var}x{bb}"] = [
                c for c in range(1, 17) if not all(
                    torch.equal(a, b) for a, b in zip(pk.blocked_microbench(
                        var, Cb, Xb, bb, 16, cluster=c), ref))]

    x = pw.inputs(2, 65, device)
    k, ns = pk.while_probe(x, 3)
    p32, _ = pk.while_probe_plain(x, 3)
    p64, ns64 = pk.while_probe_plain(x.double(), 3)
    torch.cuda.synchronize()
    scale32, scale64 = p32.abs().max().item(), p64.abs().max().item()
    out["while"] = dict(
        finite=bool(torch.isfinite(k).all()),
        max_abs_diff_f64=(k.double() - p64).abs().max().item(),
        rel_kernel_vs_plain=(k - p32).abs().max().item() / scale32,
        rel_kernel_vs_f64=(k.double() - p64).abs().max().item() / scale64,
        rel_plain_vs_f64=(p32.double() - p64).abs().max().item() / scale64,
        ns_equal=torch.equal(ns.cpu(), ns64.cpu()))
    return out


def chain_probe_case(torch, device):
    """Phase 2g: the four probe entry points (vch_tpu_torch.probes.
    diag_march_sol, diag_interleave, diag_blocked_microbench and
    probe_while) at the scripts' default shapes, diag_march_sol's chain at
    CHAIN_AMORT, each with the launch counts set to 0 just before it and
    read just after; then each probe kernel's gates."""
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.probes import (diag_blocked_microbench,
                                      diag_interleave, diag_march_sol,
                                      probe_while)

    t0 = time.perf_counter()
    runs = {}
    for key, fn in (
            ("march_sol", lambda: diag_march_sol.run(
                amort=CHAIN_AMORT, reps=1, device=device)),
            ("interleave", lambda: diag_interleave.run(device=device)),
            ("microbench", lambda: diag_blocked_microbench.run(
                device=device)),
            ("while", lambda: probe_while.run(device=device))):
        km.reset_launches()
        runs[key] = fn()
        runs[key]["launches"] = {k: v for k, v in km.launch_counts().items()
                                 if v}
    runs["gate"] = _chain_probe_gates(torch, device)
    runs["timing"] = chain_timing(torch, device)
    runs["micro_timing"] = micro_timing(torch, device)
    runs["while_bits"] = while_bits(torch, device)
    runs["while_timing"] = while_timing(torch, device)
    runs["seconds"] = time.perf_counter() - t0
    return runs


def _turns(old, new, reps):
    """CUDA-event ms of two versions of one function in turns: old, new,
    new, old."""
    t = [time_ms(f, reps) for f in (old, new, new, old)]
    return dict(old_ms=[t[0], t[3]], new_ms=[t[1], t[2]])


def chain_timing(torch, device):
    """Rows 20 and 21 on their Hopper kernels and their one-CTA oracles in
    turns (CUDA events): the chain at phase 2g's link count on one member
    of diag_march_sol's inputs, the interleaved float32 and bf16 chains at
    diag_interleave's B = 32, L = 40, K = 8; then the float32 chain's time
    per link on one cluster at each cluster size, one member (that link
    count) and eight (40 links): the cluster engine's left-product floor."""
    from vch_tpu_torch.ops import probe_kernels as pk
    from vch_tpu_torch.probes import diag_interleave as di
    from vch_tpu_torch.probes import diag_march_sol as dm

    links = dm.mm_per_solve(3) * CHAIN_AMORT
    a, v = dm.chain_inputs(64, device)
    A, X = di.inputs(64, 32, device)
    geo = lambda B, K, C=None: pk.probe_geometry("chain", 65, B, K, 0, C).cluster
    out = dict(
        row20=dict(links=links, cluster=geo(1, 1), **_turns(
            lambda: pk._matmul_chain_cta(a, v, 1, links),
            lambda: pk.matmul_chain(a, v, 1, links), 1)),
        row21=dict(B=32, L=40, K=8, cluster=geo(32, 8), **_turns(
            lambda: pk._matmul_chain_cta(A, X, 8, 40),
            lambda: pk.matmul_chain(A, X, 8, 40), 20)),
        row21_bf16=dict(B=32, L=40, K=8, **_turns(
            lambda: pk._matmul_chain_bf16_cta(A, X, 8, 40),
            lambda: pk.matmul_chain_bf16(A, X, 8, 40), 20)))
    out["us_per_link_by_cluster"] = {
        f"K{K}": {C: time_ms(lambda: pk.matmul_chain(
            x, X[:K], K, L, cluster=C), reps) * 1e3 / L
            for C in (16, 8, 4, 2, 1)}
        for K, x, L, reps in ((1, A, links, 1), (8, A, 40, 10))}
    return out


def micro_timing(torch, device):
    """Row 18 at the probe's shape (bb = 8, k = 64, n = 65): each variant
    on its cluster kernel and on its one-CTA oracle in turns (CUDA events),
    then its µs a step on one cluster of each size (`us_per_op_by_cluster`)."""
    from vch_tpu_torch.ops import probe_kernels as pk
    from vch_tpu_torch.probes import diag_blocked_microbench as mb

    C, X = mb.inputs(64, 8, device)
    run = lambda v, c=None: pk.blocked_microbench(v, C, X, 8, 64, cluster=c)
    return dict(
        cluster=pk.probe_geometry("micro", 65, 8, 8, 0).cluster,
        turns={v: _turns(lambda v=v: pk._blocked_microbench_cta(v, C, X, 8,
                                                                64),
                         lambda v=v: run(v), 5) for v in pk.VARIANTS},
        us_per_op_by_cluster={v: {c: time_ms(lambda v=v, c=c: run(v, c), 5)
                                  * 1e3 / 64 for c in (16, 8, 4, 2, 1)}
                              for v in pk.VARIANTS})


def while_bits(torch, device):
    """Row 19 (csrc/while_fused.cu) against its one-CTA oracle of probes.cu,
    phi and ns bit for bit, at n = 9, 17, 65, 101, B = 1, 2, 3 and M = 1, 3,
    member 2 of each B = 3 batch seeded with one NaN (NaN at the same
    places, ns = 50 M there). Returns the shapes that differ."""
    from vch_tpu_torch.ops import probe_kernels as pk
    from vch_tpu_torch.probes import probe_while as pw

    differ, shapes = [], 0
    for n in (9, 17, 65, 101):
        for B in (1, 2, 3):
            x = pw.inputs(B, n, device)
            if B == 3:
                x[2, n // 2, n // 3] = float("nan")
            for M in (1, 3):
                out, ns = pk.while_probe(x, M)
                ref, ns_ref = pk._while_probe_cta(x, M)
                ok = (torch.equal(out.view(torch.int32),
                                  ref.view(torch.int32))
                      and torch.equal(ns, ns_ref))
                if B == 3:
                    ok = ok and int(ns[2]) == 50 * M and torch.equal(
                        torch.isnan(out[2]), torch.isnan(x[2]))
                shapes += 1
                if not ok:
                    differ.append((n, B, M))
    torch.cuda.synchronize()
    return dict(shapes=shapes, differ=differ)


def while_timing(torch, device):
    """Row 19 at the script's shape (B = 2, M = 3, n = 65) on its kernel
    and on its one-CTA oracle in turns (CUDA events), with the trips and
    the CTA reductions each takes (the oracle three a trip, the kernel one
    a trip and one a launch: every inner trial accepts on this input)."""
    from vch_tpu_torch.ops import probe_kernels as pk
    from vch_tpu_torch.probes import probe_while as pw

    x = pw.inputs(2, 65, device)
    _, ns = pk.while_probe(x, 3)
    trips = ns.cpu().ravel().tolist()
    return dict(B=2, M=3, n=65, trips=trips,
                reductions=dict(oracle=[3 * t for t in trips],
                                kernel=[t + 1 for t in trips]),
                **_turns(lambda: pk._while_probe_cta(x, 3),
                         lambda: pk.while_probe(x, 3), 50))


def while_device_times(torch, device):
    """Row 19 and its one-CTA oracle on the device alone (calls captured in
    one CUDA graph) at the script's shape; no PyTorch call computes the
    nested loops, and the plain version's host syncs take no capture."""
    from vch_tpu_torch.ops import probe_kernels as pk
    from vch_tpu_torch.probes import probe_while as pw

    x = pw.inputs(2, 65, device)
    return dict(ms=graph_ms(lambda: pk.while_probe(x, 3), 50),
                oracle_ms=graph_ms(lambda: pk._while_probe_cta(x, 3), 50))


def _micro_library(torch, variant, C, X, bb, k):
    """The microbench's k steps as PyTorch calls, the fewest a step: one
    torch.matmul of member 0 (serial_one), of the batched members
    (member_mm, left_mm; swap_mm on their transposed view) or of the
    stacked ones (stacked_mm); for swap one torch.mul of the transposed
    view into a contiguous buffer (a transposed copy); for gdot and
    member_dot torch.linalg.vecdot of the flattened members (the sums), the
    factor (two small calls; member_dot sums the members' terms first) and
    one torch.mul."""
    n = C.shape[0]
    if variant in ("serial_one", "stacked_mm"):
        x = X[:n] if variant == "serial_one" else X
        for _ in range(k):
            x = torch.matmul(x, C)
        return x
    x = X.reshape(bb, n, n)
    for _ in range(k):
        if variant == "member_mm":
            x = torch.matmul(x, C)
        elif variant == "left_mm":
            x = torch.matmul(C, x)
        elif variant == "swap_mm":
            x = torch.matmul(x.transpose(1, 2), C)
        elif variant == "swap":
            x = torch.mul(x.transpose(1, 2), 1.0000001,
                          out=torch.empty_like(x))
        else:
            flat = x.reshape(bb, -1)
            s = torch.linalg.vecdot(flat, flat)
            if variant == "member_dot":
                s = torch.sum(s)
            fac = s.mul(1e-12).add(1.0)
            x = torch.mul(x, fac if variant == "member_dot"
                          else fac[:, None, None])
    return x


def micro_device_times(torch, device):
    """Row 18 on the device alone (calls captured in one CUDA graph,
    `probes/_timing.py` graph_ms) at the probe's shape: each variant's
    cluster kernel, its one-CTA oracle and its library form
    (`_micro_library`). After phase 7, as every capture."""
    from vch_tpu_torch.ops import probe_kernels as pk
    from vch_tpu_torch.probes import diag_blocked_microbench as mb

    C, X = mb.inputs(64, 8, device)
    return {v: dict(
        ms=graph_ms(lambda v=v: pk.blocked_microbench(v, C, X, 8, 64), 10),
        oracle_ms=graph_ms(
            lambda v=v: pk._blocked_microbench_cta(v, C, X, 8, 64), 3),
        library_ms=graph_ms(
            lambda v=v: _micro_library(torch, v, C, X, 8, 64), 10))
        for v in pk.VARIANTS}


def chain_device_times(torch, device):
    """Phase 2g-dev: rows 20 and 21 (new kernel, one-CTA oracle) and their
    library form, L torch.matmul links, each on the device alone (calls
    captured in one CUDA graph, `probes/_timing.py` graph_ms): the
    interleaved chains at B = 32, L = 40, K = 8 (float32, and bf16 with
    bf16 operands and outputs in the library form), the chain at phase
    2g's link count on one member. Last, as apply_device_times: a capture
    leaves cuBLAS a workspace."""
    from vch_tpu_torch.ops import probe_kernels as pk
    from vch_tpu_torch.probes import diag_interleave as di
    from vch_tpu_torch.probes import diag_march_sol as dm

    A, X = di.inputs(64, 32, device)
    Ab, Xb = A.to(torch.bfloat16), X.to(torch.bfloat16)
    links = dm.mm_per_solve(3) * CHAIN_AMORT
    a, v = dm.chain_inputs(64, device)
    return dict(
        row21=dict(ms=graph_ms(lambda: pk.matmul_chain(A, X, 8, 40)),
                   oracle_ms=graph_ms(
                       lambda: pk._matmul_chain_cta(A, X, 8, 40)),
                   library_ms=graph_ms(
                       lambda: pk.matmul_chain_plain(A, X, 8, 40))),
        row21_bf16=dict(
            ms=graph_ms(lambda: pk.matmul_chain_bf16(A, X, 8, 40)),
            oracle_ms=graph_ms(
                lambda: pk._matmul_chain_bf16_cta(A, X, 8, 40)),
            library_ms=graph_ms(
                lambda: pk.matmul_chain_plain(Ab, Xb, 8, 40))),
        row20=dict(links=links,
                   ms=graph_ms(lambda: pk.matmul_chain(a, v, 1, links), 2),
                   oracle_ms=graph_ms(
                       lambda: pk._matmul_chain_cta(a, v, 1, links), 2),
                   library_ms=graph_ms(
                       lambda: pk.matmul_chain_plain(a, v, 1, links), 1)))


def _while_work(B, n, ns):
    """(FLOPs, bytes) the while probe's function needs on this run's data:
    x read and out written once (ns too), and 3 FLOP per element a trip
    (one multiply for phi f1 and one FMA for its square's sum) plus 2 per
    element a member for sum x^2. That is the least: where the first trial
    accepts (every trip of a finite input), the trial phi f1 is bit for bit
    the updated phi, so the trial's sum is the norm's sum after the update
    and one pass does both. The kernel itself does 6 a trip (it carries the
    trial and the updated phi apart, so that a rejected trial still holds
    phi)."""
    return (3.0 * n * n * sum(ns) + 2.0 * B * n * n,
            4 * (2 * B * n * n + B))


def check_chain_probe_case(c):
    """Phase 2g gates: each kernel launched by its entry point; finite; the
    float32 products no farther from float64 than twice the plain float32
    version plus 1e-5 (the chain over three links, the interleaved chain,
    the chain at the phase's link count on norm-stable inputs, each
    microbench product; gdot's and member_dot's sums), every
    interleave width bit-equal, the bf16 chain within BF16_CHAIN_TOL of its
    bf16-emulated plain version, swap bit-equal to plain, gdot and
    member_dot returning X, the stacked product bit-equal to the
    per-member one, every microbench variant bit-equal (out and sums) to
    its one-CTA oracle at bb = 8, k = 64 and on one cluster of every size
    1-16 at bb = 8 and 1, k = 16, the entry point on its geometry's cluster
    and never on the oracle; the while probe within 1e-4 of float64 with equal trip
    counts (its entry point also raises on the script's gates), within
    WHILE_REL_PLAIN of the float32 plain version relative to its largest
    value and no farther from float64 than twice the plain float32 version
    plus WHILE_REL_PLAIN (both relative: after the script's 34 trips a
    typical |phi| is ~5e-6, so the 1e-4 gate alone would pass an all-zero
    field), bit for bit
    its one-CTA oracle at every shape of `while_bits`, its entry point never
    on the oracle; every time finite."""
    fails = [f"{key}: {name} never launched"
             for key, names in (("march_sol", ("matmul_chain",)),
                                ("interleave", ("matmul_chain",
                                                "matmul_chain_bf16")),
                                ("microbench", ("blocked_microbench",)),
                                ("while", ("while_probe",)))
             for name in names if c[key]["launches"].get(name, 0) <= 0]
    g = c["gate"]
    f64_gated = [(k, g[k]) for k in ("chain_3", "chain_long", "interleave")]
    for var, m in g["microbench"].items():
        if var in ("gdot", "member_dot"):
            f64_gated.append((f"{var} sums", m["sums"]))
            if not m["unchanged"]:
                fails.append(f"{var} changed X")
        elif var == "swap":
            if not m["bit_equal_plain"]:
                fails.append("swap differs from plain")
        else:
            f64_gated.append((var, m))
        if not m["finite"]:
            fails.append(f"{var}: non-finite")
    for tag, m in f64_gated:
        if not m["finite"]:
            fails.append(f"{tag}: non-finite")
        if m["rel_kernel_vs_f64"] > 2 * m["rel_plain_vs_f64"] + 1e-5:
            fails.append(f"{tag}: {m['rel_kernel_vs_f64']} from float64, "
                         f"plain float32 {m['rel_plain_vs_f64']}")
    if not (g["interleave"]["widths_equal"] and g["bf16"]["widths_equal"]):
        fails.append("interleave widths differ")
    if not (g["chain_3"]["equals_cta"] and g["chain_long"]["equals_cta"]
            and all(g["interleave"]["equals_cta"].values())):
        fails.append("the cluster chain differs from its one-CTA oracle")
    differ = {k: b["differ"] for k, b in g["cluster_bits"].items()
              if b["differ"]}
    if differ:
        fails.append(f"the cluster chain differs from its one-CTA oracle on "
                     f"clusters (n x K: C) {differ}")
    if not all(g["bf16"]["equals_wmma"].values()):
        fails.append(f"the mma.sync bf16 chain differs from the wmma one: "
                     f"{g['bf16']['equals_wmma']}")
    if not g["bf16"]["finite"] or \
            g["bf16"]["rel_kernel_vs_plain"] > BF16_CHAIN_TOL:
        fails.append(f"bf16 chain {g['bf16']['rel_kernel_vs_plain']} from "
                     f"its emulated plain version")
    if g["chain_long"]["scale_f64"] < 1e-30:
        fails.append("the long chain left float32's range")
    if not g["stacked_equals_member"]:
        fails.append("stacked product differs from the per-member one")
    if c["microbench"]["launches"].get("_blocked_microbench_cta", 0):
        fails.append("the microbench's entry point ran the one-CTA kernel")
    if c["microbench"]["cluster"] != c["micro_timing"]["cluster"]:
        fails.append("the microbench ran on another cluster than its "
                     "geometry's")
    differ = [v for v, m in g["microbench"].items() if not m["equals_cta"]]
    differ += [f"{k} on clusters {cs}" for k, cs in
               g["micro_cluster_bits"].items() if cs]
    if differ:
        fails.append(f"the cluster microbench differs from its one-CTA "
                     f"oracle: {differ}")
    w = g["while"]
    if not (w["finite"] and w["max_abs_diff_f64"] < 1e-4 and w["ns_equal"]
            and w["rel_kernel_vs_plain"] <= WHILE_REL_PLAIN
            and w["rel_kernel_vs_f64"]
            <= 2 * w["rel_plain_vs_f64"] + WHILE_REL_PLAIN):
        fails.append(f"while probe vs its plain version and float64: {w}")
    if c["while_bits"]["differ"]:
        fails.append(f"the while probe differs from its one-CTA oracle at "
                     f"(n, B, M) {c['while_bits']['differ']}")
    if c["while"]["launches"].get("_while_probe_cta", 0):
        fails.append("the while probe's entry point ran the one-CTA kernel")
    times = [c["march_sol"]["chain_ms"], c["march_sol"]["us_ideal"],
             c["while"]["ms"], g["chain_plain_ms"]]
    times += [f["march_ms"] for f in c["march_sol"]["forms"].values()]
    times += [v for k, v in c["interleave"].items() if k.endswith("_mm")]
    times += [r["us_per_op"] for r in c["microbench"]["results"].values()]
    times += [f["chain_ms"] for f in c["march_sol"]["forms"].values()]
    t = c["timing"]
    times += [x for r in ("row20", "row21", "row21_bf16")
              for x in t[r]["old_ms"] + t[r]["new_ms"]]
    times += [x for by in t["us_per_link_by_cluster"].values()
              for x in by.values()]
    mt = c["micro_timing"]
    times += [x for r in mt["turns"].values()
              for x in r["old_ms"] + r["new_ms"]]
    times += [x for by in mt["us_per_op_by_cluster"].values()
              for x in by.values()]
    wt = c["while_timing"]
    times += wt["old_ms"] + wt["new_ms"]
    if not all(np.isfinite(t) and t > 0 for t in times):
        fails.append("non-finite or zero times")
    if fails:
        raise RuntimeError("chain probes: " + "; ".join(fails) + f" | {c}")


def _micro_work(variant, n, bb, k):
    """(FLOPs, bytes) of one microbench launch: 2 n^3 per member product
    (serial_one one member a step, the other products bb), one multiply per
    element for swap, a square, a sum and a scale per element for the two
    reductions; bytes: X in, out and the sums out, and C in for the
    variants that multiply by it (swap, gdot and member_dot never read
    it)."""
    P = 2.0 * n ** 3
    elementwise = {"swap": bb * n * n, "gdot": 3 * bb * n * n,
                   "member_dot": 3 * bb * n * n}
    flops = k * elementwise.get(variant,
                                P if variant == "serial_one" else bb * P)
    c_fields = 0 if variant in elementwise else 1
    return flops, 4 * (n * n * (2 * bb + c_fields) + bb)


def _chain_probe_entries(c, dev, entry):
    """The kernels-line entries of phase 2g: the chain (row 20) at
    CHAIN_AMORT solves' worth of links on one member, the interleaved
    chains (row 21) at the script's B = 32, L = 40 and K = 8, the
    microbench (row 18) as one launch of each of its eight variants at
    bb = 8, k = 64 (times, errors and bounds summed over the variants; with
    its kernel, cluster size, the one-CTA oracle's time in turns and, from
    phase 2g-dev, the device-alone times of kernel, oracle and library
    form, each summed over the variants), the
    while probe (row 19) at B = 2, M = 3 (with its kernel, the one-CTA
    oracle's time in turns and, from phase 2g-dev, the device-alone times
    of both; no library form); launches those of each entry point's run. Rows 20-21 also carry their kernel, cluster size, the
    one-CTA oracle's time in the same turns and, from phase 2g-dev
    (`dev`), the library form's device time (L torch.matmul calls under one
    CUDA graph) beside the kernel's and the oracle's there."""
    src = "vch_tpu_torch/csrc/probes.cu"
    chain_src = "vch_tpu_torch/csrc/chain_cluster.cu"
    mean = lambda v: float(np.mean(v))
    g, t = c["gate"], c["timing"]
    ms, it, mb, wh = (c["march_sol"], c["interleave"], c["microbench"],
                      c["while"])
    n = ms["n"] + 1
    B, L = it["members"], it["chain_len"]
    chain_bytes = 4 * n * n * (2 * B + 1)
    out = [
        entry("matmul_chain", chain_src, "scripts/diag_march_sol.py:86",
              ms["launches"]["matmul_chain"], g["chain_3"]["max_abs_err"],
              ms["chain_ms"], g["chain_plain_ms"],
              (2.0 * n ** 3 * ms["chain_links"], 4 * n * n * 3),
              library_ms=dev["row20"]["library_ms"]),
        entry("matmul_chain_interleaved", chain_src,
              "scripts/diag_interleave.py:86",
              it["launches"]["matmul_chain"], g["interleave"]["max_abs_err"],
              it["highest_K8_ns_per_mm"] * B * L * 1e-6,
              g["interleave"]["plain_ms"],
              (2.0 * n ** 3 * B * L, chain_bytes),
              library_ms=dev["row21"]["library_ms"]),
    ]
    bb16 = _bound(2.0 * n ** 3 * B * L, chain_bytes, PEAK_BF16_FLOPS)
    out.append(entry("matmul_chain_bf16", chain_src,
                     "scripts/diag_interleave.py:86",
                     it["launches"]["matmul_chain_bf16"],
                     g["bf16"]["max_abs_err"],
                     it["bf16_K8_ns_per_mm"] * B * L * 1e-6,
                     g["bf16"]["plain_ms"], (0.0, 0.0),
                     library_ms=dev["row21_bf16"]["library_ms"]))
    out[-1].update(bound_ms=bb16[0], bound_by=bb16[1])
    for e, kernel, cluster, row in (
            (out[0], "chain_cluster_kernel<1>", ms["chain_cluster"], "row20"),
            (out[1], "chain_cluster_kernel<8>", it["highest_K8_cluster"],
             "row21"),
            (out[2], "chain_mma_kernel<5>", 1, "row21_bf16")):
        e.update(kernel=kernel, cluster=cluster,
                 oracle_ms=mean(t[row]["old_ms"]),
                 ms_in_turns=mean(t[row]["new_ms"]),
                 device_ms=dev[row]["ms"],
                 oracle_device_ms=dev[row]["oracle_ms"])
    nm, bb, k = mb["n"], mb["bb"], mb["k"]
    bounds = [_bound(*_micro_work(v, nm, bb, k)) for v in mb["results"]]
    mdev, mt = dev["row18"], c["micro_timing"]["turns"]
    micro = entry(
        "blocked_microbench", "vch_tpu_torch/csrc/micro_cluster.cu",
        "scripts/diag_blocked_microbench.py:100",
        mb["launches"]["blocked_microbench"],
        max(m["max_abs_err"] for m in g["microbench"].values()),
        sum(r["us_per_op"] * k * 1e-3 for r in mb["results"].values()),
        sum(m["plain_ms"] for m in g["microbench"].values()), (0.0, 0.0),
        library_ms=sum(d["library_ms"] for d in mdev.values()))
    micro.update(bound_ms=sum(b for b, _ in bounds),
                 bound_by=max(bounds)[1],
                 kernel=f"micro_cluster_kernel<VAR, {bb}>",
                 cluster=mb["cluster"],
                 oracle_ms=sum(mean(r["old_ms"]) for r in mt.values()),
                 ms_in_turns=sum(mean(r["new_ms"]) for r in mt.values()),
                 device_ms=sum(d["ms"] for d in mdev.values()),
                 oracle_device_ms=sum(d["oracle_ms"] for d in mdev.values()))
    out.append(micro)
    wn, wt = wh["n"], c["while_timing"]
    wle = entry(
        "while_probe", "vch_tpu_torch/csrc/while_fused.cu",
        "scripts/probe_pallas_while.py:67",
        wh["launches"]["while_probe"], wh["max_abs_err_vs_plain"], wh["ms"],
        wh["plain_ms"], _while_work(wh["B"], wn, wh["ns"]))
    wle.update(kernel="while_fused_kernel<17>", oracle=f"{src} while_kernel",
               oracle_ms=mean(wt["old_ms"]), ms_in_turns=mean(wt["new_ms"]),
               device_ms=dev["row19"]["ms"],
               oracle_device_ms=dev["row19"]["oracle_ms"])
    out.append(wle)
    return out


def _bench_sweep(cfg, B, materialize=True):
    """bench.py's (b3, kappa) linspace sweep tiled to B (bench.py:108-118)."""
    from vch_tpu_torch.parallel.batch import sweep_2d, tile_batch
    sc = sweep_2d(cfg, b3_values=np.linspace(5e-5, 2e-4, max(1, B // 4)),
                  kappa_values=np.linspace(5e-5, 2e-4, 4)[: max(1, min(4, B))],
                  materialize_phi_Q=materialize)
    return tile_batch(sc, B)


class EntryTimer:
    """A solver entry wrapped in CUDA events: each call's batch (the
    leading axis of its argument `batch_at`; 1 for an (n, m) field), its
    start and end events on the current stream and, for a march, its
    Newton counts (B,). Keeps no output field, so it adds nothing to a
    peak-memory reading."""

    def __init__(self, torch, fn, newton_at=None, batch_at=1):
        self.torch, self.fn, self.newton_at = torch, fn, newton_at
        self.batch_at = batch_at
        self.calls = []

    def __call__(self, *args, **kw):
        ev = lambda: self.torch.cuda.Event(enable_timing=True)
        start, end = ev(), ev()
        start.record()
        out = self.fn(*args, **kw)
        end.record()
        ns = None if self.newton_at is None else out[self.newton_at]
        t = args[self.batch_at]
        self.calls.append((1 if t.dim() == 2 else t.shape[0], start, end,
                           ns))
        return out

    def clear(self):
        self.calls = []

    def summary(self):
        """Launches and device ms in all, and by batch: launches, ms in all
        and per launch, Newton solves in all (a march)."""
        self.torch.cuda.synchronize()
        by = {}
        for B, start, end, ns in self.calls:
            d = by.setdefault(B, dict(launches=0, ms=0.0, newton=0))
            d["launches"] += 1
            d["ms"] += start.elapsed_time(end)
            if ns is not None:
                d["newton"] += int(ns.sum())
        for d in by.values():
            d["ms_per_launch"] = d["ms"] / d["launches"]
        return dict(launches=len(self.calls),
                    ms=sum(d["ms"] for d in by.values()), by_batch=by)


def pgd_run(torch, device, prob, sc, iters, before_timed=None):
    """A main path: one warm-up PGD iteration, then `iters` timed ones with
    every kernel launch count reset to 0 just before and read just after
    (before_timed, if given, runs just before too). The results stay on
    the card (host_results=False, as bench.py times vch_tpu): the default
    download of u, r and phi would add ~1 s at config 4's width."""
    from vch_tpu_torch.ops import march as km

    t0 = time.perf_counter()
    prob.run(sc, max_iter=1, verbose=False, host_results=False)  # warm-up
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(device)
    prob.straggler_rounds = 0
    if before_timed is not None:
        before_timed()
    km.reset_launches()                                 # the main path's run
    t0 = time.perf_counter()
    out = prob.run(sc, max_iter=iters, verbose=False, host_results=False)
    elapsed = time.perf_counter() - t0
    launches = km.launch_counts()
    B = sc.batch
    ch = out["cost_history"]
    cfg = prob.solver.config
    return dict(B=B, n=cfg.Nx if hasattr(cfg, "Nx") else cfg.N,
                M=prob.solver.M, iters=iters,
                problem=type(prob).__name__, elapsed_s=elapsed,
                warmup_s=warm_s, scenario_iters_per_s=B * iters / elapsed,
                newton_solves=out["newton_solves"],
                newton_solves_per_s=out["newton_solves"] / elapsed,
                timers=out["timers"], straggler_rounds=prob.straggler_rounds,
                peak_bytes=torch.cuda.max_memory_allocated(device),
                launches=launches,
                mean_cost_before=float(ch[0].mean()),
                mean_cost_after=float(ch[-1].mean()),
                mean_cost_history=ch.mean(axis=1).tolist(),
                finite=bool(np.isfinite(ch).all()))


def check_main_path(res, launched, idle):
    """Finite, falling mean cost; every kernel of the path launched, and
    the kernels of the other paths not."""
    fails = [f"{k} never launched" for k in launched
             if res["launches"][k] <= 0]
    fails += [f"{k} launched {res['launches'][k]} times" for k in idle
              if res["launches"][k] != 0]
    if not res["finite"] or not res["mean_cost_after"] < res["mean_cost_before"]:
        fails.append("did not descend")
    if fails:
        raise RuntimeError(f"{res['problem']} n={res['n']} B={res['B']}: "
                           + "; ".join(fails) + f" | {res}")


def _config(n, T=1.0, **kw):
    from vch_tpu_torch.config import ForwardSolverConfig2D
    return ForwardSolverConfig2D(Nx=n, Ny=n, T=T, dtype="float32",
                                 newton_tol=2e-4, **kw)


def _traj_bytes(cfg, B, M):
    """S: one trajectory-shaped float32 array B (M+1) (Nx+1) (Ny+1)."""
    return B * (M + 1) * (cfg.Nx + 1) * (cfg.Ny + 1) * 4


def peak_multiple(torch, device, cases=((64, 1.0), (128, 1.0), (128, 0.1)),
                  iters=2):
    """Phase 7: peak device memory of BatchedProblem2D.run at config 4's
    grid, for (B, T) cases, over S and over the chooser's estimate."""
    from vch_tpu_torch.parallel.batch import (BatchedProblem2D,
                                              full_memory_estimate_bytes)
    out = []
    for B, T in cases:
        cfg = _config(128, T=T)
        prob = BatchedProblem2D(cfg, device=device)
        sc = _bench_sweep(cfg, B)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        prob.run(sc, max_iter=iters, verbose=False, host_results=False)
        peak = torch.cuda.max_memory_allocated(device)
        S = _traj_bytes(cfg, B, prob.solver.M)
        est = full_memory_estimate_bytes(cfg, B)
        out.append(dict(B=B, M=prob.solver.M, iters=iters, peak_bytes=peak,
                        S_bytes=S, peak_over_S=peak / S, estimate_bytes=est,
                        peak_over_estimate=peak / est))
        del prob
    return out


def _cli_run(torch, argv, timers=()):
    """One command of vch_tpu_torch.cli run in this process, as a user runs
    it (`main(argv)`): its standard output captured, every launch count
    set to 0 just before and read just after, its wall seconds between two
    device synchronizations. The problem classes the CLI builds are
    swapped for subclasses that keep the problem and its result, and the
    kernel entries named in `timers` ((entry, EntryTimer keywords) pairs)
    are wrapped in CUDA events; both are put back after."""
    import contextlib
    import io
    from vch_tpu_torch import cli
    from vch_tpu_torch.control import problems
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.parallel import batch

    made = []

    class Control2D(problems.ControlProblem2D):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

        def optimize(self, *a, **k):
            self.result = super().optimize(*a, **k)
            return self.result

    class Batched2D(batch.BatchedProblem2D):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

        def run(self, *a, **k):
            self.result = super().run(*a, **k)
            return self.result

    saved = (problems.ControlProblem2D, batch.BatchedProblem2D, km.KERNELS)
    events = {k: EntryTimer(torch, getattr(km.KERNELS, k), **kw)
              for k, kw in timers}
    out = io.StringIO()
    try:
        problems.ControlProblem2D, batch.BatchedProblem2D = Control2D, Batched2D
        km.KERNELS = km.KERNELS._replace(**events)
        torch.cuda.synchronize()
        km.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in km.launch_counts().items() if v}
    finally:
        problems.ControlProblem2D, batch.BatchedProblem2D, km.KERNELS = saved
    return dict(rc=rc, wall_s=wall, launches=launches, out=out.getvalue(),
                problem=made[-1] if made else None,
                events={k: t.summary() for k, t in events.items()})


def _trials(out):
    """The line-search trials of each PGD iteration, from the CLI's
    `iter k | ... | trials n | ...` lines."""
    return [int(ln.split("| trials")[1].split("|")[0])
            for ln in out.splitlines() if ln.startswith("iter ")
            and "| trials" in ln]


def _time_study(out):
    """The CLI's PhaseTimers report (COMPUTATIONAL TIME STUDY) as
    {phase: seconds}."""
    rows = {}
    for ln in out.splitlines():
        if " s  (" in ln and "calls," in ln:
            name, rest = ln.split(":", 1)
            rows[name.strip()] = float(rest.split(" s")[0])
    return rows


# the CLI's subcommands that run as processes of their own in phase 11,
# each with the seconds it may take
CLI_SUBPROCESSES = (("show-control", 120), ("forward2d", 300),
                    ("optimize1d", 600))


def cli_phase(device=None, name=None, smi=None):
    """Phase 11: the command line, `python -m vch_tpu_torch.cli`, on the
    card with vch_tpu's defaults (newton_tol 1e-6, newton_max_iter 500 in
    2D), in process: `optimize2d` at config 3 (64x64, T = 1, M = 100,
    float32) for 3 PGD iterations with a checkpoint, `sweep2d` at config
    4's width (128x128, T = 1, B = 128: 16 b3 x 8 kappa values) for 3,
    `forward2d` at n = 128, and `optimize2d` at 32x32, T = 0.25, 2
    iterations, float32, with --device cuda and with --device cpu (the
    kernel path against the plain path); then `show-control` on the saved
    control, `forward2d --n 128` and `optimize1d --max-iter 2` as
    processes of their own. One line per command: seconds, launches,
    rates; then the gates. Alone on the card:
    `python -c "import chip_smoke; chip_smoke.cli_phase()"`."""
    import os
    import sys
    import tempfile
    import torch
    from vch_tpu_torch.config import load_params
    from vch_tpu_torch.utils.checkpoint import load_checkpoint

    if device is None:
        device, name, smi = (torch.device("cuda", 0),
                             torch.cuda.get_device_name(0), _smi())
    fails = []
    with tempfile.TemporaryDirectory(prefix="vch_cli_") as tmp:
        pre = os.path.join(tmp, "c3_")
        ck = os.path.join(tmp, "c3.npz")
        # config 3 through optimize2d, its three kernels under CUDA events
        r3 = _cli_run(torch, ["optimize2d", "--n", "64", "--T", "1",
                              "--max-iter", "3", "--no-artifacts",
                              "--checkpoint", ck, "--out-prefix", pre],
                      timers=(("schur_spectral", dict(batch_at=7)),
                              ("adjoint_spectral", dict(batch_at=7)),
                              ("march", dict(newton_at=1))))
        prob, res = r3["problem"], r3["problem"].result
        ch = np.asarray(res.cost_history)
        trials = _trials(r3["out"])
        M = prob.solver.M
        schur = r3["launches"].get("bicgstab_schur_spectral", 0)
        state, meta = load_checkpoint(ck)
        saved_u = np.load(pre + "optimal_control.npy")
        params = load_params(pre + "last_run_config_2d.json", two_d=True)
        c3 = dict(
            command="optimize2d --n 64 --T 1 --max-iter 3 --no-artifacts "
                    "--checkpoint", n=64, M=M, iters=res.iterations,
            wall_s=r3["wall_s"],
            pgd_iters_per_s=res.iterations / res.timers["total_optimization"],
            time_study=_time_study(r3["out"]), launches=r3["launches"],
            kernel_ms=r3["events"], trials=trials,
            newton_solves_baseline=schur,
            newton_solves_per_step_baseline=schur / M,
            newton_solves_all=prob.newton_solves,
            cost_history=ch.tolist(),
            natural_line=[ln for ln in r3["out"].splitlines()
                          if ln.startswith("Natural evolution")],
            device=str(prob.phi_hist0.device))
        expect = {"bicgstab_schur_spectral": schur,
                  "bicgstab_adjoint_spectral": M * res.iterations,
                  "march_fused_2d": sum(trials) + 1}
        if schur <= 0 or r3["launches"] != expect:
            fails.append(f"optimize2d launches {r3['launches']}, expected "
                         f"{expect}")
        if r3["rc"] != 0 or not np.isfinite(ch).all() \
                or np.any(np.diff(ch) > 0):
            fails.append(f"optimize2d costs {ch.tolist()} (rc {r3['rc']})")
        if not np.array_equal(state["u"], saved_u) \
                or meta.get("iterations") != res.iterations:
            fails.append("optimize2d checkpoint differs from the saved "
                         "control")
        fs = params.forward_solver
        if (fs.Nx, fs.Ny, fs.T, fs.dtype, params.last_run_iterations) != (
                64, 64, 1.0, "float32", res.iterations):
            fails.append(f"optimize2d config JSON reloads as {params}")
        if not c3["natural_line"]:
            fails.append("optimize2d printed no Natural evolution line")
        if not c3["device"].startswith("cuda"):
            fails.append(f"optimize2d ran on {c3['device']}")
        _log(11, "cli " + json.dumps(c3) + f" | {name} | {smi}")
        del prob, res, state, r3

        # config 4's width through sweep2d
        b3s = ",".join(repr(float(v)) for v in np.linspace(5e-5, 2e-4, 16))
        kss = ",".join(repr(float(v)) for v in np.linspace(5e-5, 2e-4, 8))
        r4 = _cli_run(torch, ["sweep2d", "--n", "128", "--b3", b3s,
                              "--kappa", kss, "--max-iter", "3",
                              "--no-artifacts"])
        out4 = r4["problem"].result
        ch4 = np.asarray(out4["cost_history"])
        tot4 = out4["timers"]["total_optimization"]
        c4 = dict(command="sweep2d --n 128 --b3 <16> --kappa <8> "
                          "--max-iter 3 --no-artifacts", n=128,
                  B=ch4.shape[1], iters=ch4.shape[0] - 1, wall_s=r4["wall_s"],
                  scenario_iters_per_s=ch4.shape[1] * (ch4.shape[0] - 1)
                  / tot4, timers=out4["timers"],
                  newton_solves=int(out4["newton_solves"]),
                  launches=r4["launches"],
                  mean_cost_history=ch4.mean(axis=1).tolist(),
                  members_falling=int((ch4[-1] < ch4[0]).sum()),
                  device=str(r4["problem"].device))
        if r4["rc"] != 0 or ch4.shape[1] != 128 \
                or not np.isfinite(ch4).all() or c4["members_falling"] != 128:
            fails.append(f"sweep2d: {c4['members_falling']} of {ch4.shape[1]}"
                         f" members' costs fell (rc {r4['rc']})")
        if set(r4["launches"]) != {"march_fused_2d", "adjoint_fused_2d"}:
            fails.append(f"sweep2d launched {r4['launches']}")
        _log(11, "cli " + json.dumps(c4) + f" | {name} | {smi}")
        del out4, r4

        # forward2d at n = 128: the per-step marcher on row 8 alone
        rf = _cli_run(torch, ["forward2d", "--n", "128", "--no-artifacts"])
        cf = dict(command="forward2d --n 128 --no-artifacts",
                  wall_s=rf["wall_s"], launches=rf["launches"],
                  printed=rf["out"].strip())
        if rf["rc"] != 0 or set(rf["launches"]) != {
                "bicgstab_schur_spectral"}:
            fails.append(f"forward2d launched {rf['launches']}")
        _log(11, "cli " + json.dumps(cf) + f" | {name} | {smi}")

        # the kernel path against the plain path at 32x32
        pair = {}
        for dev in ("cuda", "cpu"):
            r = _cli_run(torch, ["optimize2d", "--n", "32", "--T", "0.25",
                                 "--max-iter", "2", "--dtype", "float32",
                                 "--no-artifacts", "--device", dev,
                                 "--out-prefix",
                                 os.path.join(tmp, f"p32_{dev}_")])
            pair[dev] = (np.asarray(r["problem"].result.cost_history),
                         r["wall_s"], r["launches"], r["rc"])
        (kc, kt, kl, krc), (pc, pt, pl, prc) = pair["cuda"], pair["cpu"]
        rel = float((np.abs(kc - pc) / np.abs(pc)).max())
        cp = dict(command="optimize2d --n 32 --T 0.25 --max-iter 2 "
                          "--dtype float32 --no-artifacts --device cuda|cpu",
                  rel_cost=rel, cost_history_cuda=kc.tolist(),
                  cost_history_cpu=pc.tolist(), wall_s_cuda=kt,
                  wall_s_cpu=pt, launches_cuda=kl, launches_cpu=pl)
        if krc or prc or not np.isfinite(kc).all() or rel > 2e-4 or pl \
                or set(kl) != {"bicgstab_schur_spectral",
                               "bicgstab_adjoint_spectral", "march_fused_2d"}:
            fails.append(f"optimize2d 32x32 cuda against cpu: {cp}")
        _log(11, "cli " + json.dumps(cp) + f" | {name} | {smi}")

        # as processes of their own, as a user runs them
        root = os.path.dirname(os.path.abspath(__file__))
        argvs = {"show-control": ["show-control", pre + "optimal_control.npy"],
                 "forward2d": ["forward2d", "--n", "128", "--no-artifacts"],
                 "optimize1d": ["optimize1d", "--max-iter", "2",
                                "--no-artifacts", "--out-prefix",
                                os.path.join(tmp, "c1_")]}
        for cmd, limit in CLI_SUBPROCESSES:
            t0 = time.perf_counter()
            p = subprocess.run([sys.executable, "-m", "vch_tpu_torch.cli"]
                               + argvs[cmd], cwd=root, capture_output=True,
                               text=True, timeout=limit)
            lines = p.stdout.strip().splitlines()
            cs = dict(command="python -m vch_tpu_torch.cli "
                              + " ".join(a if not a.startswith(tmp) else
                                         os.path.basename(a)
                                         for a in argvs[cmd]),
                      rc=p.returncode, wall_s=time.perf_counter() - t0,
                      launches="not read (a process of its own)",
                      first_line=lines[0] if lines else "",
                      cost_lines=[ln for ln in lines
                                  if ln.startswith("iter ")])
            if p.returncode != 0:
                fails.append(f"{cs['command']} exited {p.returncode}: "
                             f"{p.stderr[-2000:]}")
            _log(11, "cli " + json.dumps(cs) + f" | {name} | {smi}")
    if fails:
        raise RuntimeError("phase 11 cli: " + "; ".join(fails))


# Phase 12: the batch runner's side paths (vch_tpu/parallel/batch.py:
# 168-1006). At the headline, each search mode beside the plain search
# (straggler_batch "auto", the fused route's default): the speculative
# search, a numeric straggler_batch that is no multiple of the blocked
# kernels' 8 members (its sub-batch trials take the one-member march, row 1)
# and chunks of 128 (the blocked kernels). The sweep is the slices'
# heterogeneous (b3, kappa) grid, 16 x 16 tiled to 512, with alpha_max
# raised as in vch_tpu's tests, so that members backtrack. Its stragglers
# come in pairs (the tiling), and on an H100 every backtracking round of
# its first 3 iterations has 64 members searching, so the numeric size is
# 100 (12 would never engage).
SIDE_MODES = (("plain", {}), ("speculative", {"speculative": True}),
              ("straggler 100", {"straggler_batch": 100}),
              ("chunked 128", {"chunk_size": 128}))
SIDE_COUNTER = {"speculative": "speculative_rounds",
                "straggler 100": "straggler_rounds",
                "chunked 128": "chunk_calls"}
SIDE_ALPHA_MAX = 2000.0
# the gate between a mode's cost history and the plain search's, and
# between a resumed run and an uninterrupted one (relative)
SIDE_REL = 1e-6


def _on_device(torch, device, sc):
    """A ScenarioBatch's arrays as float32 tensors on the card, staged once
    for every run that shares it."""
    t = lambda a: (None if a is None else torch.as_tensor(
        np.asarray(a), dtype=torch.float32, device=device))
    return dataclasses.replace(sc, phi0=t(sc.phi0), phi_T=t(sc.phi_T),
                               phi_Q=t(sc.phi_Q), b1=t(sc.b1), b2=t(sc.b2),
                               b3=t(sc.b3), kappa_spar=t(sc.kappa_spar))


def side_mode_run(torch, prob, sc, iters, start=0, **run_kw):
    """`prewarm`, then one `run` to `iters` (from iteration `start` on a
    resume) with every launch count set to 0 just before and read just
    after: its seconds, rate, counters and launches (a row of the kernel
    table for each entry point), and its result."""
    from vch_tpu_torch.ops import march as km
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prob.prewarm(sc)
    prewarm_s = time.perf_counter() - t0
    prob.straggler_rounds = prob.speculative_rounds = prob.chunk_calls = 0
    km.reset_launches()
    t0 = time.perf_counter()
    out = prob.run(sc, max_iter=iters, verbose=False, **run_kw)
    elapsed = time.perf_counter() - t0          # run() ends synchronized
    ch = out["cost_history"]
    done = ch.shape[0] - 1 - start
    return dict(B=sc.batch, iters=done, elapsed_s=elapsed,
                prewarm_s=prewarm_s,
                scenario_iters_per_s=sc.batch * done / elapsed,
                newton_solves=out["newton_solves"],
                ls_trials=int(out["ls_trials"].sum()),
                straggler_rounds=prob.straggler_rounds,
                speculative_rounds=prob.speculative_rounds,
                chunk_calls=prob.chunk_calls,
                launches={k: v for k, v in km.launch_counts().items() if v},
                mean_cost_history=ch.mean(axis=1).tolist(),
                finite=bool(np.isfinite(ch).all())), out


def side_headline(torch, device, iters=3):
    """Phase 12a: the four search modes at 64x64, T = 1, B = 512."""
    from vch_tpu_torch.parallel import batch
    from vch_tpu_torch.parallel.batch import (BatchedProblem2D, sweep_2d,
                                              tile_batch)
    cfg = _config(64)
    sc = _on_device(torch, device, tile_batch(sweep_2d(
        cfg, b3_values=np.logspace(-6, 0, 16),
        kappa_values=np.logspace(-6, -1, 16)), 512))
    res, outs = {}, {}
    for mode, kw in SIDE_MODES:
        prob = BatchedProblem2D(cfg, alpha_max=SIDE_ALPHA_MAX, device=device,
                                **kw)
        # the plain search's count of searching members in each
        # backtracking round, read where it picks the round's bucket
        searching = []
        if mode == "plain":
            bucket = batch.straggler_bucket
            batch.straggler_bucket = lambda n, B: (searching.append(n),
                                                   bucket(n, B))[1]
        try:
            res[mode], out = side_mode_run(torch, prob, sc, iters,
                                           host_results=False)
        finally:
            if mode == "plain":
                batch.straggler_bucket = bucket
                res[mode]["searching_per_round"] = [
                    n for n in searching if n < 512]
        outs[mode] = {k: out[k] for k in ("cost_history", "ls_trials",
                                          "newton_solves")}
        del prob, out
    plain = outs["plain"]
    for mode, o in outs.items():
        c0, c1 = plain["cost_history"], o["cost_history"]
        res[mode].update(
            max_rel_cost_vs_plain=float((np.abs(c1 - c0) / np.abs(c0)).max()),
            ls_trials_equal=bool(np.array_equal(o["ls_trials"],
                                                plain["ls_trials"])),
            newton_vs_plain=o["newton_solves"] - plain["newton_solves"])
    return res


def check_side_headline(res):
    """Phase 12a gates: every mode's trial counts equal the plain search's
    member for member and its cost history is within SIDE_REL of it; each
    mode's counter is above 0; chunks count the plain search's Newton
    solves (sub-batches and packed rounds count their own rows, so they
    differ by construction); the plain search descends on rows 3-4 and the
    numeric sub-batches take row 1."""
    fails = []
    for mode, c in res.items():
        if not (c["finite"] and c["ls_trials_equal"]
                and c["max_rel_cost_vs_plain"] <= SIDE_REL):
            fails.append(f"{mode}: trials equal {c['ls_trials_equal']}, "
                         f"cost {c['max_rel_cost_vs_plain']}")
        if mode in SIDE_COUNTER and c[SIDE_COUNTER[mode]] <= 0:
            fails.append(f"{mode}: {SIDE_COUNTER[mode]} is 0")
    if res["chunked 128"]["newton_vs_plain"] != 0:
        fails.append("chunked 128: Newton solves differ from the plain run")
    p = res["plain"]
    if not p["mean_cost_history"][-1] < p["mean_cost_history"][0]:
        fails.append("the plain search did not descend")
    for mode, c in res.items():
        need = ("march_fused_2d_blocked", "adjoint_fused_2d_blocked") + (
            ("march_fused_2d",) if mode.startswith("straggler") else ())
        fails += [f"{mode}: {k} never launched" for k in need
                  if c["launches"].get(k, 0) <= 0]
    if fails:
        raise RuntimeError("phase 12a: " + "; ".join(fails) + f" | {res}")


def _resume_case(torch, prob, sc, tmp, tag, iters=4, at=2):
    """An uninterrupted run of `iters` iterations with metrics, one of `at`
    that checkpoints at its end, and a resume from it to `iters`: their
    cases, the metrics' events, and the resumed run's largest relative
    difference from the uninterrupted one in u and in the cost history."""
    import json
    import os
    from vch_tpu_torch.utils.checkpoint import host_numpy
    ck, mp = os.path.join(tmp, f"{tag}.npz"), os.path.join(tmp,
                                                           f"{tag}.jsonl")
    full_c, full = side_mode_run(torch, prob, sc, iters, metrics_path=mp)
    t0 = time.perf_counter()
    prob.run(sc, max_iter=at, verbose=False, checkpoint_path=ck,
             checkpoint_every=at, host_results=False)
    ckpt_run_s = time.perf_counter() - t0
    res_c, res = side_mode_run(torch, prob, sc, iters, start=at,
                               checkpoint_path=ck, resume=True)
    with open(mp) as f:
        events = [json.loads(line)["event"] for line in f]
    rel = lambda a, b: float(np.abs(host_numpy(a) - host_numpy(b)).max()
                             / max(np.abs(host_numpy(b)).max(), 1e-30))
    return dict(full=full_c, resumed=res_c, checkpoint_run_s=ckpt_run_s,
                checkpoint_bytes=os.path.getsize(ck),
                pgd_iter_records=events.count("pgd_iter"),
                run_done_records=events.count("run_done"),
                rel_u=rel(res["u"], full["u"]),
                rel_cost=rel(res["cost_history"], full["cost_history"]),
                phi_type=type(res["phi"]).__name__,
                phi_on_host=all(isinstance(a, np.ndarray)
                                for a in (res["phi"] if isinstance(
                                    res["phi"], tuple) else (res["phi"],))))


def side_config4(torch, device, tmp):
    """Phase 12b: config 4 (128x128, T = 1, B = 128, the one-member
    kernels): checkpoint at 2, resume to 4, against an uninterrupted 4 with
    metrics; then trial_memory_analysis on the host batch, its peak over S
    and over the chooser's estimate."""
    from vch_tpu_torch.parallel.batch import (BatchedProblem2D,
                                              full_memory_estimate_bytes)
    cfg = _config(128)
    host = _bench_sweep(cfg, 128)
    prob = BatchedProblem2D(cfg, device=device)
    c = _resume_case(torch, prob, _on_device(torch, device, host), tmp, "c4")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tma = prob.trial_memory_analysis(host)
    S = _traj_bytes(cfg, 128, prob.solver.M)
    est = full_memory_estimate_bytes(cfg, 128)
    c.update(trial_memory=tma, trial_memory_s=time.perf_counter() - t0,
             S_bytes=S, estimate_bytes=est,
             trial_peak_over_S=tma["peak_memory_in_bytes"] / S,
             trial_peak_over_estimate=tma["peak_memory_in_bytes"] / est)
    return c


def side_lowmem(torch, device, tmp, B=8):
    """Phase 12c: the low-memory arm at config 5's grid (256x256, T = 1,
    K = 10, procedural ramp targets), B cut to 8: checkpoint at 2, resume
    to 4, against an uninterrupted 4 (segment kernels, LowMemState)."""
    from vch_tpu_torch.parallel.batch import LowMemBatchedProblem2D
    cfg = _config(256)
    prob = LowMemBatchedProblem2D(cfg, K=10, device=device)
    sc = _on_device(torch, device, _bench_sweep(cfg, B, materialize=False))
    return _resume_case(torch, prob, sc, tmp, "low")


def check_side_resume(c, row_kernels, tag):
    """Phases 12b-c gates: the resumed run within SIDE_REL of the
    uninterrupted one in u and cost, 4 pgd_iter and 1 run_done records,
    results on the host, the path's kernels launched in both runs."""
    fails = []
    if not (c["rel_u"] <= SIDE_REL and c["rel_cost"] <= SIDE_REL):
        fails.append(f"resume differs: u {c['rel_u']}, cost {c['rel_cost']}")
    if (c["pgd_iter_records"], c["run_done_records"]) != (4, 1):
        fails.append(f"metrics: {c['pgd_iter_records']} pgd_iter, "
                     f"{c['run_done_records']} run_done")
    if not (c["phi_on_host"] and c["full"]["finite"]
            and c["resumed"]["finite"]):
        fails.append("results not finite numpy arrays on the host")
    for run in ("full", "resumed"):
        fails += [f"{run}: {k} never launched" for k in row_kernels
                  if c[run]["launches"].get(k, 0) <= 0]
    tma = c.get("trial_memory")
    if tma is not None and not (
            0 < tma["peak_memory_in_bytes"] <= c["estimate_bytes"]):
        fails.append(f"trial peak {tma['peak_memory_in_bytes']} B not in "
                     f"(0, the estimate {c['estimate_bytes']} B]")
    if fails:
        raise RuntimeError(f"phase {tag}: " + "; ".join(fails) + f" | {c}")


def side_paths_phase(device=None, name=None, smi=None):
    """Phase 12, each part logged, then gated. Alone on the card:
    `python -c "import chip_smoke; chip_smoke.side_paths_phase()"`.
    Returns the launches of rows 1-6 in its main paths' runs."""
    import tempfile
    import torch
    if device is None:
        device, name, smi = (torch.device("cuda", 0),
                             torch.cuda.get_device_name(0), _smi())
    t0 = time.perf_counter()
    head = side_headline(torch, device)
    for mode, c in head.items():
        _log("12a", f"{mode} " + json.dumps(c) + f" | {name} | {smi}")
    check_side_headline(head)
    with tempfile.TemporaryDirectory(prefix="vch_side_") as tmp:
        c4 = side_config4(torch, device, tmp)
        _log("12b", json.dumps(c4) + f" | {name} | {smi}")
        check_side_resume(c4, ("march_fused_2d", "adjoint_fused_2d"), "12b")
        low = side_lowmem(torch, device, tmp)
        _log("12c", json.dumps(low) + f" | {name} | {smi}")
        check_side_resume(low, ("march_fused_2d_segment",
                                "adjoint_fused_2d_segment"), "12c")
    launches = {}
    for runs in ([c for c in head.values()],
                 [c4["full"], c4["resumed"], low["full"], low["resumed"]]):
        for c in runs:
            for k, v in c["launches"].items():
                launches[k] = launches.get(k, 0) + v
    _log(12, f"{time.perf_counter() - t0:.1f} s; launches in its runs "
         + json.dumps(launches))
    return launches


# Phase 13: the multi-device paths (vch_tpu/parallel/mesh.py, spatial.py,
# shard_fused) on torch.distributed, world size 1 on NCCL: one card, so no
# halo crosses ranks and no scaling is measured. T of (b) at 256 x 256, cut
# from 1 so that the phase fits its ~90 s (the grid-sharded float32 march
# took 1.07 s for 10 steps there, the float64 twin 0.31 s).
MESH_T_GRID = 0.25
# the gate between two float32 paths' costs (phase 11's, the CLI's)
MESH_REL = 2e-4


def _sync_s(torch, fn):
    """(seconds between two device synchronizations, fn())."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def mesh_scenario(torch, device, iters=2):
    """13a: config 4 (128x128, T = 1, B = 128) through
    BatchedProblem2D(use_mesh=True) against the same problem without a
    mesh, `iters` PGD iterations each (phases 4 and 12 built and warmed
    every kernel). The mesh problem runs twice: the process's first mesh
    run pays a one-off cost of the mesh's first use (`mesh_s_first`), so
    the rate is read from the second; its launches, from 0 just before it
    to just after."""
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.parallel.batch import BatchedProblem2D
    cfg = _config(128)
    sc = _on_device(torch, device, _bench_sweep(cfg, 128))
    plain = BatchedProblem2D(cfg, device=device)
    s0, ref = _sync_s(torch, lambda: plain.run(
        sc, max_iter=iters, verbose=False, host_results=False))
    prob = BatchedProblem2D(cfg, device=device, use_mesh=True)
    s_first, _ = _sync_s(torch, lambda: prob.run(
        sc, max_iter=iters, verbose=False, host_results=False))
    km.reset_launches()
    s1, out = _sync_s(torch, lambda: prob.run(
        sc, max_iter=iters, verbose=False, host_results=False))
    launches = km.launch_counts()
    same = (np.array_equal(out["cost_history"], ref["cost_history"])
            and np.array_equal(out["ls_trials"], ref["ls_trials"])
            and out["newton_solves"] == ref["newton_solves"]
            and torch.equal(out["u"], ref["u"])
            and torch.equal(out["phi"], ref["phi"]))
    return dict(n=cfg.Nx + 1, B=sc.batch, M=prob.solver.M, iters=iters,
                mesh=dict(dims=list(prob.mesh.mesh_dim_names),
                          size=prob.mesh.size(), backend=str(
                              torch.distributed.get_backend())),
                fused=prob._use_fused_march, bit_equal=bool(same),
                mesh_s=s1, mesh_s_first=s_first, plain_s=s0,
                scenario_iters_per_s=sc.batch * iters / s1,
                scenario_iters_per_s_plain=sc.batch * iters / s0,
                newton_solves=out["newton_solves"],
                ls_trials=int(out["ls_trials"].sum()),
                mean_cost_history=out["cost_history"].mean(axis=1).tolist(),
                launches={k: v for k, v in launches.items() if v})


def check_mesh_scenario(c):
    fails = []
    if not c["bit_equal"]:
        fails.append("the mesh run differs from the unsharded run")
    if set(c["launches"]) != {"march_fused_2d", "adjoint_fused_2d"}:
        fails.append(f"launched {c['launches']}")
    h = c["mean_cost_history"]
    if not np.isfinite(h).all() or not h[-1] < h[0]:
        fails.append("did not descend")
    if fails:
        raise RuntimeError("phase 13a: " + "; ".join(fails) + f" | {c}")


def mesh_grid_solvers(torch, device):
    """13b: GridShardedForward2D and GridShardedAdjoint2D at config 5's
    width (256 x 256, Nx = Ny = 255), T = MESH_T_GRID, float32, on a (1,)
    "gx" mesh, against a float64 twin of the same path and against the
    unsharded ForwardSolver2D / AdjointSolver2D on the card; the adjoint of
    all three on the float64 trajectory. Launches over the grid-sharded
    runs (none: plain PyTorch and collectives); collectives per Newton
    solve (forward) and per step (adjoint)."""
    from vch_tpu_torch.models.adjoint2d import AdjointSolver2D
    from vch_tpu_torch.models.forward2d import ForwardSolver2D
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.parallel.mesh import _world_mesh
    from vch_tpu_torch.parallel.spatial import (GridShardedAdjoint2D,
                                                GridShardedForward2D)
    cfg32 = _config(255, T=MESH_T_GRID)
    cfg64 = dataclasses.replace(cfg32, dtype="float64")
    mesh = _world_mesh(device, (1,), ("gx",))
    f32 = GridShardedForward2D(cfg32, mesh=mesh)
    f64 = GridShardedForward2D(cfg64, mesh=mesh)
    a32 = GridShardedAdjoint2D(cfg32, mesh=mesh)
    a64 = GridShardedAdjoint2D(cfg64, mesh=mesh)
    km.reset_launches()
    s32, (phi32, _, t) = _sync_s(torch, f32.simulate)
    s64, (phi64, _, _) = _sync_s(torch, f64.simulate)
    x = np.linspace(0.0, cfg32.Lx, cfg32.Nx + 1)
    phi_T = 0.5 * np.cos(np.pi * x)[:, None] * np.ones(cfg32.Ny + 1)[None]
    traj = phi64.cpu().numpy()
    sa32, (_, _, r32) = _sync_s(torch, lambda: a32.run(
        traj, t, 5.0, 10.0, None, phi_T))
    sa64, (_, _, r64) = _sync_s(torch, lambda: a64.run(
        traj, t, 5.0, 10.0, None, phi_T))
    sharded_launches = {k: v for k, v in km.launch_counts().items() if v}
    fwd_counts = dict(f32.comm.counts)
    un = ForwardSolver2D(cfg32, device=device)
    su, (phiu, _, _) = _sync_s(torch, un.simulate)
    sau, (_, _, ru) = _sync_s(torch, lambda: AdjointSolver2D(
        cfg32, device=device).run(traj, t, 5.0, 10.0, None, phi_T))
    d = lambda a, b: float((a.double() - b.double()).abs().max())
    scale = float(r64.abs().max())
    ns = f32.last_stats.newton_solves
    M = f32.M
    return dict(
        n=cfg32.Nx + 1, M=M, T=cfg32.T,
        newton_solves_f32=ns, newton_solves_f64=f64.last_stats.newton_solves,
        newton_solves_unsharded=un.last_stats.newton_solves,
        max_abs_dphi_vs_f64=d(phi32, phi64),
        max_abs_dphi_unsharded_vs_f64=d(phiu, phi64),
        max_abs_dphi_vs_unsharded=d(phi32, phiu),
        rel_r_vs_f64=d(r32, r64) / scale,
        rel_r_unsharded_vs_f64=d(ru, r64) / scale,
        forward_s=s32, forward_s_f64=s64, forward_s_unsharded=su,
        adjoint_s=sa32, adjoint_s_f64=sa64, adjoint_s_unsharded=sau,
        collectives_per_newton_solve={k: v / max(ns, 1)
                                      for k, v in fwd_counts.items()},
        collectives_per_adjoint_step={k: v / M
                                      for k, v in a32.comm.counts.items()},
        launches_sharded=sharded_launches)


def check_mesh_grid_solvers(c):
    fails = []
    if c["launches_sharded"]:
        fails.append(f"the grid-sharded runs launched {c['launches_sharded']}")
    if not c["max_abs_dphi_vs_f64"] <= (
            2 * c["max_abs_dphi_unsharded_vs_f64"] + 1e-5):
        fails.append("forward farther from float64 than the unsharded one")
    if not c["rel_r_vs_f64"] <= 2 * c["rel_r_unsharded_vs_f64"] + 1e-6:
        fails.append("adjoint farther from float64 than the unsharded one")
    if min(c["newton_solves_f32"], c["newton_solves_f64"]) <= 0:
        fails.append("no Newton solve")
    if fails:
        raise RuntimeError("phase 13b: " + "; ".join(fails) + f" | {c}")


def mesh_grid_problem(torch, device, iters=2):
    """13c: GridShardedProblem2D.optimize at 128 x 128, T = 1, float32, against ControlProblem2D's plain path on the card (its
    solvers' entries the plain versions, the baseline re-marched on them):
    trials equal, costs within MESH_REL."""
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.parallel.spatial import GridShardedProblem2D
    cfg = _config(127)
    km.reset_launches()
    gp = GridShardedProblem2D(cfg, device=device)
    sg, res = _sync_s(torch, lambda: gp.optimize(max_iter=iters,
                                                 verbose=False))
    grid_launches = {k: v for k, v in km.launch_counts().items() if v}
    prob = _control_problem(device, cfg)
    prob.solver.entries = prob.adjoint.entries = km.PLAIN
    prob.phi_hist0 = prob.solver.simulate(initial_phi=prob.phi0)[0]
    km.reset_launches()
    sp, ref = _sync_s(torch, lambda: prob.optimize(max_iter=iters,
                                                   verbose=False))
    c0, c1 = np.asarray(ref.cost_history), np.asarray(res.cost_history)
    return dict(n=cfg.Nx + 1, M=gp.fwd.M, T=cfg.T, iters=iters,
                rel_cost=float((np.abs(c1 - c0) / np.abs(c0)).max()),
                cost_history=c1.tolist(), trials=res.ls_trials_per_iter,
                trials_plain=ref.ls_trials_per_iter,
                newton_solves_baseline=gp.newton_solves,
                grid_s=sg, plain_s=sp,
                pgd_iters_per_s=iters / sg,
                collectives=dict(gp.fwd.comm.counts),
                launches_grid=grid_launches,
                launches_plain={k: v for k, v in km.launch_counts().items()
                                if v})


def mesh_combined(torch, device, B=4, iters=1):
    """13d: GridShardedBatchedProblem2D on the (1, 1) combined mesh
    (grid_shards=1) at 128 x 128, T = 1, B = 4, against
    BatchedProblem2D(fused_march=False) (the scan path: rows 8-9 at
    B = 4): trials equal, costs within MESH_REL."""
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.parallel.batch import BatchedProblem2D
    from vch_tpu_torch.parallel.spatial import GridShardedBatchedProblem2D
    cfg = _config(127)
    sc = _bench_sweep(cfg, B)
    km.reset_launches()
    gp = GridShardedBatchedProblem2D(cfg, grid_shards=1, device=device)
    sg, out = _sync_s(torch, lambda: gp.run(sc, max_iter=iters,
                                            verbose=False))
    grid_launches = {k: v for k, v in km.launch_counts().items() if v}
    km.reset_launches()
    sp, ref = _sync_s(torch, lambda: BatchedProblem2D(
        cfg, device=device, fused_march=False).run(sc, max_iter=iters,
                                                   verbose=False))
    c0, c1 = ref["cost_history"], out["cost_history"]
    return dict(n=cfg.Nx + 1, M=gp.fwd.M, T=cfg.T, B=B, iters=iters,
                mesh=list(gp.mesh.shape),
                rel_cost=float((np.abs(c1 - c0) / np.abs(c0)).max()),
                trials=out["ls_trials"].tolist(),
                trials_scan=ref["ls_trials"].tolist(),
                newton_solves=out["newton_solves"],
                newton_solves_scan=ref["newton_solves"],
                grid_s=sg, scan_s=sp,
                scenario_iters_per_s=B * iters / sg,
                launches_grid=grid_launches,
                launches_scan={k: v for k, v in km.launch_counts().items()
                               if v})


def check_mesh_pair(c, tag, plain_key, launch_key):
    fails = []
    if c["launches_grid"]:
        fails.append(f"the grid-sharded run launched {c['launches_grid']}")
    if c["trials"] != c[plain_key]:
        fails.append("trials differ")
    if not np.isfinite(c["rel_cost"]) or c["rel_cost"] > MESH_REL:
        fails.append(f"costs {c['rel_cost']} apart")
    if launch_key and not c[launch_key]:
        fails.append(f"{launch_key}: nothing launched")
    if fails:
        raise RuntimeError(f"phase {tag}: " + "; ".join(fails) + f" | {c}")


def mesh_cli(torch, device):
    """13e: the CLI at 32 x 32, T = 0.25, 2 iterations, float32: `sweep2d
    --mesh` and `optimize2d --grid-shard` in this process on the card
    against the same commands with --device cpu, each a process of its own
    (a gloo world of one), their checkpoints' cost histories within
    MESH_REL."""
    import os
    import sys
    import tempfile
    from vch_tpu_torch.utils.checkpoint import load_checkpoint
    cmds = {"sweep2d --mesh": ["sweep2d", "--n", "32", "--mesh"],
            "optimize2d --grid-shard": ["optimize2d", "--n", "32",
                                        "--grid-shard"]}
    common = ["--T", "0.25", "--max-iter", "2", "--dtype", "float32",
              "--no-artifacts"]
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    with tempfile.TemporaryDirectory(prefix="vch_mesh_") as tmp:
        procs = {}
        try:
            for k, argv in cmds.items():
                tag = k.split()[0]
                procs[k] = subprocess.Popen(
                    [sys.executable, "-m", "vch_tpu_torch.cli"] + argv
                    + common + ["--device", "cpu", "--checkpoint",
                                os.path.join(tmp, f"{tag}_cpu.npz"),
                                "--out-prefix",
                                os.path.join(tmp, f"{tag}_cpu_")],
                    cwd=root, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
            for k, argv in cmds.items():
                tag = k.split()[0]
                r = _cli_run(torch, argv + common + [
                    "--checkpoint", os.path.join(tmp, f"{tag}_cuda.npz"),
                    "--out-prefix", os.path.join(tmp, f"{tag}_cuda_")])
                out[k] = dict(rc=r["rc"], wall_s=r["wall_s"],
                              launches=r["launches"])
            for k, p in procs.items():
                text, _ = p.communicate(timeout=300)
                out[k].update(rc_cpu=p.returncode,
                              cpu_tail=text[-1500:] if p.returncode else "")
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for k in cmds:
            tag = k.split()[0]
            ch = {d: np.asarray(load_checkpoint(os.path.join(
                tmp, f"{tag}_{d}.npz"))[0]["cost_history"])
                for d in ("cuda", "cpu")}
            out[k].update(
                rel_cost=float((np.abs(ch["cuda"] - ch["cpu"])
                                / np.abs(ch["cpu"])).max()),
                cost_history_cuda=ch["cuda"].tolist())
    return out


def check_mesh_cli(c):
    fails = []
    for k, r in c.items():
        if r["rc"] or r["rc_cpu"]:
            fails.append(f"{k} exited {r['rc']} / {r['rc_cpu']} "
                         f"{r['cpu_tail']}")
        if not r["rel_cost"] <= MESH_REL:
            fails.append(f"{k} cuda against cpu {r['rel_cost']}")
    if set(c["sweep2d --mesh"]["launches"]) != {"march_fused_2d",
                                                "adjoint_fused_2d"}:
        fails.append(f"sweep2d --mesh launched "
                     f"{c['sweep2d --mesh']['launches']}")
    if c["optimize2d --grid-shard"]["launches"]:
        fails.append("optimize2d --grid-shard launched "
                     f"{c['optimize2d --grid-shard']['launches']}")
    if fails:
        raise RuntimeError("phase 13e: " + "; ".join(fails) + f" | {c}")


def mesh_phase(device=None, name=None, smi=None):
    """Phase 13: the multi-device paths at world size 1 on NCCL, each part
    logged and gated as it ends. The process group is made here (a
    FileStore world of one, parallel/mesh.py initialize_distributed) and
    destroyed at the end; a failure raises through. Alone on the card:
    `python -c "import chip_smoke; chip_smoke.mesh_phase()"`. Returns the
    kernel launches of its runs, by entry."""
    import torch
    import torch.distributed as dist
    from vch_tpu_torch.parallel.mesh import initialize_distributed
    if device is None:
        device, name, smi = (torch.device("cuda", 0),
                             torch.cuda.get_device_name(0), _smi())
    t0 = time.perf_counter()
    made = not dist.is_initialized()
    if made and not initialize_distributed(device="cuda"):
        raise RuntimeError("phase 13: no process group could be made")
    launches = {}

    def add(d):
        for k, v in d.items():
            launches[k] = launches.get(k, 0) + v

    try:
        if (dist.get_backend(), dist.get_world_size()) != ("nccl", 1):
            raise RuntimeError(f"phase 13 needs a world of one on NCCL, has "
                               f"{dist.get_backend()} x "
                               f"{dist.get_world_size()}")
        a = mesh_scenario(torch, device)
        _log("13a", json.dumps(a) + f" | {name} | {smi}")
        check_mesh_scenario(a)
        add(a["launches"])
        b = mesh_grid_solvers(torch, device)
        _log("13b", json.dumps(b) + f" | {name} | {smi}")
        check_mesh_grid_solvers(b)
        c = mesh_grid_problem(torch, device)
        _log("13c", json.dumps(c) + f" | {name} | {smi}")
        check_mesh_pair(c, "13c", "trials_plain", None)
        d = mesh_combined(torch, device)
        _log("13d", json.dumps(d) + f" | {name} | {smi}")
        check_mesh_pair(d, "13d", "trials_scan", "launches_scan")
        add(d["launches_scan"])
        e = mesh_cli(torch, device)
        _log("13e", json.dumps(e) + f" | {name} | {smi}")
        check_mesh_cli(e)
        for r in e.values():
            add(r["launches"])
    finally:
        if made:
            dist.destroy_process_group()
    _log(13, f"{time.perf_counter() - t0:.1f} s; launches in its runs "
         + json.dumps(launches))
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script needs a CUDA card and never runs on "
                         "the CPU")
    import vch_tpu_torch  # noqa: F401  (also pins TF32 off)
    from vch_tpu_torch.ops import _build
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.parallel.batch import (BatchedProblem2D,
                                              FULL_MEMORY_PEAK_PER_S,
                                              MARCH_WORKSPACE_FIELDS,
                                              LowMemBatchedProblem2D,
                                              full_memory_estimate_bytes,
                                              make_batched_problem_2d)

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = _smi()
    _log(0, f"device {name} | torch {torch.__version__} cuda "
            f"{torch.version.cuda} | nvidia-smi: {smi}")

    t0 = time.perf_counter()
    lib = _build.load()
    how = (f"nvcc {_build.build_seconds:.1f} s" if _build.build_seconds
           else "library of these sources already built")
    _log(1, f"build {time.perf_counter() - t0:.1f} s ({how}) | registers/"
            "spill-store bytes per kernel: " + _ptxas_summary(_build.ptxas_log)
         + " | apply2d.cu cluster_apply_kernel<VAR,S>: "
         + _ptxas_named(_build.ptxas_log, "cluster_apply_kernel")
         + " | march2d_blocked.cu march_blocked_kernel<MB,SEG> (8, 4, 2: "
         "the blocked march; <1,0>: the whole march; <1,1>: the segment "
         "march): " + _ptxas_named(_build.ptxas_log, "march_blocked_kernel")
         + " | adjoint2d_cluster.cu adjoint_cluster_kernel<MB,SEG> (8, 4, "
         "2: the blocked sweep; <1,0>: the whole sweep; <1,1>: the segment "
         "sweep): " + _ptxas_named(_build.ptxas_log, "adjoint_cluster_kernel")
         + " | solve2d_cluster.cu schur_solve_cluster_kernel (row 8): "
         + _ptxas_named(_build.ptxas_log, "schur_solve_cluster_kernel")
         + ", solve_cluster_kernel (row 9): "
         + _ptxas_named(_build.ptxas_log, "solve_cluster_kernel")
         + ", adjoint_raw_cluster_kernel (row 11): "
         + _ptxas_named(_build.ptxas_log, "adjoint_raw_cluster_kernel")
         + ", schur_raw_cluster_kernel (rows 10, 12): "
         + _ptxas_named(_build.ptxas_log, "schur_raw_cluster_kernel")
         + ", schur_probe_cluster_kernel<MMONLY> (rows 16, 17): "
         + _ptxas_named(_build.ptxas_log, "schur_probe_cluster_kernel")
         + " | solve2d.cu solve_kernel<VAR> (the cluster kernels' one-CTA "
         "oracles: 0-3 the solves, 4, 5 the probes; all but 3 with "
         "-fmad=false): "
         + _ptxas_named(_build.ptxas_log, "solve_kernel")
         + " | march1d.cu march1d_kernel: "
         + _ptxas_named(_build.ptxas_log, "march1d_kernel")
         + " | chain_cluster.cu chain_cluster_kernel<K> (rows 20, 21 "
         "float32): " + _ptxas_named(_build.ptxas_log, "chain_cluster_kernel")
         + ", chain_mma_kernel<RT> (row 21 bf16): "
         + _ptxas_named(_build.ptxas_log, "chain_mma_kernel")
         + " | micro_cluster.cu micro_cluster_kernel<VAR,BB> (row 18): "
         + _ptxas_named(_build.ptxas_log, "micro_cluster_kernel")
         + " | while_fused.cu while_fused_kernel<KM> (row 19): "
         + _ptxas_named(_build.ptxas_log, "while_fused_kernel")
         + ", its oracle probes.cu while_kernel: "
         + _ptxas_named(_build.ptxas_log, "while_kernel")
         + " | nvcc seconds per object, slowest first: "
         + json.dumps(dict(sorted(_build.object_seconds.items(),
                                  key=lambda kv: -kv[1]))))

    cases = [kernel_case(torch, 65, 4, 0.1, device),
             kernel_case(torch, 129, 2, 0.05, device),
             kernel_case(torch, 129, 8, 1.0, device, reps=1)]
    for c in cases:
        _log(2, json.dumps(c))
    for i, c in enumerate(cases):
        check_kernel_case(c, short=i < 2)
    long = cases[2]
    # row 1 on the cluster kernel against its one-CTA oracle, bit for bit
    # and in turns, at config 3's and config 4's grids, at B = 1, 8, 128
    # and, past the clusters the card holds at once, at n = 129, B = 256
    row1 = {(n, B): march_timing(torch, device, n, B)
            for n, B in ((65, 1), (65, 8), (65, 128), (129, 1), (129, 8),
                         (129, 128), (129, 256))}
    for c in row1.values():
        _log(2, "row 1 " + json.dumps(c) + f" | {name} | {smi}")
    bad = [k for k, c in row1.items()
           if not (c["cluster_equals_cta"] and c["finite"])]
    if bad:
        raise RuntimeError(f"row 1: the cluster march differs from its "
                           f"one-CTA oracle (or is not finite) at {bad}")
    # row 2 on the cluster sweep against its one-CTA oracle, bit for bit
    # and in turns, at config 3's and config 4's grids; at n = 129, B = 1
    # also on clusters of 8 and 4
    row2 = {(n, B): sweep_timing(torch, device, n, B,
                                 clusters=(8, 4) if (n, B) == (129, 1) else ())
            for n, B in ((65, 1), (129, 1), (129, 8), (129, 128))}
    for c in row2.values():
        _log(2, "row 2 " + json.dumps(c) + f" | {name} | {smi}")
    for c in row2.values():
        check_sweep_timing(c)

    blk8 = blocked_case(torch, 65, 8, 0.1, device, plain_members=8)
    _log("2b", json.dumps(blk8))
    blk512 = blocked_case(torch, 65, 512, 1.0, device, plain_members=8,
                          reps=1)
    _log("2b", json.dumps(blk512) + f" | {name} | {smi}")
    blk64 = blocked_case(torch, 65, 64, 1.0, device, plain_members=8,
                         reps=1)
    _log("2b", json.dumps(blk64) + f" | {name} | {smi}")
    seg = segment_case(torch, device)
    _log("2b", json.dumps(seg))
    seg257 = segment_case(torch, device, n=257, B=2, K=10, T=0.2, reps=1)
    _log("2b", json.dumps(seg257))
    # each batch also on the clusters the SM count alone would give and on
    # a smaller one, where those differ from the launch geometry's
    other = {8: (16, 8), 32: (4, 2)}
    seg_times = {B: segment_timing(torch, device, B=B,
                                   clusters=other.get(B, ()))
                 for B in (1, 8, 32)}
    for c in seg_times.values():
        _log("2b", json.dumps(c) + f" | {name} | {smi}")
    # row 6, the segment sweep, on the cluster kernel against its one-CTA
    # oracle: at n = 65 and at phase 6's batch and its straggler buckets,
    # each also on two other cluster sizes
    prefer = {1: (8, 4), 8: (16, 8), 32: (4, 2)}
    sweep_times = [sweep_segment_timing(torch, device, n=65, B=4, K=5,
                                        reps=3, prefer=(8, 2))]
    sweep_times += [sweep_segment_timing(torch, device, B=B,
                                         prefer=prefer[B])
                    for B in (1, 8, 32)]
    for c in sweep_times:
        _log("2b", "row 6 " + json.dumps(c) + f" | {name} | {smi}")
    for c in sweep_times:
        check_sweep_timing(c)
    sweep32 = sweep_times[-1]
    check_blocked_case(blk8, short=True)
    check_blocked_case(blk512, short=False)
    check_blocked_case(blk64, short=False)
    # fault C2: explicit blocks of 2 and 4
    c2 = block_sizes_case(torch, device)
    _log("2b", "block sizes " + json.dumps(c2) + f" | {name} | {smi}")
    check_block_sizes_case(c2)
    # row 3's cluster rule against the one-member search at the headline's
    # straggler buckets
    rule3 = [blocked_rule_timing(torch, device, B) for B in (128, 256)]
    for c in rule3:
        _log("2b", "row 3 rule " + json.dumps(c) + f" | {name} | {smi}")
    if not all(c["equal"] for c in rule3):
        raise RuntimeError("row 3: the blocked march's bits depend on its "
                           "cluster size")
    check_segment_case(seg, short=True)
    check_segment_case(seg257, short=False)
    for c in seg_times.values():
        if not (c["cluster_equals_cta"]
                and all(o["equal"] for o in c.get("other_clusters", ()))):
            raise RuntimeError(f"segment march n={c['n']} B={c['B']}: the "
                               "cluster kernel differs from the one-CTA "
                               "oracle")

    solves = [solve_case(torch, device, n, B, reps=20 if n == 65 else 5)
              for n in (65, 129, 257) for B in (None, 4)]
    # the scan path's shape at config 4's width: one launch per Newton round
    # (or sweep step) for 128 members, one cluster each
    solves.append(solve_case(torch, device, 129, 128, reps=3))
    for c in solves:
        _log("2c", json.dumps(c))
    for c in solves:
        check_solve_case(c)
    # rows 8-11 on their cluster kernels against their one-CTA
    # oracles: config 3's B = 1 at n = 65 (also on clusters of 8 and 4),
    # the scan path's n = 129, B = 128, and one member at n = 257
    rows = {(k, n, B): cluster_solve_timing(
        torch, device, k, n, B, reps=20 if n == 65 else 5,
        clusters=(8, 4) if n == 65 else ())
        for k in CLUSTER_SOLVES for n, B in ((65, 1), (129, 128), (257, 1))}
    for c in rows.values():
        _log("2c", f"row {c['row']} " + json.dumps(c) + f" | {name} | {smi}")
    for c in rows.values():
        check_cluster_solve_timing(c)

    # (N, B, T, dt, short): n = 129 and 513, 5-step and 100-step marches at
    # B = 8; B = 134 and 270 give two and four members per CTA on 132 SMs,
    # the last CTA not full
    m1d = [(march1d_case(torch, device, N, B, T, dt,
                         reps=1 if T / dt > 50 else 3,
                         cpu_reference=not short), short)
           for N, B, T, dt, short in (
               (128, 8, 0.05, 1e-2, True), (128, 8, 1.0, 1e-2, False),
               (512, 8, 0.01, 2e-3, False), (512, 8, 0.2, 2e-3, False),
               (128, 134, 0.05, 1e-2, True), (512, 270, 0.01, 2e-3, False))]
    for c, _ in m1d:
        _log("2d", json.dumps(c))
    for c, short in m1d:
        check_march1d_case(c, short)
    long1d = m1d[3][0]

    applies = [apply_case(torch, device, n, B, reps=20 if n == 65 else 5)
               for n in (65, 129, 257) for B in (None, 4)]
    bschur = batched_schur_case(torch, device)
    for c in applies + [bschur]:
        _log("2e", json.dumps(c))
    check_apply_cases(applies, bschur)
    op_calls = operator_calls(torch, device)
    _log("2e", "launches of the operators' own calls: " + json.dumps(
        {k: v for k, v in op_calls.items() if v}))
    a65 = applies[0]

    # the probe entry point at the script's default shape and at the scan
    # path's (n = 129, B = 128, 4 trips as krylov_fixed_iters)
    probes = [probe_case(torch, device, 65, 32, 10, every_cluster=True),
              probe_case(torch, device, 129, 128, 4, reps=5)]
    for c in probes:
        _log("2f", json.dumps(c) + f" | {name} | {smi}")
    for c in probes:
        check_probe_case(c)

    chains = chain_probe_case(torch, device)
    _log("2g", json.dumps(chains) + f" | {name} | {smi}")
    check_chain_probe_case(chains)

    sl = slice_case(torch, device, block=0)
    _log(3, json.dumps(sl))
    sl_blk = slice_case(torch, device, block=8)
    _log("3b", json.dumps(sl_blk))
    sl_low = slice_case(torch, device, block=8, lowmem_K=4)
    low_vs_full = float((np.abs(np.asarray(sl_low["cost_history"])
                                - np.asarray(sl_blk["cost_history"]))
                         / np.abs(np.asarray(sl_blk["cost_history"]))).max())
    _log("3b", json.dumps(dict(sl_low, rel_cost_vs_full_memory=low_vs_full)))
    for s, used in ((sl, "march_fused_2d"), (sl_blk, "march_fused_2d_blocked"),
                    (sl_low, "march_fused_2d_segment")):
        if not s["finite"] or s["rel_cost"] > 2e-4 or s["launches"][used] <= 0:
            raise RuntimeError(f"slice kernel vs plain path: {s}")
    if low_vs_full > 2e-4:
        raise RuntimeError(f"low-memory vs full-memory slice: {low_vs_full}")
    ctl = {v: control_slice(torch, device, v) for v in ("spectral", "raw")}
    for c in ctl.values():
        _log("3c", json.dumps(c))
    for c in ctl.values():
        check_control_slice(c)
    sl1d = slice1d_case(torch, device)
    _log("3d", json.dumps(sl1d))
    check_slice1d(sl1d)
    scans = [scan_slice_case(torch, device, variant, lowmem_K)
             for lowmem_K in (None, 5) for variant in ("spectral", "raw")]
    for c in scans:
        _log("3e", json.dumps(c))
    for c in scans:
        check_scan_slice(c)

    per_member = ("march_fused_2d", "adjoint_fused_2d")
    blocked = ("march_fused_2d_blocked", "adjoint_fused_2d_blocked")
    segment = ("march_fused_2d_segment", "adjoint_fused_2d_segment")
    # the one-CTA kernels are the cluster kernels' oracles, which no main
    # path launches
    oracle = ("_march_fused_2d_segment_cta", "_march_fused_2d_cta",
              "_adjoint_fused_2d_segment_cta", "_adjoint_fused_2d_cta") \
        + tuple(o for _, o, _ in CLUSTER_SOLVES.values())
    idle_segment = segment + oracle
    march_1d = ("march_fused_1d",)
    trips_fwd = _config(64).fused_krylov_fixed_iters
    trips_adj = _config(64).adjoint_krylov_fixed_iters

    cfg4 = _config(128)
    prob4, sc4 = BatchedProblem2D(cfg4, device=device), _bench_sweep(cfg4, 128)
    c4 = pgd_run(torch, device, prob4, sc4, iters=3)
    # the march kernel alone at this shape, on the run's initial conditions
    # and a seeded control, with its bound on the measured Newton total
    x4 = {"phi0": torch.as_tensor(sc4.phi0, dtype=torch.float32,
                                  device=device),
          "u": 0.05 * torch.randn(
              (128, prob4.solver.M + 1, 129, 129), device=device,
              generator=torch.Generator(device).manual_seed(0))}
    _, ns4, _ = prob4.solver.march_fused_batch(x4["u"], x4["phi0"])
    c4["march_ms_full_shape"] = time_ms(
        lambda: prob4.solver.march_fused_batch(x4["u"], x4["phi0"]), 1)
    c4["march_newton_full_shape"] = int(ns4.sum())
    c4["march_bound_ms_full_shape"], _ = _bound(*_march_work(
        129, 128, prob4.solver.M, c4["march_newton_full_shape"], trips_fwd))
    g4 = km.launch_geometry(129, 129, 128, device, members=1)
    c4["march_geometry_full_shape"] = dict(
        cluster=g4.cluster, resident_clusters=km.resident_clusters(
            0, 129, 129, g4.cluster, g4.kc, g4.smem_bytes, 1))
    # row 2, the one-member sweep, alone at this shape on the march's
    # history, with its bound
    h4, _, _ = prob4.solver.march_fused_batch(x4["u"], x4["phi0"])
    a4 = (h4, torch.linspace(0.3, 5.0, 128, device=device),
          torch.linspace(13.0, 10.0, 128, device=device),
          torch.zeros_like(h4), 0.1 * x4["phi0"])
    c4["adjoint_ms_full_shape"] = time_ms(
        lambda: prob4.adj.adjoint_fused_batch(*a4), 1)
    c4["adjoint_bound_ms_full_shape"], _ = _bound(*_adjoint_work(
        129, 128, prob4.solver.M, trips_adj))
    # the one-CTA sweep it displaced (now its bit oracle) on the same
    # history, in turns with it
    r4 = prob4.adj.adjoint_fused_batch(*a4)
    prob4.adj.entries = km.KERNELS._replace(adjoint=km._adjoint_fused_2d_cta)
    c4["adjoint_equals_one_cta_full_shape"] = bool(torch.equal(
        r4, prob4.adj.adjoint_fused_batch(*a4)))
    c4["adjoint_one_cta_ms_full_shape"] = time_ms(
        lambda: prob4.adj.adjoint_fused_batch(*a4), 1)
    prob4.adj.entries = km.KERNELS
    c4["adjoint_ms_full_shape_again"] = time_ms(
        lambda: prob4.adj.adjoint_fused_batch(*a4), 1)
    del prob4, x4, ns4, h4, a4, r4
    _log(4, json.dumps(c4) + f" | {name} | {smi}")
    check_main_path(c4, per_member, blocked + idle_segment + march_1d)
    if not c4["adjoint_equals_one_cta_full_shape"]:
        raise RuntimeError("config 4: the cluster sweep differs from its "
                           "one-CTA oracle")

    scan_solves = ("bicgstab_schur_spectral", "bicgstab_adjoint_spectral")
    prob4s, sc4s, c4s = scan_full_width(
        torch, device, fused_mean_cost=c4["mean_cost_history"][1])
    _log("4s", json.dumps(c4s) + f" | {name} | {smi}")
    check_main_path(c4s, scan_solves, per_member + blocked + idle_segment
                    + march_1d + ("bicgstab_schur", "bicgstab_adjoint"))

    cfg64 = _config(64)
    prob5 = make_batched_problem_2d(cfg64, batch=512, device=device)
    if type(prob5) is not BatchedProblem2D:
        raise RuntimeError(f"64x64 B=512 routed to {type(prob5).__name__}")
    # CUDA events around every blocked launch of the timed window
    blk_m = EntryTimer(torch, prob5.solver.entries.march_blocked,
                       newton_at=1)
    blk_a = EntryTimer(torch, prob5.adj.entries.adjoint_blocked)
    prob5.solver.entries = prob5.solver.entries._replace(march_blocked=blk_m)
    prob5.adj.entries = prob5.adj.entries._replace(adjoint_blocked=blk_a)
    c5 = pgd_run(torch, device, prob5, _bench_sweep(cfg64, 512), iters=3,
                 before_timed=lambda: (blk_m.clear(), blk_a.clear()))
    # beside row 4's launches, the one-member sweep at B = 512 on the
    # cluster kernel and on the one-CTA oracle (phase 2b)
    c5.update(blocked_march=blk_m.summary(), blocked_adjoint=blk_a.summary(),
              adjoint_one_member_ms_b512=blk512["adjoint_per_member_ms"],
              adjoint_one_cta_ms_b512=blk512["adjoint_one_cta_ms"],
              adjoint_cluster_ms_b512=blk512["adjoint_blocked_ms"],
              adjoint_bound_ms_b512=blk512["adjoint_bound_ms"])
    _log(5, json.dumps(c5) + f" | {name} | {smi}")
    check_main_path(c5, blocked, per_member + idle_segment + march_1d)

    # the largest limit under which the full-memory estimate does not fit
    # (est6 > 0.75 limit): the low-memory arm must run within it
    cfg256 = _config(256)
    est6 = full_memory_estimate_bytes(cfg256, 32, materialized_phi_Q=False)
    limit6 = int(0.99 * est6 / 0.75)
    route6 = lambda limit: make_batched_problem_2d(
        cfg256, batch=32, materialized_phi_Q=False, hbm_limit_bytes=limit,
        K=10, device=device)
    if type(route6(int(est6 / 0.75) + 1)) is not BatchedProblem2D:
        raise RuntimeError("256x256 B=32 stays on low memory above its "
                           "full-memory estimate")
    prob6 = route6(limit6)
    if not isinstance(prob6, LowMemBatchedProblem2D):
        raise RuntimeError(f"256x256 B=32 routed to {type(prob6).__name__}")
    # CUDA events around every segment launch of the timed iteration
    seg_m = EntryTimer(torch, prob6.solver.entries.march_segment, newton_at=4)
    seg_a = EntryTimer(torch, prob6.adj.entries.adjoint_segment)
    prob6.solver.entries = prob6.solver.entries._replace(march_segment=seg_m)
    prob6.adj.entries = prob6.adj.entries._replace(adjoint_segment=seg_a)
    c6 = pgd_run(torch, device, prob6,
                 _bench_sweep(cfg256, 32, materialize=False), iters=1,
                 before_timed=lambda: (seg_m.clear(), seg_a.clear()))
    S6 = _traj_bytes(cfg256, 32, prob6.solver.M)
    K6 = prob6.pipe.K
    c6.update(K=K6, segments=prob6.pipe.S,
              full_memory_estimate_bytes=est6, limit_bytes=limit6,
              peak_over_S=c6["peak_bytes"] / S6,
              segment_march=seg_m.summary(), segment_adjoint=seg_a.summary())
    m32 = c6["segment_march"]["by_batch"].get(32)
    if m32:
        c6["segment_march_bound_ms_b32"], _ = _bound(*_march_work(
            257, 32, K6, m32["newton"] / m32["launches"], trips_fwd,
            segment=True))
    c6["segment_adjoint_bound_ms_b32"], _ = _bound(*_adjoint_work(
        257, 32, K6, trips_adj, segment=True))
    # beside row 6's launches, the segment sweep at B = 32 on phase 2b's
    # inputs: the one-CTA oracle and the cluster kernel, and its geometry
    c6.update(segment_adjoint_one_cta_ms_b32=sweep32["cta_ms"],
              segment_adjoint_cluster_ms_b32=sweep32["cluster_ms"],
              segment_adjoint_geometry_b32=sweep32["geometry"])
    _log(6, json.dumps(c6) + f" | {name} | {smi}")
    check_main_path(c6, segment, per_member + blocked + march_1d
                    + oracle)
    if c6["peak_bytes"] > limit6:
        raise RuntimeError(f"low-memory peak {c6['peak_bytes']} B exceeds "
                           f"the limit it was routed under, {limit6} B")
    del prob5, prob6

    if lib.vch_workspace_fields(0) != MARCH_WORKSPACE_FIELDS:
        raise RuntimeError("MARCH_WORKSPACE_FIELDS differs from the march "
                           "kernel's workspace")
    mem = peak_multiple(torch, device)
    _log(7, json.dumps(dict(peaks=mem, constant=FULL_MEMORY_PEAK_PER_S,
                            workspace_fields=MARCH_WORKSPACE_FIELDS))
         + f" | {name} | {smi}")
    over = [m for m in mem if m["peak_over_estimate"] > 1.0]
    if over:
        raise RuntimeError(f"measured peak above the chooser's estimate: "
                           f"{over}")

    c3 = config3_run(torch, device)
    # the cluster solves' wrappers at config 3's shape: host microseconds a
    # call (enqueued without a sync, the scalars as the per-step solvers
    # pass them) against the kernel's device microseconds
    c3["solve_per_call"] = [solve_host_cost(torch, device, k)
                            for k in CLUSTER_SOLVES]
    _log(8, json.dumps(c3) + f" | {name} | {smi}")
    check_config3(c3)
    c3r = config3_raw_run(torch, device)
    _log("8r", json.dumps(c3r) + f" | {name} | {smi}")
    check_config3_raw(c3r)

    prob9, sc9 = config2_problem(device)
    if not (prob9._use_fused_march and sc9.batch == 256
            and prob9.solver.fused_march_available(256)):
        raise RuntimeError("config 2 does not take the fused 1D march")
    c9 = pgd_run(torch, device, prob9, sc9, iters=3)
    # the kernel alone at this shape, on the run's initial condition and a
    # seeded control
    x9 = {"phi0": torch.as_tensor(sc9.phi0, dtype=torch.float32,
                                  device=device),
          "u": 0.05 * torch.randn(
              (256, prob9.solver.M + 1, 513), device=device,
              generator=torch.Generator(device).manual_seed(0))}
    c9["march_ms_full_shape"] = time_ms(
        lambda: prob9.solver.march_fused_batch(x9["u"], x9["phi0"]), 1)
    _, ns9, _ = prob9.solver.march_fused_batch(x9["u"], x9["phi0"])
    c9["march_newton_full_shape"] = float(ns9.sum())
    c9["march_bound_ms_full_shape"], _ = _bound(*_march1d_work(
        513, 256, prob9.solver.M, c9["march_newton_full_shape"],
        _config(64).krylov_fixed_iters))
    g9 = km.march1d_launch_geometry(513, 256, device)
    c9["march_geometry_full_shape"] = dict(
        cluster=g9.cluster, members=g9.members, clusters=g9.clusters,
        resident=g9.resident, kc=g9.kc, smem_bytes=g9.smem_bytes)
    # the ring's k rows a stage at this shape: the launch geometry's against
    # 16 and 8, bit-gated against it
    h9 = prob9.solver.march_fused_batch(x9["u"], x9["phi0"])
    kcs, c9["march_ms_by_ring"] = km._M1D_KC, []
    try:
        for kc in (16, 8):
            km._M1D_KC = tuple(k for k in kcs if k <= kc)
            g = km.march1d_launch_geometry(513, 256, device)
            r = prob9.solver.march_fused_batch(x9["u"], x9["phi0"])
            c9["march_ms_by_ring"].append(dict(
                kc=g.kc, bits_equal=all(
                    torch.equal(a, b) for a, b in zip(r, h9)),
                ms=time_ms(lambda: prob9.solver.march_fused_batch(
                    x9["u"], x9["phi0"]), 1)))
    finally:
        km._M1D_KC = kcs
    del h9, r
    if not all(c["bits_equal"] for c in c9["march_ms_by_ring"]):
        raise RuntimeError("config 2: the 1D march's bits depend on its ring")
    c9["entries_are_kernels"] = prob9.solver.entries is km.KERNELS
    _log(9, json.dumps(c9) + f" | {name} | {smi}")
    check_main_path(c9, march_1d, per_member + blocked + idle_segment
                    + tuple(SOLVE_KERNELS) + tuple(APPLY_KERNELS))
    if not c9["entries_are_kernels"]:
        raise RuntimeError("config 2: solver entries are not the kernels")
    del x9, prob9, sc9

    c1 = config1_run(torch, device)
    _log(10, json.dumps(c1) + " | no kernel on this path: the per-step "
         f"marcher and sweep, as in vch_tpu | {name} | {smi}")
    check_config1(c1)
    exact_phases(device, name, smi)
    cli_phase(device, name, smi)
    side = side_paths_phase(device, name, smi)
    mesh = mesh_phase(device, name, smi)
    # the scan path at config 4's width likewise: its baseline march and
    # one sweep under the profiler
    _log("4sp", json.dumps(device_share(
        torch, lambda: prob4s.run(sc4s, max_iter=0, verbose=False,
                                  host_results=False)))
        + f" | {name} | {smi}")
    del prob4s, sc4s
    # the applies on the device alone, last: see apply_device_times
    for c in apply_device_times(torch, device):
        _log("2e-dev", json.dumps(c) + f" | {name} | {smi}")
    solve_dev = cluster_solve_device_times(torch, device)
    _log("2e-dev", "rows 8-12 " + json.dumps(solve_dev)
         + f" | {name} | {smi}")
    probes_dev = probe_device_times(torch, device)
    _log("2e-dev", "rows 16-17 " + json.dumps(probes_dev)
         + f" | {name} | {smi}")
    chains_dev = chain_device_times(torch, device)
    _log("2g-dev", "rows 20-21 " + json.dumps(chains_dev)
         + f" | {name} | {smi}")
    chains_dev["row18"] = micro_device_times(torch, device)
    _log("2g-dev", "row 18 " + json.dumps(chains_dev["row18"])
         + f" | {name} | {smi}")
    chains_dev["row19"] = while_device_times(torch, device)
    _log("2g-dev", "row 19 " + json.dumps(chains_dev["row19"])
         + f" | {name} | {smi}")

    def entry(fn, source, replaces, launches, err, ms, plain_ms, work,
              library_ms=None, shape=None):
        bound_ms, bound_by = _bound(*work)
        # library_ms: no single PyTorch call computes a whole march, sweep
        # or fixed-trip BiCGStab solve; the operator applies carry the time
        # of the same function as torch.matmul calls
        out = {"name": fn, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms}
        if shape:
            out["shape"] = shape
        return out

    mean = lambda v: float(np.mean(v))
    cluster_cu = "vch_tpu_torch/csrc/march2d_blocked.cu"
    sweep_cu = "vch_tpu_torch/csrc/adjoint2d_cluster.cu"
    pm = "vch_tpu/ops/pallas_march.py"
    pk = "vch_tpu/ops/pallas_kernels.py"
    seg_newton = sum(seg257["newton_chain"]) / (seg257["M"] // seg257["K"])
    trips_1d = _config(64).krylov_fixed_iters    # the 1D march's trips
    full4 = "ms, bound_ms: config 4's n=129, B=128, M=100; max_abs_err, " \
        "plain_ms: n=129, B=8, M=100"
    kernels = [
        entry("march_fused_2d", cluster_cu, f"{pm}:393",
              c4["launches"]["march_fused_2d"], long["max_abs_dphi"],
              c4["march_ms_full_shape"], long["march_plain_ms"],
              _march_work(129, 128, c4["M"], c4["march_newton_full_shape"],
                          trips_fwd), shape=full4),
        entry("adjoint_fused_2d", sweep_cu, f"{pm}:751",
              c4["launches"]["adjoint_fused_2d"], long["max_abs_dr"],
              c4["adjoint_ms_full_shape"], long["adjoint_plain_ms"],
              _adjoint_work(129, 128, c4["M"], trips_adj), shape=full4),
        entry("march_fused_2d_blocked", cluster_cu, f"{pm}:1649",
              c5["launches"]["march_fused_2d_blocked"], blk8["max_abs_dphi"],
              mean(blk8["march_blocked_ms"]), blk8["march_plain_ms"],
              _march_work(blk8["n"], blk8["B"], blk8["M"],
                          blk8["newton_blocked_total"], trips_fwd)),
        entry("adjoint_fused_2d_blocked", sweep_cu, f"{pm}:1905",
              c5["launches"]["adjoint_fused_2d_blocked"], blk8["max_abs_dr"],
              mean(blk512["adjoint_blocked_ms"]), blk8["adjoint_plain_ms"],
              _adjoint_work(blk512["n"], blk512["B"], blk512["M"], trips_adj),
              shape="ms, bound_ms: the headline's n=65, B=512, M=100; "
                    "max_abs_err, plain_ms: n=65, B=8, M=10"),
        entry("march_fused_2d_segment", cluster_cu, f"{pm}:479",
              c6["launches"]["march_fused_2d_segment"],
              seg257["max_abs_err_march"], seg257["march_ms"],
              seg257["march_plain_ms"],
              _march_work(seg257["n"], seg257["B"], seg257["K"], seg_newton,
                          trips_fwd, segment=True)),
        entry("adjoint_fused_2d_segment", sweep_cu, f"{pm}:819",
              c6["launches"]["adjoint_fused_2d_segment"],
              seg257["max_abs_err_adjoint"], mean(sweep32["cluster_ms"]),
              seg257["adjoint_plain_ms"],
              _adjoint_work(sweep32["n"], sweep32["B"], sweep32["K"],
                            trips_adj, segment=True),
              shape="ms, bound_ms: phase 6's n=257, B=32, K=10; "
                    "max_abs_err, plain_ms: n=257, B=2, K=10"),
    ]
    # the per-solve kernels at config 3's shape (n = 65, one solve), their
    # launches on their paths: the Schur solves of config 3's constructor,
    # the adjoint solves of its timed run, and the same of the raw config-3
    # run (phase 8r)
    L8, L8r = c3["launches"], c3r["kernel"]
    solve_launches = {
        "bicgstab_schur_spectral":
            L8["constructor"]["bicgstab_schur_spectral"],
        "bicgstab_adjoint_spectral":
            L8["timed"]["bicgstab_adjoint_spectral"],
        "bicgstab_schur": L8r["constructor_launches"]["bicgstab_schur"],
        "bicgstab_adjoint": L8r["launches"]["bicgstab_adjoint"]}
    lines = {"bicgstab_schur_spectral": 691, "bicgstab_schur": 233,
             "bicgstab_adjoint_spectral": 798, "bicgstab_adjoint": 581}
    # rows 8-11 on their cluster kernels at n = 65, B = 1
    for k in SOLVE_KERNELS:
        r = rows[(k, 65, 1)]
        kernels.append(entry(
            k, "vch_tpu_torch/csrc/solve2d_cluster.cu", f"{pk}:{lines[k]}",
            solve_launches[k], r["max_abs_err"], mean(r["cluster_ms"]),
            r["plain_ms"], (sum(_solve_work(k, 65, 1, t)[0]
                                for t in r["trips"]),
                            _solve_work(k, 65, 1, 0)[1])))
    # the 1D march at config 2's full shape (n = 513, B = 256, M = 500); its
    # plain version and error at the smallest bucket and a fifth of the
    # depth (n = 513, B = 8, M = 100); its launches on config 2's timed run
    kernels.append(entry(
        "march_fused_1d", "vch_tpu_torch/csrc/march1d.cu", f"{pm}:1183",
        c9["launches"]["march_fused_1d"], long1d["max_abs_dphi"],
        c9["march_ms_full_shape"], long1d["march_plain_ms"],
        _march1d_work(513, 256, c9["M"], c9["march_newton_full_shape"],
                      trips_1d),
        shape="ms, bound_ms: config 2's n=513, B=256, M=500; max_abs_err, "
              "plain_ms: n=513, B=8, M=100"))
    # the operators no solver calls, at n = 65, one field (the batched Schur
    # solve at B = 8), their launches those of operator_calls
    apply_cu = "vch_tpu_torch/csrc/apply2d.cu"
    kernels.append(entry(
        "bicgstab_schur_batched", "vch_tpu_torch/csrc/solve2d_cluster.cu",
        f"{pk}:394",
        op_calls["bicgstab_schur"], bschur["max_abs_err"], bschur["ms"],
        bschur["plain_ms"],
        (sum(_solve_work("bicgstab_schur", bschur["n"], 1, t)[0]
             for t in bschur["trips"]),
         _solve_work("bicgstab_schur", bschur["n"], bschur["B"], 0)[1])))
    for k, line in zip(APPLY_KERNELS, (101, 133, 478)):
        c = a65[k]
        kernels.append(entry(k, apply_cu, f"{pk}:{line}", op_calls[k],
                             c["max_abs_err"], c["ms"], c["plain_ms"],
                             _apply_work(k, a65["n"], 1), c["library_ms"]))
    # rows 16-17 at the script's default shape (n = 65, B = 32, 10 trips or
    # link pairs of 16 products each), their launches the entry point's,
    # with their kernel, cluster size, the one-CTA oracle's time in turns
    # and, from phase 2e-dev, the device-alone times of kernel, oracle and
    # library form (the plain version's calls under one CUDA graph)
    p65, d65 = probes[0], probes_dev[0]
    for k, line in (("nodots", 131), ("mmonly", 176)):
        g, t, dv = p65["gate"][k], p65["turns"][f"schur_{k}"], \
            d65[f"schur_{k}"]
        e = entry(
            f"schur_{k}", "vch_tpu_torch/csrc/solve2d_cluster.cu",
            f"scripts/diag_kernel_cost.py:{line}",
            p65["launches"][f"schur_{k}"], g["max_abs_err"], p65[f"{k}_ms"],
            g["plain_ms"], _solve_work("bicgstab_schur", p65["n"] + 1,
                                       p65["b"], p65["iters"]),
            library_ms=dv["library_ms"])
        e.update(kernel="schur_probe_cluster_kernel<"
                        f"{'true' if k == 'mmonly' else 'false'}>",
                 cluster=p65["geometry"]["schur_probe"]["cluster"],
                 oracle_ms=mean(t["old_ms"]), ms_in_turns=mean(t["new_ms"]),
                 device_ms=dv["ms"], oracle_device_ms=dv["oracle_ms"])
        kernels.append(e)
    kernels += _chain_probe_entries(chains, chains_dev, entry)
    # rows 1-6: their launches in phase 12's runs beside their main paths';
    # every row's launches in phase 13's runs
    for e in kernels[:6]:
        e["launches_phase12"] = side.get(e["name"], 0)
    for e in kernels:
        e["launches_phase13"] = mesh.get(e["name"], 0)
    _log("end", f"{time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
