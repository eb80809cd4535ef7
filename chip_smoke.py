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
  2p kernels — the cluster march's bf16 forms (fused_solve_precision
               "bf16x3", the default, and "default": the Krylov operator's
               four products on bf16 mma.sync): <1, false> at n = 65, B = 1
               and n = 129, B = 8, <8|4|2, false> at n = 65, B = 16 and
               <1, true> at n = 257, K = 10, B = 2, each at "highest",
               "bf16x3" and "default" against its plain version at the same
               mode: max|dphi| within ten times the float32 gate of its
               shape, first_bad equal, each member's Newton solves within
               one, one launch of the bf16 form and not the float32 bits;
               each mode's device ms per launch in turns and its bound
               (the bf16 passes over the bf16 peak, the rest over FP32);
               phases 2-2c, 4's march and sweep alone, 14c and every one-CTA
               oracle's bit gate run at "highest", their inputs as before;
  2q kernels — the cluster sweep's bf16 forms (adjoint_solve_precision
               "bf16x3": its Krylov operator's four products on bf16
               mma.sync) at their main paths' shapes, <1, false> at config
               4's n = 129, B = 128, M = 100, <8, false> at the headline's
               n = 65, B = 512 (blocks 4 and 2 and the one-member form
               bit-gated against it), <1, true> at low memory's n = 257,
               B = 32, K = 10, from a seeded march's history: the bf16 r
               held to the float64 sweep on the first members (within
               twice the farther of the plain float32 bf16x3 sweeps on the
               card and on the CPU, _adjoint_gate's rule, and within 5e-3
               of the plain bf16x3 sweep or twice the two plain sweeps'
               spread where larger), one launch of the bf16 form and not
               the float32 bits, two other cluster sizes bit for bit; both
               forms' device ms in turns and their bounds; the same forms
               at n = 33, M = 4, where the gate must also fail a control,
               the bf16 form at one pass (at the main shapes whether it
               fails is recorded);
  2r kernels — the cluster march's fwd_mm forms (fwd_mm "bf16x3": every
               product of the march on bf16 mma.sync, apply_S at the
               default fused_solve_precision "bf16x3"), short marches at
               their main paths' shapes: <1, false> at config 4's n = 129
               (B = 8, M = 5), <8|4|2, false> at n = 65, B = 16, M = 10,
               <1, true> at n = 257, B = 2, K = 10: max|dphi| from the plain
               float64 march at the same modes within twice the farther of
               the plain float32 ones on the card and on the CPU (+1e-6),
               a control (the form at one pass: no fwd_mm selects it)
               outside that gate, one launch of the fwd_mm form and not the
               bf16 form's bits, blocks 8, 4, 2, the one-member form and
               two other cluster sizes bit for bit; both forms' device ms
               in turns and their bounds;
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
               path, once with each pallas_variant, its trials' march at
               "highest" (its inputs and gates as before the bf16 forms);
  3c16       — the same at the default "bf16x3", with a second plain path
               on the CPU: costs and trials as 3c's gates, Newton solves
               within 1% of either plain path's (check_control_slice16);
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
               the default fused_solve_precision "bf16x3", one warm-up
               iteration, then 3 timed PGD iterations with the kernel launch
               counters reset just before (per-member kernels, every march
               launch on the bf16 form); then the march kernel alone at that
               shape at "highest" and "bf16x3" in turns, with its cluster
               geometry and bound at each, and the one-member sweep alone on
               the float32 march's history, with its bound, and its one-CTA
               oracle in turns with it, bit-gated;
  4h         — phase 4's run once more at "highest" (the float32 march):
               its rate and launches, and the default run's Newton-solve
               ratio and largest relative cost difference against it
               (recorded, not gated); likewise 5h after phase 5 and 6h after
               phase 6;
  4s scan    — a main path: config 4's shape on the scan path
               (BatchedProblem2D(fused_march=False)), one warm-up and one
               timed PGD iteration, the spectral per-solve kernels at
               B = 128, with their launches' CUDA-event ms; peak memory
               over S and the first iteration's cost against the fused run
               of phase 4;
  5 headline — bench.py's configuration: 64x64, T = 1, B = 512, float32,
               "bf16x3", one warm-up, then 3 timed PGD iterations (blocked
               kernels, the march on its bf16 form);
               the blocked kernels' launches and CUDA-event milliseconds
               inside the timed window, by batch, beside phase 2b's
               one-CTA sweep at B = 512;
  5a         — phase 5's run at adjoint_solve_precision "bf16x3", one
               warm-up and 2 timed iterations: every sweep launch on the
               blocked sweep's bf16 form, the cost descending, its mean
               after 2 iterations within 1% relative of phase 5's (the
               per-member largest difference recorded, not gated: vch_tpu
               records up to 1.7% a member after 20 iterations);
  6 low mem  — config 5's grid: 256x256, T = 1, B = 32, K = 10, procedural
               ramp targets, routed by make_batched_problem_2d under the
               largest device-memory limit its full-memory estimate does
               not fit; one warm-up and one timed iteration (segment
               kernels, the march on its bf16 form at "bf16x3"), whose
               peak must stay within that limit; the
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
  10x exact  — config 1 likewise through ControlProblem1D, 2 timed
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
               processes of their own, all three at once, each to exit 0;
               one line per
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
               counter above 0; (b) config 4's grid (128x128), B cut to
               16: checkpoint at 2, resume to 4 against an uninterrupted 4
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
               one), no launch, collectives per Newton solve; then their
               inner APIs, march and run_impl, at 32 x 32, T = 0.05 on host
               numpy row blocks and on CUDA tensors, bit for bit; (c)
               GridShardedProblem2D at 128 x 128, T = 1, 2 iterations,
               against ControlProblem2D's plain path (trials equal, costs
               2e-4); (d) GridShardedBatchedProblem2D on the (1, 1) mesh,
               B = 4, 1 iteration, against BatchedProblem2D(fused_march=
               False) likewise; (e) `sweep2d --mesh` and `optimize2d
               --grid-shard` at 32x32 on the card against --device cpu
               (processes of their own), 2e-4;
  14 fused   — the fused line search (ProximalGradientLoop(search_mode=
               "fused")): (a) config 3 on phase 8's problem and starting
               state, 1 warm-up then 3 timed iterations: trials, alphas and
               Newton solves phase 8's, costs within 1e-6 relative, row 1
               launched 1 + ls_max_trials times an iteration of which
               exactly the searching trials march, the search alone free of
               host reads (set_sync_debug_mode("error")), the synchronizing
               calls of one iteration of each mode, both modes' rates in
               turns; (b) config 1, 3 iterations (its third fails all its
               trials), fused against host on the card (trials, alphas,
               Newton solves equal, costs 1e-6, a failed iteration keeps its
               worse iterate); (c) row 1 with the
               flag: n = 65, B = 4, flags [1, 0, 1, 0] and n = 129, B = 128,
               all ones, bit for bit the launch without a flag (within 2% of
               its time), an idle launch's cost at n = 65, B = 1;
  15 surface — the public surface on vch_tpu's contracts: (a) the public
               apply_laplacian_2d(Lx, Ly, v) at n = 65 and 129, B = 4,
               float32 and float64, against stencil_laplacian_2d (1e-5 and
               1e-12 of the largest value), Ly untransposed in the solvers'
               helper at least 0.1 off; (b) config 3 built from the package
               namespaces (ForwardSolver2D, AdjointSolver2D, the targets
               and the cost) into a ProximalGradientLoop on vch_tpu's
               adjoint contract (phi_hist -> r), 2 iterations in each
               search mode: trials and alphas phase 8's, the host mode's
               costs phase 8's bit for bit (fused 1e-6), rows 1, 8, 9
               launched as phase 8 launches them; (c) the coercivity probe
               at 15b's result with vch_tpu's one-control forward (5
               launches of row 1) against phase 8's batched call (1), in
               turns, their seconds and estimates;
  16 chain   — vch_tpu's forward -> adjoint -> cost -> sparsity chain through
               public entry points only, float32, at config 3's 64 x 64 grid
               and config 1's N = 128: ForwardSolver{2,1}D.simulate(control=
               <CUDA tensor>), its phi_hist straight into
               AdjointSolver{2,1}D.run with CUDA t_hist and targets,
               calculate_cost with numpy grids, verify_sparsity_condition on
               CUDA u and r, and in 1D newton_1d on one member's (N+1,)
               fields: every stage bit for bit the same chain from numpy
               inputs; launches per run: rows 8 (a Newton solve) and 9 (M)
               at 64 x 64, none in 1D (phase 10's per-step path); 16c:
               sweep_2d at 64 x 64 with b3 and kappa values as CUDA
               tensors (B = 4) bit for bit the list-valued sweep, then 2
               PGD iterations of BatchedProblem2D.run on each and on the
               batch as CUDA tensors, bit for bit (costs, trials, alphas,
               Newton solves, u) with the same launches;
               trial_memory_analysis on both batches, prewarm on the
               tensor batch;
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


def _problem_inputs(torch, n, B, T, device, seed=0, solve_prec="highest"):
    """Solvers in float32 and float64 (the float64 ones on the plain
    versions, taking the float32 Newton exits) at `solve_prec` (the fused
    march's fused_solve_precision; "highest" keeps phases 2-2c on their
    float32 bit gates' inputs) and seeded inputs, as tensors of both
    dtypes."""
    from vch_tpu_torch.config import DELTA_SEP, ForwardSolverConfig2D
    from vch_tpu_torch.control.targets import build_targets_2d
    from vch_tpu_torch.models.adjoint2d import AdjointSolver2D
    from vch_tpu_torch.models.forward2d import ForwardSolver2D
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.ops.potential import init_phi_random_2d

    solvers = {}
    for dt in ("float32", "float64"):
        cfg = ForwardSolverConfig2D(Nx=n - 1, Ny=n - 1, T=T, dtype=dt,
                                    newton_tol=2e-4,
                                    fused_solve_precision=solve_prec)
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


# Phase 2p: the cluster march's bf16 forms (fused_solve_precision "bf16x3"
# and "default": apply_S's four products on bf16 mma.sync). ROADMAP's
# float32 gates of the march kernel against its plain version by n (the
# first port's short marches); a bf16 form is held to ten times the float32 gate of its
# shape: that, or the float32 pair's own max|dphi| on the same inputs in
# this run where larger or where ROADMAP gives none.
BF16_F32_GATE = {65: 5.9e-7, 129: 2.7e-6}
BF16_MODES = ("bf16x3", "default")
# (wrapper, n, B, T, block sizes): <1, false> at two shapes, <8|4|2, false>,
# <1, true> (one K = 10 segment from phi0)
BF16_FORMS = (("march_fused_2d", 65, 1, 0.1, None),
              ("march_fused_2d", 129, 8, 0.05, None),
              ("march_fused_2d_blocked", 65, 16, 0.1, (8, 4, 2)),
              ("march_fused_2d_segment", 257, 2, 0.1, None))


def _march_work16(n, B, M, newton, n_trips, passes, segment=False):
    """(FP32 FLOPs, bf16 FLOPs, bytes) of a march launch whose Krylov
    operator runs on the tensor cores: its apply_S products (8 n_trips a
    Newton iteration, trips in full) `passes` times as bf16 FLOPs, the rest
    as _march_work counts it."""
    flops, nbytes = _march_work(n, B, M, newton, n_trips, segment)
    krylov = 2.0 * n ** 3 * newton * 8 * n_trips
    return flops - krylov, krylov * passes, nbytes


def _bound16(f32_flops, bf16_flops, nbytes):
    """(bound_ms, bound_by) of mixed work: the bf16 FLOPs over the dense
    bf16 peak plus the FP32 FLOPs over the FP32 peak, or the bytes over the
    memory rate, the larger."""
    t_ops = (bf16_flops / PEAK_BF16_FLOPS + f32_flops / PEAK_FP32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bf16_form_case(torch, device, form, n, B, T, blocks=None, reps=3):
    """Phase 2p at one form and shape: the kernel at "highest", "bf16x3"
    and "default" against its plain version at the same mode on the same
    seeded inputs (the segment form: one K = M segment from phi0; the
    blocked form: each block size of `blocks`): max|dphi| (the history,
    and the segment's phi, mu, w out), Newton solves and first_bad of both,
    the launches of the bf16 form, whether its bits differ from the float32
    kernel's, the launch geometry; then each mode's device ms per launch in
    turns (highest, bf16x3, default, default, bf16x3, highest; CUDA
    events) and its bound on its Newton total; the plain version's host
    ms."""
    from vch_tpu_torch.ops import march as km

    solvers, x, _ = _problem_inputs(torch, n, B, T, device)
    fwd = solvers["float32"][0]
    phi0, segment = x["phi0"], form == "march_fused_2d_segment"
    if segment:
        w = torch.zeros_like(phi0)
        args = (fwd.dts, phi0, fwd.initialize_mu(phi0, w), w,
                torch.sum(fwd.wts * phi0, dim=(-2, -1)), x["u"]) + fwd._ops()
    else:
        args = (fwd.dts, phi0, x["u"]) + fwd._ops()
    kernel, plain = getattr(km, form), getattr(km, form + "_plain")
    variants = [dict(block_b=bb) for bb in blocks] if blocks else [{}]
    nphi = 4 if segment else 1
    trips = fwd.config.fused_krylov_fixed_iters
    mkw = lambda mode: dict(fwd._march_kw(), solve_prec=mode)
    out = dict(form=form, n=n, B=B, M=fwd.M, runs={})
    f32 = {}
    for mode in ("highest",) + BF16_MODES:
        # per member: the same for every block size
        plain_ms, p = _host_ms(torch, lambda: plain(*args, **variants[0],
                                                    **mkw(mode)))
        for v in variants:
            tag = mode + (f" block {v['block_b']}" if v else "")
            before = kernel.bf16_launches
            k = kernel(*args, **v, **mkw(mode))
            torch.cuda.synchronize()
            if mode == "highest":
                f32[tag] = k[0]
            passes = km.solve_passes(mode)
            g = km.launch_geometry(n, n, B, device,
                                   members=v.get("block_b", 1),
                                   segment=segment, solve_passes=passes)
            out["runs"][tag] = dict(
                max_abs_dphi=max((a - b).abs().max().item()
                                 for a, b in zip(k[:nphi], p[:nphi])),
                finite=all(bool(torch.isfinite(a).all()) for a in k[:nphi]),
                newton_kernel=k[-2].cpu().tolist(),
                newton_plain=p[-2].cpu().tolist(),
                first_bad=k[-1].cpu().tolist(),
                first_bad_equal=bool(torch.equal(k[-1], p[-1])),
                plain_ms=plain_ms,
                bf16_launches=kernel.bf16_launches - before,
                bits_of_highest=bool(torch.equal(
                    k[0], f32[tag.replace(mode, "highest", 1)])),
                geometry=dict(cluster=g.cluster, kc=g.kc,
                              smem_bytes=g.smem_bytes))
            del k
        del p
    for v in variants:
        fns = {mode: (lambda mode=mode: kernel(*args, **v, **mkw(mode)))
               for mode in ("highest",) + BF16_MODES}
        for mode in list(fns) + list(fns)[::-1]:
            tag = mode + (f" block {v['block_b']}" if v else "")
            out["runs"][tag].setdefault("ms", []).append(
                time_ms(fns[mode], reps))
    for tag, r in out["runs"].items():
        passes = km.solve_passes(tag.split()[0])
        work = _march_work16(n, B, fwd.M, sum(r["newton_kernel"]), trips,
                             passes, segment)
        r["bound_ms"], r["bound_by"] = _bound16(*work)
    out["f32_max_abs_dphi"] = max(r["max_abs_dphi"] for t, r in
                                  out["runs"].items()
                                  if t.startswith("highest"))
    out["gate"] = 10 * max(BF16_F32_GATE.get(n, 0.0), out["f32_max_abs_dphi"])
    return out


def check_bf16_form_case(c):
    """Phase 2p gates, at each bf16 mode and block: max|dphi| within the
    case's gate (ten times the float32 one), first_bad equal, each member's
    Newton solves within one of the plain version's, one launch of the bf16
    form and not the float32 kernel's bits; at "highest" no bf16 launch."""
    fails = []
    for tag, r in c["runs"].items():
        if not (r["finite"] and r["first_bad_equal"]):
            fails.append(f"{tag}: non-finite or first_bad differs")
        if tag.startswith("highest"):
            if r["bf16_launches"] != 0:
                fails.append(f"{tag}: launched the bf16 form")
            continue
        if r["max_abs_dphi"] > c["gate"]:
            fails.append(f"{tag}: max|dphi| {r['max_abs_dphi']} > "
                         f"{c['gate']}")
        if any(abs(a - b) > 1 for a, b in zip(r["newton_kernel"],
                                              r["newton_plain"])):
            fails.append(f"{tag}: Newton {r['newton_kernel']} vs plain "
                         f"{r['newton_plain']}")
        if r["bf16_launches"] != 1 or r["bits_of_highest"]:
            fails.append(f"{tag}: {r['bf16_launches']} bf16 launches, bits "
                         f"of the float32 kernel {r['bits_of_highest']}")
    if fails:
        raise RuntimeError(f"phase 2p {c['form']} n={c['n']} B={c['B']}: "
                           + "; ".join(fails))


def _geometry(km, torch, device, n, B, members, segment=False,
              kernel="march", solve_passes=0, fwd_passes=0):
    """The launch geometry of a cluster kernel (with solve_passes, its bf16
    form; with fwd_passes too, the march's fwd_mm form) for B members of an
    (n, n) grid, `members` per cluster: cluster, CTAs, band rows, units,
    passes, ring rows, shared bytes and how many such clusters the card
    holds."""
    g = km.launch_geometry(n, n, B, device, members=members,
                           segment=segment, kernel=kernel,
                           solve_passes=solve_passes, fwd_passes=fwd_passes)
    idx = torch.device(device).index or 0
    return dict(cluster=g.cluster, ctas=B // members * g.cluster,
                band_rows=[r for _, r in g.bands], units=g.units,
                passes=g.passes, kc=g.kc, smem_bytes=g.smem_bytes,
                resident_clusters=km.resident_clusters(
                    idx, n, n, g.cluster, g.kc, g.smem_bytes, members,
                    segment, kernel + ("16f" if fwd_passes else "16"
                                       if solve_passes else "")))


# (wrapper, n, B, T, float64-gated members, other cluster sizes): the
# sweep's bf16 forms at their main paths' shapes: <1, false> at config 4's
# (n = 129, B = 128, M = 100), <8, false> at the headline's (n = 65,
# B = 512, M = 100; blocks 4 and 2 and the one-member form bit-gated
# against it), <1, true> at low memory's (n = 257, B = 32, one K = 10
# segment)
SWEEP16_FORMS = (("adjoint_fused_2d", 129, 128, 1.0, 4, (2, 4)),
                 ("adjoint_fused_2d_blocked", 65, 512, 1.0, 8, (1, 4)),
                 ("adjoint_fused_2d_segment", 257, 32, 0.1, 2, (4, 2)))
# the same forms at n = 33, M = 4 (tests/test_torch_cuda.py's control
# shapes), where a float32 sweep lies ~7e-5 from float64 and one pass of
# At's products ~3-6e-4 (the plain sweeps on the CPU): there the gate must
# fail the one-pass control; at the main shapes any two float32 sweeps
# (5e-3 at n = 129, 2e-2 at n = 257) lie farther apart than one pass moves r
SWEEP16_CONTROLS = (("adjoint_fused_2d", 33, 4, 0.04, 4, ()),
                    ("adjoint_fused_2d_blocked", 33, 16, 0.04, 16, ()),
                    ("adjoint_fused_2d_segment", 33, 4, 0.04, 4, ()))


def _adjoint_work16(n, B, M, n_trips, segment=False):
    """(FP32 FLOPs, bf16 FLOPs, bytes) of a sweep launch whose Krylov
    operator runs on the tensor cores: apply_At's products (4 for r0's
    apply and 8 a trip, trips in full) three times as bf16 FLOPs, the rest
    as _adjoint_work counts it."""
    flops, nbytes = _adjoint_work(n, B, M, n_trips, segment)
    krylov = 2.0 * n ** 3 * B * M * (4 + 8 * n_trips)
    return flops - krylov, 3 * krylov, nbytes


def sweep16_case(torch, device, form, n, B, T, gate_members, clusters,
                 reps=1):
    """Phase 2q at one form and its main path's shape: the sweep at
    "highest" and at "bf16x3" (adjoint_solve_precision) on the cluster
    kernel, from a seeded march's history (seeded phi_Q, b1, b2 and
    terminal targets; the segment form from the terminal carry); on the
    first `gate_members` members the plain sweep in float32 at "bf16x3",
    on the card and on the CPU, and in float64 at "highest": each kernel's
    and each plain version's relative distance from float64 (r; the
    segment's carry out too), the two plain float32 sweeps' distance, the
    bf16 form's launches and whether it gives the float32 bits; the
    control, the bf16 form at one pass (`sweep_passes` replaced: no mode
    selects it), and whether the gate fails it; the blocked
    form at blocks 4 and 2 and the one-member bf16 form, and `clusters`,
    each bit-gated against the bf16 launch; both forms' device ms in turns
    (highest, bf16x3, bf16x3, highest; CUDA events), geometry and bound
    (trips in full); the plain version's host ms."""
    from vch_tpu_torch.config import DELTA_SEP
    from vch_tpu_torch.models.adjoint2d import AdjointSolver2D
    from vch_tpu_torch.models.forward2d import ForwardSolver2D
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.ops.potential import init_phi_random_2d

    # _seeded_march's phi0, and u drawn on the card (the host's generator
    # took ~4 s a form at these batches)
    fwd = ForwardSolver2D(_config(n - 1, T=T), device=device)
    gen = torch.Generator(device).manual_seed(0)
    phi0 = torch.as_tensor(np.stack([
        init_phi_random_2d(n - 1, n - 1, DELTA_SEP, amp=0.1, seed=42 + i)
        for i in range(B)]), dtype=torch.float32, device=device)
    u = 0.1 * torch.randn((B, fwd.M + 1, n, n), device=device, generator=gen)
    hist = km.march_fused_2d(fwd.dts, phi0, u, *fwd._ops(),
                             **fwd._march_kw())[0]
    del u
    adj = AdjointSolver2D(fwd.config, device=device)
    M, g = fwd.M, gate_members
    segment, blocked = form.endswith("segment"), form.endswith("blocked")
    phiQ = 0.3 * torch.randn(tuple(hist.shape), device=device, generator=gen)
    b1 = torch.linspace(0.3, 5.0, B, device=device)
    b2 = torch.linspace(13.0, 10.0, B, device=device)
    phiT = 0.1 * phi0
    if segment:
        member = (hist, phiQ) + adj.terminal(hist[:, M], phiT, b2) + (b1,)
    else:
        member = (hist, phiQ, phiT, b1, b2)
    ops = adj._ops()
    kernel = getattr(km, form)
    plain = getattr(km, form + "_plain")
    v = dict(block_b=8) if blocked else {}
    kw = lambda prec: dict(adj._kw(), solve_prec=prec)
    run = lambda prec, **o: kernel(adj.dts, *member, *ops, **(o or v),
                                   **kw(prec))
    outs = lambda x: x if segment else (x,)
    before = kernel.bf16_launches
    k16 = outs(run("bf16x3"))
    launches16 = kernel.bf16_launches - before
    k32 = outs(run("highest"))
    torch.cuda.synchronize()
    sub = tuple(t[:g] for t in member)
    plain_ms, p16 = _host_ms(torch, lambda: outs(plain(
        adj.dts, *sub, *ops, **v, **kw("bf16x3"))))
    p64 = outs(plain(adj.dts.double(), *(t.double() for t in sub),
                     *(o.double() for o in ops), **v, **kw("highest")))
    pcpu = tuple(t.to(device) for t in outs(plain(
        adj.dts.cpu(), *(t.cpu() for t in sub), *(o.cpu() for o in ops),
        **v, **kw("bf16x3"))))
    real_passes = km.sweep_passes
    km.sweep_passes = lambda prec: 1 if prec == "bf16x3" else 0
    try:
        k1 = outs(run("bf16x3"))
    finally:
        km.sweep_passes = real_passes
    dist = lambda a: max(_rel(x[:g], y, y) for x, y in zip(a, p64))
    out = dict(form=form, n=n, B=B, M=M, gate_members=g,
               bf16_launches=launches16,
               bits_of_highest=all(torch.equal(a, b)
                                   for a, b in zip(k16, k32)),
               finite=all(bool(torch.isfinite(t).all()) for t in k16),
               rel_r_kernel_vs_f64=dist(k16),
               rel_r_f32_kernel_vs_f64=dist(k32),
               rel_r_plain_vs_f64=dist(p16),
               rel_r_plain_cpu_vs_f64=dist(pcpu),
               rel_r_plain_vs_plain_cpu=max(_rel(x, y, y)
                                            for x, y in zip(p16, pcpu)),
               rel_dr=max(_rel(x[:g], y, y) for x, y in zip(k16, p16)),
               max_abs_dr=max((x[:g] - y).abs().max().item()
                              for x, y in zip(k16, p16)),
               one_pass_rel_r_vs_f64=dist(k1),
               one_pass_rel_dr=max(_rel(x[:g], y, y)
                                   for x, y in zip(k1, p16)),
               plain_ms=plain_ms)
    out["one_pass_fails_gate"] = bool(_sweep16_fails(
        out, out["one_pass_rel_r_vs_f64"], out["one_pass_rel_dr"]))
    same = lambda a: all(torch.equal(x, y) for x, y in zip(outs(a), k16))
    # the entry point alone, once per form: its launches (the solvers'
    # paths reach rows 2 and 6's bf16 forms only by a direct call)
    out["entry_launches"] = {}
    for bb in ((8, 4, 2) if blocked else (None,)):
        before = kernel.bf16_launches
        run("bf16x3", **({"block_b": bb} if bb else {}))
        out["entry_launches"][bb or 1] = kernel.bf16_launches - before
    if blocked:
        out["blocks_equal"] = {bb: same(run("bf16x3", block_b=bb))
                               for bb in (4, 2)}
        out["one_member_equal"] = same(km.adjoint_fused_2d(
            adj.dts, *member, *ops, **kw("bf16x3")))
    members = v.get("block_b", 1)
    out["geometry"] = _geometry(km, torch, device, n, B, members, segment,
                                kernel="sweep", solve_passes=3)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    fitted, out["other_clusters"] = km.launch_geometry, []
    try:
        for C in clusters:
            gc = km.blocked_geometry(n, n, B, sms, cluster=C,
                                     members=members, kernel="sweep",
                                     solve_passes=3)
            km.launch_geometry = lambda *a, **k: gc
            out["other_clusters"].append(dict(cluster=C,
                                              equal=same(run("bf16x3"))))
    finally:
        km.launch_geometry = fitted
    for prec in ("highest", "bf16x3", "bf16x3", "highest"):
        out.setdefault(f"{prec}_ms", []).append(
            time_ms(lambda: run(prec), reps))
    if blocked:      # blocks 4 and 2 once each, after the turns
        out["bf16x3_ms_by_block"] = {
            bb: time_ms(lambda: run("bf16x3", block_b=bb), reps)
            for bb in (4, 2)}
    trips = fwd.config.adjoint_krylov_fixed_iters
    out["bound_ms"], out["bound_by"] = _bound16(*_adjoint_work16(
        n, B, M, trips, segment))
    out["highest_bound_ms"], _ = _bound(*_adjoint_work(n, B, M, trips,
                                                       segment))
    del hist, phiQ, member, k16, k32, k1
    return out


def _sweep16_fails(c, rel_r_vs_f64, rel_dr):
    """The accuracy gate of phase 2q for a bf16 sweep lying rel_r_vs_f64
    from the float64 sweep and rel_dr from the plain bf16x3 sweep on the
    card: _adjoint_gate's float64 clause (within twice the farther of the
    plain float32 bf16x3 sweeps on the card and on the CPU, +1e-6), and
    within 5e-3 of the plain sweep or within twice the two plain sweeps'
    distance where that is larger (check_segment_case's rule: at n = 257
    any two float32 sweeps lie ~2e-2 apart)."""
    fails = _adjoint_gate(dict(
        rel_r_kernel_vs_f64=rel_r_vs_f64,
        rel_r_plain_vs_f64=c["rel_r_plain_vs_f64"],
        rel_r_plain_cpu_vs_f64=c["rel_r_plain_cpu_vs_f64"], rel_dr=0.0))
    ceiling = max(5e-3, 2 * c["rel_r_plain_vs_plain_cpu"])
    if rel_dr > ceiling:
        fails.append(f"bf16 kernel vs plain rel {rel_dr} > {ceiling}")
    return fails


def check_sweep16_case(c, control=False):
    """Phase 2q gates: the bf16 form launched once, finite, not the float32
    bits; `_sweep16_fails` empty; the blocked forms and the one-member form
    give its bits, and so does every cluster size tried; at the control
    shapes (control) the gate fails the one-pass form."""
    fails = _sweep16_fails(c, c["rel_r_kernel_vs_f64"], c["rel_dr"])
    if control and not c["one_pass_fails_gate"]:
        fails.append(f"the gate passes the one-pass control "
                     f"({c['one_pass_rel_r_vs_f64']} from float64)")
    if (c["bf16_launches"] != 1 or c["bits_of_highest"] or not c["finite"]
            or set(c["entry_launches"].values()) != {1}):
        fails.append(f"{c['bf16_launches']} bf16 launches, the float32 "
                     f"bits {c['bits_of_highest']}, finite {c['finite']}")
    if not all(c.get("blocks_equal", {}).values()) \
            or not c.get("one_member_equal", True):
        fails.append("the blocked bf16 forms differ from the one-member one")
    if not all(o["equal"] for o in c["other_clusters"]):
        fails.append("the bf16 sweep's bits depend on its cluster size")
    if fails:
        raise RuntimeError(f"phase 2q {c['form']} n={c['n']} B={c['B']}: "
                           + "; ".join(fails))


# Phase 2r: the cluster march's fwd_mm forms (fwd_mm "bf16x3": every
# product of the march on bf16 mma.sync, march_fwd16_kernel) at the default
# fused_solve_precision "bf16x3", at a main path's shape with a short
# march: (wrapper, n, B, T, block sizes, float64-gated members, other
# cluster sizes): <1, false> at config 4's n = 129 (B = 8, M = 5), <8|4|2,
# false> at n = 65, B = 16, M = 10, <1, true> at n = 257, B = 2, one K = 10
# segment from phi0
FWD16_FORMS = (("march_fused_2d", 129, 8, 0.05, None, 4, (4, 2)),
               ("march_fused_2d_blocked", 65, 16, 0.1, (8, 4, 2), 8, (1, 4)),
               ("march_fused_2d_segment", 257, 2, 0.1, None, 2, (4, 2)))


def _march_work_fwd16(n, B, M, newton, n_trips, krylov_passes,
                      segment=False):
    """(FP32 FLOPs, bf16 FLOPs, bytes) of a launch of the fwd_mm march,
    every product on the tensor cores: apply_S's (8 n_trips a Newton
    iteration, trips in full) at `krylov_passes`, the rest at three, as
    _march_work counts them (its elementwise work left out: no FP32
    FLOPs)."""
    flops, nbytes = _march_work(n, B, M, newton, n_trips, segment)
    krylov = 2.0 * n ** 3 * newton * 8 * n_trips
    return 0.0, krylov * krylov_passes + 3 * (flops - krylov), nbytes


def fwd16_case(torch, device, form, n, B, T, blocks, gate_members, clusters,
               reps=3):
    """Phase 2r at one form and shape: the march at fwd_mm "bf16x3" and
    fused_solve_precision "bf16x3" on the cluster kernel's fwd_mm form
    (march_fwd16_kernel), on seeded inputs (the segment form: one K = M
    segment from phi0); on the first `gate_members` members the plain march
    at the same modes in float32 on the card and on the CPU and in float64:
    each one's max|dphi| from float64 (the history; the segment's carry out
    too), the kernel's and the plain float32 one's; the fwd_mm form's
    launches (bf16_launches and fwd16_launches) and whether it gives the
    bf16 form's bits (fwd_mm "highest"); the control, the fwd_mm form at
    one pass (`fwd_passes` replaced: no fwd_mm selects it), and whether the
    gate fails it; blocks 8, 4, 2 and the one-member form (blocked) and
    `clusters` bit-gated against the launch; both forms' device ms in
    turns (bf16, fwd_mm, fwd_mm, bf16; CUDA events), geometry and bound
    (trips in full; the fwd_mm form's at its own Newton total); the plain
    version's host ms."""
    from vch_tpu_torch.ops import march as km

    solvers, x, x64 = _problem_inputs(torch, n, B, T, device)
    fwd, fwd64 = solvers["float32"][0], solvers["float64"][0]
    segment, blocked = form.endswith("segment"), form.endswith("blocked")

    def args_of(f, xs):
        phi0 = xs["phi0"]
        if segment:
            w = torch.zeros_like(phi0)
            return (f.dts, phi0, f.initialize_mu(phi0, w), w,
                    torch.sum(f.wts * phi0, dim=(-2, -1)), xs["u"]) + f._ops()
        return (f.dts, phi0, xs["u"]) + f._ops()
    args, g = args_of(fwd, x), gate_members
    # the first g members of the per-member arguments (phi0 and u; the
    # segment's: phi0, its carry and u)
    each = range(1, 6 if segment else 3)
    sub = lambda a: tuple(t[:g] if i in each else t for i, t in enumerate(a))
    args64 = sub(args_of(fwd64, x64))
    kernel, plain = getattr(km, form), getattr(km, form + "_plain")
    v = dict(block_b=8) if blocked else {}
    members_of = lambda o: o.get("block_b", 1)
    mkw = lambda fwd_mm: dict(fwd._march_kw(), solve_prec="bf16x3",
                              fwd_mm=fwd_mm)
    run = lambda fwd_mm="bf16x3", **o: kernel(*args, **(o or v), **mkw(fwd_mm))
    nphi = 4 if segment else 1
    before = (kernel.bf16_launches, kernel.fwd16_launches)
    k16 = run()
    launches = (kernel.bf16_launches - before[0],
                kernel.fwd16_launches - before[1])
    kb = run("highest")
    torch.cuda.synchronize()
    plain_ms, p32 = _host_ms(torch, lambda: plain(*sub(args), **v,
                                                  **mkw("bf16x3")))
    pcpu = plain(*(t.cpu() for t in sub(args)), **v, **mkw("bf16x3"))
    p64 = plain(*args64, **v, **mkw("bf16x3"))
    real_passes = km.fwd_passes
    km.fwd_passes = lambda mode: 1 if mode == "bf16x3" else 0
    try:
        k1 = run()
    finally:
        km.fwd_passes = real_passes
    dist = lambda out: max(
        (a[:g].double().to(b.device) - b).abs().max().item()
        for a, b in zip(out[:nphi], p64[:nphi]))
    out = dict(form=form, n=n, B=B, M=fwd.M, gate_members=g,
               bf16_launches=launches[0], fwd16_launches=launches[1],
               bits_of_bf16_form=bool(torch.equal(k16[0], kb[0])),
               finite=all(bool(torch.isfinite(t).all()) for t in k16[:nphi]),
               first_bad=k16[-1].cpu().tolist(),
               newton_kernel=k16[-2].cpu().tolist(),
               newton_plain=p32[-2].cpu().tolist(),
               newton_plain_cpu=pcpu[-2].tolist(),
               newton_plain_f64=p64[-2].cpu().tolist(),
               newton_bf16_form=kb[-2].cpu().tolist(),
               max_abs_dphi_kernel_vs_f64=dist(k16),
               max_abs_dphi_plain_vs_f64=dist(p32),
               max_abs_dphi_plain_cpu_vs_f64=dist(pcpu),
               max_abs_dphi_bf16_form_vs_f64=dist(kb),
               max_abs_dphi_vs_plain=max(
                   (a[:g] - b).abs().max().item()
                   for a, b in zip(k16[:nphi], p32[:nphi])),
               one_pass_max_abs_dphi_vs_f64=dist(k1),
               one_pass_newton=k1[-2].cpu().tolist(),
               plain_ms=plain_ms)
    out["gate"] = 2 * max(out["max_abs_dphi_plain_vs_f64"],
                          out["max_abs_dphi_plain_cpu_vs_f64"]) + 1e-6
    out["one_pass_fails_gate"] = \
        out["one_pass_max_abs_dphi_vs_f64"] > out["gate"]
    same = lambda o: all(torch.equal(a, b) for a, b in zip(o, k16))
    out["entry_launches"] = {members_of(v): launches[1]}
    if blocked:
        out["blocks_equal"] = {}
        for bb in (4, 2):
            before = kernel.fwd16_launches
            out["blocks_equal"][bb] = same(run(block_b=bb))
            out["entry_launches"][bb] = kernel.fwd16_launches - before
        out["one_member_equal"] = same(km.march_fused_2d(*args,
                                                         **mkw("bf16x3")))
    members = v.get("block_b", 1)
    out["geometry"] = _geometry(km, torch, device, n, B, members, segment,
                                solve_passes=3, fwd_passes=3)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    fitted, out["other_clusters"] = km.launch_geometry, []
    try:
        for C in clusters:
            gc = km.blocked_geometry(n, n, B, sms, cluster=C,
                                     members=members, solve_passes=3,
                                     fwd_passes=3)
            km.launch_geometry = lambda *a, **k: gc
            out["other_clusters"].append(dict(cluster=C, equal=same(run())))
    finally:
        km.launch_geometry = fitted
    for mode in ("highest", "bf16x3", "bf16x3", "highest"):
        out.setdefault(f"fwd_{mode}_ms", []).append(
            time_ms(lambda: run(mode), reps))
    if blocked:      # blocks 4 and 2 once each, after the turns
        out["fwd_bf16x3_ms_by_block"] = {
            bb: time_ms(lambda: run(block_b=bb), reps) for bb in (4, 2)}
    trips = fwd.config.fused_krylov_fixed_iters
    out["bound_ms"], out["bound_by"] = _bound16(*_march_work_fwd16(
        n, B, fwd.M, sum(out["newton_kernel"]), trips, 3, segment))
    out["bf16_form_bound_ms"], _ = _bound16(*_march_work16(
        n, B, fwd.M, sum(out["newton_bf16_form"]), trips, 3, segment))
    del k16, kb, k1, p32, pcpu, p64
    return out


def check_fwd16_case(c):
    """Phase 2r gates: the fwd_mm form launched once (in bf16_launches and
    fwd16_launches), finite, first_bad -1, not the bf16 form's bits; its
    max|dphi| from the plain float64 march within twice the farther plain
    float32 march's (card or CPU) + 1e-6, and the one-pass control outside
    that gate; the blocked forms and the one-member form give its bits, and
    so does every cluster size tried."""
    fails = []
    if c["max_abs_dphi_kernel_vs_f64"] > c["gate"]:
        fails.append(f"max|dphi| from float64 "
                     f"{c['max_abs_dphi_kernel_vs_f64']} > {c['gate']}")
    if not c["one_pass_fails_gate"]:
        fails.append(f"the gate passes the one-pass control "
                     f"({c['one_pass_max_abs_dphi_vs_f64']} from float64)")
    if ((c["bf16_launches"], c["fwd16_launches"]) != (1, 1)
            or set(c["entry_launches"].values()) != {1}
            or c["bits_of_bf16_form"] or not c["finite"]
            or set(c["first_bad"]) != {-1}):
        fails.append(f"{c['fwd16_launches']} fwd_mm launches, the bf16 "
                     f"form's bits {c['bits_of_bf16_form']}, finite "
                     f"{c['finite']}, first_bad {c['first_bad']}")
    if not all(c.get("blocks_equal", {}).values()) \
            or not c.get("one_member_equal", True):
        fails.append("the blocked fwd_mm forms differ from the one-member "
                     "one")
    if not all(o["equal"] for o in c["other_clusters"]):
        fails.append("the fwd_mm march's bits depend on its cluster size")
    if fails:
        raise RuntimeError(f"phase 2r {c['form']} n={c['n']} B={c['B']}: "
                           + "; ".join(fails))


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

    fwd = ForwardSolver2D(_config(n - 1, T=K * 0.01,
                                  fused_solve_precision="highest"),
                          device=device)
    if fwd.M != K:
        raise RuntimeError(f"segment timing: {fwd.M} steps, expected {K}")
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    phi0 = f32(np.stack([init_phi_random_2d(n - 1, n - 1, DELTA_SEP,
                                            amp=0.1, seed=42 + i)
                         for i in range(B)]))
    u = _randn(torch, device, (B, K + 1, n, n), 0.1, 0)
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
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    b1, b2 = f32(np.linspace(0.3, 5.0, B)), f32(np.linspace(13.0, 10.0, B))
    p, q, r = adj.terminal(hist[:, K], 0.1 * margs[1], b2)
    args = (adj.dts, hist, _randn(torch, device, tuple(hist.shape), 0.3, 2),
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


def _randn(torch, device, shape, scale, seed):
    """scale N(0, 1) of `shape` in float32, drawn on the card from a
    generator seeded with `seed` (the host's generator took ~30 s of
    phases 2-2b at their largest batches)."""
    gen = torch.Generator(device).manual_seed(seed)
    return scale * torch.randn(shape, device=device, generator=gen)


def _seeded_march(torch, device, n, B, T, solve_prec="highest"):
    """A float32 forward solver at (n - 1, T) and `solve_prec` (as
    _problem_inputs) and seeded inputs of B members: phi0 from
    init_phi_random_2d (seed 42 + i), u = 0.1 N(0, 1) (`_randn`, seed
    0)."""
    from vch_tpu_torch.config import DELTA_SEP
    from vch_tpu_torch.models.forward2d import ForwardSolver2D
    from vch_tpu_torch.ops.potential import init_phi_random_2d

    fwd = ForwardSolver2D(_config(n - 1, T=T,
                                  fused_solve_precision=solve_prec),
                          device=device)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    phi0 = f32(np.stack([init_phi_random_2d(n - 1, n - 1, DELTA_SEP,
                                            amp=0.1, seed=42 + i)
                         for i in range(B)]))
    u = _randn(torch, device, (B, fwd.M + 1, n, n), 0.1, 0)
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
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    args = (adj.dts, hist, _randn(torch, device, tuple(hist.shape), 0.3, 2),
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
    from vch_tpu_torch.ops.laplacian import apply_laplacian_2d_t
    from vch_tpu_torch.ops.potential import fpp_log

    solvers, x, x64 = _problem_inputs(torch, n, B or 1, 0.02, device, seed)
    (fwd, _), (fwd64, adj64) = solvers["float32"], solvers["float64"]
    hist, _, _ = fwd.march_fused_batch(x["u"], x["phi0"])
    h = hist.double()
    cfg, ops, M = fwd64.config, fwd64.op, fwd64.M
    dt = float(fwd64.dts[-1])
    lap = lambda v: apply_laplacian_2d_t(ops.Lx, ops.LyT, v)
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
    c1x = exact_run(torch, device, "1d", iters=2)
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


def control_slice(torch, device, variant, n=32, T=0.25, iters=3,
                  solve_prec="highest"):
    """Phase 3c: ControlProblem2D at the golden config's grid and horizon in
    float32, kernel path against plain path, for one pallas_variant, its
    trials' march at `solve_prec` ("highest"; 3c16: the default "bf16x3",
    with a second plain path, on the CPU with the trials on the fused
    route's plain march as on the card). The kernel run counts launches
    from its constructor on (the baseline march is where the Schur kernel
    runs); the plain run swaps the solvers' entries to the plain versions
    and redoes the baseline on them."""
    from vch_tpu_torch.ops import march as km

    cfg = _config(n, T=T, pallas_variant=variant,
                  fused_solve_precision=solve_prec)
    paths = ("kernel", "plain") + (("plain_cpu",)
                                   if solve_prec != "highest" else ())
    runs = {}
    for path in paths:
        km.reset_launches()
        prob = _control_problem(torch.device("cpu") if path == "plain_cpu"
                                else device, cfg)
        if path == "plain_cpu":
            prob._fused = True       # the trials on the card's route
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
    out = dict(variant=variant, n=n, M=prob.solver.M, iters=iters,
               solve_precision=solve_prec,
               rel_cost=float((np.abs(c1 - c0) / np.abs(c0)).max()),
               cost_history=c1.tolist(), newton_kernel=kn, newton_plain=pn,
               ls_trials_kernel=kr.ls_trials_per_iter,
               ls_trials_plain=pr.ls_trials_per_iter,
               kernel_s=kt, plain_s=pt, launches=kl, plain_launches=pl,
               finite=bool(np.isfinite(c1).all()))
    if "plain_cpu" in runs:
        cr, cn, ct, cl = runs["plain_cpu"]
        c2 = np.asarray(cr.cost_history)
        out.update(newton_plain_cpu=cn, plain_cpu_s=ct,
                   ls_trials_plain_cpu=cr.ls_trials_per_iter,
                   rel_cost_plain_cpu=float((np.abs(c2 - c0)
                                             / np.abs(c0)).max()),
                   plain_cpu_launches=cl)
    return out


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


def check_control_slice16(c):
    """Phase 3c16 gates, 3c's at the default "bf16x3": costs finite, the
    kernel path's cost history within 2e-4 relative of the plain path's,
    trials equal, the launches of 3c, nothing launched on either plain
    path; Newton solves within 1% of either plain path's, on the card or on
    the CPU. At bf16x3 two float32 implementations split a field into bf16
    (hi, lo) where their values differ in the last bits, so their Newton
    totals spread wider than at "highest": at this shape the plain path on
    the card and on the CPU took 135 and 137, the kernel 137 (spectral;
    raw: 137, 137 and 136), where all three took 104 at "highest" (a
    diagnostic run on an H100, PERF.md §6)."""
    schur, adj = (("bicgstab_schur_spectral", "bicgstab_adjoint_spectral")
                  if c["variant"] == "spectral"
                  else ("bicgstab_schur", "bicgstab_adjoint"))
    fails = [f"{k} never launched" for k in (schur, adj, "march_fused_2d")
             if c["launches"][k] <= 0]
    fails += [f"a plain path launched {k}" for k, v in
              list(c["plain_launches"].items())
              + list(c["plain_cpu_launches"].items()) if v]
    if not c["finite"] or c["rel_cost"] > 2e-4:
        fails.append(f"cost history vs plain {c['rel_cost']}")
    if not (c["ls_trials_kernel"] == c["ls_trials_plain"]
            == c["ls_trials_plain_cpu"]):
        fails.append("trials differ")
    if min(abs(c["newton_kernel"] - c[k]) / c[k]
           for k in ("newton_plain", "newton_plain_cpu")) > 0.01:
        fails.append(f"Newton solves {c['newton_kernel']} vs "
                     f"{c['newton_plain']} (card) and "
                     f"{c['newton_plain_cpu']} (CPU)")
    if fails:
        raise RuntimeError(f"control slice 3c16 {c['variant']}: "
                           + "; ".join(fails) + f" | {c}")


def config3_run(torch, device, iters=3):
    """Phase 8, the slice's main path: BASELINE config 3 (64x64, T = 1,
    M = 100, float32, newton_tol 2e-4, the 2D optimizer defaults) through
    ControlProblem2D on the card: the constructor (baseline march, the
    per-step marcher on the spectral Schur kernel), one warm-up PGD
    iteration, then `iters` timed ones, then the reference program's closing
    checks (verify_sparsity, second_order_check with 5 directions); every
    launch count reset to 0 before each of the four and read after it; last
    the constructor's baseline march once more with CUDA events around each
    Schur solve (row 8, EntryTimer). Returns the figures and the problem,
    which phase 14a reuses."""
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
                alpha_history=res.alpha_history,
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
                finite=bool(np.isfinite(ch).all())), prob


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


def pgd_run(torch, device, prob, sc, iters, before_timed=None,
            with_costs=False):
    """A main path: one warm-up PGD iteration, then `iters` timed ones with
    every kernel launch count reset to 0 just before and read just after
    (before_timed, if given, runs just before too), the cluster march's
    bf16-form launches among them apart. The results stay on the card
    (host_results=False, as bench.py times vch_tpu): the default download
    of u, r and phi would add ~1 s at config 4's width. with_costs: returns
    (the dict, the (iters + 1, B) cost history) instead."""
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
    launches, launches_bf16 = km.launch_counts(), km.bf16_launch_counts()
    B = sc.batch
    ch = out["cost_history"]
    cfg = prob.solver.config
    res = dict(B=B, n=cfg.Nx if hasattr(cfg, "Nx") else cfg.N,
                M=prob.solver.M, iters=iters,
                problem=type(prob).__name__, elapsed_s=elapsed,
                warmup_s=warm_s, scenario_iters_per_s=B * iters / elapsed,
                newton_solves=out["newton_solves"],
                newton_solves_per_s=out["newton_solves"] / elapsed,
                timers=out["timers"], straggler_rounds=prob.straggler_rounds,
                peak_bytes=torch.cuda.max_memory_allocated(device),
                launches=launches, launches_bf16=launches_bf16,
                solve_precision=getattr(cfg, "fused_solve_precision", None),
                adjoint_solve_precision=getattr(
                    cfg, "adjoint_solve_precision", None),
                mean_cost_before=float(ch[0].mean()),
                mean_cost_after=float(ch[-1].mean()),
                mean_cost_history=ch.mean(axis=1).tolist(),
                finite=bool(np.isfinite(ch).all()))
    return (res, ch) if with_costs else res


def check_main_path(res, launched, idle, bf16=()):
    """Finite, falling mean cost; every kernel of the path launched, and
    the kernels of the other paths not; of the cluster march's and sweep's
    wrappers in `bf16`, the bf16 form launched each time, and of the
    others never."""
    fails = [f"{k} never launched" for k in launched
             if res["launches"][k] <= 0]
    fails += [f"{k}: {res['launches_bf16'][k]} of {res['launches'][k]} "
              f"launches on the bf16 form" for k in bf16
              if res["launches_bf16"][k] != res["launches"][k]]
    fails += [f"{k}: {v} launches of the bf16 form" for k, v in
              res["launches_bf16"].items() if v and k not in bf16]
    fails += [f"{k} launched {res['launches'][k]} times" for k in idle
              if res["launches"][k] != 0]
    if not res["finite"] or not res["mean_cost_after"] < res["mean_cost_before"]:
        fails.append("did not descend")
    if fails:
        raise RuntimeError(f"{res['problem']} n={res['n']} B={res['B']}: "
                           + "; ".join(fails) + f" | {res}")


def mode_comparison(torch, device, prob, sc, res, costs, iters):
    """Phases 4h, 5h, 6h: a main path once more at fused_solve_precision
    "highest" (the float32 march) in the same call, after the run at the
    default "bf16x3" (`res`, its cost history `costs`): this run's own
    numbers, and the default run's against them: the Newton-solve and
    rate ratios and the largest relative cost difference, over all
    iterates and at the last (recorded, not gated)."""
    h, ch = pgd_run(torch, device, prob, sc, iters, with_costs=True)
    rel = np.abs(costs - ch) / np.abs(ch)
    h.update(newton_ratio=res["newton_solves"] / h["newton_solves"],
             rate_ratio=res["scenario_iters_per_s"]
             / h["scenario_iters_per_s"],
             max_rel_cost=float(rel.max()),
             max_rel_last_cost=float(rel[-1].max()),
             mean_rel_last_cost=float(rel[-1].mean()))
    return h


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
        # all three at once (each its own interpreter; wall_s from the
        # common start to the command's exit)
        t0 = time.perf_counter()
        procs = {cmd: subprocess.Popen(
            [sys.executable, "-m", "vch_tpu_torch.cli"] + argvs[cmd],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for cmd, _ in CLI_SUBPROCESSES}
        try:
            for cmd, limit in CLI_SUBPROCESSES:
                p = procs[cmd]
                stdout, stderr = p.communicate(timeout=limit)
                lines = stdout.strip().splitlines()
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
                                 f"{stderr[-2000:]}")
                _log(11, "cli " + json.dumps(cs) + f" | {name} | {smi}")
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
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


def side_config4(torch, device, tmp, B=16):
    """Phase 12b: config 4's grid (128x128, T = 1, the one-member kernels),
    B cut from 128 to 16 (the checkpoint's write took 49-53 s at 128):
    checkpoint at 2, resume to 4, against an uninterrupted 4 with metrics;
    then trial_memory_analysis on the host batch, its peak over S and over
    the chooser's estimate."""
    from vch_tpu_torch.parallel.batch import (BatchedProblem2D,
                                              full_memory_estimate_bytes)
    cfg = _config(128)
    host = _bench_sweep(cfg, B)
    prob = BatchedProblem2D(cfg, device=device)
    c = _resume_case(torch, prob, _on_device(torch, device, host), tmp, "c4")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tma = prob.trial_memory_analysis(host)
    S = _traj_bytes(cfg, B, prob.solver.M)
    est = full_memory_estimate_bytes(cfg, B)
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
    solve (forward) and per step (adjoint). Then the inner APIs' call
    forms on the same mesh (grid_call_forms)."""
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
        launches_sharded=sharded_launches,
        call_forms=grid_call_forms(torch, mesh))


def grid_call_forms(torch, mesh, n=31, T=0.05):
    """13b's call forms: GridShardedForward2D.march and
    GridShardedAdjoint2D.run_impl at 32 x 32 (Nx = Ny = 31), T = 0.05,
    float32, on `mesh`'s "gx" dimension (world size 1: a row block is the
    whole field), once on host numpy row blocks (the march's history read
    to the host for the sweep, dts as numpy) and once on CUDA tensors (the
    march's own history, dts a CUDA tensor). Returns the seconds, the
    devices of the outputs and each output's bit equality."""
    from vch_tpu_torch.config import DELTA_SEP
    from vch_tpu_torch.ops.potential import init_phi_random_2d
    from vch_tpu_torch.parallel.spatial import (GridShardedAdjoint2D,
                                                GridShardedForward2D)
    cfg = _config(n, T=T)
    fwd = GridShardedForward2D(cfg, mesh=mesh)
    adj = GridShardedAdjoint2D(cfg, mesh=mesh)
    rng = np.random.default_rng(13)
    shape = (fwd.M + 1, n + 1, n + 1)
    f32 = lambda a: np.asarray(a, np.float32)
    host = dict(u=f32(0.05 * rng.standard_normal(shape)),
                phi0=f32(init_phi_random_2d(n, n, DELTA_SEP, amp=0.1,
                                            seed=42)),
                phi_Q=f32(0.3 * rng.standard_normal(shape)),
                phi_T=f32(0.3 * rng.standard_normal(shape[1:])),
                dts=np.asarray(fwd.dts_np, np.float64))
    out, secs = {}, {}
    for form in ("numpy", "card"):
        a = ({k: torch.as_tensor(v).to(fwd.device) for k, v in host.items()}
             if form == "card" else host)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        phi, ns, bad = fwd.march(a["u"], a["phi0"])
        hist = phi if form == "card" else phi.cpu().numpy()
        p, q, r = adj.run_impl(hist, a["dts"], 5.0, 10.0, a["phi_Q"],
                               a["phi_T"])
        torch.cuda.synchronize()
        secs[form] = time.perf_counter() - t0
        out[form] = dict(march=(phi, ns, bad), adjoint=(p, q, r))
    numpy_out = out["numpy"]["march"] + out["numpy"]["adjoint"]
    return dict(n=n + 1, M=fwd.M, T=T, s=secs,
                newton_solves=int(out["card"]["march"][1]),
                devices=sorted({str(t.device) for t in numpy_out}),
                bits_equal={k: _chain_bits_equal(torch, out["numpy"][k],
                                                 out["card"][k])
                            for k in ("march", "adjoint")})


def check_mesh_grid_solvers(c):
    fails = []
    forms = c["call_forms"]
    fails += [f"call forms: {k} differs between numpy and CUDA inputs"
              for k, v in forms["bits_equal"].items() if not v]
    if any(not d.startswith("cuda") for d in forms["devices"]) or \
            forms["newton_solves"] <= 0:
        fails.append(f"call forms: {forms}")
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


def _sync_count(torch, fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn"): its result and
    how many synchronizing CUDA calls it made."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def _fused_loop(loop):
    """The problem's PGD loop with search_mode="fused"."""
    from vch_tpu_torch.control.pgd import ProximalGradientLoop
    return ProximalGradientLoop(loop.forward, loop.adjoint, loop.cost,
                                loop.opt, settings=loop.s,
                                error_norms=loop.error_norms,
                                search_mode="fused",
                                adjoint_takes_u=loop.adjoint_takes_u)


def fused_config3(torch, device, prob, c3, iters=3):
    """Phase 14a: config 3 in the fused search mode on phase 8's
    ControlProblem2D, from phase 8's starting state: 1 warm-up, then the
    same `iters` timed iterations, launch counts set to 0 just before; the
    members each row-1 launch marched (nonzero nsolve) counted on the
    device; then the host and the fused mode in turns (host, fused, fused,
    host, twice) for their rates in one window; the search alone, with the
    problem's trial at the first iterate, under
    torch.cuda.set_sync_debug_mode("error"); the synchronizing calls of
    one whole iteration of each mode (set_sync_debug_mode("warn")); and one
    idle trial slot (the trial with its member inactive): its host µs,
    enqueued without a sync, and its device ms alone (a CUDA graph)."""
    from vch_tpu_torch.control.pgd import optimistic_backtracking_search
    from vch_tpu_torch.control.prox import calculate_gradient
    from vch_tpu_torch.ops import march as km

    loop, fused = prob.loop, _fused_loop(prob.loop)
    u0, phi0 = prob.initial_control(), prob.phi_hist0
    alpha0 = float(prob.opt_config.alpha_max)

    def run(lp):
        return lp.run(u0, phi0, max_iter=iters, verbose=False)

    fused.run(u0, phi0, max_iter=1, verbose=False)
    marched = []

    def march(*a, **kw):
        out = km.march_fused_2d(*a, **kw)
        marched.append((out[1] > 0).sum())
        return out

    march.__name__ = "march_fused_2d"
    prob.solver.entries = km.KERNELS._replace(march=march)
    try:
        torch.cuda.synchronize()
        km.reset_launches()
        n0 = prob.newton_solves
        t0 = time.perf_counter()
        res = run(fused)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {k: v for k, v in km.launch_counts().items() if v}
        newton = prob.newton_solves - n0
        members = int(torch.stack(marched).sum()) if marched else 0
    finally:
        prob.solver.entries = km.KERNELS
    rates = {}
    for mode, lp in (("host", loop), ("fused", fused), ("fused", fused),
                     ("host", loop)) * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(lp)
        torch.cuda.synchronize()
        rates.setdefault(mode, []).append(iters / (time.perf_counter() - t0))
    r0 = (loop.adjoint(phi0, u0) if loop.adjoint_takes_u
          else loop.adjoint(phi0))
    grad = calculate_gradient(r0, u0, loop.opt.b3)
    cost0 = loop.cost(phi0, u0)
    trial = fused._trial(u0, grad)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        search = optimistic_backtracking_search(trial, cost0, alpha0, loop.s)
        search_error = None
    except RuntimeError as e:
        search_error = str(e)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    search_trials = None if search_error else int(search[4])
    timers = dict.fromkeys(("backward_total", "optimistic_eval_total",
                            "line_search_total", "successful_step_total"),
                           0.0)
    _, syncs_fused = _sync_count(torch, lambda: fused._iteration_fused(
        u0, phi0, cost0, alpha0, timers))
    _, syncs_host = _sync_count(torch, lambda: loop._iteration_host(
        u0, phi0, float(cost0), alpha0, timers))
    alpha = torch.full((), alpha0, dtype=torch.float64, device=device)
    idle = torch.zeros((), dtype=torch.bool, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        trial(alpha, idle)
    slot_host_us = 1e6 * (time.perf_counter() - t0) / 20
    slot_device_ms = graph_ms(lambda: trial(alpha, idle), 20)
    ch, ch8 = np.asarray(res.cost_history), np.asarray(c3["cost_history"])
    return dict(n=prob.solver.config.Nx, M=prob.solver.M, iters=iters,
                slots_per_iter=1 + loop.s.ls_max_trials,
                pgd_iters_per_s=iters / elapsed, elapsed_s=elapsed,
                pgd_iters_per_s_phase8=c3["pgd_iters_per_s"],
                turns_pgd_iters_per_s=rates,
                ls_trials=res.ls_trials_per_iter,
                ls_trials_phase8=c3["ls_trials"],
                alpha_history=res.alpha_history,
                alpha_history_phase8=c3["alpha_history"],
                cost_history=ch.tolist(),
                max_rel_cost_vs_phase8=float(
                    (np.abs(ch - ch8) / np.abs(ch8)).max()),
                newton_solves=newton,
                newton_solves_phase8=c3["newton_solves"],
                launches=launches, members_marched=members,
                timers={k: res.timers[k] for k in timers},
                search_sync_error=search_error, search_trials=search_trials,
                syncs_per_iteration=dict(fused=syncs_fused, host=syncs_host),
                idle_slot=dict(host_us=slot_host_us,
                               device_ms=slot_device_ms),
                finite=bool(np.isfinite(ch).all()))


def check_fused_config3(c):
    """Phase 14a gates: trials and alphas those of phase 8's host run, the
    costs within 1e-6 relative, the Newton solves equal; row 1 launched
    once a slot (1 + ls_max_trials an iteration), of which exactly the
    searching trials marched, the adjoint kernel M times an iteration and
    nothing else; the search alone made no host read; the timers at 0."""
    fails = []
    if c["ls_trials"] != c["ls_trials_phase8"]:
        fails.append(f"trials {c['ls_trials']} vs {c['ls_trials_phase8']}")
    if c["alpha_history"] != c["alpha_history_phase8"]:
        fails.append("alphas differ from phase 8's")
    if not c["finite"] or c["max_rel_cost_vs_phase8"] > 1e-6:
        fails.append(f"costs vs phase 8 {c['max_rel_cost_vs_phase8']}")
    if c["newton_solves"] != c["newton_solves_phase8"]:
        fails.append(f"Newton solves {c['newton_solves']} vs "
                     f"{c['newton_solves_phase8']}")
    want = {"march_fused_2d": c["slots_per_iter"] * c["iters"],
            "bicgstab_adjoint_spectral": c["M"] * c["iters"]}
    if c["launches"] != want:
        fails.append(f"launches {c['launches']}, expected {want}")
    if c["members_marched"] != sum(c["ls_trials"]):
        fails.append(f"{c['members_marched']} members marched, expected "
                     f"{sum(c['ls_trials'])}")
    if c["search_sync_error"] is not None:
        fails.append(f"the search read the host: {c['search_sync_error']}")
    if any(c["timers"].values()):
        fails.append(f"phase timers {c['timers']}")
    if fails:
        raise RuntimeError("phase 14a: " + "; ".join(fails) + f" | {c}")


def fused_config1(torch, device, iters=3):
    """Phase 14b: config 1 (ControlProblem1D, float32, N = 128, M = 100)
    on the card, `iters` iterations in the host mode, then in the fused
    mode, from one constructor (no kernel on this path: the per-step
    marcher, its idle trial slots marching no member)."""
    from vch_tpu_torch.config import ForwardSolverConfig1D
    from vch_tpu_torch.control.problems import ControlProblem1D
    from vch_tpu_torch.ops import march as km

    prob = ControlProblem1D(ForwardSolverConfig1D(dtype="float32"),
                            device=device)
    runs = {}
    for mode, lp in (("host", prob.loop), ("fused", _fused_loop(prob.loop))):
        torch.cuda.synchronize()
        km.reset_launches()
        n0 = prob.newton_solves
        t0 = time.perf_counter()
        res = lp.run(prob.initial_control(), prob.phi_hist0, max_iter=iters,
                     verbose=False)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        runs[mode] = dict(
            pgd_iters_per_s=iters / elapsed, elapsed_s=elapsed,
            ls_trials=res.ls_trials_per_iter,
            alpha_history=res.alpha_history,
            cost_history=res.cost_history,
            newton_solves=prob.newton_solves - n0,
            launches={k: v for k, v in km.launch_counts().items() if v})
    h, f = runs["host"], runs["fused"]
    ch, cf = np.asarray(h["cost_history"]), np.asarray(f["cost_history"])
    full = 1 + prob.loop.s.ls_max_trials
    return dict(N=prob.fwd_config.N, M=prob.solver.M, iters=iters,
                host=h, fused=f,
                max_rel_cost=float((np.abs(cf - ch) / np.abs(ch)).max()),
                failed_iterations=[k for k, n in enumerate(f["ls_trials"])
                                   if n == full and not cf[k + 1] < cf[k]],
                device=str(prob.phi_hist0.device),
                finite=bool(np.isfinite(cf).all()))


def check_fused_config1(c):
    """Phase 14b gates: trials and alphas equal, costs within 1e-6
    relative, the Newton solves equal; every iteration whose trials all
    failed keeps its last, worse iterate (the cost rises), as vch_tpu's
    fused mode does and the host mode under keep_failed_step; no kernel
    launched; on the card."""
    h, f = c["host"], c["fused"]
    fails = []
    for k in ("ls_trials", "alpha_history", "newton_solves"):
        if h[k] != f[k]:
            fails.append(f"{k}: host {h[k]}, fused {f[k]}")
    if not c["finite"] or c["max_rel_cost"] > 1e-6:
        fails.append(f"costs {c['max_rel_cost']}")
    cf = f["cost_history"]
    if any(not cf[k + 1] > cf[k] for k in c["failed_iterations"]):
        fails.append("a failed iteration did not keep its worse iterate")
    for run in (h, f):
        if run["launches"]:
            fails.append(f"launched {run['launches']}")
    if not c["device"].startswith("cuda"):
        fails.append(f"ran on {c['device']}")
    if fails:
        raise RuntimeError("phase 14b: " + "; ".join(fails) + f" | {c}")


def row1_flag_case(torch, device, reps=20):
    """Phase 14c: row 1 (`march_fused_2d`) with the per-member flag. At
    phase 2's n = 65, B = 4, T = 0.1, flags [1, 0, 1, 0]: the active
    members bit for bit the launch without a flag and its one-CTA oracle,
    the inactive ones nsolve 0 and first_bad -1. At config 4's n = 129,
    B = 128, M = 100, all ones: bit for bit the launch without a flag, both
    timed in turns (CUDA events). At config 3's n = 65, B = 1, M = 100 (an
    idle trial slot): one idle launch's CUDA-event ms over `reps` launches
    and on the device alone (a CUDA graph of `reps` launches), the host µs
    of the wrapper a call (enqueued without a sync), and one active
    launch's ms."""
    from vch_tpu_torch.ops import march as km

    out = {}
    fwd, args = _seeded_march(torch, device, 65, 4, 0.1)
    kw = fwd._march_kw()
    flags = [1, 0, 1, 0]
    act = torch.tensor(flags, dtype=torch.int32, device=device)
    ref = km.march_fused_2d(*args, **kw)
    oracle = km._march_fused_2d_cta(*args, **kw)
    got = km.march_fused_2d(*args, active=act, **kw)
    torch.cuda.synchronize()
    out["n65_b4"] = dict(
        flags=flags,
        active_equal=all(torch.equal(g[b], r[b]) and torch.equal(g[b], o[b])
                         for b, on in enumerate(flags) if on
                         for g, r, o in zip(got, ref, oracle)),
        inactive_nsolve=[int(got[1][b]) for b, on in enumerate(flags)
                         if not on],
        inactive_bad=[int(got[2][b]) for b, on in enumerate(flags)
                      if not on])
    del fwd, args, ref, oracle, got
    fwd, args = _seeded_march(torch, device, 129, 128, 1.0)
    kw = fwd._march_kw()
    ones = torch.ones(128, dtype=torch.int32, device=device)
    plain = lambda: km.march_fused_2d(*args, **kw)
    flag = lambda: km.march_fused_2d(*args, active=ones, **kw)
    a, b = plain(), flag()
    torch.cuda.synchronize()
    t = _turns(plain, flag, 1)
    out["n129_b128"] = dict(bits_equal=all(torch.equal(x, y)
                                           for x, y in zip(a, b)),
                            ms_without_flag=t["old_ms"],
                            ms_all_ones=t["new_ms"],
                            ratio=float(np.mean(t["new_ms"])
                                        / np.mean(t["old_ms"])))
    del fwd, args, a, b
    fwd, args = _seeded_march(torch, device, 65, 1, 1.0)
    kw = fwd._march_kw()
    idle = torch.zeros(1, dtype=torch.int32, device=device)
    on = torch.ones(1, dtype=torch.int32, device=device)
    idle_ms = time_ms(lambda: km.march_fused_2d(*args, active=idle, **kw),
                      reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        km.march_fused_2d(*args, active=idle, **kw)
    host_us = 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    out["n65_b1_idle"] = dict(
        idle_ms=idle_ms, wrapper_host_us=host_us,
        idle_device_ms=graph_ms(
            lambda: km.march_fused_2d(*args, active=idle, **kw), reps),
        active_ms=time_ms(lambda: km.march_fused_2d(*args, active=on, **kw),
                          1))
    return out


def check_row1_flag(c):
    """Phase 14c gates: active members bit for bit, inactive ones nsolve 0
    and first_bad -1; all ones bit for bit the launch without a flag and
    within 2% of its time."""
    a, b = c["n65_b4"], c["n129_b128"]
    fails = []
    if not a["active_equal"]:
        fails.append("active members differ from the launch without a flag")
    if any(a["inactive_nsolve"]) or any(x != -1 for x in a["inactive_bad"]):
        fails.append("an inactive member solved or was flagged bad")
    if not b["bits_equal"]:
        fails.append("all ones differ from the launch without a flag")
    if abs(b["ratio"] - 1.0) > 0.02:
        fails.append(f"all ones took {b['ratio']} of the time without a flag")
    if fails:
        raise RuntimeError("phase 14c: " + "; ".join(fails) + f" | {c}")


def fused_phase(device=None, name=None, smi=None, prob=None, c3=None):
    """Phase 14, the fused line search: (a) config 3 on phase 8's problem,
    (b) config 1, (c) row 1 with the per-member flag; each logged, then
    gated. Alone on the card (phase 8 first, for its problem and its host
    figures): `python -c "import chip_smoke; chip_smoke.fused_phase()"`.
    Returns row 1's launches in 14a by entry."""
    import torch
    if device is None:
        device, name, smi = (torch.device("cuda", 0),
                             torch.cuda.get_device_name(0), _smi())
    if prob is None:
        c3, prob = config3_run(torch, device)
        _log(8, json.dumps(c3) + f" | {name} | {smi}")
        check_config3(c3)
    t0 = time.perf_counter()
    a = fused_config3(torch, device, prob, c3)
    _log("14a", json.dumps(a) + f" | {name} | {smi}")
    check_fused_config3(a)
    b = fused_config1(torch, device)
    _log("14b", json.dumps(b) + " | no kernel on this path, as in vch_tpu "
         f"| {name} | {smi}")
    check_fused_config1(b)
    c = row1_flag_case(torch, device)
    _log("14c", json.dumps(c) + f" | {name} | {smi}")
    check_row1_flag(c)
    _log(14, f"{time.perf_counter() - t0:.1f} s")
    return a["launches"]

# phase 15a: float32 against the stencil, relative to the largest stencil
# value: each output adds three products of up to 4|v|/h^2, which the two
# forms round apart by a few float32 ulps (~1e-7); float64 likewise at
# 1e-12. A call that hands the solvers' helper Ly where it takes Ly^T (the
# fault C3 was that call under the public name) must be this far off.
LAP_F32_REL = 1e-5
LAP_F64_REL = 1e-12
LAP_WRONG_FORM_REL = 0.1


def surface_laplacian_case(torch, device, shapes=(65, 129), B=4):
    """Phase 15a: the public `apply_laplacian_2d(Lx, Ly, v)` from
    `vch_tpu_torch.ops` in vch_tpu's call form on the card, at n = 65 and
    129, B = 4 seeded fields, float32 and float64, against
    `stencil_laplacian_2d` on the same fields; and the solvers' helper
    `apply_laplacian_2d_t` handed Ly untransposed, for the size of the
    fault it repairs."""
    from vch_tpu_torch.ops import (apply_laplacian_2d,
                                   laplacian_matrix_neumann,
                                   stencil_laplacian_2d)
    from vch_tpu_torch.ops.laplacian import apply_laplacian_2d_t

    out = []
    for n in shapes:
        h = 1.0 / (n - 1)
        L = laplacian_matrix_neumann(n - 1, h)
        v = torch.randn((B, n, n), dtype=torch.float64, device=device,
                        generator=torch.Generator(device).manual_seed(n))
        got = {}
        for dt in (torch.float32, torch.float64):
            Lt, vt = torch.as_tensor(L, dtype=dt, device=device), v.to(dt)
            got[dt] = (apply_laplacian_2d(Lt, Lt, vt),
                       stencil_laplacian_2d(vt, h, h))
        L64 = torch.as_tensor(L, device=device)
        wrong = apply_laplacian_2d_t(L64, L64, v)
        (a32, s32), (a64, s64) = got[torch.float32], got[torch.float64]
        scale = float(s64.abs().max())
        rel = lambda a, b: float((a.double() - b.double()).abs().max()) \
            / scale
        out.append(dict(
            n=n, B=B, f32_vs_stencil=rel(a32, s32),
            f32_vs_f64_stencil=rel(a32, s64), f64_vs_stencil=rel(a64, s64),
            ly_untransposed_vs_stencil=rel(wrong, s64),
            ly_symmetric=bool(np.array_equal(L, L.T)),
            finite=bool(torch.isfinite(a32).all())))
    return out


def check_surface_laplacian(cases):
    """Phase 15a gates: finite; float32 within LAP_F32_REL of the stencil
    and of float64's, float64 within LAP_F64_REL; Ly untransposed in the
    helper at least LAP_WRONG_FORM_REL off (so the gate can see the
    fault)."""
    fails = []
    for c in cases:
        if not c["finite"]:
            fails.append(f"n={c['n']}: not finite")
        if max(c["f32_vs_stencil"], c["f32_vs_f64_stencil"]) > LAP_F32_REL:
            fails.append(f"n={c['n']}: float32 {c['f32_vs_stencil']}, "
                         f"{c['f32_vs_f64_stencil']} > {LAP_F32_REL}")
        if c["f64_vs_stencil"] > LAP_F64_REL:
            fails.append(f"n={c['n']}: float64 {c['f64_vs_stencil']}")
        if c["ly_untransposed_vs_stencil"] < LAP_WRONG_FORM_REL:
            fails.append(f"n={c['n']}: Ly untransposed only "
                         f"{c['ly_untransposed_vs_stencil']} off")
    if fails:
        raise RuntimeError("phase 15a: " + "; ".join(fails) + f" | {cases}")


def surface_pgd_case(torch, device, c3, iters=2):
    """Phase 15b: config 3 (64x64, T = 1, float32, newton_tol 2e-4, the 2D
    optimizer defaults) built as a vch_tpu user builds it, from the
    package namespaces only (`vch_tpu_torch`, `vch_tpu_torch.models`,
    `vch_tpu_torch.control`): the solvers, the baseline march, the targets,
    and a ProximalGradientLoop over forward u -> phi_hist (row 1 at B = 1),
    adjoint phi_hist -> r (vch_tpu's contract: no adjoint_takes_u; the
    public `AdjointSolver2D.run` on the trajectory as the loop holds it on
    the card, with simulate's t_hist: the per-step sweep on row 9) and the
    cost; `iters` iterations in the host
    mode, then in the fused mode (whose forward takes no `active`, so every
    trial slot marches), launch counts set to 0 just before each of the
    three and read just after."""
    from vch_tpu_torch import ForwardSolverConfig2D, OptimizationConfig
    from vch_tpu_torch.control import build_targets_2d, calculate_cost_2d
    from vch_tpu_torch.control.pgd import PGDSettings, ProximalGradientLoop
    from vch_tpu_torch.models import AdjointSolver2D, ForwardSolver2D
    from vch_tpu_torch.ops import march as km

    cfg = ForwardSolverConfig2D(Nx=64, Ny=64, T=1.0, dtype="float32",
                                newton_tol=2e-4)
    opt = OptimizationConfig.defaults_2d()
    windows = {}

    def window(name, fn):
        torch.cuda.synchronize()
        km.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        windows[name] = dict(s=time.perf_counter() - t0, launches={
            k: v for k, v in km.launch_counts().items() if v})
        return out

    def build():
        solver = ForwardSolver2D(cfg, device=device)
        adj = AdjointSolver2D(cfg, device=device)
        phi0 = solver.default_initial_phi()
        return solver, adj, phi0, solver.simulate(initial_phi=phi0)

    solver, adj, phi0, (phi_hist, (x, y), t_hist) = window("constructor",
                                                           build)
    windows["constructor"]["newton_solves"] = \
        solver.last_stats.newton_solves
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=solver.dtype,
                                     device=device)
    phi_T, phi_Q = (as_t(a) for a in build_targets_2d(
        x, y, t_hist, phi_hist[0].cpu().numpy(), float(cfg.Lx),
        float(cfg.Ly), float(cfg.T)))
    xs, ys, ts, phi0_d = (as_t(a) for a in (x, y, t_hist, phi0))

    def forward(u):
        return solver.march_fused_batch(u[None], phi0_d[None])[0][0]

    def adjoint(phi):
        return adj.run(phi, t_hist, opt.b1, opt.b2, phi_Q, phi_T)[2]

    def cost(phi, u):
        return calculate_cost_2d(phi, u, phi_Q, phi_T, xs, ys, ts, opt.b1,
                                 opt.b2, opt.b3, opt.kappa_sparsity)

    runs, results = {}, {}
    for mode in ("host", "fused"):
        loop = ProximalGradientLoop(forward, adjoint, cost, opt,
                                    settings=PGDSettings.defaults_2d(),
                                    search_mode=mode)
        res = results[mode] = window(
            mode, lambda: loop.run(torch.zeros_like(phi_hist), phi_hist,
                                   max_iter=iters, verbose=False))
        ch, ch8 = (np.asarray(res.cost_history),
                   np.asarray(c3["cost_history"][:iters + 1]))
        runs[mode] = dict(
            cost_history=ch.tolist(), ls_trials=res.ls_trials_per_iter,
            alpha_history=res.alpha_history,
            costs_equal_phase8=bool(np.array_equal(ch, ch8)),
            max_rel_cost_vs_phase8=float((np.abs(ch - ch8)
                                          / np.abs(ch8)).max()),
            adjoint_takes_u=loop.adjoint_takes_u,
            pgd_iters_per_s=iters / windows[mode]["s"],
            finite=bool(np.isfinite(ch).all()))
    return dict(n=cfg.Nx, M=solver.M, iters=iters,
                slots_per_iter=1 + PGDSettings.defaults_2d().ls_max_trials,
                ls_trials_phase8=c3["ls_trials"][:iters],
                alpha_history_phase8=c3["alpha_history"][:iters],
                constructor_newton_solves=windows["constructor"][
                    "newton_solves"],
                constructor_newton_solves_phase8=c3[
                    "constructor_newton_solves"],
                seconds={k: v["s"] for k, v in windows.items()},
                launches={k: v["launches"] for k, v in windows.items()},
                runs=runs), results["host"]


def check_surface_pgd(c):
    """Phase 15b gates: the constructor's Newton solves phase 8's, each on
    the spectral Schur kernel; in both modes trials and alphas phase 8's
    first `iters`, and the host mode's costs phase 8's bit for bit (the
    fused mode's within 1e-6, phase 14a's gate); the adjoint called without
    u; row 1 once a trial (host) or a slot (fused), row 9 M times an
    iteration, and nothing else."""
    fails = []
    if c["constructor_newton_solves"] != c["constructor_newton_solves_phase8"]:
        fails.append(f"constructor Newton solves "
                     f"{c['constructor_newton_solves']} vs "
                     f"{c['constructor_newton_solves_phase8']}")
    want = {"constructor": {"bicgstab_schur_spectral":
                            c["constructor_newton_solves"]}}
    for mode, r in c["runs"].items():
        if r["ls_trials"] != c["ls_trials_phase8"]:
            fails.append(f"{mode}: trials {r['ls_trials']} vs "
                         f"{c['ls_trials_phase8']}")
        if r["alpha_history"] != c["alpha_history_phase8"]:
            fails.append(f"{mode}: alphas {r['alpha_history']} vs "
                         f"{c['alpha_history_phase8']}")
        if not r["finite"] or (not r["costs_equal_phase8"] if mode == "host"
                               else r["max_rel_cost_vs_phase8"] > 1e-6):
            fails.append(f"{mode}: costs {r['cost_history']} vs phase 8's "
                         f"({r['max_rel_cost_vs_phase8']})")
        if r["adjoint_takes_u"]:
            fails.append(f"{mode}: the loop passes u to the adjoint")
        trials = (sum(r["ls_trials"]) if mode == "host"
                  else c["slots_per_iter"] * c["iters"])
        want[mode] = {"march_fused_2d": trials,
                      "bicgstab_adjoint_spectral": c["M"] * c["iters"]}
    for window, w in want.items():
        if c["launches"][window] != w:
            fails.append(f"{window}: launches {c['launches'][window]}, "
                         f"expected {w}")
    if fails:
        raise RuntimeError("phase 15b: " + "; ".join(fails) + f" | {c}")


def surface_probe_case(torch, device, prob, res, D=5):
    """Phase 15c: the coercivity probe of phase 8's problem at 15b's host
    result, with vch_tpu's one-control `forward` (D one-member marches of
    row 1) against the problem's `second_order_check` (forward_batch=: one
    march of D members, phase 8's gated count), in turns (forward, batch,
    batch, forward), launch counts set to 0 just before each call and read
    just after; the seconds of each call, its launches of the last call,
    and the estimates of each."""
    from vch_tpu_torch.control.diagnostics import \
        approximate_second_order_condition
    from vch_tpu_torch.ops import march as km

    opt = prob.opt_config
    calls = {
        "forward": lambda: approximate_second_order_condition(
            prob.loop.forward, prob.loop.cost, res.u_optimal,
            res.r_optimal, res.phi_final, opt.b3, opt.kappa_sparsity,
            opt.u_min, opt.u_max, num_directions=D, epsilon=1e-4, seed=42,
            handle_kink=False, dtype=prob.dtype, device=device),
        "forward_batch": lambda: prob.second_order_check(
            res, num_directions=D)}
    out = {k: dict(s=[], d2=None, launches=None) for k in calls}
    for mode in ("forward", "forward_batch", "forward_batch", "forward"):
        torch.cuda.synchronize()
        km.reset_launches()
        t0 = time.perf_counter()
        d2 = calls[mode]()
        torch.cuda.synchronize()
        out[mode]["s"].append(time.perf_counter() - t0)
        out[mode]["launches"] = {k: v for k, v in km.launch_counts().items()
                                 if v}
        out[mode]["d2"] = [float(v) for v in d2]
    a, b = (np.asarray(out[k]["d2"]) for k in calls)
    return dict(n=prob.solver.config.Nx, M=prob.solver.M, directions=D,
                calls=out, max_rel_d2=float(np.abs(a - b).max()
                                            / np.abs(b).max()),
                batch_over_forward_s=min(out["forward_batch"]["s"])
                / min(out["forward"]["s"]))


def check_surface_probe(c):
    """Phase 15c gates: D launches of row 1 with `forward`, one with the
    batch, nothing else; finite estimates."""
    want = {"forward": {"march_fused_2d": c["directions"]},
            "forward_batch": {"march_fused_2d": 1}}
    fails = [f"{k}: launches {c['calls'][k]['launches']}, expected {w}"
             for k, w in want.items() if c["calls"][k]["launches"] != w]
    fails += [f"{k}: non-finite estimates {r['d2']}"
              for k, r in c["calls"].items()
              if not np.isfinite(r["d2"]).all()]
    if fails:
        raise RuntimeError("phase 15c: " + "; ".join(fails) + f" | {c}")


def surface_phase(device=None, name=None, smi=None, c3=None, prob=None):
    """Phase 15, the public surface on vch_tpu's contracts: (a) the public
    Laplacian, (b) config 3 through the package namespaces and vch_tpu's
    adjoint contract against phase 8, (c) the coercivity probe with
    vch_tpu's one-control forward against phase 8's batched call; each
    logged, then gated. Alone on the card (phase 8 first, for its figures
    and problem): `python -c "import chip_smoke;
    chip_smoke.surface_phase()"`. Returns the kernels' launches in 15b and
    15c by entry, their windows summed."""
    import torch
    if device is None:
        device, name, smi = (torch.device("cuda", 0),
                             torch.cuda.get_device_name(0), _smi())
    if c3 is None or prob is None:
        c3, prob = config3_run(torch, device)
        _log(8, json.dumps(c3) + f" | {name} | {smi}")
        check_config3(c3)
    t0 = time.perf_counter()
    a = surface_laplacian_case(torch, device)
    _log("15a", json.dumps(a) + " | no kernel: two products and the "
         f"stencil in PyTorch | {name} | {smi}")
    check_surface_laplacian(a)
    b, res = surface_pgd_case(torch, device, c3)
    _log("15b", json.dumps(b) + f" | {name} | {smi}")
    check_surface_pgd(b)
    p = surface_probe_case(torch, device, prob, res)
    _log("15c", json.dumps(p) + f" | {name} | {smi}")
    check_surface_probe(p)
    _log(15, f"{time.perf_counter() - t0:.1f} s")
    launches = {}
    for w in (list(b["launches"].values())
              + [r["launches"] for r in p["calls"].values()]):
        for k, v in w.items():
            launches[k] = launches.get(k, 0) + v
    return launches


def _chain_leaves(torch, out):
    """The arrays of a chain's results, in order, on the host."""
    if isinstance(out, dict):
        return [a for k in sorted(out) for a in _chain_leaves(torch, out[k])]
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _chain_leaves(torch, o)]
    if torch.is_tensor(out):
        return [out.detach().cpu().numpy()]
    return [np.asarray(out)]


def _chain_bits_equal(torch, a, b):
    la, lb = _chain_leaves(torch, a), _chain_leaves(torch, b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and np.array_equal(x, y, equal_nan=x.dtype.kind == "f")
        for x, y in zip(la, lb))


def chain_case(torch, device, dim):
    """Phase 16, one grid: vch_tpu's forward -> adjoint -> cost ->
    sparsity chain through public entry points only, in float32, at config
    3's 64 x 64 grid (dim 2) or config 1's N = 128 (dim 1; M = 100 in
    both). Run twice, launch counts set to 0 just before each run and read
    just after: from host numpy inputs (`simulate(control=<numpy>)`, `run`
    on the history read to the host, the numpy targets and t_hist,
    `verify_sparsity_condition` on numpy u and r) and from the card's
    tensors (`simulate(control=<CUDA tensor>)`, its phi_hist straight into
    `run` with a CUDA t_hist and CUDA targets, the targets built from
    phi_hist[0] on the card, `verify_sparsity_condition` on CUDA u and r).
    The cost takes numpy grids in both. In 1D, `newton_1d` on one member's
    (N+1,) fields follows (the first frame, the dense Schur path with the
    float32 exits), and against its batch of one. Returns the
    figures and each stage's bit equality between the two runs."""
    from vch_tpu_torch import ForwardSolverConfig1D
    from vch_tpu_torch.config import DELTA_SEP, OptimizationConfig
    from vch_tpu_torch.control import (build_targets_1d, build_targets_2d,
                                       calculate_cost_1d, calculate_cost_2d)
    from vch_tpu_torch.control.diagnostics import verify_sparsity_condition
    from vch_tpu_torch.models import (AdjointSolver1D, AdjointSolver2D,
                                      ForwardSolver1D, ForwardSolver2D)
    from vch_tpu_torch.models.forward1d import newton_1d
    from vch_tpu_torch.ops import march as km

    if dim == 2:
        cfg, opt = _config(64), OptimizationConfig.defaults_2d()
        solver = ForwardSolver2D(cfg, device=device)
        adj = AdjointSolver2D(cfg, device=device)
        xx, yy = np.meshgrid(solver.x, solver.y, indexing="ij")
        space = 0.3 * np.sin(2 * np.pi * xx) * np.cos(np.pi * yy)
    else:
        cfg = ForwardSolverConfig1D(dtype="float32")
        opt = OptimizationConfig.defaults_1d()
        solver = ForwardSolver1D(cfg, device=device)
        adj = AdjointSolver1D(cfg, device=device)
        space = 0.3 * np.sin(2 * np.pi * solver.x)
    ramp = np.linspace(0.0, 1.0, solver.M + 1)
    u_np = (ramp.reshape((-1,) + (1,) * space.ndim) * space).astype(
        np.float32)
    on_card = lambda a: torch.as_tensor(a).to(device)

    def targets(x_grid, t_hist, phi_first):
        if dim == 2:
            return build_targets_2d(x_grid[0], x_grid[1], t_hist, phi_first,
                                    float(cfg.Lx), float(cfg.Ly),
                                    float(cfg.T))
        return build_targets_1d(x_grid, t_hist, phi_first, float(cfg.Lx),
                                float(cfg.T))

    def cost(phi_hist, u, phi_Q, phi_T, x_grid, t_hist):
        grids = tuple(x_grid) if dim == 2 else (x_grid,)
        fn = calculate_cost_2d if dim == 2 else calculate_cost_1d
        return fn(phi_hist, u, phi_Q, phi_T, *grids, t_hist, opt.b1, opt.b2,
                  opt.b3, opt.kappa_sparsity)

    def chain(form):
        card = form == "card"
        u = on_card(u_np) if card else u_np
        phi_hist, x_grid, t_hist = solver.simulate(control=u)
        newton = solver.last_stats.newton_solves
        first = phi_hist[0] if card else phi_hist[0].cpu().numpy()
        phi_T, phi_Q = targets(x_grid, t_hist, first)
        t_in = on_card(t_hist) if card else t_hist
        tgt = (on_card(phi_Q), on_card(phi_T)) if card else (phi_Q, phi_T)
        hist_in = phi_hist if card else phi_hist.cpu().numpy()
        p, q, r = adj.run(hist_in, t_in, opt.b1, opt.b2, *tgt)
        J = cost(phi_hist, on_card(u_np), on_card(phi_Q).float(),
                 on_card(phi_T).float(), x_grid, t_hist)
        u_s, r_s = (on_card(u_np), r) if card else (u_np, r.cpu().numpy())
        sparsity = verify_sparsity_condition(u_s, r_s, opt.kappa_sparsity,
                                             verbose=False)
        out = dict(phi_hist=phi_hist, newton_solves=newton, targets=(phi_T,
                   phi_Q), adjoint=(p, q, r), cost=J, sparsity=sparsity)
        if dim == 1:
            w0 = torch.zeros_like(phi_hist[0])
            mu0 = solver.initialize_mu(phi_hist[0] if card else
                                       phi_hist[0].cpu().numpy(),
                                       w0 if card else np.zeros(cfg.N + 1))
            w1 = on_card(0.05 * u_np[1]) if card else torch.as_tensor(
                0.05 * u_np[1], device=device)
            kw = dict(tau=cfg.tau, c1=cfg.c1, c2=cfg.c2, kappa=cfg.kappa,
                      delta_sep=DELTA_SEP, tol=cfg.newton_tol,
                      max_iter=cfg.newton_max_iter, rtol=cfg.newton_rtol,
                      stagnation_exit=True, record_history=True,
                      return_iters=True)
            out["newton_1d"] = newton_1d(solver.L, phi_hist[0], mu0, w0, w1,
                                         cfg.dt_initial, **kw)
            out["newton_1d_batch"] = newton_1d(
                solver.L, phi_hist[0][None], mu0[None], w0[None], w1[None],
                cfg.dt_initial, **kw)
        return out

    runs, out = {}, {}
    for form in ("numpy", "card"):
        torch.cuda.synchronize()
        km.reset_launches()
        t0 = time.perf_counter()
        out[form] = chain(form)
        torch.cuda.synchronize()
        runs[form] = dict(s=time.perf_counter() - t0, launches={
            k: v for k, v in km.launch_counts().items() if v})
    a, b = out["numpy"], out["card"]
    equal = {k: _chain_bits_equal(torch, a[k], b[k]) for k in a
             if k != "newton_1d_batch"}
    res = dict(dim=dim, n=(cfg.Nx if dim == 2 else cfg.N), M=solver.M,
               dtype=cfg.dtype, runs=runs, bits_equal=equal,
               newton_solves=a["newton_solves"], cost=float(a["cost"]),
               sparsity={k: float(v) for k, v in a["sparsity"].items()},
               finite=bool(all(np.isfinite(x).all() for k in
                               ("phi_hist", "adjoint", "cost")
                               for x in _chain_leaves(torch, b[k]))),
               devices=sorted({str(x.device) for x in
                               (b["phi_hist"],) + tuple(b["adjoint"])}))
    if dim == 1:
        one, batch = b["newton_1d"], b["newton_1d_batch"]
        res["newton_1d"] = dict(
            max_iter=cfg.newton_max_iter, shapes=[list(x.shape) for x in one],
            solves=int(one[3]),
            equals_batch_of_one=bool(all(
                torch.equal(torch.nan_to_num(x), torch.nan_to_num(y[0]))
                for x, y in zip(one, batch))))
    return res


def check_chain(c):
    """Phase 16 gates: every stage of the card run bit for bit the numpy
    run's; finite, on the card; launches (the same in both runs): config
    3's grid row 8 once a Newton solve and row 9 M times, nothing else;
    config 1's grid none (the per-step marcher and sweep in PyTorch, as
    phase 10); newton_1d's one-member form its batch of one, bit for bit,
    with vch_tpu's shapes."""
    fails = [f"{k} differs between numpy and card inputs"
             for k, v in c["bits_equal"].items() if not v]
    if not c["finite"]:
        fails.append("not finite")
    if any(not d.startswith("cuda") for d in c["devices"]):
        fails.append(f"ran on {c['devices']}")
    want = ({"bicgstab_schur_spectral": c["newton_solves"],
             "bicgstab_adjoint_spectral": c["M"]} if c["dim"] == 2 else {})
    for form, r in c["runs"].items():
        if r["launches"] != want:
            fails.append(f"{form}: launches {r['launches']}, expected "
                         f"{want}")
    if c["dim"] == 1:
        nt = c["newton_1d"]
        n = c["n"] + 1
        if nt["shapes"] != [[n], [n], [nt["max_iter"] + 1], []] \
                or not nt["equals_batch_of_one"] or nt["solves"] < 1:
            fails.append(f"newton_1d one member: {nt}")
    if fails:
        raise RuntimeError("phase 16: " + "; ".join(fails) + f" | {c}")


SWEEP_FIELDS = ("phi0", "phi_T", "phi_Q", "b1", "b2", "b3", "kappa_spar")


def sweep_case(torch, device, iters=2):
    """Phase 16c: sweep_2d at config 3's 64 x 64 grid with b3_values and
    kappa_values as CUDA tensors of 2 values each (B = 4) against the same
    sweep from lists, then `iters` PGD iterations of
    BatchedProblem2D(...).run on each, and on the same batch with every
    array a CUDA tensor; launch counts set to 0 just before each run and
    read just after. Then trial_memory_analysis on the list batch and on
    the tensor batch, and prewarm on the tensor batch (straggler_batch=2,
    so that it has a bucket to run). Returns the figures and the bit
    equalities with the list-valued run."""
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.parallel.batch import BatchedProblem2D, sweep_2d
    cfg = _config(64)
    values = dict(b3_values=[1e-4, 2e-4], kappa_values=[5e-5, 1e-4])
    on_card = lambda v: torch.tensor(v, dtype=torch.float64, device=device)
    batches = {"list": sweep_2d(cfg, **values),
               "card_values": sweep_2d(cfg, **{k: on_card(v) for k, v in
                                               values.items()})}
    batches["card_batch"] = dataclasses.replace(batches["card_values"], **{
        f: torch.as_tensor(getattr(batches["card_values"], f)).to(device)
        for f in SWEEP_FIELDS})
    fields = lambda sc: [getattr(sc, f) for f in SWEEP_FIELDS] + [
        sc.u_min, sc.u_max]
    prob = BatchedProblem2D(cfg, device=device)
    runs, out = {}, {}
    for form, sc in batches.items():
        torch.cuda.synchronize()
        km.reset_launches()
        t0 = time.perf_counter()
        o = prob.run(sc, max_iter=iters, verbose=False)
        torch.cuda.synchronize()
        runs[form] = dict(s=time.perf_counter() - t0, launches={
            k: v for k, v in km.launch_counts().items() if v})
        out[form] = {k: o[k] for k in ("cost_history", "ls_trials", "alpha",
                                       "newton_solves", "u")}
    memory = {form: prob.trial_memory_analysis(batches[form])
              for form in ("list", "card_batch")}
    warm = BatchedProblem2D(cfg, device=device, straggler_batch=2)
    km.reset_launches()
    t0 = time.perf_counter()
    warm.prewarm(batches["card_batch"])
    torch.cuda.synchronize()
    prewarm = dict(s=time.perf_counter() - t0, launches={
        k: v for k, v in km.launch_counts().items() if v})
    base = out["list"]
    return dict(
        n=cfg.Nx, M=prob.solver.M, B=batches["list"].batch, iters=iters,
        sweep_bits_equal=_chain_bits_equal(
            torch, fields(batches["list"]), fields(batches["card_values"])),
        run_bits_equal={form: {k: _chain_bits_equal(torch, base[k], o[k])
                               for k in base}
                        for form, o in out.items() if form != "list"},
        runs=runs, newton_solves=int(base["newton_solves"]),
        trials=np.asarray(base["ls_trials"]).tolist(),
        cost=np.asarray(base["cost_history"])[-1].tolist(),
        finite=bool(np.isfinite(base["cost_history"]).all()),
        trial_memory=memory, prewarm=prewarm)


def check_sweep_case(c):
    """Phase 16c gates: the sweep from CUDA values the list sweep's bit for
    bit; each run from them and from the CUDA batch the list run's bit for
    bit (costs, trials, alphas, Newton solves, u), finite, with the same
    kernels launched (some); the trial's argument and output bytes equal
    on both batches; prewarm launched a kernel."""
    fails = [] if c["sweep_bits_equal"] else ["sweep from CUDA values"]
    fails += [f"{form}: {k} differs from the list run"
              for form, eq in c["run_bits_equal"].items()
              for k, v in eq.items() if not v]
    if not c["finite"]:
        fails.append("not finite")
    launches = [r["launches"] for r in c["runs"].values()]
    if not launches[0] or any(lc != launches[0] for lc in launches):
        fails.append(f"launches {launches}")
    mem = c["trial_memory"]
    keys = ("argument_size_in_bytes", "output_size_in_bytes")
    if any(m is None for m in mem.values()) or len(
            {tuple(m[k] for k in keys) for m in mem.values()}) != 1:
        fails.append(f"trial_memory_analysis {mem}")
    if not c["prewarm"]["launches"]:
        fails.append("prewarm launched nothing")
    if fails:
        raise RuntimeError("phase 16c: " + "; ".join(fails) + f" | {c}")


def chain_phase(device=None, name=None, smi=None):
    """Phase 16: vch_tpu's chain through public entry points on the card's
    own tensors (chain_case) at config 3's grid, then at config 1's; then
    sweep_2d and the batched run on the card's tensors
    (sweep_case, 16c); each logged, then gated. Alone on the card (the
    build included): `python -c "import chip_smoke;
    chip_smoke.chain_phase()"`. Returns the kernels' launches of the
    card-input runs by entry."""
    import torch
    if device is None:
        device, name, smi = (torch.device("cuda", 0),
                             torch.cuda.get_device_name(0), _smi())
    t0 = time.perf_counter()
    launches = {}
    for dim in (2, 1):
        c = chain_case(torch, device, dim)
        _log(16, json.dumps(c) + f" | {name} | {smi}")
        check_chain(c)
        for k, v in c["runs"]["card"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    t1 = time.perf_counter()
    c = sweep_case(torch, device)
    _log("16c", json.dumps(c) + f" | {time.perf_counter() - t1:.1f} s | "
         f"{name} | {smi}")
    check_sweep_case(c)
    for form in ("card_values", "card_batch"):
        for k, v in c["runs"][form]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    _log(16, f"{time.perf_counter() - t0:.1f} s")
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
         + ", march_bf16_kernel<MB,SEG> (the same at a bf16 "
         "fused_solve_precision): "
         + _ptxas_named(_build.ptxas_log, "march_bf16_kernel")
         + ", march_fwd16_kernel<MB,SEG> (the same at fwd_mm \"bf16x3\"): "
         + _ptxas_named(_build.ptxas_log, "march_fwd16_kernel")
         + " | adjoint2d_cluster.cu adjoint_cluster_kernel<MB,SEG> (8, 4, "
         "2: the blocked sweep; <1,0>: the whole sweep; <1,1>: the segment "
         "sweep): " + _ptxas_named(_build.ptxas_log, "adjoint_cluster_kernel")
         + ", adjoint_bf16_kernel<MB,SEG> (the same at "
         "adjoint_solve_precision \"bf16x3\"): "
         + _ptxas_named(_build.ptxas_log, "adjoint_bf16_kernel")
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
    # the bf16 forms of rows 1, 3 and 5 at both bf16 modes against their
    # plain versions
    bf16 = [bf16_form_case(torch, device, *f) for f in BF16_FORMS]
    for c in bf16:
        _log("2p", json.dumps(c) + f" | {name} | {smi}")
    for c in bf16:
        check_bf16_form_case(c)
    # the sweep's bf16 forms (rows 2, 4, 6 at adjoint_solve_precision
    # "bf16x3") at their main paths' shapes, then at the control shapes
    sweep16 = [sweep16_case(torch, device, *f) for f in SWEEP16_FORMS]
    controls16 = [sweep16_case(torch, device, *f) for f in SWEEP16_CONTROLS]
    for c in sweep16 + controls16:
        _log("2q", json.dumps(c) + f" | {name} | {smi}")
    for c in sweep16:
        check_sweep16_case(c)
    for c in controls16:
        check_sweep16_case(c, control=True)
    # the march's fwd_mm forms (rows 1, 3, 5 at fwd_mm "bf16x3") at their
    # main paths' shapes, short marches
    fwd16 = [fwd16_case(torch, device, *f) for f in FWD16_FORMS]
    for c in fwd16:
        _log("2r", json.dumps(c) + f" | {name} | {smi}")
    for c in fwd16:
        check_fwd16_case(c)

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
    ctl16 = {v: control_slice(torch, device, v, solve_prec="bf16x3")
             for v in ("spectral", "raw")}
    for c in ctl16.values():
        _log("3c16", json.dumps(c))
    for c in ctl16.values():
        check_control_slice16(c)
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
    c4, ch4 = pgd_run(torch, device, prob4, sc4, iters=3, with_costs=True)
    # the march kernel alone at this shape, on the run's initial conditions
    # and a seeded control, at "highest" (the float32 march) and at the
    # default "bf16x3" in turns, each with its bound on its Newton total
    x4 = {"phi0": torch.as_tensor(sc4.phi0, dtype=torch.float32,
                                  device=device),
          "u": 0.05 * torch.randn(
              (128, prob4.solver.M + 1, 129, 129), device=device,
              generator=torch.Generator(device).manual_seed(0))}
    s4 = prob4.solver
    m4 = lambda mode: km.march_fused_2d(
        s4.dts, x4["phi0"], x4["u"], *s4._ops(),
        **dict(s4._march_kw(), solve_prec=mode))
    ns4 = {mode: int(m4(mode)[1].sum()) for mode in ("highest", "bf16x3")}
    t4 = {}
    for mode in ("highest", "bf16x3", "bf16x3", "highest"):
        t4.setdefault(mode, []).append(time_ms(lambda: m4(mode), 1))
    c4["march_ms_full_shape_by_mode"] = t4
    c4["march_ms_full_shape"] = float(np.mean(t4["highest"]))
    c4["march_bf16x3_ms_full_shape"] = float(np.mean(t4["bf16x3"]))
    c4["march_newton_full_shape"] = ns4["highest"]
    c4["march_bf16x3_newton_full_shape"] = ns4["bf16x3"]
    c4["march_bound_ms_full_shape"], _ = _bound(*_march_work(
        129, 128, s4.M, ns4["highest"], trips_fwd))
    c4["march_bf16x3_bound_ms_full_shape"], _ = _bound16(*_march_work16(
        129, 128, s4.M, ns4["bf16x3"], trips_fwd, 3))
    c4["march_geometry_full_shape"] = {}
    for mode in ("highest", "bf16x3"):
        p4 = km.solve_passes(mode)
        g4 = km.launch_geometry(129, 129, 128, device, members=1,
                                solve_passes=p4)
        c4["march_geometry_full_shape"][mode] = dict(
            cluster=g4.cluster, smem_bytes=g4.smem_bytes,
            resident_clusters=km.resident_clusters(
                0, 129, 129, g4.cluster, g4.kc, g4.smem_bytes, 1,
                kernel="march16" if p4 else "march"))
    # row 2, the one-member sweep, alone at this shape on the float32
    # march's history, with its bound
    h4 = m4("highest")[0]
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
    del prob4, x4, h4, a4, r4
    _log(4, json.dumps(c4) + f" | {name} | {smi}")
    check_main_path(c4, per_member, blocked + idle_segment + march_1d,
                    bf16=("march_fused_2d",))
    if not c4["adjoint_equals_one_cta_full_shape"]:
        raise RuntimeError("config 4: the cluster sweep differs from its "
                           "one-CTA oracle")
    c4h = mode_comparison(torch, device, BatchedProblem2D(
        _config(128, fused_solve_precision="highest"), device=device), sc4,
        c4, ch4, iters=3)
    _log("4h", json.dumps(c4h) + f" | {name} | {smi}")
    check_main_path(c4h, per_member, blocked + idle_segment + march_1d)

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
    sc5 = _bench_sweep(cfg64, 512)
    c5, ch5 = pgd_run(torch, device, prob5, sc5, iters=3,
                      before_timed=lambda: (blk_m.clear(), blk_a.clear()),
                      with_costs=True)
    # beside row 4's launches, the one-member sweep at B = 512 on the
    # cluster kernel and on the one-CTA oracle (phase 2b)
    c5.update(blocked_march=blk_m.summary(), blocked_adjoint=blk_a.summary(),
              adjoint_one_member_ms_b512=blk512["adjoint_per_member_ms"],
              adjoint_one_cta_ms_b512=blk512["adjoint_one_cta_ms"],
              adjoint_cluster_ms_b512=blk512["adjoint_blocked_ms"],
              adjoint_bound_ms_b512=blk512["adjoint_bound_ms"])
    _log(5, json.dumps(c5) + f" | {name} | {smi}")
    check_main_path(c5, blocked, per_member + idle_segment + march_1d,
                    bf16=("march_fused_2d_blocked",))
    del prob5
    c5h = mode_comparison(torch, device, BatchedProblem2D(
        _config(64, fused_solve_precision="highest"), device=device), sc5,
        c5, ch5, iters=3)
    _log("5h", json.dumps(c5h) + f" | {name} | {smi}")
    check_main_path(c5h, blocked, per_member + idle_segment + march_1d)
    # phase 5a: the headline with the blocked sweep on its bf16 form
    c5a, ch5a = pgd_run(torch, device, BatchedProblem2D(
        _config(64, adjoint_solve_precision="bf16x3"), device=device), sc5,
        iters=2, with_costs=True)
    rel5a = np.abs(ch5a[-1] - ch5[2]) / np.abs(ch5[2])
    c5a.update(mean_last_cost_rel_vs_phase5=float(abs(
        ch5a[-1].mean() - ch5[2].mean()) / abs(ch5[2].mean())),
        max_member_rel_vs_phase5=float(rel5a.max()))
    _log("5a", json.dumps(c5a) + f" | {name} | {smi}")
    check_main_path(c5a, blocked, per_member + idle_segment + march_1d,
                    bf16=blocked)
    if not c5a["mean_last_cost_rel_vs_phase5"] <= 0.01:
        raise RuntimeError(f"phase 5a: mean cost after 2 iterations "
                           f"{c5a['mean_last_cost_rel_vs_phase5']} from "
                           f"phase 5's (at most 0.01)")

    # the largest limit under which the full-memory estimate does not fit
    # (est6 > 0.75 limit): the low-memory arm must run within it
    cfg256 = _config(256)
    est6 = full_memory_estimate_bytes(cfg256, 32, materialized_phi_Q=False)
    limit6 = int(0.99 * est6 / 0.75)
    route6 = lambda limit, cfg=cfg256: make_batched_problem_2d(
        cfg, batch=32, materialized_phi_Q=False, hbm_limit_bytes=limit,
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
    sc6 = _bench_sweep(cfg256, 32, materialize=False)
    c6, ch6 = pgd_run(torch, device, prob6, sc6, iters=1,
                      before_timed=lambda: (seg_m.clear(), seg_a.clear()),
                      with_costs=True)
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
                    + oracle, bf16=("march_fused_2d_segment",))
    if c6["peak_bytes"] > limit6:
        raise RuntimeError(f"low-memory peak {c6['peak_bytes']} B exceeds "
                           f"the limit it was routed under, {limit6} B")
    del prob6
    c6h = mode_comparison(torch, device, route6(limit6, dataclasses.replace(
        cfg256, fused_solve_precision="highest")), sc6, c6, ch6, iters=1)
    _log("6h", json.dumps(c6h) + f" | {name} | {smi}")
    check_main_path(c6h, segment, per_member + blocked + march_1d + oracle)

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

    c3, prob3 = config3_run(torch, device)
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
    fused14 = fused_phase(device, name, smi, prob=prob3, c3=c3)
    surface15 = surface_phase(device, name, smi, c3=c3, prob=prob3)
    del prob3
    chain_phase(device, name, smi)
    # phase 4s's problem lives to here, as when its profiler pass (4sp, cut
    # to keep the run inside its time limit) ran here: the phases between
    # keep their device-memory base
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
        # work: (FLOPs, bytes), or (FP32 FLOPs, bf16 FLOPs, bytes)
        bound_ms, bound_by = (_bound16 if len(work) == 3 else _bound)(*work)
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
    # rows 1, 3, 5 on the float32 march: their launches those of the main
    # paths' reruns at "highest" (4h, 5h, 6h)
    kernels = [
        entry("march_fused_2d", cluster_cu, f"{pm}:393",
              c4h["launches"]["march_fused_2d"], long["max_abs_dphi"],
              c4["march_ms_full_shape"], long["march_plain_ms"],
              _march_work(129, 128, c4["M"], c4["march_newton_full_shape"],
                          trips_fwd), shape=full4),
        entry("adjoint_fused_2d", sweep_cu, f"{pm}:751",
              c4["launches"]["adjoint_fused_2d"], long["max_abs_dr"],
              c4["adjoint_ms_full_shape"], long["adjoint_plain_ms"],
              _adjoint_work(129, 128, c4["M"], trips_adj), shape=full4),
        entry("march_fused_2d_blocked", cluster_cu, f"{pm}:1649",
              c5h["launches"]["march_fused_2d_blocked"], blk8["max_abs_dphi"],
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
              c6h["launches"]["march_fused_2d_segment"],
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
    # rows 1, 3, 5 on their bf16 forms (march_bf16_kernel<MB, SEG>) at the
    # default "bf16x3": their launches those of the main paths (4, 5, 6),
    # the rest phase 2p's, with its ms at every mode on the same inputs;
    # row 1's ms and bound at config 4's shape (phase 4)
    full16 = "ms, bound_ms: config 4's n=129, B=128, M=100; max_abs_err, " \
        "plain_ms: n=129, B=8, M=5 (phase 2p)"
    row16 = [("march_fused_2d", 393, "1, false", c4, bf16[1], "bf16x3",
              full16),
             ("march_fused_2d_blocked", 1649, "8, false", c5, bf16[2],
              "bf16x3 block 8", "n=65, B=16, M=10 (phase 2p)"),
             ("march_fused_2d_segment", 479, "1, true", c6, bf16[3],
              "bf16x3", "n=257, B=2, K=10 (phase 2p)")]
    for fn, line, form, main_run, case, tag, shape in row16:
        r = case["runs"][tag]
        if fn == "march_fused_2d":
            ms = c4["march_bf16x3_ms_full_shape"]
            work = _march_work16(129, 128, c4["M"],
                                 c4["march_bf16x3_newton_full_shape"],
                                 trips_fwd, 3)
        else:
            ms = mean(r["ms"])
            work = _march_work16(case["n"], case["B"], case["M"],
                                 sum(r["newton_kernel"]), trips_fwd, 3,
                                 segment=fn.endswith("segment"))
        e = entry(f"{fn}[bf16x3]", cluster_cu, f"{pm}:{line}",
                  main_run["launches_bf16"][fn], r["max_abs_dphi"], ms,
                  r["plain_ms"], work, shape=shape)
        e.update(kernel=f"march_bf16_kernel<{form}>",
                 solve_precision="bf16x3",
                 ms_phase2p={t: mean(v["ms"])
                             for t, v in case["runs"].items()})
        kernels.append(e)
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
    # phases 12-15 run the default "bf16x3": their launches of rows 1, 3, 5
    # go to the bf16 forms' entries, the float32 forms' get none there
    march_rows = {fn for fn, *_ in row16}
    by = {e["name"].removesuffix("[bf16x3]"): e for e in kernels
          if e["name"] not in march_rows}
    rows6 = [e["name"] for e in kernels[:6]]
    # rows 1-6: their launches in phase 12's runs beside their main paths';
    # every row's launches in phase 13's runs
    for k in rows6:
        if k in by:
            by[k]["launches_phase12"] = side.get(k, 0)
    for k, e in by.items():
        e["launches_phase13"] = mesh.get(k, 0)
    # row 1: its launches in phase 14a's fused line search (11 a PGD
    # iteration at config 3, of which only the searching trials march)
    by["march_fused_2d"]["launches_phase14"] = fused14.get("march_fused_2d",
                                                           0)
    # rows 1, 8 and 9: their launches in phase 15b (config 3 through the
    # package namespaces: the constructor, the host and the fused mode) and
    # row 1's in 15c (the coercivity probe, one-control and batched)
    for k, e in by.items():
        if k in surface15:
            e["launches_phase15"] = surface15[k]
    # rows 2, 4, 6 on their bf16 forms (adjoint_bf16_kernel<MB, SEG>) at
    # adjoint_solve_precision "bf16x3", at their main paths' shapes (phase
    # 2q): <8, false>'s launches those of phase 5a's run, the other forms'
    # their entry point's own call (no default path reaches them: the
    # knob's default is None, and the low-memory path runs its segment
    # sweep at "highest", as vch_tpu's)
    for (fn, line, form, bb), c in zip(
            (("adjoint_fused_2d", 751, "1, false", None),
             ("adjoint_fused_2d_blocked", 1905, "8, false", 8),
             ("adjoint_fused_2d_segment", 819, "1, true", None)), sweep16):
        for b in ((8, 4, 2) if bb else (None,)):
            main = b == 8
            e = entry(
                f"{fn}[bf16x3]" + (f"[block {b}]" if b in (4, 2) else ""),
                sweep_cu, f"{pm}:{line}",
                (c5a["launches_bf16"][fn] if main
                 else c["entry_launches"][b or 1]),
                c["max_abs_dr"],
                (c["bf16x3_ms_by_block"][b] if b in (4, 2)
                 else mean(c["bf16x3_ms"])), c["plain_ms"],
                _adjoint_work16(c["n"], c["B"], c["M"], trips_adj,
                                segment=fn.endswith("segment")),
                shape=f"ms, bound_ms: n={c['n']}, B={c['B']}, M={c['M']} "
                      f"(phase 2q); max_abs_err, plain_ms: its first "
                      f"{c['gate_members']} members")
            e.update(kernel="adjoint_bf16_kernel<"
                            + (f"{b}, false>" if b else f"{form}>"),
                     solve_precision="bf16x3",
                     launches_from="phase 5a" if main
                     else "the entry point's own call (phase 2q)",
                     highest_ms=mean(c["highest_ms"]),
                     highest_bound_ms=c["highest_bound_ms"])
            kernels.append(e)
    # rows 1, 3, 5 on their fwd_mm forms (march_fwd16_kernel<MB, SEG>) at
    # fwd_mm "bf16x3" and the default fused_solve_precision "bf16x3", at
    # phase 2r's shapes: no path sets fwd_mm (vch_tpu keeps it "highest"
    # on every path), so each form's launches are its entry point's own
    # call in phase 2r
    for (fn, line, form), c in zip(
            (("march_fused_2d", 393, "1, false"),
             ("march_fused_2d_blocked", 1649, "8, false"),
             ("march_fused_2d_segment", 479, "1, true")), fwd16):
        for b in ((8, 4, 2) if c["form"].endswith("blocked") else (None,)):
            e = entry(
                f"{fn}[fwd_mm bf16x3]" + (f"[block {b}]" if b in (4, 2)
                                          else ""),
                cluster_cu, f"{pm}:{line}", c["entry_launches"][b or 1],
                c["max_abs_dphi_vs_plain"],
                (c["fwd_bf16x3_ms_by_block"][b] if b in (4, 2)
                 else mean(c["fwd_bf16x3_ms"])), c["plain_ms"],
                _march_work_fwd16(c["n"], c["B"], c["M"],
                                  sum(c["newton_kernel"]), trips_fwd, 3,
                                  segment=fn.endswith("segment")),
                shape=f"ms, bound_ms: n={c['n']}, B={c['B']}, M={c['M']} "
                      f"(phase 2r); max_abs_err, plain_ms: its first "
                      f"{c['gate_members']} members")
            e.update(kernel="march_fwd16_kernel<"
                            + (f"{b}, false>" if b else f"{form}>"),
                     solve_precision="bf16x3", fwd_mm="bf16x3",
                     launches_from="the entry point's own call (phase 2r)",
                     bf16_form_ms=mean(c["fwd_highest_ms"]),
                     bf16_form_bound_ms=c["bf16_form_bound_ms"])
            kernels.append(e)
    _log("end", f"{time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
