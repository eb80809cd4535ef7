#!/usr/bin/env python3
"""Smoke run of the vch_tpu_torch port on one CUDA card.

    python chip_smoke.py

Phases (each prints one line; any failure raises, so the exit code is not 0):
  0 device  — the card's name and power limit; no card is an error (never
              falls back to the CPU);
  1 build   — nvcc builds both kernels from vch_tpu_torch/csrc for sm_90a;
  2 kernels — each CUDA kernel against its plain PyTorch version on the same
              inputs on the card, at n = 65 and n = 129 (both odd edges) and
              at the main path's smallest line-search bucket at config 4
              (n = 129, M = 100, B = 8), with kernel and plain times;
  3 slice   — BatchedProblem2D at 32x32 on the heterogeneous B = 16 sweep,
              kernel path against plain path, 3 PGD iterations;
  4 config 4 — the main path: 128x128, T = 1 (M = 100), B = 128, float32,
              one warm-up iteration, then 3 timed PGD iterations with the
              kernel launch counters reset just before.
It then prints the kernels' JSON line, the card's nvidia-smi name and power
limit, and last `{"ok": true, "device": {...}}`.
"""
import json
import subprocess
import time

import numpy as np


def _log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


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


def _time_ms(torch, fn, reps):
    """Mean device ms of fn() over reps calls after one warm-up call,
    between two CUDA events on the current stream."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_case(torch, n, B, T, device, seed=0, reps=3):
    """Phase 2 at one shape: each kernel against its plain version on the
    same float32 inputs, and both against the plain version in float64 (the
    float32 noise floor the comparison has to be read against). Returns a
    dict of the measured numbers."""
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
    (fwd, adj), (fwd64, adj64) = solvers["float32"], solvers["float64"]
    # the float64 reference takes the float32 Newton exits, so it differs
    # from the float32 runs by arithmetic alone
    fwd64.march, adj64.sweep = km.march_fused_2d_plain, km.adjoint_fused_2d_plain
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
    x, x64 = as_dev(torch.float32), as_dev(torch.float64)
    sync = ((lambda: torch.cuda.synchronize(device)) if device.type == "cuda"
            else (lambda: None))
    rel = lambda a, b, ref: ((a.double() - b.double()).abs().max().item()
                             / max(ref.abs().max().item(), 1e-300))

    # forward march
    fwd.march = km.march_fused_2d
    kh, kns, kbad = fwd.march_fused_batch(x["u"], x["phi0"])
    sync()
    fwd.march = km.march_fused_2d_plain
    t0 = time.perf_counter()
    ph, pns, pbad = fwd.march_fused_batch(x["u"], x["phi0"])
    sync()
    march_plain_ms = (time.perf_counter() - t0) * 1e3
    h64, _, _ = fwd64.march_fused_batch(x64["u"], x64["phi0"])
    if not torch.isfinite(kh).all():
        raise RuntimeError(f"n={n}: non-finite kernel phi")
    if not torch.equal(kbad, pbad):
        raise RuntimeError(f"n={n}: first_bad differs {kbad} vs {pbad}")

    # adjoint sweep, all on the plain float32 history
    args = lambda v, hist: (hist, v["b1"], v["b2"], v["phiQ"], v["phiT"])
    adj.sweep = km.adjoint_fused_2d
    kr = adj.adjoint_fused_batch(*args(x, ph))
    sync()
    adj.sweep = km.adjoint_fused_2d_plain
    t0 = time.perf_counter()
    pr = adj.adjoint_fused_batch(*args(x, ph))
    sync()
    adjoint_plain_ms = (time.perf_counter() - t0) * 1e3
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
               rel_dr=rel(kr, pr, pr),
               rel_r_kernel_vs_f64=rel(kr, r64, r64),
               rel_r_plain_vs_f64=rel(pr, r64, r64))
    fwd.march = km.march_fused_2d
    adj.sweep = km.adjoint_fused_2d
    if device.type == "cuda":
        out["march_ms"] = _time_ms(
            torch, lambda: fwd.march_fused_batch(x["u"], x["phi0"]), reps)
        out["adjoint_ms"] = _time_ms(
            torch, lambda: adj.adjoint_fused_batch(*args(x, ph)), reps)
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
    if c["rel_r_kernel_vs_f64"] > 2 * c["rel_r_plain_vs_f64"] + 1e-6:
        fails.append("adjoint kernel farther from float64 than plain f32")
    if c["rel_dr"] > 5e-3:
        fails.append(f"adjoint kernel vs plain rel {c['rel_dr']} > 5e-3")
    if fails:
        raise RuntimeError(f"n={c['n']} B={c['B']} M={c['M']}: "
                           + "; ".join(fails))


def slice_case(torch, device, n=32, T=0.1, iters=3):
    """Phase 3: the batched PGD slice, kernel path vs plain path."""
    from vch_tpu_torch.config import ForwardSolverConfig2D
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.parallel.batch import BatchedProblem2D, sweep_2d

    cfg = ForwardSolverConfig2D(Nx=n, Ny=n, T=T, dtype="float32",
                                newton_tol=2e-4)
    sc = sweep_2d(cfg, b3_values=np.logspace(-6, 0, 4),
                  kappa_values=np.logspace(-6, -1, 4))
    runs = {}
    for path in ("kernel", "plain"):
        prob = BatchedProblem2D(cfg, device=device)
        if path == "plain":
            prob.solver.march = km.march_fused_2d_plain
            prob.adj.sweep = km.adjoint_fused_2d_plain
        t0 = time.perf_counter()
        out = prob.run(sc, max_iter=iters, verbose=False)
        runs[path] = (out, prob.straggler_rounds, time.perf_counter() - t0)
    (ko, ks, kt), (po, ps, pt) = runs["kernel"], runs["plain"]
    c0, c1 = po["cost_history"], ko["cost_history"]
    rel = float((np.abs(c1 - c0) / np.abs(c0)).max())
    return dict(rel_cost=rel, straggler_rounds_kernel=ks,
                straggler_rounds_plain=ps, newton_kernel=ko["newton_solves"],
                newton_plain=po["newton_solves"], kernel_s=kt, plain_s=pt,
                finite=bool(np.isfinite(c1).all()))


def config4(torch, device, n=128, B=128, T=1.0, iters=3):
    """Phase 4: the main path at config 4 (bench.py's sweep, tiled to B)."""
    from vch_tpu_torch.config import ForwardSolverConfig2D
    from vch_tpu_torch.ops import march as km
    from vch_tpu_torch.parallel.batch import (BatchedProblem2D, sweep_2d,
                                              tile_batch)

    cfg = ForwardSolverConfig2D(Nx=n, Ny=n, T=T, dtype="float32",
                                newton_tol=2e-4)
    sc = sweep_2d(cfg, b3_values=np.linspace(5e-5, 2e-4, max(1, B // 4)),
                  kappa_values=np.linspace(5e-5, 2e-4, 4)[: max(1, min(4, B))])
    sc = tile_batch(sc, B)
    prob = BatchedProblem2D(cfg, device=device)
    t0 = time.perf_counter()
    prob.run(sc, max_iter=1, verbose=False)             # warm-up
    warm_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prob.straggler_rounds = 0
    km.march_fused_2d.launches = 0                      # the main path's run
    km.adjoint_fused_2d.launches = 0
    t0 = time.perf_counter()
    out = prob.run(sc, max_iter=iters, verbose=False)
    elapsed = time.perf_counter() - t0
    launches = {"march_fused_2d": km.march_fused_2d.launches,
                "adjoint_fused_2d": km.adjoint_fused_2d.launches}
    ch = out["cost_history"]
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    return dict(B=B, n=n, M=prob.solver.M, iters=iters, elapsed_s=elapsed,
                warmup_s=warm_s, scenario_iters_per_s=B * iters / elapsed,
                newton_solves=out["newton_solves"],
                newton_solves_per_s=out["newton_solves"] / elapsed,
                timers=out["timers"], straggler_rounds=prob.straggler_rounds,
                peak_bytes=peak, launches=launches,
                mean_cost_before=float(ch[0].mean()),
                mean_cost_after=float(ch[-1].mean()),
                finite=bool(np.isfinite(ch).all()))


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script needs a CUDA card and never runs on "
                         "the CPU")
    import vch_tpu_torch  # noqa: F401  (also pins TF32 off)
    from vch_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = _smi()
    _log(0, f"device {name} | torch {torch.__version__} cuda "
            f"{torch.version.cuda} | nvidia-smi: {smi}")

    t0 = time.perf_counter()
    _build.load()
    regs = [ln.strip() for ln in _build.ptxas_log.splitlines()
            if "registers" in ln or "spill" in ln]
    how = (f"nvcc {_build.build_seconds:.1f} s" if _build.build_seconds
           else "library of these sources already built")
    _log(1, f"build {time.perf_counter() - t0:.1f} s ({how}) | "
            + " ; ".join(regs))

    cases = [kernel_case(torch, 65, 4, 0.1, device),
             kernel_case(torch, 129, 2, 0.05, device),
             kernel_case(torch, 129, 8, 1.0, device, reps=1)]
    for c in cases:
        _log(2, json.dumps(c))
    for i, c in enumerate(cases):
        check_kernel_case(c, short=i < 2)
    long = cases[2]

    sl = slice_case(torch, device)
    _log(3, json.dumps(sl))
    if not sl["finite"] or sl["rel_cost"] > 2e-4:
        raise RuntimeError(f"slice kernel vs plain path: {sl}")

    c4 = config4(torch, device)
    _log(4, json.dumps(c4) + f" | {name} | {smi}")
    if min(c4["launches"].values()) <= 0:
        raise RuntimeError(f"a kernel of the path never launched: {c4}")
    if not c4["finite"] or not c4["mean_cost_after"] < c4["mean_cost_before"]:
        raise RuntimeError(f"config 4 did not descend: {c4}")

    kernels = [
        {"name": "march_fused_2d", "route": "cuda",
         "source": "vch_tpu_torch/csrc/march2d.cu",
         "replaces": "vch_tpu/ops/pallas_march.py:393",
         "launches": c4["launches"]["march_fused_2d"],
         "max_abs_err": long["max_abs_dphi"], "ms": long["march_ms"],
         "plain_ms": long["march_plain_ms"]},
        {"name": "adjoint_fused_2d", "route": "cuda",
         "source": "vch_tpu_torch/csrc/adjoint2d.cu",
         "replaces": "vch_tpu/ops/pallas_march.py:751",
         "launches": c4["launches"]["adjoint_fused_2d"],
         "max_abs_err": long["max_abs_dr"], "ms": long["adjoint_ms"],
         "plain_ms": long["adjoint_plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
