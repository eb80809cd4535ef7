"""Cost split of the raw-basis Schur BiCGStab kernel on the CUDA card
(counterpart of scripts/diag_kernel_cost.py).

    python -m vch_tpu_torch.probes.diag_kernel_cost [--n 64] [--b 32]
        [--iters 10] [--reps 20]

Three launches on one batch of B members of an (n+1) x (n+1) grid, each
one member per thread-block cluster on the cluster engine
(csrc/solve2d_cluster.cu, on csrc/schur_solve.cuh's raw Schur solve):
  full     the raw Schur solve `ops.solve_kernels.bicgstab_schur`, the
           production kernel the solvers run (n_iter fixed trips);
  nodots   its trips with every block dot product the constant 0.5
           (`schur_nodots`): the products and elementwise passes alone;
  mmonly   the chain v <- M(S(M(S(v)))) iters times (`schur_mmonly`): the
           products alone.
As in the script, `full` is the production kernel, and the three are one
design built with one set of flags (-fmad=false), so reduction_share
splits the time of the kernel the solvers run.
The inputs are the script's, made with numpy from seed 0 in its order: one
random operator scaled by 0.01 in all six operator slots, the preconditioner
symbol den = 1 + |N(0,1)| shared by the members, d = 1 + |N(0,1)| and the
rhs N(0,1) per member, the scalars 100, 5 and 4.5e-4; float32, no TF32. Each
time is the mean over `reps` launches after one warm-up, between two CUDA
events, taken twice in turns (full, nodots, mmonly, then back) and
averaged. Prints one JSON object with the script's keys (full_ms, nodots_ms,
mmonly_ms, full_us_per_member_trip, reduction_share = 1 - nodots / full),
unrounded, and the card's name. Runs on the CUDA card; raises without one.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

import vch_tpu_torch  # noqa: F401  (pins TF32 off)
from vch_tpu_torch.ops import solve_kernels as sk
from vch_tpu_torch.probes._timing import cuda_device, time_ms

SCALARS = (100.0, 5.0, 4.5e-4)          # inv_dt, tau_dt, kappa/2
# the three probes, all of the cluster design (see above)
PROBES = {"full": sk.bicgstab_schur, "nodots": sk.schur_nodots,
          "mmonly": sk.schur_mmonly}


def probe_args(n: int, b: int, device, dtype=torch.float32, seed: int = 0):
    """The script's inputs on an (n+1)^2 grid for b members, as the
    positional arguments of the three probes (operators, den expanded to
    (b, n+1, n+1), d, rhs, scalars)."""
    n1 = n + 1
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                  device=device)
    op = t(rng.standard_normal((n1, n1)) * 0.01)
    den = 1.0 + np.abs(rng.standard_normal((n1, n1)))
    d = 1.0 + np.abs(rng.standard_normal((b, n1, n1)))
    rhs = rng.standard_normal((b, n1, n1))
    return ((op,) * 6 + (t(np.broadcast_to(den, (b, n1, n1))), t(d), t(rhs))
            + SCALARS)


def run(n: int = 64, b: int = 32, iters: int = 10, reps: int = 20,
        device=None) -> dict:
    """The three CUDA-event times and the script's derived keys."""
    device = cuda_device(device)
    args = probe_args(n, b, device)
    # in turns (full, nodots, mmonly, mmonly, nodots, full), so that a
    # drift of the card's clock over the call weighs on the three alike
    order = list(PROBES) + list(PROBES)[::-1]
    ms = {name: 0.0 for name in PROBES}
    for name in order:
        ms[name] += time_ms(lambda f=PROBES[name]: f(*args, n_iter=iters),
                            reps) / 2
    return {"n": n, "b": b, "iters": iters, "reps": reps,
            "full_ms": ms["full"], "nodots_ms": ms["nodots"],
            "mmonly_ms": ms["mmonly"],
            "full_us_per_member_trip": ms["full"] * 1e3 / b / iters,
            "reduction_share": 1.0 - ms["nodots"] / ms["full"],
            "device": torch.cuda.get_device_name(device)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--b", type=int, default=32)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args(argv)
    print(json.dumps(run(a.n, a.b, a.iters, a.reps)))


if __name__ == "__main__":
    main()
