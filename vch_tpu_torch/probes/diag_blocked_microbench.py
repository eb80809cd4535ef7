"""Cost of the member-blocked primitives on the CUDA card (counterpart of
scripts/diag_blocked_microbench.py).

    python -m vch_tpu_torch.probes.diag_blocked_microbench [--n 64] [--bb 8]
        [--k 64] [--reps 30]

One thread-block cluster (16 CTAs at the default shape) applies k dependent
steps of one primitive to a (bb (n+1), n+1) stack of bb members
(`ops.probe_kernels.blocked_microbench`), in the script's eight variants:
serial_one (one member's product, the other members idle), member_mm and
left_mm (one product per member, right and left),
stacked_mm (one stacked product), swap (the member-local transpose alone),
swap_mm (the transpose folded into the stacked product's operand read),
gdot (per-member squared norms) and member_dot (one factor from all
members' norms). The inputs are the script's, from seed 0: C = Q of a QR of
N(0, 1), then X = 0.1 N(0, 1). Each variant's time is the mean over `reps`
launches after one warm-up, between two CUDA events, taken twice in turns
(the variants in order, then back) and averaged. Prints the script's
summary (`us_per_op` and `us_per_member_op` per variant, unrounded) with
the cluster size it ran on and the card's name as one JSON object; the
script's `--record`, which writes BENCH_RESULTS.json, has no counterpart. Runs on the CUDA card; raises
without one.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

import vch_tpu_torch  # noqa: F401  (pins TF32 off)
from vch_tpu_torch.ops import probe_kernels as pk
from vch_tpu_torch.probes._timing import cuda_device, time_ms


def inputs(n: int, bb: int, device, dtype=torch.float32):
    """The script's C (n+1, n+1) and X (bb (n+1), n+1), in its order (its
    G and GT are the member-indicator matrices, which the kernel's
    per-member reductions take the place of)."""
    n1 = n + 1
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((n1, n1)))
    x = rng.standard_normal((bb * n1, n1)) * 0.1
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), dtype=dtype,
                                  device=device)
    return t(q), t(x)


def run(n: int = 64, bb: int = 8, k: int = 64, reps: int = 30,
        device=None) -> dict:
    """The script's summary of the eight variants."""
    device = cuda_device(device)
    C, X = inputs(n, bb, device)
    ms = {v: 0.0 for v in pk.VARIANTS}
    for v in pk.VARIANTS + pk.VARIANTS[::-1]:
        ms[v] += time_ms(lambda v=v: pk.blocked_microbench(v, C, X, bb, k),
                         reps) / 2
    results = {}
    for v in pk.VARIANTS:
        us_per_op = ms[v] * 1e3 / k
        results[v] = {"us_per_op": us_per_op,
                      "us_per_member_op": us_per_op
                      / (1 if v == "serial_one" else bb)}
    return {"n": n + 1, "bb": bb, "k": k, "reps": reps,
            "cluster": pk.probe_geometry("micro", n + 1, bb, bb,
                                          X.device.index).cluster,
            "results": results, "device": torch.cuda.get_device_name(device)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--bb", type=int, default=8)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--reps", type=int, default=30)
    a = ap.parse_args(argv)
    print(json.dumps(run(a.n, a.bb, a.k, a.reps)))


if __name__ == "__main__":
    main()
