"""Does interleaving K independent product chains in one block beat one
chain per block? (counterpart of scripts/diag_interleave.py)

    python -m vch_tpu_torch.probes.diag_interleave [--n 64] [--members 32]
        [--len 40] [--reps 30]

A chain of L dependent x <- A x products of (n+1)^2 fields per member, for
`members` members, at interleave widths K = 1, 2, 4, 8, in full float32
("highest", `ops.probe_kernels.matmul_chain`: B / K thread-block clusters
of C CTAs, K members' chains side by side in each, every link the cluster
engine's left product) and with bf16 operands on the tensor cores ("bf16",
`matmul_chain_bf16`, the counterpart of Precision.DEFAULT: B / K CTAs, x
resident in shared memory). The inputs are the script's, from seed 0:
A = 0.999 Q of a QR of N(0, 1), then X = N(0, 1) (B, n+1, n+1).

Keys: `{label}_K{K}_ns_per_mm` is the script's, wall time / (B L); on this
card the B / K blocks run at once on their own SMs, not one after another
as the TPU's grid cells do, so `{label}_K{K}_cta_ns_per_mm`, wall time /
(K L), is the time per product inside one block (a cluster of
`{label}_K{K}_cluster` CTAs; 1 for bf16, one CTA): it sets K members per
cluster against one, apart from adding SMs. `ideal_ns_at_67tflops_fp32` is
one product at the card's published FP32 peak. The chain is always a loop
inside the kernel (`body`: "loop"). Each time is the mean over `reps`
launches after one warm-up, between two CUDA events. Prints one JSON
object, unrounded, with the card's name. Runs on the CUDA card; raises
without one.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

import vch_tpu_torch  # noqa: F401  (pins TF32 off)
from vch_tpu_torch.ops import probe_kernels as pk
from vch_tpu_torch.probes._timing import PEAK_FP32_FLOPS, cuda_device, time_ms

WIDTHS = (1, 2, 4, 8)
CHAINS = {"highest": pk.matmul_chain, "bf16": pk.matmul_chain_bf16}


def inputs(n: int, members: int, device, dtype=torch.float32):
    """The script's A (n+1, n+1) and X (members, n+1, n+1)."""
    n1 = n + 1
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((n1, n1)))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), dtype=dtype,
                                  device=device)
    return t(q * 0.999), t(rng.standard_normal((members, n1, n1)))


def run(n: int = 64, members: int = 32, length: int = 40, reps: int = 30,
        device=None) -> dict:
    """The script's keys, the per-block keys with the cluster sizes, and the
    FP32 ideal."""
    device = cuda_device(device)
    A, X = inputs(n, members, device)
    res = {"n": n, "members": members, "chain_len": length, "reps": reps,
           "body": "loop"}
    for label, chain in CHAINS.items():
        for K in WIDTHS:
            if members % K:
                continue
            ms = time_ms(lambda: chain(A, X, K, length), reps)
            res[f"{label}_K{K}_ns_per_mm"] = ms * 1e6 / (members * length)
            res[f"{label}_K{K}_cta_ns_per_mm"] = ms * 1e6 / (K * length)
            res[f"{label}_K{K}_cluster"] = pk.probe_geometry(
                "chain", n + 1, members, K, X.device.index).cluster \
                if label == "highest" else 1
    res["ideal_ns_at_67tflops_fp32"] = 2.0 * (n + 1) ** 3 / PEAK_FP32_FLOPS * 1e9
    res["device"] = torch.cuda.get_device_name(device)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--members", type=int, default=32)
    ap.add_argument("--len", dest="length", type=int, default=40)
    ap.add_argument("--reps", type=int, default=30)
    a = ap.parse_args(argv)
    print(json.dumps(run(a.n, a.members, a.length, a.reps)))


if __name__ == "__main__":
    main()
