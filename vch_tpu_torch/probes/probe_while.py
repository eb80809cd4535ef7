"""In-kernel control flow on the CUDA card (counterpart of
scripts/probe_pallas_while.py).

    python -m vch_tpu_torch.probes.probe_while [--b 2] [--m 3] [--n 65]

Runs `ops.probe_kernels.while_probe` (one CTA per member: per step an outer
loop of data-dependent trips, each with an inner line search, the field
carried in registers across the M steps, one CTA reduction a trip, each
member's trip count written once) on the script's input, x = N(0, 1) (B, n, n) float32 from seed
0, and holds it with the script's gates (max |diff| < 1e-4, trip counts
equal) against `reference`, the script's float64 loop restated, and against
the plain PyTorch version on the card. Prints one JSON object (the
differences, the trip counts, the kernel's and the plain version's ms,
between CUDA events, and the card's name), then `PROBE OK`; a failed gate
raises. Runs on the CUDA card; raises without one.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

import vch_tpu_torch  # noqa: F401
from vch_tpu_torch.ops import probe_kernels as pk
from vch_tpu_torch.probes._timing import cuda_device, time_ms

TOL = 1e-4    # the script's gate on max |kernel - reference|


def inputs(B: int, n: int, device, dtype=torch.float32):
    """The script's x: N(0, 1) (B, n, n) float32 from seed 0."""
    x = np.random.default_rng(0).standard_normal((B, n, n)).astype(np.float32)
    return torch.as_tensor(x, dtype=dtype, device=device)


def reference(x: np.ndarray, M: int):
    """The script's float64 loop (scripts/probe_pallas_while.py:89): every
    inner line search accepts alpha = 1, so a trip scales phi by 0.7."""
    phi = x.astype(np.float64)
    ns = np.zeros((x.shape[0], 1), np.int32)
    for b in range(x.shape[0]):
        for _ in range(M):
            k = 0
            while k < 50:
                phi[b] *= 0.7
                k += 1
                if np.sqrt((phi[b] ** 2).sum()) < 1e-3:
                    break
            ns[b, 0] += k
    return phi, ns


def run(B: int = 2, M: int = 3, n: int = 65, reps: int = 20,
        device=None) -> dict:
    """The kernel, the plain version and the reference on the script's
    input; raises if a gate fails."""
    device = cuda_device(device)
    x = inputs(B, n, device)
    out, ns = pk.while_probe(x, M)
    plain, ns_plain = pk.while_probe_plain(x, M)
    ref, ns_ref = reference(x.cpu().numpy(), M)
    res = {"B": B, "M": M, "n": n,
           "max_abs_diff": float(np.abs(out.cpu().numpy() - ref).max()),
           "plain_max_abs_diff": float(np.abs(plain.cpu().numpy()
                                              - ref).max()),
           "max_abs_err_vs_plain": (out - plain).abs().max().item(),
           "ns": ns.cpu().ravel().tolist(),
           "ns_plain": ns_plain.cpu().ravel().tolist(),
           "ns_expected": ns_ref.ravel().tolist(),
           "ms": time_ms(lambda: pk.while_probe(x, M), reps),
           "plain_ms": time_ms(lambda: pk.while_probe_plain(x, M), 1),
           "device": torch.cuda.get_device_name(device)}
    fails = [k for k in ("max_abs_diff", "plain_max_abs_diff")
             if not res[k] < TOL]
    fails += [k for k in ("ns", "ns_plain") if res[k] != res["ns_expected"]]
    if fails:
        raise RuntimeError(f"while probe: {fails} fail the script's gates: "
                           f"{res}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--b", type=int, default=2)
    ap.add_argument("--m", type=int, default=3)
    ap.add_argument("--n", type=int, default=65)
    a = ap.parse_args(argv)
    print(json.dumps(run(a.b, a.m, a.n)))
    print("PROBE OK: compiled on the card")


if __name__ == "__main__":
    main()
