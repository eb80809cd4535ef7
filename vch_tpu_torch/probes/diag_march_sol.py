"""Speed of light of the fused 2D march on the CUDA card (counterpart of
scripts/diag_march_sol.py).

    python -m vch_tpu_torch.probes.diag_march_sol [--n 64] [--b 64]
        [--amort 2000] [--reps 3]

Times three things and sets them side by side:
  march    ForwardSolver2D.march_fused_batch at N = n, B = b, T = 1, float32,
           newton_tol 2e-4, u = 0, phi0 from init_phi_random_2d(N, N,
           DELTA_SEP, amp=0.1, seed=42 + i), in both forms: the member-blocked
           kernel (fused_march_block=None: 8 members per thread-block cluster
           of C CTAs at this grid, ops.march.launch_geometry) and one member
           per cluster (fused_march_block=0); per Newton solve = time / the
           Newton solves the march reports (the script's us_per_solve), and
           per solve in CTA time = time x CTAs / solves (us_per_solve_cta):
           the CTAs (B / 8 x C blocked, B x C one member each) run at once
           on their own SMs, not one after another as the TPU's grid cells
           do;
  chain    `ops.probe_kernels.matmul_chain`: the same count of dependent
           (n+1)^3 float32 products as one Newton solve holds
           (mm_per_solve), repeated amort times in one launch, so the
           launch's fixed cost is spread over amort solves: the march's
           serial-product floor, on the product the march runs (the
           cluster engine's left product). Once as the script runs it (one
           member, the chain's own cluster geometry: chain_ms, us_chain,
           chain_cluster), then once per form on that form's engine: K
           members per cluster of C CTAs, K and C the march's (the blocked
           form 8 members on the blocked march's C, per_member one member
           on the one-member march's C). Each form's us_chain is the
           chain's time per solve's worth of links, us_chain_cta = us_chain
           x C / K its CTA time per member, set beside the march's
           us_per_solve (chain_share, the script's ratio) and
           us_per_solve_cta (chain_share_cta);
  peak     torch.matmul on (4096, 4096) float32 (TF32 off): the card's rate
           for large products, and the time one solve's products would take
           at it (us_ideal).
The chain's inputs are the script's: a = 0.01 N(0, 1) from seed 0, v = ones;
its values fall below float32's range after ~45 links and the rest multiply
zeros, which costs the same on the FMA path. Each time is the mean over
`reps` calls after one warm-up, between two CUDA events. Prints one JSON
object, unrounded, with the card's name. Runs on the CUDA card; raises
without one.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

import vch_tpu_torch  # noqa: F401  (pins TF32 off)
from vch_tpu_torch.config import DELTA_SEP, ForwardSolverConfig2D
from vch_tpu_torch.models.forward2d import ForwardSolver2D
from vch_tpu_torch.ops import probe_kernels as pk
from vch_tpu_torch.ops.march import launch_geometry
from vch_tpu_torch.ops.potential import init_phi_random_2d
from vch_tpu_torch.probes._timing import cuda_device, time_ms

AMORT = 2000      # the script's: solves' worth of links in one chain launch
PEAK_N = 4096     # the edge of the large product that gives the peak rate


def mm_per_solve(trips: int) -> int:
    """Dense products in one Newton solve of the fused march kernel
    (scripts/diag_march_sol.py:69): the residual 4, the Schur rhs's
    Laplacian 2 and transform 2, 8 per Krylov trip, the back transform 2,
    dmu's Laplacian 2, one Armijo trial's residual 4."""
    return 4 + 2 + 2 + trips * 8 + 2 + 2 + 4


def chain_inputs(n: int, device, dtype=torch.float32):
    """The script's chain operands for an (n+1)^2 grid: a = 0.01 N(0, 1)
    (n+1, n+1) from a fresh seed-0 generator, v = ones, as (a, v[None])."""
    n1 = n + 1
    a = np.random.default_rng(0).standard_normal((n1, n1)) * 1e-2
    return (torch.as_tensor(a, dtype=dtype, device=device),
            torch.ones((1, n1, n1), dtype=dtype, device=device))


def _march(n: int, b: int, block, device, reps: int):
    """The march's numbers in one form, and its solver."""
    cfg = ForwardSolverConfig2D(Nx=n, Ny=n, T=1.0, dtype="float32",
                                newton_tol=2e-4, fused_march_block=block)
    s = ForwardSolver2D(cfg, device=device)
    phi0 = torch.as_tensor(np.stack([
        init_phi_random_2d(n, n, DELTA_SEP, amp=0.1, seed=42 + i)
        for i in range(b)]), dtype=torch.float32, device=device)
    u = torch.zeros((b, s.M + 1, n + 1, n + 1), dtype=torch.float32,
                    device=device)
    last = {}
    ms = time_ms(lambda: last.update(r=s.march_fused_batch(u, phi0)), reps)
    solves = int(last["r"][1].sum().item())
    bb = cfg.resolved_fused_block()
    members = bb if bb and b % bb == 0 else 1   # B / members clusters of C
    C = launch_geometry(n + 1, n + 1, b, device, members=members).cluster
    ctas = b // members * C
    return {"block": bb, "members": members, "cluster": C, "march_ms": ms,
            "solves": solves, "us_per_solve": ms * 1e3 / solves,
            "ctas": ctas, "us_per_solve_cta": ms * 1e3 * ctas / solves}, s


def _chain_ms(a, v, K, links, reps, cluster=None):
    """The chain's ms on K members of ones on one cluster (`cluster` CTAs;
    None: the chain's own geometry), and the cluster size that ran it."""
    X = v.expand(K, -1, -1).contiguous()
    ms = time_ms(lambda: pk.matmul_chain(a, X, K, links, cluster=cluster),
                 reps)
    return ms, pk.probe_geometry("chain", X.shape[1], K, K,
                                 X.device.index, cluster).cluster


def run(n: int = 64, b: int = 64, amort: int = AMORT, reps: int = 3,
        device=None) -> dict:
    """The three times and the script's derived numbers."""
    device = cuda_device(device)
    forms = {}
    for form, block in (("blocked", None), ("per_member", 0)):
        forms[form], solver = _march(n, b, block, device, reps)
    trips = solver.n_trips
    mm = mm_per_solve(trips)
    a, v = chain_inputs(n, device)
    chain_ms, chain_cluster = _chain_ms(a, v, 1, mm * amort, reps)
    us_chain = chain_ms * 1e3 / amort
    big = torch.ones((PEAK_N, PEAK_N), dtype=torch.float32, device=device)
    peak = 2.0 * PEAK_N ** 3 / (time_ms(lambda: big @ big, 10) * 1e-3)
    us_ideal = mm * 2.0 * (n + 1) ** 3 / peak * 1e6
    for f in forms.values():
        K, C = f["members"], f["cluster"]
        f["chain_ms"], _ = _chain_ms(a, v, K, mm * amort, reps, C)
        f["us_chain"] = f["chain_ms"] * 1e3 / amort
        f["us_chain_cta"] = f["us_chain"] * C / K
        f["chain_share"] = f["us_chain"] / f["us_per_solve"]
        f["chain_share_cta"] = f["us_chain_cta"] / f["us_per_solve_cta"]
        f["ideal_share"] = us_ideal / f["us_per_solve"]
    return {"n": n, "b": b, "M": solver.M, "trips": trips, "amort": amort,
            "reps": reps, "forms": forms, "mm_per_solve": mm,
            "chain_links": mm * amort, "chain_ms": chain_ms,
            "chain_cluster": chain_cluster, "us_chain": us_chain,
            "us_per_product": us_chain / mm,
            "peak_tflops": peak / 1e12, "us_ideal": us_ideal,
            "tf32": torch.backends.cuda.matmul.allow_tf32,
            "device": torch.cuda.get_device_name(device)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--b", type=int, default=64)
    ap.add_argument("--amort", type=int, default=AMORT)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    print(json.dumps(run(a.n, a.b, a.amort, a.reps)))


if __name__ == "__main__":
    main()
