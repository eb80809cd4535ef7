"""Command-line drivers of the port (vch_tpu/cli.py), on the CUDA card.

    python -m vch_tpu_torch.cli optimize1d   — GD_1D.py equivalent
    python -m vch_tpu_torch.cli optimize2d   — GD2_configured.py equivalent
    python -m vch_tpu_torch.cli forward1d|forward2d — standalone forward solves
    python -m vch_tpu_torch.cli sweep2d      — batched (b3, kappa) sweep
    python -m vch_tpu_torch.cli show-control optimal_control.npy
                                             — `read data file.py` equivalent

The subcommands, flags, defaults, printed lines and artifact file names are
vch_tpu's, with one flag added: `--device` (default `cuda`: the commands
run on the card, and raise where there is none; `--device cpu` runs the
plain PyTorch versions on the CPU). `--dtype` defaults to float32 on the
card and float64 on the CPU. `--interactive` prompts for every config field
with the previous run's values shown (config.get_user_input_for_config).

`--mesh` (sweep2d) shards the batch over every rank of the world and
`--grid-shard` (optimize2d) the grid's x-axis (parallel/mesh.py,
parallel/spatial.py): one process per device, launched by `torchrun
--nproc-per-node N python -m vch_tpu_torch.cli ...`; without a launcher the
world is this one process (on one card, a mesh of one). The plots need
matplotlib: where artifacts are asked for (no `--no-artifacts`) and it is
missing, a command raises before it solves anything.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from vch_tpu_torch.utils.checkpoint import host_numpy as _host

def _add_common(p):
    p.add_argument("--interactive", action="store_true",
                   help="prompt for every config field (reference behavior)")
    p.add_argument("--dtype", default=None, choices=["float32", "float64"],
                   help="solver dtype (default: float32 on the card, "
                        "float64 on the CPU)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda, the card; raises "
                        "without one; 'cpu' runs the plain PyTorch "
                        "versions)")
    p.add_argument("--max-iter", type=int, default=None)
    p.add_argument("--target", type=int, default=1,
                   help="phi_T choice (1d: 1=sin,2=cos,3=tan; 2d: 1=sin,2=circle)")
    p.add_argument("--tracking", type=int, default=1,
                   help="phi_Q choice (1=ramp, 2=zeros)")
    p.add_argument("--no-artifacts", action="store_true",
                   help="skip plots/GIF generation")
    p.add_argument("--out-prefix", default="",
                   help="prefix for output artifact files")
    p.add_argument("--checkpoint", default=None,
                   help="path to write a PGD state checkpoint after the run")


def _device_dtype(args):
    """The run's device (through resolve_device: the card unless asked
    otherwise) and dtype (--dtype, else float32 on the card, float64 on the
    CPU)."""
    from vch_tpu_torch.device import resolve_device
    device = resolve_device(args.device)
    dtype = args.dtype or ("float64" if device.type == "cpu" else "float32")
    return device, dtype


def _require_plotting(args):
    """Raise before any solve when artifacts are asked for and matplotlib
    is missing."""
    if args.no_artifacts:
        return
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "the plots of this command need matplotlib, which is not "
            "installed; pass --no-artifacts to run without them") from e


def cmd_forward1d(args):
    from vch_tpu_torch.config import (ForwardSolverConfig1D,
                                      get_user_input_for_config, load_params)
    _require_plotting(args)
    device, dtype = _device_dtype(args)
    if args.interactive:
        prev = load_params().forward_solver
        cfg = get_user_input_for_config(ForwardSolverConfig1D,
                                        "Forward Solver Parameters", prev)
        cfg = dataclasses.replace(cfg, dtype=dtype)
    else:
        cfg = ForwardSolverConfig1D(dtype=dtype)
    from vch_tpu_torch.models.forward1d import ForwardSolver1D
    solver = ForwardSolver1D(cfg, device=device)
    phi_hist, x, t_hist = solver.simulate()
    phi = _host(phi_hist[-1])
    print(f"steps={solver.M}  ||phi(T)||_inf={np.abs(phi).max():.5f}")
    if not args.no_artifacts:
        from vch_tpu_torch.viz import plot_comparison_1d
        path = plot_comparison_1d(x, phi_hist[0], np.zeros_like(x), phi,
                                  path=args.out_prefix + "forward1d_final.png")
        print("saved", path)
    return 0


def cmd_forward2d(args):
    from vch_tpu_torch.config import (ForwardSolverConfig2D,
                                      get_user_input_for_config, load_params)
    _require_plotting(args)
    device, dtype = _device_dtype(args)
    if args.interactive:
        prev = load_params("last_run_config_2d.json", two_d=True).forward_solver
        cfg = get_user_input_for_config(ForwardSolverConfig2D,
                                        "Forward Solver Parameters", prev)
        cfg = dataclasses.replace(cfg, dtype=dtype)
    else:
        cfg = ForwardSolverConfig2D(dtype=dtype, Nx=args.n, Ny=args.n)
    from vch_tpu_torch.models.forward2d import ForwardSolver2D
    solver = ForwardSolver2D(cfg, device=device)
    phi_hist, (x, y), t_hist = solver.simulate()
    phi = _host(phi_hist[-1])
    print(f"steps={solver.M}  ||phi(T)||_inf={np.abs(phi).max():.5f}")
    if not args.no_artifacts:
        from vch_tpu_torch.viz import plot_final_imshow_2d
        path = plot_final_imshow_2d(phi, x, y, cfg.T,
                                    path=args.out_prefix + "forward2d_final.png")
        print("saved", path)
    return 0


def _post_optimize(args, prob, res, one_d: bool):
    """The closing report of both optimize commands (ref GD_1D.py:487-518):
    the control saved, the coercivity probe, the sparsity check, the alpha
    advisor, the time study, the checkpoint and the convergence plot."""
    from vch_tpu_torch.utils.timers import PhaseTimers
    print(f"\nOptimization finished: {res.iterations} iterations, "
          f"converged={res.converged}, final cost {res.cost_history[-1]:.6f}")
    np.save(args.out_prefix + "optimal_control.npy", res.u_optimal)
    print(f"Optimal control saved as '{args.out_prefix}optimal_control.npy'")

    d2s = prob.second_order_check(res, num_directions=3 if one_d else 5)
    for i, d2 in enumerate(d2s, 1):
        print(f"  Direction {i}: estimated second derivative = {d2:.6e}")
    if all(v > 0 for v in d2s):
        print("Coercivity condition holds in the tested directions.")
    else:
        print("Some directions show non-positive second derivatives.")
    prob.verify_sparsity(res)

    if res.advisor_alpha is not None:
        print(f"[ALPHA ADVISOR] good initial alpha_max next time: "
              f"{res.advisor_alpha:.4f}")

    timers = PhaseTimers()
    for k, v in res.timers.items():
        timers.add(k, v)
    timers.report()

    if args.checkpoint:
        from vch_tpu_torch.utils.checkpoint import save_checkpoint
        save_checkpoint(args.checkpoint,
                        {"u": res.u_optimal, "r": res.r_optimal,
                         "cost_history": np.asarray(res.cost_history)},
                        {"iterations": res.iterations,
                         "converged": res.converged})
        print("checkpoint saved to", args.checkpoint)

    if not args.no_artifacts:
        from vch_tpu_torch.viz import plot_convergence
        p = plot_convergence(res.cost_history, res.tracking_err_history,
                             res.terminal_err_history,
                             path=args.out_prefix + "convergence_analysis.png")
        print("saved", p)


def cmd_optimize1d(args):
    from vch_tpu_torch.config import (ForwardSolverConfig1D,
                                      OptimizationConfig,
                                      get_user_input_for_config,
                                      get_yes_no_input, load_params,
                                      save_params)
    _require_plotting(args)
    device, dtype = _device_dtype(args)
    if args.interactive:
        prev = load_params()
        fwd = get_user_input_for_config(ForwardSolverConfig1D,
                                        "STEP 1: Configure the Forward Solver",
                                        prev.forward_solver)
        fwd = dataclasses.replace(fwd, dtype=dtype)
        if not get_yes_no_input("Proceed to optimization with these parameters?"):
            return 0
        opt = get_user_input_for_config(OptimizationConfig,
                                        "STEP 2: Configure the Optimization",
                                        prev.optimization)
    else:
        fwd = ForwardSolverConfig1D(dtype=dtype)
        opt = OptimizationConfig()
    from vch_tpu_torch.control.problems import ControlProblem1D
    prob = ControlProblem1D(fwd, opt, choice_t=args.target,
                            choice_q=args.tracking,
                            gradient_mode=args.gradient, device=device)
    res = prob.optimize(max_iter=args.max_iter)
    _post_optimize(args, prob, res, one_d=True)
    if not args.no_artifacts:
        from vch_tpu_torch.viz import (plot_comparison_1d,
                                       save_evolution_gif_1d)
        phi_final = res.phi_final[-1]
        plot_comparison_1d(prob.x, prob.phi0, prob.phi_T_target, phi_final,
                           path=args.out_prefix + "phi_comparison_plot.png")
        save_evolution_gif_1d(prob.x, res.phi_final, prob.t_hist,
                              prob.phi_T_target,
                              path=args.out_prefix + "phi_evolution.gif")
        print("saved comparison plot + evolution gif")
    save_params(fwd, opt, res.iterations,
                filepath=args.out_prefix + "last_run_config.json")
    return 0


def cmd_optimize2d(args):
    from vch_tpu_torch.config import (ForwardSolverConfig2D,
                                      OptimizationConfig,
                                      get_user_input_for_config, load_params,
                                      save_params)
    _require_plotting(args)
    device, dtype = _device_dtype(args)
    if args.interactive:
        prev = load_params("last_run_config_2d.json", two_d=True)
        fwd = get_user_input_for_config(ForwardSolverConfig2D,
                                        "Forward Solver Parameters",
                                        prev.forward_solver)
        fwd = dataclasses.replace(fwd, dtype=dtype)
        opt = get_user_input_for_config(OptimizationConfig,
                                        "Optimization Parameters",
                                        prev.optimization)
    else:
        fwd = ForwardSolverConfig2D(dtype=dtype, Nx=args.n, Ny=args.n,
                                    T=args.T)
        opt = OptimizationConfig.defaults_2d()
    if args.grid_shard:
        # the field's x-axis over every rank (vch_tpu/cli.py:207-218)
        from vch_tpu_torch.parallel.spatial import GridShardedProblem2D
        gprob = GridShardedProblem2D(fwd, opt, choice_t=args.target,
                                     choice_q=args.tracking, device=device)
        res = gprob.optimize(max_iter=args.max_iter)
        print(f"grid-sharded over {gprob.fwd.mesh.size()} devices; "
              f"baseline Newton solves {gprob.newton_solves}")
        _post_optimize(args, gprob, res, one_d=False)
        return 0
    from vch_tpu_torch.control.problems import ControlProblem2D
    prob = ControlProblem2D(fwd, opt, choice_t=args.target,
                            choice_q=args.tracking, device=device)
    res = prob.optimize(max_iter=args.max_iter)
    _post_optimize(args, prob, res, one_d=False)
    # natural-evolution comparison (ref GD2_configured.py:387): how far the
    # uncontrolled system ends from the target against the controlled one,
    # from the baseline march the problem ran at construction
    phi_nat = _host(prob.phi_hist0[-1])
    tgt = _host(prob.phi_T_target)
    nrm = np.linalg.norm
    err_nat = nrm(phi_nat - tgt) / max(nrm(tgt), 1e-12)
    err_ctl = nrm(res.phi_final[-1] - tgt) / max(nrm(tgt), 1e-12)
    print(f"Natural evolution terminal error {err_nat:.4f} vs "
          f"controlled {err_ctl:.4f} "
          f"(improvement {(1 - err_ctl / max(err_nat, 1e-12)) * 100:.1f}%)")
    if not args.no_artifacts:
        from vch_tpu_torch.viz import (generate_all_3d_plots_2d,
                                       parameter_card,
                                       plot_comparison_panels_2d,
                                       plot_mid_slice_comparison_2d,
                                       save_timelapse_2d)
        phi_final = res.phi_final[-1]
        # the reference's 3D-surface suite of four (visualization_3d.py:
        # 82-112, emitted by GD2_configured's final analysis)
        generate_all_3d_plots_2d(prob.phi0, phi_nat, phi_final, tgt,
                                 prob.x, prob.y, prefix=args.out_prefix)
        plot_comparison_panels_2d(prob.phi0, phi_final, tgt, prob.x, prob.y,
                                  path=args.out_prefix + "comparison_2d.png")
        plot_mid_slice_comparison_2d(phi_final, tgt, prob.x, prob.y,
                                     path=args.out_prefix + "mid_slice_2d.png")
        save_timelapse_2d(res.phi_final, prob.x, prob.y, prob.t_hist,
                          path=args.out_prefix + "phi_timelapse_2d.gif")
        parameter_card({**fwd.to_dict(), **opt.to_dict()},
                       path=args.out_prefix + "parameter_card.png")
        print("saved 2D artifact suite")
    save_params(fwd, opt, res.iterations,
                filepath=args.out_prefix + "last_run_config_2d.json")
    return 0


def cmd_sweep2d(args):
    """Batched (b3, kappa_spar) sweep, on one card or, with --mesh, over
    every rank of the world (the reference runs one scenario per
    process)."""
    from vch_tpu_torch.config import ForwardSolverConfig2D
    from vch_tpu_torch.parallel.batch import BatchedProblem2D, sweep_2d
    from vch_tpu_torch.utils.checkpoint import save_checkpoint
    device, dtype = _device_dtype(args)
    cfg = ForwardSolverConfig2D(dtype=dtype, Nx=args.n, Ny=args.n, T=args.T)
    b3s = [float(v) for v in args.b3.split(",")]
    kss = [float(v) for v in args.kappa.split(",")]
    prob = BatchedProblem2D(cfg, device=device, use_mesh=args.mesh)
    sc = sweep_2d(cfg, b3_values=b3s, kappa_values=kss,
                  choice_t=args.target, choice_q=args.tracking)
    out = prob.run(sc, max_iter=args.max_iter or 50)
    print(f"batch {sc.batch}: converged {out['converged'].sum()}, "
          f"final costs {out['cost_history'][-1].round(5)}")
    if args.checkpoint:
        save_checkpoint(args.checkpoint,
                        {"u": out["u"], "cost_history": out["cost_history"],
                         "b3": sc.b3, "kappa_spar": sc.kappa_spar},
                        {"n": args.n, "T": args.T})
        print("sweep results saved to", args.checkpoint)
    return 0


def cmd_show_control(args):
    """Equivalent of the reference's `read data file.py` loader."""
    u = np.load(args.file)
    print(f"loaded {args.file}: shape={u.shape}, dtype={u.dtype}")
    print(f"max|u|={np.abs(u).max():.6f}, "
          f"sparsity={(np.abs(u) < 1e-8).mean() * 100:.2f}% zeros")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vch_tpu_torch",
                                 description="sparse optimal control of the "
                                 "viscous Cahn-Hilliard system on a CUDA card "
                                 "(the PyTorch port of vch_tpu)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("forward1d", help="standalone 1D forward solve")
    _add_common(p)
    p.set_defaults(fn=cmd_forward1d)

    p = sub.add_parser("forward2d", help="standalone 2D forward solve")
    _add_common(p)
    p.add_argument("--n", type=int, default=128)
    p.set_defaults(fn=cmd_forward2d)

    p = sub.add_parser("optimize1d", help="1D PGD optimization (GD_1D)")
    _add_common(p)
    p.add_argument("--gradient", default="reference",
                   choices=["reference", "exact"],
                   help="'reference' = the reference's approximate adjoint; "
                        "'exact' = implicit-differentiation exact gradient")
    p.set_defaults(fn=cmd_optimize1d)

    p = sub.add_parser("optimize2d", help="2D PGD optimization (GD2)")
    _add_common(p)
    p.add_argument("--n", type=int, default=128)
    p.add_argument("--T", type=float, default=1.0)
    p.add_argument("--grid-shard", action="store_true",
                   help="shard the grid's x-axis over all devices "
                        "(for grids where one scenario outgrows a card; "
                        "one process per device under torchrun)")
    p.set_defaults(fn=cmd_optimize2d)

    p = sub.add_parser("sweep2d", help="batched (b3, kappa) sweep")
    _add_common(p)
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--T", type=float, default=1.0)
    p.add_argument("--b3", default="1e-4,2e-4", help="comma-separated b3 values")
    p.add_argument("--kappa", default="5e-5,1e-4", help="comma-separated kappa_spar values")
    p.add_argument("--mesh", action="store_true",
                   help="shard the batch over all devices (one process "
                        "per device under torchrun)")
    p.set_defaults(fn=cmd_sweep2d)

    p = sub.add_parser("show-control", help="inspect a saved control .npy")
    p.add_argument("file")
    p.set_defaults(fn=cmd_show_control)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
