"""Plotting and animation artifacts matching the reference's output set
(vch_tpu/viz/plots.py).

1D comparison and convergence plots and the evolution GIF
(GD_1D.py:521-603); the 2D imshow preview, 3D surfaces, parameter card,
MP4/GIF timelapse, 4-panel comparison with the target contour, mid-slice
comparison with its MSE, and format_time_hms (visualization_3d.py). Every
function takes tensors (on any device) or arrays, moves them to host numpy,
and writes a file. Matplotlib is imported lazily with the Agg backend, so
the suite is headless-safe and the package imports without matplotlib
(the card's machine has none: run the CLI there with --no-artifacts).
"""
from __future__ import annotations

import numpy as np

from vch_tpu_torch.utils.checkpoint import host_numpy as _np


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def format_time_hms(seconds: float) -> str:
    """hh:mm:ss formatting (ref visualization_3d.py:278-282)."""
    h, rem = divmod(int(seconds), 3600)
    m, s = divmod(rem, 60)
    return f"{h:02d}:{m:02d}:{s:02d}"


# ----------------------------------------------------------------------
# 1D
# ----------------------------------------------------------------------

def plot_comparison_1d(x, phi_initial, phi_T_target, phi_final,
                       path="phi_comparison_plot.png", T=None):
    """Initial vs target vs achieved final state (ref GD_1D.py:529-541)."""
    plt = _plt()
    x, phi_initial, phi_T_target, phi_final = map(
        _np, (x, phi_initial, phi_T_target, phi_final))
    fig = plt.figure(figsize=(12, 7))
    plt.plot(x, phi_initial, ":", color="gray", label="Initial State (t=0)",
             linewidth=2)
    plt.plot(x, phi_T_target, "--", color="red", label="Target State",
             linewidth=2.5)
    plt.plot(x, phi_final, "-", color="blue",
             label="Final State (Achieved with u*)", linewidth=3)
    plt.title("Effect of Optimal Control: Initial vs. Final vs. Target")
    plt.xlabel("Space (x)")
    plt.ylabel("Phase Field (phi)")
    plt.ylim(-1.1, 1.1)
    plt.legend()
    plt.grid(True, which="both", linestyle="--", linewidth=0.5)
    plt.tight_layout()
    plt.savefig(path, dpi=200)
    plt.close(fig)
    return path


def plot_convergence(cost_history, tracking_err_history, terminal_err_history,
                     path="convergence_analysis.png"):
    """Two-panel cost and relative-error convergence (ref GD_1D.py:544-561,
    visualization_3d.py:115-145)."""
    plt = _plt()
    cost_history, tracking_err_history, terminal_err_history = map(
        _np, (cost_history, tracking_err_history, terminal_err_history))
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 8), sharex=True,
                                   gridspec_kw={"height_ratios": [1.2, 1]})
    ax1.plot(range(len(cost_history)), cost_history, "k.-",
             label="Total Cost (J)")
    ax1.set_ylabel("Total Cost")
    ax1.grid(True, linestyle=":", alpha=0.5)
    ax1.legend(loc="upper right")
    ax1.set_title("Convergence Analysis Over Iterations")
    n = len(tracking_err_history)
    ax2.plot(range(1, n + 1), tracking_err_history, "o--",
             label="Tracking Error")
    ax2.plot(range(1, len(terminal_err_history) + 1), terminal_err_history,
             "o-", label="Terminal Error")
    ax2.set_yscale("log")
    ax2.set_xlabel("Iteration")
    ax2.set_ylabel("Relative L2 Error (log)")
    ax2.grid(True, which="both", linestyle=":", alpha=0.5)
    ax2.legend(loc="upper right")
    plt.tight_layout()
    plt.savefig(path, dpi=200)
    plt.close(fig)
    return path


def save_evolution_gif_1d(x, phi_hist, t_hist, phi_T_target,
                          path="phi_evolution.gif", skip=10, fps=20):
    """Evolution animation, every `skip`-th frame (ref GD_1D.py:577-602)."""
    plt = _plt()
    from matplotlib import animation
    x, phi_hist, t_hist, phi_T_target = map(
        _np, (x, phi_hist, t_hist, phi_T_target))
    fig, ax = plt.subplots(figsize=(10, 6))
    ax.plot(x, phi_T_target, "r--", label="Target State")
    line, = ax.plot(x, phi_hist[0], "b-", lw=2, label="Evolving State (phi)")
    time_text = ax.text(0.05, 0.9, "", transform=ax.transAxes)
    ax.set_ylim(-1.1, 1.1)
    ax.set_xlabel("Space (x)")
    ax.set_ylabel("Phase Field (phi)")
    ax.set_title("Evolution of phi under Optimal Control")
    ax.legend()
    ax.grid(True, linestyle="--")
    frames = phi_hist[::skip]
    times = t_hist[::skip]

    def update(i):
        line.set_ydata(frames[i])
        time_text.set_text(f"Time = {times[i]:.3f}s")
        return line, time_text

    ani = animation.FuncAnimation(fig, update, frames=len(frames),
                                  interval=50, blit=True)
    ani.save(path, writer="pillow", fps=fps, dpi=90)
    plt.close(fig)
    return path


# ----------------------------------------------------------------------
# 2D
# ----------------------------------------------------------------------

def plot_final_imshow_2d(phi, x, y, T, path="phi_final_2d.png"):
    """Final-state imshow preview (ref Forward2_solver.py:598-607,
    visualization_3d.py:23-37)."""
    plt = _plt()
    phi, x, y = map(_np, (phi, x, y))
    fig = plt.figure(figsize=(6, 5))
    extent = [x[0], x[-1], y[0], y[-1]]
    plt.imshow(phi.T, origin="lower", extent=extent, vmin=-1.0,
               vmax=1.0, cmap="RdBu_r", interpolation="bilinear")
    plt.title(f"Final Profile of phi at t={T}")
    plt.xlabel("x")
    plt.ylabel("y")
    plt.colorbar(label="phi")
    plt.tight_layout()
    plt.savefig(path, dpi=200)
    plt.close(fig)
    return path


def plot_surface_2d(phi, x, y, title, path, cmap="RdBu_r"):
    """3D surface plot (ref visualization_3d.py:40-112)."""
    plt = _plt()
    phi, x, y = map(_np, (phi, x, y))
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")
    xx, yy = np.meshgrid(x, y, indexing="ij")
    ax.plot_surface(xx, yy, phi, cmap=cmap, linewidth=0, antialiased=True)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("phi")
    ax.set_title(title)
    plt.tight_layout()
    plt.savefig(path, dpi=200)
    plt.close(fig)
    return path


def generate_all_3d_plots_2d(phi_initial, phi_natural_final,
                             phi_controlled_final, phi_target, x, y,
                             prefix=""):
    """The reference driver's 3D-surface suite of four
    (ref visualization_3d.py:82-112, emitted by GD2_configured's final
    analysis): initial state, natural (u = 0) final state, target and
    controlled final state, with the reference's titles and file names.
    Returns the written paths."""
    panels = [
        (phi_initial, "1. Initial State (t=0)", "3d_plot_initial_state.png"),
        (phi_natural_final, "2. Natural Evolution (Final State with u=0)",
         "3d_plot_natural_evolution.png"),
        (phi_target, "3. Target State (The Goal)",
         "3d_plot_target_state.png"),
        (phi_controlled_final, "4. Controlled Evolution (Final State with u*)",
         "3d_plot_controlled_evolution.png"),
    ]
    return [plot_surface_2d(z, x, y, title, prefix + fname, cmap="viridis")
            for z, title, fname in panels]


def plot_comparison_panels_2d(phi_initial, phi_final, phi_T_target, x, y,
                              path="comparison_2d.png"):
    """4-panel comparison with the target's zero contour
    (ref visualization_3d.py:200-240)."""
    plt = _plt()
    phi_initial, phi_final, phi_T_target, x, y = map(
        _np, (phi_initial, phi_final, phi_T_target, x, y))
    fig, axes = plt.subplots(2, 2, figsize=(11, 9))
    extent = [x[0], x[-1], y[0], y[-1]]
    panels = [
        (phi_initial, "Initial State"),
        (phi_final, "Final State (with u*)"),
        (phi_T_target, "Target State"),
        (phi_final - phi_T_target, "Error (final - target)"),
    ]
    for ax, (field, title) in zip(axes.ravel(), panels):
        im = ax.imshow(field.T, origin="lower", extent=extent, cmap="RdBu_r",
                       vmin=-1, vmax=1)
        ax.contour(x, y, phi_T_target.T, levels=[0.0], colors="k",
                   linewidths=0.8)
        ax.set_title(title)
        fig.colorbar(im, ax=ax, shrink=0.8)
    plt.tight_layout()
    plt.savefig(path, dpi=200)
    plt.close(fig)
    return path


def plot_mid_slice_comparison_2d(phi_final, phi_T_target, x, y,
                                 path="mid_slice_2d.png"):
    """The mid-y slice of the final state against the target's, with the
    MSE (ref visualization_3d.py:243-275)."""
    plt = _plt()
    phi_final, phi_T_target, x, y = map(_np, (phi_final, phi_T_target, x, y))
    mid = phi_final.shape[1] // 2
    slice_final = phi_final[:, mid]
    slice_target = phi_T_target[:, mid]
    mse = float(np.mean((slice_final - slice_target) ** 2))
    fig = plt.figure(figsize=(10, 6))
    plt.plot(x, slice_target, "r--", label="Target (mid slice)")
    plt.plot(x, slice_final, "b-", label="Final (mid slice)")
    plt.title(f"Mid-slice comparison (y={y[mid]:.3f}), MSE = {mse:.3e}")
    plt.xlabel("x")
    plt.ylabel("phi")
    plt.legend()
    plt.grid(True, linestyle="--", alpha=0.5)
    plt.tight_layout()
    plt.savefig(path, dpi=200)
    plt.close(fig)
    return path


def save_timelapse_2d(phi_hist, x, y, t_hist, path="phi_timelapse_2d.gif",
                      max_frames=200, fps=20):
    """Evolution animation, MP4 if ffmpeg is there, else GIF
    (ref visualization_3d.py:160-197)."""
    plt = _plt()
    from matplotlib import animation
    phi_hist, x, y, t_hist = map(_np, (phi_hist, x, y, t_hist))
    step = max(1, len(phi_hist) // max_frames)
    frames = phi_hist[::step]
    times = t_hist[::step]
    fig, ax = plt.subplots(figsize=(6, 5))
    extent = [x[0], x[-1], y[0], y[-1]]
    im = ax.imshow(frames[0].T, origin="lower", extent=extent, vmin=-1.0,
                   vmax=1.0, cmap="RdBu_r")
    title = ax.set_title("t = 0.000")
    fig.colorbar(im, ax=ax)

    def update(i):
        im.set_data(frames[i].T)
        title.set_text(f"t = {times[i]:.3f}")
        return im, title

    ani = animation.FuncAnimation(fig, update, frames=len(frames),
                                  interval=50, blit=False)
    if path.endswith(".mp4"):
        try:
            ani.save(path, writer="ffmpeg", fps=fps)
        except Exception:
            path = path[:-4] + ".gif"
            ani.save(path, writer="pillow", fps=fps, dpi=90)
    else:
        ani.save(path, writer="pillow", fps=fps, dpi=90)
    plt.close(fig)
    return path


def parameter_card(params: dict, path="parameter_card.png"):
    """Text card image of run parameters (ref visualization_3d.py:148-157)."""
    plt = _plt()
    fig = plt.figure(figsize=(6, 0.4 * max(4, len(params))))
    lines = [f"{k:<18} = {v}" for k, v in params.items()]
    plt.text(0.02, 0.98, "\n".join(lines), family="monospace", fontsize=11,
             va="top")
    plt.axis("off")
    plt.tight_layout()
    plt.savefig(path, dpi=200)
    plt.close(fig)
    return path
