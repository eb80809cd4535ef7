"""Plots and animations of the runs (vch_tpu/viz), host-side matplotlib,
imported lazily: importing this package needs no matplotlib."""
from vch_tpu_torch.viz.plots import (
    format_time_hms,
    generate_all_3d_plots_2d,
    parameter_card,
    plot_comparison_1d,
    plot_comparison_panels_2d,
    plot_convergence,
    plot_final_imshow_2d,
    plot_mid_slice_comparison_2d,
    plot_surface_2d,
    save_evolution_gif_1d,
    save_timelapse_2d,
)

__all__ = [
    "plot_comparison_1d", "plot_convergence", "save_evolution_gif_1d",
    "plot_final_imshow_2d", "plot_surface_2d", "generate_all_3d_plots_2d",
    "plot_comparison_panels_2d",
    "plot_mid_slice_comparison_2d", "save_timelapse_2d", "parameter_card",
    "format_time_hms",
]
