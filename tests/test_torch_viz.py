"""Headless smoke tests of the port's plots (vch_tpu_torch/viz), mirroring
tests/test_viz.py: each file written and non-empty, from numpy arrays and
from tensors; importing the package needs no matplotlib."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("matplotlib")

from vch_tpu_torch.viz import (  # noqa: E402
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

_AS = {"numpy": lambda a: a, "tensor": torch.as_tensor}


def _nonempty(path):
    assert os.path.exists(path) and os.path.getsize(path) > 0, path


def test_format_time_hms():
    assert format_time_hms(3723.4) == "01:02:03"
    assert format_time_hms(59) == "00:00:59"


def test_package_imports_without_matplotlib():
    """The port, its CLI and its plots import with matplotlib absent."""
    code = ("import sys; sys.modules['matplotlib'] = None; "
            "import vch_tpu_torch.viz, vch_tpu_torch.cli, vch_tpu_torch.ops,"
            " vch_tpu_torch.utils, vch_tpu_torch.config; print('ok')")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, timeout=120)
    assert out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_1d_artifacts(tmp_path, kind):
    as_ = _AS[kind]
    x = np.linspace(0, 1, 33)
    phi_hist = (0.5 * np.sin(2 * np.pi * x)[None, :]
                * np.linspace(0, 1, 12)[:, None])
    t = np.linspace(0, 1, 12)
    tgt = 0.7 * np.sin(2 * np.pi * x)
    _nonempty(plot_comparison_1d(as_(x), as_(phi_hist[0]), as_(tgt),
                                 as_(phi_hist[-1]),
                                 path=str(tmp_path / "cmp.png")))
    _nonempty(plot_convergence([3, 2, 1], [0.5, 0.4], as_(np.array([0.6, 0.3])),
                               path=str(tmp_path / "conv.png")))
    _nonempty(save_evolution_gif_1d(as_(x), as_(phi_hist), as_(t), as_(tgt),
                                    path=str(tmp_path / "evo.gif"), skip=3))


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_2d_artifacts(tmp_path, kind):
    as_ = _AS[kind]
    x = y = np.linspace(0, 1, 17)
    xx, yy = np.meshgrid(x, y, indexing="ij")
    phi = 0.7 * np.sin(2 * np.pi * xx) * np.cos(np.pi * yy)
    phi_hist = phi[None] * np.linspace(0, 1, 8)[:, None, None]
    t = np.linspace(0, 1, 8)
    _nonempty(plot_final_imshow_2d(as_(phi), x, y, 1.0,
                                   path=str(tmp_path / "f.png")))
    _nonempty(plot_surface_2d(as_(phi), x, y, "phi", str(tmp_path / "s.png")))
    _nonempty(plot_comparison_panels_2d(as_(phi_hist[0]), as_(phi_hist[-1]),
                                        as_(phi), x, y,
                                        path=str(tmp_path / "p.png")))
    _nonempty(plot_mid_slice_comparison_2d(as_(phi_hist[-1]), as_(phi), x, y,
                                           path=str(tmp_path / "m.png")))
    _nonempty(save_timelapse_2d(as_(phi_hist), x, y, as_(t),
                                path=str(tmp_path / "tl.gif"), max_frames=4))
    _nonempty(parameter_card({"Nx": 16, "T": 1.0},
                             path=str(tmp_path / "c.png")))


def test_3d_surface_suite(tmp_path):
    """Mirrors tests/test_viz.py::test_3d_surface_suite: the four surfaces
    of the 2D driver, with the reference's file names."""
    x = y = np.linspace(0, 1, 17)
    xx, yy = np.meshgrid(x, y, indexing="ij")
    phi = torch.as_tensor(0.7 * np.sin(2 * np.pi * xx) * np.cos(np.pi * yy))
    paths = generate_all_3d_plots_2d(0.1 * phi, 0.5 * phi, phi, -phi, x, y,
                                     prefix=str(tmp_path) + "/")
    assert len(paths) == 4
    names = {os.path.basename(p) for p in paths}
    assert names == {"3d_plot_initial_state.png",
                     "3d_plot_natural_evolution.png",
                     "3d_plot_target_state.png",
                     "3d_plot_controlled_evolution.png"}
    for p in paths:
        _nonempty(p)
