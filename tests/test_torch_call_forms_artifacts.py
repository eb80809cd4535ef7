"""vch_tpu's call forms through the port's entry points that write files,
on the CPU: utils/checkpoint.py `save_checkpoint` and the nine plots of
viz/plots.py that take fields.

The same two checks as tests/test_torch_call_forms.py, whose coverage guard
counts the cases here, each on what the file holds when read back:

(a) the port on host numpy against vch_tpu on the same arrays, bit for
    bit: the checkpoint's arrays and meta (`load_checkpoint`), each
    image's pixels (a PNG through `matplotlib.image.imread`, every frame of
    a GIF through Pillow, on which matplotlib reads images);
(b) on the emulated card (`torch.Tensor.__array__` raises a CUDA tensor's
    TypeError), the port on tensors writes what it wrote from the numpy
    arrays, bit for bit.
"""
import os
import tempfile

import numpy as np
import pytest
import torch

import test_torch_call_forms as cf
from test_torch_call_forms import card  # noqa: F401  (the fixture)
from vch_tpu.utils import checkpoint as jckpt

from vch_tpu_torch.utils import checkpoint as tckpt

pytest.importorskip("matplotlib")
from matplotlib import image as mpimg  # noqa: E402
from PIL import Image, ImageSequence  # noqa: E402

from vch_tpu.viz import plots as jplots  # noqa: E402
from vch_tpu_torch.viz import plots as tplots  # noqa: E402


def _read_image(path):
    """A written image's pixels: a PNG as imread gives it, a GIF as the
    stack of its frames."""
    if path.endswith(".png"):
        return mpimg.imread(path)
    with Image.open(path) as im:
        return np.stack([np.asarray(f.convert("RGBA"))
                         for f in ImageSequence.Iterator(im)])


def _written(call):
    """call(directory) writes files and returns their path(s); returns
    their pixels, by name, read back before the directory goes."""
    with tempfile.TemporaryDirectory() as d:
        out = call(d)
        paths = out if isinstance(out, list) else [out]
        return {os.path.relpath(p, d): _read_image(p) for p in paths}


# --- the inputs (from a numpy seed) ----------------------------------------

_rng = np.random.default_rng(26)
X1 = np.linspace(0.0, 1.0, 21)
HIST1 = 0.5 * _rng.standard_normal((5, 21))
X2, Y2 = np.linspace(0.0, 1.0, 13), np.linspace(0.0, 2.0, 13)
HIST2 = 0.5 * _rng.standard_normal((5, 13, 13))
PHI2, TARGET2 = (0.5 * _rng.standard_normal((13, 13)) for _ in range(2))
T_HIST = np.linspace(0.0, 0.03, 5)
HISTORIES = (np.array([3.0, 2.0, 1.0]), np.array([0.5, 0.4, 0.3]),
             np.array([0.6, 0.3, 0.2]))

# (vch_tpu name) -> the call (module, form, directory): the arrays in the
# form under test, each file under the directory
PLOTS = {
    "plot_comparison_1d": lambda m, f, d: m.plot_comparison_1d(
        f(X1), f(HIST1[0]), f(HIST1[1]), f(HIST1[-1]),
        path=os.path.join(d, "cmp.png"), T=0.03),
    "plot_convergence": lambda m, f, d: m.plot_convergence(
        *map(f, HISTORIES), path=os.path.join(d, "conv.png")),
    "save_evolution_gif_1d": lambda m, f, d: m.save_evolution_gif_1d(
        f(X1), f(HIST1), f(T_HIST), f(HIST1[-1]),
        path=os.path.join(d, "evo.gif"), skip=2),
    "plot_final_imshow_2d": lambda m, f, d: m.plot_final_imshow_2d(
        f(PHI2), f(X2), f(Y2), 0.03, path=os.path.join(d, "final.png")),
    "plot_surface_2d": lambda m, f, d: m.plot_surface_2d(
        f(PHI2), f(X2), f(Y2), "phi", os.path.join(d, "surface.png")),
    "generate_all_3d_plots_2d": lambda m, f, d: m.generate_all_3d_plots_2d(
        f(HIST2[0]), f(HIST2[-1]), f(PHI2), f(TARGET2), f(X2), f(Y2),
        prefix=os.path.join(d, "run_")),
    "plot_comparison_panels_2d": lambda m, f, d: m.plot_comparison_panels_2d(
        f(HIST2[0]), f(PHI2), f(TARGET2), f(X2), f(Y2),
        path=os.path.join(d, "panels.png")),
    "plot_mid_slice_comparison_2d":
        lambda m, f, d: m.plot_mid_slice_comparison_2d(
            f(PHI2), f(TARGET2), f(X2), f(Y2),
            path=os.path.join(d, "slice.png")),
    "save_timelapse_2d": lambda m, f, d: m.save_timelapse_2d(
        f(HIST2), f(X2), f(Y2), f(T_HIST),
        path=os.path.join(d, "timelapse.gif")),
}


def _plot(name):
    call = PLOTS[name]
    return (lambda inp: _written(lambda d: call(tplots, inp, d)),
            lambda: _written(lambda d: call(jplots, cf._numpy, d)))


STATE = dict(u=_rng.standard_normal((3, 4, 5)), alpha=np.array([0.5, 2.0]),
             plateau=np.array([0, 3], np.int64),
             converged=np.array([True, False]))
META = dict(iteration=7, note="mid-run")


def _checkpoint():
    def call(save, load, inp):
        with tempfile.TemporaryDirectory() as d:
            path = save(os.path.join(d, "ckpt.npz"),
                        {k: inp(v) for k, v in STATE.items()}, META)
            state, meta = load(path)
        assert meta == META
        return state

    return (lambda inp: call(tckpt.save_checkpoint, tckpt.load_checkpoint,
                             inp),
            lambda: call(jckpt.save_checkpoint, jckpt.load_checkpoint,
                         cf._numpy))


# (vch_tpu module, qualified name) -> the case's (port(form), vch_tpu())
CASES = {("viz/plots.py", name): _plot(name) for name in PLOTS}
CASES[("utils/checkpoint.py", "save_checkpoint")] = _checkpoint()
CASE_IDS = [f"{rel}::{name}" for rel, name in CASES]


@pytest.mark.parametrize("key", list(CASES), ids=CASE_IDS)
def test_written_file_matches_vch_tpu(key):
    port, ref = CASES[key]
    cf._assert_same_bits(port(cf._numpy), ref())


@pytest.mark.parametrize("key", list(CASES), ids=CASE_IDS)
def test_port_tensors_on_the_emulated_card(key, request):
    port, _ = CASES[key]
    base = port(cf._numpy)
    request.getfixturevalue("card")
    with pytest.raises(TypeError, match="cuda:0 device type"):
        np.asarray(torch.zeros(1))
    cf._assert_same_bits(port(cf._tensor), base)
