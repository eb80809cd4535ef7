"""The port's command line (vch_tpu_torch/cli.py) against vch_tpu's
(vch_tpu/cli.py): each command run in-process by both, with the same
arguments (the port's with `--device cpu`) and distinct `--out-prefix`es,
in float64 at small sizes. Compared: the saved optimal_control.npy
(1e-9), the last_run_config[_2d].json files, the checkpoints through both
packages' load_checkpoint, and the printed lines (the wall-clock lines
left out; the finite-difference second derivatives to 1e-5 relative, as
their 1e-4 step amplifies roundoff)."""
import builtins
import os
import re
import sys

import numpy as np
import pytest
import torch

import test_torch_dist_cases as cases
import vch_tpu.cli as jcli
import vch_tpu_torch.cli as tcli
from vch_tpu.utils.checkpoint import load_checkpoint as j_load
from vch_tpu_torch.utils.checkpoint import load_checkpoint as t_load

# lines that carry wall-clock seconds or rates
_TIMED = re.compile(r"\d s\b| s \(|calls,|time:")
_FD = re.compile(r"second derivative = (\S+)")


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out


def _both(argv, capsys, tmp_path, monkeypatch, answers=None):
    """Run argv through both CLIs in tmp_path (prefixes j- and t-); with
    `answers`, input() answers from it in turn, in both runs."""
    monkeypatch.chdir(tmp_path)
    outs = {}
    for tag, main, extra in (("j", jcli.main, []),
                             ("t", tcli.main, ["--device", "cpu"])):
        if answers is not None:
            it = iter(answers)
            monkeypatch.setattr(builtins, "input", lambda prompt="": next(it))
        args = [a.replace("{p}", tag) for a in argv]
        rc, out = _run(main, args + ["--out-prefix", f"{tag}-"] + extra,
                       capsys)
        assert rc == 0
        outs[tag] = out.replace(f"{tag}-", "P-").replace(f"{tag}.npz",
                                                         "P.npz")
    return outs["j"], outs["t"]


def _same_lines(out_j, out_t):
    lj = [ln for ln in out_j.splitlines() if not _TIMED.search(ln)]
    lt = [ln for ln in out_t.splitlines() if not _TIMED.search(ln)]
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        ma, mb = _FD.search(a), _FD.search(b)
        if ma and mb:
            assert float(ma.group(1)) == pytest.approx(float(mb.group(1)),
                                                       rel=1e-5)
        else:
            assert a == b


def _cost_lines(out):
    return [ln for ln in out.splitlines()
            if ln.startswith(("iter ", "Optimization finished", "batch "))]


def _same_control(tmp_path):
    j = np.load(tmp_path / "j-optimal_control.npy")
    t = np.load(tmp_path / "t-optimal_control.npy")
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= 1e-9 * max(np.abs(j).max(), 1.0)
    return t


def _same_checkpoint(tmp_path, keys):
    """Both checkpoints read by both packages' loaders: the same arrays
    (1e-9) and the same meta."""
    loaded = {(w, l): f(str(tmp_path / f"{w}.npz"))
              for w in "jt" for l, f in (("j", j_load), ("t", t_load))}
    (sj, mj) = loaded[("j", "j")]
    for (s, m) in loaded.values():
        assert sorted(s) == sorted(keys)
        assert m == mj
        for k in keys:
            assert s[k].shape == sj[k].shape
            assert np.abs(s[k] - sj[k]).max() <= 1e-9 * max(
                np.abs(sj[k]).max(), 1.0), k
    return loaded[("t", "t")]


def test_optimize2d(tmp_path, capsys, monkeypatch):
    out_j, out_t = _both(["optimize2d", "--n", "16", "--T", "0.1",
                          "--max-iter", "2", "--no-artifacts",
                          "--checkpoint", "{p}.npz"],
                         capsys, tmp_path, monkeypatch)
    u = _same_control(tmp_path)
    assert u.shape == (11, 17, 17)
    assert (open(tmp_path / "t-last_run_config_2d.json").read()
            == open(tmp_path / "j-last_run_config_2d.json").read())
    state, meta = _same_checkpoint(tmp_path, ["u", "r", "cost_history"])
    assert np.array_equal(state["u"], u)
    assert meta["iterations"] == 2
    assert len(_cost_lines(out_t)) == 3
    assert "Natural evolution terminal error" in out_t
    _same_lines(out_j, out_t)


@pytest.mark.parametrize("gradient", ["reference", "exact"])
def test_optimize1d_interactive(tmp_path, capsys, monkeypatch, gradient):
    """optimize1d at N = 16, T = 0.1 (the 1D commands take their grid from
    the prompts): the same prompts answered the same way in both."""
    import vch_tpu.config as jc
    fwd = {"N": "16", "T": "0.1"}
    answers = ([fwd.get(n, "") for n in jc.ForwardSolverConfig1D.model_fields]
               + ["y"] + [""] * len(jc.OptimizationConfig.model_fields))
    out_j, out_t = _both(["optimize1d", "--interactive", "--max-iter", "2",
                          "--no-artifacts", "--gradient", gradient],
                         capsys, tmp_path, monkeypatch, answers=answers)
    u = _same_control(tmp_path)
    # the reference mode works in the reference layout (a duplicated t = 0
    # row), the exact mode in the core layout, in both packages
    assert u.shape == ((12, 17) if gradient == "reference" else (11, 17))
    assert (open(tmp_path / "t-last_run_config.json").read()
            == open(tmp_path / "j-last_run_config.json").read())
    assert len(_cost_lines(out_t)) == 3
    _same_lines(out_j, out_t)


def test_forward1d(tmp_path, capsys, monkeypatch):
    out_j, out_t = _both(["forward1d", "--no-artifacts"], capsys, tmp_path,
                         monkeypatch)
    assert out_t.startswith("steps=100  ||phi(T)||_inf=")
    assert out_t == out_j


def test_forward2d(tmp_path, capsys, monkeypatch):
    out_j, out_t = _both(["forward2d", "--n", "16", "--no-artifacts"], capsys,
                         tmp_path, monkeypatch)
    assert out_t.startswith("steps=100  ||phi(T)||_inf=")
    assert out_t == out_j


def test_sweep2d(tmp_path, capsys, monkeypatch):
    out_j, out_t = _both(["sweep2d", "--n", "16", "--T", "0.1", "--max-iter",
                          "2", "--b3", "1e-4,2e-4", "--kappa", "5e-5,1e-4",
                          "--checkpoint", "{p}.npz"],
                         capsys, tmp_path, monkeypatch)
    state, meta = _same_checkpoint(
        tmp_path, ["u", "cost_history", "b3", "kappa_spar"])
    assert state["u"].shape == (4, 11, 17, 17)
    assert meta == {"n": 16, "T": 0.1}
    assert len(_cost_lines(out_t)) == 3
    assert out_t == out_j


def test_show_control(tmp_path, capsys):
    p = str(tmp_path / "u.npy")
    u = np.zeros((5, 9))
    u[2, 3] = -0.25
    np.save(p, u)
    rc_j, out_j = _run(jcli.main, ["show-control", p], capsys)
    rc_t, out_t = _run(tcli.main, ["show-control", p], capsys)
    assert rc_t == rc_j == 0
    assert out_t == out_j
    assert "max|u|=0.250000, sparsity=97.78% zeros" in out_t


@pytest.mark.parametrize("argv", [["--help"], ["optimize2d", "--help"],
                                  ["sweep2d", "--help"]])
def test_help_exits(argv, capsys):
    with pytest.raises(SystemExit) as e:
        tcli.main(argv)
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "usage: vch_tpu_torch" in out


@pytest.fixture
def own_world():
    """Destroys the process group the test makes (test_torch_dist_cases)."""
    with cases.own_world():
        yield


@pytest.mark.parametrize("argv,flag", [
    (["optimize2d", "--n", "15", "--T", "0.05", "--grid-shard"],
     "--grid-shard"),
    (["sweep2d", "--n", "16", "--T", "0.1", "--mesh"], "--mesh")])
def test_multi_device_flags_raise(argv, flag, tmp_path, capsys, monkeypatch,
                                  own_world):
    """The multi-device flags, once refused naming ROADMAP A7, now run (the
    test keeps its name): both CLIs with the flag, vch_tpu over its 8
    virtual devices, the port over its world (here one process, gloo);
    the same printed lines and saved control (neither writes the config
    JSON on the grid-sharded arm)."""
    out_j, out_t = _both(argv + ["--max-iter", "2", "--no-artifacts"],
                         capsys, tmp_path, monkeypatch)
    assert len(_cost_lines(out_t)) == 3
    if flag == "--mesh":
        assert out_t == out_j
        return
    sharded = re.compile(r"grid-sharded over \d+ devices")
    assert "grid-sharded over 1 devices" in out_t
    assert "grid-sharded over 8 devices" in out_j
    _same_lines(sharded.sub("", out_j), sharded.sub("", out_t))
    _same_control(tmp_path)
    assert not (tmp_path / "t-last_run_config_2d.json").exists()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the behavior on a machine with no card")
@pytest.mark.parametrize("argv", [
    ["forward2d", "--n", "16", "--no-artifacts"],
    ["sweep2d", "--n", "16"],
    ["optimize1d", "--no-artifacts", "--device", "cuda"]])
def test_runs_on_the_card_by_default(argv):
    """Without --device cpu the commands run on the card, and raise where
    there is none: no fallback to the CPU."""
    with pytest.raises(RuntimeError, match="CUDA device"):
        tcli.main(argv)


def test_artifacts_need_matplotlib(tmp_path, monkeypatch):
    """With artifacts asked for and no matplotlib, the command raises before
    it solves anything."""
    import vch_tpu_torch.control.problems as problems
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)

    def no_solve(*a, **k):
        raise AssertionError("solved before checking for matplotlib")
    monkeypatch.setattr(problems, "ControlProblem2D", no_solve)
    with pytest.raises(RuntimeError, match="--no-artifacts"):
        tcli.main(["optimize2d", "--n", "16", "--T", "0.1", "--device",
                   "cpu"])
    assert os.listdir(tmp_path) == []


def test_optimize2d_artifacts(tmp_path, capsys, monkeypatch):
    """The 2D artifact suite: vch_tpu's file names, each written."""
    pytest.importorskip("matplotlib")
    monkeypatch.chdir(tmp_path)
    rc, out = _run(tcli.main, ["optimize2d", "--n", "16", "--T", "0.05",
                               "--max-iter", "1", "--device", "cpu",
                               "--out-prefix", "a_"], capsys)
    assert rc == 0
    names = {"a_optimal_control.npy", "a_convergence_analysis.png",
             "a_3d_plot_initial_state.png", "a_3d_plot_natural_evolution.png",
             "a_3d_plot_target_state.png",
             "a_3d_plot_controlled_evolution.png", "a_comparison_2d.png",
             "a_mid_slice_2d.png", "a_phi_timelapse_2d.gif",
             "a_parameter_card.png", "a_last_run_config_2d.json"}
    assert set(os.listdir(tmp_path)) == names
    for n in names:
        assert os.path.getsize(tmp_path / n) > 0, n
    assert "saved 2D artifact suite" in out
