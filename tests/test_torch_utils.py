"""The port's utils (vch_tpu_torch/utils: PhaseTimers, the checkpoints,
MetricsLogger, SolveCounters and the profiler trace) against vch_tpu's
(vch_tpu/utils). Mirrors tests/test_config_utils.py's checkpoint and timer
cases; checkpoints are read across the two packages in both directions."""
import json
import os

import numpy as np
import pytest
import torch

import vch_tpu.utils as ju
import vch_tpu_torch.utils as tu


def test_exports_match_vch_tpu():
    assert sorted(tu.__all__) == sorted(ju.__all__)


def test_checkpoint_roundtrip(tmp_path):
    """Mirrors tests/test_config_utils.py::test_checkpoint_roundtrip, with
    tensors in the state (saved as host numpy arrays)."""
    p = str(tmp_path / "ckpt.npz")
    u = np.random.default_rng(0).standard_normal((3, 4))
    state = {"u": torch.as_tensor(u), "alpha": np.asarray([1.5, 2.0]),
             "k": torch.arange(5, dtype=torch.int32)}
    meta = {"iteration": 12, "converged": False}
    assert tu.save_checkpoint(p, state, meta) == p
    s2, m2 = tu.load_checkpoint(p)
    assert np.array_equal(s2["u"], u)
    assert np.array_equal(s2["alpha"], state["alpha"])
    assert s2["k"].dtype == np.int32 and np.array_equal(s2["k"], np.arange(5))
    assert m2 == meta
    assert os.listdir(tmp_path) == ["ckpt.npz"]     # no temporary left


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoint_interchange(tmp_path, direction):
    """A checkpoint written by either package is read by the other: the
    same arrays, dtypes and meta, and the same .npz entries."""
    rng = np.random.default_rng(1)
    state = {"u": rng.standard_normal((2, 5, 6)),
             "cost_history": rng.standard_normal(4).astype(np.float32),
             "b3": np.asarray([1e-4, 2e-4])}
    meta = {"n": 16, "T": 0.1, "converged": [True, False]}
    p = str(tmp_path / "c.npz")
    save, load = ((ju.save_checkpoint, tu.load_checkpoint)
                  if direction == "jax_to_torch"
                  else (tu.save_checkpoint, ju.load_checkpoint))
    save(p, state, meta)
    s2, m2 = load(p)
    assert m2 == meta
    assert sorted(s2) == sorted(state)
    for k, v in state.items():
        assert s2[k].dtype == v.dtype and np.array_equal(s2[k], v), k
    with np.load(p) as data:
        assert sorted(data.files) == sorted(list(state) + ["__meta__"])


def test_phase_timers_report(capsys):
    """Mirrors tests/test_config_utils.py::test_phase_timers_report; the
    report's text is vch_tpu's for the same totals."""
    t = tu.PhaseTimers()
    with t.phase("solve"):
        pass
    t.add("solve", 1.0)
    text = t.report()
    assert "solve" in text
    assert t.counts["solve"] == 2
    a, b = tu.PhaseTimers(), ju.PhaseTimers()
    for name, sec in (("backward_total", 0.25), ("trial", 1.5),
                      ("trial", 0.5), ("idle", 0.0)):
        a.add(name, sec)
        b.add(name, sec)
    capsys.readouterr()
    assert a.report("TITLE") == b.report("TITLE")
    assert a.rate("trial") == b.rate("trial") == 1.0
    assert a.rate("idle") == 0.0


def test_metrics_logger(tmp_path, capsys):
    """One JSON object a line, appended and echoed, with vch_tpu's keys."""
    p = str(tmp_path / "m.jsonl")
    lt, lj = tu.MetricsLogger(p, echo=True), ju.MetricsLogger(echo=False)
    rt = lt.log("iter", k=1, cost=np.float32(0.5), tag="a")
    rj = lj.log("iter", k=1, cost=np.float32(0.5), tag="a")
    lt.log("done", converged=True)
    assert list(rt) == list(rj) == ["event", "t", "k", "cost", "tag"]
    lines = open(p).read().splitlines()
    assert [json.loads(x)["event"] for x in lines] == ["iter", "done"]
    assert json.loads(lines[0])["cost"] == 0.5
    assert capsys.readouterr().out.splitlines() == lines


def test_solve_counters_summary():
    """SolveCounters' summary is vch_tpu's for the same records."""
    a = tu.SolveCounters(time_steps=100, batch=8)
    b = ju.SolveCounters(time_steps=100, batch=8)
    for rec in ((3, 1.5, 12000), (2, 0.75, 7000)):
        a.record(*rec)
        b.record(*rec)
    assert a.summary() == b.summary()
    assert a.summary()["pgd_scenario_iters_per_s"] == round(8 * 5 / 2.25, 4)
    assert tu.SolveCounters(10, 1).summary()["newton_solves_per_s"] == 0.0


def test_trace_writes_chrome_trace(tmp_path):
    """trace(logdir) profiles the block (on the CPU here) and writes a
    Chrome trace into logdir."""
    d = str(tmp_path / "tr")
    with tu.trace(d) as got:
        a = torch.ones(64, 64, dtype=torch.float64)
        (a @ a).sum()
    assert got == d
    path = os.path.join(d, "trace.json")
    trace = json.load(open(path))
    assert trace["traceEvents"]
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
