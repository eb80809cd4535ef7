"""Config persistence and interactive prompting of the port
(vch_tpu_torch/config.py) against vch_tpu's (vch_tpu/config.py): the JSON
files each package writes for the same configs, loading across the two in
both directions, the fallback on a missing or invalid file, and the
prompter on the same scripted input. Mirrors tests/test_config_utils.py's
config cases."""
import builtins
import json

import numpy as np
import pytest

import vch_tpu.config as jc
import vch_tpu_torch.config as tc


def _configs(pkg, two_d):
    if two_d:
        return (pkg.ForwardSolverConfig2D(Nx=32, Ny=16, T=0.25,
                                          dtype="float32", newton_tol=2e-4,
                                          use_pallas=True,
                                          fused_march_block=4),
                pkg.OptimizationConfig.defaults_2d(b3=1.5e-5))
    return (pkg.ForwardSolverConfig1D(N=64, T=0.5, kappa=1e-7,
                                      linsolve_1d="dense"),
            pkg.OptimizationConfig(b3=0.01, alpha_max=1e16))


@pytest.mark.parametrize("two_d", [False, True])
def test_save_params_writes_vch_tpu_json(tmp_path, two_d, capsys):
    """The same configs give the same file, byte for byte (keys, values,
    field order, float layout, indent=4), and the same message."""
    pj, pt = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jc.save_params(*_configs(jc, two_d), 42, filepath=pj)
    out_j = capsys.readouterr().out
    tc.save_params(*_configs(tc, two_d), 42, filepath=pt)
    out_t = capsys.readouterr().out
    assert open(pt).read() == open(pj).read()
    assert out_t.replace(pt, pj) == out_j


@pytest.mark.parametrize("two_d", [False, True])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_params_interchange(tmp_path, two_d, direction):
    """Each package's load_params reads the other's file into the same
    values."""
    p = str(tmp_path / "cfg.json")
    src, dst = (jc, tc) if direction == "jax_to_torch" else (tc, jc)
    src.save_params(*_configs(src, two_d), 7, filepath=p)
    loaded = dst.load_params(p, two_d=two_d)
    fwd, opt = _configs(jc, two_d)
    dump = lambda m: m.model_dump() if hasattr(m, "model_dump") \
        else m.to_dict()
    assert dump(loaded.forward_solver) == fwd.model_dump()
    assert dump(loaded.optimization) == opt.model_dump()
    assert loaded.last_run_iterations == 7
    assert type(loaded).__name__ == ("SimulationParameters2D" if two_d
                                     else "SimulationParameters")


@pytest.mark.parametrize("content", [None, "{not json", '{"forward_solver": '
                                     '{"N": 5}}', '{"optimization": '
                                     '{"u_min": 1.0, "u_max": 0.0}}',
                                     '{"forward_solver": null}'])
def test_load_params_fallback(tmp_path, capsys, content):
    """A missing or invalid file gives the defaults in both packages, with
    the same messages."""
    p = str(tmp_path / "cfg.json")
    if content is not None:
        open(p, "w").write(content)
    lj = jc.load_params(p)
    out_j = capsys.readouterr().out
    lt = tc.load_params(p)
    out_t = capsys.readouterr().out
    assert out_t == out_j
    assert "Using default parameters" in out_t
    assert lt.to_dict() == lj.model_dump()
    assert lt == tc.SimulationParameters()


def test_json_float_layout():
    """Floats as pydantic's JSON writes them, over magnitudes from 1e-300
    to 1e300 (the port writes them without pydantic)."""
    rng = np.random.default_rng(0)
    vals = [0.0, -0.0, 1.0, -2.5, 1e-5, 1e-6, 1e15, 1e16, 123456.789,
            0.1 + 0.2, 1 / 3, 5e-5, 2.5e-300, 1.7976931348623157e308]
    vals += list(10.0 ** rng.uniform(-300, 300, 200)
                 * rng.choice([-1, 1], 200))
    vals += list(np.round(rng.uniform(-1e6, 1e6, 50), 3))
    from pydantic_core import to_json
    for v in vals:
        assert tc._json_float(float(v)) == to_json(float(v)).decode(), v


def test_config_validators():
    """Mirrors tests/test_config_utils.py::test_config_validators; each
    error names its field."""
    with pytest.raises(tc.ConfigError) as e:
        tc.ForwardSolverConfig1D(c1=2.0, c2=1.0)
    assert e.value.errors == [("c2", "Value error, c2 (1.0) must be greater "
                                     "than c1 (2.0)")]
    with pytest.raises(ValueError):
        tc.OptimizationConfig(u_min=1.0, u_max=-1.0)
    with pytest.raises(ValueError, match="dtype"):
        tc.ForwardSolverConfig1D(dtype="float16")


@pytest.mark.parametrize("model,values", [
    ("ForwardSolverConfig1D", dict(N="5", T="abc", c1="x", c2="0.5",
                                   kappa="-1", use_pallas="maybe",
                                   fused_march_block="None", dtype=5)),
    ("ForwardSolverConfig2D", dict(Nx="64.0", Ny=" 33 ", T="1e-1",
                                   use_pallas="yes", fused_march_block="2",
                                   newton_max_iter="0", gamma="nan")),
    ("OptimizationConfig", dict(max_iter="10", u_min="x", u_max="-2",
                                b1=True, alpha_max="0")),
    ("OptimizationConfig", dict(max_iter="64.5", u_min="0.5", u_max="0.5",
                                b3="1_0")),
    ("BatchConfig", dict(batch="0", data_shards="3", mesh_axis=1)),
])
def test_coercion_and_errors_match_pydantic(model, values):
    """Typed strings and values are coerced, and rejected with the same
    field names and messages, as vch_tpu's pydantic models do."""
    jm, tm = getattr(jc, model), getattr(tc, model)
    try:
        want = ("ok", jm(**values).model_dump())
    except Exception as e:                # pydantic.ValidationError
        want = ("err", [(err["loc"][0], err["msg"]) for err in e.errors()])
    try:
        got = ("ok", tm(**values).to_dict())
    except tc.ConfigError as e:
        got = ("err", e.errors)
    assert got == want


def test_field_order_and_descriptions():
    """The fields, their order, defaults and descriptions are vch_tpu's,
    word for word (the prompts show them)."""
    import dataclasses
    for name in ("ForwardSolverConfig1D", "ForwardSolverConfig2D",
                 "OptimizationConfig", "BatchConfig"):
        jf = getattr(jc, name).model_fields
        tf = {f.name: f for f in dataclasses.fields(getattr(tc, name))}
        assert list(tf) == list(jf), name
        for k, f in jf.items():
            assert tf[k].metadata["description"] == f.description, (name, k)
            assert tf[k].default == f.default, (name, k)


def _scripted(monkeypatch, answers):
    """input() answering from `answers` in turn; returns the prompts."""
    prompts, it = [], iter(answers)

    def fake(prompt=""):
        prompts.append(prompt)
        return next(it)
    monkeypatch.setattr(builtins, "input", fake)
    return prompts


@pytest.mark.parametrize("model,title,answers,prev", [
    # one invalid entry (N = 5), re-prompted and corrected
    ("ForwardSolverConfig1D", "STEP 1: Configure the Forward Solver",
     {"N": ["5", "64"], "T": ["0.5"], "dtype": ["float32"]}, True),
    # one failed cross-field check (u_max <= u_min), and one unparsable
    # number (vch_tpu re-prompts several failing fields in set order, which
    # varies between processes, so each case has one)
    ("OptimizationConfig", "Optimization Parameters",
     {"b1": ["5"], "u_max": ["-3", "2"]}, False),
    ("OptimizationConfig", "STEP 2: Configure the Optimization",
     {"b3": ["abc", ""]}, False),
    ("ForwardSolverConfig2D", "Forward Solver Parameters",
     {"Nx": ["16"], "Ny": ["16"], "use_pallas": ["no"],
      "fused_march_block": ["-1", "0"]}, True),
])
def test_prompting_matches_vch_tpu(monkeypatch, capsys, tmp_path, model,
                                   title, answers, prev):
    """get_user_input_for_config on the same scripted input: the same
    prompts, the same printed text and the same resulting values."""
    def script(pkg):
        names = list(getattr(jc, model).model_fields)
        first = [answers.get(n, [""])[0] for n in names]
        again = [a for n in names for a in answers.get(n, [])[1:]]
        return first + again

    def run(pkg):
        prev_inst = None
        if prev:
            p = str(tmp_path / f"{pkg.__name__}.json")
            pkg.save_params(*_configs(pkg, "2D" in model), 3, filepath=p)
            loaded = pkg.load_params(p, two_d="2D" in model)
            prev_inst = loaded.forward_solver
        capsys.readouterr()
        prompts = _scripted(monkeypatch, script(pkg))
        out = pkg.get_user_input_for_config(getattr(pkg, model), title,
                                            prev_inst)
        return prompts, capsys.readouterr().out, out

    pj, oj, mj = run(jc)
    pt, ot, mt = run(tc)
    assert pt == pj
    assert ot == oj
    assert mt.to_dict() == mj.model_dump()


def test_yes_no_input(monkeypatch, capsys):
    prompts = _scripted(monkeypatch, ["maybe", "Y"])
    assert tc.get_yes_no_input("Proceed?") is True
    assert prompts == ["Proceed? (y/n): "] * 2
    assert "Invalid input" in capsys.readouterr().out
    _scripted(monkeypatch, ["no"])
    assert tc.get_yes_no_input("Proceed?") is False


def test_config_roundtrip_1d(tmp_path):
    """Mirrors tests/test_config_utils.py::test_config_roundtrip_1d."""
    p = str(tmp_path / "cfg.json")
    tc.save_params(tc.ForwardSolverConfig1D(N=64, T=0.5),
                   tc.OptimizationConfig(b3=0.01), 42, filepath=p)
    loaded = tc.load_params(p)
    assert loaded.forward_solver.N == 64
    assert loaded.forward_solver.T == 0.5
    assert loaded.optimization.b3 == 0.01
    assert loaded.last_run_iterations == 42
    assert json.load(open(p))["forward_solver"]["N"] == 64


def test_config_roundtrip_2d(tmp_path):
    """Mirrors tests/test_config_utils.py::test_config_roundtrip_2d."""
    p = str(tmp_path / "cfg2.json")
    tc.save_params(tc.ForwardSolverConfig2D(Nx=32, Ny=16),
                   tc.OptimizationConfig.defaults_2d(), 7, filepath=p)
    loaded = tc.load_params(p, two_d=True)
    assert loaded.forward_solver.Nx == 32
    assert loaded.forward_solver.Ny == 16
    assert loaded.optimization.b1 == 5.0    # 2D default
    assert isinstance(loaded.forward_solver, tc.ForwardSolverConfig2D)


def test_load_params_missing_file(tmp_path):
    """Mirrors tests/test_config_utils.py::test_load_params_missing_file."""
    loaded = tc.load_params(str(tmp_path / "nope.json"))
    assert isinstance(loaded, tc.SimulationParameters)
    assert loaded.forward_solver.N == 128
