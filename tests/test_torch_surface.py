"""The port's public surface against vch_tpu's, one case per module of
vch_tpu. The two Pallas modules (ops/pallas_march.py, ops/pallas_kernels.py)
are left out: their counterparts are the kernel wrappers of PERF.md §6's
table (ops/march.py, ops/solve_kernels.py), held against them by
tests/test_torch_blocked.py, test_torch_solve.py and the card.

For each public name a module defines (a top-level def, class or
assignment), lists in `__all__`, or, in a package's `__init__.py`,
re-exports by a `from ... import`, the port's module of the same path has
that name. For each callable, and for each public method a class defines
(and its `__init__` and `__call__`), the port accepts every vch_tpu
parameter name, a parameter vch_tpu takes by position keeps its place (so a
call written for vch_tpu binds the same arguments in the port), and a
`*args` or `**kwargs` of vch_tpu's is one of the port's. A field a class
annotates (vch_tpu's pydantic models, dataclasses and NamedTuples) is a
constructor argument or an attribute of the port's class.

The deliberate differences are in ALLOWED (parameters) and INTERNAL
(methods vch_tpu's names make public but no caller calls), each with its
reason and its entry in ROADMAP.md C. An entry that no vch_tpu signature
or method needs fails the test.
"""
import ast
import importlib
import inspect
from pathlib import Path

import pytest

import vch_tpu

ROOT = Path(vch_tpu.__file__).resolve().parent
PALLAS_MODULES = {"ops/pallas_march.py", "ops/pallas_kernels.py"}
MODULES = sorted(p.relative_to(ROOT).as_posix() for p in ROOT.rglob("*.py")
                 if p.relative_to(ROOT).as_posix() not in PALLAS_MODULES)
METHODS = ("__init__", "__call__")

PALLAS = ("Pallas-only: runs vch_tpu's Pallas kernel in interpret mode on "
          "the CPU; the port's wrappers launch their CUDA kernel on CUDA "
          "tensors and run its plain version on CPU tensors (ROADMAP C, "
          "'Pallas-only parameters')")
SYNC = ("vch_tpu's hook that ORs a Krylov predicate over the combined "
        "mesh, to keep one SPMD program in lockstep; the port's grid-"
        "sharded solvers reduce each predicate over their 'gx' group in "
        "the grid operations (ROADMAP C, 'sync_pred')")
DTS = ("the port's whole-sweep entry takes the time steps from its solver "
       "(`self.dts`, vch_tpu's own value) (ROADMAP C, "
       "'adjoint_fused_batch's dts')")

# (module path, qualified name) -> {vch_tpu parameter: (the port's name,
# or None where the port has none; the reason)}
ALLOWED = {
    ("models/forward1d.py", "ForwardSolver1D.march_fused_batch"):
        {"interpret": (None, PALLAS)},
    ("models/forward2d.py", "ForwardSolver2D.march_fused_batch"):
        {"interpret": (None, PALLAS)},
    ("models/adjoint2d.py", "AdjointSolver2D.adjoint_fused_batch"):
        {"interpret": (None, PALLAS), "dts": (None, DTS)},
    ("models/lowmem.py", "FusedLowMemBatch2D.__init__"):
        {"interpret": (None, PALLAS)},
    ("models/forward2d.py", "newton_2d"): {"pallas_interpret": (None, PALLAS)},
    ("ops/linsolve.py", "newton_schur_solve_2d"):
        {"pallas_interpret": (None, PALLAS)},
    ("ops/linsolve.py", "bicgstab"): {"sync_pred": (None, SYNC)},
    ("ops/linsolve.py", "bicgstab_split"): {"sync_pred": (None, SYNC)},
}

VALIDATOR = ("a pydantic field_validator of vch_tpu's config: pydantic calls "
             "it while it validates the field, and no caller does; the "
             "port's dataclass runs the same check in __post_init__ and "
             "raises ValueError for the same values (ROADMAP C, 'the "
             "config validators')")

# (module path, Class.method) -> the reason the port has no such method
INTERNAL = {
    ("config.py", "ForwardSolverConfig1D.check_c2_greater_than_c1"):
        VALIDATOR,
    ("config.py", "ForwardSolverConfig2D.check_c2_greater_than_c1"):
        VALIDATOR,
    ("config.py", "OptimizationConfig.u_max_must_be_greater_than_u_min"):
        VALIDATOR,
}

def _module_names(rel):
    parts = rel[:-3].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return (".".join(["vch_tpu"] + parts),
            ".".join(["vch_tpu_torch"] + parts))


def _public_names(rel, module):
    """{name: (kind, [(method, ...)], [field, ...])} of the module's public
    names (see the module docstring)."""
    tree = ast.parse((ROOT / rel).read_text())
    names = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names[node.name] = ("callable", (), ())
        elif isinstance(node, ast.ClassDef):
            methods = tuple(
                n.name for n in node.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                and (not n.name.startswith("_") or n.name in METHODS))
            fields = tuple(n.target.id for n in node.body
                           if isinstance(n, ast.AnnAssign)
                           and isinstance(n.target, ast.Name)
                           and not n.target.id.startswith("_"))
            names[node.name] = ("class", methods, fields)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name):
                    names[t.id] = ("value", (), ())
        elif (isinstance(node, ast.ImportFrom)
              and rel.endswith("__init__.py")):
            for a in node.names:
                names.setdefault(a.asname or a.name, ("export", (), ()))
    for n in getattr(module, "__all__", ()):
        names.setdefault(n, ("export", (), ()))
    return {n: v for n, v in names.items() if not n.startswith("_")}


def _is_field_validator(rel, cls, meth):
    """Whether vch_tpu's cls.meth in `rel` carries @field_validator(...)."""
    for node in ast.parse((ROOT / rel).read_text()).body:
        if isinstance(node, ast.ClassDef) and node.name == cls:
            for n in node.body:
                if isinstance(n, ast.FunctionDef) and n.name == meth:
                    return any(isinstance(d, ast.Call)
                               and getattr(d.func, "id", None)
                               == "field_validator"
                               for d in n.decorator_list)
    return False


def _signature(fn):
    try:
        return inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return None


POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
              inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _compare(where, ref, port, allowed, used):
    """The differences of the port's signature from vch_tpu's, less the
    allowed ones (recorded in `used`)."""
    jp, tp = _signature(ref), _signature(port)
    if jp is None or tp is None:
        return []
    fails, jpos = [], []
    kinds = {p.kind for p in tp.values()}
    for name, p in jp.items():
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            if p.kind not in kinds:
                star = "*" if p.kind == p.VAR_POSITIONAL else "**"
                fails.append(f"{where}: no {star}{name}")
            continue
        if name in allowed:
            used.add(name)
            port_name = allowed[name][0]
            if port_name is None:
                if name in tp:
                    fails.append(f"{where}: allowlisted {name!r} is in the "
                                 "port; drop its entry")
                continue
            name = port_name
        if name not in tp:
            fails.append(f"{where}: no parameter {name!r}")
        if p.kind in POSITIONAL:
            jpos.append(name)
    tpos = [n for n, p in tp.items() if p.kind in POSITIONAL]
    if tpos[:len(jpos)] != jpos:
        fails.append(f"{where}: positional {jpos} against the port's {tpos}")
    return fails


def _has_field(cls, field):
    params = _signature(cls)
    return hasattr(cls, field) or (params is not None and field in params)


@pytest.mark.parametrize("rel", MODULES)
def test_module_surface_matches_vch_tpu(rel):
    """Every public name of the vch_tpu module at `rel` is in the port's
    module of the same path, every callable accepts vch_tpu's parameters in
    vch_tpu's places, every annotated field is the port's."""
    ref_name, port_name = _module_names(rel)
    ref = importlib.import_module(ref_name)
    port = importlib.import_module(port_name)
    fails, used, internal = [], {}, set()
    for name, (kind, methods, fields) in sorted(
            _public_names(rel, ref).items()):
        if not hasattr(port, name):
            fails.append(f"{port_name} has no {name}")
            continue
        r, p = getattr(ref, name), getattr(port, name)
        if callable(r) and not inspect.isclass(r):
            key = (rel, name)
            fails += _compare(f"{port_name}.{name}", r, p,
                              ALLOWED.get(key, {}),
                              used.setdefault(key, set()))
        if kind != "class":
            continue
        for m in methods:
            where = f"{port_name}.{name}.{m}"
            if (rel, f"{name}.{m}") in INTERNAL:
                internal.add(f"{name}.{m}")
                if hasattr(p, m):
                    fails.append(f"{where} is in INTERNAL but the port has "
                                 "it; drop its entry")
                elif not _is_field_validator(rel, name, m):
                    fails.append(f"INTERNAL lists {where}, which is not a "
                                 "pydantic field_validator of vch_tpu's")
                continue
            if not hasattr(p, m):
                fails.append(f"{where} is missing")
                continue
            key = (rel, f"{name}.{m}")
            fails += _compare(where, getattr(r, m), getattr(p, m),
                              ALLOWED.get(key, {}),
                              used.setdefault(key, set()))
        fails += [f"{port_name}.{name} has no field {f}" for f in fields
                  if not _has_field(p, f)]
    for (mod, qual), params in ALLOWED.items():
        stale = set(params) - used.get((mod, qual), set())
        if mod == rel and stale:
            fails.append(f"ALLOWED[{mod!r}, {qual!r}] lists parameters "
                         f"{sorted(stale)} that vch_tpu's signature does "
                         "not have")
    fails += [f"INTERNAL[{mod!r}, {qual!r}] names no method of vch_tpu's"
              for mod, qual in INTERNAL
              if mod == rel and qual not in internal]
    assert not fails, "\n".join(fails)


def test_allowlist_entries_name_a_module_and_a_reason():
    """Every allowlisted module is walked, and every entry says why and
    names its ROADMAP C entry."""
    for (mod, _), params in ALLOWED.items():
        assert mod in MODULES
        for _, reason in params.values():
            assert "ROADMAP C" in reason
    for (mod, _), reason in INTERNAL.items():
        assert mod in MODULES and "ROADMAP C" in reason


@pytest.mark.parametrize("cls,bad", [
    ("ForwardSolverConfig1D", dict(c1=0.5, c2=0.5)),
    ("ForwardSolverConfig2D", dict(c1=0.7, c2=0.3)),
    ("OptimizationConfig", dict(u_min=1.0, u_max=1.0)),
])
def test_internal_validators_reject_what_vch_tpu_rejects(cls, bad):
    """The checks behind INTERNAL's validators: the values vch_tpu's
    field_validator refuses, the port's config refuses with ValueError
    (pydantic's ValidationError is one), and a valid config builds in
    both."""
    import vch_tpu.config as jconfig
    import vch_tpu_torch.config as tconfig
    for config in (jconfig, tconfig):
        with pytest.raises(ValueError):
            getattr(config, cls)(**bad)
        getattr(config, cls)()
