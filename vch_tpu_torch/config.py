"""Solver and optimizer configuration, as plain dataclasses, with the JSON
persistence and the interactive prompting of vch_tpu/config.py.

Same field names, order, defaults and descriptions as `vch_tpu/config.py`
(ForwardSolverConfig1D, ForwardSolverConfig2D, OptimizationConfig,
BatchConfig, SimulationParameters, SimulationParameters2D) and
`vch_tpu/control/pgd.py` (PGDSettings), so a config dumped by `vch_tpu`
(`model_dump()` or its JSON) loads here through `from_dict`, and
`save_params` writes the JSON vch_tpu's writes for the same configs. The
descriptions (field metadata, shown by the prompts) are vch_tpu's word for
word, its TPU measurements included; none of those figures is the port's.

Validation is by hand, with vch_tpu's rules and messages: each value is
coerced to its field's type as pydantic's lax mode does (so the strings of
interactive input and the values of a JSON file are accepted), then checked
against the field's bounds (metadata "gt"/"ge") and the validators (c2 > c1,
u_max > u_min, dtype, linsolve_1d). Every failing field is reported at once,
by name, in a `ConfigError` (a ValueError), which is what lets
`get_user_input_for_config` re-prompt only those fields.

`fused_march_block` is honored as vch_tpu honors it: `resolved_fused_block()`
gives the members per CTA of the blocked kernels (8 on grids of up to 96
points by default), and the solvers take the blocked kernels when the batch
divides by it. The CUDA kernels are built for 8 members per CTA (and 1);
another explicit block runs on CPU tensors and raises on CUDA tensors.

The routing knobs of the per-step marcher and sweep are honored too:
`use_pallas` (None: on for the float32 fixed-trip path on a CUDA device, on
a grid vch_tpu's VMEM rule keeps on its kernel,
ops.solve_kernels.per_solve_kernels_fit; off elsewhere), `pallas_variant`
("spectral", or anything else for the raw-basis per-solve kernels, as
in vch_tpu), and `krylov_tol`, `krylov_max_iter` (the adaptive float64
Krylov solves).

`fused_solve_precision` is honored as vch_tpu honors it: the fused 2D
march's Krylov operator runs at "bf16x3" (the default: three bf16 passes on
the (hi, lo) split; on the card bf16 mma.sync), "default" (one bf16 pass)
or, for None, "highest" or any other string, full precision; every other
product of the march stays full precision (ops.march `_make_mm`): only the
march entries' own `fwd_mm` argument, vch_tpu's, which no config field or
path sets, runs them at "bf16x3" (ops.march `fwd_passes`).
`adjoint_solve_precision` is honored likewise: the fused 2D sweep's Krylov
operator runs at "bf16x3" (three bf16 passes; on the card bf16 mma.sync)
or, for None (the default) or any other string, full precision; every
other product of the sweep, and the low-memory path's segment sweep (which
vch_tpu runs at "highest"), stays full precision (ops.march
`sweep_passes`).

Field accepted for interchangeability but NOT honored by the port:
  forward_matmul_precision   — vch_tpu sets it as jax's default matmul
                               precision around its float32 per-step march
                               ('high'), which only a TPU lowering reads;
                               the port computes those products in full
                               float32.
Both configs carry every knob, so either loads the other package's dump;
the 1D solvers honor `linsolve_1d` ("dense": the exact Schur solve by
`torch.linalg.solve`, "spectral": the cosine-preconditioned BiCGStab,
"auto": dense in float64 up to N = 256, spectral otherwise),
`krylov_fixed_iters` (the float32 forward solve and the fused 1D march) and
`krylov_tol`; the 2D-only knobs are carried and unused there.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
from dataclasses import dataclass
from decimal import Decimal
from typing import Any, Dict, Optional

# |phi| <= 1 - DELTA_SEP (vch_tpu/config.py:22)
DELTA_SEP = 1e-2


class ConfigError(ValueError):
    """Invalid config values: `errors` lists (field name, message) for every
    failing field, in field order."""

    def __init__(self, errors):
        self.errors = list(errors)
        super().__init__("; ".join(f"{name}: {msg}"
                                   for name, msg in self.errors))


def _field(default, description, **bounds):
    """A field with vch_tpu's default, description and bounds (gt, ge)."""
    return dataclasses.field(default=default,
                             metadata={"description": description, **bounds})


_NO_STR = {"int": "Input should be a valid integer, unable to parse string "
                  "as an integer",
           "float": "Input should be a valid number, unable to parse string "
                    "as a number",
           "bool": "Input should be a valid boolean, unable to interpret "
                   "input"}
_NOT_A = {"int": "Input should be a valid integer",
          "float": "Input should be a valid number",
          "bool": "Input should be a valid boolean",
          "str": "Input should be a valid string"}
_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


def _coerce(kind: str, v):
    """(value, None) with v as the type `kind` ("int", "float", "str",
    "bool"), or (None, message) as pydantic's lax mode words it."""
    if kind == "str":
        return (v, None) if isinstance(v, str) else (None, _NOT_A["str"])
    if isinstance(v, str):
        s = v.strip()
        if kind == "bool":
            s = s.lower()
            if s in _TRUE or s in _FALSE:
                return s in _TRUE, None
            return None, _NO_STR["bool"]
        try:
            return (int(s) if kind == "int" else float(s)), None
        except ValueError:
            if kind == "int" and re.fullmatch(r"[+-]?\d[\d_]*\.0*", s):
                return int(s.split(".")[0]), None
            return None, _NO_STR[kind]
    if isinstance(v, (bool, int, float)) or hasattr(v, "__float__"):
        try:
            f = float(v)
        except (TypeError, ValueError):
            return None, _NOT_A[kind]
        if kind == "float":
            return f, None
        if not f.is_integer():
            return None, (_NO_STR["bool"] if kind == "bool" else
                          "Input should be a valid integer, got a number "
                          "with a fractional part")
        if kind == "bool":
            return ((bool(f), None) if f in (0.0, 1.0)
                    else (None, _NO_STR["bool"]))
        return int(f), None
    return None, _NOT_A[kind]


def _check_dtype(v, data):
    if v not in ("float32", "float64"):
        raise ValueError("dtype must be 'float32' or 'float64'")


def _check_linsolve(v, data):
    if v not in ("auto", "dense", "spectral"):
        raise ValueError("linsolve_1d must be 'auto', 'dense', or 'spectral'")


def _check_c2(v, data):
    c1 = data.get("c1", 0.0)
    if v <= c1:
        raise ValueError(f"c2 ({v}) must be greater than c1 ({c1})")


def _check_u_max(v, data):
    if "u_min" in data and v <= data["u_min"]:
        raise ValueError("u_max must be strictly greater than u_min.")


def _validate(cls, values: Dict[str, Any]):
    """Coerce and check `values` (one per field of cls) in field order, as
    pydantic validates vch_tpu's models: the type, then the bounds, then
    the field's validator, which sees the fields before it that passed.
    Returns (the valid values, [(field, message), ...])."""
    data, errors = {}, []
    checks = getattr(cls, "_validators", {})
    for f in dataclasses.fields(cls):
        v = values[f.name]
        t = f.type
        optional = t.startswith("Optional[")
        if not (optional and v is None):
            v, msg = _coerce(t[9:-1] if optional else t, v)
            if msg is None and "gt" in f.metadata and not v > f.metadata["gt"]:
                msg = f"Input should be greater than {f.metadata['gt']}"
            if msg is None and "ge" in f.metadata and not v >= f.metadata["ge"]:
                msg = ("Input should be greater than or equal to "
                       f"{f.metadata['ge']}")
            if msg is None and f.name in checks:
                try:
                    checks[f.name](v, data)
                except ValueError as e:
                    msg = f"Value error, {e}"
            if msg is not None:
                errors.append((f.name, msg))
                continue
        data[f.name] = v
    return data, errors


class _Validated:
    """Coerces and checks every field on construction; raises ConfigError
    naming each failing field."""

    def __post_init__(self):
        data, errors = _validate(type(self), {
            f.name: getattr(self, f.name) for f in dataclasses.fields(self)})
        if errors:
            raise ConfigError(errors)
        for k, v in data.items():
            setattr(self, k, v)

    @classmethod
    def from_dict(cls, d: dict):
        """Build from vch_tpu's `model_dump()` / JSON; unknown keys are
        dropped, as pydantic drops them."""
        if not isinstance(d, dict):
            raise ConfigError([(cls.__name__, "Input should be a valid "
                                "dictionary or instance of "
                                f"{cls.__name__}")])
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def to_dict(self) -> dict:
        """The fields in order (vch_tpu's `model_dump()`)."""
        return dataclasses.asdict(self)


@dataclass
class _SolverKnobs(_Validated):
    """The solver knobs the 1D and 2D configs share (vch_tpu/config.py:
    25-57); each config adds its grid and physics fields after them."""

    dtype: str = _field(
        "float64", 'Solver dtype: float64 (parity) or float32 (TPU speed)')
    newton_tol: float = _field(
        1e-6, 'Newton residual L2 tolerance (ref: Forward_solver.py:143)',
        gt=0)
    newton_rtol: float = _field(
        1e-5,
        "Newton tolerance relative to the step's initial residual; active "
        'in float32 where the absolute tol can sit below the noise floor',
        ge=0)
    newton_max_iter: int = _field(50, 'Max Newton iterations per step', gt=0)
    krylov_tol: float = _field(
        1e-9, 'Relative tolerance of the inner Krylov solve (2D)', gt=0)
    krylov_max_iter: int = _field(200, 'Max inner Krylov iterations (2D)',
                                  gt=0)
    krylov_fixed_iters: int = _field(
        4,
        'Fixed Krylov trip count used on the float32/TPU path (compiles '
        "smaller, no convergence barrier; the Newton while_loop's residual "
        'tolerance absorbs the slack). Tuned on-chip at 64x64 B=32: trips '
        '10/8/6/5/4 all produce the identical Newton-solve count and final '
        'cost, so 4 is pure speedup (22.8 -> 34.4 scenario-iters/s); 3 '
        'stalls the lockstep Newton loop (11 it/s), 2 burns 40% more '
        'Newton solves',
        gt=0)
    fused_solve_precision: Optional[str] = _field(
        "bf16x3",
        "Matmul precision INSIDE the fused-march kernel's Krylov solve "
        "only: 'bf16x3' (default — three pipelined single-pass bf16 dots "
        "on the (hi, lo) split, reproducing the scan path's validated "
        "'high' arithmetic), 'highest' (6-pass f32), or 'default' (raw "
        '1-pass bf16). Residuals/Laplacians/Armijo trials ALWAYS run at '
        'highest — an imprecise solve direction can only cost extra Newton '
        'iterations (visible in the measured counters), never accuracy; '
        'keeping the RESIDUAL at bf16x3 instead stalls the Armijo accept '
        'test near convergence (94 -> 38 it/s at 20 iters). Measured at '
        '64x64 B=32 x 20 iters on-chip: bf16x3 99.2 it/s with +0.02% '
        "Newton solves and 3e-4 cost agreement vs highest's 94.1; raw bf16 "
        'DOUBLES the Newton solves (252800 vs 126557) for a net 91.0')
    fused_krylov_fixed_iters: Optional[int] = _field(
        3,
        'Fixed Krylov trip count inside the fused whole-march kernel '
        '(ops/pallas_march.py), where each member runs its OWN Newton '
        'loop: a slightly under-converged solve costs only that member an '
        'extra Newton iteration, not a lockstep round for the whole batch. '
        'Measured at 64x64 B=256 on-chip: trips 3 = 131.8 scenario-iters/s '
        "with +0.15% Newton solves vs trips 4 = 120.3 (the scan path's '3 "
        "stalls at 11 it/s' was pure vmap-lockstep artifact); trips 2 "
        'burns +34% solves for 126.4. None inherits krylov_fixed_iters',
        gt=0)
    fused_march_block: Optional[int] = _field(
        None,
        'Member-block tile size of the fused whole-march AND whole-adjoint '
        "kernels: Bb > 0 stacks Bb members' fields per grid cell so "
        'right-multiplies become one (Bb*n, m) matmul and left-multiplies '
        'become Bb MXU-pipelined slice matmuls (measured 213 -> 80/67 ns '
        'per member-matmul at 64x64, BENCH_RESULTS '
        'blocked_march_microbench), with Newton/Armijo in masked '
        'per-member lockstep inside the block (max-of-Bb trips; measured '
        'Newton-solve counts unchanged). 0 = one member per cell (the '
        'round-3 design). None = AUTO: 8 for grids up to 96 (measured '
        'on-chip at 64x64: forward 1.14x, adjoint 1.44x — the pure-Krylov '
        'sweep converts the most chain latency), 0 above (at 128x128 the '
        'bigger matmuls are already streaming-bound and the stacked lane '
        'padding costs more than blocking wins back: forward 0.71x, '
        'adjoint 0.99x; BENCH_RESULTS blocked_march_onchip). Batches that '
        'do not divide by Bb fall back to the per-member kernel',
        ge=0)
    adjoint_solve_precision: Optional[str] = _field(
        None,
        "Matmul precision inside the fused ADJOINT kernel's Krylov "
        "operator apply only: None/'highest' (6-pass f32) or 'bf16x3' "
        '(pipelined three-dot (hi,lo)-split, ~f32-equivalent arithmetic). '
        'Measured at 64x64 B=256 x 20 PGD iters on-chip: adjoint sweep '
        '0.362 -> 0.312 s (14%), end-to-end 223.7 -> 236.2 it/s (+5.6%), '
        'gradient r within 8.5e-5 rel (the f32 noise floor), Newton solves '
        '+0.57% — but per-member 20-iter final costs diverge up to 1.7% '
        'rel (noise-floor gradient perturbations flip discrete line-search '
        'decisions on the chaotic T=1 trajectories). Default None -> '
        'highest: the ~6% is not worth breaking run-to-run cost '
        'comparability; opt in for pure-throughput sweeps')
    adjoint_krylov_fixed_iters: Optional[int] = _field(
        5,
        'Fixed Krylov trip count for the ADJOINT step solves on the '
        'float32/TPU path. None inherits krylov_fixed_iters. Kept separate '
        'because the adjoint operator is condition-1e6 and has NO outer '
        'Newton loop to absorb an under-converged solve. The warm-started '
        'split-preconditioned solve is noise-floor-converged by 4 trips '
        '(f32-vs-f64 gradient relmax 1.4e-4/4.4e-4/2.8e-3 at 32/64/128 '
        'grids, trips-independent down to 4), and 20-iteration B=32 PGD '
        'runs at trips 4/5/6 produce BIT-IDENTICAL trajectories (same '
        '126557 Newton solves, same costs; 104.5/94.1/85.1 it/s). 5 = '
        'one-trip margin above the measured floor',
        gt=0)
    linsolve_1d: str = _field(
        "auto",
        "1D Newton/adjoint linear solver: 'dense' (exact LU, reference "
        "parity), 'spectral' (matrix-free cosine-preconditioned BiCGStab), "
        "or 'auto' (dense for f64 N<=256, spectral otherwise)")
    pallas_variant: str = _field(
        "spectral",
        "Fused-kernel basis: 'spectral' (BiCGStab in the cosine eigenbasis "
        '— diagonal preconditioner, half/third the matmuls per trip, '
        "measured 1.19x forward on-chip) or 'raw' (bit-parity with "
        'ops/linsolve.bicgstab_fixed / bicgstab_split_fixed)')
    use_pallas: Optional[bool] = _field(
        None,
        'Route the 2D Newton Schur solve through the fused Pallas BiCGStab '
        'kernel (whole Krylov solve in VMEM). None = auto: on for the '
        'float32 fixed-trip path on TPU, off elsewhere')
    forward_matmul_precision: Optional[str] = _field(
        None,
        'Matmul precision override for the FORWARD solver only '
        "('default'|'high'|'highest'; None inherits the package-global "
        "'highest'). The diagonally-dominant forward Schur system "
        "tolerates lower precision, and 6-pass 'highest' expansion makes "
        '128x128+ compiles pathological; the condition-1e6 adjoint always '
        'keeps full precision')

    _validators = {"dtype": _check_dtype, "linsolve_1d": _check_linsolve,
                   "c2": _check_c2}


@dataclass
class ForwardSolverConfig1D(_SolverKnobs):
    """1D forward-solve parameters (vch_tpu/config.py:60-80). The 2D-only
    knobs are carried for interchangeability; no 1D code reads them."""

    newton_max_iter: int = _field(50, 'Max Newton iterations (ref 1D: 50)',
                                  gt=0)
    N: int = _field(128, 'Number of spatial intervals', gt=10)
    Lx: float = _field(1.0, 'Domain length', gt=0)
    T: float = _field(1.0, 'Total simulation time', gt=0)
    dt_initial: float = _field(1e-2, 'Initial time step size', gt=0)
    tau: float = _field(0.05, 'Viscosity parameter for phi-equation')
    gamma: float = _field(10.0, 'Relaxation parameter', gt=0)
    c1: float = _field(0.75, 'Flory-Huggins convex coefficient')
    c2: float = _field(1.0, 'Concave (quadratic) coefficient')
    kappa: float = _field(0.03 ** 2, 'Gradient energy coefficient', ge=0)


@dataclass
class ForwardSolverConfig2D(_SolverKnobs):
    """2D forward-solve parameters (vch_tpu/config.py:83-115)."""

    newton_max_iter: int = _field(500, 'Max Newton iterations (ref 2D: 500)',
                                  gt=0)
    Nx: int = _field(128, 'Number of spatial intervals in x', gt=10)
    Ny: int = _field(128, 'Number of spatial intervals in y', gt=10)
    Lx: float = _field(1.0, 'Domain length in x', gt=0)
    Ly: float = _field(1.0, 'Domain length in y', gt=0)
    T: float = _field(1.0, 'Total simulation time', gt=0)
    dt_initial: float = _field(1e-2, 'Initial time step size', gt=0)
    tau: float = _field(0.05, 'Viscosity parameter for phi-equation')
    gamma: float = _field(10.0, 'Relaxation parameter', gt=0)
    c1: float = _field(0.75, 'Flory-Huggins convex coefficient')
    c2: float = _field(1.0, 'Concave (quadratic) coefficient')
    kappa: float = _field(0.01 ** 2, 'Gradient energy coefficient', ge=0)

    def resolved_fused_block(self) -> int:
        """Members per CTA of the member-blocked kernels (0: one member per
        CTA), vch_tpu/config.py:107-115: None gives 8 on grids of up to 96
        points and 0 above; an explicit value passes through."""
        bb = self.fused_march_block
        if bb is None:
            return 8 if max(self.Nx, self.Ny) <= 96 else 0
        return bb


# vch_tpu names both variants `ForwardSolverConfig`; its alias is the 1D one
ForwardSolverConfig = ForwardSolverConfig1D


@dataclass
class OptimizationConfig(_Validated):
    """PGD loop parameters (vch_tpu/config.py:122-154)."""

    b1: float = _field(0.3, 'Weight for space-time tracking cost', ge=0)
    b2: float = _field(13.0, 'Weight for terminal cost', ge=0)
    b3: float = _field(0.0019, 'Weight for control energy cost', ge=0)
    kappa_sparsity: float = _field(9e-5, 'Sparsity weight for L1 term', ge=0)
    alpha_max: float = _field(100.0, 'Initial step size for line search',
                              gt=0)
    max_iter: int = _field(1000, 'Max number of gradient descent iterations',
                           gt=10)
    u_min: float = _field(-1.0, 'Lower bound for the control')
    u_max: float = _field(1.0, 'Upper bound for the control')

    _validators = {"u_max": _check_u_max}

    @classmethod
    def defaults_1d(cls, **over) -> "OptimizationConfig":
        return cls(**over)

    @classmethod
    def defaults_2d(cls, **over) -> "OptimizationConfig":
        base = dict(b1=5.0, b2=10.0, b3=1e-4, kappa_sparsity=1e-4,
                    alpha_max=50.0, max_iter=500)
        base.update(over)
        return cls(**base)


@dataclass
class BatchConfig(_Validated):
    """Scenario-batch and sharding description (vch_tpu/config.py:157-162)."""

    batch: int = _field(1, 'Number of control scenarios', ge=1)
    mesh_axis: str = _field('scenarios',
                            'Mesh axis name the batch is sharded over')
    data_shards: int = _field(1, 'Number of mesh shards along the batch axis',
                              ge=1)


@dataclass
class PGDSettings:
    """Line-search / heuristic constants (vch_tpu/control/pgd.py:42-67)."""

    ls_max_trials: int = 5
    ls_beta: float = 0.8
    ls_alpha_factor: float = 1.0
    plateau_length: int = 10
    plateau_tolerance: float = 1e-7
    plateau_boost: float = 2.0
    conv_tol: float = 1e-5
    conv_min_iter: int = 10
    advisor_start_iter: int = 100
    keep_failed_step: bool = True

    @classmethod
    def defaults_1d(cls) -> "PGDSettings":
        return cls()

    @classmethod
    def defaults_2d(cls) -> "PGDSettings":
        return cls(ls_max_trials=10, ls_alpha_factor=0.8, plateau_length=5,
                   plateau_tolerance=1e-5, plateau_boost=1.5,
                   conv_min_iter=20)

    @classmethod
    def defaults_exact(cls) -> "PGDSettings":
        """The exact-gradient mode's (vch_tpu/control/pgd.py:70-73): its
        gradient has the true, much larger magnitude, so it backtracks
        deeper and never keeps an ascent step."""
        return cls(ls_max_trials=15, ls_beta=0.5, keep_failed_step=False)


# ----------------------------------------------------------------------
# persistence and interactive prompting (vch_tpu/config.py:165-261)
# ----------------------------------------------------------------------

class _Params(_Validated):
    """The persisted container: the forward config, the optimization config
    and the last run's iteration count; nested dicts (JSON) are validated
    into their configs."""

    def __post_init__(self):
        errors = []
        for name, cls in (("forward_solver", self._forward_cls),
                          ("optimization", OptimizationConfig)):
            v = getattr(self, name)
            if isinstance(v, dict):
                try:
                    v = cls.from_dict(v)
                except ConfigError as e:
                    errors += [(f"{name}.{f}", m) for f, m in e.errors]
            elif not isinstance(v, cls):
                errors.append((name, "Input should be a valid dictionary or "
                                     f"instance of {cls.__name__}"))
            setattr(self, name, v)
        n, msg = _coerce("int", self.last_run_iterations)
        if msg is not None:
            errors.append(("last_run_iterations", msg))
        self.last_run_iterations = n
        if errors:
            raise ConfigError(errors)


@dataclass
class SimulationParameters(_Params):
    """The container persisted between sessions (vch_tpu/config.py:165-170)."""

    forward_solver: ForwardSolverConfig1D = dataclasses.field(
        default_factory=ForwardSolverConfig1D)
    optimization: OptimizationConfig = dataclasses.field(
        default_factory=OptimizationConfig)
    last_run_iterations: int = _field(
        0, 'Number of iterations from the last run.')

    _forward_cls = ForwardSolverConfig1D


@dataclass
class SimulationParameters2D(_Params):
    """The 2D container (vch_tpu/config.py:173-178)."""

    forward_solver: ForwardSolverConfig2D = dataclasses.field(
        default_factory=ForwardSolverConfig2D)
    optimization: OptimizationConfig = dataclasses.field(
        default_factory=OptimizationConfig.defaults_2d)
    last_run_iterations: int = _field(
        0, 'Number of iterations from the last run.')

    _forward_cls = ForwardSolverConfig2D


def _json_float(x: float) -> str:
    """x as pydantic's JSON writes it: the shortest round-trip digits in
    ryu's layout (1e-6, 0.00001, 100.0, 1e16)."""
    if not math.isfinite(x):
        return "null"
    if x == 0:
        return "-0.0" if math.copysign(1.0, x) < 0 else "0.0"
    t = Decimal(repr(abs(x))).normalize().as_tuple()
    digits, k = "".join(map(str, t.digits)), t.exponent
    n = len(digits)
    kk = n + k                          # the decimal point's position
    if 0 <= k and kk <= 16:
        s = digits + "0" * k + ".0"
    elif 0 < kk <= 16:
        s = digits[:kk] + "." + digits[kk:]
    elif -5 < kk <= 0:
        s = "0." + "0" * -kk + digits
    elif n == 1:
        s = f"{digits}e{kk - 1}"
    else:
        s = f"{digits[0]}.{digits[1:]}e{kk - 1}"
    return ("-" if x < 0 else "") + s


def _json(v, level: int = 0) -> str:
    """v as `model_dump_json(indent=4)` writes it."""
    if isinstance(v, dict):
        if not v:
            return "{}"
        pad = " " * 4 * (level + 1)
        items = [f"{pad}{json.dumps(k, ensure_ascii=False)}: "
                 f"{_json(x, level + 1)}" for k, x in v.items()]
        return "{\n" + ",\n".join(items) + "\n" + " " * 4 * level + "}"
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _json_float(v)
    return json.dumps(v, ensure_ascii=False)


def save_params(fwd_config, opt_config: OptimizationConfig,
                iteration_count: int,
                filepath: str = "last_run_config.json") -> None:
    """Persist the configs and the final iteration count (ref: 1D
    config.py:142-159), in the JSON vch_tpu writes for the same configs."""
    container = (SimulationParameters2D
                 if isinstance(fwd_config, ForwardSolverConfig2D)
                 else SimulationParameters)
    params = container(forward_solver=fwd_config, optimization=opt_config,
                       last_run_iterations=iteration_count)
    try:
        with open(filepath, "w") as f:
            f.write(_json(params.to_dict()))
        print(f"Configuration saved to '{filepath}'.")
    except IOError as e:
        print(f"[Warning] Could not save configuration file: {e}")


def load_params(filepath: str = "last_run_config.json", two_d: bool = False):
    """Load persisted params, or the defaults (ref: 1D config.py:162-171)."""
    container = SimulationParameters2D if two_d else SimulationParameters
    try:
        with open(filepath, "r") as f:
            data = json.load(f)
        print(f"Loaded previous configuration from '{filepath}'.")
        return container.from_dict(data)
    except (FileNotFoundError, ConfigError, json.JSONDecodeError):
        print("No valid previous configuration found. Using default "
              "parameters.")
        return container()


def get_yes_no_input(prompt: str) -> bool:
    """Simple y/n confirmation (ref: 1D config.py:26-34)."""
    while True:
        response = input(f"{prompt} (y/n): ").lower().strip()
        if response in ("y", "yes"):
            return True
        if response in ("n", "no"):
            return False
        print("Invalid input. Please enter 'y' or 'n'.")


def get_user_input_for_config(config_model, title: str,
                              previous_instance=None):
    """Interactive per-field prompting with validation re-prompts (ref: 1D
    config.py:180-265): the previous run's values as a reference table,
    each field prompted with its description and class default, the typed
    strings coerced and validated, and only the failing fields re-prompted
    (in field order) until all pass."""
    print("\n" + "=" * 60)
    print(f"--- {title} ---")
    if previous_instance is not None:
        print("For your reference, here are the parameters from the last "
              "run:")
        print("." * 50)
        for name, value in previous_instance.to_dict().items():
            print(f"  {name:<15}: {value}")
        print("." * 50)
    print("Press Enter to accept the original default value shown in "
          "[brackets].")
    print("=" * 60)

    fields = {f.name: f for f in dataclasses.fields(config_model)}
    user_params: Dict[str, Any] = {}
    for name, f in fields.items():
        desc = f.metadata.get("description", "")
        raw = input(f"-> Enter '{name}' ({desc}) "
                    f"[default: {f.default}]: ").strip()
        user_params[name] = f.default if raw == "" else raw

    while True:
        try:
            validated = config_model(**user_params)
            print("\nConfiguration accepted and validated.")
            return validated
        except ConfigError as e:
            print("\nPARAMETER ERROR: Please correct the following "
                  "value(s):")
            for name, msg in e.errors:
                print(f"  - {name}: {msg}")
            for name in dict.fromkeys(name for name, _ in e.errors):
                f = fields[name]
                raw = input(f"-> (Correction) Enter '{name}' "
                            f"({f.metadata.get('description', '')}) "
                            f"[default: {f.default}]: ").strip()
                user_params[name] = f.default if raw == "" else raw
