"""Solver and optimizer configuration, as plain dataclasses.

Same field names and defaults as `vch_tpu/config.py` (ForwardSolverConfig1D,
ForwardSolverConfig2D, OptimizationConfig) and `vch_tpu/control/pgd.py`
(PGDSettings), so a config dumped by `vch_tpu` (`model_dump()` or its JSON)
loads here through `from_dict`. Validation is by hand: c2 > c1,
u_max > u_min, dtype in {float32, float64}, and positivity where vch_tpu's
fields demand it.

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

Fields accepted for interchangeability but NOT honored by the port:
  fused_solve_precision,   — the kernels compute every product in full
  adjoint_solve_precision,   float32 FMA (vch_tpu's 'highest'), and the
  forward_matmul_precision   plain versions compute in full float32 too
                             (vch_tpu's float32 per-step march runs at
                             matmul precision 'high').
Both configs carry every knob, so either loads the other package's dump;
the 1D solvers honor `linsolve_1d` ("dense": the exact Schur solve by
`torch.linalg.solve`, "spectral": the cosine-preconditioned BiCGStab,
"auto": dense in float64 up to N = 256, spectral otherwise),
`krylov_fixed_iters` (the float32 forward solve and the fused 1D march) and
`krylov_tol`; the 2D-only knobs are carried and unused there.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

# |phi| <= 1 - DELTA_SEP (vch_tpu/config.py:22)
DELTA_SEP = 1e-2


def _known(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclass
class _SolverKnobs:
    """The physics and the solver knobs the 1D and 2D configs share
    (vch_tpu/config.py:25-58), with vch_tpu's checks."""

    T: float = 1.0
    dt_initial: float = 1e-2
    tau: float = 0.05
    gamma: float = 10.0
    c1: float = 0.75
    c2: float = 1.0
    dtype: str = "float64"
    newton_tol: float = 1e-6
    newton_rtol: float = 1e-5
    krylov_tol: float = 1e-9
    krylov_max_iter: int = 200
    krylov_fixed_iters: int = 4
    fused_krylov_fixed_iters: Optional[int] = 3
    adjoint_krylov_fixed_iters: Optional[int] = 5
    linsolve_1d: str = "auto"
    fused_march_block: Optional[int] = None
    pallas_variant: str = "spectral"
    use_pallas: Optional[bool] = None
    # accepted, not honored (see the module docstring)
    fused_solve_precision: Optional[str] = "bf16x3"
    adjoint_solve_precision: Optional[str] = None
    forward_matmul_precision: Optional[str] = None

    def __post_init__(self):
        if self.dtype not in ("float32", "float64"):
            raise ValueError("dtype must be 'float32' or 'float64'")
        if self.linsolve_1d not in ("auto", "dense", "spectral"):
            raise ValueError("linsolve_1d must be 'auto', 'dense', or "
                             "'spectral'")
        if self.c2 <= self.c1:
            raise ValueError(f"c2 ({self.c2}) must be greater than c1 "
                             f"({self.c1})")
        for name in ("T", "dt_initial", "gamma", "newton_tol",
                     "newton_max_iter", "krylov_tol", "krylov_max_iter",
                     "krylov_fixed_iters") + self._positive:
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be > 0")
        for name in ("fused_krylov_fixed_iters", "adjoint_krylov_fixed_iters"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be > 0 or None")
        if self.kappa < 0 or self.newton_rtol < 0:
            raise ValueError("kappa and newton_rtol must be >= 0")
        if self.fused_march_block is not None and self.fused_march_block < 0:
            raise ValueError("fused_march_block must be >= 0 or None")

    @classmethod
    def from_dict(cls, d: dict):
        """Build from vch_tpu's `model_dump()` / JSON; unknown keys are
        dropped."""
        return cls(**_known(cls, d))


@dataclass
class ForwardSolverConfig1D(_SolverKnobs):
    """1D forward-solve parameters (vch_tpu/config.py:60-80). The 2D-only
    knobs are carried for interchangeability; no 1D code reads them."""

    N: int = 128
    Lx: float = 1.0
    kappa: float = 0.03 ** 2
    newton_max_iter: int = 50
    _positive = ("Lx",)

    def __post_init__(self):
        super().__post_init__()
        if self.N <= 10:
            raise ValueError("N must be > 10")


@dataclass
class ForwardSolverConfig2D(_SolverKnobs):
    """2D forward-solve parameters (vch_tpu/config.py:83-105)."""

    Nx: int = 128
    Ny: int = 128
    Lx: float = 1.0
    Ly: float = 1.0
    kappa: float = 0.01 ** 2
    newton_max_iter: int = 500
    _positive = ("Lx", "Ly")

    def __post_init__(self):
        super().__post_init__()
        for name in ("Nx", "Ny"):
            if getattr(self, name) <= 10:
                raise ValueError(f"{name} must be > 10")

    def resolved_fused_block(self) -> int:
        """Members per CTA of the member-blocked kernels (0: one member per
        CTA), vch_tpu/config.py:107-115: None gives 8 on grids of up to 96
        points and 0 above; an explicit value passes through."""
        bb = self.fused_march_block
        if bb is None:
            return 8 if max(self.Nx, self.Ny) <= 96 else 0
        return bb


@dataclass
class OptimizationConfig:
    """PGD loop parameters (vch_tpu/config.py:122-154)."""

    b1: float = 0.3
    b2: float = 13.0
    b3: float = 0.0019
    kappa_sparsity: float = 9e-5
    alpha_max: float = 100.0
    max_iter: int = 1000
    u_min: float = -1.0
    u_max: float = 1.0

    def __post_init__(self):
        if self.u_max <= self.u_min:
            raise ValueError("u_max must be strictly greater than u_min.")
        for name in ("b1", "b2", "b3", "kappa_sparsity"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")
        if self.alpha_max <= 0 or self.max_iter <= 10:
            raise ValueError("alpha_max must be > 0 and max_iter > 10")

    @classmethod
    def defaults_1d(cls, **over) -> "OptimizationConfig":
        return cls(**over)

    @classmethod
    def defaults_2d(cls, **over) -> "OptimizationConfig":
        base = dict(b1=5.0, b2=10.0, b3=1e-4, kappa_sparsity=1e-4,
                    alpha_max=50.0, max_iter=500)
        base.update(over)
        return cls(**base)

    @classmethod
    def from_dict(cls, d: dict) -> "OptimizationConfig":
        return cls(**_known(cls, d))


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
