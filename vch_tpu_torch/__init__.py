"""vch_tpu_torch — the viscous Cahn–Hilliard sparse-control engine on
PyTorch and CUDA (NVIDIA Hopper).

A port of `vch_tpu` (JAX on a TPU), which stays beside it as the reference.
This package imports torch, numpy and the standard library only: never
JAX, the `vch_tpu` package or the validation library of its configs, so it
runs on a machine that has none of them. The batched 2D PGD paths
(`parallel.batch`) run the forward march and the adjoint sweep as whole-march
kernels, or their per-step Krylov solves on the scan path, and the
single-scenario problem (`control.problems.ControlProblem2D`) its per-solve
Krylov solves, as hand-written CUDA kernels on CUDA tensors (`ops.march`,
`ops.solve_kernels`), and their plain PyTorch versions on CPU tensors. Entry points run on the CUDA card unless given
another device (`device.resolve_device`).
"""
import torch as _torch

# Full float32 products everywhere but where a config asks otherwise (the
# fused march's Krylov operator at fused_solve_precision "bf16x3", the
# default, or "default"; the fused sweep's at adjoint_solve_precision
# "bf16x3": bf16 passes, as in vch_tpu). The adjoint step operator reaches
# condition ~1e6, and reduced-precision products (TF32 keeps ~10 mantissa
# bits) turn its Krylov solve into NaNs — the
# counterpart of the jax_default_matmul_precision='highest' pin in
# vch_tpu/__init__.py. Both flags are set explicitly: cuDNN's TF32 default
# is on.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

# vch_tpu's package exports (vch_tpu/__init__.py); config.py imports no torch
from vch_tpu_torch.config import (  # noqa: E402,F401
    ForwardSolverConfig1D,
    ForwardSolverConfig2D,
    OptimizationConfig,
    SimulationParameters,
    load_params,
    save_params,
)
