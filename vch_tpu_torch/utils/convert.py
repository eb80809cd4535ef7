"""Carry state across from the JAX package.

vch_tpu's arrays arrive as numpy (or anything `np.asarray` takes) and leave
as the port's tensors on a chosen device, so a test can run both packages
on the same operator matrices, scenarios and configs. Nothing here imports
vch_tpu: the inputs are plain mappings and duck-typed objects.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from vch_tpu_torch.config import ForwardSolverConfig1D, ForwardSolverConfig2D
from vch_tpu_torch.ops.linsolve import SpectralOp1D, SpectralOp2D
from vch_tpu_torch.parallel.batch import ScenarioBatch


def _t(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def spectral_op_from_numpy(d: Mapping, dtype=torch.float64, device=None):
    """A SpectralOp2D from a mapping with keys Lx, Ly, Vx, Vy, Vx_inv,
    Vy_inv, lam, or a SpectralOp1D from one with keys L, V, Vinv, lam (e.g.
    `op._asdict()` of vch_tpu's SpectralOp2D or SpectralOp1D)."""
    cls = SpectralOp1D if "L" in d else SpectralOp2D
    return cls(*[_t(d[name], dtype, device) for name in cls._fields])


def scenario_batch_from_numpy(sc, dtype=torch.float64,
                              device=None) -> ScenarioBatch:
    """The port's ScenarioBatch, as tensors, from any object with vch_tpu's
    ScenarioBatch attributes (phi0, phi_T, phi_Q, b1, b2, b3, kappa_spar,
    u_min, u_max, and phi_Q_mode when phi_Q is None), 1D or 2D; a
    `sweep_1d` batch keeps its core-layout phi_Q (BatchedProblem1D.run adds
    the duplicated row)."""
    conv = lambda a: _t(a, dtype, device)
    procedural = sc.phi_Q is None
    return ScenarioBatch(
        phi0=conv(sc.phi0), phi_T=conv(sc.phi_T),
        phi_Q=None if procedural else conv(sc.phi_Q),
        b1=conv(sc.b1), b2=conv(sc.b2), b3=conv(sc.b3),
        kappa_spar=conv(sc.kappa_spar), u_min=float(sc.u_min),
        u_max=float(sc.u_max),
        phi_Q_mode=sc.phi_Q_mode if procedural else None)


def control_arrays_from_vch_tpu(prob) -> dict:
    """phi0, phi_T_target, phi_Q_target and the baseline phi_hist0 of a
    vch_tpu ControlProblem2D or ControlProblem1D (any object with those
    attributes; the 1D ones in the reference layout), as float64 numpy
    arrays."""
    return {name: np.array(getattr(prob, name), dtype=np.float64)
            for name in ("phi0", "phi_T_target", "phi_Q_target", "phi_hist0")}


def config_from_vch_tpu(d: Mapping):
    """The port's ForwardSolverConfig2D or, for a dump with N and no Nx,
    ForwardSolverConfig1D, from vch_tpu's `model_dump()` of the matching
    config (or its JSON, loaded), every solver knob included."""
    cls = ForwardSolverConfig1D if "N" in d and "Nx" not in d \
        else ForwardSolverConfig2D
    return cls.from_dict(dict(d))
