"""The device an entry point of the port runs on.

Every entry point (the solvers, the problems, the chooser) takes
`device=None`, which means the CUDA card: the port is built for it, and a
run that silently fell back to the CPU would report CPU numbers as the
card's. A caller who wants the plain PyTorch versions on the CPU (the tests)
passes `device="cpu"`.

An entry point that holds a device takes vch_tpu's array arguments: a
host numpy array, a Python sequence, or a tensor on any device, the port's
own CUDA outputs included. `as_tensor` brings one onto its device and
dtype, `to_numpy` onto the host where vch_tpu computes in numpy. (A
primitive with no device parameter takes tensors and computes where they
live.) Results stay tensors on the entry point's device: on the card,
`np.asarray(result)` needs `result.cpu()` first.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None is the CUDA card. Raises when a
    CUDA device is asked for (None included) and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vch_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions "
            "on the CPU")
    return device


def as_tensor(a, dtype=None, device=None) -> torch.Tensor:
    """An entry point's array argument as a tensor of `dtype` on `device`
    (None: keep the argument's). A tensor, on any device, moves with
    `Tensor.to`, which returns it unchanged when it already has both, and
    never passes through numpy (a CUDA tensor cannot); anything else (a
    numpy array, a Python sequence, a number) goes through `np.asarray`
    into a copy of its own, as vch_tpu's `jnp.asarray` takes it (a caller's
    array, read-only ones included, is never aliased)."""
    if torch.is_tensor(a):
        return a.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def to_numpy(a) -> np.ndarray:
    """An array argument as a host numpy array, where vch_tpu computes on
    the host: a tensor on any device is copied to the host, anything else
    goes through `np.asarray`."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)
