"""The device an entry point of the port runs on.

Every entry point (the solvers, the problems, the chooser) takes
`device=None`, which means the CUDA card: the port is built for it, and a
run that silently fell back to the CPU would report CPU numbers as the
card's. A caller who wants the plain PyTorch versions on the CPU (the tests)
passes `device="cpu"`.
"""
from __future__ import annotations

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
