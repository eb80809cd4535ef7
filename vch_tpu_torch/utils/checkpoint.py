"""PGD state checkpoints (vch_tpu/utils/checkpoint.py).

One compressed .npz holds the arrays of a state and a `__meta__` entry, the
JSON of a meta dict as uint8 bytes: the layout vch_tpu writes, so each
package reads the other's file. Tensors, on any device, are saved as host
numpy arrays; loading gives numpy arrays.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np

from vch_tpu_torch.device import to_numpy as host_numpy


def save_checkpoint(path: str, state: Dict[str, Any],
                    meta: Dict[str, Any] | None = None) -> str:
    """Save the arrays of `state` (and the JSON `meta`) atomically."""
    arrays = {k: host_numpy(v) for k, v in state.items()}
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, __meta__=np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8), **arrays)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str):
    """Return (state dict of numpy arrays, meta dict)."""
    with np.load(path) as data:
        meta = (json.loads(bytes(data["__meta__"]).decode())
                if "__meta__" in data else {})
        state = {k: data[k] for k in data.files if k != "__meta__"}
    return state, meta
