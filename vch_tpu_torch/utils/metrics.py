"""Structured metrics logging, one JSON object per event
(vch_tpu/utils/metrics.py): appended to a file and/or echoed, so long
batched runs are machine-parseable."""
from __future__ import annotations

import json
import time
from typing import Any, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._t0 = time.time()

    def log(self, event: str, **fields: Any):
        rec = {"event": event, "t": round(time.time() - self._t0, 3),
               **fields}
        line = json.dumps(rec, default=float)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print(line)
        return rec
