"""Helpers of the port: timers, checkpoints, metrics logging and profiling
(vch_tpu/utils), and `convert` (state carried across from vch_tpu, imported
by name)."""
from vch_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from vch_tpu_torch.utils.metrics import MetricsLogger
from vch_tpu_torch.utils.profiling import SolveCounters, trace
from vch_tpu_torch.utils.timers import PhaseTimers

__all__ = ["PhaseTimers", "save_checkpoint", "load_checkpoint",
           "SolveCounters", "trace", "MetricsLogger"]
