"""What every probe entry point shares: the card it times, its clock, and
the card's published peaks."""
from __future__ import annotations

import torch

from vch_tpu_torch.device import resolve_device

# Published peaks of one H100 SXM (NVIDIA's data sheet): FP32 outside the
# tensor cores, dense bf16 on the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def cuda_device(device=None) -> torch.device:
    """`device` resolved (None: the card); a probe times the CUDA kernels,
    so any other device raises."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError("the probe times the CUDA kernels: it needs a "
                           "CUDA device")
    return device


def time_ms(fn, reps: int) -> float:
    """Mean ms of fn() over reps calls after one warm-up call, between two
    CUDA events on the current stream."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device ms of fn() over reps calls captured in one CUDA graph
    and replayed three times, after a warm-up call on the capturing stream:
    the device's time without the host's cost of each launch."""
    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(reps):
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)
