"""Timing and roofline helpers; port of hcspmm_tpu/utils/profiling.py for
one NVIDIA H100.

``Timer`` spans the host clock and synchronises the card at each stop;
``time_fn`` averages a function's host time over many calls; ``device_time``
reads the card's own kernel time from ``torch.profiler``; ``roofline``
compares a time with the card's published peaks; ``trace`` writes a Chrome
trace of a block.  A time taken on the CPU is a host time: ``device_time``
raises without a card rather than report one.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch

#: One H100 SXM, NVIDIA's data sheet (dense rates, at the 700 W limit): HBM3
#: bytes a second and peak operations a second, fp32 outside the tensor
#: cores and bf16 on them (the constants PERF.md's bounds use).
H100_HBM_GBPS = 3350.0
H100_FP32_TFLOPS = 67.0
H100_BF16_TFLOPS = 989.0


def _sync(device=None) -> None:
    if torch.cuda.is_available() and (device is None or torch.device(device).type == "cuda"):
        torch.cuda.synchronize(device)


class Timer:
    """Host-clock spans, each ended by a synchronise of the card (when the
    machine has one) so that the work queued inside the span is counted."""

    def __init__(self):
        self.records: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str, device=None):
        t0 = time.perf_counter()
        yield
        _sync(device)
        self.records[name] = self.records.get(name, 0.0) + time.perf_counter() - t0


def time_fn(fn, *args, rounds: int = 100, warmup: int = 5) -> float:
    """Average host seconds per call of ``fn(*args)`` over ``rounds`` calls
    after ``warmup``, the card synchronised before and after."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(rounds):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / rounds


def device_time(fn, *args, iters: int = 20) -> float:
    """Device seconds per call of ``fn(*args)``: the summed duration of the
    CUDA kernels ``torch.profiler`` records over ``iters`` calls
    (``utils.bench.device_ms``).  Raises RuntimeError on a machine without
    a CUDA card: a CPU run has no device time."""
    if not torch.cuda.is_available():
        raise RuntimeError("no device time without a CUDA card: device_time measures its "
                           "kernels")
    from hcspmm_tpu_torch.utils.bench import device_ms

    return device_ms(lambda: fn(*args), iters, ()) / 1e3


def roofline(seconds: float, bytes_moved: float, flops: float, nnz: Optional[int] = None,
             hbm_gbps: float = H100_HBM_GBPS,
             peak_tflops: float = H100_FP32_TFLOPS) -> Dict:
    """Achieved against the card's peaks (``peak_tflops``: H100_FP32_TFLOPS
    or H100_BF16_TFLOPS by the inputs' type); ``bound`` names the resource
    that limits at full efficiency and ``speed_of_light_s`` is the least
    time the work could take."""
    t_mem = bytes_moved / (hbm_gbps * 1e9)
    t_ops = flops / (peak_tflops * 1e12)
    res = {
        "seconds": seconds,
        "gbytes_per_s": bytes_moved / seconds / 1e9,
        "hbm_efficiency": t_mem / seconds if seconds else 0.0,
        "tflops": flops / seconds / 1e12,
        "flops_efficiency": t_ops / seconds if seconds else 0.0,
        "bound": "memory" if t_mem >= t_ops else "compute",
        "speed_of_light_s": max(t_mem, t_ops),
    }
    if nnz:
        res["gnnz_per_s"] = nnz / seconds / 1e9
    return res


@contextlib.contextmanager
def trace(path: str = "hcspmm_trace.json"):
    """Chrome trace (``chrome://tracing``, Perfetto) of the enclosed block
    by ``torch.profiler``, the card's kernels included where there is one,
    written to ``path``."""
    act = torch.profiler.ProfilerActivity
    acts = [act.CPU] + ([act.CUDA] if torch.cuda.is_available() else [])
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(path)
