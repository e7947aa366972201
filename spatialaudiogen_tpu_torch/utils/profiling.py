"""Profiling: device traces and host section timers (port of
spatialaudiogen_tpu.utils.profiling).

The reference only had a disabled Chrome-trace block (dnn.py:525-542);
here tracing is a context manager usable around any training window, plus
a lightweight section timer for host-side pipeline accounting.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def device_trace(logdir: str, device="cuda"):
    """Trace the block with torch.profiler: host (CPU) activity, and the
    card's kernels and copies when `device` is a CUDA device. On exit the
    trace is written under `logdir` as `<host>_<pid>.<time>.pt.trace.json`,
    which TensorBoard's torch-profiler plugin and Chrome's trace viewer
    (chrome://tracing, Perfetto) open. Asked for a CUDA device where there
    is no card, it raises."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_trace: a CUDA trace was asked for, and there is no card")
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)


class SectionTimer:
    """Accumulates wall time per named section (data/step/eval/...)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> dict:
        return {name: {"total_s": self.totals[name], "count": self.counts[name],
                       "mean_ms": 1000.0 * self.totals[name] / max(self.counts[name], 1)}
                for name in self.totals}
