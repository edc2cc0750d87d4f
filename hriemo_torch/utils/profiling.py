"""Step timing and device traces (port of ``hriemo/utils/profiling.py``).

``StepTimer`` keeps the wall times of steady-state steps (after
``warmup``) and reports p50/p95/mean and steps per second; ``trace`` runs
``torch.profiler`` over a block (the card's kernels too, where there is
one) and writes a Chrome trace into ``log_dir``, which TensorBoard's
profiler plugin and ``chrome://tracing`` read.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: list[float] = []
        self._t0 = None
        self._n = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.warmup:
            self._times.append(dt)
        return dt

    @contextlib.contextmanager
    def measure(self):
        self.start()
        yield
        self.stop()

    def summary(self) -> dict:
        if not self._times:
            return {"steps": 0}
        a = np.asarray(self._times)
        return {
            "steps": int(a.size),
            "p50_ms": float(np.percentile(a, 50) * 1000),
            "p95_ms": float(np.percentile(a, 95) * 1000),
            "mean_ms": float(a.mean() * 1000),
            "steps_per_sec": float(1.0 / a.mean()),
        }


@contextlib.contextmanager
def trace(log_dir: str | None):
    """A ``torch.profiler`` trace of the block into ``log_dir`` (host and,
    when a card is present, device activity) as ``<host>_<pid>.<time>.pt.trace.json``;
    a no-op without a log dir."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield
    print(f"[profiler] trace written to {log_dir}")
