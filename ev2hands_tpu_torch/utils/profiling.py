"""Profiling: a ``torch.profiler`` trace, the card's time per call from
CUDA events, and rolling step statistics.

Counterpart of ``ev2hands_tpu/utils/profiling.py``: ``trace`` on
``torch.profiler`` in place of ``jax.profiler``; ``device_throughput``
times calls queued back to back between two CUDA events, where the JAX
package scanned the function inside one compiled program; ``StepTimer`` as
it is.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str = "runs/profile"):
    """Profile the block's host and CUDA activity; writes a Chrome trace
    (``trace.json``, for chrome://tracing or Perfetto) under ``log_dir``
    and yields the profiler (``key_averages()`` for sums by kernel)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_throughput(fn: Callable[[int], object], iters: int = 20,
                      warmup: int = 2) -> float:
    """Seconds a call of ``fn(i)`` on the card, ``i`` the call's index:
    ``iters`` calls queued back to back between two CUDA events, after
    ``warmup`` calls. Make ``fn``'s work depend on ``i`` where a cache or
    a reuse of the same inputs would flatter it. Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_throughput: no CUDA device is available")
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(warmup + i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


class StepTimer:
    """Rolling wall-clock statistics of a loop's steps."""

    def __init__(self, window: int = 50):
        self.window = window
        self._last = time.perf_counter()
        self._samples = []

    def tick(self) -> float:
        """Seconds since the last tick (or the timer's creation)."""
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self._samples.append(dt)
        if len(self._samples) > self.window:
            self._samples.pop(0)
        return dt

    def stats(self) -> Dict[str, float]:
        """Mean, median and 90th percentile of the last ``window`` steps."""
        if not self._samples:
            return {}
        s = sorted(self._samples)
        return {
            "mean_s": sum(s) / len(s),
            "p50_s": s[len(s) // 2],
            "p90_s": s[int(len(s) * 0.9)],
        }
