"""Profiling and timing utilities (port of ``absolutetrack_tpu/utils/profiling.py``).

Replaces the reference's ad-hoc EMA FPS counters (demo/image_visualizer.py:105)
with device-time-aware instrumentation: ``torch.profiler`` traces of the host
and the card (where JAX takes ``jax.profiler`` traces) plus lightweight
wall-clock stage timers for pipeline stages.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the CPU and, where there is
    one, the card into ``log_dir`` (``*.pt.trace.json``: TensorBoard's
    profiler plugin, Perfetto or chrome://tracing read it)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class StageTimers:
    """Named wall-clock accumulators for pipeline stages."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "count": self.counts[k],
                "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1),
            }
            for k in self.totals
        }

    def report(self) -> str:
        lines = []
        for k, s in sorted(self.summary().items()):
            lines.append(f"{k:24s} {s['mean_ms']:8.2f} ms x {s['count']}")
        return "\n".join(lines)


class FpsCounter:
    """EMA FPS (the reference demo idiom), for display only."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.fps = None
        self._t = None

    def tick(self) -> float:
        now = time.perf_counter()
        if self._t is not None:
            inst = 1.0 / max(now - self._t, 1e-9)
            self.fps = inst if self.fps is None else ((1 - self.alpha) * self.fps + self.alpha * inst)
        self._t = now
        return self.fps or 0.0
