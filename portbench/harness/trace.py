"""Reduction of a ``torch.profiler`` trace of a steady stretch to what the
per-layer metrics read: device busy time (the union of device activity
intervals), kernel counts, device time by name, and the longest idle
gaps with the host operation that ran when each began."""

from __future__ import annotations

import re
import time
from contextlib import contextmanager
from typing import List, Optional, Tuple

import torch


class Trace:
    """What one traced stretch showed. Empty (``busy_s`` 0) when the
    profiler recorded no device activity."""

    def __init__(self, window_s: float, device: List[Tuple[float, float, str]], host: List[Tuple[float, float, str]]):
        self.window_s = window_s
        self.device = sorted(device)
        self.host = sorted(host)
        merged = []
        for start, end, _ in self.device:
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        self.busy = merged
        self.busy_s = sum(e - s for s, e in merged) * 1e-6

    @property
    def kernels(self) -> int:
        return sum(1 for *_, name in self.device if not name.startswith(("Memcpy", "Memset")))

    def time_of(self, pattern: str) -> Tuple[float, int]:
        """(seconds, count) of the device activities whose name holds ``pattern``."""
        hits = [(e - s) for s, e, name in self.device if pattern in name]
        return sum(hits) * 1e-6, len(hits)

    def top_ops(self, k: int = 10):
        by_name = {}
        for s, e, name in self.device:
            key = _clean(name)
            by_name[key] = by_name.get(key, 0.0) + (e - s) * 1e-6
        return sorted(([n, t] for n, t in by_name.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10):
        """The longest gaps between device activity inside the stretch, each
        named by the innermost host operation running as it began."""
        gaps = [(self.busy[i + 1][0] - self.busy[i][1], self.busy[i][1]) for i in range(len(self.busy) - 1)]
        gaps.sort(reverse=True)
        out = []
        for length, at in gaps[:k]:
            name = "idle"
            for s, e, n in self.host:
                if s > at:
                    break
                if e >= at:
                    name = n
            out.append([_clean(name), length * 1e-6])
        return out


def _clean(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]", "_", name)[:64]


@contextmanager
def traced(device_type: str):
    """Profile the body: yields a list that holds the ``Trace`` afterwards.
    The body's work is synchronised at both ends."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = device_type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    box: List[Optional[Trace]] = []
    with profile(activities=activities) as prof:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield box
        if cuda:
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    device, host = [], []
    for e in prof.events():
        item = (e.time_range.start, e.time_range.end, e.name)
        (device if e.device_type == DeviceType.CUDA else host).append(item)
    box.append(Trace(window, device, host))
