"""Profiling and timing utilities (port of ``absolutetrack_tpu/utils/profiling.py``).

Replaces the reference's ad-hoc EMA FPS counters (demo/image_visualizer.py:105)
with device-time-aware instrumentation: ``torch.profiler`` traces of the host
and the card (where JAX takes ``jax.profiler`` traces), and the program's
spans on the same timeline.

Spans. ``span(name, device)`` marks a stretch of the program's work: the
eval driver's chunk and its stages (``eval.*``), the train step and its
forward pass, backward pass and optimizer (``train.*``). A span records its
name, its parent (the span open around it on the host thread), its host
start and end (``time.perf_counter_ns``), counts attached to it, and, over
work on a card, a pair of timing CUDA events on the current stream. Its
device ms is the time the stream took from its start event to its end
event, waits for the host included; it is read when the spans are exported
(``spans()``), after the traced stretch, and nothing synchronises inside a
span. The recorder is on exactly while a ``torch.profiler`` session is
active (``device_trace``, or any other): then each span also leaves
zero-length ``record_function`` markers, ``<name>>`` at its start and
``<name><`` at its end, on the profiler's host timeline, where they share
the clock of every kernel. Markers enclose no work, so the profiler mirrors
no span onto the device's timeline. Without a profiler a span costs one
flag test (and a store that ends the stretch) and allocates nothing. The
recorder is one per process, as the profiler is: it holds the latest
profiled stretch's spans (at most ``MAX_SPANS``); ``device_trace``'s start,
or the first span opened under a profiler after a span opened without one,
begins a new stretch.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import record_function

MAX_SPANS = 10_000


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the CPU and, where there is
    one, the card into ``log_dir`` (``*.pt.trace.json``: TensorBoard's
    profiler plugin, Perfetto or chrome://tracing read it). The program's
    spans are on while it runs: their markers lie on the trace's host
    timeline, and ``spans()`` returns them afterwards."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    RECORDER.live = False
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def _marker(name: str) -> None:
    with record_function(name):
        pass


class Span:
    """One recorded span; ``span()`` makes it and the ``with`` statement
    opens and closes it."""

    __slots__ = ("name", "index", "parent", "start_ns", "end_ns", "counts", "events", "_stack")

    def __init__(self, name: str, index: int, stack: List[int], device: Optional[torch.device]):
        self.name, self.index, self._stack = name, index, stack
        self.parent = stack[-1] if stack else None
        self.start_ns = self.end_ns = None
        self.counts: Dict[str, int] = {}
        self.events = None
        if device is not None and device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True), stream)

    def count(self, key: str, n: int) -> None:
        """Add ``n`` to the span's count ``key`` (e.g. bytes uploaded)."""
        self.counts[key] = self.counts.get(key, 0) + n

    def __enter__(self) -> "Span":
        self._stack.append(self.index)
        _marker(self.name + ">")
        self.start_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[0].record(self.events[2])
        return self

    def __exit__(self, *exc) -> None:
        if self.events is not None:
            self.events[1].record(self.events[2])
        self.end_ns = time.perf_counter_ns()
        _marker(self.name + "<")
        if self._stack and self._stack[-1] == self.index:
            self._stack.pop()

    def device_ms(self) -> Optional[float]:
        if self.events is None or self.end_ns is None:
            return None
        start, end, _ = self.events
        end.synchronize()
        return start.elapsed_time(end)


class _Off:
    """The span of a run without a profiler: records nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def count(self, key: str, n: int) -> None:
        return None


OFF = _Off()


class SpanRecorder:
    """The spans of one profiled stretch, in the order they opened."""

    def __init__(self, limit: int = MAX_SPANS):
        self.limit = limit
        self.spans: List[Span] = []
        self.dropped = 0
        self.live = False  # False once a span ran without a profiler: the next one starts a new stretch
        self._local = threading.local()

    def stack(self) -> List[int]:
        """Indices of the spans open on this thread, innermost last."""
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def open(self, name: str, device: Optional[torch.device]):
        if not self.live:
            self.spans, self.dropped, self.live = [], 0, True
            self._local = threading.local()
        if len(self.spans) >= self.limit:
            self.dropped += 1
            return OFF
        sp = Span(name, len(self.spans), self.stack(), device)
        self.spans.append(sp)
        return sp


RECORDER = SpanRecorder()


def span(name: str, device: Optional[torch.device] = None):
    """A span named ``name`` for a ``with`` statement; pass ``device`` (the
    work's ``torch.device``) for a span over work on a card. Records only
    while a ``torch.profiler`` session is active."""
    if not autograd_profiler._is_profiler_enabled:
        RECORDER.live = False
        return OFF
    return RECORDER.open(name, device)


def spans() -> List[dict]:
    """The latest profiled stretch's spans, in the order they opened: name,
    parent (an index into this list, or None), host start and end in ns
    (``time.perf_counter_ns``), counts and device ms (None for a span
    without device events). Call after the stretch: reading a span's
    device ms waits for its end event."""
    return [
        dict(name=s.name, parent=s.parent, host_start_ns=s.start_ns, host_end_ns=s.end_ns,
             counts=dict(s.counts), device_ms=s.device_ms())
        for s in RECORDER.spans
    ]


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
