"""Host ms a chunk in the eval driver's ``eval.assemble`` span
(``apps/eval_lib.py::track_recordings_batched``: the frames stacked, padded
and the label arrays gathered), from its markers on the profiler's clock in
the traced pass, which nothing synchronises."""

from portbench.metrics import _spans


def read(record):
    spans = _spans.intervals(record, "eval.assemble")
    if not spans:
        return None
    return sum(e - s for s, e in spans) / len(spans) * 1e-3
