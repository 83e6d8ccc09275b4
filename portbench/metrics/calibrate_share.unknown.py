"""The share, in %, of the protocol's host time (the ``eval.protocol`` span
in ``apps/eval_lib.py::track_recordings_unknown_skeleton``) that lies inside
its ``eval.calibrate`` span, both from their markers on the profiler's clock
in the traced pass."""

from portbench.metrics import _spans


def read(record):
    whole, calib = _spans.intervals(record, "eval.protocol"), _spans.intervals(record, "eval.calibrate")
    if not whole or not calib:
        return None
    total = sum(e - s for s, e in whole)
    inside = sum(max(0.0, min(ce, we) - max(cs, ws)) for ws, we in whole for cs, ce in calib)
    return 100.0 * inside / total if total > 0 else None
