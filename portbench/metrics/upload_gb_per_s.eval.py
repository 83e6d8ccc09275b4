"""GB/s of the eval driver's upload (the ``eval.upload`` span in
``apps/eval_lib.py::track_recordings_batched``): the bytes it counts
copying to the card (frames and label arrays) over its device ms, the time
the stream took from the span's start to its end, in the traced pass."""

from portbench.metrics import _spans


def read(record):
    spans = _spans.recorded(record, "eval.upload")
    if not spans or any(s["device_ms"] is None for s in spans):
        return None
    ms = sum(s["device_ms"] for s in spans)
    nbytes = sum(s["counts"].get("bytes", 0) for s in spans)
    return nbytes / (ms * 1e-3) / 1e9 if ms > 0 and nbytes > 0 else None
