"""Device ms of pass 1 in the traced protocol pass: the ``eval.calib_pass``
span in ``apps/eval_lib.py::track_recordings_unknown_skeleton`` (the first
frames of every recording through the unknown-skeleton head, in lockstep).
The time the stream took from the span's start to its end, waits for the
host's launches included."""

from portbench.metrics import _spans


def read(record):
    return _spans.mean_device_ms(record, "eval.calib_pass")
