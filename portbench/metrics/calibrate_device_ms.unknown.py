"""Device ms of the scale calibration in the traced protocol pass: the
``eval.calibrate`` span in ``apps/calibration.py::calibrated_scales``
(the FK targets of every window built, the batched Gauss-Newton solve and
the readback of the scales). The time the stream took from the span's start
to its end, waits for the host's launches included."""

from portbench.metrics import _spans


def read(record):
    return _spans.mean_device_ms(record, "eval.calibrate")
