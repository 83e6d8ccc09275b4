"""Device ms a chunk of the pipelined chunk's ConvRNN tail (the
``eval.scan_tail`` span in ``tracker/pipelined.py::track_chunk_eval_batched``):
the time the stream took from the span's start to its end in the traced
pass, waits for the host's launches of its frame loop included."""

from portbench.metrics import _spans


def read(record):
    return _spans.mean_device_ms(record, "eval.scan_tail")
