"""Device ms a train step of the optimizer: the ``train.optimizer`` span
around ``optimizer.update`` and ``apply_updates`` in the step of
``training/train.py::make_train_step``. The time the stream took from the
span's start to its end in the traced steps, waits for the host's launches
included."""

from portbench.metrics import _spans


def read(record):
    return _spans.mean_device_ms(record, "train.optimizer")
