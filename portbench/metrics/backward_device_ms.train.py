"""Device ms a train step of the backward pass: the ``train.backward`` span
around ``torch.autograd.grad`` in ``training/train.py::loss_and_grads``.
The time the stream took from the span's start to its end in the traced
steps, waits for the host's launches included."""

from portbench.metrics import _spans


def read(record):
    return _spans.mean_device_ms(record, "train.backward")
