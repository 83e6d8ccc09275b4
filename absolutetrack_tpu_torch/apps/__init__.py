"""Eval drivers (the library half of ``absolutetrack_tpu/apps``)."""
