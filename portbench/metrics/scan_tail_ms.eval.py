"""Host ms a chunk in the pipelined chunk's ``scan_tail`` stage (the
ConvRNN and heads stepped over the chunk's frames,
``tracker/pipelined.py``), its end synchronised (``stage_hook``)."""


def read(record):
    stages = record.get("stage_ms")
    if not stages or "scan_tail" not in stages:
        return None
    return stages["scan_tail"]
