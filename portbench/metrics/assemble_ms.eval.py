"""Host ms a chunk in the eval driver's ``assemble`` and ``upload`` stages
(``apps/eval_lib.py``), each stage's end synchronised (``stage_hook``)."""


def read(record):
    stages = record.get("stage_ms")
    if not stages or "assemble" not in stages:
        return None
    return stages["assemble"] + stages.get("upload", 0.0)
