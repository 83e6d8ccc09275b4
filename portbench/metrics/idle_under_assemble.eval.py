"""The share, in %, of the device's idle time in the traced pass (the gaps
between its first and last device activity) that falls inside the eval
driver's ``eval.assemble`` spans, whose host intervals its markers give on
the profiler's clock."""

import sys

from portbench.metrics import _spans


def read(record):
    spans = _spans.intervals(record, "eval.assemble")
    if not spans:
        return None
    busy = record["trace"].busy
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    total = sum(e - s for s, e in gaps)
    if total <= 0:
        return None
    inside = sum(max(0.0, min(ge, ae) - max(gs, as_)) for gs, ge in gaps for as_, ae in spans)
    print(f"idle_under_assemble.eval: {inside * 1e-6:.4f} s of {total * 1e-6:.4f} s of device gaps inside "
          f"eval.assemble", file=sys.stderr)
    return 100.0 * inside / total
