"""What the program's span readers share: the host intervals of a span's
markers in the traced stretch, and the program's own record of those spans
(``absolutetrack_tpu_torch.utils.profiling.spans``), which holds each span's
counts and device ms. Both are None where the program has no spans."""


def intervals(record, name):
    """[(start, end)] in us on the profiler's clock, between each ``<name>>``
    marker's end and the next ``<name><`` marker's start, or None."""
    tr = record.get("trace")
    if tr is None:
        return None
    opens = sorted(e for _, e, n in tr.host if n == name + ">")
    closes = sorted(s for s, _, n in tr.host if n == name + "<")
    if not opens or len(opens) != len(closes) or any(b < a for a, b in zip(opens, closes)):
        return None
    return list(zip(opens, closes))


def recorded(record, name):
    """The program's spans named ``name`` in the traced stretch, or None
    where the program keeps no spans or its record is not this trace's."""
    marks = intervals(record, name)
    if not marks:
        return None
    try:
        from absolutetrack_tpu_torch.utils import profiling
    except ImportError:
        return None
    export = getattr(profiling, "spans", None)
    if export is None:
        return None
    spans = [s for s in export() if s["name"] == name]
    return spans if len(spans) == len(marks) else None


def mean_device_ms(record, name):
    spans = recorded(record, name)
    if not spans or any(s["device_ms"] is None for s in spans):
        return None
    return sum(s["device_ms"] for s in spans) / len(spans)
