"""The share of a traced protocol pass, in %, that no device activity
covers (the union of the profiler's device intervals)."""


def read(record):
    tr = record.get("trace")
    if tr is None or tr.busy_s <= 0 or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
