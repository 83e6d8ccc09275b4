"""Device kernels a train step, counted by the profiler over the traced
steps (memory copies and sets left out)."""


def read(record):
    tr = record.get("trace")
    if tr is None or tr.busy_s <= 0 or not record.get("traced_steps"):
        return None
    return tr.kernels / record["traced_steps"]
