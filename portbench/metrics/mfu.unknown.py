"""The whole unknown-skeleton protocol's share of the configuration's peak,
in %: the model FLOPs of the passes in the window (``harness/unknown_counts.py``:
pass 1's frames through the unknown-skeleton head, pass 2's through the
known-skeleton head, the Gauss-Newton calibration left out) over the
window's time, over the peak the configuration names."""


def read(record):
    w = record["window"]
    if "protocol_flops" not in w:
        return None
    return 100.0 * w["passes"] * w["protocol_flops"] / w["seconds"] / record["config"]["peak_flops_per_s"]
