"""The whole train step's share of the configuration's peak, in %: 3 x the
forward FLOPs of the windows trained in the window (the trunk and memory
once a sample, both heads, counted from the configuration's shapes) over
the window's time, over the peak the configuration names."""


def read(record):
    w = record["window"]
    if "step_flops" not in w:
        return None
    return 100.0 * w["steps"] * w["step_flops"] / w["seconds"] / record["config"]["peak_flops_per_s"]
