"""The whole eval step's share of the configuration's peak, in %: the
FLOPs of the frames tracked in the window (both hands, two views each
through the trunk, the fusion, the memory and the known-skeleton head,
counted from the configuration's shapes) over the window's time, over the
peak the configuration names."""


def read(record):
    w = record["window"]
    if "frame_flops" not in w:
        return None
    return 100.0 * w["frames"] * w["frame_flops"] / w["seconds"] / record["config"]["peak_flops_per_s"]
