"""Sizes and helpers shared by the benchmark's CPU tests."""

import time

# the full-width sizes cut to a CPU test: the topology stays, the widths shrink
TINY_MODEL = dict(network="resnet_layers_1111-f16", n_image_feature_channels=24, n_temporal_memory_channels=6,
                  input_size=[32, 32])
TINY_TRAFFIC = {
    "train_pool": dict(batch=4, pool_factor=4, traced_steps=1),
    "lockstep": dict(recordings=2, frames=4, chunk=2, check_recordings=2),
}


def tiny_spec(workload: str):
    from portbench.harness import core

    spec = core.load_spec(workload)
    spec.config["model"].update(TINY_MODEL)
    spec.traffic.update(TINY_TRAFFIC[spec.traffic["kind"]])
    return spec


def run_tiny(workload: str, faults=(), seed: int = 12345678901, trace: bool = False):
    """A whole run of the cell at the tiny size on the CPU -> (line, checks)."""
    from portbench.harness import core

    return core.run_cell(tiny_spec(workload), seed, 0.2, trace, time.perf_counter(), device="cpu", faults=faults)
