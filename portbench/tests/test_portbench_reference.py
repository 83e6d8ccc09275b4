"""Whole runs of each cell at a tiny size on the CPU (the look for a card
skipped): the program agrees with the plain reference, the result line
has the contract's shape, and each fault planted under the timed path
turns ``correct`` false."""

import json

import pytest
from pb_helpers import run_tiny

CELLS = ("f32-train-pool", "bf16-lockstep")
FAULTS = ("frozen", "half", "altered")


@pytest.mark.parametrize("workload", CELLS)
def test_program_agrees_with_reference(workload):
    line, checks = run_tiny(workload)
    assert line["correct"], checks
    assert line["failed"] == 0 and line["attempted"] >= 1


@pytest.mark.parametrize("workload", CELLS)
def test_last_line_shape(workload):
    line, checks = run_tiny(workload, trace=True)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and set(line["checks"]) == {name for name, _, _ in checks}
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    json.loads(json.dumps(line))
    plain, _ = run_tiny(workload)
    e2e = {"f32-train-pool": "train_crops_per_s", "bf16-lockstep": "frames_per_s"}[workload]
    assert set(plain["metrics"]) == {e2e, "setup_s"}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_planted_fault_fails(workload, fault):
    line, checks = run_tiny(workload, faults=(fault,))
    assert not line["correct"], checks
