"""The control of each cell on the card, at a size a test run holds: the
training step with TF32 on (the program's own lower-precision path), and
the reference with every conv in float8 e4m3 in the eval's place, each
fail the cell's limits. Run on the card with
``python -m pytest portbench/tests/test_portbench_control.py``."""

import time

import pytest
import torch

from portbench.harness import core
from portbench.harness.kinds import lockstep
from portbench.reference import tracking


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [7, 8, 9])
def test_train_control_fails(card, seed):
    spec = core.load_spec("f32-train-pool")
    spec.traffic["batch"] = 128
    spec.config["conv_precision"] = "high"
    line, checks = core.run_cell(spec, seed, 1.0, False, time.perf_counter())
    assert not line["correct"], checks


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [7, 8, 9])
def test_eval_control_fails(card, seed):
    spec = core.load_spec("bf16-lockstep")
    spec.traffic.update(recordings=8, frames=16, check_recordings=4)
    cell = lockstep.Cell(core.Context(spec, seed))
    cell.setup()
    cell.release()
    params = lockstep.make_params(spec.config["model"], seed, "cuda", **spec.config["init"])
    for r in lockstep.sample(spec.traffic, seed):
        rec = lockstep.scn.reference_recording(cell.scene, r, spec.traffic["frames"], "cuda")
        cell.results[r] = lockstep.as_result(
            tracking.track(spec.config["model"], params, rec, torch.bfloat16, True, fp8=True))
    checks = cell.check()
    assert any(v > lim for _, v, lim in checks), checks
