"""The control of each cell on the card, at a size a test run holds: the
training step with TF32 on (the program's own lower-precision path), and
in each lockstep cell's place the plain reference one precision step
below the configuration's trunk (float8 e4m3 convs under bf16, a bf16
trunk under f32), each fail the cell's limits. Run on the card with
``python -m pytest portbench/tests/test_portbench_control.py``."""

import time

import pytest
import torch

from portbench.harness import core
from portbench.harness.kinds import lockstep
from portbench.reference.network import Net

BENCH = core.load_json(core.ROOT / "BENCHMARK.json")
LOCKSTEP = [c["name"] for c in BENCH["workloads"]
            if core.load_json(core.BENCH_DIR / "traffic" / f"{c['traffic']}.json")["kind"] == "lockstep"]


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
@pytest.mark.parametrize("workload", LOCKSTEP)
def test_eval_control_fails(card, workload, seed):
    spec = core.load_spec(workload)
    spec.traffic.update(recordings=8, frames=16, check_recordings=4)
    cell = lockstep.Cell(core.Context(spec, seed))
    cell.setup()
    cell.release()
    cell.put_control()
    checks = cell.check()
    assert any(v > lim for _, v, lim in checks), checks


@pytest.mark.parametrize("config, rounds", [("umetrack-bf16", True), ("umetrack-f32", False)])
def test_eval_control_is_one_step_below(config, rounds):
    """The reference as the control builds it runs its convs in bf16: through
    float8 e4m3 under a bf16 configuration, as plain bf16 under an f32 one."""
    cfg = core.load_json(core.BENCH_DIR / "configs" / f"{config}.json")["model"]
    prec = lockstep.control_precision(cfg)
    g = torch.Generator().manual_seed(0)
    params = {"c.weight": torch.randn(8, 4, 3, 3, generator=g), "c.bias": torch.randn(8, generator=g)}
    x = torch.randn(2, 4, 12, 12, generator=g).to(torch.bfloat16)
    control = Net(cfg, params, prec["trunk_dtype"], prec["fp8"]).conv(x, "c")
    plain = Net(cfg, params, torch.bfloat16).conv(x, "c")
    assert control.dtype == torch.bfloat16
    assert torch.equal(control, plain) != rounds
