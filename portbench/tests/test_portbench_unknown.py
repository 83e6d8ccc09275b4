"""The ``bf16-unknown-r24`` cell (the unknown-skeleton protocol in lockstep)
at a tiny size on the CPU: the program's protocol agrees with the plain
reference's, the result line has the contract's shape, the reference's
dense Gauss-Newton agrees with the program's batched one, and the faults
``half``, ``altered`` and ``mean`` (the mean of the per-frame scales in
the Gauss-Newton fit's place) planted under the timed path turn
``correct`` false. ``frozen`` moves the tiny model's pass 2 by less than a
limit set at full width, so it and the control (the reference one
precision step below the configuration) are held at full width on the
card, with ``mean`` again: ``python -m pytest
portbench/tests/test_portbench_unknown.py`` there."""

import time

import numpy as np
import pytest
import torch
from pb_helpers import TINY_MODEL

from portbench.harness import core
from portbench.harness import scene as scn
from portbench.harness.kinds import unknown_lockstep
from portbench.reference import kinematics as kin
from portbench.reference import unknown_skeleton as ref_unknown

CELL = "bf16-unknown-r24"
# both passes over the 8 frames (under the 30 of a calibration), in two chunks of 4
TINY_TRAFFIC = dict(recordings=2, frames=8, chunk=4, check_recordings=2)


def tiny_spec():
    spec = core.load_spec(CELL)
    spec.config["model"].update(TINY_MODEL)
    spec.traffic.update(TINY_TRAFFIC)
    return spec


def run_tiny(faults=(), trace=False, **init):
    spec = tiny_spec()
    spec.config["init"].update(init)
    return core.run_cell(spec, 12345678901, 0.1, trace, time.perf_counter(), device="cpu", faults=faults)


def test_program_agrees_with_reference():
    line, checks = run_tiny()
    assert line["correct"], checks
    assert [name for name, _, _ in checks] == ["scale_gap", "calib_gap", "valid_mismatch", "landmark_mean_mm",
                                               "angle_max_rad"]
    assert line["failed"] == 0 and line["attempted"] >= 2
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}


def test_traced_line_reads_the_protocol_spans():
    """On the CPU the spans have no device events and the profiler no device
    activity: the host-time share and the MFU are read, the device ms and the
    idle share are left out."""
    line, _ = run_tiny(trace=True)
    assert set(line["metrics"]) == {"calibrate_share.unknown", "mfu.unknown"}
    assert 0.0 < line["metrics"]["calibrate_share.unknown"]["value"] < 100.0
    assert line["metrics"]["mfu.unknown"]["value"] > 0.0


def test_dense_reference_gn_matches_the_program():
    """The reference's dense normal equations and the program's batched
    Schur-reduced solve give the same log-scales on seeded windows (one
    partly masked) of the scene's hand."""
    from absolutetrack_tpu_torch.kinematics import hand_model as hm
    from absolutetrack_tpu_torch.ops import gauss_newton as gn

    hand = scn.synthetic_hand_model()
    rng = np.random.default_rng(3)
    n_w, n_t = 3, 8

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    angles = f32(rng.uniform(-0.2, 0.8, (n_w, n_t, 22)))
    angles[..., 20:] = 0.0
    wrist = torch.eye(4).repeat(n_w, n_t, 1, 1)
    wrist[..., :3, :3] = kin.rodrigues(f32(rng.normal(0, 1, (n_w, n_t, 3))))
    wrist[..., :3, 3] = f32(rng.uniform(-80, 80, (n_w, n_t, 3)))
    ref_hand = scn.hand_tensors(hand, "cpu")
    targets = kin.landmarks(ref_unknown.scaled(ref_hand, f32(rng.uniform(0.9, 1.1, (n_w, n_t)))), angles, wrist)
    init = angles + f32(rng.uniform(-0.05, 0.05, angles.shape))
    init[..., 20:] = 0.0
    mask = torch.ones(n_w, n_t, dtype=torch.bool)
    mask[1, :5] = False
    dense = ref_unknown.gn_log_scales(ref_hand, targets, init, wrist, mask)
    program = gn.calibrate_scale_windows(hm.hand_model_from_dict(hand), targets, init, wrist, mask.float()).log_scale
    torch.testing.assert_close(dense, program, rtol=0, atol=1e-6)
    assert float(dense.abs().min()) > 1e-3  # the windows' scales are not 1


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_planted_fault_fails(fault):
    line, checks = run_tiny(faults=(fault,))
    assert not line["correct"], checks


def test_mean_in_the_calibration_s_place_fails_calib_gap():
    """The tiny trunk's pass-1 scales vary from frame to frame about ten
    times less than the full width's, so its log-scale output is widened
    ten times (``scale_output`` 1) to give the Gauss-Newton fit a spread of
    scales to weight; the sound run still holds."""
    line, checks = run_tiny(scale_output=1.0)
    assert line["correct"], checks
    line, checks = run_tiny(faults=("mean",), scale_output=1.0)
    failed = [name for name, value, limit in checks if not value <= limit]
    assert failed == ["calib_gap"], checks


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [7, 8, 9])
@pytest.mark.parametrize("what", ["control", "frozen", "mean"])
def test_control_and_faults_fail_on_the_card(card, what, seed):
    spec = core.load_spec(CELL)
    spec.traffic.update(recordings=8, check_recordings=4)
    cell = unknown_lockstep.Cell(core.Context(spec, seed, faults=() if what == "control" else (what,)))
    cell.setup()
    cell.release()
    if what == "control":
        cell.put_control()
    checks = cell.check()
    assert any(not v <= lim for _, v, lim in checks), checks
