"""Port parity: the evaluation protocol (``kinematics/metrics.py``,
``apps/load_eval.py``, ``apps/run_eval_known_skeleton.py``,
``apps/run_eval_unknown_skeleton.py``) and the CPU rehearsal of
``chip_smoke.py``'s protocol phase.

The CLIs of both packages run on the same hermetic label tree: two
recordings cut from ``chip_smoke.build_scene(mesh=True)`` (10 frames from
frame 0, 9 from frame 2, so the lockstep pads the shorter one), the
scene's hand model as the generic hand model, frames rendered by each
package's mesh renderer, and one reference-named ``.pt`` checkpoint
(``chip_smoke.reference_state_dict``) at ``--tiny-arch``, the port with
``--torch-device cpu``.

Tolerances: result pickles, tracked landmarks 0.5 mm where valid (the JAX
twin's budget), validity equal, GT landmarks 1e-3 mm; calibrated scales
1e-5 relative; printed numbers to the last printed digit. Metrics: counts
and PCK fractions exact (errors on the thresholds included), sums and
means 1e-6 relative.
"""

import io
import json
import os
import pickle
import re
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from absolutetrack_tpu.apps import load_eval as jload_eval
from absolutetrack_tpu.apps import run_eval_known_skeleton as jknown
from absolutetrack_tpu.apps import run_eval_unknown_skeleton as junknown
from absolutetrack_tpu.kinematics import metrics as JM
from absolutetrack_tpu_torch.apps import calibration, load_eval
from absolutetrack_tpu_torch.apps import run_eval_known_skeleton as known
from absolutetrack_tpu_torch.apps import run_eval_unknown_skeleton as unknown
from absolutetrack_tpu_torch.kinematics import metrics as M
from absolutetrack_tpu_torch.models.config import ModelConfig
from absolutetrack_tpu_torch.ops import warp_kernel

jax.config.update("jax_platforms", "cpu")

CUTS = ((0, 10), (2, 9))  # (start, length) of each recording
LANDMARK_TOL_MM = 0.5
SCALE_REL = 1e-5


def make_tree(root) -> dict:
    """The label tree, the generic hand model and the checkpoint under ``root``."""
    scene = chip_smoke.build_scene(5, n_frames=12, mesh=True)
    user = root / "data" / "testing" / "user00"
    user.mkdir(parents=True)
    for i, (start, length) in enumerate(CUTS):
        (user / f"recording_{i:02d}.json").write_text(json.dumps(chip_smoke.labels_json(scene, start, length)))
    generic = root / "generic_hand_model.json"
    generic.write_text(json.dumps({k: np.asarray(v).tolist() for k, v in scene["hand_model"].items()}))
    checkpoint = root / "reference.pt"
    torch.save(chip_smoke.reference_state_dict(ModelConfig.tiny(), seed=3), checkpoint)
    return dict(data=str(root / "data"), generic=str(generic), checkpoint=str(checkpoint), root=root)


def run_both(tree, jax_module, port_module, name, argv) -> tuple:
    """Run the JAX and the port CLI with ``argv`` -> (JAX out dir, port out
    dir, JAX lines, port lines)."""
    outs, lines = [], []
    for module, extra in ((jax_module, []), (port_module, ["--torch-device", "cpu"])):
        out = str(tree["root"] / f"{name}_{module.__name__.split('.')[0]}")
        buf = io.StringIO()
        with redirect_stdout(buf):
            module.main([
                "--input-dir", tree["data"], "--output-dir", out, "--checkpoint", tree["checkpoint"], "--tiny-arch",
            ] + argv + extra)
        outs.append(out)
        lines.append(buf.getvalue().splitlines())
    return outs[0], outs[1], lines[0], lines[1]


def assert_same_lines(a, b):
    """The same printed lines, numbers equal to the last printed digit."""
    assert len(a) == len(b), (a, b)
    number = re.compile(r"-?\d+\.\d+")
    for x, y in zip(a, b):
        assert number.sub("#", x) == number.sub("#", y), (x, y)
        for u, v in zip(number.findall(x), number.findall(y)):
            digits = len(u.split(".")[1])
            assert abs(float(u) - float(v)) <= 1.01 * 10**-digits, (x, y)


def assert_same_results(jax_dir, port_dir, n_expected) -> dict:
    """The two packages' result pickles within the stated tolerances."""
    a, b = chip_smoke.read_results(jax_dir), chip_smoke.read_results(port_dir)
    assert sorted(a) == sorted(b) and len(a) == n_expected
    for name in a:
        x, y = a[name], b[name]
        assert sorted(x) == sorted(y)
        np.testing.assert_array_equal(x["valid_tracking"], y["valid_tracking"])
        v = x["valid_tracking"]
        assert v.any()
        err = np.linalg.norm(x["tracked_keypoints"] - y["tracked_keypoints"], axis=-1)[v]
        assert err.max() < LANDMARK_TOL_MM, f"{name}: {err.max()} mm"
        np.testing.assert_allclose(x["gt_keypoints"], y["gt_keypoints"], atol=1e-3)
        if "calibrated_scale" in x:
            np.testing.assert_allclose(y["calibrated_scale"], x["calibrated_scale"], rtol=SCALE_REL)
    return b


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("protocol"))


# -- metrics -------------------------------------------------------------------


def _errors_on_thresholds():
    """Errors on, just below and just above each PCK threshold, in f32 (but
    for 0's neighbours, subnormals that JAX's CPU flushes to 0), and as
    float64 values that round to the threshold in f32."""
    th = M.PCK_THRESHOLDS
    f32 = np.concatenate([th, np.nextafter(th[1:], np.float32(-1)), np.nextafter(th[1:], np.float32(100))])
    f64 = th.astype(np.float64) + np.float64(1e-9) * (th > 0)  # above in f64, equal in f32
    return f32, f64


def test_metric_functions_match_jax():
    rng = np.random.default_rng(0)
    gt = rng.normal(0, 30, (2, 7, 21, 3)).astype(np.float32)
    tr = gt + rng.normal(0, 5, gt.shape).astype(np.float32)
    valid = rng.random((2, 7)) > 0.3
    close = lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6)  # noqa: E731
    close(JM.mpjpe(gt, tr), M.mpjpe(gt, tr))
    close(JM.keypoint_acceleration(tr), M.keypoint_acceleration(tr))
    np.testing.assert_array_equal(np.asarray(JM.acceleration_valid_mask(valid)), M.acceleration_valid_mask(valid))
    err = np.asarray(M.mpjpe(gt, tr))
    for mask in (None, valid):
        np.testing.assert_array_equal(
            np.asarray(JM.pck_curve(err, mask=None if mask is None else jax.numpy.asarray(mask))),
            M.pck_curve(err, mask=mask).numpy(),
        )
        np.testing.assert_array_equal(
            np.asarray(JM.pck_curve_per_axis(err, 0, mask=None if mask is None else jax.numpy.asarray(mask))),
            M.pck_curve_per_axis(err, 0, mask=mask).numpy(),
        )
    y = M.pck_curve(err).numpy()
    close(JM.normalized_auc(JM.PCK_THRESHOLDS, y), M.normalized_auc(M.PCK_THRESHOLDS, y))
    close(JM.normalized_auc(JM.PCK_THRESHOLDS, np.stack([y, y / 2]), 2.0), M.normalized_auc(M.PCK_THRESHOLDS, np.stack([y, y / 2]), 2.0))
    close(JM.masked_mean(jax.numpy.asarray(err), jax.numpy.asarray(valid)), M.masked_mean(err, valid))
    assert float(M.masked_mean(err, np.zeros_like(valid))) == 0.0 == float(JM.masked_mean(jax.numpy.asarray(err), jax.numpy.zeros(valid.shape, bool)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pck_on_thresholds_matches_jax(dtype):
    """An error on a threshold counts on the same side as in JAX, also when
    it is a float64 value that lies within f32 rounding of the threshold."""
    f32, f64 = _errors_on_thresholds()
    errors = f32 if dtype == "float32" else f64
    got = M.pck_curve(errors).numpy()
    np.testing.assert_array_equal(np.asarray(JM.pck_curve(errors)), got)
    if dtype == "float64":  # read as f32, every error lies on its threshold
        np.testing.assert_array_equal(got, np.arange(1, 102, dtype=np.float32) / np.float32(101))
    per_axis = M.pck_curve_per_axis(errors.reshape(1, -1), 0).numpy()
    np.testing.assert_array_equal(np.asarray(JM.pck_curve_per_axis(errors.reshape(1, -1), 0)), per_axis)
    assert M.pck_curve(errors).dtype == torch.float32


def _write_results(root, rng, n):
    for i in range(n):
        t = 5 + i
        gt = rng.normal(0, 30, (2, t, 21, 3)).astype(np.float32)
        d = dict(
            gt_keypoints=gt,
            tracked_keypoints=gt + rng.normal(0, 4 + 3 * i, gt.shape).astype(np.float32),
            valid_tracking=rng.random((2, t)) > 0.2,
        )
        path = root / "eval_results_known_skeleton" / f"user{i}" / f"recording_{i:02d}.npy"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(pickle.dumps(d))


def test_load_eval_matches_jax(tmp_path):
    _write_results(tmp_path, np.random.default_rng(1), 3)
    d = str(tmp_path / "eval_results_known_skeleton")
    want, got = jload_eval.aggregate_metrics(d), load_eval.aggregate_metrics(d)
    assert sorted(want) == sorted(got)
    for k in want:
        assert type(want[k]) is type(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert load_eval.aggregate_metrics(str(tmp_path / "missing")) is None
    outs = []
    for module in (jload_eval, load_eval):
        buf = io.StringIO()
        with redirect_stdout(buf):
            module.main(["--root", str(tmp_path)])
        outs.append(buf.getvalue().splitlines())
    assert outs[0][0] == "Evaluation for known_skeleton on <all>:" and len(outs[0]) == 6
    assert_same_lines(*outs)
    one = pickle.loads(next((tmp_path / "eval_results_known_skeleton").rglob("*.npy")).read_bytes())
    a = jload_eval.compute_sequence_metrics(one["gt_keypoints"], one["tracked_keypoints"], one["valid_tracking"])
    b = load_eval.compute_sequence_metrics(one["gt_keypoints"], one["tracked_keypoints"], one["valid_tracking"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


# -- the CLIs --------------------------------------------------------------------


def test_find_label_files_matches_jax(tmp_path):
    for rel in ("testing/u1/b.json", "testing/u1/a.json", "testing/u1/._a.json", "training/u2/c.json",
                "testing/u1/notes.txt", "testing/u0/d.json"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text("{}")
    for test_only in (True, False):
        got = known.find_label_files(str(tmp_path), test_only)
        assert got == jknown.find_label_files(str(tmp_path), test_only)
        assert not any(os.path.basename(p).startswith(".") for p in got)
    assert [os.path.relpath(p, tmp_path) for p in known.find_label_files(str(tmp_path))] == [
        "testing/u0/d.json", "testing/u1/a.json", "testing/u1/b.json"
    ]


@pytest.mark.parametrize("batch", ["1", "2"])
def test_known_skeleton_cli_matches_jax(tree, batch):
    """One recording at a time (rank 0 of 2 takes recording 0 alone) and two in lockstep."""
    shard = ["--rank", "0", "--world-size", "2"] if batch == "1" else []
    before = warp_kernel.K1.launches
    j, t, jl, tl = run_both(tree, jknown, known, f"known{batch}", ["--batch-recordings", batch] + shard)
    assert_same_results(j, t, 1 if batch == "1" else 2)
    assert_same_lines(jl, tl)
    assert tl[0] == f"[rank 0] {1 if batch == '1' else 2} sequences" and tl[-1].startswith("Final mean error")
    assert warp_kernel.K1.launches == before


@pytest.mark.parametrize("mode,batch", [("mean", "1"), ("lstsq", "2")])
def test_unknown_skeleton_cli_matches_jax(tree, mode, batch):
    shard = ["--rank", "0", "--world-size", "2"] if batch == "1" else []
    argv = ["--batch-recordings", batch, "--generic-hand-model", tree["generic"], "--calib-mode", mode] + shard
    j, t, jl, tl = run_both(tree, junknown, unknown, f"unknown_{mode}{batch}", argv)
    results = assert_same_results(j, t, 1 if batch == "1" else 2)
    assert_same_lines(jl, tl)
    assert all(0.5 < r["calibrated_scale"] < 2.0 for r in results.values())
    assert sum("calibrated scale" in line for line in tl) == len(results)


def test_robust_scale_matches_jax():
    rng = np.random.default_rng(2)
    scales = np.concatenate([rng.normal(1.0, 0.02, 28), [1.6, 1.8]]).astype(np.float32)
    for mode in ("mean", "lstsq"):
        assert calibration.robust_scale(scales, mode) == junknown.robust_scale(scales, mode)
    assert calibration.robust_scale(scales[:0]) == 1.0
    assert abs(calibration.robust_scale(scales, "lstsq") - 1.0) < abs(calibration.robust_scale(scales, "mean") - 1.0)


def test_cli_skips_existing_results_and_refuses_a_mesh(tree):
    out = str(tree["root"] / "skip")
    argv = ["--input-dir", tree["data"], "--output-dir", out, "--checkpoint", tree["checkpoint"], "--tiny-arch",
            "--torch-device", "cpu", "--max-frames", "2"]
    for expect_skip in (False, True):
        buf = io.StringIO()
        with redirect_stdout(buf):
            known.main(argv)
        assert ("skip testing/user00/recording_00 (exists)" in buf.getvalue()) == expect_skip
    assert chip_smoke.read_results(out)["testing/user00/recording_00.npy"]["valid_tracking"].shape == (2, 2)
    # --mesh-data 2 needs a world of 2 ranks (torchrun; tests/test_torch_parallel.py runs one)
    for module, extra in ((known, []), (unknown, ["--generic-hand-model", tree["generic"]])):
        with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
            module.main(argv + extra + ["--mesh-data", "2", "--override"])


def test_chip_smoke_protocol_on_the_cpu():
    """The protocol phase at tiny width on the CPU: its checkpoint round
    trip, label tree, CLI runs (known skeleton sequential and in lockstep,
    unknown skeleton with the mean and the GN calibration) and metrics, at 8
    frames a recording. Lockstep equals sequential, every run tracks every
    hand of the clean scene, the scales stay near 1, and no K1 launches."""
    before = warp_kernel.K1.launches
    rep = chip_smoke.protocol_phase(0, device="cpu", n_frames=8, tiny=True)
    assert warp_kernel.K1.launches == before and rep["k1_launches"] == 0
    assert sorted(rep["runs"]) == ["known_b1", "known_b4", "unknown_gn", "unknown_mean"]
    assert rep["checkpoint_round_trip_bit_equal"]
    assert rep["known_lockstep_vs_sequential_max_err_mm"] < chip_smoke.LANDMARK_TOL_MM
    for name, run in rep["runs"].items():
        assert run["metrics"]["success_rate"] == 1.0 and run["metrics"]["n_total"] == 2 * 8 * chip_smoke.PROTOCOL_RECORDINGS
        assert 0.0 < run["render_share"] < 1.0 and run["frames_rendered"] == run["frames_tracked"]
        json.dumps(run)
    assert len(rep["calibrated_scales"]["gn"]) == chip_smoke.PROTOCOL_RECORDINGS
    np.testing.assert_allclose(rep["calibrated_scales"]["gn"], rep["calibrated_scales"]["mean"], rtol=1e-3)
