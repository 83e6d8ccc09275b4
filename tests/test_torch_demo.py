"""Port parity: the live demo's path (the inverse camera chain, 2D-driven
crops, ``track_frame_from_2d``, ``LiveTracker``) and its host parts.

The replay is ``chip_smoke.build_scene`` with its box-mesh hand, views 1-2
as the stereo pair (``apps/demo/main.py``'s replay), at
``ModelConfig.tiny()`` (32x32 crops) with the JAX weights carried across,
heads x0.02 and ConvRNN x0.1 as in ``tests/test_torch_model.py``.
Tolerances:

* ``unproject``, ``undistort``, ``window_to_eye``, ``crop``: 1e-5 (unit
  rays and normalized coordinates from f32 chains), the on-axis pixel
  included;
* ``gen_crop_slots_from_2d``: those of ``tests/test_torch_geometry.py``
  (world-to-eye 1e-4, focal 1e-3 + 1e-5 relative), validity equal; on the
  scene's views the focal at 3e-5 relative (see that test);
* ``LiveTracker`` against JAX's, frame by frame: landmarks 0.5 mm (the
  tracker's budget), the tracked hands equal;
* the replay's keypoints: 1e-3 px (f32 projections); packets, slots and
  the stereo rig: exact.
"""

import copy
import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from absolutetrack_tpu.apps.demo import detector_2d as jdet
from absolutetrack_tpu.apps.demo import main as jmain
from absolutetrack_tpu.apps.demo import pipeline as jpipe
from absolutetrack_tpu.apps.demo import stereo_rig as jrig
from absolutetrack_tpu.apps.demo import unity_udp as judp
from absolutetrack_tpu.geometry import camera as jcam
from absolutetrack_tpu.kinematics.hand_model import hand_model_from_dict as jhand
from absolutetrack_tpu.models import umetrack as jum
from absolutetrack_tpu.models.config import ModelConfig as JConfig
from absolutetrack_tpu.tracker import crop_gen as jcg
from absolutetrack_tpu.tracker import tracker as jtr
from absolutetrack_tpu_torch.apps.demo import detector_2d as det
from absolutetrack_tpu_torch.apps.demo import main as demo_main
from absolutetrack_tpu_torch.apps.demo import pipeline as pipe
from absolutetrack_tpu_torch.apps.demo import stereo_rig as rig
from absolutetrack_tpu_torch.apps.demo import unity_udp as udp
from absolutetrack_tpu_torch.geometry import camera as cam
from absolutetrack_tpu_torch.models.config import ModelConfig
from absolutetrack_tpu_torch.models.params import load_jax_params
from absolutetrack_tpu_torch.models.umetrack import UmeTrackModel
from absolutetrack_tpu_torch.ops import warp_kernel
from absolutetrack_tpu_torch.tracker import crop_gen
from absolutetrack_tpu_torch.tracker.tracker import TrackerConfig
from absolutetrack_tpu_torch.tracker.video_data import labels_from_json

jax.config.update("jax_platforms", "cpu")

CFG = ModelConfig.tiny()
JCFG = JConfig.tiny()
N_FRAMES = 4


@pytest.fixture(scope="module")
def scene():
    return chip_smoke.build_scene(seed=4, n_frames=N_FRAMES, mesh=True)


@pytest.fixture(scope="module")
def labels_path(scene, tmp_path_factory):
    path = tmp_path_factory.mktemp("replay") / "recording.json"
    path.write_text(json.dumps(chip_smoke.labels_json(scene)))
    return str(path)


def _jcams(cams: cam.Camera) -> jcam.Camera:
    return jcam.Camera(*(jnp.asarray(x.numpy()) for x in cams))


def _scene_cameras(scene):
    """Frame 0's four source cameras, both packages."""
    labels = labels_from_json(chip_smoke.labels_json(scene))
    tc = labels.cameras_at(0)
    return _jcams(tc), tc


def _window_points(tc, rng, n=40):
    """(V, n, 2) window points over each view, the principal point first (on axis)."""
    w = np.stack([rng.uniform(0, 636, (tc.fx.shape[0], n)), rng.uniform(0, 480, (tc.fx.shape[0], n))], -1)
    w[:, 0, 0], w[:, 0, 1] = tc.cx.numpy(), tc.cy.numpy()
    return w.astype(np.float32)


class TestInverseCamera:
    @pytest.mark.parametrize("kind", [cam.FISHEYE62, cam.PINHOLE])
    def test_unproject(self, kind):
        rng = np.random.default_rng(0)
        p = rng.uniform(-1.2, 1.2, (3, 50, 2)).astype(np.float32)
        p[0, 0] = 0.0  # on axis: sinc(0) = 1
        want, got = jcam.unproject(jnp.asarray(p), kind), cam.unproject(torch.from_numpy(p), kind)
        np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=1e-5)
        np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-6)
        assert got[0, 0].tolist() == [0.0, 0.0, 1.0]

    def test_undistort_and_window_to_eye(self, scene):
        jc, tc = _scene_cameras(scene)
        w = _window_points(tc, np.random.default_rng(1))
        q = (w - np.stack([tc.cx, tc.cy], -1)[:, None]) / np.stack([tc.fx, tc.fy], -1)[:, None]
        want = jcam.undistort(jc.coeffs[:, None], jnp.asarray(q))
        got = cam.undistort(tc.coeffs[:, None], torch.from_numpy(q))
        np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=1e-5)
        want = np.asarray(jcam.window_to_eye(jc, jnp.asarray(w), jcam.FISHEYE62))
        got = cam.window_to_eye(tc, torch.from_numpy(w), cam.FISHEYE62)
        np.testing.assert_allclose(want, got.numpy(), atol=1e-5)
        np.testing.assert_allclose(got[:, 0].numpy(), np.tile([0.0, 0.0, 1.0], (4, 1)), atol=1e-7)
        # the inverse of the forward chain, to the radial-only undistortion's accuracy
        back = cam.eye_to_window(tc, got, cam.FISHEYE62)
        assert float((back - torch.from_numpy(w)).abs().max()) < 0.5

    def test_window_to_eye_broadcasts_hands(self):
        """(H, V, 21, 2) keypoints against a (V,) rig, as the 2D path calls it."""
        jr, tr = jrig.build_stereo_cameras(), rig.build_stereo_cameras()
        kp = np.random.default_rng(2).uniform(100, 400, (2, 2, 21, 2)).astype(np.float32)
        want = jcam.window_to_eye(jr, jnp.asarray(kp), jcam.FISHEYE62)
        got = cam.window_to_eye(tr, torch.from_numpy(kp), cam.FISHEYE62)
        assert got.shape == (2, 2, 21, 3)
        np.testing.assert_allclose(np.asarray(want), got.numpy(), atol=1e-5)

    def test_crop(self, scene):
        jc, tc = _scene_cameras(scene)
        t = torch.eye(4).expand(4, 4, 4)
        want = jcam.crop(jc, 100.0, 50.0, 320, 240, scale=0.5, T_world_from_eye=jnp.asarray(t.numpy()))
        got = cam.crop(tc, 100.0, 50.0, 320, 240, scale=0.5, T_world_from_eye=t)
        for a, b in zip(want, got):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-5)
        assert got.width.tolist() == [320.0] * 4 and torch.equal(got.coeffs, tc.coeffs)
        assert torch.equal(cam.crop(tc, 0, 0, 636, 480).T_world_from_eye, tc.T_world_from_eye)


def _compare_slots(j, t, focal_rtol=1e-5):
    np.testing.assert_array_equal(np.asarray(j.view_idx), t.view_idx.numpy())
    np.testing.assert_array_equal(np.asarray(j.view_valid), t.view_valid.numpy())
    np.testing.assert_array_equal(np.asarray(j.hand_valid), t.hand_valid.numpy())
    np.testing.assert_allclose(np.asarray(j.cameras.T_world_to_eye), t.cameras.T_world_to_eye.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.asarray(j.cameras.fx_fy), t.cameras.fx_fy.numpy(), atol=1e-3, rtol=focal_rtol)
    np.testing.assert_allclose(np.asarray(j.cameras.cx_cy), t.cameras.cx_cy.numpy(), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(j.cameras.valid), t.cameras.valid.numpy())
    # the right hand's crop cameras mirror: determinant -1
    det_r = np.linalg.det(t.cameras.T_world_to_eye.numpy()[..., :3, :3])
    np.testing.assert_allclose(det_r[0], 1.0, atol=1e-4)
    np.testing.assert_allclose(det_r[1], -1.0, atol=1e-4)


class TestCropSlotsFrom2d:
    def test_on_the_stereo_rig(self):
        rng = np.random.default_rng(0)
        kp = np.zeros((2, 2, 21, 2), np.float32)
        kp[..., 0] = 320 + rng.uniform(-60, 60, (2, 2, 21))
        kp[..., 1] = 240 + rng.uniform(-60, 60, (2, 2, 21))
        valid = np.array([[True, True], [True, False]])
        j = jcg.gen_crop_slots_from_2d(jrig.build_stereo_cameras(), jnp.asarray(kp), jnp.asarray(valid), (96, 96))
        t = crop_gen.gen_crop_slots_from_2d(rig.build_stereo_cameras(), torch.from_numpy(kp), torch.from_numpy(valid), (96, 96))
        _compare_slots(j, t)
        assert t.hand_valid.tolist() == [True, True] and t.view_valid.tolist() == [[True, True], [True, False]]

    def test_on_views_1_2_of_the_scene(self, scene):
        """Here the crop axes lie within a few degrees of the sources' axes,
        where the look-at's ``1 - cos`` cancels in f32: both packages' focal
        lengths land ~1.8e-5 (relative) from a float64 evaluation of the
        same f32 inputs, so they are held to each other at 3e-5, and the
        port to float64 no worse than JAX is."""
        labels = labels_from_json(chip_smoke.labels_json(scene))
        frames, detector = demo_main.replay_from_labels(labels, 1)
        kp, valid = det.keypoints_to_slots([detector.detect(None, v) for v in range(2)])
        valid[0, 0] = False  # hand 0 undetected in its anchor view: dropped
        stereo = labels.cameras_at(0).map(lambda x: x[1:3])
        j = jcg.gen_crop_slots_from_2d(_jcams(stereo), jnp.asarray(kp), jnp.asarray(valid), (96, 96))
        t = crop_gen.gen_crop_slots_from_2d(stereo, torch.from_numpy(kp), torch.from_numpy(valid), (96, 96))
        _compare_slots(j, t, focal_rtol=3e-5)
        assert t.hand_valid.tolist() == [False, True] and not t.view_valid[0].any()
        f64 = crop_gen.gen_crop_slots_from_2d(
            stereo.map(lambda x: x.double()), torch.from_numpy(kp).double(), torch.from_numpy(valid), (96, 96)
        ).cameras
        port_err = float((t.cameras.fx_fy.double() - f64.fx_fy).abs().max())
        jax_err = float((torch.from_numpy(np.array(j.cameras.fx_fy)).double() - f64.fx_fy).abs().max())
        assert port_err <= 1.5 * jax_err + 1e-4, (port_err, jax_err)

    def test_needs_two_views(self):
        with pytest.raises(ValueError, match="2 views"):
            crop_gen.gen_crop_slots_from_2d(
                rig.build_stereo_cameras(), torch.zeros((2, 3, 21, 2)), torch.ones((2, 3), dtype=torch.bool), (96, 96)
            )


@pytest.fixture(scope="module")
def twin():
    params = jum.init_umetrack_params(jax.random.PRNGKey(3), JCFG)
    for reg in ("regressor_k", "regressor_u"):
        params[reg]["out"] = jax.tree.map(lambda x: x * 0.02, params[reg]["out"])
    params["temporal"] = jax.tree.map(lambda x: x * 0.1, params["temporal"])
    return params, load_jax_params(jax.tree.map(np.asarray, params), CFG, device="cpu")


def _replay_inputs(scene):
    """The port's replay of the scene, stereo pair: (labels, stereo cameras,
    per frame (mono uint8, keypoints, validity)), with hand 1 undetected in
    view 1 on frame 1 and hand 0 undetected in view 0 on frame 2."""
    labels = labels_from_json(chip_smoke.labels_json(scene))
    frames, detector = demo_main.replay_from_labels(labels, N_FRAMES)
    inputs = []
    for t, (mono, rgb) in enumerate(demo_main.stereo_pair(frames)):
        kp, valid = det.keypoints_to_slots([detector.detect(rgb[v], v) for v in range(2)])
        detector.advance()
        if t == 1:
            valid[1, 1] = False
        if t == 2:
            valid[0, 0] = False
        inputs.append((mono, kp, valid))
    return labels, labels.cameras_at(0).map(lambda x: x[1:3]), inputs


def test_live_tracker_matches_jax(scene, twin):
    """``LiveTracker`` (and through it ``track_frame_from_2d``) frame by frame
    against JAX's ``LiveTracker``, the same frames and keypoints."""
    params, model = twin
    labels, stereo, inputs = _replay_inputs(scene)
    jl = jpipe.LiveTracker(
        jum.UmeTrackModel(params, JCFG), jhand(chip_smoke.labels_json(scene)["hand_model"]),
        cameras=_jcams(stereo), opts=jtr.TrackerConfig(crop_size=JCFG.input_size),
    )
    tl = pipe.LiveTracker(model, labels.hand_model, cameras=stereo, opts=TrackerConfig(crop_size=CFG.input_size))
    before = warp_kernel.K1.launches
    views = []
    for mono, kp, valid in inputs:
        want, got = jl(mono, kp, valid), tl(mono, kp, valid)
        assert sorted(want) == sorted(got)
        for h in want:
            err = np.linalg.norm(want[h] - got[h], axis=-1).max()
            assert err < 0.5, f"hand {h}: {err} mm"
        views.append(tl.last_result.num_views.tolist())
    assert views == [[2, 2], [2, 1], [0, 2], [2, 2]]
    assert warp_kernel.K1.launches == before  # the CPU takes the plain sampler
    # reset restarts the memory: the first frame again gives the first result
    tl.reset()
    first = tl(*inputs[0])
    jl.reset()
    want = jl(*inputs[0])
    for h in want:
        assert np.linalg.norm(want[h] - first[h], axis=-1).max() < 0.5
    # the views' reprojection of the tracked landmarks
    proj, jproj = tl.project_to_views(first), jl.project_to_views(want)
    for v in range(2):
        for h in want:
            np.testing.assert_allclose(jproj[v][h], proj[v][h], atol=0.05)
    assert tl.project_to_views({}) == {0: {}, 1: {}}


class TestHostParts:
    def test_encode_packet_matches_jax(self):
        rng = np.random.default_rng(5)
        kp = {0: rng.uniform(-400, 400, (21, 3)), 1: rng.uniform(-400, 400, (21, 3))}
        assert udp.encode_packet(kp) == judp.encode_packet(kp)
        hand0 = eval(udp.encode_packet({0: np.array([[1.4, 2.6, 3.0]] * 21), 1: kp[1]}).decode().split(";")[1])
        assert hand0[:3] == [1, -2, 3]

    def test_unity_sender_needs_both_hands(self):
        s = udp.UnitySender(("127.0.0.1", 59998))
        try:
            assert not s.send({0: np.zeros((21, 3))})
            assert s.send({0: np.zeros((21, 3)), 1: np.zeros((21, 3))})
        finally:
            s.close()

    def test_keypoints_to_slots_matches_jax(self):
        per_view = [{0: np.ones((21, 2)), 1: 2 * np.ones((21, 3))}, {1: 3 * np.ones((21, 2)), 5: np.ones((21, 2))}]
        for a, b in zip(jdet.keypoints_to_slots(per_view), det.keypoints_to_slots(per_view)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    def test_replay_detector_matches_jax(self, labels_path):
        """The replay's GT 2D keypoints (views 1-2) and the detector's stepping."""
        _, _, jd = jmain.build_replay(labels_path, 3)
        labels, frames, td = demo_main.build_replay(labels_path, 3)
        assert len(td.sequence) == len(jd.sequence) == 3
        for t in range(4):  # past the end, the last frame repeats
            for v in range(2):
                a, b = jd.detect(None, v), td.detect(None, v)
                assert sorted(a) == sorted(b) == [0, 1]
                for h in a:
                    assert b[h].dtype == np.float32
                    np.testing.assert_allclose(a[h], b[h], atol=1e-3)
            jd.advance()
            td.advance()
        mono, rgb = next(frames)
        assert mono.shape == (4,) + chip_smoke.SRC_HW and mono.dtype == np.uint8
        assert rgb.shape == mono.shape + (3,) and np.array_equal(rgb[..., 1], mono)

    def test_build_stereo_cameras_bit_equal(self):
        for a, b in zip(jrig.build_stereo_cameras(), rig.build_stereo_cameras()):
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(np.asarray(a), b.numpy())

    def test_mediapipe_detector_needs_mediapipe(self):
        try:
            import mediapipe  # noqa: F401
        except ImportError:
            with pytest.raises(ImportError):
                det.MediaPipeDetector(2)
        else:
            pytest.skip("mediapipe is installed")


def test_cli_replay_on_the_cpu(labels_path):
    """``main([... --source replay ... --torch-device cpu --no-udp])`` at the
    full ``ModelConfig`` width: one line a frame, both hands tracked, the
    bf16 row switch left as it was (the serving model's tracker picks its
    rows itself)."""
    for precision in ("serving", "parity"):
        out = io.StringIO()
        with redirect_stdout(out):
            demo_main.main([
                "--source", "replay", "--labels", labels_path, "--max-frames", "2",
                "--torch-device", "cpu", "--no-udp", "--precision", precision,
            ])
        lines = out.getvalue().splitlines()
        assert [line.split(":")[0] for line in lines] == ["frame 0", "frame 1"], lines
        assert all("hands=[0, 1]" in line for line in lines)
        assert warp_kernel.set_bf16_rows(False) is False
    with pytest.raises(SystemExit):
        demo_main.main(["--source", "replay", "--torch-device", "cpu"])  # no --labels


def test_chip_smoke_demo_on_the_cpu():
    """The demo phase's replay at tiny width on the CPU: the script's
    inputs, parity and serving (its tracker samples with bf16 rows)
    ``LiveTracker`` runs, serving against parity within the relative
    budget, the serving stages against a CPU copy (every conv and the tail
    equal; a conv rounded once differs), no K1 launch."""
    labels, stereo, sequence, inputs = chip_smoke.demo_inputs(0, 6)
    assert len(inputs) == 6 and len(sequence) == 6
    mono, rgb, kp, valid = inputs[0]
    assert mono.shape == (2,) + chip_smoke.SRC_HW and mono.dtype == np.uint8 and valid.all()
    parity = chip_smoke.damped(chip_smoke.with_biases(UmeTrackModel(CFG, device="cpu", generator=torch.Generator().manual_seed(0)), 0))
    serving = UmeTrackModel(ModelConfig.tiny(compute_dtype="bfloat16"), device="cpu", generator=torch.Generator().manual_seed(0))
    serving.load_state_dict(parity.state_dict())
    opts = TrackerConfig(crop_size=CFG.input_size)
    before = warp_kernel.K1.launches
    runs = {}
    for name, net in (("parity", parity), ("serving", serving)):
        live = pipe.LiveTracker(net, labels.hand_model, cameras=stereo, opts=opts)
        _, outs, results = chip_smoke._demo_steps(live, inputs)
        assert all(sorted(o) == [0, 1] for o in outs)
        runs[name] = results
    stages = chip_smoke.serving_stages(serving, copy.deepcopy(serving), parity, live, inputs[0])
    assert stages["convs"] > 0 and stages["conv_min_bit_equal_share"] == 1.0
    assert stages["tail_wrist_max_err_mm"] == 0.0 and stages["tail_joint_angle_max_err"] == 0.0
    assert stages["rounded_once_conv_min_bit_equal_share"] < chip_smoke.SERVING_CONV_BIT_EQUAL
    t32 = torch.stack([r.wrist_xfs[:, :3, 3] for r in runs["parity"]])
    t16 = torch.stack([r.wrist_xfs[:, :3, 3] for r in runs["serving"]])
    assert float((t32 - t16).abs().max()) < chip_smoke.SERVING_TRANSLATION_REL * float(t32.abs().max())
    a32 = torch.stack([r.joint_angles for r in runs["parity"]])
    a16 = torch.stack([r.joint_angles for r in runs["serving"]])
    assert float((a32 - a16).abs().max()) < chip_smoke.SERVING_ANGLE_REL * max(float(a32.abs().max()), 1.0)
    assert not torch.equal(t32, t16)
    assert warp_kernel.K1.launches == before
