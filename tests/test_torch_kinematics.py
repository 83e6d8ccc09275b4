"""Port parity: hand model, forward kinematics and crop slots against the JAX package.

Same numpy-seeded inputs through both, f32 on the CPU. The hand model and
the 4-camera fisheye62 rig come from ``chip_smoke.build_scene``. Tolerances:
1e-5 for rotations, 1e-3 mm for landmarks of ~100 mm hands, 1e-4 for
look-at transforms, 1e-3 px for crop focal lengths of ~180 px; discrete
slot decisions must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from absolutetrack_tpu.geometry import camera as jcam
from absolutetrack_tpu.kinematics import hand_model as jhm
from absolutetrack_tpu.kinematics import skinning as jsk
from absolutetrack_tpu.tracker import crop_gen as jcg
from absolutetrack_tpu_torch.kinematics import hand_model as hm
from absolutetrack_tpu_torch.kinematics import skinning as sk
from absolutetrack_tpu_torch.tracker import crop_gen as cg

jax.config.update("jax_platforms", "cpu")

N_FRAMES = 6


@pytest.fixture(scope="module")
def scene():
    return chip_smoke.build_scene(seed=3, n_frames=N_FRAMES)


@pytest.fixture(scope="module")
def hands(scene):
    return jhm.hand_model_from_dict(scene["hand_model"]), hm.hand_model_from_dict(scene["hand_model"])


def _close(j, t, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=atol, rtol=rtol)


def _random_pose(rng, n):
    ja = rng.uniform(-0.3, 1.2, (n, 22)).astype(np.float32)
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    q *= np.sign(np.linalg.det(q))[:, None, None]
    wrist = np.tile(np.eye(4), (n, 1, 1))
    wrist[:, :3, :3] = q
    wrist[:, :3, 3] = rng.uniform(-200, 200, (n, 3))
    return ja, wrist.astype(np.float32)


class TestHandModel:
    def test_fields_scaling_and_neutral_pose(self, hands):
        jh, th = hands
        for name in jhm.HandModel._fields:
            j, t = getattr(jh, name), getattr(th, name)
            assert (j is None) == (t is None), name
            if j is not None:
                np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)
        js, ts = jhm.scaled_hand_model(jh, 0.001), hm.scaled_hand_model(th, 0.001)
        _close(js.joint_rest_positions, ts.joint_rest_positions, 1e-7)
        _close(js.landmark_rest_positions, ts.landmark_rest_positions, 1e-7)
        _close(jhm.neutral_joint_angles(jh), hm.neutral_joint_angles(th), 1e-7)

    def test_landmark_skinning_matrix(self, hands):
        jh, th = hands
        m = hm.landmark_skinning_matrix(th)
        assert m.shape == (21, hm.NUM_JOINT_FRAMES)
        _close(jhm.landmark_skinning_matrix(jh), m, 0.0)


class TestSkinning:
    def test_so3_exp_including_small_angles(self):
        rng = np.random.default_rng(0)
        w = rng.standard_normal((40, 3)).astype(np.float32)
        w[:5] *= 1e-5  # the Taylor branch
        w[5] = 0.0
        _close(jsk.so3_exp(jnp.asarray(w)), sk.so3_exp(torch.from_numpy(w)), 1e-6)

    def test_skinning_transforms(self, hands):
        jh, th = hands
        ja, wrist = _random_pose(np.random.default_rng(1), 3)
        j = jsk.skinning_transforms(jh.joint_rotation_axes, jh.joint_rest_positions, ja, wrist)
        t = sk.skinning_transforms(
            th.joint_rotation_axes, th.joint_rest_positions,
            torch.from_numpy(ja), torch.from_numpy(wrist),
        )
        assert t.shape == (3, 17, 4, 4)
        _close(j, t, 1e-3, 1e-5)

    def test_landmarks_from_hand_pose_both_hands(self, hands):
        jh, th = hands
        ja, wrist = _random_pose(np.random.default_rng(2), 4)
        idx = np.array([0, 1, 0, 1])
        jb = jax.tree.map(lambda x: jnp.broadcast_to(x, (4,) + x.shape), jh)
        tb = th.map(lambda x: x.expand((4,) + x.shape))
        j = jsk.landmarks_from_hand_pose(jb, jnp.asarray(ja), jnp.asarray(wrist), jnp.asarray(idx))
        t = sk.landmarks_from_hand_pose(tb, torch.from_numpy(ja), torch.from_numpy(wrist), torch.from_numpy(idx))
        assert t.shape == (4, 21, 3)
        _close(j, t, 1e-3)
        _close(jsk.skin_landmarks(jh, ja[0], wrist[0]), sk.skin_landmarks(th, torch.from_numpy(ja[0]), torch.from_numpy(wrist[0])), 1e-3)


def _cameras(scene, t):
    c = scene["cameras"]
    f32 = {k: np.asarray(c[k], np.float32) for k in ("fx", "fy", "cx", "cy", "coeffs", "width", "height")}
    c2w = scene["camera_to_world"][t]
    j = jcam.Camera(**{k: jnp.asarray(v) for k, v in f32.items()}, T_world_from_eye=jnp.asarray(c2w))
    from absolutetrack_tpu_torch.geometry import camera as cam

    tc = cam.Camera(**{k: torch.from_numpy(v) for k, v in f32.items()}, T_world_from_eye=torch.from_numpy(c2w))
    return j, tc


class TestCropSlots:
    @pytest.mark.parametrize("num_crop_points, sort_camera_index", [(21, True), (63, True), (42, False)])
    def test_gen_crop_slots_over_frames(self, scene, hands, num_crop_points, sort_camera_index):
        jh, th = hands
        angles = scene["camera_angles"]
        for t in range(N_FRAMES):
            jc, tc = _cameras(scene, t)
            args = (scene["joint_angles"][t], scene["wrist_transforms"][t], scene["hand_confidences"][t])
            kw = dict(num_crop_points=num_crop_points, sort_camera_index=sort_camera_index)
            j = jcg.gen_crop_slots(jc, jnp.asarray(angles), jh, *map(jnp.asarray, args), (96, 96), **kw)
            s = cg.gen_crop_slots(tc, torch.from_numpy(angles), th, *map(torch.from_numpy, args), (96, 96), **kw)
            np.testing.assert_array_equal(np.asarray(j.hand_valid), s.hand_valid.numpy())
            np.testing.assert_array_equal(np.asarray(j.view_valid), s.view_valid.numpy())
            valid = s.view_valid.numpy()
            assert valid.all(), f"frame {t}: the scene keeps both hands in two views"
            np.testing.assert_array_equal(np.asarray(j.view_idx)[valid], s.view_idx.numpy()[valid])
            _close(j.cameras.T_world_to_eye, s.cameras.T_world_to_eye, 1e-4)
            _close(j.cameras.fx_fy, s.cameras.fx_fy, 1e-3)
            _close(j.cameras.cx_cy, s.cameras.cx_cy, 0.0)

    def test_selection_gates(self, scene, hands):
        """Low confidence drops a hand; min_num_crops beyond the eligible
        views drops it too; a hand behind the rig sees no camera."""
        jh, th = hands
        jc, tc = _cameras(scene, 0)
        ja = scene["joint_angles"][0]
        wrist = scene["wrist_transforms"][0].copy()
        wrist[1, :3, 3] = [0.0, 0.0, -400.0]  # behind every camera
        conf = np.array([0.3, 1.0], np.float32)
        angles = scene["camera_angles"]
        for min_crops in (1, 2, 3):
            j = jcg.gen_crop_slots(jc, jnp.asarray(angles), jh, jnp.asarray(ja), jnp.asarray(wrist), jnp.asarray(conf), (96, 96), min_num_crops=min_crops)
            s = cg.gen_crop_slots(tc, torch.from_numpy(angles), th, torch.from_numpy(ja), torch.from_numpy(wrist), torch.from_numpy(conf), (96, 96), min_num_crops=min_crops)
            np.testing.assert_array_equal(np.asarray(j.hand_valid), s.hand_valid.numpy())
            np.testing.assert_array_equal(np.asarray(j.view_valid), s.view_valid.numpy())
            assert not s.hand_valid.any()
        conf = np.ones(2, np.float32)
        j = jcg.gen_crop_slots(jc, jnp.asarray(angles), jh, jnp.asarray(ja), jnp.asarray(wrist), jnp.asarray(conf), (96, 96))
        s = cg.gen_crop_slots(tc, torch.from_numpy(angles), th, torch.from_numpy(ja), torch.from_numpy(wrist), torch.from_numpy(conf), (96, 96))
        assert s.hand_valid.tolist() == [True, False]
        np.testing.assert_array_equal(np.asarray(j.view_valid), s.view_valid.numpy())
