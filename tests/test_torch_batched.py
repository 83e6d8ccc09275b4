"""Port parity: batched crop slots and the lockstep step (``BatchedTracker``).

R = 3 recordings that differ in every input a sample carries: recording r
starts at frame r of ``chip_smoke.build_scene``, its hand model is scaled
by 0.92 + 0.08 r and its focal lengths by 1 + 0.01 r; recording 1's
camera 0 is turned away (its hands take views 1 and 2), recording 2's
right hand sits where only camera 3 sees it, and recording 0's left hand
drops below the confidence gate at frame 1. The same numpy inputs go to
JAX (``jax.vmap(gen_crop_slots)``, ``BatchedTracker.track_frames``) and to
the port on the CPU, at ``ModelConfig.tiny()`` with 32x32 crops.

Tolerances: validity and view counts exact, ``view_idx`` equal where a
slot is valid (``lax.top_k`` and the stable sort may order invalid slots
differently); crop cameras as ``tests/test_torch_geometry.py`` holds them
(T_world_to_eye 1e-4, focal 1e-3, centre 1e-5); tracker outputs as
``tests/test_torch_tracker.py``: joint angles 2e-4 rad, wrist rotations
5e-4, landmarks 0.5 mm.
"""

import functools
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from absolutetrack_tpu.geometry import camera as jcam
from absolutetrack_tpu.kinematics.hand_model import hand_model_from_dict as jhand
from absolutetrack_tpu.kinematics.skinning import landmarks_from_hand_pose as jlandmarks
from absolutetrack_tpu.models import umetrack as jum
from absolutetrack_tpu.models.config import ModelConfig as JConfig
from absolutetrack_tpu.models.regressor import output_dims, wrist_rigid_template
from absolutetrack_tpu.tracker import batched as jbatched, tracker as jtr
from absolutetrack_tpu.tracker.crop_gen import gen_crop_slots as jgen
from absolutetrack_tpu_torch.geometry import camera as cam
from absolutetrack_tpu_torch.kinematics.hand_model import hand_model_from_dict
from absolutetrack_tpu_torch.kinematics.skinning import landmarks_from_hand_pose
from absolutetrack_tpu_torch.models.config import ModelConfig
from absolutetrack_tpu_torch.models.params import load_jax_params
from absolutetrack_tpu_torch.tracker.batched import BatchedTracker
from absolutetrack_tpu_torch.tracker.crop_gen import gen_crop_slots
from absolutetrack_tpu_torch.tracker.tracker import HandTracker, TrackerConfig

jax.config.update("jax_platforms", "cpu")

CFG = ModelConfig.tiny()
JCFG = JConfig.tiny()
R = 3
N_STEPS = 2
CROP = CFG.input_size
CAM_FIELDS = ("fx", "fy", "cx", "cy", "coeffs", "width", "height")


@pytest.fixture(scope="module")
def scene():
    return chip_smoke.build_scene(seed=3, n_frames=R + N_STEPS)


def recordings_at(scene, t: int, r: int = R) -> dict:
    """numpy inputs of ``r`` distinct recordings at step ``t`` (see the module docstring)."""
    idx = np.arange(r) + t
    c = scene["cameras"]
    cams = {k: np.stack([np.asarray(c[k], np.float32)] * r) for k in CAM_FIELDS}
    cams["fx"] = cams["fx"] * (1 + 0.01 * np.arange(r))[:, None].astype(np.float32)
    c2w = scene["camera_to_world"][idx].copy()
    if r > 1:
        c2w[1, 0, :3, :3] = chip_smoke._rot_y(150) @ c2w[1, 0, :3, :3]
    wrist = scene["wrist_transforms"][idx].copy()
    if r > 2:
        wrist[2, 1, :3, 3] += [300.0, 0.0, -300.0]
    conf = scene["hand_confidences"][idx].copy()
    if t == 1:
        conf[0, 0] = 0.3
    scale = (0.92 + 0.08 * np.arange(r)).astype(np.float32)
    hand = {k: np.stack([np.asarray(v)] * r) for k, v in scene["hand_model"].items()}
    for k in ("joint_rest_positions", "landmark_rest_positions"):
        hand[k] = (hand[k] * scale[:, None, None]).astype(np.float32)
    return dict(
        cams=cams, c2w=c2w.astype(np.float32), angles=np.stack([scene["camera_angles"]] * r),
        hand=hand, ja=scene["joint_angles"][idx], wrist=wrist.astype(np.float32), conf=conf,
        images=chip_smoke.pad_frames(scene["frames"][idx]),
    )


def to_jax(d):
    return dict(
        cams=jcam.Camera(**{k: jnp.asarray(v) for k, v in d["cams"].items()}, T_world_from_eye=jnp.asarray(d["c2w"])),
        angles=jnp.asarray(d["angles"]), hand=jhand(d["hand"]),
        ja=jnp.asarray(d["ja"]), wrist=jnp.asarray(d["wrist"]), conf=jnp.asarray(d["conf"]),
        images=jnp.asarray(d["images"]),
    )


def to_port(d):
    return dict(
        cams=cam.Camera(**{k: torch.from_numpy(v) for k, v in d["cams"].items()}, T_world_from_eye=torch.from_numpy(d["c2w"])),
        angles=torch.from_numpy(d["angles"]), hand=hand_model_from_dict(d["hand"]),
        ja=torch.from_numpy(d["ja"]), wrist=torch.from_numpy(d["wrist"]), conf=torch.from_numpy(d["conf"]),
        images=torch.from_numpy(d["images"]),
    )


def _slot_args(x):
    return x["cams"], x["angles"], x["hand"], x["ja"], x["wrist"], x["conf"]


class TestBatchedCropSlots:
    @pytest.mark.parametrize("min_num_crops", [1, 2])
    def test_matches_jax_vmap(self, scene, min_num_crops):
        d = recordings_at(scene, 1)
        gen = functools.partial(jgen, crop_size=CROP, min_num_crops=min_num_crops)
        j = jax.jit(jax.vmap(gen))(*_slot_args(to_jax(d)))
        t = gen_crop_slots(*_slot_args(to_port(d)), CROP, min_num_crops=min_num_crops)
        valid = np.asarray(j.view_valid)
        np.testing.assert_array_equal(np.asarray(j.hand_valid), t.hand_valid.numpy())
        np.testing.assert_array_equal(valid, t.view_valid.numpy())
        np.testing.assert_array_equal(np.asarray(j.view_idx)[valid], t.view_idx.numpy()[valid])
        # the recordings differ: rec 0's left hand is gated, rec 1 looks through
        # views 1-2, rec 2's right hand has one view (none with min_num_crops=2)
        assert not valid[0, 0].any() and valid[0, 1].all()
        assert t.view_idx[1][t.view_valid[1]].tolist() == [1, 2, 1, 2]
        assert valid[2, 1].tolist() == ([True, False] if min_num_crops == 1 else [False, False])
        for field, atol, rtol in (("T_world_to_eye", 1e-4, 1e-5), ("fx_fy", 1e-3, 1e-5), ("cx_cy", 1e-5, 1e-5)):
            np.testing.assert_allclose(
                np.asarray(getattr(j.cameras, field))[valid], getattr(t.cameras, field).numpy()[valid],
                atol=atol, rtol=rtol,
            )

    def test_each_sample_equals_its_unbatched_call(self, scene):
        """The batch is a tensor axis: sample r of the batched call is the
        single-frame call on recording r's own cameras and hand model."""
        p = to_port(recordings_at(scene, 1))
        batched = gen_crop_slots(*_slot_args(p), CROP)
        for r in range(R):
            one = gen_crop_slots(*(a.map(lambda x: x[r]) if hasattr(a, "map") else a[r] for a in _slot_args(p)), CROP)
            for name in ("view_valid", "hand_valid"):
                assert torch.equal(getattr(batched, name)[r], getattr(one, name))
            v = one.view_valid
            assert torch.equal(batched.view_idx[r][v], one.view_idx[v])
            torch.testing.assert_close(batched.cameras.T_world_to_eye[r][v], one.cameras.T_world_to_eye[v])

    def test_no_per_sample_loop(self, scene):
        """The same aten ops, as many times each, at B=2 and at B=16."""

        def ops(b):
            p = to_port(recordings_at(scene, 0))
            args = [
                a.map(lambda x: x.repeat((b // R + 1,) + (1,) * (x.dim() - 1))[:b]) if hasattr(a, "map")
                else a.repeat((b // R + 1,) + (1,) * (a.dim() - 1))[:b]
                for a in _slot_args(p)
            ]
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                gen_crop_slots(*args, CROP)
            return Counter({e.key: e.count for e in prof.key_averages() if e.key.startswith("aten::")})

        small, large = ops(2), ops(16)
        assert sum(small.values()) > 100
        assert small == large


# -- BatchedTracker.track_frames ---------------------------------------------


def twin_params(seed: int) -> dict:
    """Damped random JAX params (as ``tests/test_torch_tracker.py``) whose
    unknown-skeleton head predicts, up to its damped random part, the wrist
    template: the damped head alone predicts wrist points ~1e-3 apart, where
    the Procrustes fit turns 1e-6 feature noise into 1e-3 rad, as a trained
    head would not."""
    params = jum.init_umetrack_params(jax.random.PRNGKey(seed), JCFG)
    for reg in ("regressor_k", "regressor_u"):
        params[reg]["out"] = jax.tree.map(lambda x: x * 0.02, params[reg]["out"])
    params["temporal"] = jax.tree.map(lambda x: x * 0.1, params["temporal"])
    r = output_dims(True, JCFG.n_wrist_rigid_pts)[0]["wrist_xfs"]
    bias = params["regressor_u"]["out"]["b"]
    params["regressor_u"]["out"]["b"] = bias.at[r[0]:r[1]].add(
        jnp.asarray(wrist_rigid_template(JCFG.n_wrist_rigid_pts).reshape(-1))
    )
    return params


@pytest.fixture(scope="module")
def twin():
    """(JAX params, port model) with the same weights."""
    params = twin_params(3)
    return params, load_jax_params(jax.tree.map(np.asarray, params), CFG, device="cpu")


def _opts():
    return TrackerConfig(crop_size=CROP, src_valid_hw=chip_smoke.SRC_HW)


def _fk(hand, ja, wrist, lm_fn, xp):
    """Landmarks of (R, 2) poses with each recording's own hand model."""
    per_hand = lambda x: xp.broadcast_to(x[:, None], (x.shape[0], 2) + x.shape[1:])  # noqa: E731
    return lm_fn(hand.map(per_hand) if hasattr(hand, "map") else jax.tree.map(per_hand, hand), ja, wrist, xp.arange(2))


@pytest.fixture(scope="module")
def lockstep_runs(scene, twin):
    """N_STEPS lockstep steps in JAX and in the port, carrying the state."""
    params, model = twin
    jbt = jbatched.BatchedTracker(jum.UmeTrackModel(params, JCFG), jtr.TrackerConfig(crop_size=JCFG.input_size, src_valid_hw=chip_smoke.SRC_HW))
    jstep = jax.jit(jbt.track_frames)
    bt = BatchedTracker(model, _opts())
    jstate, tstate = jbt.init_state(R), bt.init_state(R)
    outs = []
    for t in range(N_STEPS):
        d = recordings_at(scene, t)
        j, p = to_jax(d), to_port(d)
        jstate, jres = jstep(jstate, j["images"], *_slot_args(j))
        tstate, tres = bt.track_frames(tstate, p["images"], *_slot_args(p))
        jlm = _fk(j["hand"], jres.joint_angles, jres.wrist_xfs, jlandmarks, jnp)
        tlm = _fk(p["hand"], tres.joint_angles, tres.wrist_xfs, landmarks_from_hand_pose, torch)
        outs.append((jax.tree.map(np.asarray, jres), np.asarray(jlm), tres, tlm))
    return outs


def _compare(ja, wr, valid, views, lm, t):
    np.testing.assert_array_equal(valid, t.hand_valid.numpy())
    np.testing.assert_array_equal(views, t.num_views.numpy())
    np.testing.assert_allclose(ja[valid], t.joint_angles.numpy()[valid], atol=2e-4)
    np.testing.assert_allclose(wr[valid][:, :3, :3], t.wrist_xfs.numpy()[valid][:, :3, :3], atol=5e-4)
    err_mm = np.linalg.norm(lm - t.landmarks.numpy(), axis=-1)[valid]
    assert err_mm.max() < 0.5, f"landmarks differ by {err_mm.max():.4f} mm"


class _Res:
    def __init__(self, res, lm):
        self.joint_angles, self.wrist_xfs, self.hand_valid, self.num_views = res[:4]
        self.landmarks = lm


class TestBatchedTracker:
    def test_matches_jax(self, lockstep_runs):
        for jres, jlm, tres, tlm in lockstep_runs:
            assert tres.joint_angles.shape == (R, 2, 22) and tres.wrist_xfs.shape == (R, 2, 4, 4)
            assert tres.predicted_scales is None
            _compare(jres.joint_angles, jres.wrist_xfs, jres.hand_valid, jres.num_views, jlm, _Res(tres, tlm))
        assert not lockstep_runs[1][2].hand_valid[0, 0]  # the gated hand

    def test_matches_sequential_per_recording(self, scene, twin, lockstep_runs):
        """Each recording alone through the port's own ``HandTracker``."""
        _, model = twin
        tracker = HandTracker(model, _opts())
        for r in range(R):
            state = tracker.init_state()
            for t in range(N_STEPS):
                p = to_port(recordings_at(scene, t))
                one = [a.map(lambda x: x[r]) if hasattr(a, "map") else a[r] for a in _slot_args(p)]
                state, res = tracker.track_frame(state, p["images"][r], *one)
                b = lockstep_runs[t][2]
                hand_b = one[2].map(lambda x: x.expand((2,) + x.shape))
                lm = landmarks_from_hand_pose(hand_b, res.joint_angles, res.wrist_xfs, torch.arange(2))
                blm = lockstep_runs[t][3][r]
                valid = res.hand_valid.numpy()
                np.testing.assert_array_equal(valid, b.hand_valid[r].numpy())
                np.testing.assert_array_equal(res.num_views.numpy(), b.num_views[r].numpy())
                np.testing.assert_allclose(res.joint_angles.numpy()[valid], b.joint_angles[r].numpy()[valid], atol=2e-4)
                assert (lm - blm).norm(dim=-1)[torch.from_numpy(valid)].max() < 0.5

    def test_calibrate_scale_step(self, scene, twin):
        """The unknown-skeleton step needs two views and predicts a scale per hand."""
        _, model = twin
        bt = BatchedTracker(model, _opts())
        p = to_port(recordings_at(scene, 0))
        _, res = bt.track_frames_and_calibrate_scale(bt.init_state(R), p["images"], *_slot_args(p))
        assert res.predicted_scales.shape == (R, 2)
        assert not res.hand_valid[2, 1]  # one view only
        assert torch.isfinite(res.predicted_scales).all()
