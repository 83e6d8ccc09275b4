"""Port parity: the pipelined eval chunk (``track_chunk_eval``, ``track_chunk_eval_batched``).

R = 2 distinct recordings (``test_torch_batched.recordings_at``: each
starts at its own frame with its own hand model and focal lengths,
recording 1's camera 0 turned away, recording 0's left hand gated at step
1), F = 3 frames a chunk, two chunks with the state carried, at
``ModelConfig.tiny()`` on the CPU. Phase A is recording-major and the tail
time-major, so distinct recordings catch a transposition between them.
JAX's result does not depend on the image layout, so one JAX run per
branch serves both of the port's ``images_rec_major`` values.

Tolerances as ``tests/test_torch_tracker.py``: joint angles 2e-4 rad,
wrist rotations 5e-4, landmarks 0.5 mm; predicted scales 1e-4; validity
and view counts exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from absolutetrack_tpu.models import umetrack as jum
from absolutetrack_tpu.models.config import ModelConfig as JConfig
from absolutetrack_tpu.tracker import pipelined as jpipe, tracker as jtr
from absolutetrack_tpu.tracker.batched import BatchedTracker as JBatchedTracker
from absolutetrack_tpu_torch.kinematics.skinning import landmarks_from_hand_pose
from absolutetrack_tpu_torch.models.config import ModelConfig
from absolutetrack_tpu_torch.models.params import load_jax_params
from absolutetrack_tpu_torch.tracker import pipelined
from absolutetrack_tpu_torch.tracker.batched import BatchedTracker
from absolutetrack_tpu_torch.tracker.tracker import HandTracker, TrackerConfig
from test_torch_batched import recordings_at, to_jax, to_port, twin_params

jax.config.update("jax_platforms", "cpu")

CFG = ModelConfig.tiny()
JCFG = JConfig.tiny()
R = 2
F = 3
N_CHUNKS = 2
PER_RECORDING = ("cams", "angles", "hand")  # (R, ...); the rest is per step


@pytest.fixture(scope="module")
def scene():
    return chip_smoke.build_scene(seed=4, n_frames=R + F * N_CHUNKS)


@pytest.fixture(scope="module")
def twin():
    """(JAX model, port model) with the same weights."""
    params = twin_params(4)
    return jum.UmeTrackModel(params, JCFG), load_jax_params(jax.tree.map(np.asarray, params), CFG, device="cpu")


def _opts():
    return TrackerConfig(crop_size=CFG.input_size, src_valid_hw=chip_smoke.SRC_HW)


def _jopts():
    return jtr.TrackerConfig(crop_size=JCFG.input_size, src_valid_hw=chip_smoke.SRC_HW)


def chunk(scene, c: int, r: int = R):
    """Chunk ``c`` as (inputs, camera_to_world_seq): per-step inputs stacked
    time-major (F, R, ...); cameras, angles and hand models once (R, ...)."""
    steps = [recordings_at(scene, c * F + t, r) for t in range(F)]
    out = dict(steps[0])
    for k in ("ja", "wrist", "conf", "images"):
        out[k] = np.stack([s[k] for s in steps])
    return out, np.stack([s["c2w"] for s in steps])


def _jax_chunks(scene, model, calibrate_scale):
    fn = jax.jit(functools.partial(jpipe.track_chunk_eval_batched, model, _jopts(), calibrate_scale=calibrate_scale))
    state = JBatchedTracker(model, _jopts()).init_state(R)
    outs = []
    for c in range(N_CHUNKS):
        d, c2w = chunk(scene, c)
        j = to_jax(d)
        state, res = fn(state, j["images"], j["cams"], jnp.asarray(c2w), j["angles"], j["hand"], j["ja"], j["wrist"], j["conf"])
        outs.append(jax.tree.map(np.asarray, res))
    return jax.tree.map(lambda *xs: np.concatenate(xs), *outs)


def _port_chunks(scene, model, calibrate_scale, rec_major):
    state = BatchedTracker(model, _opts()).init_state(R)
    outs = []
    for c in range(N_CHUNKS):
        d, c2w = chunk(scene, c)
        p = to_port(d)
        images = p["images"].transpose(0, 1).contiguous() if rec_major else p["images"]
        state, res = pipelined.track_chunk_eval_batched(
            model, _opts(), state, images, p["cams"], torch.from_numpy(c2w), p["angles"], p["hand"],
            p["ja"], p["wrist"], p["conf"], calibrate_scale=calibrate_scale, images_rec_major=rec_major,
        )
        outs.append(res)
    return type(outs[0])(*(None if x[0] is None else torch.cat(x) for x in zip(*outs)))


def _landmarks(hand, ja, wrist):
    """(T, R, 2, 21, 3) landmarks with each recording's own hand model (port FK)."""
    per_hand = hand.map(lambda x: x[:, None].expand((x.shape[0], 2) + x.shape[1:]))
    return landmarks_from_hand_pose(per_hand, torch.as_tensor(ja), torch.as_tensor(wrist), torch.arange(2)).numpy()


def _compare(scene, j, t):
    """JAX and port results of the same (T, R, 2, ...) chunks."""
    valid = j.hand_valid
    np.testing.assert_array_equal(valid, t.hand_valid.numpy())
    np.testing.assert_array_equal(j.num_views, t.num_views.numpy())
    assert valid.any() and not valid.all()
    np.testing.assert_allclose(j.joint_angles[valid], t.joint_angles.numpy()[valid], atol=2e-4)
    np.testing.assert_allclose(j.wrist_xfs[valid][:, :3, :3], t.wrist_xfs.numpy()[valid][:, :3, :3], atol=5e-4)
    hand = to_port(recordings_at(scene, 0, R))["hand"]
    err = np.linalg.norm(_landmarks(hand, j.joint_angles, j.wrist_xfs) - _landmarks(hand, t.joint_angles, t.wrist_xfs), axis=-1)
    assert err[valid].max() < 0.5, f"landmarks differ by {err[valid].max():.4f} mm"
    if j.predicted_scales is None:
        assert t.predicted_scales is None
    else:
        np.testing.assert_allclose(j.predicted_scales[valid], t.predicted_scales.numpy()[valid], atol=1e-4)


@pytest.fixture(scope="module")
def jax_known(scene, twin):
    return _jax_chunks(scene, twin[0], calibrate_scale=False)


class TestTrackChunkEvalBatched:
    @pytest.mark.parametrize("rec_major", [False, True])
    def test_matches_jax(self, scene, twin, jax_known, rec_major):
        t = _port_chunks(scene, twin[1], False, rec_major)
        assert t.joint_angles.shape == (N_CHUNKS * F, R, 2, 22)
        _compare(scene, jax_known, t)

    def test_calibrate_scale_matches_jax(self, scene, twin):
        j = _jax_chunks(scene, twin[0], calibrate_scale=True)
        t = _port_chunks(scene, twin[1], True, True)
        assert t.predicted_scales.shape == (N_CHUNKS * F, R, 2)
        _compare(scene, j, t)

    def test_matches_lockstep_steps(self, scene, twin):
        """The pipelined chunks equal ``BatchedTracker.track_frames`` stepped
        frame by frame, the memory carried across both chunks."""
        model = twin[1]
        piped = _port_chunks(scene, model, False, True)
        bt = BatchedTracker(model, _opts())
        state = bt.init_state(R)
        for s in range(N_CHUNKS * F):
            p = to_port(recordings_at(scene, s, R))
            state, res = bt.track_frames(state, p["images"], p["cams"], p["angles"], p["hand"], p["ja"], p["wrist"], p["conf"])
            assert torch.equal(res.hand_valid, piped.hand_valid[s])
            torch.testing.assert_close(res.joint_angles, piped.joint_angles[s], atol=2e-5, rtol=0)


def test_track_chunk_eval_matches_jax(scene, twin):
    """One recording: recording 0 of ``recordings_at``, gated left hand included."""
    jmodel, model = twin
    fn = jax.jit(functools.partial(jpipe.track_chunk_eval, jmodel, _jopts()))
    jstate = jtr.HandTracker(jmodel, _jopts()).init_state()
    tstate = HandTracker(model, _opts()).init_state()
    jres, tres = [], []
    for c in range(N_CHUNKS):
        d, c2w = chunk(scene, c, 1)
        one = {k: (v.map(lambda x: x[0]) if hasattr(v, "map") else v[0]) if k in PER_RECORDING else v[:, 0] for k, v in to_port(d).items()}
        jone = {k: jax.tree.map(lambda x: x[0], v) if k in PER_RECORDING else v[:, 0] for k, v in to_jax(d).items()}
        args = ("images", "cams", "c2w", "angles", "hand", "ja", "wrist", "conf")
        jone["c2w"], one["c2w"] = jnp.asarray(c2w[:, 0]), torch.from_numpy(c2w[:, 0])
        jstate, j = fn(jstate, *(jone[k] for k in args))
        tstate, t = pipelined.track_chunk_eval(model, _opts(), tstate, *(one[k] for k in args))
        assert t.joint_angles.shape == (F, 2, 22) and tstate.valid_history.shape == (2,)
        jres.append(j)
        tres.append(t)
    valid = np.concatenate([np.asarray(r.hand_valid) for r in jres])
    np.testing.assert_array_equal(valid, torch.cat([r.hand_valid for r in tres]).numpy())
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(r.num_views) for r in jres]), torch.cat([r.num_views for r in tres]).numpy()
    )
    assert not valid.all()
    ja = np.concatenate([np.asarray(r.joint_angles) for r in jres])
    np.testing.assert_allclose(ja[valid], torch.cat([r.joint_angles for r in tres]).numpy()[valid], atol=2e-4)
    wr = np.concatenate([np.asarray(r.wrist_xfs) for r in jres])
    np.testing.assert_allclose(wr[valid][:, :3, :3], torch.cat([r.wrist_xfs for r in tres]).numpy()[valid][:, :3, :3], atol=5e-4)
