"""Port parity: labels and the eval drivers (``apps/eval_lib.py``).

Two recordings cut from ``chip_smoke.build_scene`` and written as label
JSON in the reference's schema (``chip_smoke.labels_json``): recording 0 is
frames 0-4 with its left hand gated at frame 2, recording 1 is frames 2-4.
Both packages load the same files and track the same uint8 frames
(480x636, padded to 512x640 by ``_prepad_opts``) at ``ModelConfig.tiny()``
on the CPU, with ``chunk_size=3``, which divides neither length.

Tolerances as ``tests/test_torch_tracker.py``: tracked landmarks 0.5 mm,
joint angles 2e-4 rad, wrist rotations 5e-4; validity exact. Labels load
to the same float32 values; GT landmarks (FK of the labels) within 1e-3 mm.
"""

import json

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from absolutetrack_tpu.apps import eval_lib as jeval
from absolutetrack_tpu.models import umetrack as jum
from absolutetrack_tpu.tracker import video_data as jvd
from absolutetrack_tpu_torch.apps import eval_lib
from absolutetrack_tpu_torch.geometry import camera as cam
from absolutetrack_tpu_torch.models.config import ModelConfig
from absolutetrack_tpu_torch.models.params import load_jax_params
from absolutetrack_tpu_torch.models.umetrack import UmeTrackModel
from absolutetrack_tpu_torch.ops import warp_kernel
from absolutetrack_tpu_torch.parallel import Mesh, make_mesh
from absolutetrack_tpu_torch.tracker import video_data
from test_torch_batched import JCFG, twin_params

jax.config.update("jax_platforms", "cpu")

CFG = ModelConfig.tiny()
CHUNK = 3
CUTS = ((0, 5), (2, 3))  # (start, length) of each recording


@pytest.fixture(scope="module")
def scene():
    return chip_smoke.build_scene(seed=6, n_frames=5)


@pytest.fixture(scope="module")
def label_files(scene, tmp_path_factory):
    paths = []
    for i, (start, length) in enumerate(CUTS):
        d = chip_smoke.labels_json(scene, start, length)
        if i == 0:
            d["hand_confidences"][2][0] = 0.2
        path = tmp_path_factory.mktemp("labels") / f"recording_{i:02d}.json"
        path.write_text(json.dumps(d))
        paths.append(str(path))
    return paths


@pytest.fixture(scope="module")
def recordings(scene, label_files):
    """[(JAX labels, port labels, frames)] per recording."""
    return [
        (jvd.load_labels(p), video_data.load_labels(p), list(scene["frames"][s : s + n]))
        for p, (s, n) in zip(label_files, CUTS)
    ]


@pytest.fixture(scope="module")
def twin():
    params = twin_params(6)
    return jum.UmeTrackModel(params, JCFG), load_jax_params(jax.tree.map(np.asarray, params), CFG, device="cpu")


def test_load_labels_matches_jax(recordings):
    for j, t, _ in recordings:
        assert t.camera_kind == j.camera_kind == cam.FISHEYE62
        assert len(t) == len(j) and t.num_views == j.num_views == chip_smoke.N_VIEWS
        for name in cam.Camera._fields:
            np.testing.assert_array_equal(np.asarray(getattr(j.cameras, name)), getattr(t.cameras, name).numpy())
        for name in j.hand_model._fields:
            a, b = getattr(j.hand_model, name), getattr(t.hand_model, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
        for name in ("camera_angles", "camera_to_world", "joint_angles", "wrist_transforms", "hand_confidences"):
            np.testing.assert_array_equal(getattr(j, name), getattr(t, name))
        np.testing.assert_array_equal(np.asarray(j.cameras_at(1).T_world_from_eye), t.cameras_at(1).T_world_from_eye.numpy())
        np.testing.assert_allclose(jvd.gt_landmark_sequence(j), video_data.gt_landmark_sequence(t), atol=1e-3)


def test_camera_from_json_pinhole_and_unknown_model():
    js = {"Camera": {"DistortionModel": "PinholePlane", "fx": 100.0, "fy": 101.0, "cx": 50.0, "cy": 40.0, "ImageSizeX": 101, "ImageSizeY": 81}}
    c, kind = cam.camera_from_json(js)
    assert kind == cam.PINHOLE and c.coeffs.tolist() == [0.0] * 8 and c.width.item() == 101.0
    assert torch.equal(c.T_world_from_eye, torch.eye(4))
    with pytest.raises(ValueError, match="DistortionModel"):
        cam.camera_from_json({"DistortionModel": "Orthographic"})


def _compare(j, t, n=None):
    """SequenceResults of the two packages (hands-major)."""
    valid = j.valid_tracking
    np.testing.assert_array_equal(valid, t.valid_tracking)
    assert valid.any() and not valid.all()
    assert t.tracked_keypoints.shape == j.tracked_keypoints.shape
    err = np.linalg.norm(j.tracked_keypoints - t.tracked_keypoints, axis=-1)[valid]
    assert err.max() < 0.5, f"landmarks differ by {err.max():.4f} mm"
    np.testing.assert_allclose(j.joint_angles[valid], t.joint_angles[valid], atol=2e-4)
    np.testing.assert_allclose(j.wrist_xfs[valid][:, :3, :3], t.wrist_xfs[valid][:, :3, :3], atol=5e-4)
    np.testing.assert_allclose(j.gt_keypoints, t.gt_keypoints, atol=1e-3)


@pytest.mark.parametrize("pipelined", [True, False])
def test_track_recording_matches_jax(recordings, twin, pipelined):
    jmodel, model = twin
    jlab, tlab, frames = recordings[0]
    j = jeval.track_recording(jmodel, jlab, frames, chunk_size=CHUNK, pipelined=pipelined)
    t = eval_lib.track_recording(model, tlab, frames, chunk_size=CHUNK, pipelined=pipelined)
    assert t.valid_tracking.shape == (2, 5) and t.predicted_scales is None
    assert not t.valid_tracking[0, 2]  # the gated frame
    _compare(j, t)


def test_track_recordings_batched_matches_jax(recordings, twin):
    """Unequal lengths (5 and 3 frames): the short one pads with
    zero-confidence frames and comes back trimmed."""
    jmodel, model = twin
    j = jeval.track_recordings_batched(jmodel, [(jl, fr) for jl, _, fr in recordings], chunk_size=CHUNK)
    t = eval_lib.track_recordings_batched(model, [(tl, fr) for _, tl, fr in recordings], chunk_size=CHUNK)
    assert [r.valid_tracking.shape for r in t] == [(2, 5), (2, 3)]
    _compare(j[0], t[0])
    np.testing.assert_array_equal(j[1].valid_tracking, t[1].valid_tracking)
    err = np.linalg.norm(j[1].tracked_keypoints - t[1].tracked_keypoints, axis=-1)[t[1].valid_tracking]
    assert err.max() < 0.5


@pytest.mark.parametrize("pipelined", [True, False])
def test_batched_equals_sequential_per_recording(recordings, twin, pipelined):
    """Lockstep results are each recording's own ``track_recording``."""
    _, model = twin
    batched = eval_lib.track_recordings_batched(
        model, [(tl, fr) for _, tl, fr in recordings], chunk_size=CHUNK, pipelined=pipelined
    )
    for (_, tlab, frames), b in zip(recordings, batched):
        s = eval_lib.track_recording(model, tlab, frames, chunk_size=CHUNK, pipelined=False)
        np.testing.assert_array_equal(s.valid_tracking, b.valid_tracking)
        err = np.linalg.norm(s.tracked_keypoints - b.tracked_keypoints, axis=-1)[s.valid_tracking]
        assert err.max() < 0.5
        np.testing.assert_allclose(s.joint_angles[s.valid_tracking], b.joint_angles[s.valid_tracking], atol=2e-4)


def test_calibrate_scale_pipelined_equals_per_frame(recordings, twin):
    """The unknown-skeleton branch: the pipelined chunk (held against JAX in
    ``tests/test_torch_pipelined.py``) against ``HandTracker``'s per-frame step."""
    _, model = twin
    _, tlab, frames = recordings[0]
    a, b = (
        eval_lib.track_recording(model, tlab, frames, chunk_size=CHUNK, calibrate_scale=True, pipelined=p)
        for p in (True, False)
    )
    assert a.predicted_scales.shape == (2, 5)
    np.testing.assert_array_equal(a.valid_tracking, b.valid_tracking)
    v = a.valid_tracking
    np.testing.assert_allclose(a.predicted_scales[v], b.predicted_scales[v], atol=1e-4)
    np.testing.assert_allclose(a.tracked_keypoints[v], b.tracked_keypoints[v], atol=0.5)


def test_pad_frames():
    frames = np.ones((2, 4, 6), np.uint8)
    out = eval_lib._pad_frames(frames, (8, 8))
    assert out.shape == (2, 8, 8) and out[:, :4, :6].all() and not out[:, 4:].any() and not out[:, :, 6:].any()
    assert eval_lib._pad_frames(frames, None) is frames
    with pytest.raises(ValueError, match="exceed the label cameras"):
        eval_lib._pad_frames(np.ones((2, 9, 6), np.uint8), (8, 8))


def _dirty_empty(monkeypatch):
    """``torch.empty`` handing out blocks of 0xFF bytes, as a cached host
    block comes back with an earlier call's bytes."""
    real = torch.empty

    def empty(*a, **kw):
        out = real(*a, **kw)
        out.view(torch.uint8).fill_(255)
        return out

    monkeypatch.setattr(torch, "empty", empty)


@pytest.mark.parametrize("pipelined", [True, False])
@pytest.mark.parametrize("dtype,pad_hw", [(np.uint8, (8, 8)), (np.float32, (8, 8)), (np.uint8, None)])
def test_frame_staging_equals_the_stacked_padded_chunk(monkeypatch, pipelined, dtype, pad_hw):
    """Each staged chunk is ``_pad_frames(np.stack(...))`` of the chunk's
    frames bit for bit, in either layout, from a buffer whose bytes were
    0xFF: recordings of 5 and 3 frames (last-frame repeats), one that
    yields no frame (zeros of the frames' dtype), one whose source ends
    after 3 of its 4 labelled frames. The upload is a copy, not a view."""
    _dirty_empty(monkeypatch)
    rng = np.random.default_rng(0)
    shape = (2, 5, 6) if pad_hw else (2, 8, 8)
    sources = [rng.integers(1, 255, (k,) + shape).astype(dtype) for k in (5, 3, 0, 3)]
    lengths, chunk = [5, 3, 5, 4], 2
    staging = eval_lib._FrameStaging([iter(s) for s in sources], chunk, pipelined, pad_hw, shape, "cpu")
    last = [None] * len(sources)
    uploaded = None
    for t in range(0, 5, chunk):
        n = min(chunk, 5 - t)
        live, waited = staging.fill(t, n, lengths)
        if uploaded is not None:
            np.testing.assert_array_equal(uploaded.numpy(), expect)  # the last chunk's upload kept its frames
        recs = []
        for ri, src in enumerate(sources):
            frames = list(src[t : min(t + n, lengths[ri], len(src))])
            assert live[ri] == len(frames)
            if frames:
                last[ri] = frames[-1]
            elif last[ri] is None:
                last[ri] = np.zeros(shape, dtype)
            recs.append(np.stack(frames + [last[ri]] * (chunk - len(frames))))
        stacked = np.stack(recs)
        expect = eval_lib._pad_frames(stacked if pipelined else np.moveaxis(stacked, 0, 1), pad_hw)
        assert waited == 0 and staging.host.dtype == dtype and staging.host.shape == expect.shape
        np.testing.assert_array_equal(staging.host, expect)
        uploaded = staging.upload()
        assert uploaded.data_ptr() != staging.buf.data_ptr() and not staging.pinned
    assert lengths == [5, 3, 0, 3]  # the sources that ended sooner cut their lengths


def test_frame_staging_refuses_what_it_cannot_stage():
    """A frame that does not cast safely to the first chunk's dtype, or of
    another shape than the first frame's, raises; so does a frame larger
    than the padded extent."""
    def staged(chunks, pad_hw=(8, 8)):
        staging = eval_lib._FrameStaging([iter(chunks)], 1, True, pad_hw, (2, 5, 6), "cpu")
        for t in range(len(chunks)):
            staging.fill(t, 1, [len(chunks)])

    u8 = np.ones((2, 5, 6), np.uint8)
    with pytest.raises(ValueError, match="float32 does not cast safely to the chunk's uint8"):
        staged([u8, u8.astype(np.float32)])
    with pytest.raises(ValueError, match="differs from the first frame's"):
        staged([u8, u8[:, :4]])
    with pytest.raises(ValueError, match="exceed the label cameras"):
        staged([np.ones((2, 9, 6), np.uint8)])
    staged([u8.astype(np.float32), u8])  # uint8 casts safely to float32


def test_unported_options_raise(recordings, twin):
    """A mesh needs a process group of its size (``tests/test_torch_parallel.py``
    runs such worlds); the recordings must split over its data axis; a
    1 x 1 mesh tracks as no mesh does."""
    _, model = twin
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh(data=2, devices="cpu")
    one = [(recordings[0][1], recordings[0][2])]
    with pytest.raises(ValueError, match="do not split over a data axis of 2"):
        eval_lib.track_recordings_batched(model, one, mesh=Mesh(2, 1, 0, torch.device("cpu")))
    (meshed,) = eval_lib.track_recordings_batched(model, one, max_frames=2, mesh=make_mesh(devices="cpu"))
    (plain,) = eval_lib.track_recordings_batched(model, one, max_frames=2)
    for name, value in vars(plain).items():
        if value is not None:
            np.testing.assert_array_equal(getattr(meshed, name), value, err_msg=name)
    # a checkpoint is read now (tests/test_torch_checkpoint.py); a missing one is an error
    with pytest.raises(FileNotFoundError):
        eval_lib.build_model("weights.pt", CFG, device="cpu")
    built = eval_lib.build_model(cfg=CFG, seed=3, device="cpu")
    assert built.device.type == "cpu" and built.cfg == CFG


def test_chip_smoke_lockstep_on_the_cpu():
    """The lockstep that the script's lockstep phase drives, at tiny width
    on the CPU: its scene, its 24 recordings of 16 frames from distinct
    start frames and its chunking. Every hand stays valid, the stage hook
    names each stage once a chunk, each checked recording equals its own
    sequential run, and the plain sampler launches no K1."""
    r, n, chunk = chip_smoke.LOCKSTEP_RECORDINGS, chip_smoke.LOCKSTEP_FRAMES, chip_smoke.LOCKSTEP_CHUNK
    recs = chip_smoke.scene_recordings(chip_smoke.build_scene(1, n_frames=n + r - 1), range(r), n)
    model = chip_smoke.damped(UmeTrackModel(CFG, device="cpu", generator=torch.Generator().manual_seed(0)))
    before = warp_kernel.K1.launches
    stages = []
    res = eval_lib.track_recordings_batched(model, recs, chunk_size=chunk, stage_hook=stages.append)
    assert warp_kernel.K1.launches == before
    assert stages == ["assemble", "upload", "crop_slots", "warp_and_inputs", "trunk", "scan_tail", "fk"] * (n // chunk)
    assert len(res) == r and all(x.valid_tracking.all() and x.tracked_keypoints.shape == (2, n, 21, 3) for x in res)
    # recording 1 is recording 0 one frame later: distinct at each step, equal shifted
    assert not np.allclose(res[0].gt_keypoints, res[1].gt_keypoints)
    np.testing.assert_array_equal(res[0].gt_keypoints[:, 1:], res[1].gt_keypoints[:, :-1])
    for i in chip_smoke.SEQUENTIAL_CHECKED:
        alone = eval_lib.track_recording(model, *recs[i], chunk_size=chunk, pipelined=False)
        err = np.linalg.norm(alone.tracked_keypoints - res[i].tracked_keypoints, axis=-1)
        assert err.max() < chip_smoke.LANDMARK_TOL_MM
