"""Port parity: the mesh skinning, hand-model I/O and the frame sources.

The recording is ``chip_smoke.build_scene`` with its box-mesh hand
(``mesh=True``: one box for the palm and one a phalanx, one-hot bone
weights), written as a label JSON that both packages load. Tolerances:

* skinned mesh vertices: 1e-3 mm (the same f32 LBS blend, summed in
  another order);
* hand-model JSON, mirror, ``split_stacked_frame``: exact;
* ``SyntheticFrameSource``: 1e-2 on the 0..255 scale on >= 99.9% of pixels
  (the landmark projections differ by f32 ulps, which move a blob's
  Gaussian a little; a rounding flip of a blob's centre moves nothing, the
  blob is computed from the exact projection either way);
* ``MeshFrameSource``: projected vertices 1e-3 px; given the same
  projections, the raster is bit-equal (the same numpy code);
* ``VideoFrameSource``: bit-equal to JAX's decode of the same FFV1 file.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from absolutetrack_tpu.apps import eval_lib as jeval
from absolutetrack_tpu.kinematics import hand_model as jhm
from absolutetrack_tpu.kinematics import skinning as jsk
from absolutetrack_tpu.tracker import video_data as jvd
from absolutetrack_tpu_torch.apps import eval_lib
from absolutetrack_tpu_torch.kinematics import hand_model as hm
from absolutetrack_tpu_torch.kinematics import skinning as sk
from absolutetrack_tpu_torch.tracker import video_data as vd

jax.config.update("jax_platforms", "cpu")

N_FRAMES = 3


@pytest.fixture(scope="module")
def scene():
    return chip_smoke.build_scene(seed=3, n_frames=N_FRAMES, mesh=True)


@pytest.fixture(scope="module")
def labels_path(scene, tmp_path_factory):
    path = tmp_path_factory.mktemp("labels") / "recording.json"
    path.write_text(json.dumps(chip_smoke.labels_json(scene)))
    return str(path)


@pytest.fixture(scope="module")
def labels(labels_path):
    """(JAX labels, port labels) of the same JSON."""
    return jvd.load_labels(labels_path), vd.load_labels(labels_path)


class TestMeshSkinning:
    def test_skin_mesh_vertices_and_mesh_from_hand_pose(self, scene):
        hand = scene["hand_model"]
        jhand, thand = jhm.hand_model_from_dict(hand), hm.hand_model_from_dict(hand)
        ja, wr = scene["joint_angles"], scene["wrist_transforms"]  # (T, 2, ...)
        jb = jax.tree.map(lambda x: jnp.broadcast_to(x, (N_FRAMES, 2) + x.shape), jhand)
        tb = thand.map(lambda x: x.expand((N_FRAMES, 2) + x.shape))
        idx = np.broadcast_to(np.arange(2), (N_FRAMES, 2))
        want = np.asarray(jsk.mesh_from_hand_pose(jb, jnp.asarray(ja), jnp.asarray(wr), jnp.asarray(idx)))
        got = sk.mesh_from_hand_pose(tb, torch.from_numpy(ja), torch.from_numpy(wr), torch.from_numpy(idx.copy()))
        assert got.shape == (N_FRAMES, 2, 128, 3)
        np.testing.assert_allclose(want, got.numpy(), atol=1e-3)
        # left hands unmirrored: the mesh is the landmarks' skin over dense weights
        want = np.asarray(jsk.skin_mesh_vertices(jb, jnp.asarray(ja), jnp.asarray(wr)))
        got = sk.skin_mesh_vertices(tb, torch.from_numpy(ja), torch.from_numpy(wr))
        np.testing.assert_allclose(want, got.numpy(), atol=1e-3)
        # the right hand mirrors the left: its mesh differs from the unmirrored skin
        assert not np.allclose(got.numpy()[:, 1], np.asarray(jsk.mesh_from_hand_pose(jb, jnp.asarray(ja), jnp.asarray(wr), jnp.asarray(idx)))[:, 1], atol=1)

    def test_skin_mesh_needs_a_mesh(self):
        hand = hm.hand_model_from_dict(chip_smoke.synthetic_hand_model())
        with pytest.raises(ValueError, match="no mesh"):
            sk.skin_mesh_vertices(hand, torch.zeros(22), torch.eye(4))

    def test_box_mesh_rides_its_frames(self, scene):
        """Each box of the synthetic mesh is weighted to one skinning frame,
        the palm to the wrist and each phalanx to the frame that moves it."""
        m = scene["hand_model"]
        frames = m["dense_bone_weights"].argmax(-1).reshape(-1, 8)
        assert (frames == frames[:, :1]).all() and (m["dense_bone_weights"].sum(-1) == 1).all()
        assert frames[:, 0].tolist() == [1] + [2 + 3 * f + s for f in range(5) for s in range(3)]
        assert m["mesh_triangles"].dtype == np.int64 and m["mesh_triangles"].max() == 127


class TestHandModelIO:
    def test_load_hand_model_json(self, scene, tmp_path):
        path = tmp_path / "hand.json"
        path.write_text(json.dumps({k: np.asarray(v).tolist() for k, v in scene["hand_model"].items()}))
        want, got = jhm.load_hand_model_json(str(path)), hm.load_hand_model_json(str(path))
        for name, a, b in zip(hm.HandModel._fields, want, got):
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
                assert b.dtype == (torch.int64 if name in hm._INT_FIELDS else torch.float32)

    def test_mirrored_hand_model(self, scene):
        hand = scene["hand_model"]
        mask = np.array([True, False])
        jb = jax.tree.map(lambda x: jnp.broadcast_to(x, (2,) + x.shape), jhm.hand_model_from_dict(hand))
        tb = hm.hand_model_from_dict(hand).map(lambda x: x.expand((2,) + x.shape))
        want, got = jhm.mirrored_hand_model(jb, jnp.asarray(mask)), hm.mirrored_hand_model(tb, torch.from_numpy(mask))
        for name, a, b in zip(hm.HandModel._fields, want, got):
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
        assert not torch.equal(got.joint_rest_positions[0], tb.joint_rest_positions[0])
        assert torch.equal(got.joint_rest_positions[1], tb.joint_rest_positions[1])


def test_split_stacked_frame():
    raw = np.random.default_rng(0).integers(0, 256, (6, 4 * 10), dtype=np.uint8)
    want, got = jvd.split_stacked_frame(raw, 4), vd.split_stacked_frame(raw, 4)
    assert got.shape == (4, 6, 10) and got.dtype == np.uint8
    np.testing.assert_array_equal(want, got)


class TestSyntheticFrameSource:
    def test_blobs_match_jax(self, labels):
        jl, tl = labels
        lm = jvd.gt_landmark_sequence(jl)
        np.testing.assert_allclose(lm, vd.gt_landmark_sequence(tl), atol=1e-3)
        want = jvd.SyntheticFrameSource(jl, lm)
        got = vd.SyntheticFrameSource(tl, lm)
        for t in range(N_FRAMES):
            a, b = want.render_frame(t), got.render_frame(t)
            assert b.shape == (4,) + chip_smoke.SRC_HW and b.dtype == np.float32
            err = np.abs(a - b)
            assert np.mean(err <= 1e-2) >= 0.999 and float(b.max()) > 100
        np.testing.assert_allclose(want._win, got._win, atol=1e-3)


class TestMeshFrameSource:
    def test_projections_and_raster_match_jax(self, labels):
        jl, tl = labels
        want, got = jvd.MeshFrameSource(jl), vd.MeshFrameSource(tl)
        want._project_all()
        got._project_all()
        assert got._win.shape == (N_FRAMES, 4, 2, 128, 2)
        np.testing.assert_allclose(want._win, got._win, atol=1e-3)
        np.testing.assert_allclose(want._eye, got._eye, atol=1e-3)
        # the same projections give the same raster, bit for bit
        got._win, got._eye = want._win, want._eye
        for t in range(N_FRAMES):
            a, b = want.render_frame(t), got.render_frame(t)
            np.testing.assert_array_equal(a, b)
            assert (b > 0).sum() > 1000 and np.array_equal(b, np.round(b))  # whole shades

    def test_needs_a_mesh(self, scene):
        scene = dict(scene, hand_model=chip_smoke.synthetic_hand_model())
        with pytest.raises(ValueError, match="no mesh"):
            vd.MeshFrameSource(vd.labels_from_json(chip_smoke.labels_json(scene)))


def test_make_frame_source_dispatch(labels):
    _, tl = labels
    assert isinstance(vd.make_frame_source(tl), vd.MeshFrameSource)
    blobs = vd.make_frame_source(tl, renderer="blobs", blob_sigma=2.0, image_size=(64, 48))
    assert isinstance(blobs, vd.SyntheticFrameSource) and blobs.blob_sigma == 2.0
    assert blobs.render_frame(0).shape == (4, 48, 64)
    with pytest.raises(ValueError, match="unknown renderer"):
        vd.make_frame_source(tl, renderer="rays")


def test_video_frame_source_decodes_as_jax_does(tmp_path):
    """A width-stacked FFV1 video written with cv2 decodes bit-equal in both
    packages (``tests/test_video_decode.py``'s recipe)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    v, h, w = 3, 48, 64
    path = str(tmp_path / "views.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 30, (v * w, h), isColor=False)
    assert writer.isOpened()
    for t in range(4):
        views = [cv2.resize(rng.uniform(0, 80, (h // 8, w // 8)).astype(np.float32), (w, h)) + 40 * i + 2 * t for i in range(v)]
        writer.write(np.clip(np.concatenate(views, axis=1), 0, 255).astype(np.uint8))
    writer.release()
    want, got = list(jvd.VideoFrameSource(path, v)), list(vd.VideoFrameSource(path, v))
    assert len(got) == 4
    for a, b in zip(want, got):
        assert b.shape == (v, h, w) and b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        vd.VideoFrameSource(str(tmp_path / "missing.mp4"), v)


def test_frames_for(labels, tmp_path):
    jl, tl = labels
    video = tmp_path / "video.mp4"
    video.write_bytes(b"")
    for path, renderer in ((None, "mesh"), (str(tmp_path / "absent.mp4"), "blobs"), (str(video), "mesh")):
        want, got = jeval.frames_for(jl, path, renderer), eval_lib.frames_for(tl, path, renderer)
        assert type(got).__name__ == type(want).__name__
    assert isinstance(eval_lib.frames_for(tl, str(video)), vd.VideoFrameSource)
    assert os.path.exists(str(video))
