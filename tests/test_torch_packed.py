"""Port parity: the packed-data path (``geometry/camera.py::pinhole_camera``,
``ops/resample.py::compute_resample_matrix``/``warp_homography``,
``data/transform.py::preprocess_packed``, ``apps/pack_sample_data.py``,
``apps/run_inference_torch_data.py``) against the JAX package on the CPU,
and the CPU rehearsal of ``chip_smoke.py``'s data phase.

Inputs: a label tree of two recordings x 4 frames cut from
``chip_smoke.build_scene(mesh=True)`` with the scene's hand model as the
generic hand model (``chip_smoke.protocol_tree``), packed by both
packages in windows of 2 frames from the same frames, the scene's own.
Tolerances, each with its reason:

* homographies and crop intrinsics/extrinsics: 1e-5 relative to the
  matrix's largest entry (f32 products of ~600 px entries);
* homography source coordinates: 1e-3 px (f32 chains of ~600 px values,
  as the crop planes in ``tests/test_torch_warp.py``);
* plain f32 warp against JAX's gather: 0.05 on the 0..255 scale, since
  coordinates an f32 ulp apart (~6e-5 px at x ~ 636) move a sample by at
  most 2 * 255 * 6e-5; crops in [0, 1] to 0.05 / 255;
* bf16 rows against the Pallas kernels in interpret mode on the same
  coordinates: <= 1e-3 on >= 99.9% of pixels and <= 1e-2 everywhere, as
  ``tests/test_torch_warp.py`` holds them;
* packed ``mono``: truncation to uint8 turns those few-hundredths into
  one level where a value sits within rounding of an integer, so at most
  1 level apart and >= 99.9% equal; labels 1e-5 relative (FK in f32);
* per-frame landmark errors (mm) at ``ModelConfig.tiny()`` with the JAX
  twin's params: 0.05 mm (no looser than ``tests/test_torch_eval.py``'s
  0.5 mm landmark budget);
* W windows in lockstep against one at a time: rtol 1e-6, atol 1e-4, as
  ``tests/test_integration.py`` holds JAX's.
"""

import io
import json
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from absolutetrack_tpu.apps import pack_sample_data as jpack
from absolutetrack_tpu.apps import run_inference_torch_data as jinfer
from absolutetrack_tpu.data import PackedDataset as JPackedDataset
from absolutetrack_tpu.data import find_dataset_folders as jfind
from absolutetrack_tpu.data import transform as jtransform
from absolutetrack_tpu.geometry import affine as jaffine
from absolutetrack_tpu.geometry import camera as jcam
from absolutetrack_tpu.models import umetrack as jum
from absolutetrack_tpu.ops import resample as jrs
from absolutetrack_tpu.ops.pallas_warp import bilinear_sample_mxu
from absolutetrack_tpu.tracker import video_data as jvd
from absolutetrack_tpu_torch.apps import pack_sample_data as pack
from absolutetrack_tpu_torch.apps import run_eval_unknown_skeleton as unknown
from absolutetrack_tpu_torch.apps import run_inference_torch_data as infer
from absolutetrack_tpu_torch.data import PackedDataset, find_dataset_folders
from absolutetrack_tpu_torch.data import transform
from absolutetrack_tpu_torch.geometry import camera as cam
from absolutetrack_tpu_torch.kinematics.hand_model import HandModel, load_hand_model_json
from absolutetrack_tpu_torch.models.config import ModelConfig
from absolutetrack_tpu_torch.models.params import export_jax_params, load_jax_params
from absolutetrack_tpu_torch.models.umetrack import UmeTrackModel
from absolutetrack_tpu_torch.ops import resample as rs
from absolutetrack_tpu_torch.ops import warp_kernel
from absolutetrack_tpu_torch.tracker import video_data as vd
from absolutetrack_tpu.models.config import ModelConfig as JConfig

jax.config.update("jax_platforms", "cpu")

CFG = ModelConfig.tiny()
JCFG = JConfig.tiny()
FRAMES = 4
WINDOW = 2
MONO_EQUAL = 0.999
LABELS_REL = 1e-5
ERR_MM = 0.05


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The label tree, packed by both packages: {"data", "generic", "jax", "port"}.

    Both packers get the same frames, the scene's own uint8 views (recording
    i is frames i to i + 3): the two mesh renderers agree bit for bit only
    given the same projections (``tests/test_torch_frames.py``), and a
    silhouette pixel that flips between them would hide what is compared here."""
    root = tmp_path_factory.mktemp("packed")
    scene = chip_smoke.build_scene(3, FRAMES + 1, mesh=True)
    data, generic = chip_smoke.protocol_tree(root, scene, 2, FRAMES)

    def scene_frames(labels, video_path, renderer="mesh"):
        start = int(video_path[-6:-4])  # .../recording_0{i}.mp4
        return list(scene["frames"][start : start + FRAMES])

    common = ["--input-dir", str(data), "--generic-hand-model", str(generic),
              "--window", str(WINDOW), "--max-frames", str(FRAMES)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpack.eval_lib, "frames_for", scene_frames)
        mp.setattr(pack.eval_lib, "frames_for", scene_frames)
        jpack.main(common + ["--output-dir", str(root / "jax")])
        pack.main(common + ["--output-dir", str(root / "port"), "--torch-device", "cpu"])
    return dict(data=data, generic=generic, jax=root / "jax", port=root / "port", scene=scene)


def _datasets(tree):
    folders = {k: find_dataset_folders(str(tree[k]), ["mono", "labels"]) for k in ("jax", "port")}
    return {k: PackedDataset(v, ["mono", "labels"]) for k, v in folders.items()}, folders


def _assert_mono_close(want, got):
    d = np.abs(want.astype(np.int16) - got.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert np.mean(d == 0) >= MONO_EQUAL, np.mean(d == 0)


def _assert_rel(want, got, rel=LABELS_REL):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert want.shape == got.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-12))


def test_pinhole_camera():
    rng = np.random.default_rng(0)
    args = [rng.uniform(100, 300, 3), rng.uniform(100, 300, 3), rng.uniform(0, 96, 3), rng.uniform(0, 96, 3),
            np.tile(np.eye(4), (3, 1, 1)) + 0.1 * rng.standard_normal((3, 4, 4)), np.full(3, 96.0), np.full(3, 64.0)]
    want, got = jcam.pinhole_camera(*args), cam.pinhole_camera(*args)
    for name in cam.Camera._fields:
        a, b = np.asarray(getattr(want, name)), getattr(got, name)
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    assert not got.coeffs.any()


def test_rectify_views_matches_jax(tree):
    """The same fisheye frames (the scene's random uint8 views) through both
    packages' ``rectify_views``: views within one level, intrinsics equal,
    extrinsics 1e-5."""
    path = sorted((tree["data"] / "testing" / "user00").glob("*.json"))[0]
    frames = list(tree["scene"]["frames"][:3])
    jimgs, jK, jw2e = jpack.rectify_views(jvd.load_labels(str(path)), frames, max_frames=3)
    imgs, K, w2e = pack.rectify_views(vd.load_labels(str(path)), frames, max_frames=3, device="cpu")
    assert imgs.shape == jimgs.shape == (3, chip_smoke.N_VIEWS) + chip_smoke.SRC_HW and imgs.dtype == np.uint8
    _assert_mono_close(jimgs, imgs)
    assert imgs.any() and (imgs == 0).any()  # the rectified views leave the fisheye's disc black
    np.testing.assert_array_equal(K, jK)
    _assert_rel(jw2e, w2e)


def test_pack_sample_data_matches_jax(tree):
    """Both mains over the tree: the same folders and window counts; mono
    within one level; labels within 1e-5, the hand models equal."""
    dsets, folders = _datasets(tree)
    rel = [[f.replace(str(tree[k]), "") for f in folders[k]] for k in ("jax", "port")]
    assert rel[0] == rel[1] and len(rel[0]) == 4  # 2 recordings x 2 hands
    assert rel[0] == [f.replace(str(tree["jax"]), "") for f in jfind(str(tree["jax"]), ["mono", "labels"])]
    jd, td = JPackedDataset(folders["jax"], ["mono", "labels"]), dsets["port"]
    assert len(jd) == len(td) == 4 * FRAMES // WINDOW
    for i in range(len(jd)):
        a, b = jd[i], td[i]
        assert b["mono"].shape == (WINDOW, 2) + chip_smoke.SRC_HW
        _assert_mono_close(a["mono"], b["mono"])
        assert sorted(a["labels"]) == sorted(b["labels"])
        for key, value in a["labels"].items():
            if key in ("hand_model", "generic_hand_model", "hand", "pinch"):
                assert b["labels"][key] == value, key
            else:
                _assert_rel(value, b["labels"][key])


def _jax_seq(sample, crop):
    return jtransform.preprocess_packed(np.asarray(sample["mono"]), sample["labels"], crop_size=crop)


def _port_seq(sample, crop, **kw):
    return transform.preprocess_packed(np.asarray(sample["mono"]), sample["labels"], crop_size=crop, device="cpu", **kw)


@pytest.mark.parametrize("crop", [(96, 96), (32, 32)])
def test_preprocess_packed_matches_jax(tree, crop):
    """Every field of one window of each hand (the right hand mirrored)."""
    jd = JPackedDataset(jfind(str(tree["jax"]), ["mono", "labels"]), ["mono", "labels"])
    for i in (0, len(jd) - 1):
        s = jd[i]
        want, got = _jax_seq(s, crop), _port_seq(s, crop)
        assert int(got.hand_idx) == int(want.hand_idx) == int(s["labels"]["hand"][0])
        assert got.left_images.shape == (WINDOW, 2, crop[1], crop[0])
        np.testing.assert_allclose(got.left_images.numpy(), np.asarray(want.left_images), atol=0.05 / 255)
        assert float(got.left_images.max()) > 0.1  # the crops hold the hand's pixels
        for name in ("intrinsics", "extrinsics"):
            _assert_rel(np.asarray(getattr(want, name)), getattr(got, name).numpy())
        for name in ("gt_joint_angles", "gt_wrist", "solved_joint_angles", "solved_wrist", "pinch"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
        for hand in ("gt_hand_model", "generic_hand_model"):
            for name in HandModel._fields:
                a, b = getattr(getattr(want, hand), name), getattr(getattr(got, hand), name)
                assert (a is None) == (b is None), name
                if a is not None:
                    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-7, err_msg=f"{hand}.{name}")


def _homography_inputs(tree):
    """The window's homography inputs as JAX's ``preprocess_packed`` makes
    them (mm to m, crop cameras): numpy (K_orig, W2E_orig, K_new, E2W_new)
    and the f32 views, for window 1 (a right hand)."""
    jd = JPackedDataset(jfind(str(tree["jax"]), ["mono", "labels"]), ["mono", "labels"])
    s = jd[len(jd) - 1]
    seq = _jax_seq(s, (96, 96))
    ext = np.asarray(s["labels"]["extrinsics"], np.float32)
    ext[..., :3, 3] *= transform.MM_TO_M
    inputs = (np.asarray(s["labels"]["intrinsics"], np.float32), ext,
              np.asarray(seq.intrinsics), np.asarray(jaffine.rigid_inverse(seq.extrinsics)))
    mono = np.asarray(s["mono"], np.float32)
    return [np.array(x.reshape((-1,) + x.shape[2:])) for x in inputs], mono.reshape((-1,) + mono.shape[2:])


def test_compute_resample_matrix_matches_jax(tree):
    inputs, _ = _homography_inputs(tree)
    want = np.asarray(jrs.compute_resample_matrix(*map(jnp.asarray, inputs)))
    got = rs.compute_resample_matrix(*map(torch.from_numpy, inputs))
    assert got.shape == want.shape == (2 * WINDOW, 4, 4)
    for a, b in zip(want, got.numpy()):
        _assert_rel(a, b)


def test_warp_homography_f32_matches_jax_gather(tree):
    inputs, views = _homography_inputs(tree)
    xfs = np.array(jrs.compute_resample_matrix(*map(jnp.asarray, inputs)))
    want = np.asarray(jrs.warp_homography(jnp.asarray(views), jnp.asarray(xfs), (96, 96), method="gather"))
    got = rs.warp_homography(torch.from_numpy(views), torch.from_numpy(xfs), (96, 96))
    assert got.shape == (2 * WINDOW, 96, 96) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=0.05)
    assert (want > 0).mean() > 0.5 and (want == 0).any()  # most pixels inside, some outside the view
    # the coordinates themselves, against JAX's einsum and divide
    x, y = rs._homography_coords(torch.from_numpy(xfs), (96, 96))
    grid = np.asarray(jrs._dst_pixel_grid((96, 96)))
    np.testing.assert_array_equal(rs._dst_pixel_grid((96, 96)).numpy(), grid)
    src = np.einsum("nij,pj->npi", xfs[:, :3, :3].astype(np.float64), np.c_[grid, np.ones(len(grid))]) + xfs[:, None, :3, 3]
    np.testing.assert_allclose(x.reshape(len(xfs), -1).numpy(), src[..., 0] / src[..., 2], atol=1e-3)
    np.testing.assert_allclose(y.reshape(len(xfs), -1).numpy(), src[..., 1] / src[..., 2], atol=1e-3)


def test_warp_homography_bf16_rows_match_pallas(tree):
    """``bf16_rows=True`` against the Pallas dispatch in interpret mode with
    ``crop_hw=(96, 96)``, as JAX's ``warp_homography`` reaches it on the
    TPU, on the same coordinates."""
    inputs, views = _homography_inputs(tree)
    xfs = torch.from_numpy(np.array(jrs.compute_resample_matrix(*map(jnp.asarray, inputs))))
    x, y = rs._homography_coords(xfs, (96, 96))
    n = len(views)
    want = np.asarray(bilinear_sample_mxu(
        jnp.asarray(views), jnp.arange(n), (jnp.asarray(x.reshape(n, -1).numpy()), jnp.asarray(y.reshape(n, -1).numpy())),
        interpret=True, crop_hw=(96, 96),
    )).reshape(n, 96, 96)
    got = rs.warp_homography(torch.from_numpy(views), xfs, (96, 96), bf16_rows=True).numpy()
    err = np.abs(want - got)
    assert err.max() <= 1e-2 and np.mean(err <= 1e-3) >= 0.999, (err.max(), np.mean(err <= 1e-3))
    f32 = rs.warp_homography(torch.from_numpy(views), xfs, (96, 96)).numpy()
    assert np.abs(f32 - want).max() > 0.1  # the bf16 rows were taken


@pytest.fixture(scope="module")
def twin():
    """(JAX model, port model) with the same weights: the port's seeded init
    with damped heads and memory (``chip_smoke.damped``), carried to JAX by
    ``export_jax_params`` and back by ``load_jax_params``."""
    seeded = chip_smoke.damped(UmeTrackModel(CFG, device="cpu", generator=torch.Generator().manual_seed(8)))
    params = export_jax_params(seeded)
    return jum.UmeTrackModel(jax.tree.map(jnp.asarray, params), JCFG), load_jax_params(params, CFG, device="cpu")


@pytest.fixture(scope="module")
def tiny_windows(tree):
    """(JAX sequences, port sequences) at crop (32, 32) of the first four
    windows: two of recording 0's left hand, then two of its right."""
    jd = JPackedDataset(jfind(str(tree["jax"]), ["mono", "labels"]), ["mono", "labels"])
    samples = [jd[i] for i in range(4)]
    return [_jax_seq(s, CFG.input_size) for s in samples], [_port_seq(s, CFG.input_size) for s in samples]


@pytest.mark.parametrize("n_views", [None, 1])
def test_eval_window_matches_jax(twin, tiny_windows, n_views):
    jmodel, model = twin
    jseqs, seqs = tiny_windows
    run = jax.jit(lambda s: jinfer.eval_window(jmodel, s, n_views=n_views))
    for i in (0, len(seqs) - 1):  # a left and a right hand
        want = np.asarray(run(jseqs[i]))
        got = infer.eval_window(model, seqs[i], n_views=n_views)
        assert got.shape == (WINDOW,) and torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want, atol=ERR_MM)


@pytest.mark.parametrize("n_views", [None, 1])
def test_eval_windows_batched_matches_jax(twin, tiny_windows, n_views):
    """All windows in lockstep against JAX's, and against the port's one at a
    time; the single-view path gives other errors than the stereo one."""
    jmodel, model = twin
    jseqs, seqs = tiny_windows
    want = np.asarray(jinfer.eval_windows_batched(jmodel, jinfer.stack_windows(jseqs), n_views=n_views))
    got = infer.eval_windows_batched(model, infer.stack_windows(seqs), n_views=n_views).numpy()
    assert got.shape == (len(seqs), WINDOW)
    np.testing.assert_allclose(got, want, atol=ERR_MM)
    single = np.stack([infer.eval_window(model, s, n_views=n_views).numpy() for s in seqs])
    np.testing.assert_allclose(got, single, rtol=1e-6, atol=1e-4)
    if n_views == 1:
        stereo = infer.eval_windows_batched(model, infer.stack_windows(seqs)).numpy()
        assert np.abs(stereo - got).max() > 1e-3


def test_stack_windows_refuses_unequal_lengths(tiny_windows):
    _, seqs = tiny_windows
    short = seqs[0]._replace(left_images=seqs[0].left_images[:1])
    with pytest.raises(ValueError, match="uniform window length"):
        infer.stack_windows([seqs[0], short])


def _main(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        res = infer.main(argv)
    return res, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "reference.pt"
    torch.save(chip_smoke.reference_state_dict(ModelConfig(), 2), path)
    return str(path)


def test_main_at_full_width_on_the_cpu(tree, checkpoint):
    """``main`` over 2 windows of 2 frames at full ``ModelConfig()`` width:
    its errors are ``eval_window``'s on the same windows (and so are its
    printed lines); ``--batch-windows 2`` matches ``--batch-windows 1``;
    ``--views 1`` runs the single-view path."""
    argv = ["--data-root", str(tree["port"]), "--checkpoint", checkpoint, "--torch-device", "cpu", "--limit", "2"]
    (errors, seconds), lines = _main(argv + ["--prefetch", "1"])
    assert errors.shape == (2, WINDOW) and np.isfinite(errors).all() and seconds > 0
    assert lines[0] == "[rank 0] 8 windows from 4 folders"
    model = infer.eval_lib.build_model(checkpoint, ModelConfig(), device="cpu")
    ds, _ = _datasets(tree)
    for i in range(2):
        seq = transform.preprocess_packed(np.asarray(ds["port"][i]["mono"]), ds["port"][i]["labels"], device="cpu")
        want = infer.eval_window(model, seq).numpy()
        np.testing.assert_array_equal(errors[i], want)
        assert lines[1 + i] == f"window error: {want.mean():.2f} mm"
    assert lines[-1] == f"Mean landmark error: {errors.mean():.3f} mm over 2 windows"

    (batched, _), blines = _main(argv + ["--batch-windows", "2"])
    np.testing.assert_allclose(batched, errors, rtol=1e-6, atol=1e-4)
    assert blines[1] == f"group of 2: {batched.mean():.2f} mm"
    assert re.fullmatch(r"throughput: [0-9.]+ windows/s \([0-9]+ frames/s\) at W=2", blines[2])
    (single_view, _), _ = _main(argv + ["--views", "1"])
    assert np.abs(single_view - errors).max() > 1e-3


def test_main_options(tree, tmp_path):
    """Rank 1 of 2 takes every other window; ``--mesh-data 2`` needs
    ``--batch-windows`` divisible by it and a world of 2 ranks (launched by
    torchrun; ``tests/test_torch_parallel.py`` runs one); an empty root
    exits with a hint; the card is the default device."""
    argv = ["--data-root", str(tree["port"]), "--torch-device", "cpu", "--limit", "0"]
    (errors, _), lines = _main(argv + ["--rank", "1", "--world-size", "2"])
    assert lines == ["[rank 1] 4 windows from 4 folders"] and errors.size == 0
    with pytest.raises(ValueError, match="--batch-windows % --mesh-data"):
        infer.main(argv + ["--mesh-data", "2"])
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        infer.main(argv + ["--mesh-data", "2", "--batch-windows", "2"])
    with pytest.raises(SystemExit, match="pack_sample_data"):
        infer.main(["--data-root", str(tmp_path), "--torch-device", "cpu"])


@pytest.mark.parametrize("batch_windows", ["1", "2"])
def test_main_raises_a_prefetch_failure(tree, monkeypatch, batch_windows):
    """A failure while the prefetch thread preprocesses (a K1 build or
    launch on the card) raises in ``main``, after the windows before it."""
    calls = []

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("K1 launch failed: error 98")
        return transform.preprocess_packed(*args, **kwargs)

    monkeypatch.setattr(infer, "preprocess_packed", failing)
    argv = ["--data-root", str(tree["port"]), "--torch-device", "cpu", "--batch-windows", batch_windows, "--limit", "4"]
    with pytest.raises(RuntimeError, match="error 98"):
        _main(argv)


def test_entry_points_default_to_the_card(tree, monkeypatch):
    """Without a device the packed path's entry points and the GN scale
    helpers ask for ``cuda``: with no card they raise, never run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds, _ = _datasets(tree)
    s = ds["port"][0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transform.preprocess_packed(np.asarray(s["mono"]), s["labels"])
    path = sorted((tree["data"] / "testing" / "user00").glob("*.json"))[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pack.rectify_views(vd.load_labels(str(path)), [], max_frames=1)
    generic = load_hand_model_json(str(tree["generic"]))
    calib = infer.eval_lib.SequenceResult(
        tracked_keypoints=np.zeros((2, 3, 21, 3), np.float32), gt_keypoints=np.zeros((2, 3, 21, 3), np.float32),
        valid_tracking=np.ones((2, 3), bool), predicted_scales=np.ones((2, 3), np.float32),
        joint_angles=np.zeros((2, 3, 22), np.float32), wrist_xfs=np.tile(np.eye(4, dtype=np.float32), (2, 3, 1, 1)),
    )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        unknown.calibrated_scale_from(calib, generic, "gn")
    assert unknown.calibrated_scale_from(calib, generic, "mean") == 1.0  # no device needed
    assert unknown.calibrated_scale_from(calib, generic, "gn", device="cpu") == pytest.approx(1.0, abs=1e-4)


def test_chip_smoke_data_phase_on_the_cpu():
    """The data phase on the CPU with a small tree: 1 recording x 4 frames
    in windows of 2, W=2 and W=1; the same checks as on the card but K1's,
    and no K1 launch."""
    before = warp_kernel.K1.launches
    rep = chip_smoke.data_phase(0, device="cpu", n_recordings=1, n_frames=4, window=2, batch_windows=2, limit=2)
    assert warp_kernel.K1.launches == before
    assert rep["windows"] == 4 and rep["k1_launches"] == 0
    assert rep["batched_vs_b1_max_err_mm"] <= chip_smoke.LANDMARK_TOL_MM
    for name in ("w_batch", "w1"):
        run = rep[name]
        assert run["windows"] > 0 and run["windows_per_s"] > 0 and np.isfinite(run["mean_error_mm"])
    json.dumps(rep)
