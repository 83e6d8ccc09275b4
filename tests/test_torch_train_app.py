"""Port parity: the training CLI (``absolutetrack_tpu_torch/apps/train.py``)
against the JAX package's on the CPU, resuming, the inference paths'
freedom from autograd graphs, and the CPU rehearsal of ``chip_smoke.py``'s
train phase.

Both CLIs start from the same JAX-written ``--checkpoint`` (seeded params),
on the synthetic blob task at ``--tiny-arch`` (32x32) and on a tiny packed
tree at full ``ModelConfig()`` width (the packed mode always trains the
full model, as JAX's does); JAX's mesh is 1 x 1. Tolerances, measured
before they were fixed:

* step 0's loss and metrics: 1e-5 relative (measured 6.6e-8 on the
  synthetic task; 1.6e-7 packed, whose crops come from each package's
  preprocessing);
* step 1's loss, after the first update: 1e-4 relative (measured 0 and
  1.4e-5: rounding in the first update moves the second step's inputs);
* the saved params after 2 steps: within 2 lr a step of JAX's everywhere
  (Adam's update is ~lr g/|g|, so a sign flip of a near-zero gradient moves
  a parameter by up to 2 lr), and the two runs' updates (params minus the
  checkpoint's) within 0.1 of each other in norm (measured 6.2e-6
  synthetic, 0.040 packed). The one-step rule of
  ``tests/test_torch_training.py`` (1e-6 where |g| is large) does not
  survive a second step: Adam's second update mixes two gradients whose
  small entries differ by rounding.
"""

import io
import json
import re
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from absolutetrack_tpu.apps import train as japp
from absolutetrack_tpu.kinematics import hand_model as jhm
from absolutetrack_tpu.models import checkpoint as jckpt
from absolutetrack_tpu.models import weights as jweights
from absolutetrack_tpu.models.config import ModelConfig as JConfig
from absolutetrack_tpu.utils import runtime as jruntime
from absolutetrack_tpu_torch.apps import eval_lib
from absolutetrack_tpu_torch.apps import pack_sample_data as pack
from absolutetrack_tpu_torch.apps import run_inference_torch_data as infer
from absolutetrack_tpu_torch.apps import train as app
from absolutetrack_tpu_torch.apps.demo.pipeline import LiveTracker
from absolutetrack_tpu_torch.data import PackedDataset, find_dataset_folders
from absolutetrack_tpu_torch.data.transform import preprocess_packed
from absolutetrack_tpu_torch.models import checkpoint
from absolutetrack_tpu_torch.models.config import ModelConfig
from absolutetrack_tpu_torch.models.umetrack import UmeTrackModel
from absolutetrack_tpu_torch.ops import warp_kernel
from absolutetrack_tpu_torch.tracker.batched import BatchedTracker
from absolutetrack_tpu_torch.tracker.tracker import HandTracker, TrackerConfig
from absolutetrack_tpu_torch.tracker.video_data import load_labels

jax.config.update("jax_platforms", "cpu")

LOSS_REL = 1e-5
LR = 1e-4
STEP1_REL = 1e-4
UPDATE_REL = 0.1


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A label tree of 2 recordings x 4 mesh frames packed by the port in
    windows of 2, the scene's hand model as the generic one, and
    JAX-written checkpoints (tiny and full width) of
    ``chip_smoke.reference_state_dict``'s seeded weights (heads damped, as
    a trained model's outputs stay in range)."""
    root = tmp_path_factory.mktemp("train")
    scene = chip_smoke.build_scene(4, 6, mesh=True)
    data, generic = chip_smoke.protocol_tree(root, scene, 2, 4)

    def scene_frames(labels, video_path, renderer="mesh"):
        start = int(video_path[-6:-4])
        return list(scene["frames"][start : start + 4])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pack.eval_lib, "frames_for", scene_frames)
        with redirect_stdout(io.StringIO()):
            pack.main(["--input-dir", str(data), "--generic-hand-model", str(generic), "--window", "2",
                       "--max-frames", "4", "--output-dir", str(root / "packed"), "--torch-device", "cpu"])
    tiny = root / "tiny.msgpack"
    jcfg = JConfig.tiny(input_size=(32, 32))
    jckpt.save_params(str(tiny), jweights.convert_torch_state_dict(
        chip_smoke.reference_state_dict(ModelConfig.tiny(input_size=(32, 32)), 1), jcfg))
    full = root / "full.msgpack"
    jckpt.save_params(str(full), jweights.convert_torch_state_dict(chip_smoke.reference_state_dict(ModelConfig(), 2)))
    return dict(root=root, data=data, generic=str(generic), packed=str(root / "packed"), tiny=str(tiny),
                full=str(full), scene=scene)


def _port(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        res = app.main(argv + ["--torch-device", "cpu"])
    return res, out.getvalue().splitlines()


def _jax(argv, files, monkeypatch):
    """JAX's CLI on one CPU device (mesh 1 x 1), its generic hand model read
    from the tree, its compilation cache off; returns (each step's metrics,
    printed lines)."""
    real_devices, real_json = jax.devices, jhm.load_hand_model_json
    monkeypatch.setattr(jax, "devices", lambda *a: real_devices(*a)[:1])
    monkeypatch.setattr(jhm, "load_hand_model_json", lambda path: real_json(files["generic"]))
    monkeypatch.setattr(jruntime, "enable_compilation_cache", lambda *a: None)
    metrics, real_step = [], japp.make_train_step

    def recording(*args, **kwargs):
        step = real_step(*args, **kwargs)

        def run(state, batch, hand):
            state, m = step(state, batch, hand)
            metrics.append({k: float(v) for k, v in m.items()})
            return state, m

        return run

    monkeypatch.setattr(japp, "make_train_step", recording)
    out = io.StringIO()
    with redirect_stdout(out):
        japp.main(argv)
    monkeypatch.undo()
    return metrics, out.getvalue().splitlines()


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def _assert_params_close(jax_file, port_file, start_file, cfg, steps):
    """Every parameter within 2 lr a step of JAX's, and the two runs'
    updates (params minus the checkpoint's) within ``UPDATE_REL`` of each
    other in norm."""
    jcfg = JConfig(**cfg.__dict__)
    want, start = _flat(jckpt.load_params(jax_file, jcfg)), _flat(jckpt.load_params(start_file, jcfg))
    got = _flat(checkpoint.load_params(port_file, cfg))
    assert sorted(want) == sorted(got)
    dw = np.concatenate([(w - start[k]).ravel() for k, w in want.items()])
    dg = np.concatenate([(got[k] - start[k]).ravel() for k in want])
    assert np.abs(dg - dw).max() <= 2 * LR * steps
    assert np.linalg.norm(dg - dw) <= UPDATE_REL * np.linalg.norm(dw), np.linalg.norm(dg - dw) / np.linalg.norm(dw)


def _step0(metrics):
    return metrics[0]["total"] if isinstance(metrics[0]["total"], float) else float(metrics[0]["total"])


def test_synthetic_mode_matches_jax(files, tmp_path, monkeypatch):
    common = ["--synthetic", "--tiny-arch", "--steps", "2", "--batch", "2", "--window", "2",
              "--checkpoint", files["tiny"], "--save-every", "1", "--eval-every", "1"]
    jmetrics, jlines = _jax(common + ["--save", str(tmp_path / "jax.msgpack")], files, monkeypatch)
    res, lines = _port(common + ["--save", str(tmp_path / "port.msgpack"), "--generic-hand-model", files["generic"]])
    assert abs(float(res["metrics"][0]["total"]) - jmetrics[0]["total"]) <= LOSS_REL * abs(jmetrics[0]["total"])
    assert sorted(res["metrics"][0]) == sorted(jmetrics[0])
    # the same printed lines, numbers aside
    shape = [re.sub(r"[0-9.]+", "#", line.replace(str(tmp_path / "port"), "P")) for line in lines]
    jshape = [re.sub(r"[0-9.]+", "#", line.replace(str(tmp_path / "jax"), "P")) for line in jlines]
    assert shape == jshape
    assert lines[0] == jlines[0]  # held-out tracked MPJPE at init, to 0.1 mm
    assert res["heldout"][0] == pytest.approx(float(lines[0].split()[-2]), abs=0.05)
    assert abs(float(res["metrics"][1]["total"]) - jmetrics[1]["total"]) <= STEP1_REL * abs(jmetrics[1]["total"]), (
        float(res["metrics"][1]["total"]), jmetrics[1]["total"])
    _assert_params_close(str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack"), files["tiny"],
                         ModelConfig.tiny(input_size=(32, 32)), 2)
    # JAX's train state resumes in the port, with its step counter
    res, lines = _port(common[:-4] + ["--steps", "1", "--resume", str(tmp_path / "jax.msgpack.train"),
                                      "--save", str(tmp_path / "resumed.msgpack"), "--generic-hand-model", files["generic"]])
    assert lines[0] == f"resumed from {tmp_path / 'jax.msgpack.train'} at step 2"
    assert int(res["state"].step) == 3


def test_packed_mode_matches_jax(files, tmp_path, monkeypatch):
    common = ["--data-root", files["packed"], "--steps", "2", "--batch", "2", "--branch", "both",
              "--checkpoint", files["full"], "--save-every", "1"]
    jmetrics, jlines = _jax(common + ["--save", str(tmp_path / "jax.msgpack")], files, monkeypatch)
    res, lines = _port(common + ["--save", str(tmp_path / "port.msgpack")])
    assert lines[0] == jlines[0] == "8 windows from 4 folders"
    assert sorted(res["metrics"][0]) == sorted(jmetrics[0]) and "u_total" in jmetrics[0]
    for k, v in jmetrics[0].items():
        assert abs(float(res["metrics"][0][k]) - v) <= LOSS_REL * abs(v), k
    assert abs(float(res["metrics"][1]["total"]) - jmetrics[1]["total"]) <= STEP1_REL * abs(jmetrics[1]["total"]), (
        float(res["metrics"][1]["total"]), jmetrics[1]["total"])
    _assert_params_close(str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack"), files["full"], ModelConfig(), 2)
    state = checkpoint.load_train_state(str(tmp_path / "jax.msgpack.train"), res["state"])
    assert int(state.step) == int(res["state"].step) == 2


def test_resume_takes_the_step_counter_and_the_moments(files, tmp_path):
    """3 steps in one run equal 2 steps, a save and a resumed third step
    (whose batch, the synthetic task's, is seeded by ``--seed``): the same
    params and moments, bit for bit, and the step counter goes on."""
    common = ["--synthetic", "--tiny-arch", "--batch", "2", "--window", "2", "--checkpoint", files["tiny"],
              "--generic-hand-model", files["generic"], "--eval-every", "100"]
    whole, _ = _port(common + ["--steps", "3", "--save", str(tmp_path / "whole.msgpack")])
    first, _ = _port(common + ["--steps", "2", "--save", str(tmp_path / "first.msgpack")])
    saved = checkpoint.load_train_state(str(tmp_path / "first.msgpack.train"), first["state"])
    for a, b in ((saved.opt_state.inner_state.mu, first["state"].opt_state.inner_state.mu),
                 (saved.opt_state.inner_state.nu, first["state"].opt_state.inner_state.nu)):
        assert all(torch.equal(a[k], b[k]) for k in a)
    res, lines = _port(common[:-6] + ["--steps", "1", "--seed", "2", "--resume", str(tmp_path / "first.msgpack.train"),
                                      "--generic-hand-model", files["generic"], "--eval-every", "100",
                                      "--save", str(tmp_path / "second.msgpack")])
    assert lines[0] == f"resumed from {tmp_path / 'first.msgpack.train'} at step 2"
    assert int(res["state"].step) == int(whole["state"].step) == 3
    assert (tmp_path / "second.msgpack").read_bytes() == (tmp_path / "whole.msgpack").read_bytes()
    assert (tmp_path / "second.msgpack.train").read_bytes() == (tmp_path / "whole.msgpack.train").read_bytes()


def _rendered_tree(root):
    """recording_00, recording_02 and recording_11 (held out) of a mesh
    scene, 12 frames each, and the scene's hand model as the generic one."""
    scene = chip_smoke.build_scene(5, 14, mesh=True)
    for i, name in enumerate(("recording_00", "recording_02", "recording_11")):
        (root / f"{name}.json").write_text(json.dumps(chip_smoke.labels_json(scene, i, 12)))
    generic = root / "generic.json"
    generic.write_text(json.dumps({k: np.asarray(v).tolist() for k, v in scene["hand_model"].items()}))
    return str(generic)


def test_rendered_mode_on_the_cpu(tmp_path, monkeypatch):
    """``--rendered`` over a hermetic tree: windows built through the
    tracker's crop path, cached under ``--cache-dir`` and read back from
    the cache by a second run (the builder refuses to run)."""
    generic = _rendered_tree(tmp_path)
    argv = ["--rendered", "--rendered-root", str(tmp_path), "--generic-hand-model", generic, "--tiny-arch",
            "--input-size", "32", "--window", "2", "--steps", "2", "--batch", "2", "--cache-dir",
            str(tmp_path / "cache"), "--save", str(tmp_path / "r.msgpack")]
    res, lines = _port(argv)
    assert lines[0] == "rendered windows: train 12 samples, held-out 6 samples (recording_11)"
    assert lines[1].startswith("held-out tracked MPJPE at init: ")
    assert re.fullmatch(r"held-out tracked MPJPE: [0-9.]+ mm \(init\) -> [0-9.]+ mm \([0-9.]+x better\)", lines[-2])
    assert np.isfinite(res["heldout"]).all() and int(res["state"].step) == 2
    assert sorted(p.name for p in (tmp_path / "cache").iterdir()) == [
        "rendered_ds_32_T2_s4_held.npz", "rendered_ds_32_T2_s4_train.npz"]

    def refuse(*a, **k):
        raise AssertionError("the cache was not used")

    from absolutetrack_tpu_torch.training import rendered

    monkeypatch.setattr(rendered, "rendered_windows_from_labels", refuse)
    again, _ = _port(argv)
    assert again["heldout"][0] == res["heldout"][0]


def test_cli_refuses_several_cards_and_defaults_to_the_card(files, monkeypatch):
    """One process takes one card: several visible cards raise with how to
    launch one rank per card; ``--model-axis 2`` at a world of 1 trains
    unsharded, as JAX's trainer takes a model axis only where it divides
    its devices (``tests/test_torch_parallel.py`` runs it at a world of 2)."""
    argv = ["--synthetic", "--tiny-arch", "--steps", "1", "--generic-hand-model", files["generic"], "--save", ""]
    res = app.main(argv + ["--model-axis", "2", "--torch-device", "cpu"])
    assert len(res["metrics"]) == 1 and int(res["state"].step) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="one rank per card: `torchrun --nproc-per-node 2"):
        app.main(argv)


def test_inference_paths_build_no_graph(files):
    """A model whose parameters require gradients (as training leaves them)
    through the trackers, the pipelined chunk, the eval driver, the packed
    path and the demo's tracker: nothing they return requires grad."""
    cfg = ModelConfig.tiny()
    model = UmeTrackModel(cfg, device="cpu").requires_grad_(True)
    ts = chip_smoke.torch_scene(files["scene"], "cpu")
    opts = TrackerConfig(crop_size=cfg.input_size, src_valid_hw=chip_smoke.SRC_HW)
    tensors = []

    def collect(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x)
        elif isinstance(x, (tuple, list)):
            for y in x:
                collect(y)

    tracker = HandTracker(model, opts)
    collect(tracker.track_sequence(ts["frames"][:2], ts["cameras"], ts["camera_to_world"][:2], ts["camera_angles"],
                                   ts["hand_model"], ts["joint_angles"][:2], ts["wrist_transforms"][:2],
                                   ts["hand_confidences"][:2]))
    bt = BatchedTracker(model, opts)
    cams = ts["cameras"]._replace(T_world_from_eye=ts["camera_to_world"][0]).map(lambda x: x[None])
    collect(bt.track_frames(bt.init_state(1), ts["frames"][:1], cams, ts["camera_angles"][None],
                            ts["hand_model"].map(lambda x: x[None]), ts["joint_angles"][:1],
                            ts["wrist_transforms"][:1], ts["hand_confidences"][:1]))
    labels = load_labels(str(sorted((files["data"] / "testing" / "user00").glob("*.json"))[0]))
    frames = list(files["scene"]["frames"][:4])
    for pipelined in (True, False):
        res = eval_lib.track_recording(model, labels, frames, pipelined=pipelined, chunk_size=2)
        assert np.isfinite(res.tracked_keypoints).all()
    ds = PackedDataset(find_dataset_folders(files["packed"], ["mono", "labels"]), ["mono", "labels"])
    seq = preprocess_packed(np.asarray(ds[0]["mono"]), ds[0]["labels"], crop_size=cfg.input_size, device="cpu")
    collect(infer.eval_window(model, seq))
    live = LiveTracker(model, ts["hand_model"], cameras=ts["cameras"].map(lambda x: x[1:3]),
                       opts=TrackerConfig(crop_size=cfg.input_size))
    live(np.asarray(files["scene"]["frames"][0][1:3]), np.zeros((2, 2, 21, 2), np.float32), np.zeros((2, 2), bool))
    collect(live.last_result)
    assert len(tensors) > 10 and not any(t.requires_grad for t in tensors)


def test_chip_smoke_train_phase_on_the_cpu():
    """The train phase on the CPU at tiny width: packed and rendered training
    through ``main``, the train state read back bit-equal, the resume, no
    K1 launch; the checks of the card (K1, card against CPU) stay out."""
    before = warp_kernel.K1.launches
    rep = chip_smoke.train_phase(0, device="cpu", tiny=True)
    assert warp_kernel.K1.launches == before
    assert rep["packed"]["steps"] > 0 and rep["rendered"]["steps"] > 0
    assert rep["packed"]["train_state_bit_equal"] and rep["resume"]["step_after"] == rep["resume"]["step_before"] + rep["resume"]["steps"]
    assert np.isfinite(rep["packed"]["losses"]).all() and np.isfinite(rep["rendered"]["heldout_mm"]).all()
    json.dumps(rep)
