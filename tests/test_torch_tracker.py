"""Port parity: the known-skeleton tracking step end to end, and the port's hygiene.

The scene is ``chip_smoke.build_scene`` (a 4-camera fisheye62 rig, two
hands ~350 mm away, uint8 frames of 480x636 uploaded padded to 512x640 with
``src_valid_hw``) at ``ModelConfig.tiny()`` (32x32 crops). The JAX tracker
runs frame by frame as ``apps/eval_lib.py::track_recording(pipelined=False)``
does (crops from the given poses) and as ``bench.py`` does (crops from the
tracked pose fed back); the port runs ``HandTracker.track_sequence`` in the
same two modes on the CPU, where the warp takes the plain sampler.

The weights are the JAX ones carried across with the heads and ConvRNN
scaled as in ``tests/test_torch_model.py``. For the feedback mode the
known-skeleton head is replaced in both packages by ``chip_smoke.with_pose_prior``,
which keeps the tracked hands in view as a trained model would.

Tolerances: landmarks (FK of the outputs) 0.5 mm, joint angles 2e-4 rad,
wrist rotations 5e-4; validity and view counts must be equal.
"""

import ast
import io
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from absolutetrack_tpu.geometry import camera as jcam
from absolutetrack_tpu.kinematics.hand_model import hand_model_from_dict as jhand
from absolutetrack_tpu.kinematics.skinning import landmarks_from_hand_pose as jlandmarks
from absolutetrack_tpu.models import umetrack as jum
from absolutetrack_tpu.models.config import ModelConfig as JConfig
from absolutetrack_tpu.tracker import tracker as jtr
from absolutetrack_tpu_torch.models.config import ModelConfig
from absolutetrack_tpu_torch.models.params import load_jax_params
from absolutetrack_tpu_torch.models.umetrack import UmeTrackModel
from absolutetrack_tpu_torch.ops import warp_kernel
from absolutetrack_tpu_torch.tracker.tracker import HandTracker, TrackerConfig

jax.config.update("jax_platforms", "cpu")

CFG = ModelConfig.tiny()
JCFG = JConfig.tiny()
N_FRAMES = 4
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def scene():
    return chip_smoke.build_scene(seed=1, n_frames=N_FRAMES)


@pytest.fixture(scope="module")
def twin(scene):
    """(JAX params, port model) with the same damped random weights."""
    params = jum.init_umetrack_params(jax.random.PRNGKey(1), JCFG)
    for reg in ("regressor_k", "regressor_u"):
        params[reg]["out"] = jax.tree.map(lambda x: x * 0.02, params[reg]["out"])
    params["temporal"] = jax.tree.map(lambda x: x * 0.1, params["temporal"])
    return params, load_jax_params(jax.tree.map(np.asarray, params), CFG, device="cpu")


@pytest.fixture(scope="module")
def prior_twin(scene, twin):
    """The twin with ``chip_smoke.with_pose_prior``'s head in both packages."""
    params, model = twin
    head = chip_smoke.with_pose_prior(model, chip_smoke.torch_scene(scene, "cpu"), CFG.input_size)
    out = head.regressor_k.out
    jparams = dict(params)
    jparams["regressor_k"] = dict(params["regressor_k"])
    jparams["regressor_k"]["out"] = {
        "w": jnp.asarray(out.weight.permute(2, 3, 1, 0).numpy()),
        "b": jnp.asarray(out.bias.numpy()),
    }
    return jparams, head


def _opts():
    return TrackerConfig(crop_size=CFG.input_size, src_valid_hw=chip_smoke.SRC_HW)


def _jax_run(params, scene, feedback):
    """The JAX tracker, frame by frame -> per-frame numpy outputs and landmarks."""
    tracker = jtr.HandTracker(
        jum.UmeTrackModel(params, JCFG),
        jtr.TrackerConfig(crop_size=JCFG.input_size, src_valid_hw=chip_smoke.SRC_HW),
    )
    step = jax.jit(tracker.track_frame)
    c = scene["cameras"]
    cams = jcam.Camera(
        **{k: jnp.asarray(np.asarray(c[k], np.float32)) for k in ("fx", "fy", "cx", "cy", "coeffs", "width", "height")},
        T_world_from_eye=jnp.asarray(scene["camera_to_world"][0]),
    )
    hand = jhand(scene["hand_model"])
    hand_b = jax.tree.map(lambda x: jnp.broadcast_to(x, (2,) + x.shape), hand)
    frames = jnp.asarray(chip_smoke.pad_frames(scene["frames"]))
    angles = jnp.asarray(scene["camera_angles"])
    ja, wr = jnp.asarray(scene["joint_angles"][0]), jnp.asarray(scene["wrist_transforms"][0])
    state = tracker.init_state()
    outs = []
    for t in range(N_FRAMES):
        if not feedback:
            ja, wr = jnp.asarray(scene["joint_angles"][t]), jnp.asarray(scene["wrist_transforms"][t])
        state, res = step(
            state, frames[t], cams._replace(T_world_from_eye=jnp.asarray(scene["camera_to_world"][t])),
            angles, hand, ja, wr, jnp.asarray(scene["hand_confidences"][t]),
        )
        if feedback:
            ja = jnp.where(res.hand_valid[:, None], res.joint_angles, ja)
            wr = jnp.where(res.hand_valid[:, None, None], res.wrist_xfs, wr)
        lm = jlandmarks(hand_b, res.joint_angles, res.wrist_xfs, jnp.arange(2))
        outs.append((res.joint_angles, res.wrist_xfs, res.hand_valid, res.num_views, lm))
    return [np.stack([np.asarray(o[i]) for o in outs]) for i in range(5)]


def _port_run(model, scene, feedback):
    ts = chip_smoke.torch_scene(scene, "cpu")
    _, res = HandTracker(model, _opts()).track_sequence(
        ts["frames"], ts["cameras"], ts["camera_to_world"], ts["camera_angles"],
        ts["hand_model"], ts["joint_angles"], ts["wrist_transforms"],
        ts["hand_confidences"], feedback=feedback,
    )
    return res


def _compare(j, t):
    ja, wr, valid, views, lm = j
    np.testing.assert_array_equal(valid, t.hand_valid.numpy())
    np.testing.assert_array_equal(views, t.num_views.numpy())
    assert valid.any()
    np.testing.assert_allclose(ja[valid], t.joint_angles.numpy()[valid], atol=2e-4)
    np.testing.assert_allclose(wr[valid][:, :3, :3], t.wrist_xfs.numpy()[valid][:, :3, :3], atol=5e-4)
    err_mm = np.linalg.norm(lm - t.tracked_keypoints.numpy(), axis=-1)[valid]
    assert err_mm.max() < 0.5, f"landmarks differ by {err_mm.max():.4f} mm"


class TestTrackSequence:
    def test_crops_from_given_poses(self, scene, twin):
        params, model = twin
        before = warp_kernel.K1.launches
        t = _port_run(model, scene, feedback=False)
        assert warp_kernel.K1.launches == before  # the CPU takes the plain sampler
        assert t.joint_angles.shape == (N_FRAMES, 2, 22) and t.tracked_keypoints.shape == (N_FRAMES, 2, 21, 3)
        assert t.hand_valid.all() and (t.num_views == 2).all()
        _compare(_jax_run(params, scene, feedback=False), t)

    def test_tracked_pose_fed_back(self, scene, prior_twin):
        params, head = prior_twin
        t = _port_run(head, scene, feedback=True)
        assert t.hand_valid.all() and (t.num_views == 2).all(), "the pose prior keeps both hands in view"
        _compare(_jax_run(params, scene, feedback=True), t)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


DEMO_MODULES = ("__init__", "detector_2d", "main", "pipeline", "stereo_rig", "unity_udp")
# the evaluation protocol's modules: the checkpoint codec and converter, the eval CLIs, GN
PROTOCOL_MODULES = (
    "apps/load_eval", "apps/run_eval_known_skeleton", "apps/run_eval_unknown_skeleton", "kinematics/metrics",
    "models/checkpoint", "models/weights", "ops/gauss_newton", "utils/flax_msgpack",
)
# the packed-data path's modules: the data layer and its two apps
DATA_MODULES = (
    "data/idxbin", "data/dataset", "data/prefetch", "data/transform",
    "apps/pack_sample_data", "apps/run_inference_torch_data",
)


def test_port_imports_no_jax():
    """No module of the port (its live demo, ``apps/demo/``, and its data
    layer included), and not chip_smoke.py, imports JAX, the JAX package,
    flax or msgpack (the card's machine has neither; checkpoints and packed
    label fields go through the port's codec)."""
    files = sorted((ROOT / "absolutetrack_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    demo = ROOT / "absolutetrack_tpu_torch" / "apps" / "demo"
    assert {demo / f"{m}.py" for m in DEMO_MODULES} <= set(files)
    assert {ROOT / "absolutetrack_tpu_torch" / f"{m}.py" for m in PROTOCOL_MODULES + DATA_MODULES} <= set(files)
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "msgpack", "absolutetrack_tpu"), f"{path}: imports {name}"


def test_port_loads_without_jax():
    """Importing every port module in a fresh interpreter pulls in no JAX,
    flax or msgpack; the demo's optional capture and detector packages (cv2, mediapipe, av)
    load only when a source or detector that needs them is built."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "absolutetrack_tpu_torch").rglob("*.py")
    )
    assert {f"absolutetrack_tpu_torch.apps.demo.{m}".removesuffix(".__init__") for m in DEMO_MODULES} <= set(mods)
    assert {"absolutetrack_tpu_torch." + m.replace("/", ".") for m in PROTOCOL_MODULES + DATA_MODULES} <= set(mods)
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r} + ['chip_smoke']: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'msgpack', 'absolutetrack_tpu', 'cv2', 'mediapipe', 'av')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_chip_smoke_path_phase_on_the_cpu():
    """The tracking that the script's path phase drives, at tiny width on the
    CPU: the script's scene and seed, its pose-prior head with tracked-pose
    feedback over all its frames, then its damped model with crops from the
    given poses. Both hands stay in view with 2 views, every output is
    finite, and the plain sampler launches no K1."""
    scene = chip_smoke.build_scene(seed=0)
    ts = chip_smoke.torch_scene(scene, "cpu")
    model = UmeTrackModel(CFG, device="cpu", generator=torch.Generator().manual_seed(0))
    before = warp_kernel.K1.launches
    runs = [
        (chip_smoke.with_pose_prior(model, ts, CFG.input_size), chip_smoke.FEEDBACK_FRAMES, True),
        (chip_smoke.damped(model), chip_smoke.GIVEN_POSE_FRAMES, False),
    ]
    for net, n, feedback in runs:
        _, res = chip_smoke._run(HandTracker(net, _opts()), ts, n, feedback)
        assert res.joint_angles.shape == (n, 2, 22)
        assert res.hand_valid.all() and (res.num_views == 2).all()
        for name, value in res._asdict().items():
            assert not value.is_floating_point() or torch.isfinite(value).all(), name
    assert warp_kernel.K1.launches == before


def test_chip_smoke_refuses_without_a_card(monkeypatch):
    """Without CUDA the script exits non-zero and prints no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = chip_smoke.main()
    assert rc != 0 and out.getvalue() == ""


def test_chip_smoke_refuses_a_port_from_elsewhere(monkeypatch, tmp_path):
    """Copied away from its checkout, the script does not drive a port that
    it finds elsewhere on the path: it exits non-zero and prints no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(chip_smoke, "__file__", str(tmp_path / "chip_smoke.py"))
    out = io.StringIO()
    with redirect_stdout(out):
        rc = chip_smoke.main()
    assert rc != 0 and out.getvalue() == ""
