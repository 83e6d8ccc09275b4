"""Port parity: the bf16 serving preset (``ModelConfig.serving()``) at ``ModelConfig.tiny()`` width.

The JAX serving model (``compute_dtype="bfloat16"``) is the reference for
the dtype of every stage, read off it with ``jax.eval_shape``: the crops
and the trunk in bf16, the skeleton features f32, the ConvRNN's features
bf16 with f32 memory, the decoded outputs f32.

Against JAX's serving model run op by op, the port's serving outputs over
three frames with memory agree to 3e-8 of wrist translation (of a 0.37
scale) and exactly in joint angles on the CPU. They are held to 2e-6 of
the translation scale and 1e-5 rad: well below the bf16-against-f32 drift
(1.4e-4 and 6.7e-4 rad here), so a serving flow that ran a stage in f32
or rounded at other places fails (a conv that added its bias before its
output rounds missed by 5.4e-6, pooling in bf16 by 4.7e-5, FTL in f32 by
1.1e-5). JAX's compiled (``jit``)
serving model keeps some values in f32 that its op-by-op run rounds to
bf16, and differs from the op-by-op run by 3.9e-5 and 1.9e-4 rad, so it
is not the reference for the rounding. Against the port's own f32 model
the outputs are held to ``tests/test_models.py::TestServingPrecision``'s
relative budget: wrist translation within 1% of its largest magnitude,
joint angles within 2% of ``max(|a|, 1)``. The weights are the JAX ones,
heads x0.02 and ConvRNN x0.1 as in ``tests/test_torch_model.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from absolutetrack_tpu.models import backbone as jbb
from absolutetrack_tpu.models import umetrack as jum
from absolutetrack_tpu.models.config import ModelConfig as JConfig
from absolutetrack_tpu_torch.models.config import ModelConfig
from absolutetrack_tpu_torch.models.params import load_jax_params
from absolutetrack_tpu_torch.models.temporal import temporal_step
from absolutetrack_tpu_torch.models.umetrack import FrameInputs, SkeletonInputs, UmeTrackModel
from absolutetrack_tpu_torch.ops import warp_kernel
from absolutetrack_tpu_torch.tracker.batched import BatchedTracker
from absolutetrack_tpu_torch.tracker.crop_gen import CropSlots
from absolutetrack_tpu_torch.tracker.tracker import HandTracker, TrackerConfig

jax.config.update("jax_platforms", "cpu")

CFG = ModelConfig.tiny()
SERVING = ModelConfig.tiny(compute_dtype="bfloat16")
JSERVING = JConfig.tiny(compute_dtype="bfloat16")
B, V = 2, 2
FRAMES = 3


@pytest.fixture(scope="module")
def params():
    p = jum.init_umetrack_params(jax.random.PRNGKey(2), JConfig.tiny())
    for reg in ("regressor_k", "regressor_u"):
        p[reg]["out"] = jax.tree.map(lambda x: x * 0.02, p[reg]["out"])
    p["temporal"] = jax.tree.map(lambda x: x * 0.1, p["temporal"])
    # nonzero biases (JAX's init zeroes them), so that where a bias add rounds shows
    rng = np.random.default_rng(3)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x + rng.normal(0, 0.05, x.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['b']") else x,
        p,
    )


def _inputs(k: int):
    """Frame ``k`` of a sequence: both samples multi-view, memory used from frame 1."""
    rng = np.random.default_rng(10 + k)
    hh, ww = CFG.input_size
    intr = np.tile(np.eye(3, dtype=np.float32), (B, V, 1, 1))
    intr[..., 0, 0] = intr[..., 1, 1] = rng.uniform(150, 350, (B, V))
    intr[..., 0, 2] = intr[..., 1, 2] = (hh - 1) / 2
    q, _ = np.linalg.qr(rng.standard_normal((B * V, 3, 3)))
    q *= np.sign(np.linalg.det(q))[:, None, None]
    ext = np.tile(np.eye(4), (B * V, 1, 1))
    ext[:, :3, :3] = q
    ext[:, :3, 3] = rng.uniform(-0.3, 0.3, (B * V, 3))
    fields = dict(
        left_images=rng.uniform(0, 1, (B, V, hh, ww)).astype(np.float32),
        intrinsics=intr, extrinsics=ext.reshape(B, V, 4, 4).astype(np.float32),
        view_mask=np.ones((B, V), bool), hand_idx=np.array([0, 1]),
        use_memory=np.full(B, k > 0), sample_mask=np.ones(B, bool),
    )
    skel = dict(
        joint_rotation_axes=np.full((1, 22, 3), 0.1, np.float32),
        joint_rest_positions=np.full((1, 22, 3), 0.01, np.float32),
    )
    j = jum.FrameInputs(**{n: jnp.asarray(v) for n, v in fields.items()}), jum.SkeletonInputs(**{n: jnp.asarray(v) for n, v in skel.items()})
    t = FrameInputs(**{n: torch.from_numpy(np.array(v)) for n, v in fields.items()}), SkeletonInputs(**{n: torch.from_numpy(v) for n, v in skel.items()})
    return j, t


def _port_run(model):
    state = model.init_state(B)
    outs = []
    for k in range(FRAMES):
        _, (frame, skel) = _inputs(k)
        state, out = model.regress_pose_use_skeleton(state, frame, skel)
        outs.append(out)
    return state, outs


def _jax_run(params, cfg):
    """JAX's model op by op: each op rounds its output to its dtype, as
    the port's do."""
    model = jum.UmeTrackModel(params, cfg)
    state = model.init_state(B)
    outs = []
    for k in range(FRAMES):
        (frame, skel), _ = _inputs(k)
        state, out = model.regress_pose_use_skeleton(state, frame, skel)
        outs.append(out)
    return state, outs


def _within_budget(ref, got):
    """TestServingPrecision's budget, output by output."""
    for a, b in zip(ref, got):
        t_ref, t_got = np.asarray(a.wrist_xfs)[:, :3, 3], np.asarray(b.wrist_xfs)[:, :3, 3]
        assert np.abs(t_ref - t_got).max() < 0.01 * np.abs(t_ref).max()
        a_ref, a_got = np.asarray(a.joint_angles), np.asarray(b.joint_angles)
        assert np.abs(a_ref - a_got).max() < 0.02 * max(np.abs(a_ref).max(), 1.0)


def _name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def test_stage_dtypes_match_the_jax_serving_model(params):
    """Each stage's dtype equals JAX's (``jax.eval_shape`` of the serving model)."""
    jm = jum.UmeTrackModel(params, JSERVING)
    (jframe, jskel), (frame, skel) = _inputs(1)
    jstate = jm.init_state(B)
    hh, ww = CFG.input_size
    j_feats = jax.eval_shape(jm.extract_features, jframe)
    j_skel = jax.eval_shape(lambda s: jm.encode_skeleton(s, B), jskel)
    j_tstate, j_tfeat = jax.eval_shape(lambda s, f, x: jm.temporal_features(s, f, x), jstate, jframe, j_feats)
    _, j_out = jax.eval_shape(jm.regress_pose_use_skeleton, jstate, jframe, jskel)
    j_bb = jax.eval_shape(
        lambda p, x: jbb.backbone_apply(p, x.astype(JSERVING.dtype), JSERVING),
        params["backbone"], jax.ShapeDtypeStruct((B * V, hh, ww, 1), jnp.float32),
    )
    want = dict(
        backbone=j_bb.dtype, features=j_feats.dtype, skeleton=j_skel.dtype,
        memory=j_tstate.mem_features.dtype, temporal_features=j_tfeat.dtype,
        joint_angles=j_out.joint_angles.dtype, wrist_xfs=j_out.wrist_xfs.dtype,
        sigmas=j_out.landmark_uncertainty_sigmas.dtype,
    )

    model = load_jax_params(jax.tree.map(np.asarray, params), SERVING, device="cpu")
    state = model.init_state(B)
    with torch.no_grad():
        bb = model.backbone(frame.left_images.reshape(B * V, 1, hh, ww).to(SERVING.dtype))
        feats = model.extract_features(frame)
        skel_feats = model.encode_skeleton(skel, B)
        tstate, tfeat = temporal_step(
            model.temporal, state, feats.permute(0, 3, 1, 2), frame.extrinsics[:, 0],
            frame.use_memory & frame.sample_mask, SERVING,
        )
        _, out = model.regress_pose_use_skeleton(state, frame, skel)
    got = dict(
        backbone=bb.dtype, features=feats.dtype, skeleton=skel_feats.dtype,
        memory=tstate.mem_features.dtype, temporal_features=tfeat.dtype,
        joint_angles=out.joint_angles.dtype, wrist_xfs=out.wrist_xfs.dtype,
        sigmas=out.landmark_uncertainty_sigmas.dtype,
    )
    assert {k: _name(v) for k, v in got.items()} == {k: str(v) for k, v in want.items()}
    assert want["features"] == jnp.bfloat16 and want["memory"] == jnp.float32


def test_serving_weights_are_bf16_where_jax_casts_them(params):
    """The trunk, fusion, ConvRNN and regressor convs hold bf16 weights (the
    JAX serving model casts its f32 weights to the activations' dtype at
    each use: the same rounding); the skeleton encoder and the wrist
    template stay f32."""
    f32 = load_jax_params(jax.tree.map(np.asarray, params), CFG, device="cpu")
    bf16 = load_jax_params(jax.tree.map(np.asarray, params), SERVING, device="cpu")
    for name, module in (("backbone", bf16.backbone), ("fusion", bf16.fusion), ("temporal", bf16.temporal),
                         ("regressor_k", bf16.regressor_k), ("regressor_u", bf16.regressor_u)):
        assert {p.dtype for p in module.parameters()} == {torch.bfloat16}, name
    assert bf16.skeleton_encoder.fc.weight.dtype == torch.float32
    assert bf16.regressor_k.template.dtype == torch.float32
    assert torch.equal(bf16.regressor_k.template, f32.regressor_k.template)
    w = np.array(params["backbone"]["stem"]["w"]).transpose(3, 2, 0, 1).copy()
    assert torch.equal(bf16.backbone.stem.weight, torch.from_numpy(w).to(torch.bfloat16))
    # the same seed gives the same weights, rounded once
    a = UmeTrackModel(CFG, device="cpu", generator=torch.Generator().manual_seed(5))
    b = UmeTrackModel(SERVING, device="cpu", generator=torch.Generator().manual_seed(5))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa.to(pb.dtype), pb), name


def test_memory_stays_f32_and_outputs_are_f32(params):
    model = load_jax_params(jax.tree.map(np.asarray, params), SERVING, device="cpu")
    state, outs = _port_run(model)
    assert state.mem_features.dtype == torch.float32 and state.prev_extrinsics.dtype == torch.float32
    assert float(state.mem_features.abs().max()) > 0  # the memory was written
    for out in outs:
        for value in out:
            if value is not None:
                assert value.dtype == torch.float32 and torch.isfinite(value).all()


def test_port_serving_against_port_f32(params):
    tree = jax.tree.map(np.asarray, params)
    _, ref = _port_run(load_jax_params(tree, CFG, device="cpu"))
    _, got = _port_run(load_jax_params(tree, SERVING, device="cpu"))
    _within_budget(ref, got)
    # the bf16 trunk was taken: it moves the outputs
    assert not torch.equal(ref[-1].joint_angles, got[-1].joint_angles)


def test_port_serving_against_jax_serving(params):
    jstate, ref = _jax_run(params, JSERVING)
    state, got = _port_run(load_jax_params(jax.tree.map(np.asarray, params), SERVING, device="cpu"))
    scale = max(float(np.abs(np.asarray(o.wrist_xfs)[:, :3, 3]).max()) for o in ref)
    for a, b in zip(ref, got):
        dt = np.abs(np.asarray(a.wrist_xfs)[:, :3, 3] - b.wrist_xfs[:, :3, 3].numpy()).max()
        assert dt < 2e-6 * scale, f"wrist translation differs by {dt} of {scale}"
        da = np.abs(np.asarray(a.joint_angles) - b.joint_angles.numpy()).max()
        assert da < 1e-5, f"joint angles differ by {da} rad"
    np.testing.assert_allclose(state.mem_features.numpy(), np.asarray(jstate.mem_features), rtol=0, atol=1e-6)


def test_serving_trackers_sample_bf16_rows():
    """Both trackers sample a bf16 model's crops with bf16 row weights: its
    crops equal an f32 model's under ``set_bf16_rows(True)`` and differ
    from its f32-row crops; the module switch stays as it was."""
    scene = chip_smoke.build_scene(seed=3, n_frames=1)
    ts = chip_smoke.torch_scene(scene, "cpu")
    opts = TrackerConfig(crop_size=CFG.input_size, src_valid_hw=chip_smoke.SRC_HW)
    cams, images = ts["cameras"], ts["frames"][0]

    def crops(model):
        single = HandTracker(model, opts)
        slots = single.crop_slots(
            cams, ts["camera_angles"], ts["hand_model"], ts["joint_angles"][0],
            ts["wrist_transforms"][0], ts["hand_confidences"][0],
        )
        a = single.make_inputs(single.init_state(), images, cams, slots).left_images
        batched = BatchedTracker(model, opts)
        one = CropSlots(*(x[None] for x in slots[:3]), slots.cameras.map(lambda x: x[None]))
        b = batched.make_inputs(batched.init_state(1), images[None], cams.map(lambda x: x[None]), one).left_images
        return a, b

    f32 = UmeTrackModel(CFG, device="cpu", generator=torch.Generator().manual_seed(0))
    bf16 = UmeTrackModel(SERVING, device="cpu", generator=torch.Generator().manual_seed(0))
    assert images.dtype == torch.uint8
    a16, b16 = crops(bf16)
    a32, _ = crops(f32)
    prev = warp_kernel.set_bf16_rows(True)
    try:
        r16, _ = crops(f32)
    finally:
        warp_kernel.set_bf16_rows(prev)
    assert a16.abs().max() > 0
    assert torch.equal(a16, b16) and torch.equal(a16, r16)
    assert not torch.equal(a16, a32)
    assert warp_kernel.set_bf16_rows(False) is False
