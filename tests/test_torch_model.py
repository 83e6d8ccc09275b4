"""Port parity: the UmeTrack network module by module, with the JAX weights carried across.

``init_umetrack_params`` draws the JAX weights for ``ModelConfig.tiny()``;
``load_jax_params`` loads the same numbers into the port. The regression
heads are scaled by 0.02 and the ConvRNN by 0.1 before either package sees
them, as ``tests/test_pipelined.py`` does: at raw random init the heads'
outputs are ~+-40, which makes the Procrustes decode ill-conditioned, and
the memory loop has a spectral radius above 1, so reduction-order noise
would be amplified past any fixed tolerance.

Tolerances follow ``tests/test_full_model_parity.py:308-323``: joint angles
2e-4, wrist 5e-4, memory 2e-4, sigmas 1e-4. Trunk features and single
modules hold to 1e-4 (f32 convolutions summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from absolutetrack_tpu.models import backbone as jbb
from absolutetrack_tpu.models import ftl as jftl
from absolutetrack_tpu.models import fusion as jfu
from absolutetrack_tpu.models import regressor as jreg
from absolutetrack_tpu.models import skeleton_encoder as jse
from absolutetrack_tpu.models import temporal as jtm
from absolutetrack_tpu.models import umetrack as jum
from absolutetrack_tpu.models.config import ModelConfig as JConfig
from absolutetrack_tpu.ops import procrustes as jpr
from absolutetrack_tpu_torch.models import layers
from absolutetrack_tpu_torch.models.config import ModelConfig
from absolutetrack_tpu_torch.models.ftl import apply_ftl
from absolutetrack_tpu_torch.models.fusion import compute_singlev_xfs, fuse_views
from absolutetrack_tpu_torch.models.params import load_jax_params
from absolutetrack_tpu_torch.models.temporal import TemporalState, temporal_step
from absolutetrack_tpu_torch.models.umetrack import FrameInputs, SkeletonInputs, UmeTrackModel
from absolutetrack_tpu_torch.ops import procrustes as pr

jax.config.update("jax_platforms", "cpu")

CFG = ModelConfig.tiny()
JCFG = JConfig.tiny()
B, V = 2, 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(j, t, atol, **kw):
    np.testing.assert_allclose(np.asarray(j), t.detach().numpy(), atol=atol, rtol=0, **kw)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _rigid(rng, shape):
    """Random rigid world->eye transforms, translations in meters."""
    n = int(np.prod(shape))
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    q *= np.sign(np.linalg.det(q))[:, None, None]
    m = np.tile(np.eye(4), (n, 1, 1))
    m[:, :3, :3] = q
    m[:, :3, 3] = rng.uniform(-0.3, 0.3, (n, 3))
    return m.reshape(tuple(shape) + (4, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def twin():
    params = jum.init_umetrack_params(jax.random.PRNGKey(0), JCFG)
    for reg in ("regressor_k", "regressor_u"):
        params[reg]["out"] = jax.tree.map(lambda x: x * 0.02, params[reg]["out"])
    params["temporal"] = jax.tree.map(lambda x: x * 0.1, params["temporal"])
    tree = jax.tree.map(np.asarray, params)
    return params, load_jax_params(tree, CFG, device="cpu")


def _frame(rng, view_mask, use_memory, hand_idx=(0, 1)):
    hh, ww = CFG.input_size
    images = rng.uniform(0, 1, (B, V, hh, ww)).astype(np.float32) * view_mask[:, :, None, None]
    intr = np.tile(np.eye(3, dtype=np.float32), (B, V, 1, 1))
    intr[..., 0, 0] = intr[..., 1, 1] = rng.uniform(150, 350, (B, V))
    intr[..., 0, 2] = intr[..., 1, 2] = (hh - 1) / 2
    fields = dict(
        left_images=images, intrinsics=intr, extrinsics=_rigid(rng, (B, V)),
        view_mask=np.asarray(view_mask), hand_idx=np.asarray(hand_idx),
        use_memory=np.asarray(use_memory), sample_mask=np.ones(B, bool),
    )
    return (
        jum.FrameInputs(**{k: jnp.asarray(v) for k, v in fields.items()}),
        FrameInputs(**{k: _t(v) for k, v in fields.items()}),
    )


def _skeleton(rng):
    axes = rng.standard_normal((1, 22, 3)).astype(np.float32) * 0.3
    rest = rng.standard_normal((1, 22, 3)).astype(np.float32) * 0.02
    return jum.SkeletonInputs(jnp.asarray(axes), jnp.asarray(rest)), SkeletonInputs(_t(axes), _t(rest))


class TestLayers:
    def test_seeded_init_is_deterministic_he_normal(self):
        a = UmeTrackModel(CFG, device="cpu", generator=torch.Generator().manual_seed(3))
        b = UmeTrackModel(CFG, device="cpu", generator=torch.Generator().manual_seed(3))
        c = UmeTrackModel(CFG, device="cpu", generator=torch.Generator().manual_seed(4))
        for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(pa, pb), name
        assert not torch.equal(a.backbone.stem.weight, c.backbone.stem.weight)
        w = a.backbone.stages[2][0].conv1.weight  # 3x3, 32 -> 64 at tiny width
        cout, _, kh, kw = w.shape
        assert abs(float(w.std()) / (2.0 / (kh * kw * cout)) ** 0.5 - 1) < 0.05
        assert float(a.backbone.stem.bias.abs().max()) == 0.0
        assert a.device.type == "cpu" and not any(p.requires_grad for p in a.parameters())

    def test_set_conv_precision_maps_to_tf32_flags(self):
        saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        try:
            layers.set_conv_precision("highest")
            assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
            layers.set_conv_precision("high")
            assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
            for name in ("default", "bf16"):
                with pytest.raises(ValueError):
                    layers.set_conv_precision(name)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved

    def test_load_rejects_a_tree_of_another_width(self, twin):
        params, _ = twin
        with pytest.raises(ValueError, match="shape"):
            load_jax_params(jax.tree.map(np.asarray, params), ModelConfig.tiny(n_image_feature_channels=27), device="cpu")

    def test_entry_points_need_a_card_unless_cpu_is_asked(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            UmeTrackModel(CFG)


class TestModules:
    def test_backbone(self, twin):
        params, model = twin
        rng = np.random.default_rng(0)
        x = rng.uniform(0, 1, (3, 32, 32, 1)).astype(np.float32)
        j = jbb.backbone_apply(params["backbone"], jnp.asarray(x), JCFG)
        t = model.backbone(_nchw(x))
        assert t.shape == (3, CFG.n_image_feature_channels, 2, 2)
        _close(np.moveaxis(np.asarray(j), -1, 1), t, 1e-4)

    @pytest.mark.parametrize("ratio", [1.0, 0.5])
    def test_ftl_keeps_nchw_element_order(self, ratio):
        rng = np.random.default_rng(1)
        feats = rng.standard_normal((3, 4, 5, 24)).astype(np.float32)
        xfs = _rigid(rng, (3,))
        j = jftl.apply_ftl(jnp.asarray(xfs), jnp.asarray(feats), ratio)
        t = apply_ftl(_t(xfs), _nchw(feats), ratio)
        _close(np.moveaxis(np.asarray(j), -1, 1), t, 1e-5)

    def test_fusion_single_and_multi_view(self, twin):
        params, model = twin
        rng = np.random.default_rng(2)
        c = CFG.n_image_feature_channels
        feats = rng.standard_normal((3, V, 2, 2, c)).astype(np.float32)
        intr = np.tile(np.eye(3, dtype=np.float32), (3, V, 1, 1))
        intr[..., 0, 0] = rng.uniform(150, 350, (3, V))
        extr = _rigid(rng, (3, V))
        mask = np.array([[True, True], [True, False], [True, True]])
        jx = jfu.compute_singlev_xfs(jnp.asarray(intr))
        tx = compute_singlev_xfs(_t(intr))
        _close(jx, tx, 1e-6)
        j = jfu.fuse_views(params["fusion"], jnp.asarray(feats), jx, jnp.asarray(extr), jnp.asarray(mask), JCFG)
        t = fuse_views(model.fusion, _t(np.moveaxis(feats, -1, 2)), tx, _t(extr), _t(mask), CFG)
        _close(np.moveaxis(np.asarray(j), -1, 1), t, 1e-4)

    def test_temporal_step_reanchors_and_zeroes(self, twin):
        params, model = twin
        rng = np.random.default_rng(3)
        m, c = CFG.n_temporal_memory_channels, CFG.n_image_feature_channels
        mem = rng.standard_normal((3, 2, 2, m)).astype(np.float32)
        prev = _rigid(rng, (3,))
        cur = _rigid(rng, (3,))
        img = rng.standard_normal((3, 2, 2, c)).astype(np.float32)
        use = np.array([True, False, True])
        js, jf = jtm.temporal_step(
            params["temporal"], jtm.TemporalState(jnp.asarray(mem), jnp.asarray(prev)),
            jnp.asarray(img), jnp.asarray(cur), jnp.asarray(use), JCFG,
        )
        ts, tf = temporal_step(model.temporal, TemporalState(_t(mem), _t(prev)), _nchw(img), _t(cur), _t(use), CFG)
        _close(js.mem_features, ts.mem_features, 2e-4)
        _close(js.prev_extrinsics, ts.prev_extrinsics, 0.0)
        _close(np.moveaxis(np.asarray(jf), -1, 1), tf, 1e-4)

    def test_skeleton_encoder(self, twin):
        params, model = twin
        rng = np.random.default_rng(4)
        axes = rng.standard_normal((3, 22, 3)).astype(np.float32)
        rest = 0.02 * rng.standard_normal((3, 22, 3)).astype(np.float32)
        j = jse.skeleton_encoder_apply(params["skeleton_encoder"], jnp.asarray(axes), jnp.asarray(rest), JCFG)
        t = model.skeleton_encoder(_t(axes), _t(rest))
        _close(np.moveaxis(np.asarray(j), -1, 1), t, 1e-5)

    @pytest.mark.parametrize("head, skel_scale", [("regressor_k", False), ("regressor_u", True)])
    def test_regressor(self, twin, head, skel_scale):
        params, model = twin
        rng = np.random.default_rng(5)
        c = getattr(model, head).blocks[0].conv1.in_channels
        feats = rng.standard_normal((3, 2, 2, c)).astype(np.float32)
        j = jreg.regress_poses(params[head], jnp.asarray(feats), JCFG, skel_scale)
        t = getattr(model, head)(_nchw(feats))
        _close(j.joint_angles, t.joint_angles, 2e-4)
        _close(j.wrist_xfs, t.wrist_xfs, 5e-4)
        _close(j.landmark_uncertainty_sigmas, t.landmark_uncertainty_sigmas, 1e-4)
        assert (j.skel_scales is None) == (t.skel_scales is None)
        if skel_scale:
            _close(j.skel_scales, t.skel_scales, 1e-4)


class TestProcrustes:
    @pytest.mark.parametrize("method", ["quat", "svd"])
    def test_matches_jax_and_recovers_the_transform(self, method):
        rng = np.random.default_rng(6)
        src = rng.standard_normal((16, 7, 3)).astype(np.float32) * 0.1
        xf = _rigid(rng, (16,))
        dst = np.einsum("bij,bnj->bni", xf[:, :3, :3], src) + xf[:, None, :3, 3]
        dst = (dst + 1e-4 * rng.standard_normal(dst.shape)).astype(np.float32)
        j = jpr.procrustes_align(jnp.asarray(src), jnp.asarray(dst), method=method)
        t = pr.procrustes_align(_t(src), _t(dst), method=method)
        _close(j, t, 1e-4)
        _close(xf, t, 5e-3)
        assert torch.allclose(torch.linalg.det(t[:, :3, :3]), torch.ones(16), atol=1e-5)

    def test_degenerate_input_falls_back_to_identity_rotation(self):
        pts = torch.zeros((2, 7, 3))
        out = pr.procrustes_align(pts, pts)
        assert torch.equal(out, torch.eye(4).expand(2, 4, 4))


class TestUmeTrack:
    def test_known_skeleton_sequence_with_revival(self, twin):
        """Four frames; hand 1 loses track at t=2 and its memory revives zeroed."""
        params, model = twin
        rng = np.random.default_rng(7)
        jm = jum.UmeTrackModel(params, JCFG)
        jskel, tskel = _skeleton(rng)
        use = [[False, False], [True, True], [True, False], [True, True]]
        js, ts = jm.init_state(B), model.init_state(B)
        step = jax.jit(jm.regress_pose_use_skeleton)
        for t_i, use_memory in enumerate(use):
            jf, tf = _frame(rng, np.ones((B, V), bool), use_memory)
            js, jo = step(js, jf, jskel)
            ts, to = model.regress_pose_use_skeleton(ts, tf, tskel)
            msg = f"frame {t_i}"
            _close(jo.joint_angles, to.joint_angles, 2e-4, err_msg=msg)
            _close(jo.wrist_xfs, to.wrist_xfs, 5e-4, err_msg=msg)
            _close(jo.landmark_uncertainty_sigmas, to.landmark_uncertainty_sigmas, 1e-4, err_msg=msg)
            _close(js.mem_features, ts.mem_features, 2e-4, err_msg=msg)
            _close(js.prev_extrinsics, ts.prev_extrinsics, 0.0, err_msg=msg)

    def test_unknown_skeleton_and_public_layouts(self, twin):
        params, model = twin
        rng = np.random.default_rng(8)
        jm = jum.UmeTrackModel(params, JCFG)
        jf, tf = _frame(rng, np.array([[True, True], [True, False]]), [False, False])
        js, jo = jm.regress_pose_pred_skel_scale(jm.init_state(B), jf)
        ts, to = model.regress_pose_pred_skel_scale(model.init_state(B), tf)
        _close(jo.joint_angles, to.joint_angles, 2e-4)
        _close(jo.wrist_xfs, to.wrist_xfs, 5e-4)
        _close(jo.skel_scales, to.skel_scales, 1e-4)
        _close(js.mem_features, ts.mem_features, 2e-4)
        # the public pieces keep the JAX package's (B, h, w, C) layout
        jfeat = jm.extract_features(jf)
        tfeat = model.extract_features(tf)
        assert tuple(tfeat.shape) == tuple(jfeat.shape)
        _close(jfeat, tfeat, 1e-4)
        jskel, tskel = _skeleton(rng)
        jsk = jm.encode_skeleton(jskel, B)
        tsk = model.encode_skeleton(tskel, B)
        assert tuple(tsk.shape) == tuple(jsk.shape)
        _close(jsk, tsk, 1e-5)
        _, jo2 = jm.regress_from_features(jm.init_state(B), jf, jfeat, jsk)
        _, to2 = model.regress_from_features(model.init_state(B), tf, tfeat, tsk)
        _close(jo2.joint_angles, to2.joint_angles, 2e-4)
        _close(jo2.wrist_xfs, to2.wrist_xfs, 5e-4)
