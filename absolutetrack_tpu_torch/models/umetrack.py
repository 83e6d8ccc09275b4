"""Top-level UmeTrack model (port of ``absolutetrack_tpu/models/umetrack.py``).

Fixed-capacity inputs (B samples x V=2 view slots) with a view mask; the
known-skeleton branch concatenates encoded skeleton features, the
unknown-skeleton branch predicts a skeleton scale; wrists are recovered
in world space with the right-hand x mirror; the temporal memory is an
explicit ``TemporalState`` carried by the caller.

Public methods keep the JAX package's layouts (crops (B, V, H, W),
features (B, h, w, C)); the modules inside run NCHW.

``ModelConfig.serving()`` (``compute_dtype="bfloat16"``) follows the JAX
package's dtype flow: the crops enter the trunk in bf16 and every conv
module of the trunk, the ConvRNN and the regressors holds its weights in
bf16 (JAX casts its f32 weights to the activation dtype at each use, the
same rounding); the FTL casts its transforms to the features' dtype; the
ConvRNN carries f32 memory; the skeleton encoder stays f32 and its
features are cast to bf16 where they join; the regressor pools and
decodes in f32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..geometry.affine import rigid_inverse
from ..utils.runtime import resolve_device
from .backbone import Backbone
from .config import ModelConfig
from .fusion import Fusion, compute_singlev_xfs, fuse_views
from .regressor import Regressor, RegressorOutput
from .skeleton_encoder import SkeletonEncoder
from .temporal import Temporal, TemporalState, init_temporal_state, temporal_step


class FrameInputs(NamedTuple):
    """One frame of network input for B tracked-hand samples.

    left_images : (B, V, H, W) normalized [0,1] mono crops
    intrinsics  : (B, V, 3, 3) crop-camera intrinsics
    extrinsics  : (B, V, 4, 4) crop-camera world->eye, translation in meters
    view_mask   : (B, V) bool; valid views compacted to the front
    hand_idx    : (B,) 0 = left, 1 = right
    use_memory  : (B,) bool
    sample_mask : (B,) bool
    """

    left_images: torch.Tensor
    intrinsics: torch.Tensor
    extrinsics: torch.Tensor
    view_mask: torch.Tensor
    hand_idx: torch.Tensor
    use_memory: torch.Tensor
    sample_mask: torch.Tensor


class SkeletonInputs(NamedTuple):
    """Known-skeleton conditioning in meters, (B or 1, 22, 3) each."""

    joint_rotation_axes: torch.Tensor
    joint_rest_positions: torch.Tensor


def _recover_wrist_in_world(hand_idx, cam0_extrinsics, wrist_in_cam0):
    """inv(cam0) @ wrist, then mirror the x column for right hands."""
    world = torch.matmul(rigid_inverse(cam0_extrinsics), wrist_in_cam0)
    sign = torch.where(hand_idx == 1, -1.0, 1.0).to(world.dtype)
    world[..., :, 0] = world[..., :, 0] * sign[..., None]
    return world


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class UmeTrackModel(nn.Module):
    """The network, with weights from a seeded He-normal init.

    Weights are drawn on the CPU from ``generator`` (seed 0 when omitted),
    so one seed gives the same model on every device, and then moved to
    ``device`` (``cuda`` unless given).
    """

    def __init__(
        self,
        cfg: ModelConfig = ModelConfig(),
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.backbone = Backbone(cfg, generator)
        self.fusion = Fusion(cfg, generator)
        self.temporal = Temporal(cfg, generator)
        self.skeleton_encoder = SkeletonEncoder(cfg, generator)
        self.regressor_k = Regressor(cfg, use_skel=True, predict_skel_scale=False, generator=generator)
        self.regressor_u = Regressor(cfg, use_skel=False, predict_skel_scale=True, generator=generator)
        for module in (self.backbone, self.fusion, self.temporal, self.regressor_k, self.regressor_u):
            for p in module.parameters():  # buffers (the wrist template) stay f32
                p.data = p.data.to(cfg.dtype)
        self.requires_grad_(False)
        self.eval()
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.backbone.stem.weight.device

    def init_state(self, batch: int) -> TemporalState:
        return init_temporal_state(batch, self.cfg, self.device)

    # -- NCHW internals ---------------------------------------------------

    def _trunk(self, frame: FrameInputs, view_shard=None) -> torch.Tensor:
        """Backbone + FTL fusion -> (B, C, h, w) cam0-space features.

        With ``view_shard`` (a ``parallel.Mesh`` whose model axis is > 1)
        the backbone runs on this rank's views only and the features of
        all views are gathered before the fusion."""
        images = frame.left_images if view_shard is None else view_shard.local_views(frame.left_images)
        b, v, hh, ww = images.shape
        # the crops enter in the trunk's weight type: cfg.dtype (a float64
        # copy of the model runs in float64)
        feats = self.backbone(images.reshape(b * v, 1, hh, ww).to(self.backbone.stem.weight.dtype))
        feats = feats.reshape((b, v) + feats.shape[1:])
        if view_shard is not None:
            feats = view_shard.gather_views(feats)
        singlev_xfs = compute_singlev_xfs(frame.intrinsics, self.cfg.canonical_focal_length)
        return fuse_views(self.fusion, feats, singlev_xfs, frame.extrinsics, frame.view_mask, self.cfg)

    def _skeleton(self, skeleton: SkeletonInputs, batch: int) -> torch.Tensor:
        skel = self.skeleton_encoder(skeleton.joint_rotation_axes, skeleton.joint_rest_positions)
        if skel.shape[0] == 1 and batch > 1:
            skel = skel.expand((batch,) + skel.shape[1:])
        return skel

    def _regress(self, state, frame, img_features, skel_features):
        state, tfeat = temporal_step(
            self.temporal,
            state,
            img_features,
            frame.extrinsics[:, 0],
            frame.use_memory & frame.sample_mask,
            self.cfg,
        )
        if skel_features is not None:
            x = torch.cat([tfeat, skel_features.to(tfeat.dtype)], dim=1)
            out = self.regressor_k(x)
        else:
            out = self.regressor_u(tfeat)
        wrist = _recover_wrist_in_world(frame.hand_idx, frame.extrinsics[:, 0], out.wrist_xfs)
        return state, out._replace(wrist_xfs=wrist)

    # -- public, JAX layouts ----------------------------------------------

    def extract_features(self, frame: FrameInputs) -> torch.Tensor:
        """Backbone + FTL fusion -> (B, h, w, C) cam0-space features."""
        return _nhwc(self._trunk(frame))

    def encode_skeleton(self, skeleton: SkeletonInputs, batch: int) -> torch.Tensor:
        """Skeleton features (batch, h, w, C) broadcast to ``batch`` samples."""
        return _nhwc(self._skeleton(skeleton, batch))

    def regress_from_features(
        self,
        state: TemporalState,
        frame: FrameInputs,
        img_features: torch.Tensor,  # (B, h, w, C)
        skel_features: Optional[torch.Tensor] = None,  # (B, h, w, C_skel)
    ) -> Tuple[TemporalState, RegressorOutput]:
        """Temporal fusion + regression head from precomputed trunk features."""
        skel = None if skel_features is None else _nchw(skel_features)
        return self._regress(state, frame, _nchw(img_features), skel)

    def regress_pose_use_skeleton(
        self, state: TemporalState, frame: FrameInputs, skeleton: SkeletonInputs, view_shard=None
    ) -> Tuple[TemporalState, RegressorOutput]:
        """Known-skeleton branch (reference umetrack_model.py:188-219);
        ``view_shard`` as in ``_trunk``."""
        feats = self._trunk(frame, view_shard)
        return self._regress(state, frame, feats, self._skeleton(skeleton, feats.shape[0]))

    def regress_pose_pred_skel_scale(
        self, state: TemporalState, frame: FrameInputs, view_shard=None
    ) -> Tuple[TemporalState, RegressorOutput]:
        """Unknown-skeleton branch (reference umetrack_model.py:221-242);
        ``view_shard`` as in ``_trunk``."""
        return self._regress(state, frame, self._trunk(frame, view_shard), None)
