"""Pose regressor (port of ``absolutetrack_tpu/models/regressor.py``).

head = BasicBlocks -> 1x1 conv -> global average pool -> (B, n_out), split
into joint_angles (20) | wrist_xfs (7*3) | [skel_scales (1)] | sigmas (21).
The wrist is the Procrustes fit of a fixed 7-point template to the
predicted points; scales are exp(log_scale); sigmas clamp(softplus, 1e-5).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops.procrustes import procrustes_align
from .config import ModelConfig
from .layers import BasicBlock, conv


def wrist_rigid_template(n_pts: int = 7, expected_norm: float = 0.1) -> np.ndarray:
    """The canonical wrist sample points, rescaled to norm 0.1
    (reference regressor.py:19-47)."""
    pts = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, -1, 0], [-1, 0, -1], [0, -1, -1]],
        np.float64,
    )
    norms = np.linalg.norm(pts, axis=-1, keepdims=True)
    scaled = np.where(norms == 0, pts, pts / np.where(norms == 0, 1, norms) * expected_norm)
    return scaled[:n_pts].astype(np.float32)


class RegressorOutput(NamedTuple):
    joint_angles: torch.Tensor  # (B, 22)
    wrist_xfs: torch.Tensor  # (B, 4, 4)
    skel_scales: Optional[torch.Tensor] = None  # (B,)
    landmark_uncertainty_sigmas: Optional[torch.Tensor] = None  # (B, 21)


def output_dims(predict_skel_scale: bool, n_wrist_rigid_pts: int = 7):
    dims = {
        "joint_angles": 20,
        "wrist_xfs": n_wrist_rigid_pts * 3,
        "skel_scales": 1 if predict_skel_scale else 0,
        "landmark_uncertainty_sigmas": 21,
    }
    ranges, n = {}, 0
    for k, v in dims.items():
        if v:
            ranges[k] = (n, n + v)
            n += v
    return ranges, n


class Regressor(nn.Module):
    def __init__(self, cfg: ModelConfig, use_skel: bool, predict_skel_scale: bool, generator=None):
        super().__init__()
        self.cfg = cfg
        self.predict_skel_scale = predict_skel_scale
        c_in = cfg.n_image_feature_channels + (cfg.n_skeleton_feature_channels if use_skel else 0)
        _, n_out = output_dims(predict_skel_scale, cfg.n_wrist_rigid_pts)
        self.blocks = nn.Sequential(
            *(BasicBlock(c_in, c_in, 1, generator) for _ in range(cfg.n_pose_regression_blocks))
        )
        self.out = conv(c_in, n_out, 1, 1, generator)
        self.register_buffer(
            "template", torch.from_numpy(wrist_rigid_template(cfg.n_wrist_rigid_pts)), persistent=False
        )

    def forward(self, features: torch.Tensor) -> RegressorOutput:
        """(B, C, h, w) -> decoded outputs (pool and decoders in f32, or
        wider: a float64 model decodes in float64)."""
        x = self.out(self.blocks(features))
        pose = torch.mean(x.to(torch.promote_types(x.dtype, torch.float32)), dim=(2, 3))
        ranges, _ = output_dims(self.predict_skel_scale, self.cfg.n_wrist_rigid_pts)
        b = pose.shape[0]

        r = ranges["joint_angles"]
        joint_angles = torch.cat([pose[:, r[0]:r[1]], pose.new_zeros((b, 2))], dim=-1)

        r = ranges["wrist_xfs"]
        pred_pts = pose[:, r[0]:r[1]].reshape(b, -1, 3)
        wrist_xfs = procrustes_align(self.template.expand((b,) + self.template.shape), pred_pts)

        skel_scales = None
        if self.predict_skel_scale:
            skel_scales = torch.exp(pose[:, ranges["skel_scales"][0]])

        r = ranges["landmark_uncertainty_sigmas"]
        sigmas = torch.clamp(F.softplus(pose[:, r[0]:r[1]]), min=1e-5)
        return RegressorOutput(joint_angles, wrist_xfs, skel_scales, sigmas)
