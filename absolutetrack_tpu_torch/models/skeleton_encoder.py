"""Skeleton encoder (port of ``absolutetrack_tpu/models/skeleton_encoder.py``):
concat(axes, rest positions) (B, 132) -> Linear -> view (B, 4, h, w) -> ReLU
(BN folded into the linear layer)."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .config import ModelConfig
from .layers import linear


class SkeletonEncoder(nn.Module):
    def __init__(self, cfg: ModelConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        h, w = cfg.feature_size
        self.fc = linear(22 * 6, cfg.n_skeleton_feature_channels * h * w, generator)

    def forward(self, joint_rotation_axes: torch.Tensor, joint_rest_positions: torch.Tensor):
        """(B, 22, 3) x 2 -> (B, n_skeleton_feature_channels, h, w)."""
        h, w = self.cfg.feature_size
        b = joint_rotation_axes.shape[0]
        feats = torch.cat([joint_rotation_axes, joint_rest_positions], dim=-1)
        x = F.relu(self.fc(feats.reshape(b, -1)))
        return x.reshape(b, self.cfg.n_skeleton_feature_channels, h, w)
