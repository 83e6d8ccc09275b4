"""Multi-view feature fusion in a canonical camera space
(port of ``absolutetrack_tpu/models/fusion.py``).

Each view's features are FTL-transformed into the canonical space (cam0's
scaled space), concatenated along channels, fused by 1x1 convs and
transformed to cam0 space. Samples with only view 0 valid take the
single-view path; both paths run dense and are selected per sample.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..geometry.affine import rigid_inverse
from .config import ModelConfig
from .ftl import apply_ftl
from .layers import conv


class Fusion(nn.Module):
    def __init__(self, cfg: ModelConfig, generator=None):
        super().__init__()
        c = cfg.n_image_feature_channels
        nc = np.linspace(c * cfg.num_views, c, cfg.n_multi_view_fusion_blocks + 1)
        self.blocks = nn.ModuleList(
            conv(int(nc[i]), int(nc[i + 1]), 1, 1, generator)
            for i in range(cfg.n_multi_view_fusion_blocks)
        )
        self.final = conv(c, c, 1, 1, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = F.relu(block(x))
        return self.final(x)


def compute_singlev_xfs(intrinsics: torch.Tensor, canonical_focal_length: float = 200.0):
    """(..., 4, 4) identity with S[2,2] = fx / canonical_f."""
    s = torch.eye(4, dtype=intrinsics.dtype, device=intrinsics.device)
    s = s.expand(intrinsics.shape[:-2] + (4, 4)).clone()
    s[..., 2, 2] = intrinsics[..., 0, 0] / canonical_focal_length
    return s


def _scale_inverse(s: torch.Tensor) -> torch.Tensor:
    out = s.clone()
    out[..., 2, 2] = 1.0 / s[..., 2, 2]
    return out


def compute_multiv_xfs(
    singlev_xfs: torch.Tensor,  # (B, V, 4, 4)
    extrinsics: torch.Tensor,  # (B, V, 4, 4) world->eye
    use_unscaled_as_canonical: bool = False,
):
    """Per-view scaled->canonical transforms and canonical->cam0 transform."""
    xf_0 = extrinsics[:, 0:1]
    xf_to_world = torch.matmul(rigid_inverse(extrinsics), singlev_xfs)
    if use_unscaled_as_canonical:
        b = singlev_xfs.shape[0]
        canonical_to_cam0 = torch.eye(4, dtype=singlev_xfs.dtype, device=singlev_xfs.device)
        canonical_to_cam0 = canonical_to_cam0.expand(b, 4, 4)
        scaled_to_canonical = torch.matmul(xf_0, xf_to_world)
    else:
        canonical_to_cam0 = singlev_xfs[:, 0]
        s0_inv = _scale_inverse(singlev_xfs[:, 0:1])
        scaled_to_canonical = torch.matmul(s0_inv, torch.matmul(xf_0, xf_to_world))
    return scaled_to_canonical, canonical_to_cam0


def fuse_views(
    fusion: Fusion,
    per_view_features: torch.Tensor,  # (B, V, C, h, w)
    singlev_xfs: torch.Tensor,  # (B, V, 4, 4)
    extrinsics: torch.Tensor,  # (B, V, 4, 4)
    view_mask: torch.Tensor,  # (B, V) bool
    cfg: ModelConfig,
) -> torch.Tensor:
    """Fused cam0-space features (B, C, h, w), single/multi-view masked."""
    b, v, c, h, w = per_view_features.shape
    if v != 2 or cfg.num_views != 2:
        raise ValueError("fusion assumes 2 view slots")

    scaled_to_canonical, canonical_to_cam0 = compute_multiv_xfs(
        singlev_xfs, extrinsics, cfg.use_unscaled_as_canonical
    )
    canon = apply_ftl(
        scaled_to_canonical.reshape(b * v, 4, 4),
        per_view_features.reshape(b * v, c, h, w),
        cfg.spatial_ftl_ratio,
    ).reshape(b, v, c, h, w)
    canon = torch.where(view_mask[:, :, None, None, None], canon, 0.0)
    # [view0 | view1] along channels, as torch flatten(1, 2) orders them
    fused = fusion(canon.reshape(b, v * c, h, w))
    multiv = apply_ftl(canonical_to_cam0, fused, cfg.spatial_ftl_ratio)

    singlev = apply_ftl(singlev_xfs[:, 0], per_view_features[:, 0], cfg.spatial_ftl_ratio)

    is_multi = view_mask[:, 1] & view_mask[:, 0]
    return torch.where(is_multi[:, None, None, None], multiv, singlev)
