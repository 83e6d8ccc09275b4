"""Temporal ConvRNN with explicit state (port of ``absolutetrack_tpu/models/temporal.py``).

state: mem_features (B, h, w, M) channels-last as in the JAX package,
prev_extrinsics (B, 4, 4). Memory is FTL-re-anchored by
cur_cam0 @ inv(prev_cam0) where used and zeroed where not; the cell is
concat(mem, img) -> 1x1 convs (ReLU between) -> split (new_mem, fused).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..geometry.affine import rigid_inverse
from .config import ModelConfig
from .ftl import apply_ftl
from .layers import conv


class TemporalState(NamedTuple):
    mem_features: torch.Tensor  # (B, h, w, M)
    prev_extrinsics: torch.Tensor  # (B, 4, 4) cam0 world->eye at previous step


def init_temporal_state(batch: int, cfg: ModelConfig, device=None) -> TemporalState:
    h, w = cfg.feature_size
    return TemporalState(
        mem_features=torch.zeros((batch, h, w, cfg.n_temporal_memory_channels), device=device),
        prev_extrinsics=torch.zeros((batch, 4, 4), device=device),
    )


class Temporal(nn.Module):
    def __init__(self, cfg: ModelConfig, generator=None):
        super().__init__()
        nc = cfg.n_image_feature_channels + cfg.n_temporal_memory_channels
        self.blocks = nn.ModuleList(
            conv(nc, nc, 1, 1, generator) for _ in range(cfg.n_temporal_blocks)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.blocks) - 1
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i != last:
                x = F.relu(x)
        return x


def temporal_step(
    temporal: Temporal,
    state: TemporalState,
    img_features: torch.Tensor,  # (B, C, h, w)
    cur_extrinsics: torch.Tensor,  # (B, 4, 4) cam0 world->eye
    use_memory: torch.Tensor,  # (B,) bool
    cfg: ModelConfig,
) -> Tuple[TemporalState, torch.Tensor]:
    """One recurrent step -> (new_state, fused features (B, C, h, w))."""
    m = cfg.n_temporal_memory_channels
    use4 = use_memory[:, None, None, None]
    use3 = use_memory[:, None, None]

    # zero unused slots before the transform (reference temporal.py:59-63)
    mem = torch.where(use4, state.mem_features, 0.0).permute(0, 3, 1, 2)
    mem = mem.to(img_features.dtype)
    prev_ext = torch.where(use3, state.prev_extrinsics, 0.0)
    # unused slots have a singular prev_ext: feed identity, mask the result
    eye = torch.eye(4, dtype=prev_ext.dtype, device=prev_ext.device)
    safe_prev = torch.where(use3, prev_ext, eye)
    rel = torch.matmul(cur_extrinsics, rigid_inverse(safe_prev))
    mem_xfed = torch.where(use4, apply_ftl(rel, mem, cfg.temporal_ftl_ratio), 0.0)

    x = temporal(torch.cat([mem_xfed, img_features], dim=1))
    new_state = TemporalState(
        mem_features=x[:, :m].permute(0, 2, 3, 1).to(state.mem_features.dtype),
        prev_extrinsics=cur_extrinsics,
    )
    return new_state, x[:, m:]
