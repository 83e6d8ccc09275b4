"""Per-view CNN backbone: stem + ResNet stages + 1x1 projection
(port of ``absolutetrack_tpu/models/backbone.py``).

For "resnet_layers_2352-f32": stem conv 1->32 + ReLU + maxpool2 (48x48),
stages of 2/3/5/2 BasicBlocks to 256 planes at 6x6, then a 1x1 conv to
72 signed feature channels. NCHW in and out.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .config import ModelConfig
from .layers import BasicBlock, conv, max_pool_2x2


def _stage_strides(n_stages: int):
    return [1] + [2] * (n_stages - 1)


class Backbone(nn.Module):
    def __init__(self, cfg: ModelConfig, generator=None):
        super().__init__()
        blocks, f = cfg.resnet_blocks
        in_planes = [f, f, f * 2, f * 4]
        out_planes = [f, f * 2, f * 4, f * 8]
        self.stem = conv(1, f, 3, 1, generator)
        self.stages = nn.ModuleList()
        for n, cin, cout, s in zip(blocks, in_planes, out_planes, _stage_strides(len(blocks))):
            stage = [BasicBlock(cin, cout, s, generator)]
            stage += [BasicBlock(cout, cout, 1, generator) for _ in range(1, n)]
            self.stages.append(nn.Sequential(*stage))
        self.proj = conv(out_planes[-1], cfg.n_image_feature_channels, 1, 1, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(N, 1, H, W) -> (N, C, H/16, W/16)."""
        x = max_pool_2x2(F.relu(self.stem(images)))
        for stage in self.stages:
            x = stage(x)
        return self.proj(x)
