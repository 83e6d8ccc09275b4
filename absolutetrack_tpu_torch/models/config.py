"""Architecture hyperparameters (port of ``absolutetrack_tpu/models/config.py``)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture configuration."""

    # backbone: "resnet_layers_<blocks>-f<start_planes>"
    network: str = "resnet_layers_2352-f32"
    n_image_feature_channels: int = 72
    n_skeleton_feature_channels: int = 4
    n_temporal_memory_channels: int = 18
    use_unscaled_as_canonical: bool = False
    n_multi_view_fusion_blocks: int = 2
    n_temporal_blocks: int = 3
    n_pose_regression_blocks: int = 2
    spatial_ftl_ratio: float = 1.0
    temporal_ftl_ratio: float = 1.0
    n_wrist_rigid_pts: int = 7
    input_size: Tuple[int, int] = (96, 96)
    canonical_focal_length: float = 200.0
    num_views: int = 2
    # "float32" (parity) or "bfloat16" (the serving preset: bf16 conv trunk,
    # f32 geometry, memory, pooling and decode)
    compute_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    @classmethod
    def serving(cls, **overrides) -> "ModelConfig":
        """The fast-serving preset: bf16 conv trunk."""
        return cls(compute_dtype="bfloat16", **overrides)

    @classmethod
    def tiny(cls, **overrides) -> "ModelConfig":
        """Full topology at reduced width with 32x32 crops (fast CPU tests)."""
        defaults = dict(
            network="resnet_layers_1111-f16",
            n_image_feature_channels=24,
            n_temporal_memory_channels=6,
            input_size=(32, 32),
        )
        defaults.update(overrides)
        return cls(**defaults)

    @property
    def feature_size(self) -> Tuple[int, int]:
        # stem maxpool /2 then three stride-2 stages => /16 overall
        return (self.input_size[0] // 16, self.input_size[1] // 16)

    @property
    def resnet_blocks(self):
        arch, planes = self.network.split("-f")
        digits = arch.removeprefix("resnet_layers_")
        if len(digits) != 4:
            raise ValueError(f"unsupported network {self.network!r}")
        return tuple(int(c) for c in digits), int(planes)
