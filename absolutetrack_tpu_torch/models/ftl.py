"""Feature Transform Layer (port of ``absolutetrack_tpu/models/ftl.py``).

The first round(C*r) channels split into three groups that act as the
X/Y/Z coordinates of C'/3 * H * W feature points, in NCHW element order:
point ``k`` of axis ``a`` is channel ``a*C'/3 + k//(H*W)`` at spatial
position ``k % (H*W)`` (reference ``apply_ftl_to_feature_maps``,
lib/models/model_utils.py:57-104). The port runs NCHW, so that order is
a plain reshape; the JAX package transposes its NHWC activations to get it.
"""

from __future__ import annotations

import torch


def apply_ftl(
    xfs: torch.Tensor,  # (N, 4, 4)
    feature_maps: torch.Tensor,  # (N, C, H, W)
    ftl_ratio: float = 1.0,
) -> torch.Tensor:
    """R x + t on the feature points of (N, C, H, W) maps."""
    if not 0.0 <= ftl_ratio <= 1.0:
        raise ValueError(f"ftl_ratio {ftl_ratio} outside [0, 1]")
    if ftl_ratio == 0.0:
        return feature_maps
    n, c, h, w = feature_maps.shape
    nc_ftl = int(round(c * ftl_ratio))
    if nc_ftl % 3:
        raise ValueError(f"{nc_ftl} FTL channels do not split into x/y/z")

    pts = feature_maps[:, :nc_ftl].reshape(n, 3, (nc_ftl // 3) * h * w)
    r = xfs[:, :3, :3].to(feature_maps.dtype)
    t = xfs[:, :3, 3].to(feature_maps.dtype)
    x = (torch.matmul(r, pts) + t[..., None]).reshape(n, nc_ftl, h, w)
    if nc_ftl != c:
        return torch.cat([x, feature_maps[:, nc_ftl:]], dim=1)
    return x
