"""Fisheye->pinhole crop extraction (port of ``absolutetrack_tpu/ops/resample.py``).

Coordinates come from vectorized camera math as separate x/y planes;
sampling goes through ``warp_kernel.bilinear_sample`` (K1 on the card,
the plain version on the CPU). ``compute_resample_matrix`` and
``warp_homography`` serve the data layer and wait for it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..geometry import camera as cam
from .warp_kernel import bilinear_sample, bilinear_sample_plain, split_coord_planes

__all__ = [
    "bilinear_sample",
    "bilinear_sample_plain",
    "split_coord_planes",
    "warp_perspective_crop",
]


def _crop_source_coords_planar(
    src_cameras: cam.Camera,  # batch (N,)
    crop_cameras: cam.Camera,  # batch (N,) pinhole
    crop_size: Tuple[int, int],
    src_kind: str,
    depth_check: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source-window coordinate planes (x, y), each (N, P = h*w), row-major
    over the crop: unproject through the crop camera, to world, into the
    source camera's eye space, project and distort."""
    w, h = crop_size
    device = crop_cameras.fx.device
    gx = torch.arange(w, dtype=torch.float32, device=device).repeat(h)
    gy = torch.arange(h, dtype=torch.float32, device=device).repeat_interleave(w)

    # pinhole crop cameras carry no distortion: unproject = normalize([q, 1])
    qx = (gx[None, :] - crop_cameras.cx[:, None]) / crop_cameras.fx[:, None]
    qy = (gy[None, :] - crop_cameras.cy[:, None]) / crop_cameras.fy[:, None]
    inv = 1.0 / torch.sqrt(qx * qx + qy * qy + 1.0)
    vx, vy, vz = qx * inv, qy * inv, inv

    # eye_to_world (crop) then world_to_eye (source), composed:
    # R = R_src^T R_crop, t = R_src^T (t_crop - t_src)
    tc = crop_cameras.T_world_from_eye
    ts = src_cameras.T_world_from_eye
    r = torch.einsum("...ji,...jk->...ik", ts[..., :3, :3], tc[..., :3, :3])
    t = torch.einsum("...ji,...j->...i", ts[..., :3, :3], tc[..., :3, 3] - ts[..., :3, 3])
    ex = r[..., 0, 0, None] * vx + r[..., 0, 1, None] * vy + r[..., 0, 2, None] * vz + t[..., 0, None]
    ey = r[..., 1, 0, None] * vx + r[..., 1, 1, None] * vy + r[..., 1, 2, None] * vz + t[..., 1, None]
    ez = r[..., 2, 0, None] * vx + r[..., 2, 1, None] * vy + r[..., 2, 2, None] * vz + t[..., 2, None]

    if src_kind == cam.FISHEYE62:
        rr = torch.sqrt(ex * ex + ey * ey)
        # 2**-128 is an f32 subnormal: the on-axis pixel needs it unflushed
        s = torch.atan2(rr, ez) / torch.clamp(rr, min=2.0**-128)
        px, py = ex * s, ey * s
    elif src_kind == cam.PINHOLE:
        px, py = ex / ez, ey / ez
    else:
        raise ValueError(f"unknown projection kind {src_kind!r}")
    k1, k2, k3, k4, p1, p2, k5, k6 = (src_cameras.coeffs[..., i, None] for i in range(8))
    r2 = torch.clamp(px * px + py * py, -math.pi**2, math.pi**2)
    r4 = r2 * r2
    r6 = r2 * r4
    radial = 1 + k1 * r2 + k2 * r4 + k3 * r6 + k4 * (r4 * r4) + k5 * (r4 * r6) + k6 * (r6 * r6)
    ux, uy = px * radial, py * radial
    x2, y2, xy = ux * ux, uy * uy, ux * uy
    rq = x2 + y2
    dx = ux + 2 * p2 * xy + p1 * (rq + 2 * x2)
    dy = uy + 2 * p1 * xy + p2 * (rq + 2 * y2)
    wx = dx * src_cameras.fx[:, None] + src_cameras.cx[:, None]
    wy = dy * src_cameras.fy[:, None] + src_cameras.cy[:, None]

    if depth_check:
        behind = ez < 0
        wx = torch.where(behind, -1.0, wx)
        wy = torch.where(behind, -1.0, wy)
    return wx.contiguous(), wy.contiguous()


def warp_perspective_crop(
    src_images: torch.Tensor,  # (V, H, W) raw camera views
    src_cameras: cam.Camera,  # batch (N,) per-slot source camera
    src_view_idx: torch.Tensor,  # (N,) int64 view index per crop slot
    crop_cameras: cam.Camera,  # batch (N,) pinhole crop cameras
    crop_size: Tuple[int, int],
    src_kind: str = cam.FISHEYE62,
    depth_check: bool = True,
    src_valid_hw: Optional[Tuple[int, int]] = None,
    bf16_rows: bool = False,
) -> torch.Tensor:
    """Extract N pinhole crops from fisheye source views -> (N, h, w) f32.

    Points behind the source camera are masked (coordinate -1 samples 0).
    ``src_valid_hw``: the true sensor (H, W) when ``src_images`` arrive
    zero-padded (sampling semantics unchanged). ``bf16_rows``: sample with
    bf16 row weights (``warp_kernel.row_mode_for``).
    """
    w, h = crop_size
    n = src_view_idx.shape[0]
    wx, wy = _crop_source_coords_planar(src_cameras, crop_cameras, crop_size, src_kind, depth_check)
    # (N, h, w) planes: K1 lays its gathers on the crop's rows
    return bilinear_sample(
        src_images, src_view_idx, (wx.view(n, h, w), wy.view(n, h, w)),
        src_valid_hw=src_valid_hw, bf16_rows=bf16_rows,
    )
