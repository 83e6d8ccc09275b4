"""Fisheye->pinhole crop extraction (port of ``absolutetrack_tpu/ops/resample.py``).

Coordinates come from vectorized camera math as separate x/y planes;
sampling goes through ``warp_kernel.bilinear_sample`` (K1 on the card,
the plain version on the CPU). ``warp_perspective_crop`` cuts fisheye
crops through the full camera chain; ``compute_resample_matrix`` and
``warp_homography`` warp pinhole views through one pixel homography per
slot, for the packed-data path (``data/transform.py``).
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
    "compute_resample_matrix",
    "split_coord_planes",
    "warp_homography",
    "warp_perspective_crop",
]


def _dst_pixel_grid(size: Tuple[int, int], device=None) -> torch.Tensor:
    """(h*w, 2) grid of the crop's (x, y) pixel centres, row-major."""
    w, h = size
    gx = torch.arange(w, dtype=torch.float32, device=device).repeat(h)
    gy = torch.arange(h, dtype=torch.float32, device=device).repeat_interleave(w)
    return torch.stack([gx, gy], dim=-1)


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
    gx, gy = _dst_pixel_grid(crop_size, crop_cameras.fx.device).unbind(-1)

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


def compute_resample_matrix(
    K_orig: torch.Tensor,  # (..., 3, 3)
    T_world_to_eye_orig: torch.Tensor,  # (..., 4, 4)
    K_new: torch.Tensor,  # (..., 3, 3)
    T_eye_to_world_new: torch.Tensor,  # (..., 4, 4)
) -> torch.Tensor:
    """4x4 homography taking new-camera pixels to orig-camera pixels:
    K_orig . W2E_orig . E2W_new . K_new^-1 lifted to 4x4, valid when both
    cameras are pinhole."""

    def lift(m3):
        out = torch.zeros(m3.shape[:-2] + (4, 4), dtype=m3.dtype, device=m3.device)
        out[..., :3, :3] = m3
        out[..., 3, 3] = 1.0
        return out

    K_inv_new = torch.linalg.inv(K_new)
    return torch.matmul(
        torch.matmul(lift(K_orig), T_world_to_eye_orig),
        torch.matmul(T_eye_to_world_new, lift(K_inv_new)),
    )


def _homography_coords(resample_xfs: torch.Tensor, out_size: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source pixel planes (x, y), each (N, h, w), of the crop's pixels
    through (N, 4, 4) homographies: the 3 x 3 part times the homogeneous
    pixel, plus the translation, over its third coordinate."""
    w, h = out_size
    n = resample_xfs.shape[0]
    gx, gy = _dst_pixel_grid(out_size, resample_xfs.device).unbind(-1)
    r = resample_xfs[:, :3, :3, None]
    t = resample_xfs[:, :3, 3, None]
    sx, sy, sz = (r[:, i, 0] * gx + r[:, i, 1] * gy + r[:, i, 2] + t[:, i] for i in range(3))
    return (sx / sz).view(n, h, w), (sy / sz).view(n, h, w)


def warp_homography(
    src_images: torch.Tensor,  # (N, H, W)
    resample_xfs: torch.Tensor,  # (N, 4, 4) new-pixel -> orig-pixel
    out_size: Tuple[int, int],
    bf16_rows: bool = False,
) -> torch.Tensor:
    """Pinhole-to-pinhole warp of slot i from view i through its pixel
    homography -> (N, h, w) f32, 0 where a tap falls outside
    [0, W-1) x [0, H-1). ``bf16_rows``: sample with bf16 row weights."""
    # (N, h, w) planes: K1 lays its gathers on the crop's rows
    x, y = _homography_coords(resample_xfs, out_size)
    idx = torch.arange(src_images.shape[0], device=src_images.device)
    return bilinear_sample(src_images, idx, (x, y), bf16_rows=bf16_rows)
