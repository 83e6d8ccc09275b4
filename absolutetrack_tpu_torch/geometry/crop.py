"""Perspective crop-camera synthesis (port of ``absolutetrack_tpu/geometry/crop.py``).

Batched over (hand, view) slots; degenerate geometry yields ``valid=False``
instead of raising, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import affine
from .camera import Camera


class CropCamera(NamedTuple):
    """A synthesized pinhole crop camera (batched).

    T_world_to_eye : (B..., 4, 4) world->eye, mirror-x included for right hands
    fx_fy, cx_cy   : (B..., 2) intrinsics
    valid          : (B...,) bool
    """

    T_world_to_eye: torch.Tensor
    fx_fy: torch.Tensor
    cx_cy: torch.Tensor
    valid: torch.Tensor

    def map(self, fn) -> "CropCamera":
        return CropCamera(*(fn(x) for x in self))


def gen_intrinsics_from_bounding_pts(
    pts_eye: torch.Tensor,
    image_w: int,
    image_h: int,
    min_focal: float = 5.0,
):
    """Focal/center so that all eye-space points project inside the image."""
    pts_ndc = pts_eye[..., 0:2] / pts_eye[..., 2:3]
    img_size = torch.tensor(
        [image_w, image_h], dtype=pts_eye.dtype, device=pts_eye.device
    )
    cx_cy = (img_size - 1.0) / 2.0
    max_ndc = torch.amax(torch.abs(pts_ndc), dim=(-1, -2))
    fx_fy = cx_cy / max_ndc[..., None]
    valid = ~(
        torch.any(pts_eye[..., 2] < 1e-4, dim=-1) | torch.any(fx_fy < min_focal, dim=-1)
    )
    return fx_fy, cx_cy.expand(fx_fy.shape), valid


def gen_crop_camera(
    orig_T_world_to_eye: torch.Tensor,
    pts_world: torch.Tensor,
    image_size: Tuple[int, int],
    mirror_img_x: torch.Tensor,
    camera_angle_deg=0.0,
    focal_multiplier: float = 0.95,
    min_focal: float = 5.0,
) -> CropCamera:
    """Crop camera looking at the center of ``pts_world`` (B..., N, 3)."""
    center = (torch.amin(pts_world, dim=-2) + torch.amax(pts_world, dim=-2)) / 2.0
    new_w2e = affine.make_look_at_matrix(orig_T_world_to_eye, center, camera_angle_deg)

    mirror = affine.mirror_x_matrix(new_w2e.dtype, new_w2e.device)
    new_w2e = torch.where(
        mirror_img_x[..., None, None], torch.matmul(mirror, new_w2e), new_w2e
    )

    pts_eye = affine.transform_points(new_w2e, pts_world)
    fx_fy, cx_cy, valid = gen_intrinsics_from_bounding_pts(
        pts_eye, image_size[0], image_size[1], min_focal
    )
    return CropCamera(
        T_world_to_eye=new_w2e,
        fx_fy=focal_multiplier * fx_fy,
        cx_cy=cx_cy,
        valid=valid,
    )


def crop_camera_to_camera(crop: CropCamera, image_size: Tuple[int, int]) -> Camera:
    """View a CropCamera as a pinhole ``Camera``."""
    fx = crop.fx_fy[..., 0]
    return Camera(
        fx=fx,
        fy=crop.fx_fy[..., 1],
        cx=crop.cx_cy[..., 0],
        cy=crop.cx_cy[..., 1],
        coeffs=torch.zeros(fx.shape + (8,), dtype=fx.dtype, device=fx.device),
        T_world_from_eye=affine.rigid_inverse(crop.T_world_to_eye),
        width=torch.full(fx.shape, float(image_size[0]), dtype=fx.dtype, device=fx.device),
        height=torch.full(fx.shape, float(image_size[1]), dtype=fx.dtype, device=fx.device),
    )


def intrinsics_matrix_from_crop(crop: CropCamera) -> torch.Tensor:
    """(B..., 3, 3) intrinsics matrix of crop cameras."""
    fx, fy = crop.fx_fy.unbind(-1)
    cx, cy = crop.cx_cy.unbind(-1)
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack(
        [
            torch.stack([fx, z, cx], dim=-1),
            torch.stack([z, fy, cy], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )
