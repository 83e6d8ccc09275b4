"""Batched 3D affine transforms (port of ``absolutetrack_tpu/geometry/affine.py``).

All functions broadcast over arbitrary leading batch dims and follow the
device of their inputs. Matrix products run in full f32: the port turns
TF32 off for matmuls (``models.layers.set_conv_precision``).
"""

from __future__ import annotations

import torch

_NORM_EPS = 5.43e-20  # matches reference lib/common/affine.py:22


def transform_points(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply a (..., 4, 4) transform to (..., 3) or (..., N, 3) points."""
    if v.dim() == m.dim() - 1:
        return rotate_points(m, v) + m[..., :3, 3]
    return rotate_points(m, v) + m[..., None, :3, 3]


def rotate_points(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply only the linear part of a (..., 4, 4) transform."""
    if v.dim() == m.dim() - 1:
        return torch.einsum("...ij,...j->...i", m[..., :3, :3], v)
    return torch.einsum("...ij,...nj->...ni", m[..., :3, :3], v)


def normalize(v: torch.Tensor, dim: int = -1, eps: float = _NORM_EPS) -> torch.Tensor:
    d = torch.clamp(torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True)), min=eps)
    return v / d


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix of (..., 3) vectors -> (..., 3, 3)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def rotation_from_two_vectors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotation taking direction ``a`` to ``b``: I + [v]x + [v]x^2 (1-c)/max(s^2, 1e-15)."""
    a = normalize(a)
    b = normalize(b)
    v = torch.linalg.cross(a, b, dim=-1)
    s2 = torch.sum(v * v, dim=-1)
    c = torch.sum(a * b, dim=-1)
    vmat = skew(v)
    eye = torch.eye(3, dtype=a.dtype, device=a.device).expand(vmat.shape)
    factor = (1.0 - c) / torch.clamp(s2, min=1e-15)
    return eye + vmat + torch.matmul(vmat, vmat) * factor[..., None, None]


def rotation_about_z(angle_deg: torch.Tensor) -> torch.Tensor:
    """Rotation about z by ``angle_deg`` degrees -> (..., 3, 3)."""
    rad = torch.deg2rad(angle_deg)
    c, s = torch.cos(rad), torch.sin(rad)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, -s, zero], dim=-1),
            torch.stack([s, c, zero], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def rigid_inverse(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a transform whose linear part is orthogonal (mirrors included)."""
    r_t = m[..., :3, :3].transpose(-1, -2)
    t = -torch.einsum("...ij,...j->...i", r_t, m[..., :3, 3])
    out = torch.zeros_like(m)
    out[..., :3, :3] = r_t
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def make_look_at_matrix(
    orig_world_to_eye: torch.Tensor,
    center: torch.Tensor,
    camera_angle_deg=0.0,
) -> torch.Tensor:
    """World-to-eye transform at the same position whose z axis passes
    through ``center``, rolled about z by the camera's mounting angle."""
    center_local = transform_points(orig_world_to_eye, center)
    z_dir_local = center_local / torch.linalg.norm(center_local, dim=-1, keepdim=True)
    e_z = torch.zeros_like(z_dir_local)
    e_z[..., 2] = 1.0
    delta_r_local = rotation_from_two_vectors(e_z, z_dir_local)

    orig_eye_to_world = rigid_inverse(orig_world_to_eye)
    angle = torch.as_tensor(
        camera_angle_deg, dtype=center_local.dtype, device=center_local.device
    )
    z_roll = rotation_about_z(angle.expand(center_local.shape[:-1]))

    new_rot = torch.matmul(
        torch.matmul(orig_eye_to_world[..., :3, :3], delta_r_local), z_roll
    )
    new_eye_to_world = orig_eye_to_world.clone()
    new_eye_to_world[..., :3, :3] = new_rot
    return rigid_inverse(new_eye_to_world)


def mirror_x_matrix(dtype=torch.float32, device=None) -> torch.Tensor:
    """4x4 mirror about the x axis (right-hand crop cameras)."""
    return torch.diag(torch.tensor([-1.0, 1.0, 1.0, 1.0], dtype=dtype, device=device))
