"""Batched camera models (port of ``absolutetrack_tpu/geometry/camera.py``).

Conventions as in the JAX package: ``v`` eye-space 3D, ``p = project(v)``,
``q = distort(p)``, window ``w = q * f + c``. Points are shaped
``cam_batch + (N, 2|3)``; every function takes any camera batch shape
(one rig ``(V,)``, or ``(R, V)`` for R recordings). The inverse chain
(``window_to_eye``: ``undistort``, ``unproject``) serves the 2D-keypoint path.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from . import affine

PINHOLE = "pinhole"
FISHEYE62 = "fisheye62"

_UNDISTORT_ITERS = 5  # fixed-point iterations, as the reference's


class Camera(NamedTuple):
    """Struct-of-arrays camera; fields share a batch shape ``B...``.

    fx, fy, cx, cy, width, height : (B...,)
    coeffs           : (B..., 8) [k1 k2 k3 k4 p1 p2 k5 k6]; zeros for pinhole
    T_world_from_eye : (B..., 4, 4) camera-to-world rigid transform
    """

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    coeffs: torch.Tensor
    T_world_from_eye: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor

    @property
    def batch_shape(self):
        return self.fx.shape

    def map(self, fn) -> "Camera":
        """Apply ``fn`` to every field (index, reshape, move)."""
        return Camera(*(fn(x) for x in self))

    def to(self, device) -> "Camera":
        return self.map(lambda x: x.to(device))


def pinhole_camera(fx, fy, cx, cy, T_world_from_eye, width, height, device=None) -> Camera:
    """A distortion-free camera from array-likes, as f32 tensors on ``device``."""

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    fx = f32(fx)
    return Camera(
        fx=fx, fy=f32(fy), cx=f32(cx), cy=f32(cy),
        coeffs=torch.zeros(fx.shape + (8,), dtype=torch.float32, device=device),
        T_world_from_eye=f32(T_world_from_eye), width=f32(width), height=f32(height),
    )


def camera_from_json(js: dict, T_world_from_eye: Optional[np.ndarray] = None):
    """One camera dict of the reference's JSON schema -> ``(Camera, kind)``
    on the CPU (keys ImageSizeX/Y, fx, fy, cx, cy, DistortionModel, k1..k6,
    p1, p2; ``absolutetrack_tpu/geometry/camera.py:78-110``)."""
    js = js.get("Camera", js)
    model = js["DistortionModel"]
    if model == "PinholePlane":
        kind = PINHOLE
        coeffs = np.zeros(8, np.float32)
    elif model == "FishEye62":
        kind = FISHEYE62
        coeffs = [js[k] for k in ("k1", "k2", "k3", "k4", "p1", "p2", "k5", "k6")]
    else:
        raise ValueError(f"Unknown DistortionModel {model!r}")
    if T_world_from_eye is None:
        T_world_from_eye = np.eye(4)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    return Camera(
        fx=f32(js["fx"]), fy=f32(js["fy"]), cx=f32(js["cx"]), cy=f32(js["cy"]),
        coeffs=f32(coeffs), T_world_from_eye=f32(T_world_from_eye),
        width=f32(js["ImageSizeX"]), height=f32(js["ImageSizeY"]),
    ), kind


def stack_cameras(cams: List[Camera]) -> Camera:
    """Stack same-kind cameras along a new leading batch axis."""
    return Camera(*(torch.stack(x) for x in zip(*cams)))


def project(v: torch.Tensor, kind: str, eps: float = 2.0**-128) -> torch.Tensor:
    """Eye-space 3D -> normalized 2D image coords.

    ``eps`` is an f32 subnormal: the on-axis pixel (r == 0) gives 0/eps = 0
    only where subnormals are not flushed to zero.
    """
    if kind == PINHOLE:
        return v[..., :2] / v[..., 2:3]
    if kind == FISHEYE62:
        x, y, z = v.unbind(-1)
        r = torch.sqrt(x * x + y * y)
        s = torch.atan2(r, z) / torch.clamp(r, min=eps)
        return torch.stack([x * s, y * s], dim=-1)
    raise ValueError(f"unknown projection kind {kind!r}")


def unproject(p: torch.Tensor, kind: str) -> torch.Tensor:
    """Normalized 2D -> unit-length eye-space 3D direction: pinhole
    normalises (x, y, 1); fisheye62 gives (u sinc(r), v sinc(r), cos(r)),
    with ``sinc(r / pi) == sin(r) / r``."""
    if kind == PINHOLE:
        return affine.normalize(torch.cat([p, torch.ones_like(p[..., :1])], dim=-1))
    if kind == FISHEYE62:
        u, v = p.unbind(-1)
        r = torch.sqrt(u * u + v * v)
        s = torch.sinc(r / math.pi)
        return torch.stack([u * s, v * s, torch.cos(r)], dim=-1)
    raise ValueError(f"unknown projection kind {kind!r}")


def distort(coeffs: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Fisheye62 forward distortion: 6 radial + 2 tangential terms."""
    k1, k2, k3, k4, p1, p2, k5, k6 = coeffs.unbind(-1)
    r2 = torch.clamp(torch.sum(p * p, dim=-1), -math.pi**2, math.pi**2)
    r4 = r2 * r2
    r6 = r2 * r4
    r8 = r4 * r4
    r10 = r4 * r6
    r12 = r6 * r6
    radial = 1 + k1 * r2 + k2 * r4 + k3 * r6 + k4 * r8 + k5 * r10 + k6 * r12
    uv = p * radial[..., None]
    x, y = uv.unbind(-1)
    x2, y2, xy = x * x, y * y, x * y
    rr = x2 + y2
    x_out = x + 2 * p2 * xy + p1 * (rr + 2 * x2)
    y_out = y + 2 * p1 * xy + p2 * (rr + 2 * y2)
    return torch.stack([x_out, y_out], dim=-1)


def undistort(coeffs: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Radial-only fisheye62 undistortion: 5 fixed-point iterations, each
    dividing the distorted point by the radial factor at the current
    estimate; the tangential terms are ignored, as the reference's."""
    k1, k2, k3, k4, _p1, _p2, k5, k6 = coeffs.unbind(-1)
    x_d, y_d = q.unbind(-1)
    x_u, y_u = x_d, y_d
    for _ in range(_UNDISTORT_ITERS):
        r2 = x_u * x_u + y_u * y_u
        radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3 + k4 * r2**4 + k5 * r2**5 + k6 * r2**6
        x_u = x_d / radial
        y_u = y_d / radial
    return torch.stack([x_u, y_u], dim=-1)


def world_to_eye(cam: Camera, v: torch.Tensor) -> torch.Tensor:
    """World points -> eye space: R^T (v - t)."""
    t = cam.T_world_from_eye[..., :3, 3]
    if v.dim() == cam.T_world_from_eye.dim() - 1:
        return torch.einsum("...ji,...j->...i", cam.T_world_from_eye[..., :3, :3], v - t)
    d = v - t[..., None, :]
    return torch.einsum("...ji,...nj->...ni", cam.T_world_from_eye[..., :3, :3], d)


def eye_to_world(cam: Camera, v: torch.Tensor) -> torch.Tensor:
    return affine.transform_points(cam.T_world_from_eye, v)


def eye_to_window(cam: Camera, v: torch.Tensor, kind: str) -> torch.Tensor:
    """Eye 3D -> window (pixel) coords: distort(project(v)) * f + c.

    Camera fields gain one trailing axis to align with the points' N axis;
    extra leading point dims broadcast numpy-style.
    """
    q = distort(cam.coeffs[..., None, :], project(v, kind))
    f = torch.stack([cam.fx[..., None], cam.fy[..., None]], dim=-1)
    c = torch.stack([cam.cx[..., None], cam.cy[..., None]], dim=-1)
    return q * f + c


def window_to_eye(cam: Camera, w: torch.Tensor, kind: str) -> torch.Tensor:
    """Window coords -> unit-length eye ray: unproject(undistort((w - c) / f));
    camera fields gain one trailing axis, as in ``eye_to_window``."""
    f = torch.stack([cam.fx[..., None], cam.fy[..., None]], dim=-1)
    c = torch.stack([cam.cx[..., None], cam.cy[..., None]], dim=-1)
    return unproject(undistort(cam.coeffs[..., None, :], (w - c) / f), kind)


def world_to_window(cam: Camera, v: torch.Tensor, kind: str) -> torch.Tensor:
    return eye_to_window(cam, world_to_eye(cam, v), kind)


def crop(
    cam: Camera,
    src_x,
    src_y,
    target_width,
    target_height,
    scale: float = 1.0,
    T_world_from_eye: Optional[torch.Tensor] = None,
) -> Camera:
    """Intrinsics of a sub-window (and rescale) of the sensor:
    f' = f * scale, c' = (c - (x, y) + 0.5) * scale - 0.5; the distortion
    coefficients are unchanged (they act on normalized coordinates)."""
    sx = torch.as_tensor(src_x, dtype=cam.cx.dtype, device=cam.cx.device)
    sy = torch.as_tensor(src_y, dtype=cam.cy.dtype, device=cam.cy.device)
    return cam._replace(
        fx=cam.fx * scale,
        fy=cam.fy * scale,
        cx=(cam.cx - sx + 0.5) * scale - 0.5,
        cy=(cam.cy - sy + 0.5) * scale - 0.5,
        width=torch.full_like(cam.width, float(target_width)),
        height=torch.full_like(cam.height, float(target_height)),
        T_world_from_eye=cam.T_world_from_eye if T_world_from_eye is None else T_world_from_eye,
    )


def intrinsics_matrix(cam: Camera) -> torch.Tensor:
    """(B..., 3, 3) pinhole intrinsics [[fx 0 cx][0 fy cy][0 0 1]]."""
    z = torch.zeros_like(cam.fx)
    o = torch.ones_like(cam.fx)
    return torch.stack(
        [
            torch.stack([cam.fx, z, cam.cx], dim=-1),
            torch.stack([z, cam.fy, cam.cy], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )
