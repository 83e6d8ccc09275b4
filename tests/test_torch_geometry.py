"""Port parity: geometry (affine, camera, crop) against the JAX package.

Same numpy-seeded inputs through both; f32 on the CPU. Tolerances: 1e-5
relative for transforms, 1e-3 px for window coordinates of ~600 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from absolutetrack_tpu.geometry import affine as jaffine
from absolutetrack_tpu.geometry import camera as jcam
from absolutetrack_tpu.geometry import crop as jcrop
from absolutetrack_tpu_torch.geometry import affine, camera as cam, crop

jax.config.update("jax_platforms", "cpu")


def _rigid(rng, n):
    """(n, 4, 4) random rigid transforms, translation in mm."""
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    q *= np.sign(np.linalg.det(q))[:, None, None]
    m = np.tile(np.eye(4), (n, 1, 1))
    m[:, :3, :3] = q
    m[:, :3, 3] = rng.uniform(-100, 100, (n, 3))
    return m.astype(np.float32)


def _fisheye_cams(rng, n):
    coeffs = np.zeros((n, 8), np.float32)
    coeffs[:, :4] = [-0.02, 0.004, -0.0008, 0.0001]
    coeffs[:, 4:6] = 1e-4 * rng.standard_normal((n, 2))
    coeffs[:, 6:] = 1e-5 * rng.standard_normal((n, 2))
    return dict(
        fx=rng.uniform(220, 240, n), fy=rng.uniform(220, 240, n),
        cx=rng.uniform(315, 320, n), cy=rng.uniform(237, 242, n),
        coeffs=coeffs, T_world_from_eye=_rigid(rng, n),
        width=np.full(n, 636.0), height=np.full(n, 480.0),
    )


def _both(d):
    """A camera dict as (JAX Camera, port Camera)."""
    fields = {k: np.asarray(v, np.float32) for k, v in d.items()}
    j = jcam.Camera(**{k: jnp.asarray(v) for k, v in fields.items()})
    t = cam.Camera(**{k: torch.from_numpy(v) for k, v in fields.items()})
    return j, t


def _close(j, t, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=atol, rtol=rtol)


class TestAffine:
    def test_transform_and_rotate_points(self):
        rng = np.random.default_rng(0)
        m = _rigid(rng, 5)
        for v in (rng.standard_normal((5, 3)), rng.standard_normal((5, 7, 3))):
            v = v.astype(np.float32)
            _close(jaffine.transform_points(m, v), affine.transform_points(torch.from_numpy(m), torch.from_numpy(v)), 1e-4)
            _close(jaffine.rotate_points(m, v), affine.rotate_points(torch.from_numpy(m), torch.from_numpy(v)))

    def test_rigid_inverse_and_rotations(self):
        rng = np.random.default_rng(1)
        m = _rigid(rng, 6)
        _close(jaffine.rigid_inverse(m), affine.rigid_inverse(torch.from_numpy(m)), 1e-4)
        a = rng.standard_normal((6, 3)).astype(np.float32)
        b = rng.standard_normal((6, 3)).astype(np.float32)
        _close(
            jaffine.rotation_from_two_vectors(a, b),
            affine.rotation_from_two_vectors(torch.from_numpy(a), torch.from_numpy(b)),
        )
        ang = rng.uniform(-180, 180, 6).astype(np.float32)
        _close(jaffine.rotation_about_z(ang), affine.rotation_about_z(torch.from_numpy(ang)))

    def test_look_at(self):
        rng = np.random.default_rng(2)
        m = _rigid(rng, 4)
        center = rng.uniform(-300, 300, (4, 3)).astype(np.float32)
        ang = np.array([0.0, 90.0, 90.0, 180.0], np.float32)
        _close(
            jaffine.make_look_at_matrix(m, center, ang),
            affine.make_look_at_matrix(torch.from_numpy(m), torch.from_numpy(center), torch.from_numpy(ang)),
            atol=1e-3,
        )


class TestCamera:
    @pytest.mark.parametrize("kind", [cam.FISHEYE62, cam.PINHOLE])
    def test_project_includes_on_axis_point(self, kind):
        rng = np.random.default_rng(3)
        v = rng.uniform(-200, 200, (50, 3)).astype(np.float32)
        v[:, 2] = np.abs(v[:, 2]) + 10
        v[0, :2] = 0.0  # on the optical axis: r == 0 divides by the subnormal eps
        j = np.asarray(jcam.project(jnp.asarray(v), kind))
        t = cam.project(torch.from_numpy(v), kind)
        # the port keeps the subnormal, so the on-axis point projects to the
        # centre; XLA's CPU backend flushes it and the JAX value is NaN there
        assert t[0].tolist() == [0.0, 0.0]
        assert torch.isfinite(t).all()
        _close(j[1:], t[1:])

    def test_distort(self):
        rng = np.random.default_rng(4)
        coeffs = _fisheye_cams(rng, 3)["coeffs"]
        p = rng.uniform(-1.2, 1.2, (3, 40, 2)).astype(np.float32)
        _close(jcam.distort(coeffs[:, None], p), cam.distort(torch.from_numpy(coeffs)[:, None], torch.from_numpy(p)))

    def test_world_eye_window_chains(self):
        rng = np.random.default_rng(5)
        jc, tc = _both(_fisheye_cams(rng, 4))
        eye_pts = rng.uniform(-150, 150, (4, 30, 3)).astype(np.float32)
        eye_pts[..., 2] = rng.uniform(100, 400, (4, 30))  # in front of each camera
        world = np.array(jcam.eye_to_world(jc, eye_pts))
        _close(jcam.eye_to_world(jc, eye_pts), cam.eye_to_world(tc, torch.from_numpy(eye_pts)), 1e-3)
        _close(jcam.world_to_eye(jc, world), cam.world_to_eye(tc, torch.from_numpy(world)), 1e-3)
        _close(
            jcam.world_to_window(jc, world, jcam.FISHEYE62),
            cam.world_to_window(tc, torch.from_numpy(world), cam.FISHEYE62),
            atol=1e-3,
        )
        _close(jcam.intrinsics_matrix(jc), cam.intrinsics_matrix(tc))

    def test_window_chain_broadcasts_leading_point_dims(self):
        # (H, 1, 21, 3) landmarks against (V,) cameras -> (H, V, 21, 2)
        rng = np.random.default_rng(6)
        jc, tc = _both(_fisheye_cams(rng, 4))
        lm = rng.uniform(-100, 100, (2, 1, 21, 3)).astype(np.float32)
        j = jcam.eye_to_window(jc, jcam.world_to_eye(jc, lm), jcam.FISHEYE62)
        t = cam.eye_to_window(tc, cam.world_to_eye(tc, torch.from_numpy(lm)), cam.FISHEYE62)
        assert t.shape == (2, 4, 21, 2)
        _close(j, t, atol=2e-3)


class TestCrop:
    def test_gen_crop_camera_and_views(self):
        rng = np.random.default_rng(7)
        w2e = _rigid(rng, 4).reshape(2, 2, 4, 4)
        w2e[..., :3, 3] = 0.0
        # points 300-400 mm along each camera's +z
        eye_pts = rng.uniform(-40, 40, (2, 2, 63, 3)) + [0, 0, 350]
        r = w2e[..., :3, :3]
        pts = np.einsum("hvji,hvnj->hvni", r, eye_pts).astype(np.float32)
        mirror = np.array([[False, False], [True, True]])
        ang = np.array([[0.0, 90.0], [90.0, 180.0]], np.float32)
        j = jcrop.gen_crop_camera(w2e, pts, (96, 96), mirror, ang, 0.8)
        t = crop.gen_crop_camera(
            torch.from_numpy(w2e), torch.from_numpy(pts), (96, 96),
            torch.from_numpy(mirror), torch.from_numpy(ang), 0.8,
        )
        _close(j.T_world_to_eye, t.T_world_to_eye, atol=1e-4)
        _close(j.fx_fy, t.fx_fy, atol=1e-3)
        _close(j.cx_cy, t.cx_cy)
        np.testing.assert_array_equal(np.asarray(j.valid), t.valid.numpy())
        _close(jcrop.intrinsics_matrix_from_crop(j), crop.intrinsics_matrix_from_crop(t), atol=1e-3)
        jc = jcrop.crop_camera_to_camera(j, (96, 96))
        tc = crop.crop_camera_to_camera(t, (96, 96))
        for name in cam.Camera._fields:
            _close(getattr(jc, name), getattr(tc, name), atol=1e-3)

    def test_degenerate_points_are_invalid(self):
        w2e = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
        pts = np.zeros((2, 5, 3), np.float32)
        pts[:, :, 2] = 300.0
        pts[:, :, 0] = np.linspace(-10, 10, 5)
        pts[1, 0, 2] = -5.0  # behind the camera
        t = crop.gen_crop_camera(torch.from_numpy(w2e), torch.from_numpy(pts), (96, 96), torch.tensor([False, False]))
        j = jcrop.gen_crop_camera(w2e, pts, (96, 96), np.array([False, False]))
        np.testing.assert_array_equal(np.asarray(j.valid), t.valid.numpy())
        assert t.valid.tolist() == [True, False]
