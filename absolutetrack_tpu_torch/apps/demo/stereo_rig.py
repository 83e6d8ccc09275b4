"""The demo's stereo rig (port of ``absolutetrack_tpu/apps/demo/stereo_rig.py``).

The ELP fisheye stereo camera's bundled calibration (reference
demo/ume_tracker.py:46-106): two fisheye62 cameras, the right one offset
by the stereo baseline with a small relative rotation. World frame: the
left camera, in millimeters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...geometry import camera as cam

IMG_WIDTH = 640
IMG_HEIGHT = 480
M_TO_MM = 1000.0


@dataclasses.dataclass(frozen=True)
class StereoCalibration:
    fx_left: float = 2.3877057700850656e02
    fy_left: float = 2.3903223316525276e02
    cx_left: float = 3.1846939219741773e02
    cy_left: float = 2.4685137381795201e02
    # k1..k4 (tangential terms and k5, k6 are zero for this rig)
    dist_left: tuple = (
        -3.7539305827469560e-02,
        -8.7553205432575471e-03,
        2.2015408171895236e-03,
        -6.6218076061138698e-04,
    )
    fx_right: float = 2.3952183485043457e02
    fy_right: float = 2.3981379751051574e02
    cx_right: float = 3.1286224145189811e02
    cy_right: float = 2.5158397962108106e02
    dist_right: tuple = (
        -3.6790400486095221e-02,
        -8.2041573433038941e-03,
        1.0552974220937024e-03,
        -2.5841665172692902e-04,
    )
    # the right camera's pose relative to the left (rotation, baseline in meters)
    right_rotation: tuple = (
        (9.9999470555416226e-01, 1.1490100298631428e-03, 3.0444440536135159e-03),
        (-1.1535052313709361e-03, 9.9999824663038117e-01, 1.4751819698614872e-03),
        (-3.0427437166985561e-03, -1.4786859417328980e-03, 9.9999427758290704e-01),
    )
    baseline_m: tuple = (
        -5.9457914254177978e-02,
        -6.8318101539255457e-05,
        -1.8101725187729225e-04,
    )


def build_stereo_cameras(calib: StereoCalibration = StereoCalibration()) -> cam.Camera:
    """Batched (V=2) fisheye62 cameras in the left camera's frame (mm), on the CPU."""

    def coeffs8(d):
        return np.asarray(list(d) + [0.0] * (8 - len(d)), np.float32)

    t_left = np.eye(4, dtype=np.float32)
    t_right = np.eye(4, dtype=np.float32)
    t_right[:3, :3] = np.asarray(calib.right_rotation, np.float32)
    t_right[:3, 3] = np.asarray(calib.baseline_m, np.float32) * M_TO_MM

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    return cam.Camera(
        fx=f32([calib.fx_left, calib.fx_right]),
        fy=f32([calib.fy_left, calib.fy_right]),
        cx=f32([calib.cx_left, calib.cx_right]),
        cy=f32([calib.cy_left, calib.cy_right]),
        coeffs=f32(np.stack([coeffs8(calib.dist_left), coeffs8(calib.dist_right)])),
        T_world_from_eye=f32(np.stack([t_left, t_right])),
        width=torch.full((2,), float(IMG_WIDTH)),
        height=torch.full((2,), float(IMG_HEIGHT)),
    )
