"""The benchmark's hermetic scene: a 4-camera fisheye62 rig, a synthetic
hand and seeded uint8 frames (numpy only), frozen here so that the
program can change and the yardstick cannot. ``scene_recordings`` hands
the recordings to the program through its label parser;
``reference_recording`` gives the plain reference the same scene as
tensors; ``touched_source_bytes`` counts the least source traffic of a
bilinear crop sampler's call."""

from __future__ import annotations

import math

import numpy as np
import torch

N_VIEWS = 4
SRC_HW = (480, 636)  # the sensor


def _rot_x(deg):
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rot_y(deg):
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rot_z(deg):
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def synthetic_hand_model() -> dict:
    """A left-canonical hand in mm: 5 four-joint fingers along +y from the
    wrist, flexion about x, abduction about z, 21 landmarks skinned to 1-2
    of the 17 frames, joint limits."""
    base_x = [-32.0, -18.0, -2.0, 14.0, 28.0]
    base_y = [12.0, 40.0, 42.0, 40.0, 36.0]
    seg = [17.0, 22.0, 25.0, 23.0, 18.0]
    splay = [-35.0, -6.0, 0.0, 6.0, 12.0]  # finger direction in the palm plane, deg
    jp = np.zeros((22, 3))
    axes = np.zeros((22, 3))
    lm = np.zeros((21, 3))
    bw = np.zeros((21, 3))
    bi = np.zeros((21, 3), np.int64)
    for f in range(5):
        d = _rot_z(splay[f]) @ np.array([0.0, 1.0, 0.0])
        for j in range(4):
            jp[4 * f + j] = [base_x[f], base_y[f], 0.0] + j * seg[f] * d
            axes[4 * f + j] = [0.0, 0.0, 1.0] if j == 0 else _rot_z(splay[f]) @ [1.0, 0.0, 0.0]
        frame = 2 + 3 * f  # frames 2-4 of finger f follow joints 0-1, 0-2, 0-3
        lm[f] = jp[4 * f + 3] + seg[f] * d  # fingertip
        bw[f, 0], bi[f, 0] = 1.0, frame + 2
        for j in range(3):  # landmarks at joints 1-3
            k = 6 + 3 * f + j
            lm[k] = jp[4 * f + 1 + j]
            bw[k, :2] = (0.7, 0.3) if j else (1.0, 0.0)
            bi[k, :2] = (frame + j, frame + max(j - 1, 0))
    axes[20], axes[21] = [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]
    bw[5, 0], bi[5, 0] = 1.0, 1  # wrist landmark on the wrist frame
    limits = np.tile([[-0.2, 1.4]], (22, 1))
    limits[0::4][:5] = [-0.35, 0.35]
    limits[20:] = [-0.6, 0.6]
    idx = np.arange(22)
    return dict(
        joint_rotation_axes=axes.astype(np.float32),
        joint_rest_positions=jp.astype(np.float32),
        joint_frame_index=idx,
        joint_parent=np.where(idx % 4 == 0, 21, idx - 1),
        joint_first_child=np.where(idx % 4 == 3, -1, idx + 1),
        joint_next_sibling=np.where(idx < 16, idx + 4, -1),
        landmark_rest_positions=lm.astype(np.float32),
        landmark_rest_bone_weights=bw.astype(np.float32),
        landmark_rest_bone_indices=bi,
        joint_limits=limits.astype(np.float32),
    )


def build_scene(seed: int, n_frames: int) -> dict:
    """A 4-camera fisheye62 rig (rolled 0/90/90/180 deg), two hands about
    350 mm in front of it moving slowly, and uint8 frames."""
    rng = np.random.default_rng(seed % 2**64)
    h, w = SRC_HW
    rolls = np.array([0.0, 90.0, 90.0, 180.0])
    positions = [[-45, -15, 0], [45, -15, 0], [-55, 20, -5], [55, 20, -5]]
    yaw_pitch = [(-15, 5), (15, 5), (-25, 12), (25, 12)]
    c2w = np.tile(np.eye(4), (N_VIEWS, 1, 1))
    for v in range(N_VIEWS):
        body = _rot_y(yaw_pitch[v][0]) @ _rot_x(yaw_pitch[v][1])
        c2w[v, :3, :3] = body @ _rot_z(-rolls[v])
        c2w[v, :3, 3] = positions[v]
    coeffs = np.zeros((N_VIEWS, 8))
    coeffs[:, :4] = [-0.02, 0.004, -0.0008, 0.0001] * (1 + 0.1 * rng.standard_normal((N_VIEWS, 4)))
    coeffs[:, 4:6] = 1e-4 * rng.standard_normal((N_VIEWS, 2))
    cameras = dict(
        fx=230.0 + rng.uniform(-5, 5, N_VIEWS),
        fy=230.0 + rng.uniform(-5, 5, N_VIEWS),
        cx=(w - 1) / 2 + rng.uniform(-3, 3, N_VIEWS),
        cy=(h - 1) / 2 + rng.uniform(-3, 3, N_VIEWS),
        coeffs=coeffs,
        width=np.full(N_VIEWS, float(w)),
        height=np.full(N_VIEWS, float(h)),
    )

    t = np.arange(n_frames)[:, None]
    ja = np.zeros((n_frames, 2, 22))
    ja[:, :, :20] = 0.25 + 0.15 * np.sin(0.2 * t[..., None] + rng.uniform(0, 6, (1, 2, 20)))
    ja[:, :, 0:20:4] *= 0.3  # small abduction
    palm_to_rig = np.diag([1.0, -1.0, -1.0])  # fingers up, palm toward the rig
    mirror = np.diag([-1.0, 1.0, 1.0])
    wrist = np.tile(np.eye(4), (n_frames, 2, 1, 1))
    for i in range(n_frames):
        rot = _rot_y(10 * math.sin(0.1 * i)) @ _rot_x(15) @ palm_to_rig
        wrist[i, 0, :3, :3] = rot
        wrist[i, 1, :3, :3] = mirror @ rot @ mirror  # the right hand mirrors the left
        wrist[i, 0, :3, 3] = [-80 + 15 * math.sin(0.15 * i), 20 + 10 * math.cos(0.1 * i), 350]
        wrist[i, 1, :3, 3] = [85 - 10 * math.sin(0.12 * i), 25, 340 + 20 * math.sin(0.1 * i)]

    return dict(
        cameras=cameras,
        camera_angles=rolls.astype(np.float32),
        camera_to_world=np.tile(c2w, (n_frames, 1, 1, 1)).astype(np.float32),
        hand_model=synthetic_hand_model(),
        joint_angles=ja.astype(np.float32),
        wrist_transforms=wrist.astype(np.float32),
        hand_confidences=np.ones((n_frames, 2), np.float32),
        frames=rng.integers(0, 256, (n_frames, N_VIEWS, h, w), dtype=np.uint8),
    )


def labels_json(scene: dict, start: int, length: int) -> dict:
    """Frames [start, start + length) of the scene as a label dict of the
    reference recordings' JSON schema."""
    c = scene["cameras"]
    coeff_names = ("k1", "k2", "k3", "k4", "p1", "p2", "k5", "k6")
    cameras = [
        {
            "DistortionModel": "FishEye62",
            "ImageSizeX": int(c["width"][v]), "ImageSizeY": int(c["height"][v]),
            **{k: float(c[k][v]) for k in ("fx", "fy", "cx", "cy")},
            **dict(zip(coeff_names, map(float, c["coeffs"][v]))),
        }
        for v in range(N_VIEWS)
    ]
    sl = slice(start, start + length)
    return {
        "cameras": cameras,
        "camera_angles": scene["camera_angles"].tolist(),
        "camera_to_world_transforms": scene["camera_to_world"][sl].tolist(),
        "hand_model": {k: np.asarray(v).tolist() for k, v in scene["hand_model"].items()},
        "joint_angles": scene["joint_angles"][sl].tolist(),
        "wrist_transforms": scene["wrist_transforms"][sl].tolist(),
        "hand_confidences": scene["hand_confidences"][sl].tolist(),
    }


def scene_recordings(scene: dict, starts, length: int) -> list:
    """(labels, frames) pairs for the program's eval driver: one recording
    of ``length`` frames from each start, frames as (V, 480, 636) uint8."""
    from absolutetrack_tpu_torch.tracker.video_data import labels_from_json

    return [
        (labels_from_json(labels_json(scene, s, length)), list(scene["frames"][s: s + length]))
        for s in starts
    ]


def hand_tensors(hand: dict, device, scale: float = 1.0) -> dict:
    """The hand model as the reference's FK dict (``scale`` times its lengths)."""
    from ..reference.kinematics import dense_weights

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return dict(
        axes=f32(hand["joint_rotation_axes"]),
        rest=f32(hand["joint_rest_positions"]) * scale,
        lm_rest=f32(hand["landmark_rest_positions"]) * scale,
        weights=dense_weights(f32(hand["landmark_rest_bone_weights"]),
                              torch.as_tensor(hand["landmark_rest_bone_indices"], device=device)),
        limits=f32(hand["joint_limits"]),
    )


def reference_recording(scene: dict, start: int, length: int, device) -> dict:
    """Frames [start, start + length) as the reference tracker's inputs."""
    c = scene["cameras"]
    sl = slice(start, start + length)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return dict(
        frames=torch.as_tensor(scene["frames"][sl], device=device),
        fx=f32(c["fx"]), fy=f32(c["fy"]), cx=f32(c["cx"]), cy=f32(c["cy"]), coeffs=f32(c["coeffs"]),
        cam_to_world=f32(scene["camera_to_world"][sl]),
        angles_deg=f32(scene["camera_angles"]),
        hand=hand_tensors(scene["hand_model"], device),
        joint_angles=f32(scene["joint_angles"][sl]),
        wrist=f32(scene["wrist_transforms"][sl]),
        confidence=f32(scene["hand_confidences"][sl]),
    )


def touched_source_bytes(images, image_idx, xs, ys, valid_hw) -> int:
    """Bytes of ``images`` (V, H, W) that the four taps of the in-bounds
    pixels read, each byte counted once: the least source traffic of one
    sample. A view index counts from the end when negative, then clamps."""
    h, w = valid_hw
    n_views, hp, wp = images.shape
    xs, ys = xs.reshape(xs.shape[0], -1), ys.reshape(ys.shape[0], -1)
    x0, y0 = torch.floor(xs), torch.floor(ys)
    inside = (xs >= 0) & (x0 + 1 <= w - 1) & (ys >= 0) & (y0 + 1 <= h - 1)
    idx = image_idx.long()
    idx = torch.where(idx < 0, idx + n_views, idx).clamp(0, n_views - 1)
    v = idx[:, None].expand_as(xs)
    corner = (v[inside] * hp + y0[inside].long()) * wp + x0[inside].long()
    taps = torch.cat([corner, corner + 1, corner + wp, corner + wp + 1])
    return int(torch.unique(taps).numel()) * images.element_size()
