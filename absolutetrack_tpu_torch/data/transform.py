"""Preprocessing of packed sequences (port of ``absolutetrack_tpu/data/transform.py``).

A packed sample is a window of pinhole-rectified views plus labels (GT
skeleton and pose, the generic skeleton's solved pose, enclosing points).
``preprocess_packed`` converts mm to m, mirrors right hands into the
left-hand canonical space, makes one crop camera per (frame, view) from
the enclosing points and warps each view through one pixel homography
(``ops/resample.py::warp_homography``: K1 on the card, its plain version
on the CPU), all batched on the device of the call.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..geometry import affine, crop as crop_mod
from ..kinematics.hand_model import HandModel, hand_model_from_dict, mirrored_hand_model, scaled_hand_model
from ..ops.resample import compute_resample_matrix, warp_homography
from ..utils.runtime import resolve_device

MM_TO_M = 0.001


class PackedSequence(NamedTuple):
    """Model inputs and targets of one packed window, T leading, in meters."""

    left_images: torch.Tensor  # (T, V, h, w) in [0, 1]
    intrinsics: torch.Tensor  # (T, V, 3, 3)
    extrinsics: torch.Tensor  # (T, V, 4, 4)
    hand_idx: torch.Tensor  # () int
    gt_joint_angles: torch.Tensor  # (T, 22)
    gt_wrist: torch.Tensor  # (T, 4, 4) left-canonical, meters
    solved_joint_angles: torch.Tensor  # (T, 22)
    solved_wrist: torch.Tensor  # (T, 4, 4)
    gt_hand_model: HandModel  # left-canonical, meters
    generic_hand_model: HandModel
    pinch: torch.Tensor


def _mirror_wrist_to_left(wrist: torch.Tensor, is_right: torch.Tensor) -> torch.Tensor:
    """The wrist's x column times -1 where ``is_right`` holds."""
    out = wrist.clone()
    out[..., :, 0] = out[..., :, 0] * torch.where(is_right, -1.0, 1.0)
    return out


def _scale_translation(xf: torch.Tensor, factor: float) -> torch.Tensor:
    out = xf.clone()
    out[..., :3, 3] = out[..., :3, 3] * factor
    return out


def preprocess_packed(
    mono: np.ndarray,  # (T, V, H, W) uint8
    labels: Dict,
    crop_size: Tuple[int, int] = (96, 96),
    focal_multiplier: float = 0.95,
    device=None,
    bf16_rows: bool = False,
) -> PackedSequence:
    """One packed sample -> cropped model inputs on ``device`` (``cuda``
    unless given). ``labels`` follows the reference's RawSample schema;
    ``bf16_rows`` samples the crops with bf16 row weights."""
    device = resolve_device(device)
    t, v = mono.shape[:2]

    def f32(key, default=None):
        return torch.as_tensor(np.asarray(labels.get(key, default), np.float32), device=device)

    extrinsics = f32("extrinsics")  # (T, V, 4, 4)
    intrinsics = f32("intrinsics")  # (T, V, 3, 3)
    enclosing = f32("enclosing_points")  # (T, P, 3)
    hand = f32("hand").reshape(-1)[0]
    wrist = f32("wrist")
    joint_angles = f32("joint_angles")
    solved_wrist = f32("solved_wrist_xfs")
    solved_angles = f32("solved_joint_angles")
    pinch = f32("pinch", np.zeros(t))

    gt_hand = hand_model_from_dict(labels["hand_model"], device=device)
    generic = hand_model_from_dict(labels["generic_hand_model"], device=device)

    # mm -> m
    extrinsics = _scale_translation(extrinsics, MM_TO_M)
    enclosing = enclosing * MM_TO_M
    wrist = _scale_translation(wrist, MM_TO_M)
    solved_wrist = _scale_translation(solved_wrist, MM_TO_M)
    gt_hand = scaled_hand_model(gt_hand, MM_TO_M)
    generic = scaled_hand_model(generic, MM_TO_M)

    is_right = hand == 1
    gt_hand = mirrored_hand_model(gt_hand, is_right)
    generic = mirrored_hand_model(generic, is_right)
    wrist = _mirror_wrist_to_left(wrist, is_right)
    solved_wrist = _mirror_wrist_to_left(solved_wrist, is_right)

    # per (frame, view) crop cameras from the enclosing points
    pts = enclosing[:, None].expand((t, v) + enclosing.shape[1:])
    mirror = is_right.expand(t, v)
    cc = crop_mod.gen_crop_camera(extrinsics, pts, crop_size, mirror, 0.0, focal_multiplier)
    new_K = crop_mod.intrinsics_matrix_from_crop(cc)
    new_w2e = cc.T_world_to_eye

    resample = compute_resample_matrix(intrinsics, extrinsics, new_K, affine.rigid_inverse(new_w2e))
    # a copy: the packed views are a read-only memory map
    imgs = torch.as_tensor(np.array(mono), device=device).reshape(t * v, *mono.shape[2:]).float()
    warped = warp_homography(imgs, resample.reshape(t * v, 4, 4), crop_size, bf16_rows=bf16_rows)
    warped = warped.reshape(t, v, crop_size[1], crop_size[0]) / 255.0

    return PackedSequence(
        left_images=warped,
        intrinsics=new_K,
        extrinsics=new_w2e,
        hand_idx=hand.to(torch.int64),
        gt_joint_angles=joint_angles,
        gt_wrist=wrist,
        solved_joint_angles=solved_angles,
        solved_wrist=solved_wrist,
        gt_hand_model=gt_hand,
        generic_hand_model=generic,
        pinch=pinch,
    )
