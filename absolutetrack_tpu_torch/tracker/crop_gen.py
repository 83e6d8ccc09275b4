"""Crop-camera generation from hand poses (port of ``absolutetrack_tpu/tracker/crop_gen.py``).

One function over fixed (NUM_HANDS x MAX_VIEWS) slots: FK of up to three
poses per hand gives the crop bounding points; per-camera visibility
counts pick the two lowest-indexed eligible cameras; a look-at crop camera
is built per slot. It takes one frame (cameras ``(V,)``, an unbatched hand
model) or any leading batch ``B...`` of samples, each with its own cameras
and hand model: the batch is a tensor axis, not a loop, and stands in for
``jax.vmap(gen_crop_slots)`` (``tracker/batched.py:65-87``).
``gen_crop_slots_from_2d`` drives the crops from per-view 2D keypoints
(the live demo).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..geometry import affine, camera as cam, crop
from ..kinematics import hand_model as hm
from ..kinematics.hand_model import HandModel, neutral_joint_angles
from ..kinematics.skinning import landmarks_from_hand_pose

CONFIDENCE_THRESHOLD = 0.5  # reference tracker.py:36
MAX_VIEWS = 2  # reference tracker.py:37


class CropSlots(NamedTuple):
    """Fixed-capacity crop assignment for one frame (or ``B...`` samples,
    which lead every shape).

    view_idx   : (B..., NUM_HANDS, MAX_VIEWS) int64 source-camera index per slot
    view_valid : (B..., NUM_HANDS, MAX_VIEWS) bool
    hand_valid : (B..., NUM_HANDS) bool
    cameras    : CropCamera with batch shape (B..., NUM_HANDS, MAX_VIEWS)
    """

    view_idx: torch.Tensor
    view_valid: torch.Tensor
    hand_valid: torch.Tensor
    cameras: crop.CropCamera


def _crop_points(hand: HandModel, joint_angles, wrist, num_crop_points: int):
    """(B..., H, num_crop_points, 3) bounding points: the actual, neutral and
    open poses through one batched FK call, pose-major per hand."""
    if num_crop_points not in (21, 42, 63):
        raise ValueError(f"num_crop_points must be 21, 42 or 63, got {num_crop_points}")
    lead, h = joint_angles.shape[:-2], joint_angles.shape[-2]
    nb = len(lead)
    n_poses = num_crop_points // 21

    poses = [joint_angles]
    if n_poses > 1:
        poses.append(neutral_joint_angles(hand)[..., None, :].expand(joint_angles.shape))
    if n_poses > 2:
        poses.append(torch.zeros_like(joint_angles))

    angles_b = torch.stack(poses, dim=nb)  # (B..., n_poses, H, 22)
    wrist_b = wrist.unsqueeze(nb).expand(lead + (n_poses,) + wrist.shape[nb:])
    hand_idx_b = torch.arange(h, device=wrist.device).expand(n_poses, h)
    hand_b = hand.map(
        lambda x: x.reshape(lead + (1, 1) + x.shape[nb:]).expand(lead + (n_poses, h) + x.shape[nb:])
    )
    pts = landmarks_from_hand_pose(hand_b, angles_b, wrist_b, hand_idx_b)
    return pts.movedim(nb, nb + 1).reshape(lead + (h, n_poses * 21, 3))


def _visibility_counts(cameras: cam.Camera, landmarks_world, src_kind: str):
    """(B..., H, V) count of landmarks inside each camera's window with z > 0;
    cameras (B..., V), landmarks (B..., H, 21, 3)."""
    nb = landmarks_world.dim() - 3
    cams = cameras.map(lambda x: x.unsqueeze(nb))  # (B..., 1, V): broadcast over hands
    eye = cam.world_to_eye(cams, landmarks_world.unsqueeze(-3))
    win = cam.eye_to_window(cams, eye, src_kind)
    w = cams.width[..., None]
    h = cams.height[..., None]
    vis = (
        (win[..., 0] >= 0)
        & (win[..., 0] <= w - 1)
        & (win[..., 1] >= 0)
        & (win[..., 1] <= h - 1)
        & (eye[..., 2] > 0)
    )
    return torch.sum(vis, dim=-1)


def _top2(score: torch.Tensor):
    """Top-2 along the last axis, ties to the lower index (as ``lax.top_k``);
    the stable sort keeps that rule in every row of a batch."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :MAX_VIEWS], idx[..., :MAX_VIEWS]


def gen_crop_slots(
    cameras: cam.Camera,  # batch (B..., V) source cameras with frame extrinsics
    camera_angles: torch.Tensor,  # (B..., V)
    hand: HandModel,  # fields (B..., ...), millimeters; unbatched for one frame
    joint_angles: torch.Tensor,  # (B..., NUM_HANDS, 22)
    wrist_transforms: torch.Tensor,  # (B..., NUM_HANDS, 4, 4) world, millimeters
    hand_confidences: torch.Tensor,  # (B..., NUM_HANDS)
    crop_size: Tuple[int, int],
    num_crop_points: int = 63,
    min_num_crops: int = 1,
    min_required_vis_landmarks: int = 19,
    focal_multiplier: float = 0.8,
    src_kind: str = cam.FISHEYE62,
    mirror_right_hand: bool = True,
    sort_camera_index: bool = True,
) -> CropSlots:
    """Batched equivalent of the reference HandTracker.gen_crop_cameras."""
    lead, n_hands = joint_angles.shape[:-2], joint_angles.shape[-2]
    nb = len(lead)
    device = joint_angles.device
    hand_idx = torch.arange(n_hands, device=device)

    pts = _crop_points(hand, joint_angles, wrist_transforms, num_crop_points)
    counts = _visibility_counts(cameras, pts[..., :21, :], src_kind)
    eligible = counts >= min_required_vis_landmarks

    n_cams = counts.shape[-1]
    neg_inf = torch.tensor(float("-inf"), device=device)
    if sort_camera_index:
        # the two lowest-indexed eligible cameras, not the two most visible
        order = -torch.arange(n_cams, device=device, dtype=torch.float32)
        score = torch.where(eligible, order, neg_inf)
    else:
        score = torch.where(eligible, counts.to(torch.float32), neg_inf)
    top_vals, view_idx = _top2(score)
    slot_valid = torch.isfinite(top_vals)

    confident = hand_confidences >= CONFIDENCE_THRESHOLD
    n_eligible = torch.sum(slot_valid, dim=-1)
    hand_valid = confident & (n_eligible >= min_num_crops)
    view_valid = slot_valid & confident[..., None] & hand_valid[..., None]

    # each sample's slots gather from that sample's own cameras
    flat_idx = view_idx.reshape(lead + (n_hands * MAX_VIEWS,))
    w2e = torch.take_along_dim(
        affine.rigid_inverse(cameras.T_world_from_eye), flat_idx[..., None, None], dim=nb
    ).reshape(lead + (n_hands, MAX_VIEWS, 4, 4))
    angles = torch.take_along_dim(camera_angles, flat_idx, dim=nb).reshape(
        lead + (n_hands, MAX_VIEWS)
    )

    if mirror_right_hand:
        mirror = (hand_idx == hm.RIGHT_HAND_INDEX)[:, None].expand(lead + (n_hands, MAX_VIEWS))
    else:
        mirror = torch.zeros(lead + (n_hands, MAX_VIEWS), dtype=torch.bool, device=device)
    crop_cams = crop.gen_crop_camera(
        w2e,
        pts.unsqueeze(-3).expand(lead + (n_hands, MAX_VIEWS) + pts.shape[-2:]),
        crop_size,
        mirror,
        camera_angle_deg=angles,
        focal_multiplier=focal_multiplier,
    )
    view_valid = view_valid & crop_cams.valid
    # slot 0 stays the anchor view: a hand whose slot-0 crop failed is
    # dropped this frame (the reference would raise there)
    hand_valid = (
        hand_valid & view_valid[..., 0] & (torch.sum(view_valid, dim=-1) >= min_num_crops)
    )
    view_valid = view_valid & hand_valid[..., None]

    return CropSlots(
        view_idx=view_idx,
        view_valid=view_valid,
        hand_valid=hand_valid,
        cameras=crop_cams,
    )


def gen_crop_slots_from_2d(
    cameras: cam.Camera,  # batch (V,) source cameras, V == MAX_VIEWS
    keypoints_2d: torch.Tensor,  # (NUM_HANDS, V, 21, 2) window coords
    keypoints_valid: torch.Tensor,  # (NUM_HANDS, V) bool
    crop_size: Tuple[int, int],
    focal_multiplier: float = 0.8,
    src_kind: str = cam.FISHEYE62,
) -> CropSlots:
    """Crop cameras from per-view 2D keypoints (the live-demo path): each
    view's keypoints unproject to unit-depth points in world space, and a
    look-at crop camera per (hand, view) bounds them; right hands mirror.
    View slot v uses source camera v (a stereo rig); slot 0 anchors the hand
    (reference tracker.py:111-219)."""
    n_hands, v = keypoints_2d.shape[:2]
    if v != MAX_VIEWS:
        raise ValueError(f"the 2D path takes {MAX_VIEWS} views, got {v}")
    device = keypoints_2d.device
    rays = cam.window_to_eye(cameras, keypoints_2d, src_kind)  # (H, V, 21, 3)
    pts_world = cam.eye_to_world(cameras, rays)
    w2e = affine.rigid_inverse(cameras.T_world_from_eye).expand(n_hands, v, 4, 4)
    mirror = (torch.arange(n_hands, device=device) == hm.RIGHT_HAND_INDEX)[:, None].expand(n_hands, v)
    crop_cams = crop.gen_crop_camera(
        w2e, pts_world, crop_size, mirror, camera_angle_deg=0.0, focal_multiplier=focal_multiplier
    )
    view_valid = keypoints_valid & crop_cams.valid
    hand_valid = view_valid[:, 0]
    return CropSlots(
        view_idx=torch.arange(v, device=device).expand(n_hands, v),
        view_valid=view_valid & hand_valid[:, None],
        hand_valid=hand_valid,
        cameras=crop_cams,
    )
