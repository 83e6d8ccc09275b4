"""The per-frame hand tracker (port of ``absolutetrack_tpu/tracker/tracker.py``).

``track_frame`` runs crop-camera synthesis, the fisheye->pinhole warp
(kernel K1 on the card), the network and unit conversions for one frame;
``track_sequence`` runs it frame by frame, carrying the state, with the
semantics of ``absolutetrack_tpu.apps.eval_lib.track_recording(
pipelined=False)``; ``track_frame_and_calibrate_scale`` is the
unknown-skeleton step; ``track_frame_from_2d`` the live demo's, with crops
from per-view 2D keypoints. World geometry is in mm; network extrinsics
and skeletons are in meters.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple, Optional, Tuple

import torch

from ..geometry import camera as cam, crop as crop_mod
from ..kinematics.hand_model import HandModel, scaled_hand_model
from ..kinematics.skinning import landmarks_from_hand_pose
from ..models.temporal import TemporalState
from ..models.umetrack import FrameInputs, SkeletonInputs, UmeTrackModel
from ..ops.resample import warp_perspective_crop
from .crop_gen import CropSlots, gen_crop_slots, gen_crop_slots_from_2d

MM_TO_M = 0.001
M_TO_MM = 1000.0
NUM_HANDS = 2
MAX_VIEWS = 2


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Runtime options (reference HandTrackerOpts, tracker.py:50-58)."""

    num_crop_points: int = 63
    enable_memory: bool = True
    hand_ratio_in_crop: float = 0.8
    min_required_vis_landmarks: int = 19
    crop_size: Tuple[int, int] = (96, 96)
    # true sensor (H, W) when frames arrive zero-padded (e.g. 480x636
    # uploaded as 512x640); sampling semantics are those of the unpadded frame
    src_valid_hw: Optional[Tuple[int, int]] = None


def samples_bf16_rows(model: UmeTrackModel) -> bool:
    """A bf16 model (the serving preset) samples its crops with bf16 row
    weights, as every Pallas warp kernel does; an f32 model keeps the f32
    rows of JAX's gather."""
    return model.cfg.dtype == torch.bfloat16


class TrackerState(NamedTuple):
    temporal: TemporalState  # batch = NUM_HANDS slots
    valid_history: torch.Tensor  # (NUM_HANDS,) bool


class TrackFrameResult(NamedTuple):
    """Per-frame outputs for both hand slots (masked by ``hand_valid``).

    joint_angles (NUM_HANDS, 22); wrist_xfs (NUM_HANDS, 4, 4) world, mm;
    hand_valid (NUM_HANDS,) bool; num_views (NUM_HANDS,) int.
    """

    joint_angles: torch.Tensor
    wrist_xfs: torch.Tensor
    hand_valid: torch.Tensor
    num_views: torch.Tensor
    predicted_scales: Optional[torch.Tensor] = None


class SequenceResult(NamedTuple):
    """``track_sequence`` outputs, frame-major: (T, NUM_HANDS, ...).

    tracked_keypoints are the FK landmarks (mm) of the tracked poses.
    """

    joint_angles: torch.Tensor
    wrist_xfs: torch.Tensor
    hand_valid: torch.Tensor
    num_views: torch.Tensor
    tracked_keypoints: torch.Tensor


class HandTracker:
    """Tracker around a ``UmeTrackModel``; runs on the model's device.

    Inputs (frames, cameras, hand model, poses) must already be on that
    device (``Camera.to``, ``HandModel.to``).
    """

    def __init__(self, model: UmeTrackModel, opts: TrackerConfig = TrackerConfig()):
        self.model = model
        self.opts = opts

    @property
    def device(self) -> torch.device:
        return self.model.device

    def init_state(self) -> TrackerState:
        return TrackerState(
            temporal=self.model.init_state(NUM_HANDS),
            valid_history=torch.zeros(NUM_HANDS, dtype=torch.bool, device=self.device),
        )

    def make_inputs(
        self,
        state: TrackerState,
        images: torch.Tensor,  # (V, H, W) raw mono views, 0..255
        cameras: cam.Camera,  # batch (V,) with per-frame extrinsics (mm)
        slots: CropSlots,
        src_kind: str = cam.FISHEYE62,
    ) -> FrameInputs:
        """Warp the crops and build the dense network inputs."""
        n_slots = NUM_HANDS * MAX_VIEWS
        crop_w, crop_h = self.opts.crop_size
        flat = slots.cameras.map(lambda x: x.reshape((n_slots,) + x.shape[2:]))
        crop_cam = crop_mod.crop_camera_to_camera(flat, self.opts.crop_size)
        src_idx = slots.view_idx.reshape(-1)
        src_cams = cameras.map(lambda x: x[src_idx])

        crops = warp_perspective_crop(
            images,
            src_cams,
            src_idx,
            crop_cam,
            self.opts.crop_size,
            src_kind=src_kind,
            src_valid_hw=self.opts.src_valid_hw,
            bf16_rows=samples_bf16_rows(self.model),
        )
        crops = crops.reshape(NUM_HANDS, MAX_VIEWS, crop_h, crop_w) / 255.0
        crops = torch.where(slots.view_valid[..., None, None], crops, 0.0)

        extrinsics = slots.cameras.T_world_to_eye.clone()
        extrinsics[..., :3, 3] = extrinsics[..., :3, 3] * MM_TO_M
        if self.opts.enable_memory:
            use_memory = state.valid_history & slots.hand_valid
        else:
            use_memory = torch.zeros_like(slots.hand_valid)
        return FrameInputs(
            left_images=crops,
            intrinsics=crop_mod.intrinsics_matrix_from_crop(slots.cameras),
            extrinsics=extrinsics,
            view_mask=slots.view_valid,
            hand_idx=torch.arange(NUM_HANDS, device=images.device),
            use_memory=use_memory,
            sample_mask=slots.hand_valid,
        )

    def _finish(self, state, new_temporal, slots, out) -> Tuple[TrackerState, TrackFrameResult]:
        wrist_mm = out.wrist_xfs.clone()
        wrist_mm[..., :3, 3] = wrist_mm[..., :3, 3] * M_TO_MM
        # invalid hands keep their previous memory; use_memory=False zeroes
        # it on revival (reference temporal.py:59-63 + tracker.py:399-406)
        valid = slots.hand_valid
        mem = torch.where(
            valid[:, None, None, None], new_temporal.mem_features, state.temporal.mem_features
        )
        prev_ext = torch.where(
            valid[:, None, None], new_temporal.prev_extrinsics, state.temporal.prev_extrinsics
        )
        new_state = TrackerState(
            temporal=TemporalState(mem_features=mem, prev_extrinsics=prev_ext),
            valid_history=valid,
        )
        result = TrackFrameResult(
            joint_angles=out.joint_angles,
            wrist_xfs=wrist_mm,
            hand_valid=valid,
            num_views=torch.sum(slots.view_valid, dim=-1),
            predicted_scales=out.skel_scales,
        )
        return new_state, result

    def crop_slots(
        self,
        cameras: cam.Camera,
        camera_angles: torch.Tensor,
        hand_model_mm: HandModel,
        prev_joint_angles: torch.Tensor,
        prev_wrist_mm: torch.Tensor,
        hand_confidences: torch.Tensor,
        min_num_crops: int = 1,
        src_kind: str = cam.FISHEYE62,
    ) -> CropSlots:
        """The frame's crop slots from a given pose (reference tracker.py:222-260)."""
        return gen_crop_slots(
            cameras,
            camera_angles,
            hand_model_mm,
            prev_joint_angles,
            prev_wrist_mm,
            hand_confidences,
            self.opts.crop_size,
            num_crop_points=self.opts.num_crop_points,
            min_num_crops=min_num_crops,
            min_required_vis_landmarks=self.opts.min_required_vis_landmarks,
            focal_multiplier=self.opts.hand_ratio_in_crop,
            src_kind=src_kind,
        )

    @staticmethod
    def skeleton_inputs(hand_model_mm: HandModel) -> SkeletonInputs:
        """Known-skeleton conditioning in meters, shared by both hand slots."""
        hand_model_m = scaled_hand_model(hand_model_mm, MM_TO_M)
        return SkeletonInputs(
            joint_rotation_axes=hand_model_m.joint_rotation_axes.expand(1, 22, 3),
            joint_rest_positions=hand_model_m.joint_rest_positions.expand(1, 22, 3),
        )

    @torch.no_grad()
    def track_frame(
        self,
        state: TrackerState,
        images: torch.Tensor,  # (V, H, W) uint8 (or f32/bf16) views
        cameras: cam.Camera,  # batch (V,)
        camera_angles: torch.Tensor,  # (V,)
        hand_model_mm: HandModel,
        prev_joint_angles: torch.Tensor,  # (NUM_HANDS, 22) pose used for crops
        prev_wrist_mm: torch.Tensor,  # (NUM_HANDS, 4, 4)
        hand_confidences: torch.Tensor,  # (NUM_HANDS,)
        min_num_crops: int = 1,
        src_kind: str = cam.FISHEYE62,
    ) -> Tuple[TrackerState, TrackFrameResult]:
        """Known-skeleton tracking step (reference track_frame, tracker.py:262-289)."""
        slots = self.crop_slots(
            cameras, camera_angles, hand_model_mm, prev_joint_angles,
            prev_wrist_mm, hand_confidences, min_num_crops, src_kind,
        )
        frame = self.make_inputs(state, images, cameras, slots, src_kind)
        new_temporal, out = self.model.regress_pose_use_skeleton(
            state.temporal, frame, self.skeleton_inputs(hand_model_mm)
        )
        return self._finish(state, new_temporal, slots, out)

    @torch.no_grad()
    def track_frame_and_calibrate_scale(
        self,
        state: TrackerState,
        images: torch.Tensor,
        cameras: cam.Camera,
        camera_angles: torch.Tensor,
        hand_model_mm: HandModel,
        prev_joint_angles: torch.Tensor,
        prev_wrist_mm: torch.Tensor,
        hand_confidences: torch.Tensor,
        src_kind: str = cam.FISHEYE62,
    ) -> Tuple[TrackerState, TrackFrameResult]:
        """Unknown-skeleton step: predicts a per-hand skeleton scale; crops
        need two views (reference tracker.py:235-271)."""
        slots = self.crop_slots(
            cameras, camera_angles, hand_model_mm, prev_joint_angles,
            prev_wrist_mm, hand_confidences, 2, src_kind,
        )
        frame = self.make_inputs(state, images, cameras, slots, src_kind)
        new_temporal, out = self.model.regress_pose_pred_skel_scale(state.temporal, frame)
        return self._finish(state, new_temporal, slots, out)

    @torch.no_grad()
    def track_frame_from_2d(
        self,
        state: TrackerState,
        images: torch.Tensor,  # (V, H, W) stereo views
        cameras: cam.Camera,  # batch (V,) == MAX_VIEWS
        hand_model_mm: HandModel,
        keypoints_2d: torch.Tensor,  # (NUM_HANDS, V, 21, 2) window coords
        keypoints_valid: torch.Tensor,  # (NUM_HANDS, V) bool
        src_kind: str = cam.FISHEYE62,
    ) -> Tuple[TrackerState, TrackFrameResult]:
        """Live-demo step: crops from per-view 2D detections, not a
        previous 3D pose (reference tracker.py:111-219)."""
        slots = gen_crop_slots_from_2d(
            cameras, keypoints_2d, keypoints_valid, self.opts.crop_size,
            focal_multiplier=self.opts.hand_ratio_in_crop, src_kind=src_kind,
        )
        frame = self.make_inputs(state, images, cameras, slots, src_kind)
        new_temporal, out = self.model.regress_pose_use_skeleton(
            state.temporal, frame, self.skeleton_inputs(hand_model_mm)
        )
        return self._finish(state, new_temporal, slots, out)

    @torch.no_grad()
    def track_sequence(
        self,
        frames: Iterable[torch.Tensor],  # T x (V, H, W)
        cameras: cam.Camera,  # batch (V,) intrinsics
        camera_to_world: torch.Tensor,  # (T, V, 4, 4) per-frame extrinsics, mm
        camera_angles: torch.Tensor,  # (V,)
        hand_model_mm: HandModel,
        joint_angles: torch.Tensor,  # (T, NUM_HANDS, 22) given poses
        wrist_mm: torch.Tensor,  # (T, NUM_HANDS, 4, 4)
        hand_confidences: torch.Tensor,  # (T, NUM_HANDS)
        feedback: bool = False,
        state: Optional[TrackerState] = None,
        min_num_crops: int = 1,
        src_kind: str = cam.FISHEYE62,
    ) -> Tuple[TrackerState, SequenceResult]:
        """Track frame by frame, carrying the state.

        ``feedback=False``: crops come from the given per-frame poses (the
        eval protocol). ``feedback=True``: frame 0's crops come from the
        given pose, every later frame's from the previous tracked pose
        where that hand was valid (live tracking, as in ``bench.py``).
        """
        if state is None:
            state = self.init_state()
        hand_b = hand_model_mm.map(lambda x: x.expand((NUM_HANDS,) + x.shape))
        hand_idx = torch.arange(NUM_HANDS, device=self.device)
        ja_t, wr_t = joint_angles[0], wrist_mm[0]
        outs = []
        for t, images in enumerate(frames):
            if not feedback:
                ja_t, wr_t = joint_angles[t], wrist_mm[t]
            cams = cameras._replace(T_world_from_eye=camera_to_world[t])
            state, res = self.track_frame(
                state, images, cams, camera_angles, hand_model_mm,
                ja_t, wr_t, hand_confidences[t],
                min_num_crops=min_num_crops, src_kind=src_kind,
            )
            if feedback:
                ja_t = torch.where(res.hand_valid[:, None], res.joint_angles, ja_t)
                wr_t = torch.where(res.hand_valid[:, None, None], res.wrist_xfs, wr_t)
            lm = landmarks_from_hand_pose(hand_b, res.joint_angles, res.wrist_xfs, hand_idx)
            outs.append((res.joint_angles, res.wrist_xfs, res.hand_valid, res.num_views, lm))
        return state, SequenceResult(*(torch.stack(x) for x in zip(*outs)))
