"""Batched multi-recording tracker (port of ``absolutetrack_tpu/tracker/batched.py``).

R recordings advance in lockstep: one step's batch is (R recordings x
NUM_HANDS hand slots), each recording with its own cameras, hand model,
temporal memory and validity history, so per recording the results are
those of the sequential ``HandTracker``. The source views flatten to
``(R*V, H, W)`` and all R*NUM_HANDS*MAX_VIEWS crops go through one warp
call: on the card, one launch of K1.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..geometry import camera as cam, crop as crop_mod
from ..kinematics.hand_model import HandModel, scaled_hand_model
from ..models.temporal import TemporalState
from ..models.umetrack import FrameInputs, SkeletonInputs, UmeTrackModel
from ..ops.resample import warp_perspective_crop
from ..ops.warp_kernel import view_index
from .crop_gen import CropSlots, gen_crop_slots
from .tracker import (
    MAX_VIEWS,
    MM_TO_M,
    M_TO_MM,
    NUM_HANDS,
    TrackerConfig,
    TrackerState,
    TrackFrameResult,
    samples_bf16_rows,
)


class BatchedTracker:
    """Tracker over R recordings x NUM_HANDS hand slots; runs on the model's device.

    State: ``temporal`` batches R*NUM_HANDS memory slots, ``valid_history``
    is (R, NUM_HANDS). Public outputs lead with (R, NUM_HANDS).
    """

    def __init__(self, model: UmeTrackModel, opts: TrackerConfig = TrackerConfig()):
        self.model = model
        self.opts = opts

    @property
    def device(self) -> torch.device:
        return self.model.device

    def init_state(self, num_recordings: int) -> TrackerState:
        return TrackerState(
            temporal=self.model.init_state(num_recordings * NUM_HANDS),
            valid_history=torch.zeros(
                (num_recordings, NUM_HANDS), dtype=torch.bool, device=self.device
            ),
        )

    # -- input assembly ---------------------------------------------------

    def _gen_slots(
        self,
        cameras: cam.Camera,  # batch (R, V), millimeters
        camera_angles: torch.Tensor,  # (R, V)
        hand_models: HandModel,  # fields batched (R, ...)
        joint_angles: torch.Tensor,  # (R, NUM_HANDS, 22)
        wrist_mm: torch.Tensor,  # (R, NUM_HANDS, 4, 4)
        confidences: torch.Tensor,  # (R, NUM_HANDS)
        min_num_crops: int,
        src_kind: str,
    ) -> CropSlots:
        return gen_crop_slots(
            cameras,
            camera_angles,
            hand_models,
            joint_angles,
            wrist_mm,
            confidences,
            self.opts.crop_size,
            num_crop_points=self.opts.num_crop_points,
            min_num_crops=min_num_crops,
            min_required_vis_landmarks=self.opts.min_required_vis_landmarks,
            focal_multiplier=self.opts.hand_ratio_in_crop,
            src_kind=src_kind,
        )

    def make_inputs(
        self,
        state: TrackerState,
        images: torch.Tensor,  # (R, V, H, W) raw mono views, 0..255
        cameras: cam.Camera,  # batch (R, V) with per-frame extrinsics (mm)
        slots: CropSlots,  # batch (R, NUM_HANDS, MAX_VIEWS)
        src_kind: str = cam.FISHEYE62,
    ) -> FrameInputs:
        """Warp all R*NUM_HANDS*MAX_VIEWS crops in one sampler call and build
        the dense (B = R*NUM_HANDS)-sample network inputs."""
        r, v = images.shape[0], images.shape[1]
        n_slots = r * NUM_HANDS * MAX_VIEWS
        crop_w, crop_h = self.opts.crop_size
        crop_cam = crop_mod.crop_camera_to_camera(
            slots.cameras.map(lambda x: x.reshape((n_slots,) + x.shape[3:])), self.opts.crop_size
        )
        # (recording, view) flatten into one source-image axis; the index
        # follows the sampler's rule for a view index
        offsets = torch.arange(r, device=images.device) * v
        src_idx = view_index(slots.view_idx + offsets[:, None, None], r * v).reshape(-1)
        src_cams = cameras.map(lambda x: x.reshape((r * v,) + x.shape[2:])[src_idx])

        crops = warp_perspective_crop(
            images.reshape((r * v,) + images.shape[2:]),
            src_cams,
            src_idx,
            crop_cam,
            self.opts.crop_size,
            src_kind=src_kind,
            src_valid_hw=self.opts.src_valid_hw,
            bf16_rows=samples_bf16_rows(self.model),
        )
        crops = crops.reshape(r * NUM_HANDS, MAX_VIEWS, crop_h, crop_w) / 255.0
        view_valid = slots.view_valid.reshape(r * NUM_HANDS, MAX_VIEWS)
        crops = torch.where(view_valid[..., None, None], crops, 0.0)

        extrinsics = slots.cameras.T_world_to_eye.reshape(r * NUM_HANDS, MAX_VIEWS, 4, 4).clone()
        extrinsics[..., :3, 3] = extrinsics[..., :3, 3] * MM_TO_M
        hand_valid = slots.hand_valid.reshape(-1)
        if self.opts.enable_memory:
            use_memory = state.valid_history.reshape(-1) & hand_valid
        else:
            use_memory = torch.zeros_like(hand_valid)
        return FrameInputs(
            left_images=crops,
            intrinsics=crop_mod.intrinsics_matrix_from_crop(slots.cameras).reshape(
                r * NUM_HANDS, MAX_VIEWS, 3, 3
            ),
            extrinsics=extrinsics,
            view_mask=view_valid,
            hand_idx=torch.arange(NUM_HANDS, device=images.device).repeat(r),
            use_memory=use_memory,
            sample_mask=hand_valid,
        )

    @staticmethod
    def _skeleton_inputs(hand_models_mm: HandModel) -> SkeletonInputs:
        """Known-skeleton conditioning in meters, one per hand slot (R*2, 22, 3)."""
        hand_m = scaled_hand_model(hand_models_mm, MM_TO_M)
        return SkeletonInputs(
            joint_rotation_axes=hand_m.joint_rotation_axes.repeat_interleave(NUM_HANDS, dim=0),
            joint_rest_positions=hand_m.joint_rest_positions.repeat_interleave(NUM_HANDS, dim=0),
        )

    def _finish(
        self, state: TrackerState, new_temporal: TemporalState, slots: CropSlots, out
    ) -> Tuple[TrackerState, TrackFrameResult]:
        """Mask the state and convert units; reads only the slots' validity."""
        r = slots.hand_valid.shape[0]
        hand_valid = slots.hand_valid.reshape(-1)
        wrist_mm = out.wrist_xfs.clone()
        wrist_mm[..., :3, 3] = wrist_mm[..., :3, 3] * M_TO_MM
        # memory slots of invalid hands keep their previous content
        # (reference temporal.py:59-63 + tracker.py:399-406)
        mem = torch.where(
            hand_valid[:, None, None, None], new_temporal.mem_features, state.temporal.mem_features
        )
        prev_ext = torch.where(
            hand_valid[:, None, None], new_temporal.prev_extrinsics, state.temporal.prev_extrinsics
        )
        new_state = TrackerState(
            temporal=TemporalState(mem_features=mem, prev_extrinsics=prev_ext),
            valid_history=slots.hand_valid,
        )

        def split(x, trailing):
            return x.reshape((r, NUM_HANDS) + trailing)

        result = TrackFrameResult(
            joint_angles=split(out.joint_angles, (22,)),
            wrist_xfs=split(wrist_mm, (4, 4)),
            hand_valid=slots.hand_valid,
            num_views=torch.sum(slots.view_valid, dim=-1),
            predicted_scales=None if out.skel_scales is None else split(out.skel_scales, ()),
        )
        return new_state, result

    # -- public steps -----------------------------------------------------

    @torch.no_grad()
    def track_frames(
        self,
        state: TrackerState,
        images: torch.Tensor,  # (R, V, H, W)
        cameras: cam.Camera,  # batch (R, V)
        camera_angles: torch.Tensor,  # (R, V)
        hand_models_mm: HandModel,  # fields batched (R, ...)
        prev_joint_angles: torch.Tensor,  # (R, NUM_HANDS, 22)
        prev_wrist_mm: torch.Tensor,  # (R, NUM_HANDS, 4, 4)
        hand_confidences: torch.Tensor,  # (R, NUM_HANDS)
        min_num_crops: int = 1,
        src_kind: str = cam.FISHEYE62,
    ) -> Tuple[TrackerState, TrackFrameResult]:
        """Known-skeleton step over all recordings at once."""
        slots = self._gen_slots(
            cameras, camera_angles, hand_models_mm, prev_joint_angles,
            prev_wrist_mm, hand_confidences, min_num_crops, src_kind,
        )
        frame = self.make_inputs(state, images, cameras, slots, src_kind)
        new_temporal, out = self.model.regress_pose_use_skeleton(
            state.temporal, frame, self._skeleton_inputs(hand_models_mm)
        )
        return self._finish(state, new_temporal, slots, out)

    @torch.no_grad()
    def track_frames_and_calibrate_scale(
        self,
        state: TrackerState,
        images: torch.Tensor,
        cameras: cam.Camera,
        camera_angles: torch.Tensor,
        hand_models_mm: HandModel,
        prev_joint_angles: torch.Tensor,
        prev_wrist_mm: torch.Tensor,
        hand_confidences: torch.Tensor,
        src_kind: str = cam.FISHEYE62,
    ) -> Tuple[TrackerState, TrackFrameResult]:
        """Unknown-skeleton step: predicts per-hand skeleton scales; crops
        need two views (reference run_eval_unknown_skeleton.py:58-64)."""
        slots = self._gen_slots(
            cameras, camera_angles, hand_models_mm, prev_joint_angles,
            prev_wrist_mm, hand_confidences, 2, src_kind,
        )
        frame = self.make_inputs(state, images, cameras, slots, src_kind)
        new_temporal, out = self.model.regress_pose_pred_skel_scale(state.temporal, frame)
        return self._finish(state, new_temporal, slots, out)
