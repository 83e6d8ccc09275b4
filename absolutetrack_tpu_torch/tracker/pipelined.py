"""Pipelined eval tracking (port of ``absolutetrack_tpu/tracker/pipelined.py``).

In the eval protocols the crops come from a pose known per frame in
advance, so crop slots, the warp, the backbone and the multi-view fusion
are independent across frames; only the ConvRNN memory and the regression
head after it are sequential. Phase A runs the independent part for all
F frames (of all R recordings) as one batch; phase B steps the tail over
the F frames with the memory carried, a Python loop where JAX scans.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..geometry import camera as cam
from ..kinematics.hand_model import HandModel
from ..models.umetrack import UmeTrackModel
from ..utils import profiling
from .batched import BatchedTracker
from .crop_gen import CropSlots
from .tracker import NUM_HANDS, TrackerConfig, TrackerState, TrackFrameResult

StageHook = Optional[Callable[[str], None]]


@torch.no_grad()
def track_chunk_eval_batched(
    model: UmeTrackModel,
    opts: TrackerConfig,
    state: TrackerState,  # BatchedTracker state: valid_history (R, 2)
    images_seq: torch.Tensor,  # (F, R, V, H, W); (R, F, V, H, W) when images_rec_major
    cameras: cam.Camera,  # batch (R, V), extrinsics overridden per frame
    camera_to_world_seq: torch.Tensor,  # (F, R, V, 4, 4)
    camera_angles: torch.Tensor,  # (R, V)
    hand_models_mm: HandModel,  # fields batched (R, ...)
    joint_angles_seq: torch.Tensor,  # (F, R, NUM_HANDS, 22)
    wrist_mm_seq: torch.Tensor,  # (F, R, NUM_HANDS, 4, 4)
    confidences_seq: torch.Tensor,  # (F, R, NUM_HANDS)
    min_num_crops: int = 1,
    src_kind: str = cam.FISHEYE62,
    calibrate_scale: bool = False,
    images_rec_major: bool = False,
    stage_hook: StageHook = None,
) -> Tuple[TrackerState, TrackFrameResult]:
    """R recordings x F frames, the trunk batched over both -> results (F, R, NUM_HANDS, ...).

    Phase A treats the (recording, frame) pairs as one recording-major batch
    (flat index = recording * F + frame); phase B steps the frames with the
    R*NUM_HANDS memory slots as the carry. ``stage_hook``, if given, is
    called with each stage's name as the stage ends (crop_slots,
    warp_and_inputs, trunk, scan_tail), for a caller's timing; under a
    profiler each stage is also an ``eval.<stage>`` span
    (``utils/profiling.py``).
    """
    mark = stage_hook or (lambda name: None)
    if images_rec_major:
        r, f = images_seq.shape[0], images_seq.shape[1]
    else:
        f, r = images_seq.shape[0], images_seq.shape[1]
    bt = BatchedTracker(model, opts)

    def flat(x):  # (F, R, ...) -> (R*F, ...), recording-major
        return x.transpose(0, 1).reshape((r * f,) + x.shape[2:])

    def rep(x):  # (R, ...) -> (R*F, ...), recording-major repeat
        return x.unsqueeze(1).expand((r, f) + x.shape[1:]).reshape((r * f,) + x.shape[1:])

    dev = model.device
    cams_fr = cameras.map(rep)._replace(T_world_from_eye=flat(camera_to_world_seq))
    with profiling.span("eval.crop_slots", dev):
        slots = bt._gen_slots(
            cams_fr,
            rep(camera_angles),
            hand_models_mm.map(rep),
            flat(joint_angles_seq),
            flat(wrist_mm_seq),
            flat(confidences_seq),
            2 if calibrate_scale else min_num_crops,
            src_kind,
        )
    mark("crop_slots")
    with profiling.span("eval.warp_and_inputs", dev):
        # use_memory of phase A's inputs is a placeholder: phase B sets it per frame
        dummy = bt.init_state(r * f)
        images_flat = (
            images_seq.reshape((r * f,) + images_seq.shape[2:]) if images_rec_major else flat(images_seq)
        )
        frame_all = bt.make_inputs(dummy, images_flat, cams_fr, slots, src_kind)
    mark("warp_and_inputs")
    with profiling.span("eval.trunk", dev):
        feats_all = model.extract_features(frame_all)  # (R*F*2, h, w, C)
        skel_all = None
        if not calibrate_scale:
            skel_all = model.encode_skeleton(bt._skeleton_inputs(hand_models_mm), r * NUM_HANDS)
    mark("trunk")

    def at(x, t):  # frame t, time-major for the tail: (R*F*2, ...) -> (R*2, ...), (R*F, 2, ...) -> (R, 2, ...)
        return x.unflatten(0, (r, f, -1))[:, t].flatten(0, 1)

    outs = []
    with profiling.span("eval.scan_tail", dev):
        for t in range(f):
            slots_t = CropSlots(
                view_idx=None, cameras=None,
                view_valid=at(slots.view_valid, t), hand_valid=at(slots.hand_valid, t),
            )
            hand_valid = slots_t.hand_valid.reshape(-1)  # (R*2,)
            if opts.enable_memory:
                use_memory = state.valid_history.reshape(-1) & hand_valid
            else:
                use_memory = torch.zeros_like(hand_valid)
            # the tail reads neither the crops nor the intrinsics
            frame_t = frame_all._replace(
                left_images=None,
                intrinsics=None,
                extrinsics=at(frame_all.extrinsics, t),
                view_mask=at(frame_all.view_mask, t),
                hand_idx=at(frame_all.hand_idx, t),
                use_memory=use_memory,
                sample_mask=hand_valid,
            )
            new_t, out = model.regress_from_features(state.temporal, frame_t, at(feats_all, t), skel_all)
            state, res = bt._finish(state, new_t, slots_t, out)
            outs.append(res)
    mark("scan_tail")
    return state, stack_results(outs)


def stack_results(results) -> TrackFrameResult:
    """Per-frame ``TrackFrameResult``s -> one with a leading frame axis."""
    return TrackFrameResult(*(None if xs[0] is None else torch.stack(xs) for xs in zip(*results)))


def track_chunk_eval(
    model: UmeTrackModel,
    opts: TrackerConfig,
    state: TrackerState,  # sequential tracker state (2 hand slots)
    images_seq: torch.Tensor,  # (F, V, H, W) raw mono views
    cameras: cam.Camera,  # batch (V,), extrinsics overridden per frame
    camera_to_world_seq: torch.Tensor,  # (F, V, 4, 4)
    camera_angles: torch.Tensor,  # (V,)
    hand_model_mm: HandModel,  # unbatched, millimeters
    joint_angles_seq: torch.Tensor,  # (F, NUM_HANDS, 22) crop-driving poses
    wrist_mm_seq: torch.Tensor,  # (F, NUM_HANDS, 4, 4)
    confidences_seq: torch.Tensor,  # (F, NUM_HANDS)
    min_num_crops: int = 1,
    src_kind: str = cam.FISHEYE62,
    calibrate_scale: bool = False,
) -> Tuple[TrackerState, TrackFrameResult]:
    """Track F frames of one recording -> results stacked on F.

    The one-recording case of ``track_chunk_eval_batched``: with R = 1 its
    recording-major flat index is the frame-major one of JAX's
    ``track_chunk_eval``, where the F frames play the recordings.
    """
    one = lambda x: x.unsqueeze(0)  # noqa: E731
    time_major = lambda x: x.unsqueeze(1)  # noqa: E731
    state, res = track_chunk_eval_batched(
        model, opts,
        TrackerState(temporal=state.temporal, valid_history=one(state.valid_history)),
        one(images_seq), cameras.map(one), time_major(camera_to_world_seq),
        one(camera_angles), hand_model_mm.map(one), time_major(joint_angles_seq),
        time_major(wrist_mm_seq), time_major(confidences_seq),
        min_num_crops=min_num_crops, src_kind=src_kind,
        calibrate_scale=calibrate_scale, images_rec_major=True,
    )
    return (
        TrackerState(temporal=state.temporal, valid_history=state.valid_history[0]),
        TrackFrameResult(*(None if x is None else x[:, 0] for x in res)),
    )
