"""Evaluation driver (port of ``absolutetrack_tpu/apps/eval_lib.py``).

``build_model`` gives the network, from a checkpoint or seeded. The
driver tracks recordings with crops from the labelled per-frame poses and returns
the reference's per-sequence payload (tracked and GT FK landmarks,
validity), hands-major, as numpy. ``track_recording`` runs one recording in
chunks; ``track_recordings_batched`` runs R recordings in lockstep. With
``pipelined=True`` (the default) each chunk is one
``track_chunk_eval[_batched]`` call: crops, warp and trunk batched over the
chunk, the ConvRNN tail stepped per frame. With ``pipelined=False`` the
chunk runs the per-frame step. Device results stay on the device until
every chunk has been issued. ``frames_for`` picks a recording's frames
(its video, else a synthetic renderer). The eval CLIs
(``run_eval_known_skeleton``, ``run_eval_unknown_skeleton``) drive it.
With ``mesh=`` (a ``parallel.Mesh`` of several ranks) the lockstep splits
its recordings over the 'data' axis: each rank tracks its contiguous
block, and every rank returns all results.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Iterable, List, Optional

import numpy as np
import torch

from ..geometry import camera as cam
from ..kinematics.hand_model import HandModel, stack_hand_models
from ..kinematics.skinning import landmarks_from_hand_pose
from ..models.checkpoint import load_any
from ..models.config import ModelConfig
from ..models.params import load_jax_params
from ..models.umetrack import UmeTrackModel
from ..tracker.batched import BatchedTracker
from ..tracker.pipelined import StageHook, stack_results, track_chunk_eval, track_chunk_eval_batched
from ..tracker.tracker import HandTracker, TrackerConfig
from ..tracker.video_data import (  # noqa: F401  (gt_landmark_sequence: re-export)
    HandPoseLabels,
    VideoFrameSource,
    gt_landmark_sequence,
    make_frame_source,
)
from ..utils import profiling

NUM_HANDS = 2
NUM_LANDMARKS = 21


def build_model(
    checkpoint: Optional[str] = None, cfg: ModelConfig = ModelConfig(), seed: int = 0, device=None
) -> UmeTrackModel:
    """The network on ``cuda`` unless ``device`` is given, with the weights of
    ``checkpoint`` (the reference's torch state dict or a flax-msgpack param
    file, ``models/checkpoint.py::load_any``) or, without one, seeded random
    weights; ``cfg=ModelConfig.serving()`` gives the bf16 serving trunk."""
    if checkpoint:
        return load_jax_params(load_any(checkpoint, cfg), cfg, device=device)
    return UmeTrackModel(cfg, device=device, generator=torch.Generator().manual_seed(seed))


@dataclasses.dataclass
class SequenceResult:
    """Same payload as the reference's per-sequence pickle
    (run_eval_known_skeleton.py:96-104), hands-major."""

    tracked_keypoints: np.ndarray  # (2, T, 21, 3)
    gt_keypoints: np.ndarray  # (2, T, 21, 3)
    valid_tracking: np.ndarray  # (2, T)
    predicted_scales: Optional[np.ndarray] = None  # (2, T)
    joint_angles: Optional[np.ndarray] = None  # (2, T, 22) raw predictions
    wrist_xfs: Optional[np.ndarray] = None  # (2, T, 4, 4) world, mm


def _prepad_opts(opts: TrackerConfig, labels: HandPoseLabels):
    """Frames upload zero-padded (rows to 256-multiples, cols to
    128-multiples) with ``src_valid_hw`` recording the true sensor extent;
    sampling is unchanged. Returns (opts, pad_hw), pad_hw None when already
    aligned or when the caller pinned ``src_valid_hw`` itself."""
    h = int(labels.cameras.height.reshape(-1)[0])
    w = int(labels.cameras.width.reshape(-1)[0])
    hp, wp = -(-h // 256) * 256, -(-w // 128) * 128
    if opts.src_valid_hw is not None or (hp == h and wp == w):
        return opts, None
    return dataclasses.replace(opts, src_valid_hw=(h, w)), (hp, wp)


def _pad_frames(images: np.ndarray, pad_hw) -> np.ndarray:
    """(..., H, W) -> (..., hp, wp) zero-padded (contiguous as it is when pad_hw is None)."""
    if pad_hw is None:
        return np.ascontiguousarray(images)
    hp, wp = pad_hw
    h, w = images.shape[-2:]
    if h > hp or w > wp:
        # a silent truncation to the label cameras' extent would sample a
        # cropped region
        raise ValueError(
            f"frame dims ({h}, {w}) exceed the label cameras' padded "
            f"extent ({hp}, {wp}); frames and labels disagree"
        )
    out = np.zeros(images.shape[:-2] + (hp, wp), images.dtype)
    out[..., :h, :w] = images
    return out


def _frames_to_axis(x: torch.Tensor, n: int, axis: int) -> np.ndarray:
    """The first ``n`` frames of a frame-major device result, frame axis moved to ``axis``."""
    return np.moveaxis(x[:n].cpu().numpy(), 0, axis)


def track_recording(
    model: UmeTrackModel,
    labels: HandPoseLabels,
    frames: Iterable[np.ndarray],
    hand_model_mm: Optional[HandModel] = None,
    opts: Optional[TrackerConfig] = None,
    min_num_crops: int = 1,
    calibrate_scale: bool = False,
    max_frames: Optional[int] = None,
    chunk_size: int = 8,
    pipelined: bool = True,
) -> SequenceResult:
    """Track one recording with GT-pose-driven crops, ``chunk_size`` frames
    at a time; the temporal state carries across frames and chunks. The
    tail chunk repeats its last frame up to ``chunk_size`` (results of the
    repeats are dropped)."""
    if opts is None:
        # crops must match the network's input size
        opts = TrackerConfig(crop_size=model.cfg.input_size)
    opts, pad_hw = _prepad_opts(opts, labels)
    dev = model.device
    tracker = HandTracker(model, opts)
    hand_mm = (hand_model_mm if hand_model_mm is not None else labels.hand_model).to(dev)
    camera_angles = torch.as_tensor(labels.camera_angles, device=dev)
    base_cams = labels.cameras.to(dev)
    src_kind = labels.camera_kind

    def run_chunk(state, images_c, cam_c, ja_c, wr_c, conf_c):
        if pipelined:
            return track_chunk_eval(
                model, opts, state, images_c, base_cams, cam_c, camera_angles, hand_mm,
                ja_c, wr_c, conf_c, min_num_crops=min_num_crops, src_kind=src_kind,
                calibrate_scale=calibrate_scale,
            )
        outs = []
        for i in range(images_c.shape[0]):
            args = (
                state, images_c[i], base_cams._replace(T_world_from_eye=cam_c[i]),
                camera_angles, hand_mm, ja_c[i], wr_c[i], conf_c[i],
            )
            if calibrate_scale:
                state, res = tracker.track_frame_and_calibrate_scale(*args, src_kind=src_kind)
            else:
                state, res = tracker.track_frame(*args, min_num_crops=min_num_crops, src_kind=src_kind)
            outs.append(res)
        return state, stack_results(outs)

    t_total = len(labels) if max_frames is None else min(max_frames, len(labels))
    tracked = np.zeros((NUM_HANDS, t_total, NUM_LANDMARKS, 3), np.float32)
    gt = np.zeros_like(tracked)
    valid = np.zeros((NUM_HANDS, t_total), bool)
    scales = np.zeros((NUM_HANDS, t_total), np.float32)
    raw_angles = np.zeros((NUM_HANDS, t_total, 22), np.float32)
    raw_wrists = np.zeros((NUM_HANDS, t_total, 4, 4), np.float32)

    # tracked landmarks FK with the tracking hand model, GT landmarks with
    # the recording's own
    hand_idx = torch.arange(NUM_HANDS, device=dev)
    hand_b = hand_mm.map(lambda x: x.expand((NUM_HANDS,) + x.shape))
    gt_hand_b = labels.hand_model.to(dev).map(lambda x: x.expand((NUM_HANDS,) + x.shape))

    state = tracker.init_state()
    frame_iter = iter(frames)
    pending = []  # (t_start, n, res, tracked landmarks, gt landmarks) on the device
    t = 0
    while t < t_total:
        chunk_frames = list(itertools.islice(frame_iter, min(chunk_size, t_total - t)))
        if not chunk_frames:
            break
        n = len(chunk_frames)
        sl = slice(t, t + n)
        pad = chunk_size - n

        def pad0(a):
            return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)]) if pad else a

        def upload(a):
            return torch.as_tensor(pad0(a), device=dev)

        ja_c, wr_c = upload(labels.joint_angles[sl]), upload(labels.wrist_transforms[sl])
        with torch.no_grad():
            state, res = run_chunk(
                state, upload(_pad_frames(np.asarray(chunk_frames), pad_hw)),
                upload(labels.camera_to_world[sl]), ja_c, wr_c, upload(labels.hand_confidences[sl]),
            )
            pending.append((
                t, n, res,
                landmarks_from_hand_pose(hand_b, res.joint_angles, res.wrist_xfs, hand_idx),
                landmarks_from_hand_pose(gt_hand_b, ja_c, wr_c, hand_idx),
            ))
        t += n

    for t0, n, res, tk, gk in pending:
        sl = slice(t0, t0 + n)
        valid[:, sl] = _frames_to_axis(res.hand_valid, n, 1)
        tracked[:, sl] = _frames_to_axis(tk, n, 1)
        gt[:, sl] = _frames_to_axis(gk, n, 1)
        if res.predicted_scales is not None:
            scales[:, sl] = _frames_to_axis(res.predicted_scales, n, 1)
        raw_angles[:, sl] = _frames_to_axis(res.joint_angles, n, 1)
        raw_wrists[:, sl] = _frames_to_axis(res.wrist_xfs, n, 1)

    return SequenceResult(
        tracked_keypoints=tracked,
        gt_keypoints=gt,
        valid_tracking=valid,
        predicted_scales=scales if calibrate_scale else None,
        joint_angles=raw_angles,
        wrist_xfs=raw_wrists,
    )


def track_recordings_batched(
    model: UmeTrackModel,
    recordings,  # list of (HandPoseLabels, frame iterable) pairs
    hand_models_mm: Optional[List[HandModel]] = None,  # per-recording tracking skeletons
    opts: Optional[TrackerConfig] = None,
    min_num_crops: int = 1,
    calibrate_scale: bool = False,
    max_frames: Optional[int] = None,
    chunk_size: int = 8,
    pipelined: bool = True,
    mesh=None,
    stage_hook: StageHook = None,
) -> List[SequenceResult]:
    """Track R recordings in lockstep -> one SequenceResult each.

    Per recording the results are those of ``track_recording``: each keeps
    its own cameras, hand model, temporal memory and validity history.
    Shorter recordings pad with zero-confidence frames (their hand slots go
    invalid; results are trimmed on return). All recordings share the view
    count, image size and camera kind. Each chunk's frames arrive on the
    card recording-major, ``(R, chunk, V, H, W)`` uint8. ``stage_hook``, if
    given, is called with each stage's name as it ends (assemble, upload,
    the stages of ``track_chunk_eval_batched``, fk), for a caller's timing.
    Under a profiler each chunk is an ``eval.chunk`` span with a span
    ``eval.<stage>`` a stage (``utils/profiling.py``; the upload counts
    its bytes), and the copies back to the host after the last chunk are
    one ``eval.readback`` span.

    With ``mesh`` (a ``parallel.Mesh``) R must divide by its 'data' size
    n: each rank tracks the contiguous block of R / n recordings of its
    data coordinate (replicated over 'model') on its own device, as JAX
    shards the recording axis, and the results are all-gathered, so that
    every rank returns all R in recording order. A pipelined chunk is
    recording-major and per sample, so nothing else crosses the ranks.
    """
    if mesh is not None:
        n = mesh.shape["data"]
        if len(recordings) % n:
            raise ValueError(f"{len(recordings)} recordings do not split over a data axis of {n}")
        k = len(recordings) // n
        block = slice(mesh.data_index * k, (mesh.data_index + 1) * k)
        mine = track_recordings_batched(
            model, recordings[block], None if hand_models_mm is None else hand_models_mm[block], opts,
            min_num_crops, calibrate_scale, max_frames, chunk_size, pipelined, stage_hook=stage_hook,
        )
        everyone = mesh.objects(mine)
        return [res for d in range(n) for res in everyone[d * mesh.shape["model"]]]
    mark = stage_hook or (lambda name: None)
    labels_list = [lab for lab, _ in recordings]
    r = len(labels_list)
    if len({lab.camera_kind for lab in labels_list}) != 1 or len({lab.num_views for lab in labels_list}) != 1:
        raise ValueError("recordings must share the rig layout (camera kind and view count)")
    src_kind = labels_list[0].camera_kind

    if opts is None:
        opts = TrackerConfig(crop_size=model.cfg.input_size)
    opts, pad_hw = _prepad_opts(opts, labels_list[0])
    dev = model.device
    tracker = BatchedTracker(model, opts)
    hands_mm = hand_models_mm if hand_models_mm is not None else [lab.hand_model for lab in labels_list]
    hand_stack = stack_hand_models(hands_mm).to(dev)
    base_cams = cam.stack_cameras([lab.cameras for lab in labels_list]).to(dev)
    camera_angles = torch.as_tensor(np.stack([lab.camera_angles for lab in labels_list]), device=dev)

    def run_chunk(state, images_c, cam_c, ja_c, wr_c, conf_c):
        if pipelined:
            return track_chunk_eval_batched(
                model, opts, state, images_c, base_cams, cam_c, camera_angles, hand_stack,
                ja_c, wr_c, conf_c, min_num_crops=min_num_crops, src_kind=src_kind,
                calibrate_scale=calibrate_scale, images_rec_major=True, stage_hook=stage_hook,
            )
        outs = []
        for i in range(images_c.shape[0]):
            args = (
                state, images_c[i], base_cams._replace(T_world_from_eye=cam_c[i]),
                camera_angles, hand_stack, ja_c[i], wr_c[i], conf_c[i],
            )
            if calibrate_scale:
                state, res = tracker.track_frames_and_calibrate_scale(*args, src_kind=src_kind)
            else:
                state, res = tracker.track_frames(*args, min_num_crops=min_num_crops, src_kind=src_kind)
            outs.append(res)
        return state, stack_results(outs)

    lengths = [len(lab) if max_frames is None else min(max_frames, len(lab)) for lab in labels_list]
    t_total = max(lengths)
    tracked = np.zeros((r, NUM_HANDS, t_total, NUM_LANDMARKS, 3), np.float32)
    gt = np.zeros_like(tracked)
    valid = np.zeros((r, NUM_HANDS, t_total), bool)
    scales = np.zeros((r, NUM_HANDS, t_total), np.float32)
    raw_angles = np.zeros((r, NUM_HANDS, t_total, 22), np.float32)
    raw_wrists = np.zeros((r, NUM_HANDS, t_total, 4, 4), np.float32)

    # FK hand models per hand slot: tracked poses use the tracking skeleton,
    # GT poses the recording's own
    def per_hand(hand: HandModel) -> HandModel:
        return hand.map(lambda x: x[:, None].expand((r, NUM_HANDS) + x.shape[1:]))

    hand_fk = per_hand(hand_stack)
    gt_hand_fk = per_hand(stack_hand_models([lab.hand_model for lab in labels_list]).to(dev))
    hand_idx = torch.arange(NUM_HANDS, device=dev).expand(r, NUM_HANDS)

    state = tracker.init_state(r)
    frame_iters = [iter(frames) for _, frames in recordings]
    last_frames = [None] * r
    zeros_like_first = None
    v = labels_list[0].num_views
    pending = []  # (t_start, n, res, tracked landmarks, gt landmarks) on the device

    t = 0
    while t < t_total:
        n = min(chunk_size, t_total - t)
        with profiling.span("eval.chunk"):
            with profiling.span("eval.assemble"):
                # up to n live frames per recording; recordings past their end
                # repeat their last frame with zero confidence (masked out)
                imgs = []  # per recording (chunk_size, V, H, W)
                live_counts = np.zeros(r, np.int64)
                for ri in range(r):
                    rec_frames = []
                    for ti in range(n):
                        if t + ti < lengths[ri]:
                            try:
                                last_frames[ri] = np.asarray(next(frame_iters[ri]))
                                rec_frames.append(last_frames[ri])
                                continue
                            except StopIteration:
                                lengths[ri] = min(lengths[ri], t + ti)
                        break
                    live_counts[ri] = len(rec_frames)
                    if last_frames[ri] is None:
                        if zeros_like_first is None:
                            # only when a recording yields no frame: the frame shape
                            # comes from the rig
                            cam0 = labels_list[ri].cameras
                            zeros_like_first = np.zeros(
                                (v, int(cam0.height.reshape(-1)[0]), int(cam0.width.reshape(-1)[0])),
                                np.float32,
                            )
                        last_frames[ri] = zeros_like_first
                    rec_frames.extend([last_frames[ri]] * (chunk_size - len(rec_frames)))
                    imgs.append(np.stack(rec_frames))
                stacked = np.stack(imgs)  # (R, chunk, V, H, W)
                images_c = _pad_frames(stacked if pipelined else np.moveaxis(stacked, 0, 1), pad_hw)

                # label arrays by fancy indexing, time-major (chunk, R, ...)
                ts = t + np.arange(chunk_size)

                def per_rec(field):
                    return np.stack(
                        [getattr(lab, field)[np.minimum(ts, len(lab) - 1)] for lab in labels_list], axis=1
                    )

                live = ts[:, None] < (t + live_counts)[None, :]  # (chunk, R)
                conf_c = (per_rec("hand_confidences") * live[..., None]).astype(np.float32)
            mark("assemble")

            with profiling.span("eval.upload", dev) as upload:
                host = (images_c, per_rec("camera_to_world"), per_rec("joint_angles"), per_rec("wrist_transforms"),
                        conf_c)
                images_dev, cam_c, ja_c, wr_c, conf_dev = (torch.as_tensor(a, device=dev) for a in host)
                upload.count("bytes", sum(a.nbytes for a in host))
            mark("upload")
            with torch.no_grad():
                state, res = run_chunk(state, images_dev, cam_c, ja_c, wr_c, conf_dev)
                with profiling.span("eval.fk", dev):
                    pending.append((
                        t, n, res,
                        landmarks_from_hand_pose(hand_fk, res.joint_angles, res.wrist_xfs, hand_idx),
                        landmarks_from_hand_pose(gt_hand_fk, ja_c, wr_c, hand_idx),
                    ))
            mark("fk")
        t += n

    with profiling.span("eval.readback", dev):
        for t0, n, res, tk, gk in pending:
            sl = slice(t0, t0 + n)
            valid[:, :, sl] = _frames_to_axis(res.hand_valid, n, 2)
            tracked[:, :, sl] = _frames_to_axis(tk, n, 2)
            gt[:, :, sl] = _frames_to_axis(gk, n, 2)
            if res.predicted_scales is not None:
                scales[:, :, sl] = _frames_to_axis(res.predicted_scales, n, 2)
            raw_angles[:, :, sl] = _frames_to_axis(res.joint_angles, n, 2)
            raw_wrists[:, :, sl] = _frames_to_axis(res.wrist_xfs, n, 2)

    return [
        SequenceResult(
            tracked_keypoints=tracked[ri, :, : lengths[ri]],
            gt_keypoints=gt[ri, :, : lengths[ri]],
            valid_tracking=valid[ri, :, : lengths[ri]],
            predicted_scales=scales[ri, :, : lengths[ri]] if calibrate_scale else None,
            joint_angles=raw_angles[ri, :, : lengths[ri]],
            wrist_xfs=raw_wrists[ri, :, : lengths[ri]],
        )
        for ri in range(r)
    ]


def frames_for(labels: HandPoseLabels, video_path: Optional[str], renderer: str = "mesh"):
    """Decoded frames when the video exists, synthetic frames otherwise
    (``renderer``: ``mesh``, the skinned-mesh silhouettes, or ``blobs``)."""
    if video_path and os.path.exists(video_path):
        return VideoFrameSource(video_path, labels.num_views)
    return make_frame_source(labels, renderer=renderer)
