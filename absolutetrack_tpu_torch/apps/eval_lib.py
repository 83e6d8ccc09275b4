"""Evaluation driver (port of ``absolutetrack_tpu/apps/eval_lib.py``).

``build_model`` gives the network, from a checkpoint or seeded. The
driver tracks recordings with crops from the labelled per-frame poses and returns
the reference's per-sequence payload (tracked and GT FK landmarks,
validity), hands-major, as numpy. ``track_recording`` runs one recording in
chunks; ``track_recordings_batched`` runs R recordings in lockstep, and
``track_recordings_unknown_skeleton`` the unknown-skeleton protocol's two
passes and calibration over them. With
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
import time
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from .calibration import CALIB_FRAMES, calibrated_scales
from ..geometry import camera as cam
from ..kinematics.hand_model import HandModel, scaled_hand_model, stack_hand_models
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


def _check_extent(h: int, w: int, pad_hw) -> None:
    if h > pad_hw[0] or w > pad_hw[1]:
        # a silent truncation to the label cameras' extent would sample a
        # cropped region
        raise ValueError(
            f"frame dims ({h}, {w}) exceed the label cameras' padded "
            f"extent {tuple(pad_hw)}; frames and labels disagree"
        )


def _pad_frames(images: np.ndarray, pad_hw) -> np.ndarray:
    """(..., H, W) -> (..., hp, wp) zero-padded (contiguous as it is when pad_hw is None)."""
    if pad_hw is None:
        return np.ascontiguousarray(images)
    hp, wp = pad_hw
    h, w = images.shape[-2:]
    _check_extent(h, w, pad_hw)
    out = np.zeros(images.shape[:-2] + (hp, wp), images.dtype)
    out[..., :h, :w] = images
    return out


class _FrameStaging:
    """The host image of a lockstep chunk's frames, allocated once a call:
    ``(R, chunk, V, hp, wp)`` recording-major or ``(chunk, R, V, hp, wp)``
    frame-major, as ``_pad_frames`` lays out the stacked chunk. On a CUDA
    device it is page-locked and the card copies it without a pageable
    bounce (torch's caching host allocator keeps the block across calls);
    elsewhere it is plain host memory. Each frame is copied into it once.

    The first chunk fixes its dtype (what ``np.stack`` gives for that
    chunk's frames; float32 when no recording yields one) and the frame
    shape (its first frame's, else ``rig_shape``). A later frame of another
    shape, or of a dtype that does not cast safely, raises ``ValueError``.
    The pad margins are zeroed once, at allocation, and no frame reaches
    them: a cached block comes back with old bytes."""

    def __init__(self, frame_iters: list, chunk_size: int, rec_major: bool, pad_hw, rig_shape, device):
        self.frame_iters, self.chunk_size, self.rec_major = frame_iters, chunk_size, rec_major
        self.pad_hw, self.rig_shape = pad_hw, tuple(rig_shape)
        self.device = torch.device(device)
        self.pinned = self.device.type == "cuda"
        self.last: List[Optional[np.ndarray]] = [None] * len(frame_iters)
        self.buf = self.host = self.zeros = self.frame_shape = None
        self.copied = None  # the CUDA event recorded after the last upload

    def fill(self, t: int, n: int, lengths: List[int]):
        """Stage frames ``t .. t + n - 1``: up to ``n`` live frames a
        recording (its ``lengths`` bound it; a source that ends sooner cuts
        its entry there), then its last frame repeated, or zeros where it has
        yielded none. Returns the live counts and the µs the host waited for
        the previous chunk's copy to leave the buffer."""
        got = []
        for ri, frames in enumerate(self.frame_iters):
            rec = []
            for ti in range(min(n, lengths[ri] - t)):
                try:
                    rec.append(np.asarray(next(frames)))
                except StopIteration:
                    lengths[ri] = t + ti
                    break
            got.append(rec)
        if self.buf is None:
            self._allocate([f for rec in got for f in rec])
        waited_us = 0
        if self.copied is not None:
            t0 = time.perf_counter_ns()
            self.copied.synchronize()
            waited_us = (time.perf_counter_ns() - t0) // 1000
        for ri, rec in enumerate(got):
            if rec:
                self.last[ri] = rec[-1]
            elif self.last[ri] is None:
                if self.zeros is None:
                    self.zeros = np.zeros(self.frame_shape, self.host.dtype)
                self.last[ri] = self.zeros
            for ti in range(self.chunk_size):
                self._put(ri, ti, rec[ti] if ti < len(rec) else self.last[ri])
        return np.array([len(rec) for rec in got], np.int64), waited_us

    def _allocate(self, frames: List[np.ndarray]) -> None:
        dtype = np.result_type(*{f.dtype for f in frames}) if frames else np.dtype(np.float32)
        self.frame_shape = frames[0].shape if frames else self.rig_shape
        h, w = self.frame_shape[-2:]
        hp, wp = self.pad_hw or (h, w)
        _check_extent(h, w, (hp, wp))
        r = len(self.frame_iters)
        lead = (r, self.chunk_size) if self.rec_major else (self.chunk_size, r)
        self.buf = torch.empty(lead + self.frame_shape[:-2] + (hp, wp),
                               dtype=torch.from_numpy(np.empty(0, dtype)).dtype, pin_memory=self.pinned)
        self.host = self.buf.numpy()
        self.host[..., h:, :] = 0
        self.host[..., :h, w:] = 0

    def _put(self, ri: int, ti: int, frame: np.ndarray) -> None:
        if not np.can_cast(frame.dtype, self.host.dtype, "safe"):
            raise ValueError(f"a frame of {frame.dtype} does not cast safely to the chunk's {self.host.dtype} "
                             "(the first chunk's frames set it)")
        if frame.shape != self.frame_shape:
            raise ValueError(f"a frame of shape {frame.shape} differs from the first frame's {self.frame_shape}")
        h, w = self.frame_shape[-2:]
        np.copyto(self.host[(ri, ti) if self.rec_major else (ti, ri)][..., :h, :w], frame)

    def upload(self) -> torch.Tensor:
        """The staged chunk on the device; it never aliases the buffer."""
        images = self.buf.to(self.device, non_blocking=self.pinned, copy=True)
        if self.pinned:
            self.copied = torch.cuda.Event()
            self.copied.record(torch.cuda.current_stream(self.device))
        return images


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
    count, image size and camera kind. Each chunk's frames are copied once
    into one staging buffer a call (``_FrameStaging``: page-locked on a
    CUDA device, zero-padded) and arrive on the card recording-major,
    ``(R, chunk, V, H, W)`` in the frames' dtype. ``stage_hook``, if
    given, is called with each stage's name as it ends (assemble, upload,
    the stages of ``track_chunk_eval_batched``, fk), for a caller's timing.
    Under a profiler each chunk is an ``eval.chunk`` span with a span
    ``eval.<stage>`` a stage (``utils/profiling.py``; the upload counts
    its bytes), and the copies back to the host after the last chunk are
    one ``eval.readback`` span. ``eval.assemble`` counts
    ``staging_wait_us``, the host's wait for the previous chunk's copy out
    of the buffer; ``eval.upload`` counts ``bytes`` (frames and label
    arrays) and ``pinned_bytes``, those copied from page-locked staging.

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
    cam0 = labels_list[0].cameras
    staging = _FrameStaging(
        [iter(frames) for _, frames in recordings], chunk_size, pipelined, pad_hw,
        (labels_list[0].num_views, int(cam0.height.reshape(-1)[0]), int(cam0.width.reshape(-1)[0])), dev,
    )
    pending = []  # (t_start, n, res, tracked landmarks, gt landmarks) on the device

    t = 0
    while t < t_total:
        n = min(chunk_size, t_total - t)
        with profiling.span("eval.chunk"):
            with profiling.span("eval.assemble") as assemble:
                # up to n live frames per recording; recordings past their end
                # repeat their last frame with zero confidence (masked out)
                live_counts, waited_us = staging.fill(t, n, lengths)
                assemble.count("staging_wait_us", waited_us)

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
                images_dev = staging.upload()
                host = (per_rec("camera_to_world"), per_rec("joint_angles"), per_rec("wrist_transforms"), conf_c)
                cam_c, ja_c, wr_c, conf_dev = (torch.as_tensor(a, device=dev) for a in host)
                upload.count("bytes", staging.buf.nbytes + sum(a.nbytes for a in host))
                upload.count("pinned_bytes", staging.buf.nbytes if staging.pinned else 0)
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


@dataclasses.dataclass
class UnknownSkeletonRun:
    """The unknown-skeleton protocol over a group of recordings."""

    calibration: List[SequenceResult]  # pass 1: the first frames on the generic skeleton, with scales
    scales: List[float]  # each recording's calibrated user scale
    results: List[SequenceResult]  # pass 2: the recording on its scaled skeleton


def track_recordings_unknown_skeleton(
    model: UmeTrackModel,
    recordings: Callable[[], list],  # -> (HandPoseLabels, frame iterable) pairs, called once a pass
    generic_mm: HandModel,
    calib_mode: str = "gn",
    chunk_size: int = 8,
    pipelined: bool = True,
    max_frames: Optional[int] = None,
    mesh=None,
) -> UnknownSkeletonRun:
    """The unknown-skeleton protocol (reference run_eval_unknown_skeleton.py)
    over R recordings in lockstep (``recordings()`` gives them, with frames
    from their start, for each pass): pass 1 tracks each recording's first
    ``CALIB_FRAMES`` (30) frames through the scale-predicting head, two views a
    hand, crops driven through the generic skeleton; the calibration turns
    the per-frame scales into one user scale a recording
    (``calibration.calibrated_scales``: with ``gn`` one
    batched solve over every (recording, hand) window and one readback);
    pass 2 re-tracks each recording with a fresh state and
    ``scaled_hand_model(generic_mm, scale)``. Both passes are
    ``track_recordings_batched`` calls. Under a profiler the whole is an
    ``eval.protocol`` span around ``eval.calib_pass`` (counts ``frames``),
    ``eval.calibrate`` and ``eval.track_pass``."""
    dev = model.device
    with profiling.span("eval.protocol", dev):
        with profiling.span("eval.calib_pass", dev) as calib_pass:
            group = recordings()
            calibration = track_recordings_batched(
                model, group, hand_models_mm=[generic_mm] * len(group), calibrate_scale=True,
                max_frames=CALIB_FRAMES, chunk_size=chunk_size, pipelined=pipelined, mesh=mesh,
            )
            calib_pass.count("frames", sum(c.valid_tracking.shape[1] for c in calibration))
        scales = calibrated_scales(calibration, generic_mm, calib_mode, dev)
        with profiling.span("eval.track_pass", dev):
            results = track_recordings_batched(
                model, recordings(), hand_models_mm=[scaled_hand_model(generic_mm, s) for s in scales],
                max_frames=max_frames, chunk_size=chunk_size, pipelined=pipelined, mesh=mesh,
            )
    return UnknownSkeletonRun(calibration, scales, results)


def frames_for(labels: HandPoseLabels, video_path: Optional[str], renderer: str = "mesh"):
    """Decoded frames when the video exists, synthetic frames otherwise
    (``renderer``: ``mesh``, the skinned-mesh silhouettes, or ``blobs``)."""
    if video_path and os.path.exists(video_path):
        return VideoFrameSource(video_path, labels.num_views)
    return make_frame_source(labels, renderer=renderer)
