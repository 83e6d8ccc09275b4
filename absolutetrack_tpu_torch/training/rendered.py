"""Rendered-window training data (port of ``absolutetrack_tpu/training/rendered.py``).

Builds ``SequenceBatch`` training windows by driving the tracker's own
input pipeline (GT-pose crop slots, then the fisheye->pinhole warp of
``BatchedTracker.make_inputs``: K1 on the card) over synthetic frames posed
by recording label JSONs. The default renderer is the z-buffered LBS mesh
silhouette (``MeshFrameSource``), whose finite hand extent makes stereo
depth and skeleton scale observable; ``renderer="blobs"`` draws landmark
gaussians. The build runs on the device it is given (``cuda`` unless
given): a chunk of up to 16 windows x T frames is one K1 launch of
4 slots a frame. Windows, their ``.npz`` cache and its meta are the JAX
package's, so caches cross both ways.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..geometry import camera as cam
from ..kinematics.hand_model import HandModel, load_hand_model_json, scaled_hand_model
from ..models.config import ModelConfig
from ..models.umetrack import UmeTrackModel
from ..tracker.batched import BatchedTracker
from ..tracker.tracker import MM_TO_M, TrackerConfig
from ..tracker.video_data import gt_landmark_sequence, load_labels, make_frame_source
from ..utils.runtime import resolve_device
from .synthetic import GENERIC_HAND_MODEL, numpy_hand_model
from .train import SequenceBatch

NUM_HANDS = 2
TIME_MAJOR = {"images", "intrinsics", "extrinsics", "use_memory", "sample_mask", "gt_joint_angles", "gt_wrist"}


def _gt_landmarks_mm(labels) -> np.ndarray:
    """(T, 2, 21, 3) FK landmarks of the GT poses (world, mm), on the CPU."""
    return gt_landmark_sequence(labels)


def _log_scale_vs_generic(hand_model_mm: HandModel, generic_hand_model: str = GENERIC_HAND_MODEL) -> float:
    """log of this hand's uniform scale relative to the generic model at
    ``generic_hand_model``: a uniform scale multiplies every joint rest
    offset, so the ratio of summed rest-offset norms recovers it."""
    generic = numpy_hand_model(load_hand_model_json(generic_hand_model))
    num = float(np.linalg.norm(numpy_hand_model(hand_model_mm).joint_rest_positions, axis=-1).sum())
    den = float(np.linalg.norm(generic.joint_rest_positions, axis=-1).sum())
    return float(np.log(num / den))


def _smooth_noise(
    rng: np.random.Generator,
    t: int,
    shape: Tuple[int, ...],
    sigma: float,
    min_period: float = 40.0,
    max_period: float = 160.0,
) -> np.ndarray:
    """(t, *shape) temporally smooth noise: two random sinusoids per element
    with std ~ sigma (hand motion is low-frequency)."""
    ts = np.arange(t, dtype=np.float32).reshape((t,) + (1,) * len(shape))
    out = np.zeros((t,) + shape, np.float32)
    for _ in range(2):
        period = rng.uniform(min_period, max_period, shape).astype(np.float32)
        phase = rng.uniform(0, 2 * np.pi, shape).astype(np.float32)
        amp = rng.normal(0.0, sigma, shape).astype(np.float32)
        out += amp * np.sin(2 * np.pi * ts / period + phase)
    return out


def augment_labels(
    labels,
    seed: int,
    scale_range: Tuple[float, float] = (0.8, 1.2),
    wrist_rot_deg: float = 10.0,
    wrist_trans_mm: float = 25.0,
    angle_offset_sigma: float = 0.10,
    angle_wobble_sigma: float = 0.06,
    head_rot_deg: float = 0.0,
    head_trans_mm: float = 0.0,
):
    """A new plausible recording from an existing one's labels: a skeleton
    scale in ``scale_range``, joint angles perturbed within the joint limits
    (constant offset + smooth wobble), wrist trajectories perturbed
    (wrist-local rotation + world translation), and optionally the rig's
    trajectory (one rigid transform per frame about the rig's centroid).
    Renderer and GT both read the returned labels."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    t = len(labels)

    s = float(rng.uniform(*scale_range))
    hand = scaled_hand_model(labels.hand_model, s)

    ja = np.asarray(labels.joint_angles, np.float32).copy()  # (T, 2, 22)
    ja += rng.normal(0, angle_offset_sigma, (1, 2, 22)).astype(np.float32)
    ja += _smooth_noise(rng, t, (2, 22), angle_wobble_sigma)
    jl = labels.hand_model.joint_limits
    if jl is not None:
        jl = np.asarray(jl)
        ja = np.clip(ja, jl[:, 0], jl[:, 1])

    wr = np.asarray(labels.wrist_transforms, np.float32).copy()  # (T, 2, 4, 4)
    rot_s = np.deg2rad(wrist_rot_deg) / np.sqrt(3)
    rv = rng.normal(0, rot_s, (1, 2, 3)).astype(np.float32) + _smooth_noise(rng, t, (2, 3), rot_s * 0.5)
    d_r = Rotation.from_rotvec(rv.reshape(-1, 3)).as_matrix().reshape(t, 2, 3, 3)
    tr_s = wrist_trans_mm / np.sqrt(3)
    d_t = rng.normal(0, tr_s, (1, 2, 3)).astype(np.float32) + _smooth_noise(rng, t, (2, 3), tr_s * 0.5)
    wr[..., :3, :3] = wr[..., :3, :3] @ d_r.astype(np.float32)
    wr[..., :3, 3] += d_t

    c2w = np.asarray(labels.camera_to_world, np.float32).copy()  # (T, V, 4, 4)
    if head_rot_deg > 0 or head_trans_mm > 0:
        hr = np.deg2rad(head_rot_deg) / np.sqrt(3)
        rv_h = rng.normal(0, hr, (1, 3)).astype(np.float32) + _smooth_noise(rng, t, (3,), hr * 0.5)
        r_h = Rotation.from_rotvec(rv_h.reshape(-1, 3)).as_matrix().reshape(t, 1, 3, 3).astype(np.float32)
        ht = head_trans_mm / np.sqrt(3)
        t_h = rng.normal(0, ht, (1, 3)).astype(np.float32) + _smooth_noise(rng, t, (3,), ht * 0.5)
        # rotate about the per-frame rig centroid, not the world origin
        center = c2w[..., :3, 3].mean(axis=1, keepdims=True)  # (T, 1, 3)
        c2w[..., :3, :3] = r_h @ c2w[..., :3, :3]
        c2w[..., :3, 3] = (
            np.einsum("tvij,tvj->tvi", np.broadcast_to(r_h, c2w[..., :3, :3].shape), c2w[..., :3, 3] - center)
            + center + t_h[:, None, :]
        )

    return dataclasses.replace(labels, hand_model=hand, joint_angles=ja, wrist_transforms=wr, camera_to_world=c2w)


@torch.no_grad()
def rendered_windows_from_labels(
    labels,
    starts: Sequence[int],
    window_t: int,
    cfg: ModelConfig = ModelConfig(),
    blob_sigma: float = 3.0,
    chunk_windows: int = 16,
    crop_jitter_seed: Optional[int] = None,
    renderer: str = "mesh",
    generic_hand_model: str = GENERIC_HAND_MODEL,
    device=None,
) -> Tuple[SequenceBatch, HandModel]:
    """Windows of rendered frames pushed through the serving crop/warp path
    on ``device`` (``cuda`` unless given).

    Returns a time-major ``SequenceBatch`` with B = len(starts)*NUM_HANDS
    samples (sample index = window*2 + hand), its crops uint8, plus the
    matching batched left-canonical hand model in meters (numpy leaves).
    ``sample_mask`` is False where the crop generator rejected the hand or
    found fewer than 2 valid views. ``crop_jitter_seed`` perturbs the poses
    fed to the crop generator only (~4 deg wrist rotation, ~8 mm, ~0.05 rad
    joint noise a frame), as serving crops from imperfect tracked poses."""
    device = resolve_device(device)
    opts = TrackerConfig(crop_size=cfg.input_size)
    w_n, t_n = len(starts), window_t
    v = labels.num_views

    src = make_frame_source(
        labels,
        renderer=renderer,
        landmarks_world=_gt_landmarks_mm(labels) if renderer == "blobs" else None,
        blob_sigma=blob_sigma,
    )
    frame_ids = [s + dt for s in starts for dt in range(t_n)]  # F = W*T

    ja_crop = np.asarray(labels.joint_angles, np.float32)
    wr_crop = np.asarray(labels.wrist_transforms, np.float32)
    if crop_jitter_seed is not None:
        from scipy.spatial.transform import Rotation

        jrng = np.random.default_rng(crop_jitter_seed)
        tt = len(labels)
        ja_crop = ja_crop + jrng.normal(0, 0.05, ja_crop.shape).astype(np.float32)
        rv = jrng.normal(0, np.deg2rad(4.0) / np.sqrt(3), (tt, 2, 3))
        d_r = Rotation.from_rotvec(rv.reshape(-1, 3)).as_matrix().reshape(tt, 2, 3, 3).astype(np.float32)
        wr_crop = wr_crop.copy()
        wr_crop[..., :3, :3] = wr_crop[..., :3, :3] @ d_r
        wr_crop[..., :3, 3] += jrng.normal(0, 8.0 / np.sqrt(3), (tt, 2, 3)).astype(np.float32)
    rendered = {fi: src.render_frame(fi).astype(np.uint8) for fi in sorted(set(frame_ids))}

    # fixed-size chunks: one K1 launch of chunk_w * T * 4 slots each
    chunk_w = min(w_n, chunk_windows)
    f = chunk_w * t_n
    # the model only gives make_inputs its state shapes and row mode
    bt = BatchedTracker(UmeTrackModel(cfg, device=device), opts)
    cams_f0 = labels.cameras.map(lambda x: x.expand((f,) + x.shape)).to(device)
    angles_f = torch.as_tensor(labels.camera_angles, device=device).expand(f, v)
    hand_f = labels.hand_model.map(lambda x: x.expand((f,) + x.shape)).to(device)

    def upload(a):
        return torch.as_tensor(np.asarray(a), device=device)

    parts_frames, parts_ok = [], []
    for c0 in range(0, w_n, chunk_w):
        chunk_starts = list(starts[c0 : c0 + chunk_w])
        pad = chunk_w - len(chunk_starts)
        chunk_starts += [chunk_starts[-1]] * pad
        ids = [s + dt for s in chunk_starts for dt in range(t_n)]
        cams_f = cams_f0._replace(T_world_from_eye=upload(labels.camera_to_world[ids]))
        slots = bt._gen_slots(
            cams_f, angles_f, hand_f, upload(ja_crop[ids]), upload(wr_crop[ids]),
            upload(labels.hand_confidences[ids]), 2, cam.FISHEYE62,
        )
        images = upload(np.stack([rendered[fi] for fi in ids]))
        frame = bt.make_inputs(bt.init_state(f), images, cams_f, slots, cam.FISHEYE62)
        ok = slots.hand_valid & (torch.sum(slots.view_valid, dim=-1) >= 2)  # (F, 2)
        keep = (chunk_w - pad) * t_n
        parts_frames.append(
            [x[: keep * NUM_HANDS].cpu().numpy() for x in (frame.left_images, frame.intrinsics, frame.extrinsics)]
        )
        parts_ok.append(ok[:keep].cpu().numpy())
    left_images, intrinsics, extrinsics = (np.concatenate(xs, axis=0) for xs in zip(*parts_frames))
    ok = np.concatenate(parts_ok, axis=0)  # (W*T, 2)

    def to_tb(x: np.ndarray) -> np.ndarray:
        """(F*2, ...) sample-flat -> (T, W*2, ...) time-major."""
        x = x.reshape((w_n, t_n, NUM_HANDS) + x.shape[1:])
        return np.moveaxis(x, 1, 0).reshape((t_n, w_n * NUM_HANDS) + x.shape[3:])

    def lbl_tb(x: np.ndarray) -> np.ndarray:
        """(F, 2, ...) frame-major labels -> (T, W*2, ...)."""
        x = x.reshape((w_n, t_n, NUM_HANDS) + x.shape[2:])
        return np.moveaxis(x, 1, 0).reshape((t_n, w_n * NUM_HANDS) + x.shape[3:])

    sample_mask = lbl_tb(ok)
    use_mem = sample_mask.copy()
    use_mem[0] = False

    # GT wrist: world mm (right-hand space for hand 1) -> LEFT-canonical
    # meters (negate the x column for right hands, the inverse of the
    # model's output mirror)
    wr = np.asarray(labels.wrist_transforms[frame_ids], np.float32).copy()
    wr[:, 1, :, 0] *= -1.0
    wr[..., :3, 3] *= MM_TO_M

    b = w_n * NUM_HANDS
    hand_m = numpy_hand_model(scaled_hand_model(labels.hand_model, MM_TO_M))
    hand_m = HandModel(*(None if x is None else np.broadcast_to(x, (b,) + x.shape) for x in hand_m))

    # GT log-scale vs the GENERIC model: the unknown-skeleton protocol
    # tracks with the generic model scaled by the mean predicted scale
    log_scale = np.float32(_log_scale_vs_generic(labels.hand_model, generic_hand_model))

    # crops store as uint8 (bilinear blends of uint8 sources quantize to
    # <= 0.5/255); materialize() converts minibatches back to [0,1] f32
    crops_u8 = np.clip(np.round(left_images * 255.0), 0, 255).astype(np.uint8)
    batch = SequenceBatch(
        images=to_tb(crops_u8),
        intrinsics=to_tb(intrinsics),
        extrinsics=to_tb(extrinsics),
        use_memory=use_mem,
        sample_mask=sample_mask,
        hand_idx=np.tile(np.arange(NUM_HANDS, dtype=np.int32), w_n),
        skel_axes=np.asarray(hand_m.joint_rotation_axes, np.float32),
        skel_rest=np.asarray(hand_m.joint_rest_positions, np.float32),
        gt_joint_angles=lbl_tb(np.asarray(labels.joint_angles[frame_ids], np.float32)),
        gt_wrist=lbl_tb(wr),
        gt_log_scale=np.full(b, log_scale, np.float32),
    )
    return batch, hand_m


def materialize(batch: SequenceBatch) -> SequenceBatch:
    """uint8-stored crops -> the [0,1] f32 the model consumes."""
    if batch.images.dtype == np.uint8:
        batch = batch._replace(images=np.asarray(batch.images, np.float32) / 255.0)
    return batch


def slice_windows(batch: SequenceBatch, hand_m: HandModel, idx: np.ndarray) -> Tuple[SequenceBatch, HandModel]:
    """Select samples (B axis) for a minibatch (crops -> f32)."""
    fields = {}
    for name in SequenceBatch._fields:
        x = getattr(batch, name)
        if x is None:
            fields[name] = None
        elif name in TIME_MAJOR:
            fields[name] = x[:, idx]
        else:
            fields[name] = x[idx]
    return materialize(SequenceBatch(**fields)), HandModel(*(None if x is None else x[idx] for x in hand_m))


def concat_windows(parts: List[Tuple[SequenceBatch, HandModel]]) -> Tuple[SequenceBatch, HandModel]:
    """Concatenate per-recording window sets along the sample axis."""
    fields = {}
    for name in SequenceBatch._fields:
        xs = [getattr(b, name) for b, _ in parts]
        fields[name] = None if xs[0] is None else np.concatenate(xs, axis=1 if name in TIME_MAJOR else 0)
    hand_m = HandModel(*(None if xs[0] is None else np.concatenate(xs, axis=0) for xs in zip(*[h for _, h in parts])))
    return SequenceBatch(**fields), hand_m


def _save_dataset(path: str, batch: SequenceBatch, hand_m: HandModel, meta: Optional[dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrs = {f"b_{k}": np.asarray(getattr(batch, k)) for k in SequenceBatch._fields if getattr(batch, k) is not None}
    arrs.update({f"h_{k}": np.asarray(getattr(hand_m, k)) for k in hand_m._fields if getattr(hand_m, k) is not None})
    if meta is not None:
        arrs["meta_json"] = np.frombuffer(json.dumps(meta, sort_keys=True).encode(), np.uint8)
    # renamed into place: the ranks of a sharded run build the same cache
    # at once, and none may read another's partial file
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez_compressed(tmp, **arrs)
    os.replace(tmp, path)


def _load_dataset(path: str) -> Tuple[SequenceBatch, HandModel, Optional[dict]]:
    z = np.load(path)
    batch = SequenceBatch(**{k: (z[f"b_{k}"] if f"b_{k}" in z else None) for k in SequenceBatch._fields})
    hand = HandModel(**{k: (z[f"h_{k}"] if f"h_{k}" in z else None) for k in HandModel._fields})
    meta = json.loads(bytes(z["meta_json"])) if "meta_json" in z else None
    return batch, hand, meta


def rendered_dataset(
    label_paths: Sequence[str],
    window_t: int = 8,
    stride: int = 8,
    cfg: ModelConfig = ModelConfig(),
    max_windows_per_recording: Optional[int] = None,
    cache_path: Optional[str] = None,
    augment: int = 0,
    crop_jitter: bool = False,
    seed: int = 0,
    blob_sigma: float = 3.0,
    augment_kwargs: Optional[dict] = None,
    renderer: str = "mesh",
    generic_hand_model: str = GENERIC_HAND_MODEL,
    device=None,
) -> Tuple[SequenceBatch, HandModel]:
    """Windows from several label JSONs, optionally cached as one .npz.

    ``augment``: extra augmented replicas per recording (replica 0 is the
    clean labels; ``augment_labels``); with ``crop_jitter`` the replicas'
    crops come from jittered poses. The cache records its build parameters
    (the JAX package's meta) and is rebuilt when any of them change."""
    meta = {
        "version": 3,
        "renderer": str(renderer),
        "label_paths": list(label_paths),
        "window_t": int(window_t),
        "stride": int(stride),
        "input_size": list(cfg.input_size),
        "blob_sigma": float(blob_sigma),
        "augment": int(augment),
        "crop_jitter": bool(crop_jitter),
        "seed": int(seed),
        "max_windows": int(max_windows_per_recording or 0),
        "augment_kwargs": dict(augment_kwargs or {}),
    }
    if cache_path and os.path.exists(cache_path):
        batch, hand_m, cached_meta = _load_dataset(cache_path)
        if cached_meta == meta:
            return batch, hand_m
        print(f"rendered_dataset: {cache_path} was built with different parameters; rebuilding")

    parts = []
    for pi, p in enumerate(label_paths):
        base = load_labels(p)
        for r in range(augment + 1):
            rseed = seed * 7919 + pi * 131 + r
            lv = base if r == 0 else augment_labels(base, seed=rseed, **(augment_kwargs or {}))
            starts = list(range(0, len(lv) - window_t, stride))
            if max_windows_per_recording:
                starts = starts[:max_windows_per_recording]
            jseed = rseed + 61 if (crop_jitter and r > 0) else None
            parts.append(
                rendered_windows_from_labels(
                    lv, starts, window_t, cfg=cfg, blob_sigma=blob_sigma, crop_jitter_seed=jseed,
                    renderer=renderer, generic_hand_model=generic_hand_model, device=device,
                )
            )
    batch, hand_m = concat_windows(parts)
    if cache_path:
        _save_dataset(cache_path, batch, hand_m, meta)
    return batch, hand_m
