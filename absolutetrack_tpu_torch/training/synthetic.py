"""Synthetic windows and hand models (port of ``absolutetrack_tpu/training/synthetic.py``).

``synthetic_sequence_batch`` is a deterministic noise batch that exercises
the whole train/eval step; ``learnable_windows`` draws gaussian blobs at
the FK landmarks' projections through a fixed stereo rig, a vision task
whose pose is recoverable from the pixels. Both return numpy leaves, as
the JAX package's do; hand models come back with float32 and int32 numpy
fields.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kinematics.hand_model import HandModel, load_hand_model_json, scaled_hand_model
from ..kinematics.skinning import skin_landmarks
from ..models.config import ModelConfig
from .train import SequenceBatch

GENERIC_HAND_MODEL = "/root/reference/dataset/generic_hand_model.json"


def numpy_hand_model(hand: HandModel) -> HandModel:
    """A hand model's fields as numpy, float32 and int32 (the JAX package's
    dtypes), None where absent."""

    def conv(x):
        if x is None:
            return None
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        return x.astype(np.int32 if np.issubdtype(x.dtype, np.integer) else np.float32)

    return HandModel(*(conv(x) for x in hand))


def synthetic_sequence_batch(
    b: int,
    t: int = 2,
    cfg: ModelConfig = ModelConfig(input_size=(32, 32)),
    seed: int = 0,
) -> SequenceBatch:
    """Deterministic random batch of b samples x t frames x 2 views."""
    v = cfg.num_views
    h, w = cfg.input_size
    rng = np.random.default_rng(seed)

    def arr(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    eye3 = np.broadcast_to(np.eye(3, dtype=np.float32) * [250, 250, 1], (t, b, v, 3, 3))
    eye4 = np.broadcast_to(np.eye(4, dtype=np.float32), (t, b, v, 4, 4))
    use_mem = np.zeros((t, b), bool)
    use_mem[1:] = True

    return SequenceBatch(
        images=rng.uniform(0, 1, (t, b, v, h, w)).astype(np.float32),
        intrinsics=np.ascontiguousarray(eye3),
        extrinsics=np.ascontiguousarray(eye4),
        use_memory=use_mem,
        sample_mask=np.ones((t, b), bool),
        hand_idx=(np.arange(b) % 2).astype(np.int32),
        skel_axes=arr((b, 22, 3), 0.1),
        skel_rest=arr((b, 22, 3), 0.01),
        gt_joint_angles=arr((t, b, 22), 0.1),
        gt_wrist=np.ascontiguousarray(np.broadcast_to(np.eye(4, dtype=np.float32), (t, b, 4, 4))),
        gt_log_scale=np.zeros(b, np.float32),
    )


@torch.no_grad()
def learnable_windows(
    b: int,
    t: int = 2,
    cfg: ModelConfig = ModelConfig(input_size=(32, 32)),
    seed: int = 0,
    hand_m: HandModel | None = None,
    generic_hand_model: str = GENERIC_HAND_MODEL,
) -> tuple[SequenceBatch, HandModel]:
    """Windows whose images encode the pose: gaussian blobs at the FK
    landmarks' projections through fixed stereo crop cameras, so training
    on them must reduce held-out tracked MPJPE.

    ``hand_m`` (batched (b, ...), left-canonical, meters) defaults to the
    hand model at ``generic_hand_model`` scaled to meters. Returns
    (SequenceBatch, the batched hand model), numpy leaves."""
    v = cfg.num_views
    h, w = cfg.input_size
    rng = np.random.default_rng(seed)

    if hand_m is None:
        hand = scaled_hand_model(load_hand_model_json(generic_hand_model), 0.001)  # meters
        hand_m = hand.map(lambda x: x.expand((b,) + x.shape))
    hand_m = numpy_hand_model(hand_m)

    # poses: joint angles near neutral, wrist 0.35 m in front of the rig
    # with strong x/y translation variation (the dominant learnable signal)
    ja = rng.uniform(-0.35, 0.35, (t, b, 22)).astype(np.float32)
    ja[..., 20:] = 0.0
    wrist = np.broadcast_to(np.eye(4, dtype=np.float32), (t, b, 4, 4)).copy()
    wrist[..., 0, 3] = rng.uniform(-0.12, 0.12, (t, b))
    wrist[..., 1, 3] = rng.uniform(-0.12, 0.12, (t, b))
    wrist[..., 2, 3] = rng.uniform(0.30, 0.42, (t, b))

    # stereo rig: view 0 at origin, view 1 offset 6 cm in x; both look +z
    extr = np.broadcast_to(np.eye(4, dtype=np.float32), (t, b, v, 4, 4)).copy()
    if v > 1:
        extr[..., 1, 0, 3] = -0.06
    focal = 50.0 * (w / 32.0)
    intr = np.zeros((t, b, v, 3, 3), np.float32)
    intr[..., 0, 0] = focal
    intr[..., 1, 1] = focal
    intr[..., 0, 2] = (w - 1) / 2.0
    intr[..., 1, 2] = (h - 1) / 2.0
    intr[..., 2, 2] = 1.0

    # FK landmarks (meters, world == view-0 space) -> project per view
    hand_tb = HandModel(*(None if x is None else torch.from_numpy(x).expand((t,) + x.shape) for x in hand_m))
    lm = skin_landmarks(hand_tb, torch.from_numpy(ja), torch.from_numpy(wrist)).numpy()  # (T, B, 21, 3)

    eye = np.einsum("tbvij,tbkj->tbvki", extr[..., :3, :3], lm) + extr[..., None, :3, 3]  # (T, B, V, 21, 3)
    uv = focal * eye[..., :2] / eye[..., 2:3]
    uv[..., 0] += (w - 1) / 2.0
    uv[..., 1] += (h - 1) / 2.0

    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    d2 = (gx[None] - uv[..., 0].reshape(-1, 21)[..., None, None]) ** 2 + (
        gy[None] - uv[..., 1].reshape(-1, 21)[..., None, None]
    ) ** 2
    sigma = 1.5 * (w / 32.0)
    images = np.exp(-d2 / (2 * sigma**2)).sum(axis=-3).reshape(t, b, v, h, w)
    images = np.clip(images, 0.0, 1.0).astype(np.float32)

    use_mem = np.zeros((t, b), bool)
    use_mem[1:] = True
    batch = SequenceBatch(
        images=images,
        intrinsics=intr,
        extrinsics=extr,
        use_memory=use_mem,
        sample_mask=np.ones((t, b), bool),
        hand_idx=np.zeros(b, np.int32),  # left-canonical, no mirror
        skel_axes=hand_m.joint_rotation_axes,
        skel_rest=hand_m.joint_rest_positions,
        gt_joint_angles=ja,
        gt_wrist=wrist,
        gt_log_scale=np.zeros(b, np.float32),
    )
    return batch, hand_m


def synthetic_hand_model_m(b: int, seed: int = 0) -> HandModel:
    """Tiny batched left-canonical hand model in meters (numpy leaves)."""
    rng = np.random.default_rng(seed)

    def arr(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return HandModel(
        joint_rotation_axes=arr((b, 22, 3)),
        joint_rest_positions=arr((b, 22, 3), 0.01),
        joint_frame_index=np.zeros((b, 22), np.int32),
        joint_parent=np.zeros((b, 22), np.int32),
        joint_first_child=np.zeros((b, 22), np.int32),
        joint_next_sibling=np.zeros((b, 22), np.int32),
        landmark_rest_positions=arr((b, 21, 3), 0.01),
        landmark_rest_bone_weights=np.ones((b, 21, 3), np.float32) / 3.0,
        landmark_rest_bone_indices=rng.integers(0, 17, (b, 21, 3)).astype(np.int32),
    )
