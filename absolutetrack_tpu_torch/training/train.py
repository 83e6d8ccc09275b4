"""Sequence train and eval steps (port of ``absolutetrack_tpu/training/train.py``).

The JAX package scans the model over a window with ``lax.scan`` and jits
the step over a ('data', 'model') mesh. Here the unroll is a loop over the
window's T frames carrying the temporal memory, on one device: the batch
moves to the model's device (``batch_shardings`` has no counterpart), and
a ``mesh`` raises until the parallel layer is ported. The train step takes
autograd's gradients of the sequence loss and applies the optimizer of
``training/optimizer.py`` to the model's parameters in place; its state
carries the moments by parameter name.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kinematics.hand_model import HandModel
from ..kinematics.skinning import skin_landmarks
from ..models.config import ModelConfig
from ..models.regressor import RegressorOutput
from ..models.umetrack import FrameInputs, SkeletonInputs, UmeTrackModel
from .loss import LossWeights, distance, sequence_loss
from .optimizer import ClippedAdamW, GuardState, apply_updates


class SequenceBatch(NamedTuple):
    """A batch of temporal windows (time-major).

    images      : (T, B, V, H, W) normalized crops
    intrinsics  : (T, B, V, 3, 3)
    extrinsics  : (T, B, V, 4, 4) world->eye, meters
    use_memory  : (T, B) bool (False at window starts)
    sample_mask : (T, B) bool
    hand_idx    : (B,)
    skel_axes, skel_rest : (B, 22, 3), meters (known-skeleton branch)
    gt_joint_angles : (T, B, 22)
    gt_wrist    : (T, B, 4, 4) world, meters, LEFT-hand canonical space
    gt_log_scale: (B,) optional

    The window builders fill it with numpy arrays; the steps move it to the
    model's device.
    """

    images: torch.Tensor
    intrinsics: torch.Tensor
    extrinsics: torch.Tensor
    use_memory: torch.Tensor
    sample_mask: torch.Tensor
    hand_idx: torch.Tensor
    skel_axes: torch.Tensor
    skel_rest: torch.Tensor
    gt_joint_angles: torch.Tensor
    gt_wrist: torch.Tensor
    gt_log_scale: Optional[torch.Tensor] = None


class TrainState(NamedTuple):
    """The model (its parameters are trained in place), the optimizer's
    state and the step counter (int32, 0-d)."""

    params: UmeTrackModel
    opt_state: GuardState
    step: torch.Tensor


def _on(x, device):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.asarray(x)
    if x.dtype == np.float64:
        x = x.astype(np.float32)
    elif not x.flags.writeable:  # a broadcast view
        x = x.copy()
    return torch.from_numpy(x).to(device)


def to_device(batch: SequenceBatch, hand_model_m: HandModel, device) -> Tuple[SequenceBatch, HandModel]:
    """The batch and hand model as tensors on ``device`` (numpy or tensors
    in); float64 arrays become float32, as JAX takes them with x64 off."""
    return SequenceBatch(*(_on(x, device) for x in batch)), HandModel(*(_on(x, device) for x in hand_model_m))


def init_train_state(model: UmeTrackModel, optimizer: ClippedAdamW) -> TrainState:
    """``TrainState(params, opt.init(params), 0)``."""
    step = torch.zeros((), dtype=torch.int32, device=model.device)
    return TrainState(model, optimizer.init(dict(model.named_parameters())), step)


def _unroll(model: UmeTrackModel, batch: SequenceBatch, branch: str) -> RegressorOutput:
    """Step the model over the window -> RegressorOutput stacked on T."""
    b = batch.hand_idx.shape[0]
    state = model.init_state(b)
    skel = SkeletonInputs(batch.skel_axes, batch.skel_rest)
    outs = []
    for t in range(batch.images.shape[0]):
        images = batch.images[t]
        frame = FrameInputs(
            left_images=images,
            intrinsics=batch.intrinsics[t],
            extrinsics=batch.extrinsics[t],
            view_mask=torch.ones(images.shape[:2], dtype=torch.bool, device=images.device),
            hand_idx=batch.hand_idx,
            use_memory=batch.use_memory[t],
            sample_mask=batch.sample_mask[t],
        )
        if branch == "known":
            state, out = model.regress_pose_use_skeleton(state, frame, skel)
        else:
            state, out = model.regress_pose_pred_skel_scale(state, frame)
        outs.append(out)
    return RegressorOutput(*(None if xs[0] is None else torch.stack(xs) for xs in zip(*outs)))


def _undo_world_mirror(wrist_world: torch.Tensor, hand_idx: torch.Tensor) -> torch.Tensor:
    """Map predicted world wrists back to LEFT-hand canonical space: the
    model mirrors the x column for right hands on output; the GT is
    left-canonical. Out of place (the other columns times 1)."""
    sign = torch.where(hand_idx == 1, -1.0, 1.0).to(wrist_world.dtype)
    ones = torch.ones_like(sign)
    column = torch.stack([sign, ones, ones, ones], dim=-1)  # (..., 4)
    return wrist_world * column[..., None, :]


def loss_fn(
    model: UmeTrackModel,
    batch: SequenceBatch,
    hand_model_m: HandModel,  # leading dim (B,), left-canonical, meters
    cfg: ModelConfig,
    branch: str = "known",
    weights: LossWeights = LossWeights(),
):
    """(loss, metrics) of the unrolled window; ``branch`` "both" sums the
    known- and unknown-skeleton losses (their metrics, the unknown's as
    ``u_*``). ``cfg`` is the model's (kept for the JAX signature)."""
    if branch == "both":
        tk, mk = loss_fn(model, batch, hand_model_m, cfg, "known", weights)
        tu, mu = loss_fn(model, batch, hand_model_m, cfg, "unknown", weights)
        metrics = {f"u_{k}": v for k, v in mu.items()}
        metrics.update(mk)
        metrics["total"] = tk + tu
        return tk + tu, metrics
    if branch not in ("known", "unknown"):
        raise ValueError(f"unknown branch {branch!r}")
    outs = _unroll(model, batch, branch)
    outs = outs._replace(wrist_xfs=_undo_world_mirror(outs.wrist_xfs, batch.hand_idx[None]))
    return sequence_loss(
        outs,
        hand_model_m,
        batch.gt_joint_angles,
        batch.gt_wrist,
        batch.sample_mask,
        weights,
        batch.gt_log_scale if branch == "unknown" else None,
    )


def make_optimizer(
    lr: float = 1e-4,
    weight_decay: float = 1e-5,
    clip_norm: float = 1.0,
    max_consecutive_nonfinite: int = 10,
) -> ClippedAdamW:
    """AdamW with global-norm clipping and non-finite-update rejection: a
    rare degenerate sample can give an inf/NaN loss, and without the guard
    one such batch would poison the parameters for good."""
    return ClippedAdamW(lr, weight_decay, clip_norm, max_consecutive_nonfinite)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("train/eval steps over a mesh of several cards are not ported yet")


def make_train_step(
    cfg: ModelConfig,
    optimizer: ClippedAdamW,
    branch: str = "known",
    weights: LossWeights = LossWeights(),
    mesh=None,
):
    """The train step: ``(state, batch, hand_model_m) -> (state, metrics)``.

    The batch moves to the model's device; the parameters are updated in
    place (the JAX step donates its state) and the returned state holds
    the same model. Metrics are 0-d tensors on the device."""
    _no_mesh(mesh)

    def train_step(state: TrainState, batch: SequenceBatch, hand_model_m: HandModel):
        model = state.params.requires_grad_(True)  # the port's models are built without gradients
        batch, hand_model_m = to_device(batch, hand_model_m, model.device)
        params = dict(model.named_parameters())
        with torch.enable_grad():
            loss, metrics = loss_fn(model, batch, hand_model_m, cfg, branch, weights)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        updates, opt_state = optimizer.update(dict(zip(params, grads)), state.opt_state, params)
        apply_updates(params, updates)
        return TrainState(model, opt_state, state.step + 1), {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_eval_step(cfg: ModelConfig, branch: str = "known", mesh=None):
    """Unroll + landmark error sums: ``(model, batch, hand_model_m) -> dict``
    with ``err_sum_m``, ``err_count`` and the stacked outputs."""
    _no_mesh(mesh)

    @torch.no_grad()
    def eval_step(model: UmeTrackModel, batch: SequenceBatch, hand_model_m: HandModel):
        batch, hand_model_m = to_device(batch, hand_model_m, model.device)
        outs = _unroll(model, batch, branch)
        pred_wrist_left = _undo_world_mirror(outs.wrist_xfs, batch.hand_idx[None])
        t = batch.gt_joint_angles.shape[0]
        hand_tb = hand_model_m.map(lambda x: x.expand((t,) + x.shape))
        pred_lm = skin_landmarks(hand_tb, outs.joint_angles, pred_wrist_left)
        gt_lm = skin_landmarks(hand_tb, batch.gt_joint_angles, batch.gt_wrist)
        err = distance(pred_lm, gt_lm).mean(-1)  # (T, B)
        mask = batch.sample_mask.to(torch.float32)
        return {
            "err_sum_m": torch.sum(err * mask),
            "err_count": torch.sum(mask),
            "scales": outs.skel_scales,
            "joint_angles": outs.joint_angles,
            "wrist_xfs": outs.wrist_xfs,
        }

    return eval_step
