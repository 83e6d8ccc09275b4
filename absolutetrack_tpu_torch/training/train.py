"""Sequence train and eval steps (port of ``absolutetrack_tpu/training/train.py``).

The JAX package scans the model over a window with ``lax.scan`` and jits
the step over a ('data', 'model') mesh. Here the unroll is a loop over the
window's T frames carrying the temporal memory, and the batch moves to the
model's device. The train step takes autograd's gradients of the sequence
loss and applies the optimizer of ``training/optimizer.py`` to the model's
parameters in place; its state carries the moments by parameter name.

Under a ``parallel.Mesh`` of several ranks each rank's step takes its own
block of the batch (``local_batch``): samples over 'data', and over
'model' the views, whose backbone features are all-gathered before the
fusion. The loss divides by the valid samples of the whole batch, the
gradients and metrics are summed over the ranks in a fixed order from one
all-gather, and so every rank applies the same update.
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
from ..parallel.mesh import Mesh, shard_block
from ..utils import profiling
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


# SequenceBatch fields whose batch axis is 1 (time-major); the others lead with it
_TIME_MAJOR = ("images", "intrinsics", "extrinsics", "use_memory", "sample_mask", "gt_joint_angles", "gt_wrist")


def local_batch(mesh: Mesh, batch: SequenceBatch, hand_model_m: HandModel) -> Tuple[SequenceBatch, HandModel]:
    """This rank's block of a whole batch and of its (B,) hand models, on
    the mesh's device: the samples that JAX's ``batch_shardings`` places
    on its 'data' row (all views: the step picks its 'model' block)."""
    batch, hand_model_m = to_device(batch, hand_model_m, mesh.device)
    return (
        SequenceBatch(*(
            None if x is None else shard_block(mesh, x, 1 if f in _TIME_MAJOR else 0)
            for f, x in zip(SequenceBatch._fields, batch)
        )),
        hand_model_m.map(lambda x: shard_block(mesh, x)),
    )


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh (parallel.make_mesh), not {type(mesh).__name__}")


def _sharded(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.size > 1


def _view_shard(mesh: Optional[Mesh]) -> Optional[Mesh]:
    return mesh if mesh is not None and mesh.model > 1 else None


def _sum_rows(rows: torch.Tensor) -> torch.Tensor:
    """rows[0] + rows[1] + ... in that order."""
    total = rows[0]
    for row in rows[1:]:
        total = total + row
    return total


def _sum_over_data(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data axis in data order (model rank 0's
    copies), identical on every rank."""
    return _sum_rows(mesh.grid(x)[:, 0])


def _gather_over_data(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """(T, B / data, ...) blocks -> the whole (T, B, ...) batch."""
    return torch.cat(list(mesh.grid(x)[:, 0]), dim=1)


def _unroll(model: UmeTrackModel, batch: SequenceBatch, branch: str, view_shard=None) -> RegressorOutput:
    """Step the model over the window -> RegressorOutput stacked on T
    (``view_shard``: ``UmeTrackModel._trunk``'s)."""
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
            state, out = model.regress_pose_use_skeleton(state, frame, skel, view_shard)
        else:
            state, out = model.regress_pose_pred_skel_scale(state, frame, view_shard)
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
    mask_total: Optional[torch.Tensor] = None,
    view_shard=None,
):
    """(loss, metrics) of the unrolled window; ``branch`` "both" sums the
    known- and unknown-skeleton losses (their metrics, the unknown's as
    ``u_*``). ``cfg`` is the model's (kept for the JAX signature);
    ``mask_total`` is ``pose_loss``'s, ``view_shard`` ``_unroll``'s."""
    if branch == "both":
        tk, mk = loss_fn(model, batch, hand_model_m, cfg, "known", weights, mask_total, view_shard)
        tu, mu = loss_fn(model, batch, hand_model_m, cfg, "unknown", weights, mask_total, view_shard)
        metrics = {f"u_{k}": v for k, v in mu.items()}
        metrics.update(mk)
        metrics["total"] = tk + tu
        return tk + tu, metrics
    if branch not in ("known", "unknown"):
        raise ValueError(f"unknown branch {branch!r}")
    outs = _unroll(model, batch, branch, view_shard)
    outs = outs._replace(wrist_xfs=_undo_world_mirror(outs.wrist_xfs, batch.hand_idx[None]))
    return sequence_loss(
        outs,
        hand_model_m,
        batch.gt_joint_angles,
        batch.gt_wrist,
        batch.sample_mask,
        weights,
        batch.gt_log_scale if branch == "unknown" else None,
        mask_total=mask_total,
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


def loss_and_grads(
    model: UmeTrackModel,
    batch: SequenceBatch,
    hand_model_m: HandModel,
    cfg: ModelConfig,
    branch: str = "known",
    weights: LossWeights = LossWeights(),
    mesh: Optional[Mesh] = None,
):
    """(loss, metrics, gradients by parameter name, zeros where unused) of
    ``loss_fn``, on the model's device; the model's parameters must
    require grad.

    Under a mesh of several ranks ``batch`` is this rank's block
    (``local_batch``) and the three are those of the whole batch,
    identical on every rank: the loss divides by the valid samples of the
    whole batch (``mask_total``), so the ranks' losses add up to it; one
    all-gather brings every rank's gradients and metrics, which are summed
    over 'data' in data order. Over 'model', the backbone's gradients are
    summed (each rank's hold its own views' share), and every other
    gradient is whole on each rank (they all run the same work after the
    gather) and is taken once, from model rank 0.
    """
    batch, hand_model_m = to_device(batch, hand_model_m, model.device)
    params = dict(model.named_parameters())
    mask_total = _sum_over_data(mesh, batch.sample_mask.to(torch.float32).sum()) if _sharded(mesh) else None
    with torch.enable_grad():
        with profiling.span("train.forward", model.device):
            loss, metrics = loss_fn(model, batch, hand_model_m, cfg, branch, weights, mask_total, _view_shard(mesh))
        with profiling.span("train.backward", model.device):
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), grads)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    if not _sharded(mesh):
        return loss.detach(), metrics, grads

    keys = sorted(metrics)
    dtype = next(iter(grads.values())).dtype
    parts = [torch.stack([metrics[k].to(dtype) for k in keys])] + [g.reshape(-1) for g in grads.values()]
    by_model = torch.cat([
        torch.zeros(len(keys), dtype=torch.bool, device=model.device),
        *(torch.full((g.numel(),), n.startswith("backbone."), device=model.device) for n, g in grads.items()),
    ])
    grid = mesh.grid(torch.cat(parts))  # (data, model, n)
    rows = torch.where(by_model, _sum_rows(grid.transpose(0, 1)), grid[:, 0])  # (data, n)
    total = _sum_rows(rows)
    metrics = {k: total[i] for i, k in enumerate(keys)}
    out, at = {}, len(keys)
    for n, g in grads.items():
        out[n] = total[at : at + g.numel()].reshape(g.shape)
        at += g.numel()
    return metrics["total"], metrics, out


def make_train_step(
    cfg: ModelConfig,
    optimizer: ClippedAdamW,
    branch: str = "known",
    weights: LossWeights = LossWeights(),
    mesh: Optional[Mesh] = None,
):
    """The train step: ``(state, batch, hand_model_m) -> (state, metrics)``.

    The batch moves to the model's device; the parameters are updated in
    place (the JAX step donates its state) and the returned state holds
    the same model. Metrics are 0-d tensors on the device. Under a
    ``mesh`` each rank passes its block of the batch (``local_batch``);
    the gradients and metrics are the whole batch's (``loss_and_grads``),
    so the clipped optimizer decides alike on every rank. Under a profiler
    the step is a ``train.step`` span around ``loss_and_grads``'s
    ``train.forward`` and ``train.backward`` and its own
    ``train.optimizer`` (``utils/profiling.py``)."""
    _check_mesh(mesh)

    def train_step(state: TrainState, batch: SequenceBatch, hand_model_m: HandModel):
        model = state.params.requires_grad_(True)  # the port's models are built without gradients
        with profiling.span("train.step", model.device):
            _, metrics, grads = loss_and_grads(model, batch, hand_model_m, cfg, branch, weights, mesh)
            params = dict(model.named_parameters())
            with profiling.span("train.optimizer", model.device):
                updates, opt_state = optimizer.update(grads, state.opt_state, params)
                apply_updates(params, updates)
        return TrainState(model, opt_state, state.step + 1), metrics

    return train_step


def make_eval_step(cfg: ModelConfig, branch: str = "known", mesh: Optional[Mesh] = None):
    """Unroll + landmark error sums: ``(model, batch, hand_model_m) -> dict``
    with ``err_sum_m``, ``err_count`` and the stacked outputs. Under a
    ``mesh`` each rank passes its block of the batch (``local_batch``) and
    gets the whole batch's: the sums over 'data', the outputs gathered."""
    _check_mesh(mesh)

    @torch.no_grad()
    def eval_step(model: UmeTrackModel, batch: SequenceBatch, hand_model_m: HandModel):
        batch, hand_model_m = to_device(batch, hand_model_m, model.device)
        outs = _unroll(model, batch, branch, _view_shard(mesh))
        pred_wrist_left = _undo_world_mirror(outs.wrist_xfs, batch.hand_idx[None])
        t = batch.gt_joint_angles.shape[0]
        hand_tb = hand_model_m.map(lambda x: x.expand((t,) + x.shape))
        pred_lm = skin_landmarks(hand_tb, outs.joint_angles, pred_wrist_left)
        gt_lm = skin_landmarks(hand_tb, batch.gt_joint_angles, batch.gt_wrist)
        err = distance(pred_lm, gt_lm).mean(-1)  # (T, B)
        mask = batch.sample_mask.to(torch.float32)
        out = {
            "err_sum_m": torch.sum(err * mask),
            "err_count": torch.sum(mask),
            "scales": outs.skel_scales,
            "joint_angles": outs.joint_angles,
            "wrist_xfs": outs.wrist_xfs,
        }
        if _sharded(mesh):
            out["err_sum_m"], out["err_count"] = _sum_over_data(mesh, torch.stack([out["err_sum_m"], out["err_count"]]))
            for k in ("scales", "joint_angles", "wrist_xfs"):
                if out[k] is not None:
                    out[k] = _gather_over_data(mesh, out[k])
        return out

    return eval_step
