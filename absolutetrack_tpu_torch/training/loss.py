"""Training losses (port of ``absolutetrack_tpu/training/loss.py``).

Supervision follows the UmeTrack paper's heads: FK landmark L2 and a
Gaussian NLL under the predicted per-landmark sigmas, joint-angle L2 on
the 20 finger DoFs, the L2 of the 7 wrist template points mapped through
the predicted and the GT wrist, and the log skeleton-scale L2 of the
unknown-skeleton branch. Every term is masked by sample validity, in
meters.

Distances are ``sqrt(sum(d * d))``, as ``jnp.linalg.norm`` computes them:
at an exactly zero distance its gradient is NaN (``torch.linalg.norm``'s
is 0), and the optimizer's non-finite guard must see the same NaN.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kinematics.hand_model import HandModel
from ..kinematics.skinning import skin_landmarks
from ..models.regressor import RegressorOutput, wrist_rigid_template


@dataclasses.dataclass(frozen=True)
class LossWeights:
    landmark: float = 1.0
    landmark_nll: float = 0.1
    joint_angle: float = 0.1
    wrist_points: float = 1.0
    skel_scale: float = 1.0


def distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distance over the last axis, as ``jnp.linalg.norm(a - b, axis=-1)``."""
    d = a - b
    return torch.sqrt(torch.sum(d * d, dim=-1))


def pose_loss(
    out: RegressorOutput,
    hand_model_m: HandModel,  # batched to (B,) leading dim, meters
    gt_joint_angles: torch.Tensor,  # (B, 22)
    gt_wrist_m: torch.Tensor,  # (B, 4, 4), meters, LEFT-hand space
    sample_mask: torch.Tensor,  # (B,)
    weights: LossWeights = LossWeights(),
    gt_log_scale: Optional[torch.Tensor] = None,  # (B,)
    pred_wrist_left_m: Optional[torch.Tensor] = None,
    mask_total: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, dict]:
    """Scalar masked loss + metric dict. All wrist transforms left-handed.

    Every term is divided by ``max(mask_total, 1)``: the count of valid
    samples, this batch's unless given (a data-sharded step passes the
    count over the whole batch, so that its ranks' losses sum to it)."""
    m = sample_mask.to(torch.float32)
    denom = torch.clamp(torch.sum(m) if mask_total is None else mask_total, min=1.0)

    pred_wrist = out.wrist_xfs if pred_wrist_left_m is None else pred_wrist_left_m

    gt_lm = skin_landmarks(hand_model_m, gt_joint_angles, gt_wrist_m)
    pred_lm = skin_landmarks(hand_model_m, out.joint_angles, pred_wrist)
    lm_err = distance(pred_lm, gt_lm)  # (B, 21)
    lm_l2 = torch.sum(torch.mean(lm_err, dim=-1) * m) / denom

    sigma = out.landmark_uncertainty_sigmas
    nll = torch.log(sigma) + 0.5 * torch.square(lm_err / sigma)
    lm_nll = torch.sum(torch.mean(nll, dim=-1) * m) / denom

    ang = torch.sum(
        torch.mean(torch.square(out.joint_angles[:, :20] - gt_joint_angles[:, :20]), dim=-1) * m
    ) / denom

    tmpl = torch.as_tensor(wrist_rigid_template(), device=pred_wrist.device)  # (7, 3)

    def map_pts(xf):
        return torch.einsum("bij,pj->bpi", xf[:, :3, :3], tmpl) + xf[:, None, :3, 3]

    wrist_l2 = torch.sum(torch.mean(distance(map_pts(pred_wrist), map_pts(gt_wrist_m)), dim=-1) * m) / denom

    total = (
        weights.landmark * lm_l2
        + weights.landmark_nll * lm_nll
        + weights.joint_angle * ang
        + weights.wrist_points * wrist_l2
    )
    metrics = {
        "landmark_l2_m": lm_l2,
        "landmark_nll": lm_nll,
        "joint_angle_mse": ang,
        "wrist_points_m": wrist_l2,
    }
    if gt_log_scale is not None and out.skel_scales is not None:
        scale_l2 = torch.sum(torch.square(torch.log(out.skel_scales) - gt_log_scale) * m) / denom
        total = total + weights.skel_scale * scale_l2
        metrics["skel_scale_logmse"] = scale_l2
    metrics["total"] = total
    return total, metrics


def sequence_loss(
    outs: RegressorOutput,  # fields stacked over time: (T, B, ...)
    hand_model_m: HandModel,  # (B,) leading dims
    gt_joint_angles: torch.Tensor,  # (T, B, 22)
    gt_wrist_m: torch.Tensor,  # (T, B, 4, 4)
    sample_mask: torch.Tensor,  # (T, B)
    weights: LossWeights = LossWeights(),
    gt_log_scale: Optional[torch.Tensor] = None,  # (B,)
    mask_total: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, dict]:
    """Average ``pose_loss`` over an unrolled sequence (time-major);
    ``mask_total`` as in ``pose_loss``."""
    t, b = gt_joint_angles.shape[:2]

    def flat(x):
        return None if x is None else x.reshape((t * b,) + x.shape[2:])

    hand_flat = hand_model_m.map(lambda x: x.expand((t,) + x.shape).reshape((t * b,) + x.shape[1:]))
    scale_flat = None if gt_log_scale is None else gt_log_scale.expand(t, b).reshape(-1)
    return pose_loss(
        RegressorOutput(*(flat(x) for x in outs)),
        hand_flat,
        flat(gt_joint_angles),
        flat(gt_wrist_m),
        flat(sample_mask),
        weights,
        scale_flat,
        mask_total=mask_total,
    )
