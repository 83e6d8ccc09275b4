"""Evaluation metrics: MPJPE, keypoint acceleration, PCK curve, AUC (port of
``absolutetrack_tpu/kinematics/metrics.py``).

Formulas as the reference's: keypoint error is the per-frame mean of the
per-landmark L2; acceleration the mean over landmarks of
||p[t-1] + p[t+1] - 2 p[t]||; PCK thresholds 0..50 mm in 101 steps; the
AUC trapezoidal and normalized. Every function is masked (no boolean
indexing) and takes numpy arrays or tensors.

Inputs are read as the JAX package reads them with 64-bit types off:
float64 becomes float32 and int64 int32 before any comparison, so an
error within f32 rounding of a threshold counts on the same side.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_LANDMARK_ERROR_MM = 50.0
PCK_THRESHOLDS = np.linspace(0.0, MAX_LANDMARK_ERROR_MM, 101, dtype=np.float32)

_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def _tensor(x) -> torch.Tensor:
    """``x`` as a tensor with JAX's 32-bit canonical type."""
    t = torch.as_tensor(x)
    return t.to(_NARROW[t.dtype]) if t.dtype in _NARROW else t


def mpjpe(gt_keypoints, tracked_keypoints) -> torch.Tensor:
    """Per-frame mean per-joint position error: (..., T, 21, 3) -> (..., T)."""
    d = torch.linalg.vector_norm(_tensor(gt_keypoints) - _tensor(tracked_keypoints), dim=-1)
    return d.mean(dim=-1)


def keypoint_acceleration(pts) -> torch.Tensor:
    """(..., T, 21, 3) -> (..., T-2) mean second-difference magnitude."""
    pts = _tensor(pts)
    acc = pts[..., :-2, :, :] + pts[..., 2:, :, :] - 2.0 * pts[..., 1:-1, :, :]
    return torch.linalg.vector_norm(acc, dim=-1).mean(dim=-1)


def acceleration_valid_mask(valid) -> torch.Tensor:
    """(..., T) bool -> (..., T-2): all three consecutive frames tracked."""
    valid = torch.as_tensor(valid)
    return valid[..., :-2] & valid[..., 1:-1] & valid[..., 2:]


def pck_curve(errors, thresholds=PCK_THRESHOLDS, mask=None) -> torch.Tensor:
    """Fraction of the (flattened) errors <= each threshold -> (len(thresholds),)."""
    errors = _tensor(errors).reshape(-1)
    mask = torch.ones_like(errors, dtype=torch.bool) if mask is None else torch.as_tensor(mask).reshape(-1)
    th = torch.as_tensor(thresholds).to(errors.dtype)
    le = (errors[None, :] <= th[:, None]) & mask[None, :]
    denom = torch.clamp(mask.sum(), min=1)
    return le.sum(dim=-1) / denom


def pck_curve_per_axis(errors, axis: int, thresholds=PCK_THRESHOLDS, mask=None) -> torch.Tensor:
    """One PCK curve per element along ``axis`` -> (n_axis, len(thresholds)),
    e.g. per hand or per landmark."""
    errors = torch.movedim(_tensor(errors), axis, 0)
    n = errors.shape[0]
    errors = errors.reshape(n, -1)
    if mask is None:
        mask = torch.ones_like(errors, dtype=torch.bool)
    else:
        mask = torch.movedim(torch.as_tensor(mask), axis, 0).reshape(n, -1)
    th = torch.as_tensor(thresholds).to(errors.dtype)
    le = (errors[:, None, :] <= th[None, :, None]) & mask[:, None, :]
    denom = torch.clamp(mask.sum(dim=-1), min=1)
    return le.sum(dim=-1) / denom[:, None]


def normalized_auc(x, y, y_max: float = 1.0) -> torch.Tensor:
    """Trapezoidal AUC normalized by the largest area."""
    x, y = _tensor(x), _tensor(y)
    auc = torch.sum((x[1:] - x[:-1]) * (y[..., 1:] + y[..., :-1]) * 0.5, dim=-1)
    return auc / ((x[-1] - x[0]) * y_max)


def masked_mean(values, mask) -> torch.Tensor:
    """Mean over the entries where ``mask`` holds (0 when it holds nowhere)."""
    values = _tensor(values)
    m = torch.as_tensor(mask).to(values.dtype)
    return torch.sum(values * m) / torch.clamp(torch.sum(m), min=1.0)
