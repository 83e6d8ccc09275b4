"""The unknown-skeleton protocol's scale calibration: pass 1's per-frame
scale predictions turned into one user scale a recording (``--calib-mode``
of ``run_eval_unknown_skeleton``): ``mean`` (the reference's), ``lstsq``
(one Huber IRLS round around the median) or ``gn`` (one shared log-scale a
hand fitted with the per-frame poses by windowed Gauss-Newton,
``ops/gauss_newton.py``, against FK targets built from pass 1's own poses
and scales; every window of a group in one batched solve)."""

from __future__ import annotations

import numpy as np
import torch

from ..kinematics.hand_model import HandModel, scaled_hand_model
from ..kinematics.skinning import skin_landmarks
from ..ops.gauss_newton import calibrate_scale_windows
from ..utils import profiling
from ..utils.runtime import resolve_device

CALIB_FRAMES = 30  # the reference's calibration window
GN_ITERS = 6


def robust_scale(scales: np.ndarray, mode: str = "mean") -> float:
    """Aggregate per-frame scale predictions over the calibration window."""
    if len(scales) == 0:
        return 1.0
    if mode == "mean":
        return float(scales.mean())
    # one IRLS round with Huber weights around the median
    med = np.median(scales)
    resid = np.abs(scales - med)
    mad = np.median(resid) + 1e-6
    c = 1.345 * 1.4826 * mad
    w = np.minimum(1.0, c / np.maximum(resid, 1e-12))
    return float((w * scales).sum() / w.sum())


def gn_windows(generic: HandModel, calibs, device):
    """Every (recording, hand) GN window with at least 2 valid frames, built
    in one batch on ``device`` -> (keys, FK targets (W, T, 21, 3), joint
    angles (W, T, 22), left-canonical wrists (W, T, 4, 4), frame mask (W, T)),
    ``keys`` the (recording, hand) of each window; None when no window
    qualifies. T is the longest calibration; a shorter one pads with masked
    frames. The targets are FK of each frame's predicted pose on the generic
    skeleton scaled by that frame's predicted scale."""
    t = max(c.valid_tracking.shape[1] for c in calibs)

    def stacked(field, fill):
        out = np.full((len(calibs), 2, t) + np.shape(fill), fill, np.float32)
        for ri, c in enumerate(calibs):
            x = getattr(c, field)
            out[ri, :, : x.shape[1]] = x
        return out

    mask = stacked("valid_tracking", 0.0) > 0
    keep = mask.sum(-1) >= 2  # (R, 2)
    if not keep.any():
        return None
    # left-canonical poses: undo the right-hand world mirror
    wr = stacked("wrist_xfs", np.eye(4, dtype=np.float32))
    wr[:, 1, ..., :, 0] *= -1
    scales = np.where(mask, stacked("predicted_scales", 1.0), 1.0)
    wr, ja, scales, m = (torch.as_tensor(x[keep], device=device)
                         for x in (wr, stacked("joint_angles", np.zeros(22, np.float32)), scales, mask))
    n_w = wr.shape[0]
    hand_t = scaled_hand_model(generic.to(device).map(lambda x: x.expand((n_w, t) + x.shape)), scales)
    return [tuple(k) for k in np.argwhere(keep).tolist()], skin_landmarks(hand_t, ja, wr), ja, wr, m.float()


def calibrated_scales(calibs, generic: HandModel, calib_mode: str, device=None) -> list:
    """Each recording's user scale from its pass-1 scale predictions (mean /
    Huber-lstsq / windowed GN, see the module's docstring). GN fits every
    (recording, hand) window of at least 2 valid frames in one batched solve
    on ``device`` (``cuda`` unless given) with one readback of the scales; a
    recording's scale is the mean of its hands', 1.0 where neither has one.
    Under a profiler this is an ``eval.calibrate`` span (counts ``windows``,
    ``valid_frames``, ``iters``) with the solve an ``eval.gn_solve`` span."""
    if calib_mode != "gn":
        with profiling.span("eval.calibrate") as sp:
            sp.count("valid_frames", int(sum(c.valid_tracking.sum() for c in calibs)))
            return [robust_scale(c.predicted_scales[c.valid_tracking], calib_mode) for c in calibs]
    device = resolve_device(device)
    with profiling.span("eval.calibrate", device) as sp:
        windows = gn_windows(generic, calibs, device)
        per_rec = [[] for _ in calibs]
        if windows is not None:
            keys, targets, ja, wr, mask = windows
            with profiling.span("eval.gn_solve", device):
                res = calibrate_scale_windows(generic.to(device), targets, ja, wr, frame_mask=mask, iters=GN_ITERS)
            for (ri, _hand), s in zip(keys, np.exp(res.log_scale.cpu().numpy())):
                per_rec[ri].append(float(s))
            sp.count("windows", len(keys))
            sp.count("valid_frames", int(sum(calibs[ri].valid_tracking[h].sum() for ri, h in keys)))
            sp.count("iters", GN_ITERS)
    return [float(np.mean(s)) if s else 1.0 for s in per_rec]
