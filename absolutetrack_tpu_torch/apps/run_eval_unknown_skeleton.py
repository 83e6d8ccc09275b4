"""Unknown-skeleton eval: two-pass scale calibration, then tracking (port of
``absolutetrack_tpu/apps/run_eval_unknown_skeleton.py``).

The reference's protocol:
  pass 1: the first 30 two-view frames through the scale-prediction
          branch, with the GENERIC hand model driving the crops; the
          aggregated predicted scale gives a scaled generic skeleton;
  pass 2: a fresh tracker state re-tracks the sequence known-skeleton
          style with the calibrated skeleton.

``--calib-mode`` picks the aggregation of pass 1's per-frame scales:
``mean`` (the reference's), ``lstsq`` (one Huber IRLS round around the
median) or ``gn`` (one shared log-scale fitted with the per-frame poses by
windowed Gauss-Newton, ``ops/gauss_newton.py``, against FK targets built
from pass 1's own poses and scales). The last two aggregate the network's
predictions: they reduce the calibration's variance, not its bias.

Usage:
  python -m absolutetrack_tpu_torch.apps.run_eval_unknown_skeleton \
      --input-dir /path/to/raw_data/real --generic-hand-model generic_hand_model.json \
      --output-dir tmp/eval_unknown [--checkpoint pretrained_weights.torch]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import eval_lib
from .run_eval_known_skeleton import add_common_args, is_writer, pending_outputs, setup, write_result
from ..kinematics.hand_model import HandModel, load_hand_model_json, scaled_hand_model
from ..kinematics.skinning import skin_landmarks
from ..ops.gauss_newton import calibrate_scale_window
from ..tracker.video_data import load_labels
from ..utils.runtime import resolve_device

CALIB_FRAMES = 30  # the reference's calibration window


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


def gn_window_inputs(generic: HandModel, calib, hand_idx: int, device):
    """The GN window of one hand, on ``device``: (FK targets, joint angles,
    left-canonical wrists, frame mask), or None with fewer than 2 valid
    frames. The targets are FK of each frame's predicted pose on the
    generic skeleton scaled by that frame's predicted scale."""
    mask = calib.valid_tracking[hand_idx]
    if mask.sum() < 2:
        return None
    t = len(mask)
    # left-canonical poses: undo the right-hand world mirror
    wr = np.asarray(calib.wrist_xfs[hand_idx]).copy()
    if hand_idx == 1:
        wr[..., :, 0] *= -1
    wr = torch.as_tensor(wr, dtype=torch.float32, device=device)
    ja = torch.as_tensor(calib.joint_angles[hand_idx], device=device)
    scales = np.where(mask, calib.predicted_scales[hand_idx], 1.0)
    hand_t = scaled_hand_model(
        generic.to(device).map(lambda x: x.expand((t,) + x.shape)), torch.as_tensor(scales, dtype=torch.float32)
    )
    targets = skin_landmarks(hand_t, ja, wr)
    return targets, ja, wr, torch.as_tensor(mask, dtype=torch.float32, device=device)


def gn_window_scale(generic: HandModel, calib, hand_idx: int, device=None) -> float | None:
    """Windowed Gauss-Newton scale calibration of one hand: the per-frame
    poses and ONE shared log-scale refined jointly against pass 1's landmarks
    (Schur-complement GN), in place of averaging the per-frame scales. Runs
    on ``device`` (``cuda`` unless given)."""
    device = resolve_device(device)
    window = gn_window_inputs(generic, calib, hand_idx, device)
    if window is None:
        return None
    targets, ja, wr, mask = window
    res = calibrate_scale_window(generic.to(device), targets, ja, wr, frame_mask=mask, iters=6)
    return float(np.exp(res.log_scale.cpu().numpy()))


def calibrated_scale_from(calib, generic: HandModel, calib_mode: str, device=None) -> float:
    """One recording's user scale from its pass-1 scale predictions
    (mean / Huber-lstsq / windowed GN, see the module's docstring); GN runs
    on ``device`` (``cuda`` unless given)."""
    if calib_mode == "gn":
        gn_scales = [s for s in (gn_window_scale(generic, calib, h, device) for h in range(2)) if s is not None]
        return float(np.mean(gn_scales)) if gn_scales else 1.0
    return robust_scale(calib.predicted_scales[calib.valid_tracking], calib_mode)


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_common_args(ap, "tmp/eval_results_unknown_skeleton")
    ap.add_argument("--generic-hand-model", default="dataset/generic_hand_model.json")
    ap.add_argument(
        "--calib-mode", choices=["mean", "lstsq", "gn"], default="mean",
        help="scale aggregation: mean (the reference's), lstsq (Huber IRLS) or gn (windowed Gauss-Newton)",
    )
    args = ap.parse_args(argv)

    generic = load_hand_model_json(args.generic_hand_model)
    label_files, model, mesh = setup(args)
    log = print if is_writer(mesh) else (lambda *a, **k: None)
    errors = []

    def save_result(rel, out_path, res, user_scale):
        err = write_result(out_path, res, is_writer(mesh), calibrated_scale=user_scale)
        errors.append(err)
        log(f"{rel}: mean keypoint error {err.mean():.2f} mm")

    pending = pending_outputs(args, label_files, mesh)
    b = max(1, args.batch_recordings)
    for i in range(0, len(pending), b):
        group = pending[i : i + b]
        if len(group) == 1 or b == 1:
            for lf, rel, out_path in group:
                labels = load_labels(lf)

                # pass 1: calibrate on the first frames (stereo required)
                frames = eval_lib.frames_for(labels, lf[:-5] + ".mp4", args.renderer)
                calib = eval_lib.track_recording(
                    model, labels, frames, hand_model_mm=generic, calibrate_scale=True, max_frames=CALIB_FRAMES,
                )
                user_scale = calibrated_scale_from(calib, generic, args.calib_mode, model.device)
                log(f"{rel}: calibrated scale {user_scale:.4f} ({calib.valid_tracking.sum()} calib frames)")

                # pass 2: fresh tracker state, known-skeleton tracking
                frames = eval_lib.frames_for(labels, lf[:-5] + ".mp4", args.renderer)
                res = eval_lib.track_recording(
                    model, labels, frames, hand_model_mm=scaled_hand_model(generic, user_scale),
                    min_num_crops=1, max_frames=args.max_frames,
                )
                save_result(rel, out_path, res, user_scale)
        else:
            labels_list = [load_labels(lf) for lf, _rel, _out in group]

            def recordings():
                return [
                    (lab, eval_lib.frames_for(lab, lf[:-5] + ".mp4", args.renderer))
                    for lab, (lf, _r, _o) in zip(labels_list, group)
                ]

            # pass 1 in lockstep: every recording calibrates on the generic skeleton
            calibs = eval_lib.track_recordings_batched(
                model, recordings(), hand_models_mm=[generic] * len(group), calibrate_scale=True,
                max_frames=CALIB_FRAMES, mesh=mesh,
            )
            scales = [calibrated_scale_from(c, generic, args.calib_mode, model.device) for c in calibs]
            for (lf, rel, _out), c, s in zip(group, calibs, scales):
                log(f"{rel}: calibrated scale {s:.4f} ({c.valid_tracking.sum()} calib frames)")

            # pass 2 in lockstep: fresh state, each recording's calibrated skeleton
            results = eval_lib.track_recordings_batched(
                model, recordings(), hand_models_mm=[scaled_hand_model(generic, s) for s in scales],
                min_num_crops=1, max_frames=args.max_frames, mesh=mesh,
            )
            for (lf, rel, out_path), res, s in zip(group, results, scales):
                save_result(rel, out_path, res, s)

    if errors:
        log(f"Final mean error: {np.concatenate(errors).mean():.3f} mm")


if __name__ == "__main__":
    main()
