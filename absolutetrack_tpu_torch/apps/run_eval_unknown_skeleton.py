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

from . import eval_lib
from .calibration import CALIB_FRAMES, calibrated_scales
from .run_eval_known_skeleton import add_common_args, is_writer, pending_outputs, setup, write_result
from ..kinematics.hand_model import HandModel, load_hand_model_json, scaled_hand_model
from ..tracker.video_data import load_labels


def calibrated_scale_from(calib, generic: HandModel, calib_mode: str, device=None) -> float:
    """One recording's user scale (``calibrated_scales`` of that recording)."""
    return calibrated_scales([calib], generic, calib_mode, device)[0]


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

            run = eval_lib.track_recordings_unknown_skeleton(
                model, recordings, generic, args.calib_mode, max_frames=args.max_frames, mesh=mesh,
            )
            for (lf, rel, _out), c, s in zip(group, run.calibration, run.scales):
                log(f"{rel}: calibrated scale {s:.4f} ({c.valid_tracking.sum()} calib frames)")
            for (lf, rel, out_path), res, s in zip(group, run.results, run.scales):
                save_result(rel, out_path, res, s)

    if errors:
        log(f"Final mean error: {np.concatenate(errors).mean():.3f} mm")


if __name__ == "__main__":
    main()
