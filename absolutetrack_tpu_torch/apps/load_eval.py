"""Aggregate per-sequence eval results into the headline metrics (port of
``absolutetrack_tpu/apps/load_eval.py``).

Reads the per-sequence result ``.npy`` pickles that the eval apps write
and reports the mean keypoint error (MPJPE), the PCK-AUC over 0-50 mm,
the tracked-frame success rate and the keypoint accelerations, with the
reference's formulas. Runs on the host (numpy and torch on the CPU).

Usage:
  python -m absolutetrack_tpu_torch.apps.load_eval --root tmp
"""

from __future__ import annotations

import argparse
import fnmatch
import os
import pickle

import numpy as np

from ..kinematics import metrics as M


def compute_sequence_metrics(gt, tracked, valid):
    err = np.linalg.norm(gt - tracked, axis=-1).mean(-1)  # (2, T)
    acc_valid = valid[:, :-2] & valid[:, 1:-1] & valid[:, 2:]

    def acc(pts):
        a = pts[:, :-2] + pts[:, 2:] - 2 * pts[:, 1:-1]
        return np.linalg.norm(a, axis=-1).mean(-1)

    return {
        "keypoint_errors": err[valid],
        "keypoint_accelerations": acc(tracked)[acc_valid],
        "gt_keypoint_accelerations": acc(gt)[acc_valid],
        "n_valid": int(valid.sum()),
        "n_total": int(valid.size),
    }


def aggregate_metrics(output_dir: str) -> dict | None:
    """The metrics over every ``*.npy`` result under ``output_dir``, or None
    when there is none."""
    errs, accs, gt_accs = [], [], []
    n_valid = n_total = 0
    for cur, _dirs, files in os.walk(output_dir):
        for fname in fnmatch.filter(files, "*.npy"):
            with open(os.path.join(cur, fname), "rb") as f:
                d = pickle.load(f)
            m = compute_sequence_metrics(d["gt_keypoints"], d["tracked_keypoints"], d["valid_tracking"])
            errs.append(m["keypoint_errors"])
            accs.append(m["keypoint_accelerations"])
            gt_accs.append(m["gt_keypoint_accelerations"])
            n_valid += m["n_valid"]
            n_total += m["n_total"]
    if not errs:
        return None
    errs = np.concatenate(errs)
    accs = np.concatenate(accs)
    gt_accs = np.concatenate(gt_accs)
    pck = M.pck_curve(errs, M.PCK_THRESHOLDS).numpy() * 100.0
    auc = float(M.normalized_auc(M.PCK_THRESHOLDS, pck / 100.0))
    return {
        "success_rate": n_valid / max(n_total, 1),
        "mean_keypoint_error_mm": float(errs.mean()) if len(errs) else float("nan"),
        "pck_auc": auc,
        "mean_keypoint_acceleration": float(accs.mean()) if len(accs) else float("nan"),
        "gt_mean_keypoint_acceleration": float(gt_accs.mean()) if len(gt_accs) else float("nan"),
        "n_valid": n_valid,
        "n_total": n_total,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="tmp")
    args = ap.parse_args(argv)

    for eval_mode in ["known_skeleton", "unknown_skeleton"]:
        for protocol in ["", "real/separate_hand", "real/hand_hand"]:
            d = os.path.join(args.root, f"eval_results_{eval_mode}", protocol)
            m = aggregate_metrics(d)
            if m is None:
                continue
            print(f"Evaluation for {eval_mode} on {protocol or '<all>'}:")
            print(f"  Tracked {m['n_valid']} / {m['n_total']} ({m['success_rate'] * 100:.1f}%)")
            print(f"  Mean keypoint error: {m['mean_keypoint_error_mm']:.3f} mm")
            print(f"  AUC score: {m['pck_auc']:.4f}")
            print(f"  Mean keypoint accel: {m['mean_keypoint_acceleration']:.3f}")
            print(f"  GT keypoint accel: {m['gt_mean_keypoint_acceleration']:.3f}")


if __name__ == "__main__":
    main()
