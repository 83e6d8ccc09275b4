"""Pack raw recordings into the torch_data layout (port of
``absolutetrack_tpu/apps/pack_sample_data.py``):

  {out}/{recording}_hand{h}/testing/mono.torch.{idx,bin}     (T, V, H, W) u8
  {out}/{recording}_hand{h}/testing/labels.torch.{idx,bin}   msgpack dicts

The stored views are pinhole-rectified, as the reference's torch_data
ships them: each fisheye frame is warped at full size to a pinhole camera
of focal 240 centred on the sensor (``warp_perspective_crop``: K1 on the
card, its plain version on the CPU). Frames are decoded from the
recording's video when it exists and rendered otherwise.

Usage:
  python -m absolutetrack_tpu_torch.apps.pack_sample_data \
      --input-dir sample_data/user05 --generic-hand-model dataset/generic_hand_model.json \
      --output-dir tmp/torch_data [--torch-device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from . import eval_lib
from .run_eval_known_skeleton import find_label_files
from ..data import write_torch_idx
from ..geometry import affine, camera as cam
from ..ops.resample import warp_perspective_crop
from ..tracker.video_data import load_labels
from ..utils.runtime import resolve_device


@torch.no_grad()
def rectify_views(labels, frames, pinhole_focal: float = 240.0, max_frames=None, device=None):
    """Fisheye views -> pinhole-rectified views on ``device`` (``cuda``
    unless given), returned as numpy (imgs uint8, K, w2e): each frame's f32
    views sampled at full size, clipped to 0..255 and truncated."""
    device = resolve_device(device)
    v = labels.num_views
    w = int(labels.cameras.width[0])
    h = int(labels.cameras.height[0])

    t_total = len(labels) if max_frames is None else min(max_frames, len(labels))
    out_imgs = np.zeros((t_total, v, h, w), np.uint8)
    out_K = np.zeros((t_total, v, 3, 3), np.float32)
    out_w2e = np.zeros((t_total, v, 4, 4), np.float32)

    view_idx = torch.arange(v, device=device)
    for t, frame in enumerate(frames):
        if t >= t_total:
            break
        cams_t = labels.cameras_at(t).to(device)
        pin = cams_t._replace(
            fx=torch.full((v,), pinhole_focal, device=device),
            fy=torch.full((v,), pinhole_focal, device=device),
            cx=torch.full((v,), (w - 1) / 2.0, device=device),
            cy=torch.full((v,), (h - 1) / 2.0, device=device),
            coeffs=torch.zeros((v, 8), device=device),
        )
        images = torch.as_tensor(np.asarray(frame), device=device).float()
        warped = warp_perspective_crop(images, cams_t, view_idx, pin, (w, h), src_kind=labels.camera_kind)
        out_imgs[t] = warped.clamp(0, 255).to(torch.uint8).cpu().numpy()
        out_K[t] = cam.intrinsics_matrix(pin).cpu().numpy()
        out_w2e[t] = affine.rigid_inverse(pin.T_world_from_eye).cpu().numpy()
    return out_imgs, out_K, out_w2e


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input-dir", default="sample_data/user05")
    ap.add_argument("--output-dir", default="tmp/torch_data")
    ap.add_argument("--generic-hand-model", default="dataset/generic_hand_model.json")
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--views", type=int, nargs=2, default=[1, 2])
    ap.add_argument("--max-frames", type=int, default=64)
    ap.add_argument(
        "--renderer", choices=["mesh", "blobs"], default="mesh",
        help="synthetic frames when the mp4 is absent (mesh silhouettes or landmark blobs)",
    )
    ap.add_argument("--torch-device", default="cuda", help="the device that rectifies the views")
    args = ap.parse_args(argv)

    with open(args.generic_hand_model) as f:
        generic_dict = json.load(f)

    for lf in find_label_files(args.input_dir, test_only=False):
        rec = os.path.splitext(os.path.basename(lf))[0]
        labels = load_labels(lf)
        frames = eval_lib.frames_for(labels, lf[:-5] + ".mp4", args.renderer)
        imgs, K, w2e = rectify_views(labels, frames, max_frames=args.max_frames, device=args.torch_device)
        lm = eval_lib.gt_landmark_sequence(labels)  # (T, 2, 21, 3) mm

        vi = np.asarray(args.views)
        n_win = imgs.shape[0] // args.window
        hand_model_dict = {
            k: np.asarray(x).tolist() if x is not None else None
            for k, x in zip(labels.hand_model._fields, labels.hand_model)
        }

        for hand in range(2):
            monos, packs = [], []
            for wdx in range(n_win):
                sl = slice(wdx * args.window, (wdx + 1) * args.window)
                conf = labels.hand_confidences[sl, hand]
                if not (conf > 0).all():
                    continue
                monos.append(imgs[sl][:, vi])
                packs.append(
                    {
                        "extrinsics": w2e[sl][:, vi].tolist(),
                        "intrinsics": K[sl][:, vi].tolist(),
                        "enclosing_points": lm[sl, hand].tolist(),
                        "hand": [float(hand)],
                        "hand_model": hand_model_dict,
                        "wrist": labels.wrist_transforms[sl, hand].tolist(),
                        "joint_angles": labels.joint_angles[sl, hand].tolist(),
                        # no solver here: the generic skeleton's "solved" pose
                        # is the GT pose (the reference ships both)
                        "solved_wrist_xfs": labels.wrist_transforms[sl, hand].tolist(),
                        "solved_joint_angles": labels.joint_angles[sl, hand].tolist(),
                        "generic_hand_model": generic_dict,
                        "pinch": [0.0] * args.window,
                    }
                )
            if not monos:
                continue
            folder = os.path.join(args.output_dir, f"{rec}_hand{hand}", "testing")
            os.makedirs(folder, exist_ok=True)
            write_torch_idx(os.path.join(folder, "mono.torch.idx"), monos)
            write_torch_idx(os.path.join(folder, "labels.torch.idx"), packs)
            print(f"packed {rec} hand{hand}: {len(monos)} windows of {args.window}")


if __name__ == "__main__":
    main()
