"""Offline 4-view replay with visualization + Unity UDP streaming (port of
``absolutetrack_tpu/apps/run_replay_visualize.py``).

Reference equivalent: run_eval_window_pose.py (despite its name: decode a
recording, track per frame with GT-pose crops, draw GT vs predicted
skeletons per camera, stream keypoints to Unity at 127.0.0.1:5052).

Here: track with the standard eval driver (on ``--torch-device``, ``cuda``
unless given), reproject both skeletons into every view, optionally
display (cv2) or dump annotated frames, and stream over UDP. cv2 is needed
only to draw: without ``--show`` or ``--dump-dir`` the replay tracks and
streams.

Usage:
  python -m absolutetrack_tpu_torch.apps.run_replay_visualize \\
      --labels recording_00.json --max-frames 60 [--show] [--dump-dir tmp/frames] [--no-udp]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from . import eval_lib
from .demo.unity_udp import UnitySender
from .demo.visualizer import HAND_COLORS, UME_EDGES, draw_skeleton
from ..geometry import camera as cam
from ..geometry.crop import crop_camera_to_camera
from ..models.config import ModelConfig
from ..models.layers import set_conv_precision
from ..tracker.crop_gen import gen_crop_slots
from ..tracker.tracker import HandTracker, TrackerConfig
from ..tracker.video_data import load_labels


def make_crop_debug_fn(model, labels, opts: TrackerConfig = TrackerConfig()):
    """(images, cam_t, ja, wr, conf) tensors on the model's device ->
    (crops [0,1], slots).

    The per-(hand, view) warped network-input crops, the equivalent of the
    reference's ``track_frame_analysis`` debug windows
    (lib/tracker/tracker.py:416-604)."""
    tracker = HandTracker(model, opts)
    dev = model.device
    base_cams = labels.cameras.to(dev)
    angles = torch.as_tensor(labels.camera_angles, device=dev)
    hand = labels.hand_model.to(dev)

    @torch.no_grad()
    def crop_fn(images, cam_t, ja, wr, conf):
        cams = base_cams._replace(T_world_from_eye=cam_t)
        slots = gen_crop_slots(
            cams, angles, hand, ja, wr, conf, opts.crop_size,
            num_crop_points=opts.num_crop_points,
            min_required_vis_landmarks=opts.min_required_vis_landmarks,
            focal_multiplier=opts.hand_ratio_in_crop,
            src_kind=labels.camera_kind,
        )
        frame = tracker.make_inputs(tracker.init_state(), images, cams, slots, labels.camera_kind)
        return frame.left_images, slots

    return crop_fn


def render_crop_panel(crops, slots, tracked_mm, valid, camera_kind, scale=2):
    """(2 hands x 2 views) crop tiles with the tracked skeleton reprojected
    into each crop camera -> one BGR image."""
    import cv2

    crops = crops.float().cpu().numpy()  # (2, 2, h, w) in [0, 1]
    n_h, n_v, h, w = crops.shape
    crop_cams = crop_camera_to_camera(slots.cameras, (w, h))
    view_valid = slots.view_valid.cpu().numpy()
    panel = np.zeros((n_h * h * scale, n_v * w * scale, 3), np.uint8)
    for hi in range(n_h):
        for vi in range(n_v):
            tile = np.repeat(np.clip(crops[hi, vi] * 255, 0, 255).astype(np.uint8)[..., None], 3, axis=-1)
            tile = cv2.resize(tile, (w * scale, h * scale), interpolation=0)
            if view_valid[hi, vi] and valid[hi]:
                cam_hv = crop_cams.map(lambda x: x[hi, vi])
                lm = torch.as_tensor(tracked_mm[hi], device=cam_hv.fx.device)
                win = cam.world_to_window(cam_hv, lm, cam.PINHOLE).cpu().numpy()
                draw_skeleton(tile, win * scale, UME_EDGES, HAND_COLORS[hi])
            else:
                tile[:] = tile // 3  # dim invalid slots
            panel[hi * h * scale : (hi + 1) * h * scale, vi * w * scale : (vi + 1) * w * scale] = tile
    return panel


def draw_views(mono, labels, res, t):
    """The views of frame ``t`` as BGR images, GT (white) and tracked
    (each hand's color) skeletons reprojected into each."""
    cams = labels.cameras_at(t)
    views = []
    for v in range(labels.num_views):
        img = np.repeat(np.clip(mono[v], 0, 255).astype(np.uint8)[..., None], 3, axis=-1)
        for h in range(2):
            if not res.valid_tracking[h, t]:
                continue
            for pts_world, color in ((res.gt_keypoints[h, t], (255, 255, 255)), (res.tracked_keypoints[h, t], HAND_COLORS[h])):
                cam_v = cams.map(lambda x: x[v])
                win = cam.world_to_window(cam_v, torch.as_tensor(pts_world), labels.camera_kind).numpy()
                draw_skeleton(img, win, UME_EDGES, color)
        views.append(img)
    return views


def main(argv=None):
    """Returns the tracked ``SequenceResult``, beside the printed line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--labels", required=True,
                    help="a recording's label JSON (the reference's sample_data/user05/recording_00.json)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument(
        "--precision", choices=["parity", "serving"], default="parity",
        help="serving = bf16 conv trunk, f32 geometry/solvers (ModelConfig.serving())",
    )
    ap.add_argument("--max-frames", type=int, default=60)
    ap.add_argument("--show", action="store_true")
    ap.add_argument("--dump-dir", default=None)
    ap.add_argument("--no-udp", action="store_true")
    ap.add_argument(
        "--crops", action="store_true",
        help="also render the warped per-(hand,view) network-input crops "
        "(reference track_frame_analysis windows, tracker.py:416-604)",
    )
    ap.add_argument(
        "--renderer", choices=["mesh", "blobs"], default="mesh",
        help="synthetic-frame fallback renderer when the mp4 is absent "
        "(mesh = LBS mesh silhouettes; blobs = landmark gaussians)",
    )
    ap.add_argument("--tiny-arch", action="store_true",
                    help="ModelConfig.tiny(): full topology at reduced width and crop size")
    ap.add_argument("--torch-device", default="cuda", help="the device the tracker runs on")
    args = ap.parse_args(argv)

    labels = load_labels(args.labels)
    if args.tiny_arch:
        mcfg = ModelConfig.tiny(compute_dtype="bfloat16") if args.precision == "serving" else ModelConfig.tiny()
    else:
        mcfg = ModelConfig.serving() if args.precision == "serving" else ModelConfig()
    set_conv_precision("highest")  # f32 convs and matmuls without TF32, as the JAX package's HIGHEST
    model = eval_lib.build_model(args.checkpoint, cfg=mcfg, device=args.torch_device)
    frames_src = eval_lib.frames_for(labels, args.labels[:-5] + ".mp4", args.renderer)

    res = eval_lib.track_recording(model, labels, frames_src, max_frames=args.max_frames)
    sender = None if args.no_udp else UnitySender()
    crop_fn = make_crop_debug_fn(model, labels) if args.crops else None
    draw = bool(args.dump_dir or args.show)
    dev = model.device

    frames_src = eval_lib.frames_for(labels, args.labels[:-5] + ".mp4", args.renderer)
    for t, mono in enumerate(frames_src):
        if t >= res.tracked_keypoints.shape[1]:
            break
        if sender is not None:
            sender.send({h: res.tracked_keypoints[h, t] for h in range(2) if res.valid_tracking[h, t]})
        if not draw:
            continue
        views = draw_views(mono, labels, res, t)

        crop_panel = None
        if crop_fn is not None:
            crops, slots = crop_fn(*(
                torch.as_tensor(np.asarray(a, np.float32), device=dev)
                for a in (mono, labels.camera_to_world[t], labels.joint_angles[t], labels.wrist_transforms[t],
                          labels.hand_confidences[t])
            ))
            crop_panel = render_crop_panel(
                crops, slots, res.tracked_keypoints[:, t], res.valid_tracking[:, t], labels.camera_kind,
            )

        import cv2

        if args.dump_dir:
            os.makedirs(args.dump_dir, exist_ok=True)
            cv2.imwrite(os.path.join(args.dump_dir, f"frame_{t:04d}.png"), np.concatenate(views, axis=1))
            if crop_panel is not None:
                cv2.imwrite(os.path.join(args.dump_dir, f"crops_{t:04d}.png"), crop_panel)
        if args.show:
            cv2.imshow("replay", np.concatenate(views, axis=1))
            if crop_panel is not None:
                cv2.imshow("crops", crop_panel)
            cv2.waitKey(1)

    err = np.linalg.norm((res.gt_keypoints - res.tracked_keypoints)[res.valid_tracking], axis=-1).mean(-1)
    if err.size:
        print(f"mean keypoint error over replay: {err.mean():.2f} mm")
    if sender is not None:
        sender.close()
    return res


if __name__ == "__main__":
    main()
