"""The live demo's entry point (port of ``absolutetrack_tpu/apps/demo/main.py``).

Modes:
  * ``--source camera``: live stereo capture (a stereo webcam, cv2 and
    mediapipe, and the generic hand model JSON);
  * ``--source replay``: hermetic replay of a recording's labels, its GT
    2D keypoints standing in for MediaPipe and synthetic frames for the
    video, through the same 3D path.

``--device`` is the webcam's index, as in the JAX demo; ``--torch-device``
the device the tracker runs on (``cuda`` unless given). ``--precision
serving`` (the default) runs the bf16 trunk and samples the crops with
bf16 row weights, as the TPU's kernels do; ``parity`` runs f32.

Usage:
  python -m absolutetrack_tpu_torch.apps.demo.main --source replay --labels <json> --no-udp
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

STEREO_VIEWS = (1, 2)  # the demo's stereo pair among a 4-view recording's views


@torch.no_grad()
def replay_from_labels(labels, max_frames: int, renderer: str = "mesh"):
    """(frames, detector) of a replay: the first ``max_frames`` frames of
    ``labels``, synthetic mono views of every view with their RGB copies,
    and a ``ReplayDetector`` of the GT landmarks' projections into the
    stereo pair's views (``STEREO_VIEWS``), as the JAX demo builds them.
    The mesh renderer's frames are whole shades, so they go as uint8, as a
    camera's would; the blob renderer's stay f32."""
    from ...geometry import camera as cam
    from ...tracker.video_data import gt_landmark_sequence, make_frame_source
    from .detector_2d import ReplayDetector

    lm = gt_landmark_sequence(labels)  # (T, 2, 21, 3)
    src = make_frame_source(labels, renderer=renderer, landmarks_world=lm)
    t_total = min(max_frames, len(labels))
    sequence = []
    for t in range(t_total):
        win = cam.world_to_window(labels.cameras_at(t), torch.from_numpy(lm[t])[:, None], labels.camera_kind)
        win = win.numpy()  # (2 hands, V, 21, 2)
        sequence.append([
            {h: win[h, v] for h in range(2) if labels.hand_confidences[t, h] > 0}
            for v in STEREO_VIEWS
        ])

    def frames():
        for t in range(t_total):
            mono = src.render_frame(t)
            if renderer == "mesh":
                mono = mono.astype(np.uint8)
            yield mono, np.repeat(mono[..., None], 3, axis=-1).astype(np.uint8)

    return frames(), ReplayDetector(sequence)


def stereo_pair(frames, views=STEREO_VIEWS):
    """The replay's (mono, rgb) frames cut to the demo's stereo pair."""
    sel = list(views)
    for mono, rgb in frames:
        yield mono[sel], rgb[sel]


def build_replay(labels_path: str, max_frames: int, renderer: str = "mesh"):
    """(labels, frames, detector) of a recording's label JSON."""
    from ...tracker.video_data import load_labels

    labels = load_labels(labels_path)
    frames, detector = replay_from_labels(labels, max_frames, renderer)
    return labels, frames, detector


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", choices=["camera", "replay"], default="replay")
    ap.add_argument("--device", type=int, default=0, help="the webcam's index (camera mode)")
    ap.add_argument("--torch-device", default="cuda", help="the device the tracker runs on")
    ap.add_argument("--labels", default=None, help="a recording's label JSON (replay mode)")
    ap.add_argument(
        "--hand-model", default="dataset/generic_hand_model.json",
        help="the generic hand model JSON (camera mode)",
    )
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument(
        "--precision", choices=["parity", "serving"], default="serving",
        help="serving = the bf16 trunk with bf16 crop row weights (lowest "
        "latency); parity = f32 throughout",
    )
    ap.add_argument(
        "--renderer", choices=["mesh", "blobs"], default="mesh",
        help="replay mode's synthetic renderer (mesh silhouettes or blobs)",
    )
    ap.add_argument("--max-frames", type=int, default=60)
    ap.add_argument("--no-udp", action="store_true")
    args = ap.parse_args(argv)
    if args.source == "replay" and args.labels is None:
        ap.error("--source replay needs --labels <recording JSON>")

    from .. import eval_lib
    from ...models.config import ModelConfig
    from .pipeline import DemoConfig, LiveTracker, StereoFrameSource, run_pipeline

    cfg = DemoConfig(send_udp=not args.no_udp)
    mcfg = ModelConfig.serving() if args.precision == "serving" else ModelConfig()
    model = eval_lib.build_model(args.checkpoint, cfg=mcfg, device=args.torch_device)

    if args.source == "replay":
        labels, frames, detector = build_replay(args.labels, args.max_frames, renderer=args.renderer)
        stereo = labels.cameras_at(0).map(lambda x: x[list(STEREO_VIEWS)])
        live = LiveTracker(model, labels.hand_model, cameras=stereo)
        frames = stereo_pair(frames)
        cfg.num_views = 2
    else:
        from ...kinematics.hand_model import load_hand_model_json
        from .detector_2d import MediaPipeDetector

        hand = load_hand_model_json(args.hand_model)
        live = LiveTracker(model, hand)
        frames = StereoFrameSource(args.device, cfg)
        detector = MediaPipeDetector(cfg.num_views)

    def on_result(i, keypoints, fps):
        hands = sorted(keypoints)
        centers = {h: np.round(keypoints[h].mean(0)).astype(int).tolist() for h in hands}
        print(f"frame {i}: hands={hands} centers={centers} fps={fps:.1f}")

    run_pipeline(frames, detector, live, cfg, on_result=on_result, max_frames=args.max_frames)


if __name__ == "__main__":
    main()
