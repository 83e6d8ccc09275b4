"""The live demo's pipeline: capture -> 2D detect -> 3D track -> sinks
(port of ``absolutetrack_tpu/apps/demo/pipeline.py``).

The 3D stage, ``LiveTracker``, runs ``HandTracker.track_frame_from_2d``
and the forward kinematics of its result as one step a frame on the
model's device (K1 samples the crops on the card): one upload of the
uint8 views and one blocking (2, 64) readback a frame. ``run_pipeline``
is the single-process loop (the reference's all_in_one mode).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ...geometry import camera as cam
from ...kinematics.hand_model import HandModel
from ...kinematics.skinning import landmarks_from_hand_pose
from ...models.umetrack import UmeTrackModel
from ...tracker.tracker import NUM_HANDS, HandTracker, TrackerConfig
from .detector_2d import Detector2D, keypoints_to_slots
from .stereo_rig import IMG_HEIGHT, IMG_WIDTH, build_stereo_cameras
from .unity_udp import UnitySender
from .visualizer import ImageVisualizer


@dataclasses.dataclass
class DemoConfig:
    num_views: int = 2
    image_width: int = IMG_WIDTH
    image_height: int = IMG_HEIGHT
    send_udp: bool = True
    visualize: bool = False  # run_pipeline draws each frame's views (visualizer.ImageVisualizer; needs cv2)


class StereoFrameSource:
    """cv2 capture of a side-by-side stereo camera (or a video file):
    yields (V, H, W) mono and (V, H, W, 3) RGB frames (reference
    demo/main.py:74-137)."""

    def __init__(self, device=0, cfg: DemoConfig = DemoConfig()):
        import cv2

        self.cv2 = cv2
        self.cap = cv2.VideoCapture(device)
        self.cap.set(cv2.CAP_PROP_FRAME_WIDTH, cfg.image_width * cfg.num_views)
        self.cap.set(cv2.CAP_PROP_FRAME_HEIGHT, cfg.image_height)
        self.cfg = cfg

    def __iter__(self):
        cv2 = self.cv2
        v = self.cfg.num_views
        while True:
            ok, frame = self.cap.read()
            if not ok:
                return
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            w = gray.shape[1] // v
            mono = np.stack([gray[:, i * w : (i + 1) * w] for i in range(v)])
            rgb_views = np.stack([rgb[:, i * w : (i + 1) * w] for i in range(v)])
            yield mono, rgb_views


class LiveTracker:
    """The 3D stage: per-view 2D detections and mono views -> world
    landmarks (mm) of each tracked hand. Keeps the tracker state; the last
    frame's ``TrackFrameResult`` stays on the device as ``last_result``."""

    def __init__(
        self,
        model: UmeTrackModel,
        hand_model_mm: HandModel,
        cameras: Optional[cam.Camera] = None,
        opts: TrackerConfig = TrackerConfig(),
    ):
        self.device = model.device
        self.tracker = HandTracker(model, opts)
        self.cameras = (build_stereo_cameras() if cameras is None else cameras).to(self.device)
        self.hand_model_mm = hand_model_mm.to(self.device)
        self._hand_b = self.hand_model_mm.map(lambda x: x.expand((NUM_HANDS,) + x.shape))
        self._hand_idx = torch.arange(NUM_HANDS, device=self.device)
        self.state = self.tracker.init_state()
        self.last_result = None

    def reset(self):
        self.state = self.tracker.init_state()

    @torch.no_grad()
    def __call__(self, mono_views: np.ndarray, keypoints_2d: np.ndarray, valid: np.ndarray) -> Dict[int, np.ndarray]:
        dev = self.device
        # the frame's one upload of views: uint8 frames go as they are
        images = torch.from_numpy(np.ascontiguousarray(mono_views)).to(dev)
        kp = torch.from_numpy(np.ascontiguousarray(keypoints_2d, np.float32)).to(dev)
        ok = torch.from_numpy(np.ascontiguousarray(valid, bool)).to(dev)
        self.state, res = self.tracker.track_frame_from_2d(
            self.state, images, self.cameras, self.hand_model_mm, kp, ok
        )
        lm = landmarks_from_hand_pose(self._hand_b, res.joint_angles, res.wrist_xfs, self._hand_idx)
        packed = torch.cat([res.hand_valid.float()[:, None], lm.reshape(NUM_HANDS, 63)], dim=1)
        self.last_result = res
        packed = packed.cpu().numpy()  # the frame's one blocking readback, (2, 64)
        return {h: packed[h, 1:].reshape(21, 3) for h in range(NUM_HANDS) if packed[h, 0] > 0.5}

    @torch.no_grad()
    def project_to_views(self, keypoints: Dict[int, np.ndarray]):
        """World keypoints reprojected into every view, one call for all
        hands -> {view: {hand: (21, 2)}}."""
        n_views = int(self.cameras.fx.shape[0])
        out: Dict[int, Dict[int, np.ndarray]] = {v: {} for v in range(n_views)}
        if not keypoints:
            return out
        hands = sorted(keypoints)
        lm = torch.from_numpy(np.stack([keypoints[h] for h in hands]).astype(np.float32)).to(self.device)
        win = cam.world_to_window(self.cameras, lm[:, None], cam.FISHEYE62).cpu().numpy()  # (H, V, 21, 2)
        for hi, hand_idx in enumerate(hands):
            for vi in range(n_views):
                out[vi][hand_idx] = win[hi, vi]
        return out


def run_pipeline(
    frames: Iterable,
    detector: Detector2D,
    live_tracker: LiveTracker,
    cfg: DemoConfig = DemoConfig(),
    on_result: Optional[Callable] = None,
    max_frames: Optional[int] = None,
):
    """The single-process loop: detect per view, track, send (and, with
    ``cfg.visualize``, show the views with the detections and the tracked
    hands reprojected); ``on_result`` gets (frame index, keypoints,
    frames/s EMA)."""
    sender = UnitySender() if cfg.send_udp else None
    viz = ImageVisualizer() if cfg.visualize else None
    fps_ema = None
    t_prev = time.perf_counter()
    try:
        for i, (mono, rgb) in enumerate(frames):
            if max_frames is not None and i >= max_frames:
                break
            per_view = [detector.detect(rgb[v], v) for v in range(cfg.num_views)]
            if hasattr(detector, "advance"):
                detector.advance()
            kp, valid = keypoints_to_slots(per_view)
            keypoints = live_tracker(mono, kp, valid)
            if sender is not None:
                sender.send(keypoints)
            if viz is not None:
                viz.render(rgb, per_view, live_tracker.project_to_views(keypoints))
            now = time.perf_counter()
            inst = 1.0 / max(now - t_prev, 1e-6)
            fps_ema = inst if fps_ema is None else 0.9 * fps_ema + 0.1 * inst
            t_prev = now
            if on_result is not None:
                on_result(i, keypoints, fps_ema)
    finally:
        if sender is not None:
            sender.close()
