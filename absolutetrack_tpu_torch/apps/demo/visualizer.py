"""cv2 visualization of 2D detections and reprojected 3D skeletons (port of
``absolutetrack_tpu/apps/demo/visualizer.py``; cv2 is imported where it draws).

Reference: demo/image_visualizer.py + connection maps in
demo/const_values.py. Drawing uses the standard 21-landmark hand skeleton
edges; colors distinguish the 2D detector overlay from the tracked-3D
reprojection.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

# 21-landmark skeleton edges: wrist -> finger chains (fingertips at 0-4,
# per the UME landmark order used by the tracker output).
UME_EDGES = [
    (5, 6), (6, 7), (7, 0),        # thumb: wrist-frame chain to fingertip
    (5, 8), (8, 9), (9, 10), (10, 1),
    (5, 11), (11, 12), (12, 13), (13, 2),
    (5, 14), (14, 15), (15, 16), (16, 3),
    (5, 17), (17, 18), (18, 19), (19, 4),
]

# MediaPipe 21-landmark edges (wrist at 0, fingertips at 4/8/12/16/20).
MP_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 4),
    (0, 5), (5, 6), (6, 7), (7, 8),
    (0, 9), (9, 10), (10, 11), (11, 12),
    (0, 13), (13, 14), (14, 15), (15, 16),
    (0, 17), (17, 18), (18, 19), (19, 20),
]

HAND_COLORS = {0: (0, 255, 0), 1: (0, 128, 255)}  # left green, right orange


def draw_skeleton(img: np.ndarray, pts: np.ndarray, edges, color):
    import cv2

    for a, b in edges:
        pa, pb = pts[a], pts[b]
        if np.isfinite(pa).all() and np.isfinite(pb).all():
            cv2.line(img, tuple(pa.astype(int)), tuple(pb.astype(int)), color, 1)
    for p in pts:
        if np.isfinite(p).all():
            cv2.circle(img, tuple(p.astype(int)), 2, color, -1)
    return img


class ImageVisualizer:
    """Per-view windows with detector + tracked overlays and FPS."""

    def __init__(self, show: bool = True):
        self.show = show
        from ...utils.profiling import FpsCounter

        self.fps = FpsCounter()

    def render(
        self,
        rgb_views: np.ndarray,  # (V, H, W, 3)
        detections_2d: Optional[list] = None,  # per-view {hand: (21,2)}
        reprojected: Optional[Dict[int, Dict[int, np.ndarray]]] = None,
    ) -> list:
        import cv2

        fps = self.fps.tick()
        frames = []
        for v in range(rgb_views.shape[0]):
            img = np.ascontiguousarray(rgb_views[v][..., ::-1])  # RGB -> BGR
            if detections_2d is not None:
                for hand_idx, pts in detections_2d[v].items():
                    draw_skeleton(img, pts[:, :2], MP_EDGES, (255, 0, 0))
            if reprojected is not None:
                for hand_idx, pts in reprojected.get(v, {}).items():
                    draw_skeleton(img, pts, UME_EDGES, HAND_COLORS.get(hand_idx, (255, 255, 255)))
            cv2.putText(
                img, f"{fps:5.1f} fps", (8, 20), cv2.FONT_HERSHEY_SIMPLEX,
                0.6, (0, 255, 255), 1,
            )
            frames.append(img)
            if self.show:
                cv2.imshow(f"view {v}", img)
        if self.show:
            cv2.waitKey(1)
        return frames
