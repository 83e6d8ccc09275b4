"""Per-view 2D hand detectors (port of ``absolutetrack_tpu/apps/demo/detector_2d.py``).

Per view a detector returns ``{hand_idx: (21, 2) window keypoints}`` with
the egocentric hand index (0 = left, 1 = right), MediaPipe's handedness
flipped (reference media_pipe_estimator.py:85). ``MediaPipeDetector``
imports mediapipe when built and raises where it is missing;
``ReplayDetector`` replays given keypoints (the hermetic replay mode).
"""

from __future__ import annotations

from typing import Dict, List, Protocol, Tuple

import numpy as np


class Detector2D(Protocol):
    def detect(self, rgb_view: np.ndarray, view_idx: int) -> Dict[int, np.ndarray]:
        """RGB (H, W, 3) -> {hand_idx: (21, 2) window keypoints}."""
        ...


class MediaPipeDetector:
    """mediapipe.solutions.hands, one instance a view."""

    def __init__(
        self,
        num_views: int,
        max_num_hands: int = 2,
        min_detection_confidence: float = 0.3,
        min_tracking_confidence: float = 0.3,
        model_complexity: int = 0,
    ):
        import mediapipe as mp  # optional dependency

        self._detectors = [
            mp.solutions.hands.Hands(
                max_num_hands=max_num_hands,
                model_complexity=model_complexity,
                min_detection_confidence=min_detection_confidence,
                min_tracking_confidence=min_tracking_confidence,
            )
            for _ in range(num_views)
        ]

    def detect(self, rgb_view: np.ndarray, view_idx: int) -> Dict[int, np.ndarray]:
        h, w = rgb_view.shape[:2]
        res = self._detectors[view_idx].process(rgb_view)
        out: Dict[int, np.ndarray] = {}
        if res.multi_handedness:
            for handedness, lms in zip(res.multi_handedness, res.multi_hand_landmarks):
                hand_idx = 1 - handedness.classification[0].index  # egocentric flip
                out[hand_idx] = np.asarray([[p.x * w, p.y * h] for p in lms.landmark], np.float32)
        return out


class ReplayDetector:
    """Replays given 2D keypoints: ``sequence`` is a (T, V) list of
    {hand_idx: (21, 2)} dicts; ``advance`` moves to the next frame."""

    def __init__(self, sequence):
        self.sequence = sequence
        self._t = 0

    def advance(self):
        self._t += 1

    def detect(self, rgb_view: np.ndarray, view_idx: int) -> Dict[int, np.ndarray]:
        frame = self.sequence[min(self._t, len(self.sequence) - 1)]
        return {k: np.asarray(v, np.float32) for k, v in frame[view_idx].items()}


def keypoints_to_slots(
    per_view: List[Dict[int, np.ndarray]], num_hands: int = 2
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-view detections -> dense (H, V, 21, 2) keypoints and (H, V) validity."""
    v = len(per_view)
    kp = np.zeros((num_hands, v, 21, 2), np.float32)
    valid = np.zeros((num_hands, v), bool)
    for vi, dets in enumerate(per_view):
        for hand_idx, pts in dets.items():
            if 0 <= hand_idx < num_hands:
                kp[hand_idx, vi] = pts[:, :2]
                valid[hand_idx, vi] = True
    return kp, valid
