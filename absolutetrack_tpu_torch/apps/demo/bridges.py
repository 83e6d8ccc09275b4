"""Alternative input bridges: Leap Motion ground truth and RealSense capture
(port of ``absolutetrack_tpu/apps/demo/bridges.py``).

Reference equivalents: demo_with_leap/leap_bridge.py (LeapC cffi listener
streaming 21-landmark hand positions, remapped from Leap's joint order to
the UME landmark order) and demo/realsense_reader.py (color+depth capture
into shared memory). Both SDKs are optional; the bridges raise a clear
ImportError when the vendor library is absent and everything else in the
demo works without them.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

# Leap's flat joint ordering -> the UME 21-landmark order
# (reference demo_with_leap/leap_bridge.py:18-27): fingertips first, wrist,
# then per-finger intermediate frames, palm last.
LEAP2UME_JOINT_MAP = [
    4, 8, 12, 16, 20,  # fingertips (thumb..pinky)
    0,                 # wrist
    2, 3,              # thumb frames
    5, 6, 7,           # index
    9, 10, 11,         # middle
    13, 14, 15,        # ring
    17, 18, 19,        # pinky
    1,                 # palm center
]


def leap_to_ume(joints_leap_order: np.ndarray) -> np.ndarray:
    """(21, 3) Leap-ordered joints -> (21, 3) UME landmark order."""
    return np.asarray(joints_leap_order)[LEAP2UME_JOINT_MAP]


class LeapBridge:
    """Streams ground-truth 3D hand landmarks from a Leap Motion device.

    Yields {hand_idx: (21, 3) world-mm landmarks in UME order}. Requires the
    ``leap`` / ``leapc_cffi`` packages (vendor SDK).
    """

    def __init__(self):
        try:
            import leap  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "Leap Motion SDK not installed; LeapBridge unavailable"
            ) from e
        import leap
        from leap.enums import HandType

        bridge = self

        class _Listener(leap.Listener):
            def __init__(self):
                super().__init__()
                bridge.latest: Dict[int, Optional[np.ndarray]] = {0: None, 1: None}

            def on_tracking_event(self, event):
                latest: Dict[int, Optional[np.ndarray]] = {0: None, 1: None}
                for hand in event.hands:
                    idx = 0 if hand.type == HandType.Left else 1
                    pts = [
                        (
                            hand.arm.next_joint.x,
                            hand.arm.next_joint.y,
                            hand.arm.next_joint.z,
                        ),
                        (hand.palm.position.x, hand.palm.position.y, hand.palm.position.z),
                    ]
                    for digit in hand.digits:
                        for bone in digit.bones:
                            j = bone.next_joint
                            pts.append((j.x, j.y, j.z))
                    # flat Leap order: wrist, palm, then 4 bones x 5 digits
                    flat = np.asarray(pts[:21], np.float32)
                    latest[idx] = leap_to_ume(
                        np.concatenate([flat, np.zeros((21 - len(flat), 3))])[:21]
                    )
                bridge.latest = latest

        self._listener = _Listener()
        self._connection = leap.Connection()
        self._connection.add_listener(self._listener)

    def __enter__(self):
        self._cm = self._connection.open()
        self._cm.__enter__()
        return self

    def __exit__(self, *exc):
        self._cm.__exit__(*exc)

    def poll(self) -> Dict[int, Optional[np.ndarray]]:
        return dict(self.latest)


class RealSenseReader:
    """Color + depth frames from an Intel RealSense camera.

    Yields (color_rgb (H, W, 3) u8, depth (H, W) u16). Requires
    ``pyrealsense2``.
    """

    def __init__(self, width: int = 640, height: int = 480, fps: int = 30):
        try:
            import pyrealsense2 as rs
        except ImportError as e:
            raise ImportError(
                "pyrealsense2 not installed; RealSenseReader unavailable"
            ) from e
        self._rs = rs
        self.pipeline = rs.pipeline()
        config = rs.config()
        config.enable_stream(rs.stream.color, width, height, rs.format.rgb8, fps)
        config.enable_stream(rs.stream.depth, width, height, rs.format.z16, fps)
        self.pipeline.start(config)

    def __iter__(self):
        while True:
            frames = self.pipeline.wait_for_frames()
            color = frames.get_color_frame()
            depth = frames.get_depth_frame()
            if not color or not depth:
                continue
            yield (
                np.asanyarray(color.get_data()),
                np.asanyarray(depth.get_data()),
            )

    def close(self):
        self.pipeline.stop()
