"""Recording labels (port of the label half of ``absolutetrack_tpu/tracker/video_data.py``).

The label JSON (cameras, camera angles, per-frame hand poses and
camera_to_world transforms, an inline hand model) loads into numpy arrays,
with the cameras and hand model as CPU tensors. The frame sources (video
decoding, the synthetic renderers) wait for a later slice.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..geometry import camera as cam
from ..kinematics.hand_model import HandModel, hand_model_from_dict
from ..kinematics.skinning import landmarks_from_hand_pose


@dataclasses.dataclass
class HandPoseLabels:
    """Parsed recording labels (reference video_pose_data.py:23-93)."""

    cameras: cam.Camera  # batch (V,) intrinsics only (identity extrinsics), CPU
    camera_kind: str
    camera_angles: np.ndarray  # (V,)
    camera_to_world: np.ndarray  # (T, V, 4, 4)
    hand_model: HandModel  # millimeters, CPU
    joint_angles: np.ndarray  # (T, 2, 22)
    wrist_transforms: np.ndarray  # (T, 2, 4, 4)
    hand_confidences: np.ndarray  # (T, 2)

    def __len__(self) -> int:
        return len(self.joint_angles)

    @property
    def num_views(self) -> int:
        return len(self.camera_angles)

    def cameras_at(self, frame_idx: int) -> cam.Camera:
        """Source cameras with this frame's extrinsics attached."""
        return self.cameras._replace(
            T_world_from_eye=torch.as_tensor(self.camera_to_world[frame_idx], dtype=torch.float32)
        )


def labels_from_json(labels: dict) -> HandPoseLabels:
    """A parsed label JSON (the reference's schema) -> ``HandPoseLabels``."""
    cams, kinds = [], []
    for js in labels["cameras"]:
        c, kind = cam.camera_from_json(js)
        cams.append(c)
        kinds.append(kind)
    if len(set(kinds)) != 1:
        raise ValueError(f"mixed camera kinds unsupported: {sorted(set(kinds))}")
    return HandPoseLabels(
        cameras=cam.stack_cameras(cams),
        camera_kind=kinds[0],
        camera_angles=np.asarray(labels["camera_angles"], np.float32),
        camera_to_world=np.asarray(labels["camera_to_world_transforms"], np.float32),
        hand_model=hand_model_from_dict(labels["hand_model"]),
        joint_angles=np.asarray(labels["joint_angles"], np.float32),
        wrist_transforms=np.asarray(labels["wrist_transforms"], np.float32),
        hand_confidences=np.asarray(labels["hand_confidences"], np.float32),
    )


def load_labels(path: str) -> HandPoseLabels:
    with open(path) as f:
        return labels_from_json(json.load(f))


@torch.no_grad()
def gt_landmark_sequence(labels: HandPoseLabels) -> np.ndarray:
    """(T, 2, 21, 3) FK landmarks of the GT poses (world, mm), on the CPU."""
    t = len(labels)
    hand_b = labels.hand_model.map(lambda x: x.expand((t, 2) + x.shape))
    lm = landmarks_from_hand_pose(
        hand_b,
        torch.as_tensor(labels.joint_angles),
        torch.as_tensor(labels.wrist_transforms),
        torch.arange(2).expand(t, 2),
    )
    return lm.numpy()
