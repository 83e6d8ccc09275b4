"""The 22-joint / 21-landmark hand model (port of ``absolutetrack_tpu/kinematics/hand_model.py``).

Field shapes as in the JAX package::

  joint_rotation_axes        (..., 22, 3)
  joint_rest_positions       (..., 22, 3)
  joint_frame_index          (..., 22)      int
  joint_parent               (..., 22)      int
  joint_first_child          (..., 22)      int
  joint_next_sibling         (..., 22)      int
  landmark_rest_positions    (..., 21, 3)
  landmark_rest_bone_weights (..., 21, 3)
  landmark_rest_bone_indices (..., 21, 3)   int
  hand_scale, mesh_vertices, mesh_triangles, dense_bone_weights,
  joint_limits (..., 22, 2)                 optional
"""

from __future__ import annotations

import json
from typing import List, NamedTuple, Optional

import numpy as np
import torch

NUM_HANDS = 2
NUM_LANDMARKS_PER_HAND = 21
NUM_JOINTS_PER_HAND = 22
NUM_DIGITS = 5
NUM_JOINT_FRAMES = 1 + 1 + 3 * 5  # root + wrist + 3 frames per finger
DOF_PER_FINGER = 4
LEFT_HAND_INDEX = 0
RIGHT_HAND_INDEX = 1

_INT_FIELDS = (
    "joint_frame_index",
    "joint_parent",
    "joint_first_child",
    "joint_next_sibling",
    "landmark_rest_bone_indices",
    "mesh_triangles",
)


class HandModel(NamedTuple):
    joint_rotation_axes: torch.Tensor
    joint_rest_positions: torch.Tensor
    joint_frame_index: torch.Tensor
    joint_parent: torch.Tensor
    joint_first_child: torch.Tensor
    joint_next_sibling: torch.Tensor
    landmark_rest_positions: torch.Tensor
    landmark_rest_bone_weights: torch.Tensor
    landmark_rest_bone_indices: torch.Tensor
    hand_scale: Optional[torch.Tensor] = None
    mesh_vertices: Optional[torch.Tensor] = None
    mesh_triangles: Optional[torch.Tensor] = None
    dense_bone_weights: Optional[torch.Tensor] = None
    joint_limits: Optional[torch.Tensor] = None

    def map(self, fn) -> "HandModel":
        """Apply ``fn`` to every field that is present."""
        return HandModel(*(None if x is None else fn(x) for x in self))

    def to(self, device) -> "HandModel":
        return self.map(lambda x: x.to(device))


def hand_model_from_dict(d: dict, device=None) -> HandModel:
    """Build a HandModel from a dict of array-likes (a parsed JSON dict)."""
    kwargs = {}
    for field in HandModel._fields:
        v = d.get(field)
        if v is None:
            kwargs[field] = None
        else:
            dtype = torch.int64 if field in _INT_FIELDS else torch.float32
            kwargs[field] = torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
    return HandModel(**kwargs)


def load_hand_model_json(path: str, device=None) -> HandModel:
    """A hand model JSON of the reference's schema (``generic_hand_model.json``)."""
    with open(path) as f:
        return hand_model_from_dict(json.load(f), device=device)


def stack_hand_models(hands: List[HandModel]) -> HandModel:
    """Stack hand models along a new leading batch axis (one per recording),
    as ``jax.tree.map(jnp.stack, *hands)`` does."""
    return HandModel(
        *(None if xs[0] is None else torch.stack(xs) for xs in zip(*hands))
    )


def scaled_hand_model(hand: HandModel, multiplier) -> HandModel:
    """Uniformly scale rest positions, landmarks and mesh."""
    m = torch.as_tensor(
        multiplier,
        dtype=hand.joint_rest_positions.dtype,
        device=hand.joint_rest_positions.device,
    )
    mm = m[..., None, None]
    return hand._replace(
        joint_rest_positions=hand.joint_rest_positions * mm,
        landmark_rest_positions=hand.landmark_rest_positions * mm,
        mesh_vertices=None if hand.mesh_vertices is None else hand.mesh_vertices * mm,
    )


def mirrored_hand_model(hand: HandModel, to_mirror) -> HandModel:
    """Mirror the model about x where ``to_mirror`` holds (broadcast over the
    model's leading batch dims): rotation-axis y, z and rest-position x
    components flip sign (reference hand.py:114-147)."""
    like = hand.joint_rotation_axes
    mask = torch.as_tensor(to_mirror, device=like.device)[..., None, None]
    flip_yz = torch.tensor([1.0, -1.0, -1.0], dtype=like.dtype, device=like.device)
    flip_x = torch.tensor([-1.0, 1.0, 1.0], dtype=like.dtype, device=like.device)
    return hand._replace(
        joint_rotation_axes=torch.where(mask, like * flip_yz, like),
        joint_rest_positions=torch.where(mask, hand.joint_rest_positions * flip_x, hand.joint_rest_positions),
        landmark_rest_positions=torch.where(
            mask, hand.landmark_rest_positions * flip_x, hand.landmark_rest_positions
        ),
    )


def neutral_joint_angles(hand: HandModel, lower_factor: float = 0.5) -> torch.Tensor:
    """Mid-range joint angles (reference lib/tracker/perspective_crop.py:19-24)."""
    jl = hand.joint_limits
    if jl is None:
        raise ValueError("hand model carries no joint limits")
    return jl[..., 0] * lower_factor + jl[..., 1] * (1.0 - lower_factor)


def landmark_skinning_matrix(hand: HandModel) -> torch.Tensor:
    """Dense (..., 21, 17) skinning matrix from sparse <=3-bone weights."""
    idx = hand.landmark_rest_bone_indices
    w = hand.landmark_rest_bone_weights
    frames = torch.arange(NUM_JOINT_FRAMES, device=idx.device)
    one_hot = (idx[..., None] == frames).to(w.dtype)
    return torch.sum(w[..., None] * one_hot, dim=-2)
