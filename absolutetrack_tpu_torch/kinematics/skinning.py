"""Forward kinematics + linear-blend skinning (port of ``absolutetrack_tpu/kinematics/skinning.py``).

The finger chains compose (R, t) pairs batched over (batch x 5 fingers);
the sparse skinning weights are a dense (21, 17) matrix, the mesh's are
the model's own dense (V, 17) ``dense_bone_weights``.
"""

from __future__ import annotations

import torch

from .hand_model import (
    DOF_PER_FINGER,
    NUM_DIGITS,
    HandModel,
    landmark_skinning_matrix,
)


def so3_exp(w: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rodrigues' formula for axis-angle vectors (..., 3) -> (..., 3, 3),
    with Taylor guards at theta -> 0.

    The angle terms keep a trailing axis of 1: under ``torch.func`` a
    single vector's 0-d terms would meet Python scalars, where forward
    mode promotes the tangent to float64 (PyTorch 2.13)."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = theta2 < eps
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    sin_t = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cos_t = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)

    x, y, z = w.unbind(-1)
    zero = torch.zeros_like(x)
    k = torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(k.shape)
    return eye + sin_t[..., None] * k + cos_t[..., None] * torch.matmul(k, k)


def _compose_rt(r1, t1, r2, t2):
    """(R1, t1) . (R2, t2) = (R1 R2, R1 t2 + t1)."""
    return torch.matmul(r1, r2), torch.einsum("...ij,...j->...i", r1, t2) + t1


def _skinning_rt(rotation_axes, rest_positions, joint_angles, wrist_transforms):
    """The 17 skinning frames as (rot (..., 17, 3, 3), trans (..., 17, 3)):
    [root, wrist, then frames 2-4 of each finger's 4-joint chain]."""
    n20 = NUM_DIGITS * DOF_PER_FINGER
    w = rotation_axes[..., :n20, :] * joint_angles[..., :n20, None]
    rot = so3_exp(w)
    rest = rest_positions[..., :n20, :]
    trans = rest - torch.einsum("...ij,...j->...i", rot, rest)

    batch = rot.shape[:-3]
    r_f = rot.reshape(batch + (NUM_DIGITS, DOF_PER_FINGER, 3, 3))
    t_f = trans.reshape(batch + (NUM_DIGITS, DOF_PER_FINGER, 3))

    rw = wrist_transforms[..., None, :3, :3]
    tw = wrist_transforms[..., None, :3, 3]
    r01, t01 = _compose_rt(rw, tw, r_f[..., 0, :, :], t_f[..., 0, :])
    r2, t2 = _compose_rt(r01, t01, r_f[..., 1, :, :], t_f[..., 1, :])
    r3, t3 = _compose_rt(r2, t2, r_f[..., 2, :, :], t_f[..., 2, :])
    r4, t4 = _compose_rt(r3, t3, r_f[..., 3, :, :], t_f[..., 3, :])
    finger_r = torch.stack([r2, r3, r4], dim=-3).reshape(batch + (NUM_DIGITS * 3, 3, 3))
    finger_t = torch.stack([t2, t3, t4], dim=-2).reshape(batch + (NUM_DIGITS * 3, 3))

    rw2 = wrist_transforms[..., None, :3, :3].expand(batch + (2, 3, 3))
    tw2 = wrist_transforms[..., None, :3, 3].expand(batch + (2, 3))
    return torch.cat([rw2, finger_r], dim=-3), torch.cat([tw2, finger_t], dim=-2)


def skinning_transforms(rotation_axes, rest_positions, joint_angles, wrist_transforms):
    """The 17 skinning frames as (..., 17, 4, 4)."""
    r, t = _skinning_rt(rotation_axes, rest_positions, joint_angles, wrist_transforms)
    top = torch.cat([r, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=r.dtype, device=r.device)
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def skin_points(
    hand: HandModel,
    skin_matrix: torch.Tensor,  # (..., V, 17)
    points: torch.Tensor,  # (..., V, 3)
    joint_angles: torch.Tensor,  # (..., 22)
    wrist_transforms: torch.Tensor,  # (..., 4, 4)
) -> torch.Tensor:
    """LBS: out_v = sum_f skin[v,f] * (R_f @ p_v + t_f) -> (..., V, 3)."""
    r, t = _skinning_rt(
        hand.joint_rotation_axes, hand.joint_rest_positions, joint_angles, wrist_transforms
    )
    return torch.einsum("...vf,...fij,...vj->...vi", skin_matrix, r, points) + torch.einsum(
        "...vf,...fi->...vi", skin_matrix, t
    )


def skin_landmarks(hand: HandModel, joint_angles, wrist_transforms) -> torch.Tensor:
    """21 world-space landmarks for the given pose (..., 21, 3)."""
    return skin_points(
        hand,
        landmark_skinning_matrix(hand),
        hand.landmark_rest_positions,
        joint_angles,
        wrist_transforms,
    )


def skin_mesh_vertices(hand: HandModel, joint_angles, wrist_transforms) -> torch.Tensor:
    """The skinned mesh for the given pose (..., V, 3): the landmarks' LBS
    blend over the model's dense per-vertex weights."""
    if hand.mesh_vertices is None or hand.dense_bone_weights is None:
        raise ValueError("hand model carries no mesh")
    return skin_points(hand, hand.dense_bone_weights, hand.mesh_vertices, joint_angles, wrist_transforms)


def _mirror_right_wrist(wrist_transform: torch.Tensor, hand_idx) -> torch.Tensor:
    """The wrist transform with its x column negated for right hands (the
    model stores left hands only)."""
    hand_idx = torch.as_tensor(hand_idx, device=wrist_transform.device)
    sign = torch.where(hand_idx == 1, -1.0, 1.0).to(wrist_transform.dtype)
    xf = wrist_transform.clone()
    xf[..., :, 0] = xf[..., :, 0] * sign[..., None]
    return xf


def mesh_from_hand_pose(hand: HandModel, joint_angles, wrist_transform, hand_idx) -> torch.Tensor:
    """World mesh vertices, with the right-hand wrist mirror applied."""
    return skin_mesh_vertices(hand, joint_angles, _mirror_right_wrist(wrist_transform, hand_idx))


def landmarks_from_hand_pose(
    hand: HandModel,
    joint_angles: torch.Tensor,
    wrist_transform: torch.Tensor,
    hand_idx: torch.Tensor,
) -> torch.Tensor:
    """World landmarks; for right hands the wrist's x column flips sign
    before FK (the model stores left hands only)."""
    return skin_landmarks(hand, joint_angles, _mirror_right_wrist(wrist_transform, hand_idx))
