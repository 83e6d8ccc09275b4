"""The hand's forward kinematics and skinning in plain PyTorch.

A hand has 22 joints with rotation axes and rest positions; joints
4f..4f+3 are finger f's chain (20 of them rotate), and 17 skinning frames
move the 21 landmarks: the root and the wrist (both the wrist transform)
and, for each finger, the frames after its second, third and fourth
joint. Joint j rotates by angle_j about its axis through its rest
position. A landmark is the blend of its (at most 3) frames' images of
its rest position, with its bone weights.
"""

from __future__ import annotations

import torch


def rodrigues(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle vectors (..., 3) -> rotations (..., 3, 3), with the
    series of sin(t)/t and (1 - cos(t))/t^2 below t^2 = 1e-8."""
    t2 = (w * w).sum(-1, keepdim=True)[..., None]
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2s)
    a = torch.where(small, 1 - t2 / 6, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24, (1 - torch.cos(t)) / t2s)
    x, y, z = w.unbind(-1)
    o = torch.zeros_like(x)
    k = torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1), torch.stack([-y, x, o], -1)], -2)
    return torch.eye(3, device=w.device, dtype=w.dtype) + a * k + b * (k @ k)


def frames(axes, rest, angles, wrist):
    """The 17 skinning frames as (R (..., 17, 3, 3), t (..., 17, 3))."""
    r = rodrigues(axes[..., :20, :] * angles[..., :20, None])
    t = rest[..., :20, :] - (r @ rest[..., :20, :, None])[..., 0]
    rw, tw = wrist[..., :3, :3], wrist[..., :3, 3]
    out_r, out_t = [rw, rw], [tw, tw]
    per_finger = [[], [], []]
    for f in range(5):
        cr, ct = rw, tw
        for j in range(4):
            jr, jt = r[..., 4 * f + j, :, :], t[..., 4 * f + j, :]
            cr, ct = cr @ jr, (cr @ jt[..., None])[..., 0] + ct
            if j:
                per_finger[j - 1].append((f, cr, ct))
    # frame 2 + 3 f + s follows joints 0..s+1 of finger f
    for f in range(5):
        for s in range(3):
            _, cr, ct = per_finger[s][f]
            out_r.append(cr)
            out_t.append(ct)
    return torch.stack(out_r, -3), torch.stack(out_t, -2)


def landmarks(hand: dict, angles: torch.Tensor, wrist: torch.Tensor) -> torch.Tensor:
    """World landmarks (..., 21, 3) of a left-canonical hand: ``hand`` holds
    ``axes`` and ``rest`` (..., 22, 3), ``lm_rest`` (..., 21, 3) and the
    dense ``weights`` (..., 21, 17), broadcast against the pose's batch."""
    r, t = frames(hand["axes"], hand["rest"], angles, wrist)
    moved = torch.einsum("...fij,...vj->...vfi", r, hand["lm_rest"]) + t[..., None, :, :]
    return torch.einsum("...vf,...vfi->...vi", hand["weights"], moved)


def dense_weights(bone_weights: torch.Tensor, bone_indices: torch.Tensor) -> torch.Tensor:
    """(..., 21, 3) sparse weights and frame indices -> (..., 21, 17)."""
    onehot = (bone_indices[..., None] == torch.arange(17, device=bone_indices.device)).to(bone_weights.dtype)
    return (bone_weights[..., None] * onehot).sum(-2)


def mirror_x_column(xf: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) transforms with the x column negated where ``right``."""
    sign = torch.where(right, -1.0, 1.0).to(xf.dtype)
    col = torch.stack([sign, torch.ones_like(sign), torch.ones_like(sign), torch.ones_like(sign)], -1)
    return xf * col[..., None, :]
