"""Batched Gauss-Newton kinematic fitting with Schur-complement reduction
(port of ``absolutetrack_tpu/ops/gauss_newton.py``).

* ``fit_pose``: per-sample Gauss-Newton refinement of (20 finger DoFs +
  6 wrist DoFs) against target 3D landmarks, batched over samples: each
  iteration builds the (26 x 26) normal equations from the FK Jacobian
  (forward mode through the skinning) and solves them, with Levenberg
  damping.
* ``calibrate_scale_windows``: over W windows of T frames, jointly refine
  each window's per-frame poses and its one shared log-scale. Each normal
  system is arrowhead (T pose blocks and one scalar): every pose block is
  eliminated by 26 x 26 solves batched over all W x T frames and the scalar
  Schur complement S = sum_t (H_ss(t) - H_sp H_pp^-1 H_ps) is summed over
  each window. ``calibrate_scale_window`` is its one-window case.

Wrist updates right-multiply an axis-angle increment (the linearization
is around the identity each iteration); translation is in the landmarks'
units, the scale a log-scale. The Jacobians come from
``torch.func.vmap(torch.func.jacfwd(...))``, the iterations are a Python
loop, the solves ``torch.linalg.solve_ex`` (no error check: as in JAX, a
singular block gives non-finite values, not an exception, and no host
sync). Run with TF32 off for matmuls (``set_conv_precision("highest")``)
for full f32 normal equations on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.func import jacfwd, vmap

from ..kinematics.hand_model import HandModel
from ..kinematics.skinning import skin_landmarks, so3_exp

N_ANGLES = 20
N_POSE = N_ANGLES + 6  # finger DoFs + wrist (3 rot, 3 trans)


class FitResult(NamedTuple):
    joint_angles: torch.Tensor  # (..., 22)
    wrist: torch.Tensor  # (..., 4, 4)
    residual: torch.Tensor  # (...,) final mean landmark error
    log_scale: Optional[torch.Tensor] = None


def _apply_delta(joint_angles, wrist, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """Angles + delta's 20 finger DoFs; wrist' = wrist @ [exp(w) | t]."""
    angles = torch.cat([joint_angles[..., :N_ANGLES] + delta[..., :N_ANGLES], joint_angles[..., N_ANGLES:]], dim=-1)
    rot = so3_exp(delta[..., N_ANGLES : N_ANGLES + 3])
    top = torch.cat([rot, delta[..., N_ANGLES + 3 :, None]], dim=-1)  # (..., 3, 4)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=wrist.dtype, device=wrist.device)
    upd = torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2).to(wrist.dtype)
    return angles, torch.matmul(wrist, upd)


def _landmarks(hand: HandModel, angles, wrist, log_scale=None):
    if log_scale is not None:
        s = torch.exp(log_scale)[..., None, None]
        hand = hand._replace(
            joint_rest_positions=hand.joint_rest_positions * s,
            landmark_rest_positions=hand.landmark_rest_positions * s,
        )
    return skin_landmarks(hand, angles, wrist)


def _batch_dims(hand: HandModel) -> HandModel:
    """``vmap``'s in_dims for a batched hand model (absent fields: None)."""
    return HandModel(*(None if x is None else 0 for x in hand))


def fit_pose(
    hand: HandModel,  # batched (B, ...) left-canonical
    target_landmarks: torch.Tensor,  # (B, 21, 3)
    init_joint_angles: torch.Tensor,  # (B, 22)
    init_wrist: torch.Tensor,  # (B, 4, 4)
    iters: int = 5,
    damping: float = 1e-3,
    weights: Optional[torch.Tensor] = None,  # (B, 21), e.g. 1/sigma^2
) -> FitResult:
    """Batched GN refinement of hand poses against target landmarks."""

    def residual(delta, hand_i, a0, w0, target):
        a, w = _apply_delta(a0, w0, delta)
        return (_landmarks(hand_i, a, w) - target).reshape(-1)

    jac = vmap(jacfwd(residual), in_dims=(None, _batch_dims(hand), 0, 0, 0))
    zero = torch.zeros(N_POSE, dtype=init_wrist.dtype, device=init_wrist.device)
    eye = torch.eye(N_POSE, dtype=init_wrist.dtype, device=init_wrist.device)
    a, w = init_joint_angles, init_wrist
    for _ in range(iters):
        J = jac(zero, hand, a, w, target_landmarks)  # (B, 63, 26)
        r = (_landmarks(hand, a, w) - target_landmarks).reshape(a.shape[0], -1)  # (B, 63)
        if weights is not None:
            sw = torch.sqrt(torch.repeat_interleave(weights, 3, dim=-1))
            J = J * sw[..., None]
            r = r * sw
        H = J.transpose(-1, -2) @ J + damping * eye
        g = (J.transpose(-1, -2) @ r[..., None])[..., 0]
        delta = -torch.linalg.solve_ex(H, g[..., None])[0][..., 0]
        a, w = _apply_delta(a, w, delta)
    res = torch.linalg.vector_norm(_landmarks(hand, a, w) - target_landmarks, dim=-1).mean(dim=-1)
    return FitResult(joint_angles=a, wrist=w, residual=res)


def calibrate_scale_window(
    hand: HandModel,  # unbatched left-canonical generic model
    target_landmarks: torch.Tensor,  # (T, 21, 3), one hand over a window
    init_joint_angles: torch.Tensor,  # (T, 22)
    init_wrist: torch.Tensor,  # (T, 4, 4)
    frame_mask: Optional[torch.Tensor] = None,  # (T,)
    iters: int = 6,
    damping: float = 1e-3,
) -> FitResult:
    """Joint poses + one shared log-scale over a temporal window (GN + Schur):
    the one-window case of ``calibrate_scale_windows``."""
    res = calibrate_scale_windows(
        hand, target_landmarks[None], init_joint_angles[None], init_wrist[None],
        None if frame_mask is None else frame_mask[None], iters, damping,
    )
    return FitResult(*(x[0] for x in res))


def calibrate_scale_windows(
    hand: HandModel,  # unbatched left-canonical generic model
    target_landmarks: torch.Tensor,  # (W, T, 21, 3), one hand over each window
    init_joint_angles: torch.Tensor,  # (W, T, 22)
    init_wrist: torch.Tensor,  # (W, T, 4, 4)
    frame_mask: Optional[torch.Tensor] = None,  # (W, T)
    iters: int = 6,
    damping: float = 1e-3,
) -> FitResult:
    """W windows of T frames, each with its own per-frame poses and one
    shared log-scale, fitted together (GN + Schur) -> fields (W, T, ...),
    ``residual`` and ``log_scale`` (W,).

    Each iteration: per-frame residuals r_t(dp_t, ds) with J_p (63, 26) and
    J_s (63,); each window's arrowhead normal system is reduced by
    eliminating every pose block, S = sum_t (H_ss(t) - H_sp H_pp^-1 H_ps) +
    damping and b = sum_t (g_s(t) - H_sp H_pp^-1 g_p(t)) give its ds = -b / S,
    then each frame's dp_t = -H_pp^-1 (g_p + H_ps ds). The W x T frames run
    as one batch, so the launches do not grow with W.
    """
    dev, dtype = init_wrist.device, init_wrist.dtype
    n_w, n_t = target_landmarks.shape[:2]
    mask = torch.ones(n_w, n_t, device=dev) if frame_mask is None else frame_mask.to(torch.float32)
    eye = torch.eye(N_POSE, dtype=dtype, device=dev)
    zero = torch.zeros(N_POSE, dtype=dtype, device=dev)

    def residual(x, a0, w0, target):  # x = (dp (26), ds)
        a, w = _apply_delta(a0, w0, x[:N_POSE])
        return (_landmarks(hand, a, w, log_scale=x[N_POSE]) - target).reshape(-1)

    def per_frame(log_s, a0, w0, target, m):
        x = torch.cat([zero, log_s[None]])
        J = jacfwd(residual)(x, a0, w0, target)  # (63, 27): J_p | J_s
        r = residual(x, a0, w0, target)
        return J[:, :N_POSE] * m, J[:, N_POSE] * m, r * m

    def flat(x):  # (W, T, ...) -> (W*T, ...)
        return x.reshape((n_w * n_t,) + x.shape[2:])

    def per_window(x):  # (W,) -> (W*T,)
        return x[:, None].expand(n_w, n_t).reshape(-1)

    frames = vmap(per_frame)
    angles, wrist = flat(init_joint_angles), flat(init_wrist)
    target, m = flat(target_landmarks), flat(mask)
    log_s = torch.zeros(n_w, dtype=dtype, device=dev)
    for _ in range(iters):
        J_p, J_s, r = frames(per_window(log_s), angles, wrist, target, m)
        J_pt = J_p.transpose(-1, -2)
        H_pp = J_pt @ J_p + damping * eye  # (W*T, 26, 26)
        H_ps = (J_pt @ J_s[..., None])[..., 0]  # (W*T, 26)
        H_ss = (J_s * J_s).sum(-1)
        g_p = (J_pt @ r[..., None])[..., 0]
        g_s = (J_s * r).sum(-1)
        Hinv_gp = torch.linalg.solve_ex(H_pp, g_p[..., None])[0][..., 0]
        Hinv_Hps = torch.linalg.solve_ex(H_pp, H_ps[..., None])[0][..., 0]
        S_t = H_ss - (H_ps * Hinv_Hps).sum(-1)
        b_t = g_s - (H_ps * Hinv_gp).sum(-1)
        ds = -b_t.view(n_w, n_t).sum(-1) / (S_t.view(n_w, n_t).sum(-1) + damping)  # (W,)
        # back-substitute the per-frame pose updates
        dp = -torch.linalg.solve_ex(H_pp, (g_p + H_ps * per_window(ds)[:, None])[..., None])[0][..., 0]
        angles, wrist = _apply_delta(angles, wrist, dp * m[:, None])
        log_s = log_s + ds

    final = _landmarks(
        hand.map(lambda x: x.expand((n_w * n_t,) + x.shape)), angles, wrist, log_scale=per_window(log_s)
    )
    err = torch.linalg.vector_norm(final - target, dim=-1).mean(dim=-1).view(n_w, n_t)
    res = (err * mask).sum(-1) / torch.clamp(mask.sum(-1), min=1.0)
    return FitResult(
        joint_angles=angles.view(n_w, n_t, -1), wrist=wrist.view(n_w, n_t, 4, 4), residual=res, log_scale=log_s
    )
