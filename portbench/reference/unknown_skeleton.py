"""UmeTrack's unknown-skeleton evaluation protocol in plain PyTorch.

Per recording (UmeTrack, SIGGRAPH Asia 2022; upstream
``run_eval_unknown_skeleton.py``): pass 1 tracks the first frames with the
unknown-skeleton head (``regressor_u``, which also predicts a log scale of
the skeleton), crops driven through the generic skeleton and two views
required a hand; the per-frame scales of each hand with at least 2 valid
frames give one scale for that hand, the recording's scale is the mean of
its hands' (1.0 where neither has one); pass 2 tracks the whole recording
afresh, known-skeleton style, with the generic skeleton scaled by it
(``tracking.track``).

Departures from the published protocol:
- The published aggregation is the mean of the per-frame scales. Here it is
  a windowed Gauss-Newton fit (the `--calib-mode gn` option of the program
  under test): the targets are FK of each valid frame's predicted pose on
  the generic skeleton scaled by that frame's predicted scale (a right
  hand's wrist with its world mirror undone); the unknowns are each frame's
  20 finger angles and wrist increment (axis-angle rotation, then
  translation in mm, right-multiplied) and one log-scale; 6 iterations,
  each solving the window's dense normal equations of 26 T + 1 unknowns,
  J^T J + damping I, with no elimination. Each Jacobian row comes from
  ``torch.autograd``: a frame's residual depends on its own pose and on the
  scale alone, so the scale is given to each frame as its own copy, and the
  backward pass of one landmark coordinate summed over the frames yields
  that row for every frame at once.
- The generic skeleton is the scene's hand (the published
  ``generic_hand_model.json`` is not in the repository).
- Crops come from the labelled poses (the evaluation's pose-driven crops),
  as in ``tracking.py``.
"""

from __future__ import annotations

import torch

from . import kinematics as kin
from .network import Net, decode
from .tracking import crop_inputs, track

N_POSE = 26  # 20 finger angles, 3 wrist rotation, 3 wrist translation


def first_frames(rec: dict, n: int) -> dict:
    """The recording's first ``n`` frames (its per-frame fields cut)."""
    per_frame = ("frames", "cam_to_world", "joint_angles", "wrist", "confidence")
    return {k: (v[:n] if k in per_frame else v) for k, v in rec.items()}


@torch.no_grad()
def calibration_pass(cfg: dict, params, rec: dict, trunk_dtype=torch.bfloat16, bf16_rows: bool = True,
                     fp8: bool = False) -> dict:
    """Pass 1 over ``rec`` -> dict of (F, 2, ...): ``angles``, ``wrist_mm``
    (world, right hands mirrored), ``valid`` and ``scale``. A hand needs both
    of its view slots usable."""
    net = Net(cfg, params, trunk_dtype, fp8)
    x = crop_inputs(rec, tuple(cfg["input_size"]), bf16_rows)
    hand_ok = x["hand_ok"] & x["view_ok"].all(-1)
    view_ok = x["view_ok"] & hand_ok[..., None]
    images = torch.where(view_ok[..., None, None], x["images"], 0.0)
    n_f = images.shape[0]
    dev = images.device
    feats = net.trunk(images.flatten(0, 1), x["intrinsics"].flatten(0, 1), x["extrinsics"].flatten(0, 1),
                      view_ok.flatten(0, 1)).unflatten(0, (n_f, 2))
    fh, fw = feats.shape[-2:]
    mem = torch.zeros(2, cfg["n_temporal_memory_channels"], fh, fw, device=dev)
    prev = torch.zeros(2, 4, 4, device=dev)
    hist = torch.zeros(2, dtype=torch.bool, device=dev)
    right = torch.tensor([False, True], device=dev)
    outs = {k: [] for k in ("angles", "wrist_mm", "valid", "scale")}
    for t in range(n_f):
        ok = hand_ok[t]
        ext0 = x["extrinsics"][t][:, 0]
        new_mem, fused = net.memory(mem, prev, feats[t], ext0, hist & ok)
        out = decode(net, fused, None, ext0, known=False)
        mem = torch.where(ok[:, None, None, None], new_mem, mem)
        prev = torch.where(ok[:, None, None], ext0, prev)
        hist = ok
        wrist = kin.mirror_x_column(out.wrist_world, right)
        wrist[:, :3, 3] = wrist[:, :3, 3] * 1e3
        outs["angles"].append(out.angles)
        outs["wrist_mm"].append(wrist)
        outs["valid"].append(ok)
        outs["scale"].append(out.scale)
    return {k: torch.stack(v) for k, v in outs.items()}


def scaled(hand: dict, scale: torch.Tensor) -> dict:
    """The FK dict with its lengths times ``scale`` (...,), batched over it."""
    s = scale[..., None, None]
    return dict(hand, rest=hand["rest"] * s, lm_rest=hand["lm_rest"] * s)


def step(angles: torch.Tensor, wrist: torch.Tensor, delta: torch.Tensor):
    """Angles plus the 20 finger increments; the wrist times the rigid
    increment [exp(rotation) | translation] on its right."""
    angles = torch.cat([angles[..., :20] + delta[..., :20], angles[..., 20:]], -1)
    inc = torch.eye(4, device=wrist.device).expand_as(wrist).clone()
    inc[..., :3, :3] = kin.rodrigues(delta[..., 20:23])
    inc[..., :3, 3] = delta[..., 23:26]
    return angles, wrist @ inc


def gn_log_scales(hand: dict, targets: torch.Tensor, angles: torch.Tensor, wrist: torch.Tensor,
                  mask: torch.Tensor, iters: int = 6, damping: float = 1e-3) -> torch.Tensor:
    """Each window's log-scale fitted with its per-frame poses: ``targets``
    (W, T, 21, 3) mm, ``angles`` (W, T, 22), left-canonical ``wrist`` (W, T,
    4, 4) mm, ``mask`` (W, T) -> (W,). Dense Gauss-Newton, as the module's
    docstring sets out."""
    n_w, n_t = mask.shape
    dev = targets.device
    n = N_POSE * n_t + 1
    log_s = torch.zeros(n_w, device=dev)
    m = mask.float()[..., None]
    for _ in range(iters):
        delta = torch.zeros(n_w, n_t, N_POSE, device=dev, requires_grad=True)
        s_copies = log_s[:, None].expand(n_w, n_t).clone().requires_grad_(True)
        with torch.enable_grad():
            a, w = step(angles, wrist, delta)
            lm = kin.landmarks(scaled(hand, torch.exp(s_copies)), a, w)
            res = ((lm - targets) * m[..., None]).flatten(2)  # (W, T, 63)
            rows = []
            for k in range(res.shape[-1]):
                d_pose, d_scale = torch.autograd.grad(res[..., k].sum(), (delta, s_copies), retain_graph=True)
                rows.append(torch.cat([d_pose, d_scale[..., None]], -1))
        block = torch.stack(rows, 2)  # (W, T, 63, 27): d residual / d (own pose, scale)
        jac = torch.zeros(n_w, n_t, 63, n, device=dev)
        for t in range(n_t):
            jac[:, t, :, N_POSE * t:N_POSE * (t + 1)] = block[:, t, :, :N_POSE]
        jac[..., -1] = block[..., N_POSE]
        jac = jac.reshape(n_w, n_t * 63, n)
        r = res.detach().reshape(n_w, n_t * 63, 1)
        normal = jac.transpose(1, 2) @ jac + damping * torch.eye(n, device=dev)
        step_all = -torch.linalg.solve(normal, jac.transpose(1, 2) @ r)[..., 0]
        angles, wrist = step(angles, wrist, step_all[:, :-1].reshape(n_w, n_t, N_POSE))
        log_s = log_s + step_all[:, -1]
    return log_s


def calibrate(hand: dict, calib: dict, iters: int = 6, damping: float = 1e-3):
    """A recording's scale from its pass-1 results -> (scale, {hand: log-scale})."""
    right = torch.tensor([False, True], device=calib["valid"].device)
    windows = [h for h in range(2) if int(calib["valid"][:, h].sum()) >= 2]
    if not windows:
        return 1.0, {}
    valid = calib["valid"][:, windows].T  # (W, T)
    angles = calib["angles"][:, windows].transpose(0, 1)
    wrist = kin.mirror_x_column(calib["wrist_mm"], right)[:, windows].transpose(0, 1)  # left-canonical
    frame_scale = torch.where(valid, calib["scale"][:, windows].T, 1.0)
    targets = kin.landmarks(scaled(hand, frame_scale), angles, wrist)
    log_s = gn_log_scales(hand, targets, angles, wrist, valid, iters, damping)
    by_hand = dict(zip(windows, log_s.tolist()))
    return float(torch.exp(log_s).mean()), by_hand


def protocol(cfg: dict, params, rec: dict, calib_frames: int = 30, iters: int = 6, damping: float = 1e-3,
             trunk_dtype=torch.bfloat16, bf16_rows: bool = True, fp8: bool = False, track_scale=None):
    """Both passes and the calibration over one recording, ``rec["hand"]``
    the generic skeleton -> (scale, pass 1's ``calibration_pass`` dict, pass
    2's ``tracking.track`` dict). Pass 2 tracks on the generic skeleton
    scaled by ``track_scale`` where given, else by the calibrated scale."""
    calib = calibration_pass(cfg, params, first_frames(rec, calib_frames), trunk_dtype, bf16_rows, fp8)
    scale, _ = calibrate(rec["hand"], calib, iters, damping)
    hand = scaled(rec["hand"], torch.tensor(scale if track_scale is None else track_scale, device=rec["frames"].device))
    return scale, calib, track(cfg, params, dict(rec, hand=hand), trunk_dtype, bf16_rows, fp8)
