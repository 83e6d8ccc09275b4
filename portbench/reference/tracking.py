"""The pose-driven evaluation tracker in plain PyTorch.

Per frame and hand (millimetres, world space): the forward kinematics of
three poses (the labelled one, the neutral one at the middle of the joint
limits, and all angles 0; a right hand is the left-canonical model with
its wrist's x column negated) bound the crop. A camera is eligible when
at least 19 of the labelled pose's 21 landmarks project inside its
fisheye62 window in front of it; the two lowest-indexed eligible cameras
take the hand's two view slots, and a hand needs a confidence of 0.5 and
one slot. Each slot's pinhole crop camera sits at its source camera,
looks at the centre of the bounding points' box, is rolled by the
camera's mounting angle, mirrored in x for a right hand, and has the
focal length that puts every bounding point inside the crop, times 0.8.
The crop's pixels are sampled bilinearly from the uint8 view (0 where a
tap leaves the view), divided by 255. The network runs with crop
extrinsics in metres; the memory carries over the frames of a recording
where the hand stays valid. Outputs: joint angles, the world wrist in mm
(right hands mirrored), validity, and the landmarks of that pose.
"""

from __future__ import annotations

import math

import torch

from . import kinematics as kin
from .network import Net, decode, rigid_inverse

VIS_LANDMARKS = 19
CONFIDENCE = 0.5
FOCAL_SHARE = 0.8
MIN_FOCAL = 5.0


def fisheye62(eye: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Eye-space points (..., 3) -> distorted normalized coordinates (..., 2);
    ``coeffs`` (..., 8) are k1 k2 k3 k4 p1 p2 k5 k6."""
    x, y, z = eye.unbind(-1)
    r = torch.sqrt(x * x + y * y)
    s = torch.atan2(r, z) / torch.clamp(r, min=2.0**-128)
    px, py = x * s, y * s
    k1, k2, k3, k4, p1, p2, k5, k6 = coeffs.unbind(-1)
    r2 = torch.clamp(px * px + py * py, -math.pi**2, math.pi**2)
    radial = 1 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * (k4 + r2 * (k5 + r2 * k6)))))
    ux, uy = px * radial, py * radial
    rr = ux * ux + uy * uy
    dx = ux + 2 * p2 * ux * uy + p1 * (rr + 2 * ux * ux)
    dy = uy + 2 * p1 * ux * uy + p2 * (rr + 2 * uy * uy)
    return torch.stack([dx, dy], -1)


def rotation_z(deg: torch.Tensor) -> torch.Tensor:
    a = torch.deg2rad(deg)
    c, s = torch.cos(a), torch.sin(a)
    o, i = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, o], -1), torch.stack([s, c, o], -1), torch.stack([o, o, i], -1)], -2)


def z_to(d: torch.Tensor) -> torch.Tensor:
    """The rotation taking +z to the unit direction ``d`` by the shortest arc."""
    ez = torch.zeros_like(d)
    ez[..., 2] = 1.0
    v = torch.linalg.cross(ez, d, dim=-1)
    c = d[..., 2]
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    k = torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1), torch.stack([-y, x, o], -1)], -2)
    f = (1 - c) / torch.clamp((v * v).sum(-1), min=1e-15)
    return torch.eye(3, device=d.device) + k + (k @ k) * f[..., None, None]


def apply(xf, pts):
    return (xf[..., None, :3, :3] @ pts[..., None])[..., 0] + xf[..., None, :3, 3]


def sample(frames: torch.Tensor, view: torch.Tensor, x: torch.Tensor, y: torch.Tensor, bf16_rows: bool):
    """Bilinear samples of uint8 ``frames`` (V, H, W) at (x, y) planes
    (N, P) of view ``view`` (N,); 0 where a tap is outside the view. With
    ``bf16_rows`` the row weights 1 - wy and 1 - (1 - wy) round to
    bfloat16 and the column mix is float32 (the serving preset's rows)."""
    h, w = frames.shape[-2:]
    x0, y0 = torch.floor(x), torch.floor(y)
    valid = (x >= 0) & (x0 + 1 <= w - 1) & (y >= 0) & (y0 + 1 <= h - 1)
    xi = x0.clamp(0, w - 2).long()
    yi = y0.clamp(0, h - 2).long()
    flat = frames.reshape(frames.shape[0], -1).float()
    base = flat[view]  # (N, H*W)

    def tap(dy, dx):
        return torch.gather(base, 1, (yi + dy) * w + xi + dx)

    f00, f01, f10, f11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    wx, wy = x - x0, y - y0
    if bf16_rows:
        ay, ax = 1 - wy, 1 - wx
        r0 = ay.to(torch.bfloat16).float()
        r1 = (1 - ay).to(torch.bfloat16).float()
        out = (r0 * f00 + r1 * f10) * ax + (r0 * f01 + r1 * f11) * (1 - ax)
    else:
        out = f00 * (1 - wx) * (1 - wy) + f01 * wx * (1 - wy) + f10 * (1 - wx) * wy + f11 * wx * wy
    return torch.where(valid, out, 0.0)


def crop_inputs(rec: dict, crop_hw, bf16_rows: bool):
    """Crops and network inputs of every frame of one recording.

    ``rec``: ``frames`` (F, V, H, W) uint8, ``fx fy cx cy`` (V,),
    ``coeffs`` (V, 8), ``cam_to_world`` (F, V, 4, 4), ``angles_deg`` (V,),
    ``hand`` (the FK dict, mm, with ``limits`` (22, 2)), ``joint_angles``
    (F, 2, 22), ``wrist`` (F, 2, 4, 4) mm, ``confidence`` (F, 2).
    -> dict of (F, 2, ...) tensors."""
    dev = rec["frames"].device
    n_f, n_v, h, w = rec["frames"].shape
    ch, cw = crop_hw
    hand = rec["hand"]
    right = torch.tensor([False, True], device=dev)
    neutral = hand["limits"][:, 0] * 0.5 + hand["limits"][:, 1] * 0.5
    ja = rec["joint_angles"]
    poses = torch.stack([ja, neutral.expand_as(ja), torch.zeros_like(ja)], 2)  # (F, 2, 3, 22)
    wrist = kin.mirror_x_column(rec["wrist"], right)[:, :, None].expand(-1, -1, 3, -1, -1)
    pts = kin.landmarks(hand, poses, wrist).flatten(2, 3)  # (F, 2, 63, 3), pose-major

    c2w = rec["cam_to_world"]  # (F, V, 4, 4)
    rel = pts[:, :, None, :21, :] - c2w[:, None, :, None, :3, 3]  # (F, 2, V, 21, 3)
    eye = (rel[..., None, :] @ c2w[:, None, :, None, :3, :3])[..., 0, :]  # R^T (p - t)
    d = fisheye62(eye, rec["coeffs"][:, None, :])
    wx = d[..., 0] * rec["fx"][:, None] + rec["cx"][:, None]
    wy = d[..., 1] * rec["fy"][:, None] + rec["cy"][:, None]
    seen = (wx >= 0) & (wx <= w - 1) & (wy >= 0) & (wy <= h - 1) & (eye[..., 2] > 0)
    eligible = seen.sum(-1) >= VIS_LANDMARKS  # (F, 2, V)
    cams = torch.arange(n_v, device=dev)
    key = torch.where(eligible, cams, n_v + cams)  # eligible cameras first, each group by index
    view = torch.argsort(key, dim=-1)[..., :2]
    slot_ok = torch.gather(eligible, -1, view)
    confident = rec["confidence"] >= CONFIDENCE
    hand_ok = confident & slot_ok.any(-1)
    view_ok = slot_ok & hand_ok[..., None]

    w2e = rigid_inverse(c2w)  # (F, V, 4, 4)
    fi = torch.arange(n_f, device=dev)[:, None, None]
    src_w2e = w2e[fi, view]  # (F, 2, 2, 4, 4)
    roll = rec["angles_deg"][view]
    center = (pts.amin(-2) + pts.amax(-2)) / 2  # (F, 2, 3)
    c_local = apply(src_w2e, center[:, :, None, None, :])[..., 0, :]
    delta = z_to(c_local / torch.linalg.norm(c_local, dim=-1, keepdim=True))
    e2w = rigid_inverse(src_w2e)
    rot = e2w[..., :3, :3] @ delta @ rotation_z(roll)
    new_e2w = torch.cat([torch.cat([rot, e2w[..., :3, 3:]], -1), e2w[..., 3:, :]], -2)
    crop_w2e = rigid_inverse(new_e2w)
    mirror = torch.diag(torch.tensor([-1.0, 1.0, 1.0, 1.0], device=dev))
    crop_w2e = torch.where(right[:, None, None, None], mirror @ crop_w2e, crop_w2e)
    p_eye = apply(crop_w2e, pts[:, :, None].expand(-1, -1, 2, -1, -1))  # (F, 2, 2, 63, 3)
    half = torch.tensor([(cw - 1) / 2, (ch - 1) / 2], device=dev)
    reach = (p_eye[..., :2] / p_eye[..., 2:]).abs().amax((-1, -2))
    focal = half / reach[..., None]
    crop_ok = ~((p_eye[..., 2] < 1e-4).any(-1) | (focal < MIN_FOCAL).any(-1))
    focal = FOCAL_SHARE * focal
    view_ok = view_ok & crop_ok
    hand_ok = hand_ok & view_ok[..., 0]
    view_ok = view_ok & hand_ok[..., None]

    # each crop pixel's ray, to the world, into the source camera, distorted
    gy, gx = torch.meshgrid(torch.arange(ch, device=dev, dtype=torch.float32),
                            torch.arange(cw, device=dev, dtype=torch.float32), indexing="ij")
    qx = (gx.reshape(-1) - half[0]) / focal[..., 0, None]
    qy = (gy.reshape(-1) - half[1]) / focal[..., 1, None]
    ray = torch.stack([qx, qy, torch.ones_like(qx)], -1)
    ray = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)  # (F, 2, 2, P, 3)
    world = apply(rigid_inverse(crop_w2e), ray)
    src_c2w = c2w[fi, view]
    src_eye = ((world - src_c2w[..., None, :3, 3])[..., None, :] @ src_c2w[..., None, :3, :3])[..., 0, :]
    d = fisheye62(src_eye, rec["coeffs"][view][..., None, :])
    sx = d[..., 0] * rec["fx"][view][..., None] + rec["cx"][view][..., None]
    sy = d[..., 1] * rec["fy"][view][..., None] + rec["cy"][view][..., None]
    behind = src_eye[..., 2] < 0
    sx, sy = torch.where(behind, -1.0, sx), torch.where(behind, -1.0, sy)
    flat_view = (fi * n_v + view).reshape(-1)
    crops = sample(rec["frames"].reshape(n_f * n_v, h, w), flat_view, sx.reshape(flat_view.shape[0], -1),
                   sy.reshape(flat_view.shape[0], -1), bf16_rows)
    crops = crops.reshape(n_f, 2, 2, ch, cw) / 255.0
    crops = torch.where(view_ok[..., None, None], crops, 0.0)

    intr = torch.zeros(focal.shape[:-1] + (3, 3), device=dev)
    intr[..., 0, 0], intr[..., 1, 1] = focal[..., 0], focal[..., 1]
    intr[..., 0, 2], intr[..., 1, 2], intr[..., 2, 2] = half[0], half[1], 1.0
    ext = crop_w2e.clone()
    ext[..., :3, 3] = ext[..., :3, 3] * 1e-3
    return dict(images=crops, intrinsics=intr, extrinsics=ext, view_ok=view_ok, hand_ok=hand_ok)


@torch.no_grad()
def track(cfg: dict, params, rec: dict, trunk_dtype=torch.bfloat16, bf16_rows: bool = True, fp8: bool = False):
    """Track one recording -> dict of (F, 2, ...) results: ``angles``,
    ``wrist_mm`` (right hands mirrored), ``valid``, ``landmarks`` (mm)."""
    net = Net(cfg, params, trunk_dtype, fp8)
    x = crop_inputs(rec, tuple(cfg["input_size"]), bf16_rows)
    n_f = x["images"].shape[0]
    dev = x["images"].device
    feats = net.trunk(x["images"].flatten(0, 1), x["intrinsics"].flatten(0, 1), x["extrinsics"].flatten(0, 1),
                      x["view_ok"].flatten(0, 1)).unflatten(0, (n_f, 2))
    hand = rec["hand"]
    skel = net.skeleton(hand["axes"].expand(2, -1, -1), hand["rest"].expand(2, -1, -1) * 1e-3)
    fh, fw = feats.shape[-2:]
    mem = torch.zeros(2, cfg["n_temporal_memory_channels"], fh, fw, device=dev)
    prev = torch.zeros(2, 4, 4, device=dev)
    hist = torch.zeros(2, dtype=torch.bool, device=dev)
    right = torch.tensor([False, True], device=dev)
    outs = {k: [] for k in ("angles", "wrist_mm", "valid")}
    for t in range(n_f):
        ok = x["hand_ok"][t]
        ext0 = x["extrinsics"][t][:, 0]
        new_mem, fused = net.memory(mem, prev, feats[t], ext0, hist & ok)
        out = decode(net, fused, skel, ext0, known=True)
        mem = torch.where(ok[:, None, None, None], new_mem, mem)
        prev = torch.where(ok[:, None, None], ext0, prev)
        hist = ok
        wrist = kin.mirror_x_column(out.wrist_world, right)
        wrist[:, :3, 3] = wrist[:, :3, 3] * 1e3
        outs["angles"].append(out.angles)
        outs["wrist_mm"].append(wrist)
        outs["valid"].append(ok)
    res = {k: torch.stack(v) for k, v in outs.items()}
    res["landmarks"] = kin.landmarks(hand, res["angles"], kin.mirror_x_column(res["wrist_mm"], right))
    return res
