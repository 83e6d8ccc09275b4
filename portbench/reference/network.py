"""UmeTrack's network in plain PyTorch, as the yardstick computes it.

Written from the model's description (UmeTrack, SIGGRAPH Asia 2022, and
the configuration's sizes), with no code of the program under test:
a per-view ResNet trunk (3x3 stem, max-pool, stages of BasicBlocks with
folded BatchNorm, a 1x1 projection), feature-transform-layer (FTL)
fusion of two views in the canonical camera space, a ConvRNN memory
re-anchored by the camera motion, a skeleton encoder and two regression
heads (known skeleton, and unknown skeleton with a scale) whose wrist is
the rigid fit of a 7-point template. Parameters are a dict of float32
tensors under the names of ``param_shapes``.

``trunk_dtype`` is the type the convolutions run in (float32, or bfloat16
for the serving preset: geometry, memory, pooling and decode stay
float32); ``fp8`` rounds every conv's input and weights to float8 e4m3
with one scale a tensor, the control of a bfloat16 configuration.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
E4M3_MAX = 448.0


def resnet_blocks(network: str):
    """"resnet_layers_2352-f32" -> ([2, 3, 5, 2], 32)."""
    arch, planes = network.split("-f")
    return [int(c) for c in arch.removeprefix("resnet_layers_")], int(planes)


def feature_hw(cfg: dict):
    h, w = cfg["input_size"]
    return h // 16, w // 16


def fusion_channels(cfg: dict):
    c = cfg["n_image_feature_channels"]
    nc = np.linspace(c * cfg["num_views"], c, cfg["n_multi_view_fusion_blocks"] + 1)
    return [int(x) for x in nc]


def head_outputs(predict_scale: bool, n_pts: int) -> int:
    return 20 + 3 * n_pts + (1 if predict_scale else 0) + 21


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every parameter of the model by name, in a fixed order."""
    shapes = {}

    def conv(name, cin, cout, k):
        shapes[f"{name}.weight"] = (cout, cin, k, k)
        shapes[f"{name}.bias"] = (cout,)

    def block(name, cin, cout, stride):
        conv(f"{name}.conv1", cin, cout, 3)
        conv(f"{name}.conv2", cout, cout, 3)
        if stride != 1 or cin != cout:
            conv(f"{name}.downsample", cin, cout, 1)

    blocks, f = resnet_blocks(cfg["network"])
    conv("backbone.stem", 1, f, 3)
    cin = f
    for s, n in enumerate(blocks):
        cout = f * 2**s
        for i in range(n):
            block(f"backbone.stages.{s}.{i}", cin if i == 0 else cout, cout, 1 if (s == 0 or i) else 2)
        cin = cout
    c = cfg["n_image_feature_channels"]
    conv("backbone.proj", cin, c, 1)
    nc = fusion_channels(cfg)
    for i in range(cfg["n_multi_view_fusion_blocks"]):
        conv(f"fusion.blocks.{i}", nc[i], nc[i + 1], 1)
    conv("fusion.final", c, c, 1)
    m = c + cfg["n_temporal_memory_channels"]
    for i in range(cfg["n_temporal_blocks"]):
        conv(f"temporal.blocks.{i}", m, m, 1)
    fh, fw = feature_hw(cfg)
    shapes["skeleton_encoder.fc.weight"] = (cfg["n_skeleton_feature_channels"] * fh * fw, 22 * 6)
    shapes["skeleton_encoder.fc.bias"] = (cfg["n_skeleton_feature_channels"] * fh * fw,)
    for head, cin, scale in (("regressor_k", c + cfg["n_skeleton_feature_channels"], False), ("regressor_u", c, True)):
        for i in range(cfg["n_pose_regression_blocks"]):
            block(f"{head}.blocks.{i}", cin, cin, 1)
        conv(f"{head}.out", cin, head_outputs(scale, cfg["n_wrist_rigid_pts"]), 1)
    return shapes


def make_params(cfg: dict, seed: int, device, bias_std: float = 0.02, head_scale: float = 0.02,
                memory_scale: float = 0.1) -> Params:
    """Random float32 weights from ``seed``, drawn on ``device`` in one call:
    He-normal weights (std sqrt(2 / (k*k*cout)) for a conv, sqrt(2 / cout)
    for a linear layer), normal biases of ``bias_std``; the heads' output
    convs scaled by ``head_scale`` and the ConvRNN's weights on the carried
    memory by ``memory_scale``, so that the outputs have a trained model's
    scale (at random init the heads read about +-40 and the memory loop's
    gain passes 1) while the image features pass at full strength."""
    shapes = param_shapes(cfg)
    m = cfg["n_temporal_memory_channels"]
    g = torch.Generator(device=device).manual_seed(seed % 2**63)
    z = torch.randn(sum(math.prod(s) for s in shapes.values()), generator=g, device=device)
    params, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        x = z[at:at + n].view(shape)
        at += n
        if name.endswith(".bias"):
            x = x * bias_std
        elif len(shape) == 4:
            x = x * math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
        else:
            x = x * math.sqrt(2.0 / shape[0])
        if ".out." in name:
            x = x * head_scale
        elif name == "temporal.blocks.0.weight":
            x = torch.cat([x[:, :m] * memory_scale, x[:, m:]], 1)
        params[name] = x
    return params


# -- geometry -------------------------------------------------------------


def rigid_inverse(m: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 4, 4) transforms with an orthogonal linear part."""
    rt = m[..., :3, :3].transpose(-1, -2)
    t = -(rt @ m[..., :3, 3:4])
    bottom = torch.zeros(m.shape[:-2] + (1, 4), dtype=m.dtype, device=m.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([rt, t], -1), bottom], -2)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (w, x, y, z) -> rotation matrices."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def rigid_fit(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The rotation and translation (..., 4, 4) that take points ``a`` to
    ``b`` ((..., N, 3) each) in least squares: Horn's quaternion, the top
    eigenvector of the 4 x 4 symmetric matrix of the cross-covariance."""
    ma, mb = a.mean(-2), b.mean(-2)
    s = (a - ma[..., None, :]).transpose(-1, -2) @ (b - mb[..., None, :])  # s[i, j] = sum a_i b_j
    sxx, sxy, sxz, syx, syy, syz, szx, szy, szz = s.flatten(-2).unbind(-1)
    n = torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1),
    ], -2)
    _, vecs = torch.linalg.eigh(n)
    r = quat_to_rot(vecs[..., -1])
    t = mb - (r @ ma[..., None])[..., 0]
    bottom = torch.zeros(r.shape[:-2] + (1, 4), dtype=r.dtype, device=r.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([r, t[..., None]], -1), bottom], -2)


def wrist_template(n_pts: int = 7, norm: float = 0.1) -> np.ndarray:
    """The 7 canonical wrist points, each nonzero one scaled to ``norm``."""
    pts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, -1, 0], [-1, 0, -1], [0, -1, -1]], np.float64)
    lengths = np.linalg.norm(pts, axis=-1, keepdims=True)
    pts = np.where(lengths > 0, pts / np.maximum(lengths, 1e-12) * norm, pts)
    return pts[:n_pts].astype(np.float32)


# -- layers ---------------------------------------------------------------


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale for the tensor, back in its type."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / E4M3_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


class Net:
    """The functional model over a parameter dict."""

    def __init__(self, cfg: dict, params: Params, trunk_dtype=torch.float32, fp8: bool = False):
        self.cfg = cfg
        self.p = params
        self.dt = trunk_dtype
        self.fp8 = fp8
        self.template = torch.as_tensor(wrist_template(cfg["n_wrist_rigid_pts"]),
                                        device=next(iter(params.values())).device)

    def conv(self, x, name, stride=1):
        w = self.p[f"{name}.weight"].to(self.dt)
        b = self.p[f"{name}.bias"].to(self.dt)
        if self.fp8:
            x, w = fp8_round(x), fp8_round(w)
        k = w.shape[-1]
        return F.conv2d(x, w, None, stride, k // 2) + b[:, None, None]

    def block(self, x, name, stride):
        out = self.conv(F.relu(self.conv(x, f"{name}.conv1", stride)), f"{name}.conv2")
        res = self.conv(x, f"{name}.downsample", stride) if f"{name}.downsample.weight" in self.p else x
        return F.relu(out + res)

    def backbone(self, images):
        """(N, H, W) crops -> (N, C, H/16, W/16) in the trunk's type."""
        x = F.max_pool2d(F.relu(self.conv(images[:, None].to(self.dt), "backbone.stem")), 2, 2)
        blocks, _ = resnet_blocks(self.cfg["network"])
        for s, n in enumerate(blocks):
            for i in range(n):
                x = self.block(x, f"backbone.stages.{s}.{i}", 1 if (s == 0 or i) else 2)
        return self.conv(x, "backbone.proj")

    @staticmethod
    def ftl(xf, feats, ratio):
        """Rotate and translate the feature points of (N, C, h, w) maps: the
        first round(C r) channels are 3 groups, the x, y and z of points."""
        n, c, h, w = feats.shape
        k = int(round(c * ratio))
        if k == 0:
            return feats
        pts = feats[:, :k].reshape(n, 3, (k // 3) * h * w)
        x = xf[:, :3, :3].to(feats.dtype) @ pts + xf[:, :3, 3:4].to(feats.dtype)
        x = x.reshape(n, k, h, w)
        return x if k == c else torch.cat([x, feats[:, k:]], 1)

    def trunk(self, images, intrinsics, extrinsics, view_mask):
        """(B, 2, H, W) crops of two views -> (B, C, h, w) fused cam0 features."""
        if self.cfg["use_unscaled_as_canonical"]:
            raise ValueError("the reference fuses in cam0's scaled space only")
        b, v = images.shape[:2]
        feats = self.backbone(images.flatten(0, 1))
        c, h, w = feats.shape[1:]
        feats = feats.reshape(b, v, c, h, w)
        s = torch.eye(4, device=images.device).repeat(b, v, 1, 1)
        s[..., 2, 2] = intrinsics[..., 0, 0] / self.cfg["canonical_focal_length"]
        s0_inv = s[:, :1].clone()
        s0_inv[..., 2, 2] = 1.0 / s[:, :1, 2, 2]
        to_canonical = s0_inv @ (extrinsics[:, :1] @ (rigid_inverse(extrinsics) @ s))
        ratio = self.cfg["spatial_ftl_ratio"]
        canon = self.ftl(to_canonical.flatten(0, 1), feats.flatten(0, 1), ratio).reshape(b, v, c, h, w)
        canon = torch.where(view_mask[:, :, None, None, None], canon, 0.0)
        x = canon.reshape(b, v * c, h, w)
        for i in range(self.cfg["n_multi_view_fusion_blocks"]):
            x = F.relu(self.conv(x, f"fusion.blocks.{i}"))
        multi = self.ftl(s[:, 0], self.conv(x, "fusion.final"), ratio)
        single = self.ftl(s[:, 0], feats[:, 0], ratio)
        both = view_mask[:, 0] & view_mask[:, 1]
        return torch.where(both[:, None, None, None], multi, single)

    def skeleton(self, axes, rest):
        """(B, 22, 3) axes and rest positions (metres) -> (B, C_s, h, w) float32."""
        h, w = feature_hw(self.cfg)
        x = torch.cat([axes, rest], -1).flatten(1)
        x = F.relu(x @ self.p["skeleton_encoder.fc.weight"].T + self.p["skeleton_encoder.fc.bias"])
        return x.reshape(x.shape[0], self.cfg["n_skeleton_feature_channels"], h, w)

    def memory(self, mem, prev_ext, img_feats, cur_ext, use):
        """One ConvRNN step. ``mem`` (B, M, h, w) float32 and ``prev_ext``
        (B, 4, 4) are the carried state, ``use`` (B,) says where it holds.
        -> (new memory float32, fused features in the trunk's type)."""
        m = self.cfg["n_temporal_memory_channels"]
        u4 = use[:, None, None, None]
        mem = torch.where(u4, mem, 0.0).to(img_feats.dtype)
        eye = torch.eye(4, device=cur_ext.device).expand_as(prev_ext)
        rel = cur_ext @ rigid_inverse(torch.where(use[:, None, None], prev_ext, eye))
        mem = torch.where(u4, self.ftl(rel, mem, self.cfg["temporal_ftl_ratio"]), 0.0)
        x = torch.cat([mem, img_feats], 1)
        n = self.cfg["n_temporal_blocks"]
        for i in range(n):
            x = self.conv(x, f"temporal.blocks.{i}")
            if i < n - 1:
                x = F.relu(x)
        return x[:, :m].float(), x[:, m:]

    def head(self, x, known: bool):
        """Fused features -> (joint angles (B, 22), wrist in cam0 (B, 4, 4),
        scale (B,) or None, sigmas (B, 21)), all float32."""
        name = "regressor_k" if known else "regressor_u"
        for i in range(self.cfg["n_pose_regression_blocks"]):
            x = self.block(x, f"{name}.blocks.{i}", 1)
        pose = self.conv(x, f"{name}.out").float().mean((2, 3))
        b, k = pose.shape[0], 3 * self.cfg["n_wrist_rigid_pts"]
        angles = torch.cat([pose[:, :20], pose.new_zeros(b, 2)], -1)
        wrist = rigid_fit(self.template.expand(b, -1, -1), pose[:, 20:20 + k].reshape(b, -1, 3))
        scale = None if known else torch.exp(pose[:, 20 + k])
        sigmas = F.softplus(pose[:, -21:]).clamp(min=1e-5)
        return angles, wrist, scale, sigmas


class Out(NamedTuple):
    angles: torch.Tensor
    wrist_world: torch.Tensor  # left-hand space: the right hand's mirror is not applied
    scale: Optional[torch.Tensor]
    sigmas: torch.Tensor


def decode(net: Net, feats, skel, extrinsics0, known: bool) -> Out:
    """The head on fused features (with the skeleton's, for the known
    branch) and the wrist taken from cam0 to the world."""
    x = torch.cat([feats, skel.to(feats.dtype)], 1) if known else feats
    angles, wrist, scale, sigmas = net.head(x, known)
    return Out(angles, rigid_inverse(extrinsics0) @ wrist, scale, sigmas)
