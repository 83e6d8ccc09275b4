"""The reference's torch checkpoint -> the JAX-layout param tree, with
BatchNorm folded (port of ``absolutetrack_tpu/models/weights.py``).

The reference loads ``pretrained_weights.torch`` into the module tree of
its ``load_pretrained_model``. This maps that state dict's names onto the
tree that ``models/params.py::load_jax_params`` takes (and the JAX
package's ``init_umetrack_params`` builds):

  _feature_extractor._image_backbone.0._layers.0.{0,1}     stem conv+bn
  _feature_extractor._image_backbone.0._layers.{1..4}.b.*  stages/blocks
  _feature_extractor._image_backbone.1                     1x1 proj conv
  _feature_extractor._multi_view_fusion.{0,1,3,4,6}        fusion convs+bns
  _temporal._temporal_module.{0,2,4}                       temporal convs
  _skeleton_enc._layers.{0,2}                              linear + bn2d
  _regressor_{k,u}._pose_regression_layers.{0,1,2}         blocks + out conv

Folding (inference-mode BN is affine): with s = gamma / sqrt(var + eps),
w' = w * s[out], b' = (b - mean) * s + beta. Conv weights go OIHW -> HWIO,
linear weights (out, in) -> (in, out). The skeleton encoder's BN acts on
the (B, 4, h, w) view of the linear output, so its fold scales groups of
h*w output columns per channel. Leaves are float32 numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .config import ModelConfig

_BN_EPS = 1e-5  # torch BatchNorm2d default


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()


def _conv(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    w = _np(sd[prefix + ".weight"])  # (O, I, kh, kw)
    b = _np(sd[prefix + ".bias"]) if prefix + ".bias" in sd else np.zeros(w.shape[0], np.float32)
    return {"w": w.transpose(2, 3, 1, 0).astype(np.float32), "b": b.astype(np.float32)}


def _bn_scale_shift(sd: Mapping, prefix: str):
    gamma = _np(sd[prefix + ".weight"])
    beta = _np(sd[prefix + ".bias"])
    mean = _np(sd[prefix + ".running_mean"])
    var = _np(sd[prefix + ".running_var"])
    s = gamma / np.sqrt(var + _BN_EPS)
    return s.astype(np.float32), (beta - mean * s).astype(np.float32)


def _conv_bn(sd: Mapping, conv_prefix: str, bn_prefix: str) -> Dict[str, np.ndarray]:
    p = _conv(sd, conv_prefix)
    s, shift = _bn_scale_shift(sd, bn_prefix)
    return {"w": p["w"] * s, "b": p["b"] * s + shift}


def _basic_block(sd: Mapping, prefix: str) -> Dict:
    out = {
        "conv1": _conv_bn(sd, prefix + ".conv1", prefix + ".bn1"),
        "conv2": _conv_bn(sd, prefix + ".conv2", prefix + ".bn2"),
    }
    if prefix + ".downsample.0.weight" in sd:
        out["downsample"] = _conv_bn(sd, prefix + ".downsample.0", prefix + ".downsample.1")
    return out


def _backbone(sd: Mapping, cfg: ModelConfig) -> Dict:
    blocks, _ = cfg.resnet_blocks
    root = "_feature_extractor._image_backbone"
    params: Dict = {"stem": _conv_bn(sd, f"{root}.0._layers.0.0", f"{root}.0._layers.0.1")}
    for si, n in enumerate(blocks):
        params[f"stage{si}"] = [_basic_block(sd, f"{root}.0._layers.{si + 1}.{bi}") for bi in range(n)]
    params["proj"] = _conv(sd, f"{root}.1")
    return params


def _fusion(sd: Mapping, cfg: ModelConfig) -> Dict:
    root = "_feature_extractor._multi_view_fusion"
    blocks = []
    idx = 0
    for _ in range(cfg.n_multi_view_fusion_blocks):
        blocks.append(_conv_bn(sd, f"{root}.{idx}", f"{root}.{idx + 1}"))
        idx += 3  # conv, bn, relu
    return {"blocks": blocks, "final": _conv(sd, f"{root}.{idx}")}


def _temporal(sd: Mapping, cfg: ModelConfig) -> Dict:
    root = "_temporal._temporal_module"
    return {"blocks": [_conv(sd, f"{root}.{2 * i}") for i in range(cfg.n_temporal_blocks)]}


def _skeleton(sd: Mapping, cfg: ModelConfig) -> Dict:
    root = "_skeleton_enc._layers"
    w = _np(sd[root + ".0.weight"]).T.astype(np.float32)  # (in, out)
    b = _np(sd[root + ".0.bias"]).astype(np.float32)
    s, shift = _bn_scale_shift(sd, root + ".2")
    h, wdt = cfg.feature_size
    per_ch = h * wdt  # output columns per BN channel (NCHW view c*h*w + hw)
    s_cols = np.repeat(s, per_ch)
    shift_cols = np.repeat(shift, per_ch)
    return {"fc": {"w": w * s_cols, "b": b * s_cols + shift_cols}}


def _regressor(sd: Mapping, which: str, cfg: ModelConfig) -> Dict:
    root = f"_regressor_{which}._pose_regression_layers"
    return {
        "blocks": [_basic_block(sd, f"{root}.{i}") for i in range(cfg.n_pose_regression_blocks)],
        "out": _conv(sd, f"{root}.{cfg.n_pose_regression_blocks}"),
    }


def convert_torch_state_dict(sd: Mapping, cfg: ModelConfig = ModelConfig()) -> Dict:
    """The reference's state dict -> the JAX-layout param tree (numpy leaves)."""
    return {
        "backbone": _backbone(sd, cfg),
        "fusion": _fusion(sd, cfg),
        "temporal": _temporal(sd, cfg),
        "skeleton_encoder": _skeleton(sd, cfg),
        "regressor_k": _regressor(sd, "k", cfg),
        "regressor_u": _regressor(sd, "u", cfg),
    }


def load_torch_checkpoint(path: str, cfg: ModelConfig = ModelConfig()) -> Dict:
    """A state dict file (zip or legacy pickle, tensors only) -> the param tree."""
    with open(path, "rb") as f:
        sd = torch.load(f, map_location="cpu", weights_only=True)
    return convert_torch_state_dict(sd, cfg)
