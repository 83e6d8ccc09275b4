"""Operations and bytes of the work, counted from the configuration's
shapes (never from which kernels ran), so that they count the same work
whatever implements it.

A FLOP count is 2 x the multiply-adds of the convolutions, linear layers
and feature-transform products a computation needs; element-wise work,
pooling, the wrist fit and the kinematics are left out, so a share of a
peak is a lower bound. A training step counts 3 x its forward work.
"""

from __future__ import annotations

from ..reference.network import feature_hw, fusion_channels, head_outputs, resnet_blocks

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
K1_FLOPS_PER_PIXEL = 15  # the f32 bilinear mix: the weights, four products of three terms, three sums


def conv_flops(cin, cout, k, h, w):
    return 2 * cin * cout * k * k * h * w


def backbone_flops(cfg: dict) -> int:
    """One crop through the trunk's CNN (3x3 stem, 2x2 max-pool, the stages
    of BasicBlocks, the 1x1 projection)."""
    blocks, f = resnet_blocks(cfg["network"])
    h, w = cfg["input_size"]
    total = conv_flops(1, f, 3, h, w)
    h, w = h // 2, w // 2
    cin = f
    for s, n in enumerate(blocks):
        cout = f * 2**s
        for i in range(n):
            stride = 1 if (s == 0 or i) else 2
            if stride == 2:
                h, w = h // 2, w // 2
            c0 = cin if i == 0 else cout
            total += conv_flops(c0, cout, 3, h, w) + conv_flops(cout, cout, 3, h, w)
            if stride != 1 or c0 != cout:
                total += conv_flops(c0, cout, 1, h, w)
        cin = cout
    return total + conv_flops(cin, cfg["n_image_feature_channels"], 1, h, w)


def ftl_flops(channels: int, ratio: float, h: int, w: int) -> int:
    return 2 * 3 * int(round(channels * ratio)) * h * w  # a 3x3 product a point, plus its translation


def fusion_flops(cfg: dict) -> int:
    """A sample's two views into the canonical space, the 1x1 fusion convs,
    to cam0, and the single-view path."""
    h, w = feature_hw(cfg)
    c = cfg["n_image_feature_channels"]
    nc = fusion_channels(cfg)
    total = sum(conv_flops(nc[i], nc[i + 1], 1, h, w) for i in range(cfg["n_multi_view_fusion_blocks"]))
    total += conv_flops(c, c, 1, h, w)
    return total + (cfg["num_views"] + 2) * ftl_flops(c, cfg["spatial_ftl_ratio"], h, w)


def memory_flops(cfg: dict) -> int:
    h, w = feature_hw(cfg)
    m = cfg["n_image_feature_channels"] + cfg["n_temporal_memory_channels"]
    return (cfg["n_temporal_blocks"] * conv_flops(m, m, 1, h, w)
            + ftl_flops(cfg["n_temporal_memory_channels"], cfg["temporal_ftl_ratio"], h, w))


def head_flops(cfg: dict, known: bool) -> int:
    h, w = feature_hw(cfg)
    c = cfg["n_image_feature_channels"] + (cfg["n_skeleton_feature_channels"] if known else 0)
    blocks = cfg["n_pose_regression_blocks"] * 2 * conv_flops(c, c, 3, h, w)
    return blocks + conv_flops(c, head_outputs(not known, cfg["n_wrist_rigid_pts"]), 1, h, w)


def skeleton_flops(cfg: dict) -> int:
    h, w = feature_hw(cfg)
    return 2 * 22 * 6 * cfg["n_skeleton_feature_channels"] * h * w


def sample_flops(cfg: dict, known: bool = True, unknown: bool = False) -> int:
    """One hand at one frame: its views' trunk, the fusion, the memory and
    the heads asked for."""
    total = cfg["num_views"] * backbone_flops(cfg) + fusion_flops(cfg) + memory_flops(cfg)
    return total + (head_flops(cfg, True) if known else 0) + (head_flops(cfg, False) if unknown else 0)


def eval_frame_flops(cfg: dict) -> int:
    """A tracked frame of the known-skeleton eval: both hands."""
    return 2 * sample_flops(cfg, known=True)


def train_step_flops(cfg: dict, windows: int, frames: int) -> int:
    """A step of both heads over ``windows`` x ``frames`` samples: 3 x the
    forward work, the trunk and memory once a sample (both heads read the
    same), each head once, the skeleton once a window."""
    forward = windows * frames * sample_flops(cfg, known=True, unknown=True) + windows * skeleton_flops(cfg)
    return 3 * forward


def k1_bytes(n: int, p: int, touched_source: int) -> int:
    """Least traffic of one crop sampler call of ``n`` crops of ``p``
    pixels: the x and y planes and the view index read, the f32 crops
    written, and the source bytes that the taps touch."""
    return n * p * 8 + n * 8 + n * p * 4 + touched_source


def k1_flops(n: int, p: int) -> int:
    return n * p * K1_FLOPS_PER_PIXEL
