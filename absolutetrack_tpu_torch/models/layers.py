"""Primitive layers: convs with folded BatchNorm, ResNet BasicBlock
(port of ``absolutetrack_tpu/models/layers.py``).

Modules run NCHW with OIHW weights; BN is folded into conv weight/bias
(at init BN(1, 0) with unit running stats folds to identity). Weights
come from the He-normal init of the reference ResNet, drawn from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F


def set_conv_precision(name: str) -> None:
    """Set conv/matmul precision: "highest" (full f32, the parity mode) or
    "high" (TF32 on the card, cuDNN's own default).

    The JAX package runs parity at ``Precision.HIGHEST`` because
    reduced-precision convs drift the wrist by millimetres; cuDNN
    convolutions default to TF32, so "highest" turns TF32 off for both
    cuDNN convs and CUDA matmuls. The flags are process-wide.
    """
    if name not in ("high", "highest"):
        raise ValueError(f"unknown precision {name!r}")
    tf32 = name == "high"
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


def he_normal_(weight: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """normal(0, sqrt(2/n)), n = kh*kw*cout (reference backbone_resnet.py:117-123)."""
    cout, _, kh, kw = weight.shape
    std = math.sqrt(2.0 / (kh * kw * cout))
    with torch.no_grad():
        weight.copy_(std * torch.randn(weight.shape, generator=generator))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose bias is added by an op of its own after the
    convolution, as the JAX package's ``conv(x, w) + b`` adds it
    (``absolutetrack_tpu/models/layers.py:63-74``): in bf16 the
    convolution's output rounds before the add. (On the CPU ``nn.Conv2d``
    adds it inside the convolution, before the one rounding.)"""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight, None) + self.bias[:, None, None]


def conv(cin: int, cout: int, k: int, stride: int = 1, generator=None) -> Conv2d:
    """k x k conv with k//2 padding (the JAX package's ``SAME1``), He init, zero bias."""
    c = nn.utils.skip_init(Conv2d, cin, cout, k, stride=stride, padding=k // 2)
    he_normal_(c.weight, generator)
    nn.init.zeros_(c.bias)
    return c


def linear(cin: int, cout: int, generator=None) -> nn.Linear:
    """Linear layer, normal(0, sqrt(2/cout)) weights, zero bias."""
    lin = nn.utils.skip_init(nn.Linear, cin, cout)
    with torch.no_grad():
        lin.weight.copy_(math.sqrt(2.0 / cout) * torch.randn((cout, cin), generator=generator))
    nn.init.zeros_(lin.bias)
    return lin


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


class BasicBlock(nn.Module):
    """ResNet BasicBlock (reference backbone_resnet.py:14-72, BN folded)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, generator=None):
        super().__init__()
        self.stride = stride
        self.conv1 = conv(cin, cout, 3, stride, generator)
        self.conv2 = conv(cout, cout, 3, 1, generator)
        self.downsample = (
            conv(cin, cout, 1, stride, generator) if stride != 1 or cin != cout else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv1(x))
        out = self.conv2(out)
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)
