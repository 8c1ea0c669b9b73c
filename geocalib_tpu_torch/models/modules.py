"""Network building blocks, NCHW inside.

Port of geocalib_tpu/models/modules.py. Semantics copied exactly:
- GELU is the erf form (torch's default, unlike jax.nn.gelu's default);
- the ResidualConvUnit skip adds relu(x), not x;
- BatchNorm runs in eval mode with eps 1e-5;
- convolutions use symmetric explicit padding.
"""

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor


def gelu(x: Tensor) -> Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def resize_bilinear(x: Tensor, size: Tuple[int, int]) -> Tensor:
    """Bilinear NCHW resize with half-pixel centers (= jax.image.resize when upsampling)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


class ConvModule(nn.Module):
    """conv → ReLU (the GeoCalib net never enables the optional norm)."""

    def __init__(self, cin: int, cout: int, kernel: int, padding: int = 0, bias: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, padding=padding, bias=bias)

    def forward(self, x: Tensor) -> Tensor:
        return F.relu(self.conv(x))


class ResidualConvUnit(nn.Module):
    """relu → conv3 → relu → conv3, plus relu(x)."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(ch, ch, 3, padding=1)
        self.conv2 = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x: Tensor) -> Tensor:
        r = F.relu(x)
        return self.conv2(F.relu(self.conv1(r))) + r


class FeatureFusionBlock(nn.Module):
    """x + RCU(skip), then another RCU (no upsampling in the decoder heads)."""

    def __init__(self, ch: int):
        super().__init__()
        self.rcu1 = ResidualConvUnit(ch)
        self.rcu2 = ResidualConvUnit(ch)

    def forward(self, x: Tensor, skip: Tensor) -> Tensor:
        return self.rcu2(x + self.rcu1(skip))


class Mlp(nn.Module):
    """1×1 conv → 3×3 depthwise conv → GELU → 1×1 conv."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Conv2d(dim, hidden, 1)
        self.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = nn.Conv2d(hidden, dim, 1)

    def forward(self, x: Tensor) -> Tensor:
        return self.fc2(gelu(self.dwconv(self.fc1(x))))


class AttentionModule(nn.Module):
    """5×5 depthwise, three separable strip convs (7, 11, 21), 1×1 mix, gate."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv0 = nn.Conv2d(dim, dim, 5, padding=2, groups=dim)
        self.strips = nn.ModuleList()
        for k in (7, 11, 21):
            self.strips.append(nn.Conv2d(dim, dim, (1, k), padding=(0, k // 2), groups=dim))
            self.strips.append(nn.Conv2d(dim, dim, (k, 1), padding=(k // 2, 0), groups=dim))
        self.conv3 = nn.Conv2d(dim, dim, 1)

    def forward(self, x: Tensor) -> Tensor:
        attn = self.conv0(x)
        total = attn
        for i in range(0, len(self.strips), 2):
            total = total + self.strips[i + 1](self.strips[i](attn))
        return self.conv3(total) * x


class SpatialAttention(nn.Module):
    """1×1 → GELU → attention gate → 1×1, plus the input."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj1 = nn.Conv2d(dim, dim, 1)
        self.gate = AttentionModule(dim)
        self.proj2 = nn.Conv2d(dim, dim, 1)

    def forward(self, x: Tensor) -> Tensor:
        return self.proj2(self.gate(gelu(self.proj1(x)))) + x


class MSCANBlock(nn.Module):
    """BN → attention and BN → MLP residual branches with layer scale."""

    def __init__(self, dim: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(dim, eps=1e-5)
        self.attn = SpatialAttention(dim)
        self.norm2 = nn.BatchNorm2d(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.layer_scale_1 = nn.Parameter(torch.full((dim,), 1e-2))
        self.layer_scale_2 = nn.Parameter(torch.full((dim,), 1e-2))

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.layer_scale_1[:, None, None] * self.attn(self.norm1(x))
        return x + self.layer_scale_2[:, None, None] * self.mlp(self.norm2(x))


class StemConv(nn.Module):
    """Two stride-2 3×3 convs with BN, GELU between: 1/4 resolution."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout // 2, 3, stride=2, padding=1)
        self.bn1 = nn.BatchNorm2d(cout // 2, eps=1e-5)
        self.conv2 = nn.Conv2d(cout // 2, cout, 3, stride=2, padding=1)
        self.bn2 = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x: Tensor) -> Tensor:
        return self.bn2(self.conv2(gelu(self.bn1(self.conv1(x)))))


class OverlapPatchEmbed(nn.Module):
    """Stride-2 3×3 conv with BN."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, cout, 3, stride=2, padding=1)
        self.norm = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x: Tensor) -> Tensor:
        return self.norm(self.proj(x))


class ChannelLayerNorm(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW tensor."""

    def forward(self, x: Tensor) -> Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
