"""Alternative backbones: VGG- and ResNet-style pyramids, NCHW inside.

Port of geocalib_tpu/models/encoders.py. The input is RGB in [0, 1], NCHW,
flipped to BGR and scaled by 255 as the JAX modules do; the outputs are the
4-scale feature pyramid, NCHW. Flax weights map onto them with
models/weights.py ``zoo_params_from_jax``.
"""

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from geocalib_tpu_torch.models.modules import BatchNorm

Tensor = torch.Tensor


class VGG(nn.Module):
    """VGG-style: stacked 3×3 conv+ReLU stages with maxpool downsampling.

    ``convs[j]`` is the Flax module's ``Conv2d_j``: two at stage 0 before the
    stage's ``convs_per_stage``, then ``convs_per_stage`` a stage.
    """

    def __init__(self, dims: Sequence[int] = (64, 128, 320, 512), convs_per_stage: int = 2):
        super().__init__()
        self.dims, self.convs_per_stage = tuple(dims), convs_per_stage
        shapes = [(3, dims[0] // 2), (dims[0] // 2, dims[0])]
        cin = dims[0]
        for dim in dims:
            for k in range(convs_per_stage):
                shapes.append((cin if k == 0 else dim, dim))
            cin = dim if convs_per_stage else cin
        self.convs = nn.ModuleList(nn.Conv2d(a, b, 3, padding=1) for a, b in shapes)

    def forward(self, image: Tensor) -> Tuple[Tensor, ...]:
        x = image.flip(1) * 255.0
        convs = iter(self.convs)
        outs = []
        for i in range(len(self.dims)):
            if i > 0:
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(F.max_pool2d(next(convs)(x), 2, 2))
                x = F.max_pool2d(F.relu(next(convs)(x)), 2, 2)
            for _ in range(self.convs_per_stage):
                x = F.relu(next(convs)(x))
            outs.append(x)
        return tuple(outs)


class ResNetBlock(nn.Module):
    """Basic block: two 3×3 conv + BN, a 1×1 conv + BN on the skip where the shape changes."""

    def __init__(self, cin: int, features: int, strides: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 3, stride=strides, padding=1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(features)
        self.downsample = None
        if strides != 1 or cin != features:
            self.downsample = nn.Sequential(nn.Conv2d(cin, features, 1, stride=strides, bias=False),
                                            BatchNorm(features))

    def forward(self, x: Tensor) -> Tensor:
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet-style: stem + 4 stages of basic blocks at strides 4/8/16/32."""

    def __init__(self, dims: Sequence[int] = (64, 128, 320, 512), blocks_per_stage: int = 2):
        super().__init__()
        self.dims, self.blocks_per_stage = tuple(dims), blocks_per_stage
        self.stem = nn.Conv2d(3, dims[0], 7, stride=2, padding=3, bias=False)
        self.stem_bn = BatchNorm(dims[0])
        blocks, cin = [], dims[0]
        for i, dim in enumerate(dims):
            for j in range(blocks_per_stage):
                blocks.append(ResNetBlock(cin, dim, 2 if (i > 0 and j == 0) else 1))
                cin = dim
        self.blocks = nn.ModuleList(blocks)

    def forward(self, image: Tensor) -> Tuple[Tensor, ...]:
        x = F.relu(self.stem_bn(self.stem(image.flip(1) * 255.0)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        outs = []
        blocks = iter(self.blocks)
        for _ in self.dims:
            for _ in range(self.blocks_per_stage):
                x = next(blocks)(x)
            outs.append(x)
        return tuple(outs)
