"""DeepCalib baseline: dense CNN + per-parameter classification heads.

Port of geocalib_tpu/models/deepcalib.py (a conf-driven DenseNet trunk and 4
heads of ``num_bins`` bins over roll/rho/vfov/k1_hat, NLL loss, argmax or
softargmax decoding), NCHW inside. Flax weights map onto it with
models/weights.py ``deepcalib_params_from_jax``.

Dtypes as in the JAX package's compiled program: the callers pass bf16
images; the ImageNet mean is subtracted in the input's dtype (rounded to
bf16), and the division by the std is the float32 product by its reciprocal
that XLA makes of it, not rounded to bf16, since every layer after it runs
in float32, the dtype of its parameters (Flax promotes a bf16 input against
float32 parameters, and XLA drops the bf16 round trip); the logits are
float32. On the card
the float32 convolutions and products run with TF32 off, to agree with the
CPU: ``forward`` runs under ``exact_float32``, and a training step takes its
backward under it too. The stem's max pool pads with -inf, the average
pools floor odd sizes, and the heads pool with a mean over H and W.
"""

import contextlib
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from geocalib_tpu_torch.models.modules import BatchNorm
from geocalib_tpu_torch.optim.ransac import argmax_first

Tensor = torch.Tensor

# vFoV's bounds are float32, as jnp.deg2rad makes them; the others Python floats
BOUNDS = {
    "roll": (-np.pi / 4, np.pi / 4),
    "rho": (-1.0, 1.0),
    "vfov": (np.float32(20.0) * np.float32(np.pi / 180), np.float32(105.0) * np.float32(np.pi / 180)),
    "k1_hat": (-0.7, 0.7),
}
HEADS = ("roll", "rho", "vfov", "k1_hat")
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def exact_float32():
    """cuDNN convolutions and cuBLAS products in full float32 (TF32 off) inside the
    block, the flags restored after it."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """a·b + c of float32 arrays rounded once to float32, as a fused multiply-add: the
    product is exact in float64, the sum's rounding error is recovered exactly (two-sum)
    and decides between the float32 neighbours of the float64 sum."""
    p, c = a.astype(np.float64) * b.astype(np.float64), c.astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.astype(np.float32)  # first: on an exact tie (err = 0) it is the even neighbour
    cands = np.stack([r, np.nextafter(r, np.float32(-np.inf)), np.nextafter(r, np.float32(np.inf))])
    return cands[np.argmin(np.abs((cands.astype(np.float64) - s) - err), axis=0),
                 np.arange(r.size)].astype(np.float32)


def bin_centers(lo: float, hi: float, num_bins: int, device="cpu") -> Tensor:
    """jnp.linspace(lo, hi + (hi - lo) / (num_bins - 1), num_bins) in float32: the
    upper bound one bin past hi, on purpose (the reference's centers and edges).

    The values are those of XLA's compiled linspace: with d = num_bins - 1 and
    r = 1/d in float32, start·(1 - i·r) fused with i·(stop·r) into one multiply-add
    for i < d, then stop itself."""
    start, stop = np.float32(lo), np.float32(hi + (hi - lo) / (num_bins - 1))
    r = np.float32(1.0) / np.float32(num_bins - 1)
    i = np.arange(num_bins - 1, dtype=np.float32)
    head = _fma32(i, np.full_like(i, stop * r), start * (np.float32(1.0) - i * r))
    return torch.from_numpy(np.append(head, stop).astype(np.float32)).to(device)


def bins_to_val(centers: Tensor, logits: Tensor, softargmax: bool = False) -> Tensor:
    """Decode logits (B, num_bins) to values."""
    if not softargmax:
        return centers[argmax_first(logits)]
    p = torch.softmax(logits, dim=-1)
    return torch.sum(centers[None, : logits.shape[-1]] * p, dim=-1)


class DenseLayer(nn.Module):
    def __init__(self, cin: int, growth_rate: int = 32, bn_size: int = 4):
        super().__init__()
        self.bn1 = BatchNorm(cin)
        self.conv1 = nn.Conv2d(cin, bn_size * growth_rate, 1, bias=False)
        self.bn2 = BatchNorm(bn_size * growth_rate)
        self.conv2 = nn.Conv2d(bn_size * growth_rate, growth_rate, 3, padding=1, bias=False)

    def forward(self, x: Tensor) -> Tensor:
        y = self.conv1(F.relu(self.bn1(x)))
        y = self.conv2(F.relu(self.bn2(y)))
        return torch.cat([x, y], dim=1)


class DenseBlock(nn.Module):
    def __init__(self, cin: int, num_layers: int, growth_rate: int = 32):
        super().__init__()
        self.layers = nn.Sequential(*(DenseLayer(cin + i * growth_rate, growth_rate)
                                      for i in range(num_layers)))
        self.out_channels = cin + num_layers * growth_rate

    def forward(self, x: Tensor) -> Tensor:
        return self.layers(x)


class Transition(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        self.bn = BatchNorm(cin)
        self.conv = nn.Conv2d(cin, features, 1, bias=False)

    def forward(self, x: Tensor) -> Tensor:
        return F.avg_pool2d(self.conv(F.relu(self.bn(x))), 2, 2)


class DenseNet(nn.Module):
    """DenseNet trunk; block_config (6,12,36,24) ~ densenet161 structure."""

    def __init__(self, growth_rate: int = 32, block_config: Sequence[int] = (6, 12, 36, 24),
                 init_features: int = 64):
        super().__init__()
        self.conv0 = nn.Conv2d(3, init_features, 7, stride=2, padding=3, bias=False)
        self.bn0 = BatchNorm(init_features)
        self.blocks, self.transitions = nn.ModuleList(), nn.ModuleList()
        features = init_features
        for i, layers in enumerate(block_config):
            self.blocks.append(DenseBlock(features, layers, growth_rate))
            features += layers * growth_rate
            if i != len(block_config) - 1:
                self.transitions.append(Transition(features, features // 2))
                features //= 2
        self.out_channels = features

    def forward(self, x: Tensor) -> Tensor:
        x = F.relu(self.bn0(self.conv0(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i < len(self.transitions):
                x = self.transitions[i](x)
        return x


class ClassificationHead(nn.Module):
    """transition → small dense block → pool → MLP → log-probabilities of the bins."""

    def __init__(self, cin: int, num_bins: int = 256, growth_rate: int = 32):
        super().__init__()
        self.transition = Transition(cin, cin // 2)
        self.block = DenseBlock(cin // 2, 3, growth_rate)
        self.bn = BatchNorm(self.block.out_channels)
        self.fc1 = nn.Linear(self.block.out_channels, 512)
        self.fc2 = nn.Linear(512, num_bins)

    def forward(self, x: Tensor) -> Tensor:
        x = F.relu(self.bn(self.block(self.transition(x))))
        x = F.relu(self.fc1(x.mean(dim=(2, 3))))
        return torch.log_softmax(self.fc2(x), dim=-1)


class DeepCalib(nn.Module):
    """4-head classification calibrator; returns per-head logits + values.

    Input image (B, H, W, 3) RGB in [0, 1], of any float dtype (see the module
    docstring); ``loss`` is the NLL over each head's ground-truth bin.
    """

    def __init__(self, num_bins: int = 256, softargmax: bool = False,
                 block_config: Sequence[int] = (6, 12, 36, 24), growth_rate: int = 32):
        super().__init__()
        self.num_bins, self.softargmax = num_bins, softargmax
        self.block_config, self.growth_rate = tuple(block_config), growth_rate
        self.trunk = DenseNet(growth_rate, block_config)
        self.heads = nn.ModuleList(ClassificationHead(self.trunk.out_channels, num_bins, growth_rate)
                                   for _ in HEADS)
        for head in HEADS:
            self.register_buffer(f"centers_{head}", bin_centers(*BOUNDS[head], num_bins),
                                 persistent=False)

    def forward(self, image: Tensor) -> Dict[str, Tensor]:
        mean = torch.tensor(IMAGENET_MEAN, dtype=image.dtype, device=image.device)
        std = torch.tensor(IMAGENET_STD, dtype=image.dtype, device=image.device)
        # XLA's compiled arithmetic: the subtraction in the image's dtype, then the
        # division as a float32 product by the reciprocal, unrounded, since the first
        # convolution takes float32
        x = ((image - mean).float() * (1.0 / std.float())).permute(0, 3, 1, 2)
        out: Dict[str, Tensor] = {}
        with exact_float32():
            trunk = self.trunk(x)
            for head, module in zip(HEADS, self.heads):
                logits = module(trunk)
                out[f"{head}_logits"] = logits
                out[head] = bins_to_val(getattr(self, f"centers_{head}"), logits, self.softargmax)
        return out

    @staticmethod
    def loss(out: Dict[str, Tensor], gt: Dict[str, Tensor], num_bins: int = 256) -> Tensor:
        """NLL over the GT bin of each head, (B,)."""
        total = 0.0
        for head in HEADS:
            centers = bin_centers(*BOUNDS[head], num_bins, gt[head].device)
            target = argmax_first(-torch.abs(gt[head][:, None] - centers[None, :num_bins]))
            total = total - torch.take_along_dim(out[f"{head}_logits"], target[:, None], 1)[:, 0]
        return total
