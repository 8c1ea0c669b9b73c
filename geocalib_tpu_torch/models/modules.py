"""Network building blocks, NCHW inside.

Port of geocalib_tpu/models/modules.py. Semantics copied exactly:
- GELU is the erf form (torch's default, unlike jax.nn.gelu's default);
- the ResidualConvUnit skip adds relu(x), not x;
- BatchNorm has eps 1e-5, and in training Flax's statistics: the biased
  variance taken in float32, and Flax's momentum 0.9 (``BatchNorm``);
- convolutions use symmetric explicit padding.

Training mode is the module's ``training`` flag. DropPath and the Mlp's
dropout draw their masks from an explicit ``torch.Generator``. The blocks
with a BatchNorm take the data-parallel mesh (parallel/mesh.py), the
counterpart of the JAX modules' ``bn_axis_name``.
"""

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from geocalib_tpu_torch.parallel.mesh import Mesh, mean_over_ranks

Tensor = torch.Tensor

FLAX_BN_MOMENTUM = 0.9


def gelu(x: Tensor) -> Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def resize_bilinear(x: Tensor, size: Tuple[int, int]) -> Tensor:
    """Bilinear NCHW resize with half-pixel centers (= jax.image.resize when upsampling).

    The forward is ``F.interpolate``; its backward (``_Resize``) applies the
    transposed interpolation matrices, with no atomics, so a gradient through it
    has the same bits from run to run.
    """
    return _Resize.apply(x, tuple(size))


@functools.lru_cache(maxsize=64)
def _interpolation_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) weights of 1-D linear interpolation with half-pixel centers
    (align_corners=False), sources below 0 clamped to 0, as F.interpolate."""
    A = np.zeros((n_out, n_in))
    for i in range(n_out):
        src = max((i + 0.5) * n_in / n_out - 0.5, 0.0)
        i0 = min(int(np.floor(src)), n_in - 1)
        i1 = min(i0 + 1, n_in - 1)
        frac = src - i0
        A[i, i0] += 1.0 - frac
        A[i, i1] += frac
    return A


class _Resize(torch.autograd.Function):
    """F.interpolate forward; backward Ahᵀ · g · Aw by two batched products, where
    the native CUDA backward of bilinear upsampling accumulates with atomics."""

    @staticmethod
    def forward(ctx, x: Tensor, size: Tuple[int, int]) -> Tensor:
        ctx.in_size = tuple(x.shape[-2:])
        return F.interpolate(x, size=size, mode="bilinear", align_corners=False)

    @staticmethod
    def backward(ctx, g: Tensor):
        (h_in, w_in), (h_out, w_out) = ctx.in_size, g.shape[-2:]
        mat = lambda n_out, n_in: torch.as_tensor(_interpolation_matrix(n_out, n_in),
                                                  dtype=g.dtype, device=g.device)
        return torch.matmul(mat(h_out, h_in).T, torch.matmul(g, mat(w_out, w_in))), None


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


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d (eps 1e-5) with Flax's training semantics.

    Evaluation is torch's, on the running statistics; where those are float32
    and x is not (validation during mixed-precision training), it is Flax's
    formula below on them. Training takes the batch
    statistics in float32 whatever x's dtype, as Flax's ``_compute_stats``:
    the mean and E[x²] - E[x]² clipped at 0, the *biased* variance, which also
    goes into the running update ``r = 0.9 r + 0.1 batch`` (in place, under
    no_grad; torch's own update uses the unbiased variance). The output is
    (x - mean) · (rsqrt(var + eps) · scale) + bias in float32, cast to x's dtype.

    With a mesh, training stacks the float32 mean and E[x²] and takes their mean
    over the ranks in one collective, as Flax's ``_compute_stats`` does with its
    ``axis_name``: every rank then normalises with, and makes the running update
    from, the statistics of the whole batch (synced BatchNorm; the backward sums
    the ranks' cotangents, as JAX's pmean transposes).
    """

    def __init__(self, ch: int, mesh: Optional[Mesh] = None):
        super().__init__(ch, eps=1e-5)
        self.mesh = mesh

    def forward(self, x: Tensor) -> Tensor:
        if not self.training and self.running_mean.dtype == x.dtype:
            return super().forward(x)
        x32 = x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            mean, sq = x32.mean((0, 2, 3)), (x32 * x32).mean((0, 2, 3))
            if self.mesh is not None:
                mean, sq = mean_over_ranks(torch.stack([mean, sq]), self.mesh).unbind(0)
            var = torch.clamp(sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = FLAX_BN_MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (x32 - mean[:, None, None]) * mul[:, None, None] + self.bias.float()[:, None, None]
        return y.to(x.dtype)


def _keep_mask(shape, keep: float, generator: Optional[torch.Generator], device) -> Tensor:
    return torch.rand(shape, generator=generator, device=device) < keep


class DropPath(nn.Module):
    """Stochastic depth: in training, drop a sample's whole residual branch with
    probability ``rate`` and scale the kept ones by 1 / (1 - rate)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: Tensor, generator: Optional[torch.Generator] = None) -> Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask = _keep_mask((x.shape[0],) + (1,) * (x.ndim - 1), keep, generator, x.device)
        return x * mask.to(x.dtype) / keep


def dropout(x: Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> Tensor:
    """Flax's ``nn.Dropout``: kept elements are x / (1 - rate), dropped ones 0."""
    if rate == 0.0 or not training:
        return x
    keep = 1.0 - rate
    return torch.where(_keep_mask(x.shape, keep, generator, x.device), x / keep,
                       torch.zeros_like(x))


class Mlp(nn.Module):
    """1×1 conv → 3×3 depthwise conv → GELU → dropout → 1×1 conv → dropout."""

    def __init__(self, dim: int, hidden: int, drop: float = 0.0):
        super().__init__()
        self.fc1 = nn.Conv2d(dim, hidden, 1)
        self.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = nn.Conv2d(hidden, dim, 1)
        self.drop = drop

    def forward(self, x: Tensor, generator: Optional[torch.Generator] = None) -> Tensor:
        x = dropout(gelu(self.dwconv(self.fc1(x))), self.drop, self.training, generator)
        return dropout(self.fc2(x), self.drop, self.training, generator)


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
    """BN → attention and BN → MLP residual branches with layer scale and DropPath."""

    def __init__(self, dim: int, mlp_ratio: float, drop: float = 0.0, drop_path: float = 0.0,
                 mesh: Optional[Mesh] = None):
        super().__init__()
        self.norm1 = BatchNorm(dim, mesh)
        self.attn = SpatialAttention(dim)
        self.norm2 = BatchNorm(dim, mesh)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop)
        self.layer_scale_1 = nn.Parameter(torch.full((dim,), 1e-2))
        self.layer_scale_2 = nn.Parameter(torch.full((dim,), 1e-2))
        self.drop_path = DropPath(drop_path)

    def forward(self, x: Tensor, generator: Optional[torch.Generator] = None) -> Tensor:
        h = self.layer_scale_1[:, None, None] * self.attn(self.norm1(x))
        x = x + self.drop_path(h, generator)
        h = self.layer_scale_2[:, None, None] * self.mlp(self.norm2(x), generator)
        return x + self.drop_path(h, generator)


class StemConv(nn.Module):
    """Two stride-2 3×3 convs with BN, GELU between: 1/4 resolution."""

    def __init__(self, cin: int, cout: int, mesh: Optional[Mesh] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout // 2, 3, stride=2, padding=1)
        self.bn1 = BatchNorm(cout // 2, mesh)
        self.conv2 = nn.Conv2d(cout // 2, cout, 3, stride=2, padding=1)
        self.bn2 = BatchNorm(cout, mesh)

    def forward(self, x: Tensor) -> Tensor:
        return self.bn2(self.conv2(gelu(self.bn1(self.conv1(x)))))


class OverlapPatchEmbed(nn.Module):
    """Stride-2 3×3 conv with BN."""

    def __init__(self, cin: int, cout: int, mesh: Optional[Mesh] = None):
        super().__init__()
        self.proj = nn.Conv2d(cin, cout, 3, stride=2, padding=1)
        self.norm = BatchNorm(cout, mesh)

    def forward(self, x: Tensor) -> Tensor:
        return self.norm(self.proj(x))


class ChannelLayerNorm(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW tensor."""

    def forward(self, x: Tensor) -> Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
