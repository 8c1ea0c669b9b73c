"""LightHamHead decoder (HamNet / SegNeXt) with the Hamburger NMF.

Port of geocalib_tpu/models/hamburger.py as models/fused_heads.py runs it:
each head is split around its NMF, so that GeoCalibNet can stack both heads'
tokens into one NMF of batch 2B. In evaluation the bases are JAX's
deterministic draw, ``uniform(PRNGKey(0), (B, D, R))``, reproduced bit for
bit (utils/threefry.py) and tiled over the two halves, and the NMF is the
kernel's (7 steps). In training the bases are drawn per stacked half from the
step's NMF key, and the NMF is ``NMF2D(train=True)``: 6 steps in plain
PyTorch with autograd, never the kernel (fused_heads.py:190-191).
"""

import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from geocalib_tpu_torch.models.modules import (
    ConvModule,
    FeatureFusionBlock,
    resize_bilinear,
)
from geocalib_tpu_torch.ops.nmf import nmf_plain, nmf_reconstruct
from geocalib_tpu_torch.utils.threefry import Key, uniform_tensor

Tensor = torch.Tensor

NMF_RANK = 64
NMF_EVAL_STEPS = 7
NMF_TRAIN_STEPS = 6
NMF_INV_T = 1.0
NMF_EPS = 1e-6


@functools.lru_cache(maxsize=16)
def _eval_bases_cpu(B: int, D: int, R: int, dtype: torch.dtype) -> Tensor:
    return uniform_tensor(0, (B, D, R), dtype)


def eval_bases(B: int, D: int, device, dtype: torch.dtype, R: int = NMF_RANK) -> Tensor:
    """``jax.random.uniform(PRNGKey(0), (B, D, R), dtype)`` on `device`."""
    return _eval_bases_cpu(B, D, R, dtype).to(device)


def train_bases(key: Key, B: int, D: int, device, dtype: torch.dtype, R: int = NMF_RANK
                ) -> Tensor:
    """``jax.random.uniform(key, (B, D, R), dtype)`` drawn on `device`."""
    return uniform_tensor(key, (B, D, R), dtype, device)


def nmf_2d(tokens: Tensor, bases: Tensor, steps: int = NMF_EVAL_STEPS) -> Tensor:
    """Evaluation NMF2D of tokens (B, N, D) from raw bases (B, D, R)."""
    return nmf_reconstruct(tokens, bases, steps, NMF_INV_T, NMF_EPS)


def nmf_2d_train(tokens: Tensor, bases: Tensor, steps: int = NMF_TRAIN_STEPS) -> Tensor:
    """Training NMF2D of tokens (B, N, D) from raw bases (B, D, R): the plain
    version, differentiable, on any device."""
    coef, bt = nmf_plain(tokens, bases, steps, NMF_INV_T, NMF_EPS)
    return torch.matmul(coef, bt)


class LightHamHead(nn.Module):
    """Aggregate the four backbone scales, decompose, fuse low-level features.

    ``front`` runs up to the NMF's input, ``back`` from its output to the
    head's features and log-confidence.
    """

    def __init__(self, in_channels: int = 1024, ham_channels: int = 512, out_channels: int = 64):
        super().__init__()
        self.squeeze = ConvModule(in_channels, ham_channels, 1)
        self.ham_in = ConvModule(ham_channels, ham_channels, 1)
        self.ham_out = ConvModule(ham_channels, ham_channels, 1)
        self.align = ConvModule(ham_channels, out_channels, 1)
        self.conv_up = ConvModule(out_channels, out_channels, 3, padding=1, bias=False)
        self.fusion = FeatureFusionBlock(out_channels)
        self.conv_unc = ConvModule(out_channels, out_channels, 3, padding=1, bias=False)
        self.conf = nn.Conv2d(out_channels, 1, 1)

    def front(self, hl: Sequence[Tensor]) -> Tuple[Tensor, Tensor]:
        """(x, h): the squeezed features and the NMF's input, NCHW."""
        x = self.squeeze(torch.cat([resize_bilinear(f, hl[0].shape[-2:]) for f in hl], dim=1))
        return x, self.ham_in(x)

    def forward(self, hl: Sequence[Tensor], ll: Tensor) -> Tuple[Tensor, Tensor]:
        """(features, log_confidence) of the evaluation path: ``front``, the NMF of the
        head's own tokens from the evaluation bases, ``back``."""
        x, h = self.front(hl)
        B, C, hh, ww = h.shape
        tokens = h.permute(0, 2, 3, 1).reshape(B, hh * ww, C).contiguous()
        recon = nmf_2d(tokens, eval_bases(B, C, tokens.device, tokens.dtype))
        return self.back(x, recon.reshape(B, hh, ww, C).permute(0, 3, 1, 2), ll)

    def back(self, x: Tensor, recon: Tensor, ll: Tensor) -> Tuple[Tensor, Tensor]:
        """(features, log_confidence) at full resolution, NCHW."""
        x = F.relu(x + self.ham_out(recon))
        feats = self.align(x)
        feats = resize_bilinear(feats, (feats.shape[2] * 2, feats.shape[3] * 2))
        feats = self.conv_up(feats)
        feats = resize_bilinear(feats, (feats.shape[2] * 2, feats.shape[3] * 2))
        feats = self.fusion(feats, ll)
        return feats, self.conf(self.conv_unc(feats))[:, 0]
