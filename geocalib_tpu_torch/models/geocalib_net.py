"""GeoCalib network: backbone + low-level encoder + the two decoder heads.

Port of geocalib_tpu/models/geocalib_net.py with the outputs of the fused
serving path (geocalib_tpu/models/fused_heads.py): the heads' token
matrices are stacked into one NMF of batch 2B with tiled bases. The
block-diagonal 128-wide layout of the TPU path is not carried over; each
head runs at its own width.

Input image (B, H, W, 3) RGB in [0, 1], H and W multiples of 32. Output
fields are channel-last as in the JAX package: up_field (B, H, W, 2),
latitude_field (B, H, W, 1), up_confidence / latitude_confidence (B, H, W).

``forward`` is the evaluation path; ``forward_train`` mirrors
``fused_forward_train`` (models/fused_heads.py:399-452): the backbone in
training mode, the heads' NMF from bases drawn from the step's NMF key.
With a data-parallel mesh (parallel/mesh.py, the JAX net's ``bn_axis_name``)
the backbone's BatchNorms sync their statistics over the ranks in training;
the training step reads the mesh from ``net.mesh``.
"""

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from geocalib_tpu_torch.models.hamburger import (LightHamHead, eval_bases, nmf_2d, nmf_2d_train,
                                                 train_bases)
from geocalib_tpu_torch.models.modules import ConvModule
from geocalib_tpu_torch.models.mscan import MSCAN, MSCAN_VARIANTS
from geocalib_tpu_torch.parallel.mesh import Mesh
from geocalib_tpu_torch.utils.threefry import Key

Tensor = torch.Tensor
RUNNING_STATS = ("running_mean", "running_var")


class LowLevelEncoder(nn.Module):
    """Two 3×3 conv + ReLU at full resolution."""

    def __init__(self, feat_dim: int = 64):
        super().__init__()
        self.conv1 = ConvModule(3, feat_dim, 3, padding=1)
        self.conv2 = ConvModule(feat_dim, feat_dim, 3, padding=1)

    def forward(self, image: Tensor) -> Tensor:
        assert image.shape[2] % 32 == 0 and image.shape[3] % 32 == 0, (
            "image size must be a multiple of 32")
        return self.conv2(self.conv1(image))


def up_field(proj: Tensor) -> Tensor:
    """The up head's 1×1 projection (B, 2, H, W) → the L2-normalized up field (B, H, W, 2),
    the norm's square clamped at 1e-24 inside the sqrt."""
    up = proj.permute(0, 2, 3, 1)
    return up / torch.sqrt(torch.clamp(torch.sum(up * up, dim=-1, keepdim=True), min=1e-24))


def latitude_field(proj: Tensor) -> Tensor:
    """The latitude head's 1×1 projection (B, 1, H, W) → the latitude field (B, H, W, 1):
    tanh → clamp → asin in float32 (in bf16 the clamp is a no-op), in proj's dtype."""
    eps = 1e-5
    lat = torch.tanh(proj.permute(0, 2, 3, 1).float())
    return torch.arcsin(torch.clamp(lat, -1 + eps, 1 - eps)).to(proj.dtype)


class UpDecoder(nn.Module):
    """LightHamHead → 1×1 conv → L2-normalized up field (evaluation path); the
    counterpart of the JAX package's UpDecoder (GeoCalibNet runs both heads itself)."""

    def __init__(self, out_channels: int = 64, ham_channels: int = 512, in_channels: int = 1024):
        super().__init__()
        self.head = LightHamHead(in_channels, ham_channels, out_channels)
        self.proj = nn.Conv2d(out_channels, 2, 1)

    def forward(self, hl, ll: Tensor) -> Dict[str, Tensor]:
        feats, log_conf = self.head(hl, ll)
        return {"up_field": up_field(self.proj(feats)), "up_confidence": torch.sigmoid(log_conf)}


class LatitudeDecoder(nn.Module):
    """LightHamHead → 1×1 conv → tanh → asin latitude field (evaluation path)."""

    def __init__(self, out_channels: int = 64, ham_channels: int = 512, in_channels: int = 1024):
        super().__init__()
        self.head = LightHamHead(in_channels, ham_channels, out_channels)
        self.proj = nn.Conv2d(out_channels, 1, 1)

    def forward(self, hl, ll: Tensor) -> Dict[str, Tensor]:
        feats, log_conf = self.head(hl, ll)
        return {"latitude_field": latitude_field(self.proj(feats)),
                "latitude_confidence": torch.sigmoid(log_conf)}


class GeoCalibNet(nn.Module):
    """Perspective-field network; ``variant`` is "b" (released) or "tiny" (tests)."""

    def __init__(self, variant: str = "b", drop_path_rate: float = 0.0,
                 mesh: Optional[Mesh] = None):
        super().__init__()
        dims, ratios, depths = MSCAN_VARIANTS[variant]
        out_ch = min(64, dims[0])
        ham_ch = min(512, sum(dims))
        self.variant = variant
        self.mesh = mesh
        self.backbone = MSCAN(dims, ratios, depths, drop_path_rate=drop_path_rate, mesh=mesh)
        self.low_level = LowLevelEncoder(out_ch)
        self.up_head = LightHamHead(sum(dims), ham_ch, out_ch)
        self.up_proj = nn.Conv2d(out_ch, 2, 1)
        self.lat_head = LightHamHead(sum(dims), ham_ch, out_ch)
        self.lat_proj = nn.Conv2d(out_ch, 1, 1)

    def front(self, image: Tensor) -> Tuple[Tensor, ...]:
        """Everything before the NMF: (xu, xl, ll, tokens, bases).

        tokens (2B, h*w, C) stacks the up head's NMF input over the latitude
        head's; bases (2B, C, R) tiles the evaluation draw over both halves.
        """
        xu, xl, ll, tokens = self._trunk(image)
        bases = eval_bases(xu.shape[0], tokens.shape[2], tokens.device, tokens.dtype)
        return xu, xl, ll, tokens, bases.repeat(2, 1, 1)

    def _trunk(self, image: Tensor, generator: Optional[torch.Generator] = None
               ) -> Tuple[Tensor, ...]:
        x = image.permute(0, 3, 1, 2)
        hl = self.backbone(x, generator)
        ll = self.low_level(x)
        xu, hu = self.up_head.front(hl)
        xl, hlat = self.lat_head.front(hl)
        B, C, h, w = hu.shape
        tokens = torch.cat([hu, hlat], 0).permute(0, 2, 3, 1).reshape(2 * B, h * w, C)
        return xu, xl, ll, tokens.contiguous()

    def forward(self, image: Tensor, nmf_key: Optional[Key] = None,
                generator: Optional[torch.Generator] = None):
        """The fields; with an NMF key, ``forward_train``'s (fields, running statistics),
        so that ``torch.func.functional_call`` can drive either."""
        if nmf_key is not None:
            return self.forward_train(image, nmf_key, generator)
        xu, xl, ll, tokens, bases = self.front(image)
        return self._fields(xu, xl, ll, nmf_2d(tokens, bases))

    def forward_train(self, image: Tensor, nmf_key: Key,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        """The training forward: call it on a net in training mode (``net.train()``).

        BatchNorm normalises with batch statistics and updates its running
        statistics in place; DropPath draws from ``generator``; the NMF runs its
        6 training steps in plain PyTorch from bases ``uniform(nmf_key, (2B, C,
        64))``, independent per stacked half. Returns the fields and the
        BatchNorm running statistics after the update, by parameter name.
        """
        xu, xl, ll, tokens = self._trunk(image, generator)
        bases = train_bases(nmf_key, tokens.shape[0], tokens.shape[2], tokens.device,
                            tokens.dtype)
        fields = self._fields(xu, xl, ll, nmf_2d_train(tokens, bases))
        stats = {k: v for k, v in self.named_buffers() if k.endswith(RUNNING_STATS)}
        return fields, stats

    def _fields(self, xu: Tensor, xl: Tensor, ll: Tensor, recon: Tensor) -> Dict[str, Tensor]:
        """The heads from the NMF's reconstruction (2B, h*w, C) to the four fields."""
        B, C, h, w = xu.shape
        recon = recon.reshape(2 * B, h, w, C).permute(0, 3, 1, 2)

        fu, conf_u = self.up_head.back(xu, recon[:B], ll)
        fl, conf_l = self.lat_head.back(xl, recon[B:], ll)

        return {
            "up_field": up_field(self.up_proj(fu)),
            "up_confidence": torch.sigmoid(conf_u),
            "latitude_field": latitude_field(self.lat_proj(fl)),
            "latitude_confidence": torch.sigmoid(conf_l),
        }
