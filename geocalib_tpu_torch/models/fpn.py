"""FPN decoder: alternative to the Light Hamburger head.

Port of geocalib_tpu/models/fpn.py (lateral 1×1 + top-down sum/GLU/
feed-forward fusion), NCHW: returns (features (B, C, H, W), log_confidence
(B, H, W)) like LightHamHead. The Flax module infers its input widths; here
they are ``in_channels`` (the pyramid, finest first) and ``ll_channels`` (the
low-level features).
"""

from typing import Sequence, Tuple

import torch
from torch import nn

from geocalib_tpu_torch.models.modules import ConvModule, resize_bilinear

Tensor = torch.Tensor


class FPN(nn.Module):
    def __init__(self, out_channels: int = 64, fusion: str = "sum",
                 in_channels: Sequence[int] = (64, 128, 320, 512), ll_channels: int = 64):
        super().__init__()
        if fusion not in ("sum", "glu", "ff"):
            raise ValueError(f"unknown fusion {fusion!r}")
        c, levels = out_channels, len(in_channels) - 1
        self.out_channels, self.fusion = c, fusion
        self.in_channels, self.ll_channels = tuple(in_channels), ll_channels
        self.laterals = nn.ModuleList(nn.Conv2d(cin, c, 1) for cin in in_channels)
        if fusion == "glu":
            self.gates = nn.ModuleList(nn.Conv2d(2 * c, c, 1) for _ in range(levels))
        if fusion == "ff":
            self.fuse = nn.ModuleList(ConvModule(2 * c, c, 3, padding=1) for _ in range(levels))
        self.smooth = nn.ModuleList(ConvModule(c, c, 3, padding=1) for _ in range(levels))
        self.up = ConvModule(c, c, 3, padding=1)
        self.low_level = ConvModule(ll_channels, c, 3, padding=1)
        self.unc = ConvModule(c, c, 3, padding=1, bias=False)
        self.conf = nn.Conv2d(c, 1, 1)

    def forward(self, hl_features: Sequence[Tensor], ll_features: Tensor) -> Tuple[Tensor, Tensor]:
        laterals = [conv(f) for conv, f in zip(self.laterals, hl_features)]
        x = laterals[-1]  # top-down pathway; index 0 is the finest
        for level, lat in enumerate(reversed(laterals[:-1])):
            x = resize_bilinear(x, lat.shape[2:])
            if self.fusion == "sum":
                x = x + lat
            elif self.fusion == "glu":
                gate = torch.sigmoid(self.gates[level](torch.cat([x, lat], 1)))
                x = gate * x + (1 - gate) * lat
            else:
                x = self.fuse[level](torch.cat([x, lat], 1))
            x = self.smooth[level](x)

        # to full resolution, fuse low-level features
        feats = resize_bilinear(x, (x.shape[2] * 2, x.shape[3] * 2))
        feats = self.up(feats)
        feats = resize_bilinear(feats, (feats.shape[2] * 2, feats.shape[3] * 2))
        feats = feats + self.low_level(ll_features)
        log_confidence = self.conf(self.unc(feats))[:, 0]
        return feats, log_confidence
