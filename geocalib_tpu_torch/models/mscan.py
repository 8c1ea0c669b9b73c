"""MSCAN backbone (SegNeXt), port of geocalib_tpu/models/mscan.py.

Variants: "b" is the released model (dims 64/128/320/512, depths 3/3/12/3);
"tiny" is the test-size variant of the JAX package. In training, block i of
the n blocks drops its residual branches at the rate drop_path_rate·i/(n-1)
(mscan.py:54-56). Its BatchNorms take the data-parallel mesh (the JAX
MSCAN's ``bn_axis_name``).
"""

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from geocalib_tpu_torch.models.modules import (
    ChannelLayerNorm,
    MSCANBlock,
    OverlapPatchEmbed,
    StemConv,
)
from geocalib_tpu_torch.parallel.mesh import Mesh

Tensor = torch.Tensor

MSCAN_VARIANTS = {
    # dims, mlp_ratios, depths
    "b": ((64, 128, 320, 512), (8, 8, 4, 4), (3, 3, 12, 3)),
    "tiny": ((16, 24, 32, 48), (4, 4, 2, 2), (1, 1, 2, 1)),
}


class MSCAN(nn.Module):
    """Four-stage pyramid; returns features at strides 4, 8, 16, 32 (NCHW).

    Input: RGB in [0, 1], NCHW, mapped to BGR × 255 as the reference weights expect.
    """

    def __init__(self, dims: Sequence[int] = MSCAN_VARIANTS["b"][0],
                 mlp_ratios: Sequence[int] = MSCAN_VARIANTS["b"][1],
                 depths: Sequence[int] = MSCAN_VARIANTS["b"][2], drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, mesh: Optional[Mesh] = None):
        super().__init__()
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        self.embeds = nn.ModuleList()
        self.stages = nn.ModuleList()
        self.norms = nn.ModuleList()
        cur = 0
        for i, dim in enumerate(dims):
            self.embeds.append(StemConv(3, dim, mesh) if i == 0
                               else OverlapPatchEmbed(dims[i - 1], dim, mesh))
            self.stages.append(nn.Sequential(*[MSCANBlock(dim, mlp_ratios[i], drop_rate,
                                                          dpr[cur + j], mesh)
                                               for j in range(depths[i])]))
            self.norms.append(ChannelLayerNorm(dim, eps=1e-5))
            cur += depths[i]

    def forward(self, image: Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[Tensor, ...]:
        x = image.flip(1) * 255.0
        outs = []
        for embed, stage, norm in zip(self.embeds, self.stages, self.norms):
            x = embed(x)
            for block in stage:
                x = block(x, generator)
            x = norm(x)
            outs.append(x)
        return tuple(outs)
