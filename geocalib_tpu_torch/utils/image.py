"""Image IO and preprocessing: resize to a target side, center-crop to a multiple
of 32, and record the scale and crop so cameras map back to the original pixels.

Port of geocalib_tpu/utils/image.py. The antialiased bilinear downsizing is
``F.interpolate(..., antialias=True)``, which agrees with
``jax.image.resize(..., antialias=True)`` to float32 rounding (the same
triangle kernel widened by the scale, renormalized at the borders). PIL is
imported inside the file functions: the machine with the card has none, and
the preprocessor itself needs no file.
"""

import dataclasses
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def load_image(path: Union[str, Path]) -> Tensor:
    """Load an image as float32 RGB (H, W, 3) in [0, 1] (PIL backend)."""
    from PIL import Image

    img = Image.open(str(path)).convert("RGB")
    return torch.from_numpy(np.asarray(img, dtype=np.float32) / 255.0)


def write_image(img, path: Union[str, Path]) -> None:
    """Save float RGB [0, 1] (H, W, 3) to disk."""
    from PIL import Image

    arr = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(str(path))


def resize_image(img: Tensor, size: Tuple[int, int], antialias: bool = True) -> Tensor:
    """Bilinear resize of (..., H, W, C) to `size`, half-pixel centers
    (jax.image.resize's "bilinear"), antialiased when downsizing if asked."""
    lead = img.shape[:-3]
    x = img.reshape((-1,) + tuple(img.shape[-3:])).permute(0, 3, 1, 2)
    out = F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                        antialias=antialias)
    return out.permute(0, 2, 3, 1).reshape(lead + (size[0], size[1], img.shape[-1]))


@dataclasses.dataclass
class PreprocessorConf:
    resize: Optional[int] = 320
    side: str = "short"
    edge_divisible_by: Optional[int] = 32
    antialias: bool = True
    square_crop: bool = False


class ImagePreprocessor:
    """Resize images (..., h, w, 3), float RGB in [0, 1], so that the conf's side
    is `resize` (no resize when it is None), then center-crop both sides to
    multiples of `edge_divisible_by` (no crop when it is None or 0); with
    `square_crop` the image is first center-cropped to a square.

    Returns image (..., h', w', 3), scales [sx, sy] (new/old), crop_pad [dw, dh]
    (non-positive, zero without a crop), image_size and original_image_size
    (after the square crop), as tensors on the images' device. A batch of
    same-size images is resized in one call.
    """

    def __init__(self, conf: Optional[PreprocessorConf] = None, **kw):
        self.conf = conf or PreprocessorConf(**kw)

    def target_size(self, h: int, w: int) -> Tuple[int, int]:
        c = self.conf
        if c.resize is None:
            return h, w
        aspect = w / h
        if (c.side == "short") ^ (aspect < 1.0):
            return c.resize, int(round(c.resize * aspect))
        return int(round(c.resize / aspect)), c.resize

    def __call__(self, img) -> Dict[str, Tensor]:
        img = torch.as_tensor(img, dtype=torch.float32)
        h0, w0 = img.shape[-3:-1]
        if self.conf.square_crop:
            m = min(h0, w0)
            oy, ox = (h0 - m) // 2, (w0 - m) // 2
            img = img[..., oy : oy + m, ox : ox + m, :]
            h0, w0 = m, m

        th, tw = self.target_size(h0, w0)
        if (th, tw) != (h0, w0):
            img = resize_image(img, (th, tw), self.conf.antialias)

        dw = dh = 0
        d = self.conf.edge_divisible_by
        if d:
            ch, cw = (th // d) * d, (tw // d) * d
            dh, dw = ch - th, cw - tw
            top, left = (-dh) // 2, (-dw) // 2
            img = img[..., top : top + ch, left : left + cw, :]
        f32 = lambda *v: torch.tensor(v, dtype=torch.float32, device=img.device)
        return {
            "image": img.contiguous(),
            "scales": f32(tw / w0, th / h0),
            "crop_pad": f32(dw, dh),
            "image_size": f32(img.shape[-2], img.shape[-3]),
            "original_image_size": f32(w0, h0),
        }
