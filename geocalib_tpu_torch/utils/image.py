"""Image preprocessing: resize the short side, center-crop to a multiple of 32.

Port of ImagePreprocessor in geocalib_tpu/utils/image.py. The antialiased
bilinear downsizing is ``F.interpolate(..., antialias=True)``, which agrees
with ``jax.image.resize(..., antialias=True)`` to float32 rounding (the same
triangle kernel widened by the scale, renormalized at the borders). There is
no image file loader: images come in as arrays.
"""

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def resize_image(img: Tensor, size: Tuple[int, int]) -> Tensor:
    """Antialiased bilinear resize of (..., H, W, C) to `size`, half-pixel centers
    (jax.image.resize's "bilinear" default; upsizing is plain bilinear)."""
    lead = img.shape[:-3]
    x = img.reshape((-1,) + tuple(img.shape[-3:])).permute(0, 3, 1, 2)
    out = F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                        antialias=True)
    return out.permute(0, 2, 3, 1).reshape(lead + (size[0], size[1], img.shape[-1]))


class ImagePreprocessor:
    """Resize images (..., h, w, 3), float RGB in [0, 1], so that their short side
    is 320, then center-crop both sides to multiples of 32; records the undo data.

    Returns image (..., h', w', 3), scales [sx, sy] (new/old), crop_pad [dw, dh]
    (non-positive), image_size and original_image_size, as tensors on the
    images' device. A batch of same-size images is resized in one call.
    """

    resize = 320
    edge_divisible_by = 32

    def target_size(self, h: int, w: int) -> Tuple[int, int]:
        aspect = w / h
        if aspect >= 1.0:
            return self.resize, int(round(self.resize * aspect))
        return int(round(self.resize / aspect)), self.resize

    def __call__(self, img) -> Dict[str, Tensor]:
        img = torch.as_tensor(img, dtype=torch.float32)
        h0, w0 = img.shape[-3:-1]
        th, tw = self.target_size(h0, w0)
        if (th, tw) != (h0, w0):
            img = resize_image(img, (th, tw))

        d = self.edge_divisible_by
        ch, cw = (th // d) * d, (tw // d) * d
        dh, dw = ch - th, cw - tw
        top, left = (-dh) // 2, (-dw) // 2
        img = img[..., top : top + ch, left : left + cw, :]
        f32 = lambda *v: torch.tensor(v, dtype=torch.float32, device=img.device)
        return {
            "image": img.contiguous(),
            "scales": f32(tw / w0, th / h0),
            "crop_pad": f32(dw, dh),
            "image_size": f32(cw, ch),
            "original_image_size": f32(w0, h0),
        }
