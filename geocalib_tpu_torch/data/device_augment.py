"""Photometric augmentation on the device, inside the training step.

Port of geocalib_tpu/data/device_augment.py: the same op list, probabilities
and order as the host "geocalib" pipeline, branch-free (per-image gates
blended in), with the two host codecs replaced as in the JAX package: the
JPEG round trip by luma quantization to 24..200 levels, the multi-resampling
downscale by a Gaussian low-pass whose sigma matches the scale's anti-alias
filter. Every draw comes from the port's threefry (utils/threefry.py) with
the keys of ``jax.random.split(rng, 24)``, so the uniform draws are JAX's bit
for bit; the normal draws go through erfinv, which differs from XLA's in the
last bits, and the float32 reductions and powers round in another order, so
the images agree with JAX's to float32 rounding except where a value sits at
a quantization step.

img: (B, H, W, 3) float32 in [0, 1] on any device; rng: a key pair.
"""

from typing import Tuple

import torch

from geocalib_tpu_torch.utils.threefry import (Key, normal, normal_from_unit, scale_unit, split,
                                               uniform_range, uniform_rows)

Tensor = torch.Tensor

_LUMA = (0.299, 0.587, 0.114)
_SEPIA = ((0.393, 0.769, 0.189), (0.349, 0.686, 0.168), (0.272, 0.534, 0.131))


def _per_image(key: Key, img: Tensor, lo: float, hi: float) -> Tensor:
    """A uniform scalar per image, (B, 1, 1, 1)."""
    return uniform_range(key, (img.shape[0], 1, 1, 1), lo, hi, img.device)


def _gate(key: Key, img: Tensor, p: float) -> Tensor:
    return (uniform_range(key, (img.shape[0], 1, 1, 1), device=img.device) < p).float()


def _blend(gate: Tensor, aug, orig) -> Tensor:
    return gate * aug + (1.0 - gate) * orig


class _SmallDraws:
    """The pipeline's per-image and per-channel draws, hashed in two batched passes
    instead of one threefry per key: the same bits as ``uniform_range(key, shape)``
    and ``normal(key, shape)``, with a few hundred launches instead of thousands."""

    def __init__(self, per_image, per_channel, b: int, device):
        self.b = b
        self.rows = dict(zip(per_image, uniform_rows(per_image, b, device)))
        self.rows.update(zip(per_channel, uniform_rows(per_channel, 3 * b, device)))

    def _shape(self, key: Key) -> tuple:
        return (self.b, 1, 1, self.rows[key].numel() // self.b)

    def uniform(self, key: Key, lo: float = 0.0, hi: float = 1.0) -> Tensor:
        return scale_unit(self.rows[key], lo, hi).view(self._shape(key))

    def gate(self, key: Key, p: float) -> Tensor:
        return (self.uniform(key) < p).float()

    def normal(self, key: Key) -> Tensor:
        return normal_from_unit(self.rows[key]).view(self._shape(key))


def _constant(values, device) -> Tensor:
    """A small float32 constant on `device`, copied without waiting for the device."""
    return torch.tensor(values, dtype=torch.float32).to(device, non_blocking=True)


def _sep_blur(img: Tensor, sigma_x: Tensor, sigma_y: Tensor, radius: int = 4) -> Tensor:
    """Separable Gaussian blur with per-image sigmas: 9 taps, edge-padded, W then H."""
    b, h, w = img.shape[:3]
    taps = torch.arange(-radius, radius + 1, dtype=torch.float32, device=img.device)

    def kernel(sigma: Tensor) -> Tensor:  # (B, 1, 1, 1) -> (B, 1, 1, 1, T)
        s = torch.clamp(sigma.reshape(b, 1), min=1e-3)
        k = torch.exp(-0.5 * (taps[None, :] / s) ** 2)
        return (k / k.sum(-1, keepdim=True))[:, None, None, None, :]

    def shifted(x: Tensor, n: int, dim: int) -> Tensor:  # (..., T): edge-padded shifts
        idx = torch.arange(n, device=x.device)
        views = [x.index_select(dim, torch.clamp(idx + t, 0, n - 1))
                 for t in range(-radius, radius + 1)]
        return torch.stack(views, -1)

    img = (shifted(img, w, 2) * kernel(sigma_x)).sum(-1)
    return (shifted(img, h, 1) * kernel(sigma_y)).sum(-1)


def device_augment(img: Tensor, rng: Key) -> Tensor:
    """The GeoCalib augmentation pipeline on the device."""
    k = split(rng, 24)
    sub = split(k[23], 6)
    dev, b = img.device, img.shape[0]
    r = _SmallDraws([k[i] for i in (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 13, 14, 16, 17, 18, 20,
                                     22)] + list(sub), [k[11], k[21]], b, dev)

    # ---- color ---- #
    g = _blend(r.gate(k[0], 0.8), r.uniform(k[1], 0.8, 1.8), 1.0)
    img = torch.clamp(img, 0.0, 1.0) ** g

    low = torch.clamp(0.25 + 0.1 * r.normal(k[2]), 0.0, 1.0)
    high = torch.clamp(0.75 + 0.1 * r.normal(k[3]), 0.0, 1.0)
    t = torch.clamp(img, 0.0, 1.0)
    curved = 3 * (1 - t) ** 2 * t * low + 3 * (1 - t) * t**2 * high + t**3
    img = _blend(r.gate(k[4], 0.5), curved, img)

    mean = img.mean((1, 2, 3), keepdim=True)
    bc = torch.clamp((img - mean) * r.uniform(k[5], 0.8, 1.2) + mean
                     + r.uniform(k[6], -0.2, 0.2), 0.0, 1.0)
    img = _blend(r.gate(k[7], 0.5), bc, img)

    cj = torch.clamp(img * r.uniform(k[8], 0.8, 1.2), 0.0, 1.0)
    mean = cj.mean((1, 2, 3), keepdim=True)
    cj = torch.clamp((cj - mean) * r.uniform(k[9], 0.8, 1.2) + mean, 0.0, 1.0)
    gray = cj.mean(-1, keepdim=True)
    cj = torch.clamp(gray + (cj - gray) * r.uniform(k[10], 0.8, 1.2), 0.0, 1.0)
    cj = torch.clamp(cj * r.uniform(k[11], 0.9, 1.1), 0.0, 1.0)
    img = _blend(r.gate(k[12], 0.4), cj, img)

    p = r.uniform(k[13])
    gray3 = img.mean(-1, keepdim=True).expand_as(img)
    sepia = torch.clamp(img @ _constant(_SEPIA, dev).T, 0.0, 1.0)
    img = torch.where(p < 0.1, gray3, torch.where(p < 0.2, sepia, img))

    # ---- noise ---- #
    sigma = torch.sqrt(r.uniform(k[14], 5.0, 112.0)) / 255.0
    noise = sigma * normal(k[15], img.shape, dev)
    img = torch.clamp(img + r.gate(k[16], 0.75) * noise, 0.0, 1.0)

    # JPEG stand-in: quantization to a random level count ~ quality 20..100
    levels = torch.round(r.uniform(k[17], 24.0, 200.0))
    img = torch.clamp(torch.round(img * levels) / levels, 0.0, 1.0)

    # ISO noise: luminance shot grain and a zero-mean hue drift
    luma = (img @ _constant(_LUMA, dev))[..., None]
    intensity = r.uniform(k[18], 0.1, 0.5)
    shot = torch.sqrt(torch.clamp(luma, 0.0, 1.0) / 255.0) * normal(k[19], luma.shape, dev)
    shift = r.uniform(k[20], 0.01, 0.05) * intensity * r.normal(k[21])
    iso = torch.clamp(img + intensity * shot + (shift - shift.mean(-1, keepdim=True)), 0.0, 1.0)
    img = _blend(r.gate(k[22], 0.5), iso, img)

    # ---- blur / sharpen / downscale low-pass ---- #
    gate_blur = r.gate(sub[0], 0.5)
    sx = _blend(gate_blur, r.uniform(sub[1], 0.2, 1.0), 1e-3)
    s = r.uniform(sub[2], 0.5, 0.99)
    sd = 0.5 * torch.sqrt(1.0 / (s * s) - 1.0)
    sx_total = torch.sqrt(sx**2 + sd**2)
    sy = torch.sqrt(_blend(gate_blur, r.uniform(sub[3], 0.2, 1.0), 1e-3) ** 2 + sd**2)
    blurred = _sep_blur(img, sx_total, sy)
    alpha = r.gate(sub[4], 0.25) * r.uniform(sub[5], 0.2, 0.5)
    return torch.clamp(blurred + alpha * (img - blurred), 0.0, 1.0)


def device_augment_dark(img: Tensor, rng: Key) -> Tensor:
    """The low-light preset: gamma-crush the shadows, dim, add sensor noise."""
    k = split(rng, 4)
    img = torch.clamp(img, 0.0, 1.0) ** _per_image(k[0], img, 1.5, 3.0)
    img = img * _per_image(k[1], img, 0.3, 0.7)
    sigma = _per_image(k[2], img, 0.01, 0.05)
    return torch.clamp(img + sigma * normal(k[3], img.shape, img.device), 0.0, 1.0)


def device_augment_deepcalib(img: Tensor, rng: Key) -> Tensor:
    """The DeepCalib preset: the GeoCalib pipeline, then per-pixel multiplicative
    noise in 0.85..1.15 with probability 0.5 per image."""
    k_base, k_gate, k_mul = split(rng, 3)
    img = device_augment(img, k_base)
    mul = uniform_range(k_mul, img.shape, 0.85, 1.15, img.device)
    return torch.clamp(img * torch.where(_gate(k_gate, img, 0.5) > 0, mul, 1.0), 0.0, 1.0)


DEVICE_AUGMENTATIONS = {
    "identity": lambda img, rng: img,
    "geocalib": device_augment,
    "dark": device_augment_dark,
    "deepcalib": device_augment_deepcalib,
}


def augment_stats(img: Tensor, rng: Key) -> Tuple[Tensor, Tensor]:
    """Mean and (population) standard deviation of the augmented batch."""
    out = device_augment(img, rng)
    return out.mean(), out.std(unbiased=False)
