"""Photometric augmentation pipelines on the host (numpy, PIL inside two ops).

Port of geocalib_tpu/data/augmentations.py, which is numpy and PIL already:
the same ops, draws and order, so the same seed gives the same bits. The
"geocalib" training pipeline follows the original GeoCalib's op families and
probabilities: gamma 0.8, tone curve 0.5, brightness/contrast 0.5, color
jitter 0.4, gray/sepia 0.1/0.1, gaussian sensor noise 0.75, JPEG compression
always (quality 20..100, a real PIL encode and decode), ISO noise 0.5, a
blur/sharpen pair, and a multi-interpolation downscale always (scale
0.5..0.99, PIL's BOX/BILINEAR/BICUBIC). Registry: "geocalib", "dark",
"default", "identity". PIL is imported inside ``jpeg_compress`` and
``downscale_upscale``: the card's machine has none.
"""

import io
from typing import Callable, Dict, Sequence, Tuple

import numpy as np

Array = np.ndarray


def _blur(img: Array, sigma: float, sigma_y: float = None) -> Array:
    """Separable gaussian blur with a small kernel (per-axis sigma)."""
    sy = sigma if sigma_y is None else sigma_y

    def kernel(s):
        radius = max(1, int(3 * s))
        x = np.arange(-radius, radius + 1)
        k = np.exp(-0.5 * (x / max(s, 1e-3)) ** 2)
        return k / k.sum()

    out = np.apply_along_axis(lambda m: np.convolve(m, kernel(sy), mode="same"), 0, img)
    out = np.apply_along_axis(lambda m: np.convolve(m, kernel(sigma), mode="same"), 1, out)
    return out


def jpeg_compress(img: Array, quality: int) -> Array:
    """Real JPEG encode/decode round-trip (reference A.ImageCompression)."""
    from PIL import Image

    arr = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=int(quality))
    buf.seek(0)
    out = np.asarray(Image.open(buf).convert("RGB"), np.float32) / 255.0
    return out


_PIL_INTERP: Sequence[Tuple[str, str]] = (
    # (down, up) pairs mirroring the reference's cv2 combinations
    ("box", "bilinear"),
    ("bilinear", "bicubic"),
    ("bicubic", "bilinear"),
    ("bilinear", "box"),
)


def downscale_upscale(img: Array, scale: float, pair: Tuple[str, str]) -> Array:
    """Downscale then restore at full size with the given resampling pair
    (reference A.Downscale with multi-interpolation)."""
    from PIL import Image

    interp = {
        "box": Image.BOX,
        "bilinear": Image.BILINEAR,
        "bicubic": Image.BICUBIC,
        "nearest": Image.NEAREST,
    }
    h, w = img.shape[:2]
    sh, sw = max(1, int(h * scale)), max(1, int(w * scale))
    arr = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    pil = Image.fromarray(arr)
    small = pil.resize((sw, sh), interp[pair[0]])
    back = small.resize((w, h), interp[pair[1]])
    return np.asarray(back, np.float32) / 255.0


def iso_noise(img: Array, rng, color_shift: float, intensity: float) -> Array:
    """Sensor ISO noise: poisson luminance grain + hue drift
    (reference A.ISONoise(color_shift=(0.01,0.05), intensity=(0.1,0.5)))."""
    luminance = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    # photon shot noise: variance proportional to luminance
    grain = rng.poisson(np.clip(luminance, 0, 1) * 255.0) / 255.0 - luminance
    out = img + (intensity * grain)[..., None]
    # color (hue) shift: rotate channels slightly, zero-mean
    shift = rng.normal(0.0, color_shift * intensity, (1, 1, 3))
    out = out + (shift - shift.mean())
    return np.clip(out, 0, 1).astype(np.float32)


def tone_curve(img: Array, rng, scale: float = 0.1) -> Array:
    """Random smooth S-curve on intensity (reference A.RandomToneCurve):
    a cubic bezier with jittered control points, applied per-image."""
    low = np.clip(rng.normal(0.25, scale), 0.0, 1.0)
    high = np.clip(rng.normal(0.75, scale), 0.0, 1.0)
    t = np.clip(img, 0, 1)
    # cubic bezier through (0,0),(0.25,low),(0.75,high),(1,1) evaluated at t
    out = (
        (1 - t) ** 3 * 0.0
        + 3 * (1 - t) ** 2 * t * low
        + 3 * (1 - t) * t**2 * high
        + t**3 * 1.0
    )
    return np.clip(out, 0, 1).astype(np.float32)


def to_sepia(img: Array) -> Array:
    m = np.array(
        [[0.393, 0.769, 0.189], [0.349, 0.686, 0.168], [0.272, 0.534, 0.131]],
        np.float32,
    )
    return np.clip(img @ m.T, 0, 1).astype(np.float32)


class Augmentation:
    """Base: a callable img (H, W, 3) float [0,1] → augmented image."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def reseed(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def __call__(self, img: Array) -> Array:
        raise NotImplementedError


class IdentityAugmentation(Augmentation):
    def __call__(self, img: Array) -> Array:
        return img


class DefaultAugmentation(Augmentation):
    """Mild photometric jitter (reference "default" pipeline)."""

    def __call__(self, img: Array) -> Array:
        rng = self.rng
        if rng.uniform() < 0.5:
            img = img ** rng.uniform(0.8, 1.25)  # gamma
        if rng.uniform() < 0.5:
            img = np.clip(img * rng.uniform(0.8, 1.2) + rng.uniform(-0.1, 0.1), 0, 1)
        if rng.uniform() < 0.5:
            scale = rng.uniform(0.9, 1.1, size=(1, 1, 3))
            img = np.clip(img * scale, 0, 1)
        return img.astype(np.float32)


class GeoCalibAugmentation(Augmentation):
    """Full training pipeline (reference "geocalib" op list + probabilities,
    augmentations.py:277-349)."""

    def __call__(self, img: Array) -> Array:
        rng = self.rng
        # ---- color transforms ---- #
        if rng.uniform() < 0.8:  # RandomGamma gamma_limit=(80, 180)
            img = np.clip(img, 0, 1) ** rng.uniform(0.8, 1.8)
        if rng.uniform() < 0.5:  # RandomToneCurve scale=0.1
            img = tone_curve(img, rng, scale=0.1)
        if rng.uniform() < 0.5:  # RandomBrightnessContrast
            mean = img.mean()
            img = np.clip(
                (img - mean) * rng.uniform(0.8, 1.2) + mean + rng.uniform(-0.2, 0.2),
                0,
                1,
            )
        if rng.uniform() < 0.4:  # ColorJitter (0.2, 0.2, 0.2, 0.2)
            img = np.clip(img * rng.uniform(0.8, 1.2), 0, 1)  # brightness
            mean = img.mean()
            img = np.clip((img - mean) * rng.uniform(0.8, 1.2) + mean, 0, 1)
            gray = img.mean(-1, keepdims=True)
            img = np.clip(gray + (img - gray) * rng.uniform(0.8, 1.2), 0, 1)  # sat
            img = np.clip(img * rng.uniform(0.9, 1.1, (1, 1, 3)), 0, 1)  # hue-ish
        p = rng.uniform()
        if p < 0.1:  # ToGray
            img = np.repeat(img.mean(-1, keepdims=True), 3, axis=-1)
        elif p < 0.2:  # ToSepia
            img = to_sepia(img)

        # ---- noise transforms ---- #
        if rng.uniform() < 0.75:  # GaussNoise var_limit=(5, 112) on 0-255
            sigma = np.sqrt(rng.uniform(5.0, 112.0)) / 255.0
            img = np.clip(img + rng.normal(0, sigma, img.shape), 0, 1)
        # ImageCompression quality 20..100, p=1 (ALWAYS)
        img = jpeg_compress(img, rng.integers(20, 101))
        if rng.uniform() < 0.5:  # ISONoise
            img = iso_noise(
                img, rng, rng.uniform(0.01, 0.05), rng.uniform(0.1, 0.5)
            )
        # blur/sharpen pair in random order (OneOrOther of AdvancedBlur+Sharpen)
        def do_blur(x):
            return np.clip(
                _blur(x, rng.uniform(0.2, 1.0), rng.uniform(0.2, 1.0)), 0, 1
            )

        def do_sharpen(x):
            if rng.uniform() < 0.5:
                alpha = rng.uniform(0.2, 0.5)
                return np.clip(x + alpha * (x - _blur(x, 1.0)), 0, 1)
            return x

        if rng.uniform() < 0.5:
            img = do_sharpen(do_blur(img))
        else:
            img = do_blur(do_sharpen(img))

        # ---- image transforms ---- #
        # Downscale scale 0.5..0.99, multi-interp, p=1 (ALWAYS)
        pair = _PIL_INTERP[rng.integers(0, len(_PIL_INTERP))]
        img = downscale_upscale(img, rng.uniform(0.5, 0.99), pair)
        return img.astype(np.float32)


class DarkAugmentation(Augmentation):
    """Low-light simulation (reference "dark")."""

    def __call__(self, img: Array) -> Array:
        rng = self.rng
        img = img ** rng.uniform(1.5, 3.0)  # crush shadows
        img = img * rng.uniform(0.3, 0.7)
        img = np.clip(img + rng.normal(0, rng.uniform(0.01, 0.05), img.shape), 0, 1)
        return img.astype(np.float32)


AUGMENTATIONS: Dict[str, Callable[..., Augmentation]] = {
    "identity": IdentityAugmentation,
    "default": DefaultAugmentation,
    "geocalib": GeoCalibAugmentation,
    "dark": DarkAugmentation,
}


def get_augmentation(name: str, seed: int = 0) -> Augmentation:
    try:
        return AUGMENTATIONS[name](seed=seed)
    except KeyError:
        raise ValueError(f"unknown augmentation {name!r}; options: {list(AUGMENTATIONS)}")
