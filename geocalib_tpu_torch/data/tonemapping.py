"""HDR → LDR tonemapping operators and a batch CLI for panorama preparation.

Port of geocalib_tpu/data/tonemapping.py: the Laval HDR panoramas must be
tonemapped to 8-bit JPEGs before the pano→crop generator can use them. The
operators are numpy (host-side data preparation, the same arrays as the JAX
package's): `log` (Reinhard-style log compression with percentile
normalization) and `gamma`. OpenCV, which reads .hdr and .exr files, is
imported inside `_load_hdr` only; .npy files need nothing else.

CLI:
    python -m geocalib_tpu_torch.data.tonemapping --hdr_dir panos_hdr \
        --out_dir panos_ldr --operator log
"""

import argparse
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["tonemap_log", "tonemap_gamma", "tonemap", "main"]


def _luminance(img: np.ndarray) -> np.ndarray:
    return 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]


def tonemap_gamma(img: np.ndarray, gamma: float = 2.2, percentile: float = 90.0) -> np.ndarray:
    """Percentile-normalized gamma curve; returns float in [0, 1]."""
    img = np.clip(np.nan_to_num(img.astype(np.float64)), 0.0, None)
    scale = np.percentile(_luminance(img), percentile)
    img = img / max(scale, 1e-8)
    return np.clip(img ** (1.0 / gamma), 0.0, 1.0)


def tonemap_log(
    img: np.ndarray,
    exposure: float = 1.0,
    percentile: float = 90.0,
    gamma: float = 2.2,
) -> np.ndarray:
    """Log-compress dynamic range around a percentile white point, then gamma."""
    img = np.clip(np.nan_to_num(img.astype(np.float64)), 0.0, None) * exposure
    lum = _luminance(img)
    white = max(np.percentile(lum, percentile), 1e-8)
    mapped_lum = np.log1p(lum / white) / np.log1p(1.0 / max(white, 1e-8) * white)
    ratio = mapped_lum / np.maximum(lum / white, 1e-8)
    out = img / white * ratio[..., None]
    return np.clip(out ** (1.0 / gamma), 0.0, 1.0)


OPERATORS = {"log": tonemap_log, "gamma": tonemap_gamma}


def tonemap(img: np.ndarray, operator: str = "log", **kw) -> np.ndarray:
    return OPERATORS[operator](img, **kw)


def _load_hdr(path: Path) -> Optional[np.ndarray]:
    """Read .hdr/.exr via OpenCV if available, .npy directly."""
    if path.suffix == ".npy":
        return np.load(path)
    try:
        import cv2  # optional: the card's machine has no OpenCV

        img = cv2.imread(str(path), cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
        return None if img is None else img[..., ::-1].astype(np.float32)
    except ImportError:
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--hdr_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--operator", choices=sorted(OPERATORS), default="log")
    ap.add_argument("--exposure", type=float, default=1.0)
    args = ap.parse_args(argv)

    from geocalib_tpu_torch.utils.image import write_image

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = sorted(
        p
        for p in Path(args.hdr_dir).iterdir()
        if p.suffix.lower() in (".hdr", ".exr", ".npy")
    )
    done = 0
    for path in paths:
        img = _load_hdr(path)
        if img is None:
            print(f"skipping {path.name} (no reader available)")
            continue
        kw = {"exposure": args.exposure} if args.operator == "log" else {}
        ldr = tonemap(img, args.operator, **kw)
        write_image(ldr, out_dir / (path.stem + ".jpg"))
        done += 1
    print(f"tonemapped {done}/{len(paths)} panoramas → {out_dir}")


if __name__ == "__main__":
    main()
