"""2D visualization: fields, confidences and horizon lines over images.

Port of geocalib_tpu/visualization/viz2d.py: matplotlib helpers on numpy
arrays (H, W, C) that draw what the JAX package's draw. matplotlib is
imported inside the functions (the card's machine has none), and the
headless Agg backend is chosen unless pyplot was already loaded with
another one. Tensors are accepted wherever arrays are and copied to the
host first.
"""

import sys
from typing import Optional, Sequence

import numpy as np


def _plt():
    """matplotlib.pyplot, on Agg unless pyplot was already loaded."""
    import matplotlib

    if "matplotlib.pyplot" not in sys.modules:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def to_numpy(x) -> np.ndarray:
    """A host float array of a tensor (any device or dtype) or an array."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x)


def plot_images(imgs: Sequence[np.ndarray], titles: Optional[Sequence[str]] = None,
                cmaps: str = "gray", dpi: int = 100, pad: float = 0.5):
    """A row of images; returns the figure and its axes."""
    plt = _plt()
    imgs = [to_numpy(i) for i in imgs]
    n = len(imgs)
    if not isinstance(cmaps, (list, tuple)):
        cmaps = [cmaps] * n
    ratios = [i.shape[1] / i.shape[0] for i in imgs]
    fig, axs = plt.subplots(1, n, figsize=(sum(ratios) * 4.5, 4.5), dpi=dpi,
                            gridspec_kw={"width_ratios": ratios})
    if n == 1:
        axs = [axs]
    for ax, img, cmap in zip(axs, imgs, cmaps):
        ax.imshow(img, cmap=plt.get_cmap(cmap))
        ax.set_axis_off()
        if titles:
            ax.set_title(titles[list(axs).index(ax)])
    fig.tight_layout(pad=pad)
    return fig, axs


def plot_vector_fields(axs, fields: Sequence[np.ndarray], subsample: int = 15,
                       scale: float = 1.0, color: str = "#60c6a8"):
    """Overlay up-vector fields (h, w, 2) as quiver plots."""
    for ax, field in zip(axs, fields):
        field = to_numpy(field)
        h, w = field.shape[:2]
        ys = np.arange(subsample // 2, h, subsample)
        xs = np.arange(subsample // 2, w, subsample)
        xx, yy = np.meshgrid(xs, ys)
        fx = field[yy, xx, 0]
        fy = field[yy, xx, 1]
        ax.quiver(xx, yy, fx, -fy, angles="xy", scale=30 / scale, color=color, width=0.003)


def plot_latitudes(axs, latitudes: Sequence[np.ndarray], is_radians: bool = True,
                   cmap: str = "seismic", alpha: float = 0.4):
    """Overlay latitude maps (h, w[, 1]) as heatmaps."""
    for ax, lat in zip(axs, latitudes):
        lat = to_numpy(lat).squeeze()
        lat = np.degrees(lat) if is_radians else lat
        ax.imshow(lat, cmap=cmap, vmin=-90, vmax=90, alpha=alpha)


def plot_confidences(axs, confidences: Sequence[np.ndarray], alpha: float = 0.4):
    """Overlay confidence maps (h, w) on a log scale."""
    for ax, conf in zip(axs, confidences):
        conf = to_numpy(conf).squeeze()
        ax.imshow(np.log10(np.clip(conf, 1e-6, None)), cmap="turbo", alpha=alpha)


def plot_horizon_lines(axs, cameras, gravities, line_colors: str = "orange", lw: int = 2):
    """Draw each image's horizon line; cameras and gravities are batched (B,)."""
    from geocalib_tpu_torch.geometry.perspective_fields import get_horizon_line

    for i, ax in enumerate(axs):
        cam, grav = cameras[i: i + 1], gravities[i: i + 1]
        horizon = to_numpy(get_horizon_line(cam, grav, relative=False))[0]
        w = float(cam.size[0, 0])
        ax.plot([0, w - 1], [horizon[0], horizon[1]], color=line_colors, lw=lw)


def plot_perspective_fields(imgs, ups, latitudes, confidences=None, **kw):
    """Images with up quivers and latitude overlays in one row."""
    fig, axs = plot_images(imgs, **kw)
    plot_vector_fields(axs, ups)
    plot_latitudes(axs, latitudes)
    if confidences is not None:
        plot_confidences(axs, confidences)
    return fig, axs


def save_plot(fig, path, **kw) -> None:
    fig.savefig(path, bbox_inches="tight", **kw)
    _plt().close(fig)
