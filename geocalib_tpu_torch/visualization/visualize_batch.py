"""Figures of a training or evaluation batch.

Port of geocalib_tpu/visualization/visualize_batch.py: predicted against
ground-truth up and latitude fields for the first images of a batch, the
figures the training loop writes with each validation.
"""

from typing import Dict

from geocalib_tpu_torch.visualization.viz2d import (plot_images, plot_latitudes,
                                                    plot_vector_fields, to_numpy)


def _first(batch, key: str, n: int) -> list:
    return [to_numpy(batch[key][i]) for i in range(min(n, len(batch[key])))]


def make_up_figure(pred: Dict, data: Dict, n: int = 3):
    """Rows: image + GT up, image + predicted up."""
    imgs = _first(data, "image", n)
    fig, axs = plot_images(imgs + imgs, titles=None)
    k = len(imgs)
    plot_vector_fields(axs[:k], _first(data, "up_field", k))
    plot_vector_fields(axs[k:], _first(pred, "up_field", k), color="#cc3311")
    return {"up_field": fig}


def make_latitude_figure(pred: Dict, data: Dict, n: int = 3):
    imgs = _first(data, "image", n)
    fig, axs = plot_images(imgs + imgs)
    k = len(imgs)
    plot_latitudes(axs[:k], _first(data, "latitude_field", k))
    plot_latitudes(axs[k:], _first(pred, "latitude_field", k))
    return {"latitude_field": fig}


def make_perspective_figures(pred: Dict, data: Dict, n_pairs: int = 3) -> Dict:
    """Every field comparison figure the batch has fields for."""
    figs = {}
    if "up_field" in pred and "up_field" in data:
        figs |= make_up_figure(pred, data, n_pairs)
    if "latitude_field" in pred and "latitude_field" in data:
        figs |= make_latitude_figure(pred, data, n_pairs)
    return figs
