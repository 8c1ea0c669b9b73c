"""Visualization: matplotlib plots of fields, confidences and horizon lines
(matplotlib is imported when a plot is drawn, not here)."""

from geocalib_tpu_torch.visualization.visualize_batch import make_perspective_figures
from geocalib_tpu_torch.visualization.viz2d import (plot_confidences, plot_horizon_lines,
                                                    plot_images, plot_latitudes,
                                                    plot_perspective_fields, plot_vector_fields,
                                                    save_plot)

__all__ = [
    "make_perspective_figures",
    "plot_confidences",
    "plot_horizon_lines",
    "plot_images",
    "plot_latitudes",
    "plot_perspective_fields",
    "plot_vector_fields",
    "save_plot",
]
