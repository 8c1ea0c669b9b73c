"""Evaluation: metrics, pipelines, benchmark harness."""

from geocalib_tpu_torch.eval.metrics import (camera_metrics, gravity_metrics,
                                             pixel_projection_errors)
from geocalib_tpu_torch.eval.pipeline import EvalConf, SimplePipeline, evaluate_benchmark

__all__ = [
    "camera_metrics",
    "gravity_metrics",
    "pixel_projection_errors",
    "EvalConf",
    "SimplePipeline",
    "evaluate_benchmark",
]
