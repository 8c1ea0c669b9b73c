"""Geometry core: cameras, gravity, manifolds, perspective fields."""

from geocalib_tpu_torch.geometry.camera import (
    CAMERA_MODELS,
    DIST_RANGE,
    NUM_DIST_PARAMS,
    Camera,
)
from geocalib_tpu_torch.geometry.gravity import Gravity
from geocalib_tpu_torch.geometry.manifolds import EuclideanManifold, SphericalManifold
from geocalib_tpu_torch.geometry.perspective_fields import (
    J_perspective_field,
    get_horizon_line,
    get_latitude_field,
    get_perspective_field,
    get_up_field,
)

__all__ = [
    "CAMERA_MODELS",
    "DIST_RANGE",
    "NUM_DIST_PARAMS",
    "Camera",
    "Gravity",
    "EuclideanManifold",
    "SphericalManifold",
    "J_perspective_field",
    "get_horizon_line",
    "get_latitude_field",
    "get_perspective_field",
    "get_up_field",
]
