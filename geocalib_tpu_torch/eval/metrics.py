"""Per-image evaluation metrics: camera, gravity and pixel projection.

Port of geocalib_tpu/eval/metrics.py. Batched on the tensors' device; every
metric is (B,), angles in degrees.
"""

from typing import Dict, Sequence

import torch

from geocalib_tpu_torch.geometry.camera import Camera
from geocalib_tpu_torch.geometry.gravity import Gravity
from geocalib_tpu_torch.training.losses import (dist_error, gravity_error, pitch_error,
                                                roll_error, vfov_error)

Tensor = torch.Tensor


def pixel_projection_errors(camera_pred: Camera, camera_gt: Camera, n: int = 64,
                            distortion_only: bool = True) -> Dict[str, Tensor]:
    """Pixel distance between the predicted and GT cameras' projections.

    An n×n grid over each image's own [0, W_i-1]×[0, H_i-1] (a batch may mix
    original sizes) is lifted to rays by the GT pinhole camera and projected by
    both cameras; with distortion_only the prediction keeps the GT size, focal
    and principal point. Returns dist, valid (both in both images) and
    valid_gt, each (B, n*n).
    """
    if distortion_only:
        camera_pred = Camera(camera_gt.size, camera_gt.f, camera_gt.c, camera_pred.k,
                             camera_gt.model)
    t = torch.linspace(0.0, 1.0, n, device=camera_gt.size.device)
    yg, xg = torch.meshgrid(t, t, indexing="ij")
    unit = torch.stack([xg, yg], dim=-1).reshape(-1, 2)
    xy = unit[None] * (camera_gt.size[:, None, :] - 1.0)

    uv_pin, _ = camera_gt.pinhole().image2world(xy)
    xy_gt, valid_gt = camera_gt.world2image(uv_pin)
    xy_pred, valid_pred = camera_pred.world2image(uv_pin)
    dist = torch.sqrt(torch.sum((xy_pred - xy_gt) ** 2, dim=-1))
    return {"dist": dist, "valid": valid_gt & valid_pred, "valid_gt": valid_gt}


def camera_metrics(camera_pred: Camera, camera_gt: Camera,
                   thresholds: Sequence[float] = (0.5, 1.0, 3.0, 5.0)) -> Dict[str, Tensor]:
    """vFoV, focal and k1 errors, and for a distorted GT model the pixel
    projection and distortion recalls at each threshold."""
    f_pred, f_gt = camera_pred.f[..., 1], camera_gt.f[..., 1]
    out = {
        "vfov": torch.rad2deg(camera_pred.vfov),
        "vfov_error": vfov_error(camera_pred, camera_gt),
        "focal": f_pred,
        "focal_error": torch.abs(f_pred - f_gt),
        "rel_focal_error": torch.abs(f_pred - f_gt) / f_gt,
    }
    if camera_gt.model != "pinhole":
        out["k1"] = camera_pred.k[..., 0]
        out["k1_error"] = dist_error(camera_pred, camera_gt)
        for distortion_only, tag in ((False, "projection"), (True, "distortion")):
            res = pixel_projection_errors(camera_pred, camera_gt, distortion_only=distortion_only)
            denom = torch.clamp(res["valid_gt"].sum(-1), min=1)
            for th in thresholds:
                hit = ((res["dist"] < th) & res["valid"]).sum(-1)
                out[f"pixel_{tag}_error@{th:g}"] = hit / denom
    return out


def gravity_metrics(gravity_pred: Gravity, gravity_gt: Gravity) -> Dict[str, Tensor]:
    return {
        "roll": torch.rad2deg(gravity_pred.roll),
        "pitch": torch.rad2deg(gravity_pred.pitch),
        "roll_error": roll_error(gravity_pred, gravity_gt),
        "pitch_error": pitch_error(gravity_pred, gravity_gt),
        "gravity_error": gravity_error(gravity_pred, gravity_gt),
    }
