"""Training losses and metrics, port of geocalib_tpu/training/losses.py.

Field losses are L1 over the channels, weighted per pixel by the confidence
normalised to mean 1 and detached (``_conf_weight``, as the JAX package's
stop_gradient); parameter losses are L1 on the solver's gravity vector,
focal / h and distortion. Inputs are channel-last (B, H, W, C); every loss and
metric is per image (B,).
"""

import math
from typing import Dict, Optional

import torch

from geocalib_tpu_torch.geometry.camera import Camera
from geocalib_tpu_torch.geometry.gravity import Gravity

Tensor = torch.Tensor


def _conf_weight(confidence: Tensor) -> Tensor:
    """Per-pixel weights with mean 1, detached."""
    w = confidence / torch.sum(confidence, dim=(-2, -1), keepdim=True)
    w = w * (confidence.shape[-1] * confidence.shape[-2])
    return w.detach()


def field_loss(pred: Tensor, target: Tensor, confidence: Optional[Tensor] = None,
               loss_type: str = "l1") -> Tensor:
    """Per-image field loss (B,)."""
    res = pred - target
    if loss_type == "l1":
        loss = torch.abs(res).sum(-1)
    elif loss_type == "l2":
        loss = (res**2).sum(-1)
    elif loss_type == "dot":
        loss = 1.0 - (pred * target).sum(-1)
    elif loss_type == "cauchy":
        c = 0.007  # ~5 degrees
        loss = c**2 / 2 * torch.log1p((res**2).sum(-1) / c**2)
    elif loss_type == "huber":
        c = math.radians(1.0)
        a = torch.abs(res)
        loss = torch.where(a < c, 0.5 * res**2, c * (a - 0.5 * c)).sum(-1)
    else:
        raise ValueError(f"unknown loss type {loss_type}")
    if confidence is not None:
        loss = loss * _conf_weight(confidence)
    return loss.mean(dim=(-2, -1))


def param_losses(pred_cam: Camera, pred_grav: Gravity, gt_cam: Camera, gt_grav: Gravity
                 ) -> Dict[str, Tensor]:
    """L1 losses on the solver's outputs (B,)."""
    gravity = torch.abs(pred_grav.vec3d - gt_grav.vec3d).sum(-1)
    h = gt_cam.size[..., 1]
    focal = torch.abs(pred_cam.f - gt_cam.f).mean(-1) / h
    dist = torch.abs(pred_cam.k - gt_cam.k).sum(-1)
    return {"gravity": gravity, "focal": focal, "dist": dist,
            "param_total": gravity + focal + dist}


def geocalib_losses(fields: Dict[str, Tensor], lm_camera: Camera, lm_gravity: Gravity,
                    data: Dict[str, Tensor], gt_camera: Camera, gt_gravity: Gravity
                    ) -> Dict[str, Tensor]:
    """The training loss dict; "total" is the one optimised."""
    up = field_loss(fields["up_field"], data["up_field"], fields.get("up_confidence"), "l1")
    lat = field_loss(fields["latitude_field"], data["latitude_field"],
                     fields.get("latitude_confidence"), "l1")
    losses = {"up_total": up, "latitude_total": lat, "perspective_total": up + lat}
    losses |= param_losses(lm_camera, lm_gravity, gt_camera, gt_gravity)
    losses["total"] = losses["perspective_total"] + losses["param_total"]
    return losses


def _wrap_deg(x: Tensor) -> Tensor:
    """Angle differences wrapped into [-180, 180) degrees (floored modulo, as jnp's %)."""
    return torch.remainder(x + 180.0, 360.0) - 180.0


def roll_error(pred: Gravity, gt: Gravity) -> Tensor:
    return torch.abs(_wrap_deg(torch.rad2deg(pred.roll) - torch.rad2deg(gt.roll)))


def pitch_error(pred: Gravity, gt: Gravity) -> Tensor:
    return torch.abs(torch.rad2deg(pred.pitch) - torch.rad2deg(gt.pitch))


def gravity_error(pred: Gravity, gt: Gravity) -> Tensor:
    cos = torch.clamp(torch.sum(pred.vec3d * gt.vec3d, -1), -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))


def vfov_error(pred: Camera, gt: Camera) -> Tensor:
    return torch.abs(torch.rad2deg(pred.vfov) - torch.rad2deg(gt.vfov))


def dist_error(pred: Camera, gt: Camera) -> Tensor:
    return torch.abs(pred.k[..., 0] - gt.k[..., 0])


def up_angle_error(pred: Tensor, target: Tensor) -> Tensor:
    """Per-pixel angle between up vectors in degrees, (B, H, W)."""
    cos = torch.clamp(torch.sum(pred * target, -1), -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))


def latitude_angle_error(pred: Tensor, target: Tensor) -> Tensor:
    return torch.rad2deg(torch.abs(pred - target))[..., 0]


def geocalib_metrics(fields: Dict[str, Tensor], lm_camera: Camera, lm_gravity: Gravity,
                     data: Dict[str, Tensor], gt_camera: Camera, gt_gravity: Gravity
                     ) -> Dict[str, Tensor]:
    """Per-image metrics (B,) under the reference's names."""
    up_err = up_angle_error(fields["up_field"], data["up_field"])
    lat_err = latitude_angle_error(fields["latitude_field"], data["latitude_field"])
    out = {
        "roll_error": roll_error(lm_gravity, gt_gravity),
        "pitch_error": pitch_error(lm_gravity, gt_gravity),
        "gravity_error": gravity_error(lm_gravity, gt_gravity),
        "vfov_error": vfov_error(lm_camera, gt_camera),
        "k1_error": dist_error(lm_camera, gt_camera),
        "up_angle_error": up_err.mean(dim=(-2, -1)),
        "latitude_angle_error": lat_err.mean(dim=(-2, -1)),
    }
    for th in (1, 5, 10):
        out[f"up_angle_recall@{th}"] = (up_err < th).float().mean(dim=(-2, -1))
        out[f"latitude_angle_recall@{th}"] = (lat_err < th).float().mean(dim=(-2, -1))
    return out
