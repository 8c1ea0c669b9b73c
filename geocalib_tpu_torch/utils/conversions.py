"""Angle / focal-length / rotation conversions on tensors.

Port of the parts of geocalib_tpu/utils/conversions.py the slice uses; every
function broadcasts over arbitrary batch shapes.
"""

import math

import torch

Tensor = torch.Tensor


def deg2rad(deg: Tensor) -> Tensor:
    """Convert degrees to radians."""
    return deg * (math.pi / 180.0)


def fov2focal(fov: Tensor, size: Tensor) -> Tensor:
    """Focal length (pixels) from field of view (radians) and image size (pixels)."""
    return size / 2.0 / torch.tan(fov / 2.0)


def focal2fov(focal: Tensor, size: Tensor) -> Tensor:
    """Field of view (radians) from focal length and image size (pixels)."""
    return 2.0 * torch.arctan(size / (2.0 * focal))


def rad2rotmat(roll: Tensor, pitch: Tensor, yaw=None) -> Tensor:
    """Rotation matrix (..., 3, 3) from roll/pitch/yaw (radians): Rz(roll) Rx(pitch) Ry(yaw)."""
    roll = torch.as_tensor(roll)
    pitch = torch.as_tensor(pitch)
    yaw = torch.zeros_like(roll) if yaw is None else torch.as_tensor(yaw)

    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cr, sr = torch.cos(roll), torch.sin(roll)
    one = torch.ones_like(cp)
    zero = torch.zeros_like(cp)

    rx = torch.stack([one, zero, zero, zero, cp, sp, zero, -sp, cp], -1)
    ry = torch.stack([cy, zero, -sy, zero, one, zero, sy, zero, cy], -1)
    rz = torch.stack([cr, sr, zero, -sr, cr, zero, zero, zero, one], -1)
    rx = rx.reshape(pitch.shape + (3, 3))
    ry = ry.reshape(yaw.shape + (3, 3))
    rz = rz.reshape(roll.shape + (3, 3))
    return rz @ rx @ ry
