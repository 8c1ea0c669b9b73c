"""Angle / focal-length / rotation conversions on tensors.

Port of geocalib_tpu/utils/conversions.py; every function broadcasts over
arbitrary batch shapes.
"""

import math

import torch

Tensor = torch.Tensor


def rad2deg(rad: Tensor) -> Tensor:
    """Convert radians to degrees."""
    return rad * (180.0 / math.pi)


def deg2rad(deg: Tensor) -> Tensor:
    """Convert degrees to radians."""
    return deg * (math.pi / 180.0)


def fov2focal(fov: Tensor, size: Tensor) -> Tensor:
    """Focal length (pixels) from field of view (radians) and image size (pixels)."""
    return size / 2.0 / torch.tan(fov / 2.0)


def focal2fov(focal: Tensor, size: Tensor) -> Tensor:
    """Field of view (radians) from focal length and image size (pixels)."""
    return 2.0 * torch.arctan(size / (2.0 * focal))


def pitch2rho(pitch: Tensor, f: Tensor, h: Tensor) -> Tensor:
    """Distance from principal point to horizon, normalized by image height."""
    return torch.tan(pitch) * f / h


def rho2pitch(rho: Tensor, f: Tensor, h: Tensor) -> Tensor:
    """Pitch angle from normalized distance to horizon."""
    return torch.arctan(rho * h / f)


def skew_symmetric(v: Tensor) -> Tensor:
    """Skew-symmetric matrix (..., 3, 3) from vector (..., 3)."""
    z = torch.zeros_like(v[..., 0])
    rows = torch.stack([z, -v[..., 2], v[..., 1], v[..., 2], z, -v[..., 0], -v[..., 1], v[..., 0], z],
                       dim=-1)
    return rows.reshape(v.shape[:-1] + (3, 3))


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
