"""Up/latitude field ↔ classification-bin encodings (PerspectiveFields compat).

Port of geocalib_tpu/models/perspective_encoding.py. ``%`` is the floored
modulo of jnp (``torch.remainder``), ``round`` is half to even in both, and
``searchsorted`` takes the left side, as jnp's default.
"""

import math

import numpy as np
import torch

Tensor = torch.Tensor
_DEG, _RAD = 180.0 / math.pi, math.pi / 180.0


def encode_up_bin(vector_field: Tensor, num_bin: int) -> Tensor:
    """Up field (..., h, w, 2) → bin indices (..., h, w), int32; last bin = invalid."""
    angle = torch.remainder(
        torch.atan2(vector_field[..., 1], vector_field[..., 0]) * _DEG + 180.0, 360.0)
    angle_bin = torch.round(angle / (360.0 / (num_bin - 1))).to(torch.int32)
    angle_bin = torch.where(angle_bin == num_bin - 1, 0, angle_bin)
    invalid = torch.all(vector_field == 0, dim=-1)
    return torch.where(invalid, num_bin - 1, angle_bin).to(torch.int32)


def decode_up_bin(angle_bin: Tensor, num_bin: int) -> Tensor:
    """Bin indices (..., h, w) → up field (..., h, w, 2); invalid bins → 0."""
    angle = (angle_bin.float() * (360.0 / (num_bin - 1)) - 180.0) * _RAD
    field = torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)
    invalid = (angle_bin == num_bin - 1)[..., None]
    return torch.where(invalid, 0.0, field)


def _grid(num: int, device) -> Tensor:
    """arange(-90, 90, 180 / num) in float32, as jnp.arange makes it."""
    return torch.from_numpy(np.arange(-90.0, 90.0, 180.0 / num, dtype=np.float32)).to(device)


def encode_bin_latitude(latimap: Tensor, num_classes: int) -> Tensor:
    """Latitude map (radians) → bin indices in [0, num_classes), int32."""
    boundaries = _grid(num_classes, latimap.device)[1:].contiguous()
    return torch.searchsorted(boundaries, (latimap * _DEG).contiguous()).to(torch.int32)


def decode_bin_latitude(binmap: Tensor, num_classes: int) -> Tensor:
    """Bin indices → latitude map (radians, bin centers)."""
    bin_size = 180.0 / num_classes
    centers = _grid(num_classes, binmap.device) + bin_size / 2.0
    return centers[binmap.long()] * _RAD
