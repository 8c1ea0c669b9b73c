"""Gravity direction in the camera frame.

Port of geocalib_tpu/geometry/gravity.py: a unit 3-vector with roll/pitch
extraction and manifold updates.
"""

import dataclasses
import math

import torch

from geocalib_tpu_torch.geometry.manifolds import EuclideanManifold, SphericalManifold
from geocalib_tpu_torch.utils.conversions import rad2rotmat

Tensor = torch.Tensor
_EPS = 1e-4


@dataclasses.dataclass(frozen=True)
class Gravity:
    """Unit gravity vector (..., 3) in camera coordinates."""

    vec3d: Tensor

    @classmethod
    def from_vec3d(cls, vec) -> "Gravity":
        """Create from an arbitrary 3-vector (normalized here)."""
        vec = torch.as_tensor(vec, dtype=torch.float32)
        norm = torch.linalg.norm(vec, dim=-1, keepdim=True)
        return cls(vec3d=vec / torch.clamp(norm, min=1e-12))

    @classmethod
    def from_rp(cls, roll, pitch) -> "Gravity":
        """g = [-sin r cos p, -cos r cos p, sin p]."""
        roll = torch.as_tensor(roll, dtype=torch.float32)
        pitch = torch.as_tensor(pitch, dtype=torch.float32, device=roll.device)
        sr, cr = torch.sin(roll), torch.cos(roll)
        sp, cp = torch.sin(pitch), torch.cos(pitch)
        return cls(vec3d=torch.stack([-sr * cp, -cr * cp, sp], dim=-1))

    @property
    def x(self) -> Tensor:
        return self.vec3d[..., 0]

    @property
    def y(self) -> Tensor:
        return self.vec3d[..., 1]

    @property
    def z(self) -> Tensor:
        return self.vec3d[..., 2]

    @property
    def roll(self) -> Tensor:
        """Roll angle in radians, in (-π, π]."""
        denom = torch.sqrt(torch.clamp(1.0 - self.z**2, min=0.0)) + _EPS
        roll = torch.arcsin(torch.clamp(-self.x / denom, -1.0, 1.0))
        offset = -math.pi * torch.sign(self.x)
        return torch.where(self.y < 0, roll, -roll + offset)

    @property
    def pitch(self) -> Tensor:
        return torch.arcsin(torch.clamp(self.z, -1.0, 1.0))

    @property
    def rp(self) -> Tensor:
        return torch.stack([self.roll, self.pitch], dim=-1)

    def J_rp(self) -> Tensor:
        """Jacobian d vec3d / d (roll, pitch), shape (..., 3, 2)."""
        cp, sp = torch.cos(self.pitch), torch.sin(self.pitch)
        cr, sr = torch.cos(self.roll), torch.sin(self.roll)
        zero = torch.zeros_like(cp)
        J_roll = torch.stack([-cr * cp, sr * cp, zero], dim=-1)
        J_pitch = torch.stack([sr * sp, cr * sp, cp], dim=-1)
        return torch.stack([J_roll, J_pitch], dim=-1)

    @property
    def R(self) -> Tensor:
        return rad2rotmat(roll=self.roll, pitch=self.pitch)

    def update(self, delta: Tensor, spherical: bool = False) -> "Gravity":
        """Apply a 2D tangent update on the selected manifold."""
        if spherical:
            return Gravity.from_vec3d(SphericalManifold.plus(self.vec3d, delta))
        rp = EuclideanManifold.plus(self.rp, delta)
        return Gravity.from_rp(rp[..., 0], rp[..., 1])

    def J_update(self, spherical: bool = False) -> Tensor:
        return SphericalManifold.J_plus(self.vec3d) if spherical else self.J_rp()

    def __getitem__(self, idx) -> "Gravity":
        return Gravity(self.vec3d[idx])
