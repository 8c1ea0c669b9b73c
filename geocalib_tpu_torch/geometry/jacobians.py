"""Shared analytic Jacobian helpers (port of geocalib_tpu/geometry/jacobians.py)."""

import torch

Tensor = torch.Tensor


def J_vecnorm(vec: Tensor, eps: float = 1e-6) -> Tensor:
    """Jacobian of v ↦ v/||v||₂, shape (..., D, D)."""
    D = vec.shape[-1]
    norm = torch.linalg.norm(vec, dim=-1, keepdim=True)[..., None]
    norm = torch.clamp(norm, min=eps)
    xxT = vec[..., :, None] * vec[..., None, :]
    eye = torch.eye(D, dtype=vec.dtype, device=vec.device)
    return eye / norm - xxT / norm**3


def J_focal2fov(focal: Tensor, h: Tensor) -> Tensor:
    """Jacobian of focal2fov(f, h) = 2 atan(h / 2f) wrt f."""
    return -4.0 * h / (4.0 * focal**2 + h**2)


def J_up_projection(uv: Tensor, abc: Tensor, wrt: str = "uv") -> Tensor:
    """Jacobian of the up-vector projection p(uv) = (a, b) - c·uv.

    uv: (..., N, 2); abc: (..., 3). wrt="uv" → (..., N, 2, 2); "abc" → (..., N, 2, 3).
    """
    if wrt == "uv":
        c = abc[..., 2][..., None, None, None]
        eye = torch.eye(2, dtype=uv.dtype, device=uv.device)
        return -c * eye.expand(uv.shape[:-1] + (2, 2))
    if wrt == "abc":
        zeros = torch.zeros_like(uv[..., 0])
        ones = torch.ones_like(uv[..., 0])
        row0 = torch.stack([ones, zeros, -uv[..., 0]], dim=-1)
        row1 = torch.stack([zeros, ones, -uv[..., 1]], dim=-1)
        return torch.stack([row0, row1], dim=-2)
    raise ValueError(f"Unknown wrt: {wrt}")
