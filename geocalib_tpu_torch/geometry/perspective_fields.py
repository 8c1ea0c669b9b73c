"""Perspective fields (up vectors + latitudes) and their analytic Jacobians.

Port of geocalib_tpu/geometry/perspective_fields.py. Fields are
channel-last grids (B, h, w, C); Jacobians are flattened over pixels,
(B, N, C, P) with P = 2 (gravity tangent) + 1 (focal) + num_k.
"""

from typing import Tuple

import torch

from geocalib_tpu_torch.geometry.camera import Camera
from geocalib_tpu_torch.geometry.gravity import Gravity
from geocalib_tpu_torch.geometry.jacobians import J_up_projection, J_vecnorm
from geocalib_tpu_torch.geometry.manifolds import SphericalManifold

Tensor = torch.Tensor


def _normalize(v: Tensor, eps: float = 1e-12) -> Tensor:
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    return v / torch.sqrt(torch.clamp(sq, min=eps * eps))


def _mm(a: Tensor, b: Tensor) -> Tensor:
    """Batched matrix product over the two trailing dims."""
    return torch.matmul(a, b)


def get_up_field_flat(camera: Camera, gravity: Gravity, h: int, w: int,
                      normalize: bool = True) -> Tensor:
    """Up-vector field flattened over pixels, (B, N, 2)."""
    uv = camera.normalize(camera.pixel_coordinates(h, w))
    abc = gravity.vec3d
    projected = abc[..., None, :2] - abc[..., 2, None, None] * uv
    if camera.has_distortion:
        d_uv = camera.distort_scale(uv)
        offset = camera.up_projection_offset(uv)
        inner = torch.sum(uv * projected, dim=-1, keepdim=True)
        projected = d_uv * projected + offset * inner
    return _normalize(projected) if normalize else projected


def get_up_field(camera: Camera, gravity: Gravity, h: int, w: int,
                 normalize: bool = True) -> Tensor:
    """Up-vector field as a grid, (B, h, w, 2)."""
    flat = get_up_field_flat(camera, gravity, h, w, normalize)
    return flat.reshape(flat.shape[:-2] + (h, w, 2))


def get_latitude_field_flat(camera: Camera, gravity: Gravity, h: int, w: int) -> Tensor:
    """Latitude field (radians) flattened over pixels, (B, N, 1)."""
    uv1, _ = camera.image2world(camera.pixel_coordinates(h, w))
    rays = camera.pixel_bearing_many(uv1)
    lat = torch.sum(rays * gravity.vec3d[..., None, :], dim=-1)
    eps = 1e-6
    return torch.arcsin(torch.clamp(lat, -1 + eps, 1 - eps))[..., None]


def get_latitude_field(camera: Camera, gravity: Gravity, h: int, w: int) -> Tensor:
    """Latitude field (radians) as a grid, (B, h, w, 1)."""
    flat = get_latitude_field_flat(camera, gravity, h, w)
    return flat.reshape(flat.shape[:-2] + (h, w, 1))


def get_perspective_field(camera: Camera, gravity: Gravity, h: int, w: int,
                          use_up: bool = True, use_latitude: bool = True
                          ) -> Tuple[Tensor, Tensor]:
    """Up (B, h, w, 2) and latitude (B, h, w, 1) fields."""
    assert use_up or use_latitude
    B = camera.batch_shape[0] if camera.batch_shape else 1
    dev = camera.f.device
    up = (get_up_field(camera, gravity, h, w) if use_up
          else torch.zeros((B, h, w, 2), device=dev))
    lat = (get_latitude_field(camera, gravity, h, w) if use_latitude
           else torch.zeros((B, h, w, 1), device=dev))
    return up, lat


def get_horizon_line(camera: Camera, gravity: Gravity, relative: bool = True) -> Tensor:
    """Heights where the horizon meets the left and right image borders, (B, 2);
    divided by the image height when relative."""
    e3 = torch.tensor([0.0, 0.0, 1.0], device=camera.f.device)
    midpoint3 = (camera.K @ gravity.R) @ e3
    midpoint = midpoint3[..., :2] / midpoint3[..., 2:3]

    left_offset = midpoint[..., 0] * torch.tan(gravity.roll)
    right_offset = (camera.size[..., 0] - midpoint[..., 0]) * torch.tan(gravity.roll)
    left = midpoint[..., 1] + left_offset
    right = midpoint[..., 1] - right_offset
    horizon = torch.stack([left, right], dim=-1)
    return horizon / camera.size[..., 1:2] if relative else horizon


def J_up_field(camera: Camera, gravity: Gravity, h: int, w: int,
               spherical: bool = False, log_focal: bool = False) -> Tensor:
    """Jacobian of the normalized up field, (B, N, 2, 3 + num_k)."""
    xy = camera.pixel_coordinates(h, w)
    uv = camera.normalize(xy)
    abc = gravity.vec3d
    projected = abc[..., None, :2] - abc[..., 2, None, None] * uv

    raw_up = get_up_field_flat(camera, gravity, h, w, normalize=False)
    J_norm2proj = J_vecnorm(raw_up)  # (B, N, 2, 2)

    has_dist = camera.has_distortion
    eye = torch.eye(2, dtype=uv.dtype, device=uv.device)
    if has_dist:
        d_uv = camera.distort_scale(uv)
        offset = camera.up_projection_offset(uv)
        D = d_uv[..., None] * eye + offset[..., :, None] * uv[..., None, :]

    blocks = []

    # gravity block
    J_proj2abc = J_up_projection(uv, abc, wrt="abc")  # (B, N, 2, 3)
    if has_dist:
        J_proj2abc = _mm(D, J_proj2abc)
    J_abc2delta = SphericalManifold.J_plus(abc) if spherical else gravity.J_rp()
    J_proj2delta = _mm(J_proj2abc, J_abc2delta[..., None, :, :])
    blocks.append(_mm(J_norm2proj, J_proj2delta))

    # focal block
    J_proj2uv = J_up_projection(uv, abc, wrt="uv")  # -c I
    if has_dist:
        J_proj2up = _mm(D, J_proj2uv)
        inner = torch.sum(uv * projected, dim=-1)[..., None, None]
        J_proj2uv = (
            projected[..., :, None] * offset[..., None, :]
            + inner * camera.J_up_projection_offset(uv, wrt="uv")
            + offset[..., :, None] * projected[..., None, :]
            + J_proj2up
        )
    J_uv2f = camera.J_normalize(xy, wrt="f")
    if log_focal:
        J_uv2f = J_uv2f * camera.f[..., None, None, :]
    J_uv2f = J_uv2f.sum(-1)  # (B, N, 2)
    J_proj2f = _mm(J_proj2uv, J_uv2f[..., None])[..., 0]
    blocks.append(_mm(J_norm2proj, J_proj2f[..., None]))

    # distortion block
    if has_dist:
        J_duv = camera.J_distort(uv, wrt="scale2dist")  # (B, N, K)
        J_first2dist = projected[..., :, None] * J_duv[..., None, :]
        uv_projT = uv[..., :, None] * projected[..., None, :]
        J_offset_k = camera.J_up_projection_offset(uv, wrt="dist")  # (B, N, 2, K)
        J_sec2dist = _mm(uv_projT, J_offset_k)
        blocks.append(_mm(J_norm2proj, J_first2dist + J_sec2dist))

    return torch.cat(blocks, dim=-1)


def J_latitude_field(camera: Camera, gravity: Gravity, h: int, w: int,
                     spherical: bool = False, log_focal: bool = False) -> Tensor:
    """Jacobian of sin(latitude), (B, N, 1, 3 + num_k)."""
    xy = camera.pixel_coordinates(h, w)
    uv1, _ = camera.image2world(xy)
    uv1_norm = camera.pixel_bearing_many(uv1)
    J_norm2w = J_vecnorm(uv1)[..., :2]  # (B, N, 3, 2)
    g = gravity.vec3d

    blocks = []
    J_delta = SphericalManifold.J_plus(g) if spherical else gravity.J_rp()
    blocks.append(_mm(uv1_norm[..., None, :], J_delta[..., None, :, :])[..., 0, :])

    J_w2f = camera.J_image2world(xy, "f")
    if log_focal:
        J_w2f = J_w2f * camera.f[..., None, None, :]
    J_w2f = J_w2f.sum(-1)  # (B, N, 2)
    J_norm2f = _mm(J_norm2w, J_w2f[..., None])[..., 0]  # (B, N, 3)
    blocks.append(torch.sum(J_norm2f * g[..., None, :], dim=-1)[..., None])

    if camera.has_distortion:
        J_w2dist = camera.J_image2world(xy, "dist")  # (B, N, 2, K)
        J_norm2dist = _mm(J_norm2w, J_w2dist)  # (B, N, 3, K)
        blocks.append(torch.sum(J_norm2dist * g[..., None, :, None], dim=-2))

    return torch.cat(blocks, dim=-1)[..., None, :]


def J_perspective_field(camera: Camera, gravity: Gravity, h: int, w: int,
                        spherical: bool = False, log_focal: bool = False
                        ) -> Tuple[Tensor, Tensor]:
    """Up and latitude Jacobians, (B, N, 2, P) and (B, N, 1, P)."""
    return (J_up_field(camera, gravity, h, w, spherical, log_focal),
            J_latitude_field(camera, gravity, h, w, spherical, log_focal))
