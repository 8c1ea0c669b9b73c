"""Planar (pixel-last) perspective-field math.

Port of geocalib_tpu/geometry/planar_fields.py: every per-pixel quantity is
a scalar plane (B, N), and the 2×P Jacobians are expanded to plane
arithmetic through the radial-distortion scalar characterization. This is
the plain PyTorch twin that the LM CUDA kernel (ops/lm_system.py) is held
against, line for line.
"""

from typing import List, Tuple

import torch

from geocalib_tpu_torch.geometry.camera import Camera, _spec
from geocalib_tpu_torch.geometry.gravity import Gravity
from geocalib_tpu_torch.geometry.manifolds import SphericalManifold

Tensor = torch.Tensor
_EPS = 1e-12


def make_grid(camera: Camera, h: int, w: int) -> Tuple[Tensor, Tensor]:
    """Normalized pixel-center coordinates as planes u, v of shape (B, N)."""
    dev = camera.f.device
    x = torch.arange(w, dtype=torch.float32, device=dev)
    y = torch.arange(h, dtype=torch.float32, device=dev)
    xx = x.repeat(h)  # x fastest
    yy = y.repeat_interleave(w)
    fx, fy = camera.f[..., 0:1], camera.f[..., 1:2]
    cx, cy = camera.c[..., 0:1], camera.c[..., 1:2]
    return (xx - cx) / fx, (yy - cy) / fy


def strided_grid(camera: Camera, h: int, w: int, stride: int) -> Tuple[Tensor, Tensor]:
    """Normalized coords for every stride-th pixel (matches grid[::s, ::s])."""
    dev = camera.f.device
    x = torch.arange(0, w, stride, dtype=torch.float32, device=dev)
    y = torch.arange(0, h, stride, dtype=torch.float32, device=dev)
    xx = x.repeat(y.shape[0])
    yy = y.repeat_interleave(x.shape[0])
    fx, fy = camera.f[..., 0:1], camera.f[..., 1:2]
    cx, cy = camera.c[..., 0:1], camera.c[..., 1:2]
    return (xx - cx) / fx, (yy - cy) / fy


def _k_planes(camera: Camera) -> Tuple[Tensor, Tensor]:
    return camera.k[..., 0:1], camera.k[..., 1:2]


def _gravity_planes(gravity: Gravity) -> Tuple[Tensor, Tensor, Tensor]:
    vec = gravity.vec3d
    return vec[..., 0:1], vec[..., 1:2], vec[..., 2:3]


def up_planes(camera: Camera, gravity: Gravity, u: Tensor, v: Tensor,
              normalize: bool = True) -> Tuple[Tensor, Tensor]:
    """Up field as planes (tx, ty), optionally L2-normalized."""
    a, b, cg = _gravity_planes(gravity)
    px = a - cg * u
    py = b - cg * v
    if camera.has_distortion:
        spec = _spec(camera.model)
        k1, k2 = _k_planes(camera)
        r2 = u * u + v * v
        s = spec.scale(k1, k2, r2)
        phi = spec.phi(k1, k2, r2)
        inner = u * px + v * py
        tx = s * px + phi * u * inner
        ty = s * py + phi * v * inner
    else:
        tx, ty = px, py
    if not normalize:
        return tx, ty
    inv = 1.0 / torch.clamp(torch.sqrt(tx * tx + ty * ty), min=_EPS)
    return tx * inv, ty * inv


def sinlat_planes(camera: Camera, gravity: Gravity, u: Tensor, v: Tensor) -> Tensor:
    """sin(latitude) plane: bearing(u, v) · gravity."""
    a, b, cg = _gravity_planes(gravity)
    spec = _spec(camera.model)
    k1, k2 = _k_planes(camera)
    su = spec.undistort_scale(k1, k2, u * u + v * v)
    ud, vd = su * u, su * v
    inv = 1.0 / torch.sqrt(ud * ud + vd * vd + 1.0)
    return (a * ud + b * vd + cg) * inv


def manifold_matrix(gravity: Gravity, spherical: bool) -> Tensor:
    """J_abc2delta (B, 3, 2): the gravity-tangent basis of the J planes."""
    return SphericalManifold.J_plus(gravity.vec3d) if spherical else gravity.J_rp()


def _manifold_planes(gravity: Gravity, spherical: bool, M=None):
    """m[k][d] as (B, 1) planes; M is (B, 3, 2) or None (computed from gravity)."""
    if M is None:
        M = manifold_matrix(gravity, spherical)
    return [[M[..., k, d][..., None] for d in range(2)] for k in range(3)]


def _focal_planes(camera: Camera, u: Tensor, v: Tensor, log_focal: bool):
    """d(u, v)/d(focal step) as planes (gx, gy)."""
    if log_focal:
        return -u, -v
    fx, fy = camera.f[..., 0:1], camera.f[..., 1:2]
    return -u / fx, -v / fy


def J_up_planes(camera: Camera, gravity: Gravity, u: Tensor, v: Tensor,
                spherical: bool = False, log_focal: bool = False,
                M: Tensor = None) -> List[List[Tensor]]:
    """Jacobian planes J[c][p] of the normalized up field, c < 2, p < 3 + num_k."""
    a, b, cg = _gravity_planes(gravity)
    px = a - cg * u
    py = b - cg * v
    has_dist = camera.has_distortion
    if has_dist:
        spec = _spec(camera.model)
        k1, k2 = _k_planes(camera)
        r2 = u * u + v * v
        s = spec.scale(k1, k2, r2)
        phi = spec.phi(k1, k2, r2)
        dphi = spec.dphi_dr2(k1, k2, r2)
        inner = u * px + v * py
        D11 = s + phi * u * u
        D12 = phi * u * v
        D22 = s + phi * v * v
        tx = s * px + phi * u * inner
        ty = s * py + phi * v * inner
        ox, oy = phi * u, phi * v
    else:
        tx, ty = px, py

    inv = 1.0 / torch.clamp(torch.sqrt(tx * tx + ty * ty), min=_EPS)
    inv3 = inv * inv * inv
    n11 = inv - tx * tx * inv3
    n12 = -tx * ty * inv3
    n22 = inv - ty * ty * inv3

    cols: List[List[Tensor]] = [[], []]

    # gravity block: J_t2abc = D @ [[1, 0, -u], [0, 1, -v]]
    if has_dist:
        t_abc = ((D11, D12, -(D11 * u + D12 * v)), (D12, D22, -(D12 * u + D22 * v)))
    else:
        one, zero = torch.ones_like(u), torch.zeros_like(u)
        t_abc = ((one, zero, -u), (zero, one, -v))
    m = _manifold_planes(gravity, spherical, M)
    for d in range(2):
        td0 = t_abc[0][0] * m[0][d] + t_abc[0][1] * m[1][d] + t_abc[0][2] * m[2][d]
        td1 = t_abc[1][0] * m[0][d] + t_abc[1][1] * m[1][d] + t_abc[1][2] * m[2][d]
        cols[0].append(n11 * td0 + n12 * td1)
        cols[1].append(n12 * td0 + n22 * td1)

    # focal block
    gx, gy = _focal_planes(camera, u, v, log_focal)
    if has_dist:
        J00 = px * ox + inner * (phi + 2.0 * dphi * u * u) + ox * px - cg * D11
        J01 = px * oy + inner * (2.0 * dphi * u * v) + ox * py - cg * D12
        J10 = py * ox + inner * (2.0 * dphi * v * u) + oy * px - cg * D12
        J11 = py * oy + inner * (phi + 2.0 * dphi * v * v) + oy * py - cg * D22
        tf0 = J00 * gx + J01 * gy
        tf1 = J10 * gx + J11 * gy
    else:
        tf0 = -cg * gx
        tf1 = -cg * gy
    cols[0].append(n11 * tf0 + n12 * tf1)
    cols[1].append(n12 * tf0 + n22 * tf1)

    # distortion block
    if has_dist:
        for dk, dpk in zip(spec.ds_dk(k1, k2, r2), spec.dphi_dk(k1, k2, r2)):
            pre0 = px * dk + dpk * inner * u
            pre1 = py * dk + dpk * inner * v
            cols[0].append(n11 * pre0 + n12 * pre1)
            cols[1].append(n12 * pre0 + n22 * pre1)
    return cols


def J_lat_planes(camera: Camera, gravity: Gravity, u: Tensor, v: Tensor,
                 spherical: bool = False, log_focal: bool = False,
                 M: Tensor = None) -> List[Tensor]:
    """Jacobian planes J[p] of sin(latitude), p < 3 + num_k."""
    a, b, cg = _gravity_planes(gravity)
    spec = _spec(camera.model)
    k1, k2 = _k_planes(camera)
    r2 = u * u + v * v
    su = spec.undistort_scale(k1, k2, r2)
    dsu = spec.dsu_dr2(k1, k2, r2)
    ud, vd = su * u, su * v

    inv = 1.0 / torch.sqrt(ud * ud + vd * vd + 1.0)
    inv3 = inv * inv * inv
    gw = a * ud + b * vd + cg
    e0 = a * inv - ud * gw * inv3
    e1 = b * inv - vd * gw * inv3

    cols: List[Tensor] = []
    m = _manifold_planes(gravity, spherical, M)
    for d in range(2):
        cols.append((ud * m[0][d] + vd * m[1][d] + m[2][d]) * inv)

    gx, gy = _focal_planes(camera, u, v, log_focal)
    dot = u * gx + v * gy
    jw0 = su * gx + 2.0 * dsu * u * dot
    jw1 = su * gy + 2.0 * dsu * v * dot
    cols.append(e0 * jw0 + e1 * jw1)

    for gam in spec.dsu_dk(k1, k2, r2):
        cols.append(gam * (e0 * u + e1 * v))
    return cols
