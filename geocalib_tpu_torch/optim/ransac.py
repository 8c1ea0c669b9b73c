"""RANSAC roll/pitch/focal solver from perspective fields.

Port of geocalib_tpu/optim/ransac.py: the closed-form minimal solver
(vertical vanishing point from two up-vector line crossings, focal from a
latitude sample quadratic, roll/pitch from the normalized abc vector) and
the batched hypothesis scoring on a strided pixel grid, chunk by chunk.

The samples come from the port's threefry (utils/threefry.py): ``split`` and
``randint`` give ``jax.random``'s pixel indices bit for bit, on any device.
The chunks are scored in a Python loop on the device with no host sync; each
keeps the earliest winner on ties, as the JAX scan does (first index of the
maximum within a chunk, a strict ``>`` across chunks), with a NaN score taken
as the maximum, as ``jnp.argmax`` takes it.
"""

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from geocalib_tpu_torch.geometry import planar_fields as pf
from geocalib_tpu_torch.geometry.camera import Camera
from geocalib_tpu_torch.geometry.gravity import Gravity
from geocalib_tpu_torch.utils.threefry import Key, prng_key, randint, split

Tensor = torch.Tensor
_EPS = 1e-9
_DEG = 180.0 / math.pi


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    n_iter: int = 1000
    chunk: int = 100  # hypotheses scored per chunk
    scoring_stride: int = 4  # score on every s-th pixel
    up_inlier_th: float = 1.0  # degrees
    latitude_inlier_th: float = 1.0  # degrees
    up_weight: float = 1.0
    latitude_weight: float = 1.0
    use_latitude: bool = True


# ------------------------- minimal solver ------------------------- #


def _up_line(xy: Tensor, up: Tensor) -> Tensor:
    """Homogeneous line through pixel xy along up direction: (xy,1) × (xy+up,1)."""
    x, y = xy[..., 0], xy[..., 1]
    ux, uy = up[..., 0], up[..., 1]
    return torch.stack([-uy, ux, x * uy - y * ux], dim=-1)


def _cross(a: Tensor, b: Tensor) -> Tensor:
    """a × b over the last axis, in jnp.cross's order of operations."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def vertical_vanishing_point(xy1: Tensor, up1: Tensor, xy2: Tensor, up2: Tensor) -> Tensor:
    """VVP = line1 × line2, normalized to z=1."""
    v = _cross(_up_line(xy1, up1), _up_line(xy2, up2))
    z = v[..., 2:3]
    return v / torch.where(z.abs() < _EPS, torch.sign(z) * _EPS + _EPS, z)


def _centered(vvp: Tensor, c: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    vx = vvp[..., 0] - c[..., 0:1] * vvp[..., 2]
    vy = vvp[..., 1] - c[..., 1:2] * vvp[..., 2]
    return vx, vy, vvp[..., 2]


def solve_focal(L: Tensor, xy: Tensor, vvp: Tensor, c: Tensor) -> Tuple[Tensor, Tensor]:
    """Focal from one sin-latitude sample + the VVP: the two roots in f² of
    a0 f⁴ + a1 f² + a2 = 0, as focals."""
    u = xy[..., 0] - c[..., 0:1]
    v = xy[..., 1] - c[..., 1:2]
    vx, vy, vz = _centered(vvp, c)
    L2 = L * L

    a0 = (L2 - 1) * (vz * vz)
    a1 = L2 * ((vz * vz) * (u * u + v * v) + vx * vx + vy * vy) - 2 * vz * (vx * u + vy * v)
    a2 = L2 * (v * v + u * u) * (vx * vx + vy * vy) - (u * vx + v * vy) * (u * vx + v * vy)

    a0 = torch.where(a0 == 0, 1e-6, a0)
    disc = torch.sqrt(torch.clamp(a1 * a1 - 4 * a0 * a2, min=0.0))
    f2_pos = (-a1 + disc) / (2 * a0)
    f2_neg = (-a1 - disc) / (2 * a0)
    return torch.sqrt(torch.maximum(f2_pos, _full(f2_pos, _EPS))), \
        torch.sqrt(torch.maximum(f2_neg, _full(f2_neg, _EPS)))


def _full(like: Tensor, value: float) -> Tensor:
    """A scalar of like's dtype and device, for the NaN-propagating max and min."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _clip(x: Tensor, lo: float, hi: float) -> Tensor:
    """jnp.clip: min(max(x, lo), hi), NaN kept."""
    return torch.minimum(torch.maximum(x, _full(x, lo)), _full(x, hi))


def solve_rp(vvp: Tensor, c: Tensor, f: Tensor) -> Tuple[Tensor, Tensor]:
    """Roll/pitch from the normalized abc vector."""
    vx, vy, vz = _centered(vvp, c)
    abc = torch.stack([vx / f, vy / f, vz], dim=-1)
    abc = abc / torch.maximum(torch.linalg.vector_norm(abc, dim=-1, keepdim=True), _full(abc, _EPS))
    a, cz = abc[..., 0], abc[..., 2]
    # gravity must point "down" in camera frame (b < 0): flip sign ambiguity
    flip = torch.where(abc[..., 1] > 0, -1.0, 1.0)
    a, cz = a * flip, cz * flip
    denom = torch.sqrt(torch.maximum(1 - cz * cz, _full(cz, _EPS)))
    roll = torch.arcsin(_clip(-a / denom, -1 + 1e-6, 1 - 1e-6))
    pitch = torch.arcsin(_clip(cz, -1 + 1e-6, 1 - 1e-6))
    return roll, pitch


# --------------------------- RANSAC loop --------------------------- #


class RansacResult(NamedTuple):
    camera: Camera
    gravity: Gravity
    score: Tensor  # (B,) inlier score of the winner
    rpf: Tensor  # (B, 3) roll, pitch, focal


def sample_pixels(B: int, n: int, h: int, w: int, key: Key, device) -> Tuple[Tensor, Tensor]:
    """The minimal samples' pixel indices xs, ys (B, n, 3), int64: the JAX solver's
    ``randint`` draws from the two halves of ``split(key)``, bit for bit."""
    kx, ky = split(key)
    return randint(kx, (B, n, 3), 0, w, device), randint(ky, (B, n, 3), 0, h, device)


def hypotheses(data: Dict[str, Tensor], xs: Tensor, ys: Tensor) -> Tensor:
    """(B, 2n, 3) roll, pitch, focal of every minimal sample: the positive roots of
    the focal quadratic, then the negative ones (or the prior focal twice), focals
    clipped to [0.1, 10]·max(h, w), NaN set to 0 and ±inf to ±1e6."""
    up_field = data["up_field"]
    B, h, w = up_field.shape[:3]
    bidx = torch.arange(B, device=up_field.device)[:, None, None]
    up = up_field[bidx, ys, xs]  # (B, n, 3, 2)
    xy = torch.stack([xs, ys], dim=-1).float()  # (B, n, 3, 2)
    c = torch.tensor([w / 2.0, h / 2.0], dtype=torch.float32, device=up.device).expand(B, 2)

    vvp = vertical_vanishing_point(xy[..., 0, :], up[..., 0, :], xy[..., 1, :], up[..., 1, :])
    if "prior_focal" in data:
        prior = torch.as_tensor(data["prior_focal"], dtype=torch.float32, device=up.device)
        f_pos = f_neg = prior[:, None].expand(B, xs.shape[1])
    else:
        lat = data["latitude_field"][bidx, ys, xs][..., 2, 0]  # (B, n)
        f_pos, f_neg = solve_focal(torch.sin(lat), xy[..., 2, :], vvp, c)

    hyps = []
    for f in (f_pos, f_neg):
        f = _clip(f, 0.1 * max(h, w), 10.0 * max(h, w))
        roll, pitch = solve_rp(vvp, c, f)
        hyps.append(torch.stack([roll, pitch, f], dim=-1))
    return torch.nan_to_num(torch.cat(hyps, dim=1), nan=0.0, posinf=1e6, neginf=-1e6)


def _score_chunk(rpf: Tensor, obs_upx: Tensor, obs_upy: Tensor, obs_lat: Optional[Tensor],
                 w_up: Tensor, w_lat: Optional[Tensor], h: int, w: int, stride: int,
                 cfg: RansacConfig) -> Tensor:
    """Inlier score for a chunk of hypotheses rpf (B, C, 3); returns (B, C)."""
    B, C = rpf.shape[:2]
    roll, pitch, focal = (rpf[..., i].reshape(B * C) for i in range(3))
    full = lambda v: torch.full((B * C,), v, dtype=torch.float32, device=rpf.device)
    cam = Camera.from_dict({"height": full(float(h)), "width": full(float(w)), "f": focal})
    grav = Gravity.from_rp(roll, pitch)

    u, v = pf.strided_grid(cam, h, w, stride)
    upx, upy = pf.up_planes(cam, grav, u, v)
    Ns = u.shape[-1]
    upx, upy = upx.reshape(B, C, Ns), upy.reshape(B, C, Ns)

    cosang = torch.clamp(upx * obs_upx[:, None] + upy * obs_upy[:, None], -1.0, 1.0)
    up_err = torch.arccos(cosang) * _DEG
    score = cfg.up_weight * torch.sum((up_err < cfg.up_inlier_th) * w_up[:, None], dim=-1)

    if obs_lat is not None:
        sinlat = pf.sinlat_planes(cam, grav, u, v).reshape(B, C, Ns)
        lat_err = torch.abs(torch.arcsin(torch.clamp(sinlat, -1, 1)) - obs_lat[:, None]) * _DEG
        score = score + cfg.latitude_weight * torch.sum(
            (lat_err < cfg.latitude_inlier_th) * w_lat[:, None], dim=-1)
    return score


def argmax_first(x: Tensor) -> Tensor:
    """jnp.argmax over the last axis: the first index of the maximum, a NaN counted as
    larger than any number (so the first NaN wins), whatever torch's kernel does with
    NaN on the device."""
    nan = torch.isnan(x)
    return torch.where(nan.any(-1), nan.to(torch.uint8).argmax(-1),
                       torch.argmax(torch.where(nan, -math.inf, x), dim=-1))


def observation_planes(data: Dict[str, Tensor], cfg: RansacConfig):
    """The observed planes on the scoring grid: (obs_upx, obs_upy, obs_lat, w_up, w_lat),
    (B, Ns) each, the latitude pair None when it is not used."""
    up_field, s = data["up_field"], cfg.scoring_stride
    B = up_field.shape[0]
    obs_up = up_field[:, ::s, ::s].reshape(B, -1, 2)
    obs_upx, obs_upy = obs_up[..., 0], obs_up[..., 1]
    w_up = (data["up_confidence"][:, ::s, ::s].reshape(B, -1) if "up_confidence" in data
            else torch.ones_like(obs_upx))
    if not (cfg.use_latitude and "latitude_field" in data):
        return obs_upx, obs_upy, None, w_up, None
    obs_lat = data["latitude_field"][:, ::s, ::s].reshape(B, -1)
    w_lat = (data["latitude_confidence"][:, ::s, ::s].reshape(B, -1)
             if "latitude_confidence" in data else torch.ones_like(obs_lat))
    return obs_upx, obs_upy, obs_lat, w_up, w_lat


def run_ransac(data: Dict[str, Tensor], cfg: RansacConfig = RansacConfig(),
               rng: Optional[Key] = None) -> RansacResult:
    """Estimate (roll, pitch, focal) per image by RANSAC over field samples.

    data: up_field (B, h, w, 2) [+ latitude_field, confidences, prior_focal], all
    on one device; rng a key pair (``PRNGKey(0)``'s by default).
    """
    up_field = data["up_field"]
    B, h, w = up_field.shape[:3]
    dev = up_field.device
    xs, ys = sample_pixels(B, cfg.n_iter, h, w, prng_key(0) if rng is None else rng, dev)
    rpf_all = hypotheses(data, xs, ys)
    planes = observation_planes(data, cfg)

    n_total, C = rpf_all.shape[1], cfg.chunk
    n_chunks = -(-n_total // C)
    rpf_pad = torch.cat([rpf_all, rpf_all.new_zeros(B, n_chunks * C - n_total, 3)], dim=1)

    best_score = torch.full((B,), -math.inf, device=dev)
    best_rpf = torch.zeros((B, 3), device=dev)
    for k in range(n_chunks):
        chunk_rpf = rpf_pad[:, k * C:(k + 1) * C]
        score = _score_chunk(chunk_rpf, *planes, h, w, cfg.scoring_stride, cfg)
        idx = argmax_first(score)
        sc = torch.take_along_dim(score, idx[:, None], 1)[:, 0]
        cand = torch.take_along_dim(chunk_rpf, idx[:, None, None], 1)[:, 0]
        better = sc > best_score
        best_score = torch.where(better, sc, best_score)
        best_rpf = torch.where(better[:, None], cand, best_rpf)

    full = lambda v: torch.full((B,), v, dtype=torch.float32, device=dev)
    camera = Camera.from_dict({"height": full(float(h)), "width": full(float(w)),
                               "f": best_rpf[:, 2]})
    gravity = Gravity.from_rp(best_rpf[:, 0], best_rpf[:, 1])
    return RansacResult(camera, gravity, best_score, best_rpf)
