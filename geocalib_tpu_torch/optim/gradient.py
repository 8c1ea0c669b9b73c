"""First-order (Adam) calibration baseline over (roll, pitch, vfov).

Port of geocalib_tpu/optim/gradient.py: Adam steps on (roll, pitch, vFoV)
against the observed fields with a per-lane plateau scale of the step, in a
plain loop of ``num_steps`` with torch.autograd, batched over lanes.

As in the JAX package:
- the gradient is that of the cost summed over lanes;
- the optimizer is optax's ``adam(1.0)`` (b1 0.9, b2 0.999, eps 1e-8,
  eps_root 0, bias-corrected), its update scaled per lane by the lane's rate;
- ``costs[k]`` is the per-lane cost before step k's update;
- the vFoV clip is min(max(v, 5°), 170°), whose gradient at a bound is 1/2,
  as JAX's gradient of ``jnp.clip`` there (torch's maximum and minimum split
  a tie's gradient in halves; ``torch.clamp`` would pass all of it).
"""

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from geocalib_tpu_torch.geometry import planar_fields as pf
from geocalib_tpu_torch.geometry.camera import Camera
from geocalib_tpu_torch.geometry.gravity import Gravity

Tensor = torch.Tensor

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
VFOV_RANGE = (math.radians(5.0), math.radians(170.0))


@dataclasses.dataclass(frozen=True)
class GDConfig:
    num_steps: int = 100
    lr: float = 0.05
    plateau_patience: int = 10
    plateau_factor: float = 0.5
    use_latitude: bool = True


class GDResult(NamedTuple):
    camera: Camera
    gravity: Gravity
    costs: Tensor  # (num_steps, B)


def _clip_vfov(vfov: Tensor) -> Tensor:
    lo, hi = (torch.full((), v, dtype=vfov.dtype, device=vfov.device) for v in VFOV_RANGE)
    return torch.minimum(torch.maximum(vfov, lo), hi)


def _camera(vfov: Tensor, h: int, w: int) -> Camera:
    full = lambda v: torch.full(vfov.shape, v, dtype=torch.float32, device=vfov.device)
    return Camera.from_dict({"height": full(float(h)), "width": full(float(w)),
                             "vfov": _clip_vfov(vfov)})


def _cost(params: Tensor, planes: Tuple[Tensor, Tensor, Optional[Tensor]], h: int, w: int,
          use_latitude: bool) -> Tensor:
    """Per-image field mismatch for params (B, 3) = (roll, pitch, vfov)."""
    obs_upx, obs_upy, obs_lat = planes
    cam = _camera(params[:, 2], h, w)
    grav = Gravity.from_rp(params[:, 0], params[:, 1])
    u, v = pf.make_grid(cam, h, w)
    upx, upy = pf.up_planes(cam, grav, u, v)
    dx, dy = upx - obs_upx, upy - obs_upy
    cost = (dx * dx + dy * dy).mean(-1)
    if use_latitude and obs_lat is not None:
        d = pf.sinlat_planes(cam, grav, u, v) - torch.sin(obs_lat)
        cost = cost + (d * d).mean(-1)
    return cost


def run_gradient_descent(data: Dict[str, Tensor], cfg: GDConfig = GDConfig()) -> GDResult:
    """Adam-optimize (roll, pitch, vfov) against the observed fields (on their device)."""
    up = data["up_field"]
    B, h, w = up.shape[:3]
    dev = up.device
    up_flat = up.reshape(B, -1, 2)
    obs_lat = (data["latitude_field"].reshape(B, -1)
               if cfg.use_latitude and "latitude_field" in data else None)
    planes = (up_flat[..., 0], up_flat[..., 1], obs_lat)

    params = torch.stack([torch.zeros(B, device=dev), torch.zeros(B, device=dev),
                          torch.full((B,), 1.0, device=dev)], dim=-1)
    mu, nu = torch.zeros_like(params), torch.zeros_like(params)
    lr = torch.full((B,), cfg.lr, device=dev)
    best = torch.full((B,), math.inf, device=dev)
    since = torch.zeros((B,), dtype=torch.int32, device=dev)
    b1, b2 = (torch.full((), b, dtype=torch.float32, device=dev) for b in (ADAM_B1, ADAM_B2))
    costs = []
    for step in range(1, cfg.num_steps + 1):
        p = params.detach().requires_grad_()
        cost_lanes = _cost(p, planes, h, w, cfg.use_latitude)
        (grads,) = torch.autograd.grad(cost_lanes.sum(), p)
        cost_lanes = cost_lanes.detach()
        # optax.adam(1.0): moments, bias correction, then the unit rate's -1 scale
        mu = (1 - ADAM_B1) * grads + ADAM_B1 * mu
        nu = (1 - ADAM_B2) * (grads * grads) + ADAM_B2 * nu
        count = torch.full((), float(step), dtype=torch.float32, device=dev)
        mu_hat = mu / (1 - torch.pow(b1, count))
        nu_hat = nu / (1 - torch.pow(b2, count))
        updates = -1.0 * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
        params = params + lr[:, None] * updates

        improved = cost_lanes < best - 1e-8
        since = torch.where(improved, 0, since + 1)
        best = torch.minimum(best, cost_lanes)
        plateau = since >= cfg.plateau_patience
        lr = torch.where(plateau, lr * cfg.plateau_factor, lr)
        since = torch.where(plateau, 0, since)
        costs.append(cost_lanes)

    return GDResult(_camera(params[:, 2], h, w), Gravity.from_rp(params[:, 0], params[:, 1]),
                    torch.stack(costs))
