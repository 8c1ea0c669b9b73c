"""Batched Levenberg-Marquardt solver for camera calibration (forward).

Port of geocalib_tpu/optim/lm.py: a fixed number of iterations with
per-lane convergence freezing, priors as static parameter masks, the damped
normal equations solved by an unrolled Cholesky (or, with shared
intrinsics, by a Schur complement over the arrow-shaped system), and the
uncertainty from the inverse Hessian in (roll, pitch, focal) space. Each
iteration's normal equations come from one pass of ``ops.lm_system`` (the
CUDA kernel on the card), and that pass's cost is the "new cost" of the
previous iteration, so the λ and convergence bookkeeping is deferred by one
iteration exactly as in the JAX solver.

All four camera models, the trivial and heuristic inits and shared
intrinsics are ported. Not ported yet (asking for it raises
NotImplementedError): the backward paths (``grad_mode="ift"``; the kernel
has no VJP).
"""

import dataclasses
import math
from typing import Dict, NamedTuple, Tuple

import torch

from geocalib_tpu_torch.geometry.camera import NUM_DIST_PARAMS, Camera
from geocalib_tpu_torch.geometry.gravity import Gravity
from geocalib_tpu_torch.geometry.jacobians import J_focal2fov
from geocalib_tpu_torch.ops.lm_system import lm_system
from geocalib_tpu_torch.optim import linalg
from geocalib_tpu_torch.utils.conversions import focal2fov

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Static solver configuration; defaults are the reference inference preset."""

    camera_model: str = "pinhole"
    shared_intrinsics: bool = False
    num_steps: int = 30
    lambda_: float = 0.1
    fix_lambda: bool = False
    early_stop: bool = True
    atol: float = 1e-8
    rtol: float = 1e-8
    use_spherical_manifold: bool = True
    use_log_focal: bool = True
    up_loss_fn_scale: float = 1e-2
    lat_loss_fn_scale: float = 1e-2
    loss_fn: str = "huber"
    use_up: bool = True
    use_latitude: bool = True
    init_mode: str = "trivial"  # "trivial" | "heuristic"
    estimate_gravity: bool = True
    estimate_focal: bool = True
    estimate_dist: bool = True
    with_uncertainty: bool = True
    grad_mode: str = "unroll"

    def __post_init__(self):
        if self.camera_model not in NUM_DIST_PARAMS:
            raise ValueError(f"Unknown camera model {self.camera_model!r}")
        if self.init_mode not in ("trivial", "heuristic"):
            raise ValueError(f"Unknown init_mode {self.init_mode!r}")
        if self.grad_mode != "unroll":
            raise NotImplementedError(f"grad_mode {self.grad_mode!r} is not ported yet")

    @property
    def num_dist(self) -> int:
        return NUM_DIST_PARAMS[self.camera_model]

    @property
    def num_params(self) -> int:
        """P = 2 (gravity) + 1 (focal) + K."""
        return 3 + self.num_dist

    @property
    def opt_dist(self) -> bool:
        return self.estimate_dist and self.num_dist > 0

    @property
    def param_mask(self) -> Tuple[float, ...]:
        """Static 0/1 mask over [g0, g1, f, k...]."""
        m = [float(self.estimate_gravity)] * 2 + [float(self.estimate_focal)]
        return tuple(m + [float(self.opt_dist)] * self.num_dist)


class LMResult(NamedTuple):
    camera: Camera
    gravity: Gravity
    info: Dict[str, Tensor]


def flatten_observations(data: Dict[str, Tensor], cfg: LMConfig
                         ) -> Tuple[Dict[str, Tensor], int, int]:
    """Planar observations {up_x, up_y, lat_sin, up_conf, lat_conf} (B, N) from
    channel-last (B, h, w, C) fields; latitude residuals live in sin space."""
    ref = data["up_field"] if "up_field" in data else data["latitude_field"]
    B, h, w = ref.shape[0], ref.shape[1], ref.shape[2]
    N = h * w
    f32 = lambda t: t.reshape(B, N).to(torch.float32).contiguous()
    obs = {}
    if cfg.use_up and "up_field" in data:
        up = data["up_field"].reshape(B, N, 2)
        obs["up_x"], obs["up_y"] = f32(up[..., 0]), f32(up[..., 1])
        if "up_confidence" in data:
            obs["up_conf"] = f32(data["up_confidence"])
    if cfg.use_latitude and "latitude_field" in data:
        obs["lat_sin"] = f32(torch.sin(data["latitude_field"].reshape(B, N).float()))
        if "latitude_confidence" in data:
            obs["lat_conf"] = f32(data["latitude_confidence"])
    assert "up_x" in obs or "lat_sin" in obs, "No observations provided"
    return obs, h, w


def get_trivial_estimation(data: Dict[str, Tensor], cfg: LMConfig) -> Tuple[Camera, Gravity]:
    """roll = pitch = 0, f = 0.7·max(h, w); priors override."""
    ref = data["up_field"] if "up_field" in data else data["latitude_field"]
    B, h, w = ref.shape[0], ref.shape[1], ref.shape[2]
    dev = ref.device
    batch_h = torch.full((B,), float(h), device=dev)
    batch_w = torch.full((B,), float(w), device=dev)
    focal = data.get("prior_focal", torch.full((B,), 0.7 * float(max(h, w)), device=dev))
    vfov = focal2fov(torch.as_tensor(focal, dtype=torch.float32, device=dev), batch_h)

    params = {"width": batch_w, "height": batch_h, "vfov": vfov}
    if "scales" in data:
        params["scales"] = data["scales"]
    if "prior_dist" in data:
        params["dist"] = data["prior_dist"]
    camera = Camera.from_dict(params, model=cfg.camera_model)

    if "prior_gravity" in data:
        pg = data["prior_gravity"]
        gravity = pg if isinstance(pg, Gravity) else Gravity.from_vec3d(pg)
    else:
        zeros = torch.zeros((B,), device=dev)
        gravity = Gravity.from_rp(zeros, zeros)
    return camera, gravity


def get_heuristic_estimation(data: Dict[str, Tensor], cfg: LMConfig
                             ) -> Tuple[Camera, Gravity]:
    """Initial estimate from the fields: roll from the centre up vector, pitch from
    the centre latitude, vFoV from the top-to-bottom latitude span; priors override."""
    up = data["up_field"]
    lat = data["latitude_field"]
    B, h, w = up.shape[0], up.shape[1], up.shape[2]
    dev = up.device
    lim = math.radians(45.0)

    up_c = up[:, h // 2, w // 2]  # (B, 2)
    init_r = torch.clamp(-torch.atan2(up_c[..., 0], -up_c[..., 1]), -lim, lim)
    init_p = torch.clamp(lat[:, h // 2, w // 2, 0], -lim, lim)
    init_vfov = torch.clamp(torch.abs(lat[:, 0, w // 2, 0] - lat[:, -1, w // 2, 0]),
                            math.radians(20.0), math.radians(120.0))

    params = {"width": torch.full((B,), float(w), device=dev),
              "height": torch.full((B,), float(h), device=dev), "vfov": init_vfov}
    if "prior_focal" in data:
        params["f"] = torch.as_tensor(data["prior_focal"], dtype=torch.float32, device=dev)
        del params["vfov"]
    if "scales" in data:
        params["scales"] = data["scales"]
    if "prior_dist" in data:
        params["dist"] = data["prior_dist"]
    camera = Camera.from_dict(params, model=cfg.camera_model)

    if "prior_gravity" in data:
        pg = data["prior_gravity"]
        gravity = pg if isinstance(pg, Gravity) else Gravity.from_vec3d(pg)
    else:
        gravity = Gravity.from_rp(init_r, init_p)
    return camera, gravity


def resolve_priors(data: Dict[str, Tensor], cfg: LMConfig) -> LMConfig:
    """Turn off the estimate_* flags of every prior given in `data`."""
    return dataclasses.replace(
        cfg,
        estimate_gravity=cfg.estimate_gravity and "prior_gravity" not in data,
        estimate_focal=cfg.estimate_focal and "prior_focal" not in data,
        estimate_dist=cfg.estimate_dist and "prior_dist" not in data,
    )


def _update_estimate(camera: Camera, gravity: Gravity, delta: Tensor, cfg: LMConfig
                     ) -> Tuple[Camera, Gravity]:
    if cfg.estimate_gravity:
        gravity = gravity.update(delta[..., :2], spherical=cfg.use_spherical_manifold)
    if cfg.estimate_focal:
        camera = camera.update_focal(delta[..., 2:3], as_log=cfg.use_log_focal)
    if cfg.opt_dist:
        camera = camera.update_dist(delta[..., 3 : 3 + cfg.num_dist])
    return camera, gravity


def _select(mask: Tensor, a: Tensor, b: Tensor) -> Tensor:
    return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim)), a, b)


def _solve_damped(G: Tensor, H: Tensor, lamb: Tensor, cfg: LMConfig) -> Tensor:
    """Damped normal-equation solve; the arrow solve when the intrinsics are shared.

    With shared intrinsics λ is one scalar lane. The gravity blocks are damped
    per image; the intrinsics block S is rebuilt from the undamped blocks summed
    over the batch and damped on that summed diagonal.
    """
    if not cfg.shared_intrinsics:
        return linalg.cholesky_solve_small(linalg.damp_hessian(H, lamb), G)
    Hd = linalg.damp_hessian(H, lamb.expand(H.shape[:1]))
    D, U = Hd[:, :2, :2], Hd[:, :2, 2:]
    S_raw = H[:, 2:, 2:].sum(0)
    g_i = G[:, 2:].sum(0)
    diag = torch.diagonal(S_raw, dim1=-2, dim2=-1)
    S = S_raw + torch.diag(torch.clamp(diag * lamb, min=1e-6))
    x_g, x_i = linalg.solve_arrow(D, U, S, G[:, :2], g_i)
    return torch.cat([x_g, x_i.expand((G.shape[0],) + x_i.shape)], dim=-1)


def _update_lambda(lamb: Tensor, prev_cost: Tensor, new_cost: Tensor) -> Tensor:
    """×10 on a cost increase, ×0.1 on a decrease, clamped to [1e-6, 1e2]."""
    factor = torch.where(new_cost > prev_cost, 10.0, 0.1)
    return torch.clamp(lamb * factor, 1e-6, 1e2)


def run_lm(data: Dict[str, Tensor], cfg: LMConfig) -> LMResult:
    """Calibrate from channel-last fields "up_field" (B, h, w, 2), "latitude_field"
    (B, h, w, 1), optional confidences (B, h, w), priors "prior_gravity",
    "prior_focal", "prior_dist" and "scales"."""
    cfg = resolve_priors(data, cfg)
    obs, h, w = flatten_observations(data, cfg)
    if cfg.init_mode == "heuristic" and "up_field" in data and "latitude_field" in data:
        camera0, gravity0 = get_heuristic_estimation(data, cfg)
    else:
        camera0, gravity0 = get_trivial_estimation(data, cfg)
    camera, gravity, info = optimize(obs, camera0, gravity0, h, w, cfg)
    info["initial_vfov"] = camera0.vfov
    return LMResult(camera, gravity, info)


def optimize(obs: Dict[str, Tensor], camera: Camera, gravity: Gravity, h: int, w: int,
             cfg: LMConfig) -> Tuple[Camera, Gravity, Dict[str, Tensor]]:
    """The LM loop, then the final cost and uncertainty at the optimum.

    With shared intrinsics, λ, the convergence test and stop_at are one lane
    for the whole batch, on the batch-mean cost; λ stays at its initial value
    (the reference freezes it in that mode), and no lane is frozen alone.
    """
    B = camera.f.shape[0]
    dev = camera.f.device
    shared = cfg.shared_intrinsics
    L = 1 if shared else B  # lanes of the bookkeeping
    lamb = torch.full((L,), cfg.lambda_, device=dev)
    prev_cost = torch.zeros((L,), device=dev)
    converged = torch.zeros((L,), dtype=torch.bool, device=dev)
    stop_at = torch.full((L,), float(cfg.num_steps), device=dev)
    initial_cost = torch.zeros((B,), device=dev)

    for it in range(cfg.num_steps):
        G, H, cost_lane = lm_system(obs, camera, gravity, h, w, cfg)
        cost = cost_lane.mean(0, keepdim=True) if shared else cost_lane
        if it == 0:
            initial_cost = cost_lane
            conv_now = torch.zeros_like(converged)
        else:
            # bookkeeping deferred from the previous iteration: this cost is its "new cost"
            if not cfg.fix_lambda and not shared:
                lamb = torch.where(converged, lamb, _update_lambda(lamb, prev_cost, cost))
            conv_now = torch.abs(cost - prev_cost) <= cfg.atol + cfg.rtol * torch.abs(prev_cost)
        stop_at = torch.where(~converged & conv_now, float(it), stop_at)
        converged = converged | conv_now

        delta = _solve_damped(G, H, lamb, cfg)
        if cfg.early_stop:
            delta = torch.where(converged[:, None], 0.0, delta)
        new_camera, new_gravity = _update_estimate(camera, gravity, delta, cfg)
        if cfg.early_stop and not shared:
            new_camera = Camera(*(_select(converged, a, b) for a, b in zip(
                (camera.size, camera.f, camera.c, camera.k),
                (new_camera.size, new_camera.f, new_camera.c, new_camera.k))), camera.model)
            new_gravity = Gravity(_select(converged, gravity.vec3d, new_gravity.vec3d))
        camera, gravity, prev_cost = new_camera, new_gravity, cost

    # final cost, and H in (roll, pitch, focal) space for the uncertainty
    _, H_rpf, final_cost = lm_system(obs, camera, gravity, h, w, cfg,
                                     spherical=False, log_focal=False)
    info = {"initial_cost": initial_cost, "stop_at": stop_at.expand(B), "final_cost": final_cost}
    if cfg.with_uncertainty:
        info.update(estimate_uncertainty(camera, H_rpf, cfg))
    return camera, gravity, info


def estimate_uncertainty(camera: Camera, H: Tensor, cfg: LMConfig) -> Dict[str, Tensor]:
    """Covariance from the inverse of the (roll, pitch, focal, dist) Hessian.

    The focal/vFoV formulas are asymmetric on purpose (/2 outside the sqrt
    for focal, inside for vFoV), copied verbatim from the JAX solver, which
    copies the reference's published formulas.
    """
    mask = torch.tensor(cfg.param_mask, dtype=H.dtype, device=H.device)
    Cov = linalg.inv_small(H + torch.diag(1.0 - mask))
    zeros = torch.zeros(H.shape[:1], dtype=H.dtype, device=H.device)
    if cfg.estimate_gravity:
        roll_u, pitch_u = Cov[..., 0, 0], Cov[..., 1, 1]
        gravity_u = linalg.max_eig_2x2(Cov[..., :2, :2])
    else:
        roll_u = pitch_u = gravity_u = zeros
    if cfg.estimate_focal:
        focal_u = Cov[..., 2, 2]
        fov_u = J_focal2fov(camera.f[..., 1], camera.size[..., 1]) ** 2 * focal_u
    else:
        focal_u = fov_u = zeros
    relu = lambda t: torch.clamp(t, min=0.0)
    return {
        "covariance": Cov,
        "roll_uncertainty": torch.sqrt(relu(roll_u)),
        "pitch_uncertainty": torch.sqrt(relu(pitch_u)),
        "gravity_uncertainty": torch.sqrt(relu(gravity_u)),
        "focal_uncertainty": torch.sqrt(relu(focal_u)) / 2.0,
        "vfov_uncertainty": torch.sqrt(relu(fov_u) / 2.0),
    }
