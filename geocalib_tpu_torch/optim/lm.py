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
intrinsics are ported, and both ways gradients flow through the solver
(``grad_mode``): "unroll" differentiates every iteration, each system
through the VJP of ``ops.lm_system``; "ift" runs the loop on detached
observations and attaches implicit-function-theorem gradients at the fixed
point (``IFTTheta``, the mirror of the JAX ``_ift_theta``).

With shared intrinsics and a data-parallel mesh (``LMConfig.mesh``, the JAX
``axis_name``), the batch's lanes are split over the ranks and share one
camera: the intrinsic blocks of the normal equations, the Schur corrections
and the batch-mean cost are summed over the ranks, so that every rank solves
the same coupled system, in the loop and in the IFT adjoint solve. The LM
kernel still computes each rank's G, H and cost.
"""

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from geocalib_tpu_torch.geometry.camera import NUM_DIST_PARAMS, Camera
from geocalib_tpu_torch.geometry.gravity import Gravity
from geocalib_tpu_torch.geometry.jacobians import J_focal2fov
from geocalib_tpu_torch.ops.lm_system import lm_system, lm_system_plain
from geocalib_tpu_torch.optim import linalg
from geocalib_tpu_torch.parallel.mesh import Mesh, mean_over_ranks, sum_over_ranks
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
    grad_mode: str = "unroll"  # "unroll" | "ift"
    # the mesh the batch is split over; with shared_intrinsics the intrinsic blocks
    # and the batch-mean cost are summed over its ranks (the JAX config's axis_name)
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        if self.camera_model not in NUM_DIST_PARAMS:
            raise ValueError(f"Unknown camera model {self.camera_model!r}")
        if self.init_mode not in ("trivial", "heuristic"):
            raise ValueError(f"Unknown init_mode {self.init_mode!r}")
        if self.grad_mode not in ("unroll", "ift"):
            raise ValueError(f"Unknown grad_mode {self.grad_mode!r}")

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
    over the batch and damped on that summed diagonal. With a mesh, the batch is
    the whole batch over the ranks: S, g_i and the Schur corrections are summed
    over them.
    """
    if not cfg.shared_intrinsics:
        return linalg.cholesky_solve_small(linalg.damp_hessian(H, lamb), G)
    Hd = linalg.damp_hessian(H, lamb.expand(H.shape[:1]))
    D, U = Hd[:, :2, :2], Hd[:, :2, 2:]
    mesh = cfg.mesh
    cross = None if mesh is None else (lambda t: sum_over_ranks(t, mesh))
    S_raw = sum_over_ranks(H[:, 2:, 2:].sum(0), mesh)
    g_i = sum_over_ranks(G[:, 2:].sum(0), mesh)
    diag = torch.diagonal(S_raw, dim1=-2, dim2=-1)
    S = S_raw + torch.diag(torch.clamp(diag * lamb, min=1e-6))
    x_g, x_i = linalg.solve_arrow(D, U, S, G[:, :2], g_i, cross_sum=cross)
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
    With ``grad_mode="ift"`` the loop sees detached observations, and a zero
    step from ``IFTTheta`` carries the gradients of the fixed point.
    """
    if cfg.grad_mode == "ift":
        loop_obs = {k: v.detach() for k, v in obs.items()}
        camera, gravity, info = _optimize_loop(loop_obs, camera, gravity, h, w, cfg)
        keys = tuple(obs)
        theta = IFTTheta.apply((keys, camera.model, h, w, cfg), camera.data, gravity.vec3d,
                               *(obs[k] for k in keys))
        camera, gravity = _update_estimate(camera, gravity, theta, cfg)
    else:
        camera, gravity, info = _optimize_loop(obs, camera, gravity, h, w, cfg)

    # final cost, and H in (roll, pitch, focal) space for the uncertainty
    _, H_rpf, final_cost = lm_system(obs, camera, gravity, h, w, cfg,
                                     spherical=False, log_focal=False)
    info["final_cost"] = final_cost
    if cfg.with_uncertainty:
        info.update(estimate_uncertainty(camera, H_rpf, cfg))
    return camera, gravity, info


def _optimize_loop(obs: Dict[str, Tensor], camera: Camera, gravity: Gravity, h: int, w: int,
                   cfg: LMConfig) -> Tuple[Camera, Gravity, Dict[str, Tensor]]:
    """The fixed-length loop with per-lane freezing: the estimate, the initial
    cost and stop_at."""
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
        cost = mean_over_ranks(cost_lane.mean(0, keepdim=True), cfg.mesh) if shared else cost_lane
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
    return camera, gravity, {"initial_cost": initial_cost, "stop_at": stop_at.expand(B)}


class IFTTheta(torch.autograd.Function):
    """A zero step (B, P) that carries the implicit-function-theorem gradients
    dθ*/d obs at the converged estimate (the JAX ``_ift_theta``, optim/lm.py:611-667).

    Forward: zeros, so applying it with ``_update_estimate`` leaves the estimate
    as it is. Backward, the mirror of ``_ift_bwd``: H from ``lm_system_plain``
    at the solution (the loop's spherical/log-focal system), w = the damped
    solve of H w = ct with λ = 0, then the VJP of G with respect to the
    observations at θ = 0, against w. The camera and the gravity get no
    gradient through this step.
    """

    @staticmethod
    def forward(ctx, spec, cam_data: Tensor, vec3d: Tensor, *planes: Tensor) -> Tensor:
        ctx.spec = spec
        ctx.save_for_backward(cam_data, vec3d, *planes)
        cfg = spec[-1]
        return cam_data.new_zeros((cam_data.shape[0], cfg.num_params))

    @staticmethod
    def backward(ctx, ct: Tensor):
        keys, model, h, w, cfg = ctx.spec
        cam_data, vec3d, *planes = ctx.saved_tensors
        camera, gravity = Camera.from_data(cam_data, model), Gravity(vec3d)
        B = cam_data.shape[0]
        _, H, _ = lm_system_plain(dict(zip(keys, planes)), camera, gravity, h, w, cfg)
        lamb = H.new_zeros((1 if cfg.shared_intrinsics else B,))
        wvec = _solve_damped(ct, H, lamb, cfg)
        theta0 = H.new_zeros((B, cfg.num_params))
        camera, gravity = _update_estimate(camera, gravity, theta0, cfg)
        obs = {k: t.detach().requires_grad_() for k, t in zip(keys, planes)}
        with torch.enable_grad():
            G, _, _ = lm_system_plain(obs, camera, gravity, h, w, cfg)
            grads = torch.autograd.grad(G, list(obs.values()), wvec, allow_unused=True)
        return (None, None, None, *grads)


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
