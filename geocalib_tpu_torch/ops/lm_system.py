"""LM normal equations G, H and the mean cost in one pass over the pixels.

Port of geocalib_tpu/ops/lm_kernel.py (``lm_system_pallas``). ``lm_system``
launches the CUDA kernel of ``csrc/lm_system.cu`` (one launch per call, one
thread-block cluster per lane, no scratch tensor) for CUDA tensors and calls
``lm_system_plain``, the same math in plain PyTorch on (B, N) planes, for CPU
tensors. Forward only: the kernel has no backward yet, so on CUDA tensors
``lm_system`` refuses inputs that require grad while grad is enabled.
"""

import ctypes
from typing import Dict, Optional, Tuple

import torch

from geocalib_tpu_torch.geometry import planar_fields as pf
from geocalib_tpu_torch.geometry.camera import Camera
from geocalib_tpu_torch.geometry.gravity import Gravity
from geocalib_tpu_torch.ops import build, refuse_autograd
from geocalib_tpu_torch.optim.losses import get_loss_fn, scaled_loss

Tensor = torch.Tensor

OBS_KEYS = ("up_x", "up_y", "lat_sin", "up_conf", "lat_conf")
LOSS_IDS = {"squared": 0, "huber": 1, "barron": 2}
MODEL_IDS = {"pinhole": 0, "simple_radial": 1, "radial": 2, "simple_divisional": 3}


def _options(cfg, spherical: Optional[bool], log_focal: Optional[bool]):
    spherical = cfg.use_spherical_manifold if spherical is None else spherical
    log_focal = cfg.use_log_focal if log_focal is None else log_focal
    return spherical, log_focal


def lm_system_plain(obs: Dict[str, Tensor], camera: Camera, gravity: Gravity, h: int, w: int,
                    cfg, spherical: Optional[bool] = None, log_focal: Optional[bool] = None
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """G (B, P), H (B, P, P) and the mean cost (B,) on full (B, N) planes."""
    spherical, log_focal = _options(cfg, spherical, log_focal)
    loss_fn = get_loss_fn(cfg.loss_fn)
    mask = cfg.param_mask
    P = cfg.num_params
    u, v = pf.make_grid(camera, h, w)
    M = pf.manifold_matrix(gravity, spherical)
    B, N = u.shape

    channels = []  # (residual, weight, J columns)
    cost = u.new_zeros((B,))
    if "up_x" in obs:
        pred_x, pred_y = pf.up_planes(camera, gravity, u, v)
        r_up = (obs["up_x"] - pred_x, obs["up_y"] - pred_y)
        c, w_up, _ = scaled_loss(r_up[0] ** 2 + r_up[1] ** 2, loss_fn, cfg.up_loss_fn_scale)
        if "up_conf" in obs:
            c = c * obs["up_conf"]
            w_up = w_up * obs["up_conf"]
        cost = cost + c.sum(-1)
        J_up = pf.J_up_planes(camera, gravity, u, v, spherical, log_focal, M)
        channels += [(r_up[0], w_up, J_up[0]), (r_up[1], w_up, J_up[1])]
    if "lat_sin" in obs:
        r_lat = obs["lat_sin"] - pf.sinlat_planes(camera, gravity, u, v)
        c, w_lat, _ = scaled_loss(r_lat**2, loss_fn, cfg.lat_loss_fn_scale)
        if "lat_conf" in obs:
            c = c * obs["lat_conf"]
            w_lat = w_lat * obs["lat_conf"]
        cost = cost + c.sum(-1)
        J_lat = pf.J_lat_planes(camera, gravity, u, v, spherical, log_focal, M)
        channels.append((r_lat, w_lat, J_lat))

    G = u.new_zeros((B, P))
    H = u.new_zeros((B, P, P))
    for r, wts, J in channels:
        Jm = torch.stack([J[p] * mask[p] for p in range(P)], dim=1)  # (B, P, N)
        Jw = Jm * wts[:, None, :]
        G = G + torch.einsum("bpn,bn->bp", Jw, r)
        H = H + torch.einsum("bpn,bqn->bpq", Jw, Jm)
    return G, H, cost / N


def lm_system(obs: Dict[str, Tensor], camera: Camera, gravity: Gravity, h: int, w: int, cfg,
              spherical: Optional[bool] = None, log_focal: Optional[bool] = None
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """G (B, P), H (B, P, P) and the mean cost (B,) at the current estimate.

    obs: any of ``OBS_KEYS``, each (B, N = h*w) float32. CPU tensors go to
    ``lm_system_plain``; CUDA tensors launch the kernel or raise.
    """
    dev = camera.f.device
    if dev.type == "cpu":
        return lm_system_plain(obs, camera, gravity, h, w, cfg, spherical, log_focal)
    if dev.type != "cuda":
        raise ValueError(f"lm_system runs on CPU or CUDA tensors, not {dev}")
    spherical, log_focal = _options(cfg, spherical, log_focal)
    if cfg.loss_fn not in LOSS_IDS:
        raise ValueError(f"unknown loss {cfg.loss_fn!r}")
    unknown = set(obs) - set(OBS_KEYS)
    if unknown:
        raise ValueError(f"unknown observation planes {sorted(unknown)}")

    B = camera.f.shape[0]
    N = h * w
    for key, t in obs.items():
        if t.device != dev or t.dtype != torch.float32 or t.shape != (B, N):
            raise ValueError(f"{key}: expected float32 (B={B}, N={N}) on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{key} must be contiguous")
    if ("up_x" in obs) != ("up_y" in obs):
        raise ValueError("up_x and up_y come together")
    refuse_autograd("lm_system", *obs.values(), camera.data, gravity.vec3d)

    cam = camera.data.to(torch.float32).contiguous()
    grav = gravity.vec3d.to(torch.float32).contiguous()
    M = pf.manifold_matrix(gravity, spherical).to(torch.float32).reshape(B, 6).contiguous()
    return launch(obs, cam, grav, M, camera.model, w, cfg, log_focal)


def launch(obs: Dict[str, Tensor], cam: Tensor, grav: Tensor, M: Tensor, model: str, w: int,
           cfg, log_focal: bool) -> Tuple[Tensor, Tensor, Tensor]:
    """One launch of the kernel on checked inputs: cam (B, 8), grav (B, 3), M (B, 6)."""
    B, N = next(iter(obs.values())).shape
    dev = cam.device
    P = cfg.num_params
    G = torch.empty((B, P), dtype=torch.float32, device=dev)
    H = torch.empty((B, P, P), dtype=torch.float32, device=dev)
    cost = torch.empty((B,), dtype=torch.float32, device=dev)
    mask_bits = sum(1 << p for p, m in enumerate(cfg.param_mask) if m)
    code = build.lib().gc_lm_system(
        *(build.ptr(obs.get(k)) for k in OBS_KEYS),
        cam.data_ptr(), grav.data_ptr(), M.data_ptr(), G.data_ptr(), H.data_ptr(),
        cost.data_ptr(), B, N, w, MODEL_IDS[model], P,
        LOSS_IDS[cfg.loss_fn], cfg.up_loss_fn_scale, cfg.lat_loss_fn_scale, mask_bits,
        int(log_focal), torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "gc_lm_system")
    lm_system.launches += 1
    lm_system.launches_by_model[model] += 1
    return G, H, cost


def kernel_config(w: int) -> Dict[str, int]:
    """The built kernel's threads per block, blocks per lane (one cluster), and how many
    clusters (lanes) the card holds at once at w columns."""
    threads, cluster, active = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    build.check(build.lib().gc_lm_config(ctypes.byref(threads), ctypes.byref(cluster),
                                         ctypes.byref(active), w), "gc_lm_config")
    return {"threads": threads.value, "cluster": cluster.value, "active_clusters": active.value}


lm_system.launches = 0
lm_system.launches_by_model = dict.fromkeys(MODEL_IDS, 0)
