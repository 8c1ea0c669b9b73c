#!/usr/bin/env python3
"""Smoke run of geocalib_tpu_torch on one CUDA card: the port still starts.

Builds the CUDA kernels from geocalib_tpu_torch/csrc, serves five
GeoCalib.calibrate requests at MSCAN-B width on the committed weights
(weights/geocalib_synth_r05.msgpack), one for each path:

  a  16 views at 480x640, pinhole
  b  one view, pinhole
  c  one view, simple_radial, a focal prior
  d  8 views of one camera, radial, shared intrinsics
  e  4 views through a division-model lens, simple_divisional, served by a
     second GeoCalib with the heuristic init

Each request's launch counts are set to 0 just before it and read just after,
and it must have launched both kernels (the LM kernel in its camera model's
instance). Then it holds each kernel against its plain PyTorch version at the
serving shapes of requests a, c, d and e, traces one LM kernel call with
torch.profiler (it must be one launch), times the NMF kernel and each of the
LM kernel's four model instances at request a's shape and at one lane of it,
checks that two NMF launches give the same bits, prints the registers and
spills of the kernels (and fails if a bf16 NMF stage spills), and ends with
the whole-path gate: requests a, c, d and e served again by the kernels and
by the plain versions, converged (the solver's early stop off, so every lane
runs all 30 iterations: roll, pitch and vFoV within 0.05 degrees in every
lane) and serving (early stop on, as users run it: lanes that stop at the
same iteration within 0.05 degrees of roll, pitch and vFoV; lanes that stop
apart must be one iteration apart, and are named).

Run from the repository root, on a machine with one card:

    python3 chip_smoke.py

It exits non-zero, and prints no result, without a card or outside the
repository. Every line is flushed as it is printed; the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import copy
import faulthandler
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

import geocalib_tpu_torch
from geocalib_tpu_torch.geometry import planar_fields as pf
from geocalib_tpu_torch.models import hamburger
from geocalib_tpu_torch.models.weights import params_from_jax, read_flax_msgpack
from geocalib_tpu_torch.ops import build, lm_system as lm_ops, nmf as nmf_ops
from geocalib_tpu_torch.optim import lm as lm_solver
from geocalib_tpu_torch.geometry.camera import Camera
from geocalib_tpu_torch.geometry.gravity import Gravity
from geocalib_tpu_torch.optim.lm import (LMConfig, flatten_observations, get_heuristic_estimation,
                                         get_trivial_estimation, resolve_priors)

ROOT = Path(__file__).resolve().parent
WEIGHTS = ROOT / "weights" / "geocalib_synth_r05.msgpack"

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the least-time bounds.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
# Float operations per pixel of the LM system with all five planes and the huber
# loss, counted by hand from its formulas (IEEE divisions and square roots): an
# FMA as two, a sqrt, division, negation, max or compare as one, a subexpression
# the model's functions share (q, sigma', sigma'' of the divisional model) once.
# The 0/1 parameter mask is not counted: it multiplies the lane's sums, not the
# pixels' Jacobian rows.
LM_FLOPS_PER_PIXEL = {"pinhole": 228, "simple_radial": 351, "radial": 425,
                      "simple_divisional": 383}
# The distortion of the camera each LM instance is timed with, at request a's shape.
LM_TIMING_K = {"pinhole": (0.0, 0.0), "simple_radial": (-0.1, 0.0), "radial": (-0.1, 0.02),
               "simple_divisional": (-0.3, 0.0)}

LM_TOL = 1e-4    # f32 relative deviation of G, H and cost: sums taken in another order
NMF_TOL = 2e-2   # relative Frobenius error of the bf16 reconstruction, 7 steps
ANGLE_TOL = 0.05  # degrees, whole path with kernels against the plain versions
GATE_REQUESTS = ("a", "c", "d", "e")  # served by both routes for the whole-path gate
WATCHDOG_S = 600  # a hung kernel becomes a traceback after this many seconds
ROLL_TOL = 3.0    # degrees, request a's roll against the rendered views (r05 weights)
FOCAL_PRIOR = {"focal": 500.0}  # request c's prior, in input pixels
SHARED_VFOV = 0.9  # radians, request d's one camera
DIVISION_K1 = -0.3  # request e's lens, division model in normalised coordinates


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi gave nothing"


def log(*args) -> None:
    print(*args, flush=True)


def check(ok: bool, message: str) -> None:
    """A failed check ends the run with a traceback (asserts vanish under -O)."""
    if not ok:
        raise RuntimeError(message)


def scenes(rng: np.random.Generator, n: int, h: int, w: int, vfov: float = None,
           k1: float = 0.0):
    """Rendered views of a checkered ground plane under a sky, with fog.

    Each camera has a random roll and pitch, and a random vFoV unless `vfov`
    (radians) fixes one for all views, so the images carry real perspective
    (vanishing lines, a tilted horizon). With k1 the lens follows the division
    model: a pixel's normalised coordinate p maps to the ray (p / (1 + k1 |p|²), 1).
    Returns the images and the (roll, pitch, vfov) of each view in degrees.
    """
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    images = np.empty((n, h, w, 3), np.float32)
    truth = []
    for i in range(n):
        roll, pitch = rng.uniform(-0.3, 0.3, 2)
        fov = rng.uniform(0.7, 1.3) if vfov is None else vfov
        f = h / 2 / math.tan(fov / 2)
        p = np.stack([(xx + 0.5 - w / 2) / f, (yy + 0.5 - h / 2) / f], -1)
        p = p / (1.0 + k1 * (p * p).sum(-1, keepdims=True))
        rays = np.concatenate([p, np.ones_like(xx)[..., None]], -1)
        cr, sr, cp, sp = math.cos(roll), math.sin(roll), math.cos(pitch), math.sin(pitch)
        rot = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]]) @ np.array(
            [[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
        world = rays @ rot.T  # y points down; the ground is the plane y = 1.5
        down = world[..., 1] > 1e-6
        t = np.where(down, 1.5 / np.where(down, world[..., 1], 1.0), 0.0)
        tiles = (np.floor(t * world[..., 0] / 2) + np.floor(t * world[..., 2] / 2)) % 2
        ground = np.where(tiles[..., None] > 0, rng.uniform(0.1, 0.9, 3), rng.uniform(0.1, 0.9, 3))
        up = -world[..., 1:2] / np.linalg.norm(world, axis=-1, keepdims=True)
        sky = rng.uniform(0.5, 0.95, 3) * (1.0 - 0.4 * np.clip(up, 0.0, 1.0))
        fog = np.where(down, np.exp(-t / 60.0), 0.0)[..., None]
        img = ground * fog + sky * (1.0 - fog)
        images[i] = np.clip(img + rng.normal(0.0, 0.02, img.shape), 0.0, 1.0)
        truth.append([math.degrees(roll), math.degrees(pitch), math.degrees(fov)])
    return images, truth


def cuda_ms(fn, reps: int = 5, per_graph: int = 10) -> float:
    """Mean device milliseconds of one fn() call.

    fn is captured `per_graph` times into a CUDA graph, and the graph is
    replayed `reps` times between CUDA events, so host launch overhead does
    not hide the device time of short kernels.
    """
    fn()  # warm up outside the capture (allocator, library handles)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * per_graph)


def finite(out: dict) -> None:
    tensors = {k: v for k, v in out.items() if torch.is_tensor(v)}
    tensors["camera"] = out["camera"].data
    tensors["gravity"] = out["gravity"].vec3d
    for k, v in tensors.items():
        check(bool(torch.isfinite(v).all()), f"{k} is not finite")


def summary(out: dict) -> dict:
    deg = lambda t: [round(float(x), 4) for x in torch.rad2deg(t.reshape(-1)).cpu()]
    return {"roll": deg(out["gravity"].roll), "pitch": deg(out["gravity"].pitch),
            "vfov": deg(out["camera"].vfov),
            "stop_at": [int(x) for x in out["stop_at"].reshape(-1).cpu()]}


def timed_request(calib, name: str, *args, **kw) -> dict:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = calib.calibrate(*args, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    finite(out)
    log(f"request {name}: {ms:.1f} ms {json.dumps(summary(out))}")
    return out


def zero_counts() -> None:
    lm_ops.lm_system.launches = 0
    lm_ops.lm_system.launches_by_model = dict.fromkeys(lm_ops.MODEL_IDS, 0)
    nmf_ops.nmf.launches = 0


def serve(calib, name: str, *args, **kw):
    """One request as a path of its own: the launch counts are set to 0 just
    before it and read just after; it must have launched the NMF kernel and
    the LM kernel's instance for its camera model."""
    zero_counts()
    out = timed_request(calib, name, *args, **kw)
    model = kw.get("camera_model", "pinhole")
    counts = {"lm_system": lm_ops.lm_system.launches, "nmf": nmf_ops.nmf.launches,
              "lm_system_by_model": {k: n for k, n in lm_ops.lm_system.launches_by_model.items()
                                     if n}}
    log(f"request {name}: launches {json.dumps(counts)}")
    check(counts["nmf"] > 0 and counts["lm_system_by_model"].get(model, 0) > 0,
          f"request {name}: a kernel of its path was not launched: {counts}")
    return out, counts


@contextlib.contextmanager
def plain_versions(lm: bool = True, nmf: bool = True):
    """Route the serving path through the plain PyTorch version of the chosen kernels."""
    lm_fn, nmf_fn = lm_solver.lm_system, hamburger.nmf_reconstruct
    if lm:
        lm_solver.lm_system = lm_ops.lm_system_plain
    if nmf:
        hamburger.nmf_reconstruct = lambda x, b, *a: torch.matmul(*nmf_ops.nmf_plain(x, b, *a))
    try:
        yield
    finally:
        lm_solver.lm_system, hamburger.nmf_reconstruct = lm_fn, nmf_fn


def rel_dev(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


def without_early_stop(calib):
    """The same calibrator (same network, same options) with the solver's early stop
    off: every lane runs the fixed number of iterations, so the stop test, which
    sits at the float32 ulp, drops out of a comparison."""
    out = copy.copy(calib)
    out.optimizer_options = {**calib.optimizer_options, "early_stop": False}
    return out


def gate_serve(requests: dict) -> dict:
    """Requests a, c, d and e by the present routing, converged (early stop off) and
    serving (early stop on, as users run it): mode -> request -> output."""
    return {mode: {k: (cal if early_stop else without_early_stop(cal)).calibrate(imgs, **kw)
                   for k, (cal, imgs, kw) in requests.items() if k in GATE_REQUESTS}
            for mode, early_stop in (("converged", False), ("serving", True))}


def gate_verdict(route: str, outs: dict, refs: dict) -> dict:
    """The whole-path gate: `route`'s outputs of gate_serve against the plain path's.

    Converged (the gate proper): roll, pitch and vFoV within ANGLE_TOL in every
    lane. Serving: roll, pitch and vFoV within ANGLE_TOL in every lane whose
    stop_at equals the plain path's; a lane whose stop_at differs must differ by
    exactly one iteration, and such lanes are counted and named. Logs each lane;
    returns ok (both comparisons), ok per comparison, the failures, the lanes
    that stop apart and the largest deviations per mode and request.
    """
    failures, apart, worst = [], [], {}
    failed = dict.fromkeys(("converged", "serving"), False)
    for mode in failed:
        worst[mode] = {}
        for k, out in outs[mode].items():
            ref = refs[mode][k]
            dev = torch.stack([out["gravity"].roll - ref["gravity"].roll,
                               out["gravity"].pitch - ref["gravity"].pitch,
                               out["camera"].vfov - ref["camera"].vfov], -1)
            dev = torch.rad2deg(dev.abs()).reshape(-1, 3).cpu().numpy()
            sigma = torch.rad2deg(ref["vfov_uncertainty"]).reshape(-1).cpu().numpy()
            stop = out["stop_at"].reshape(-1).cpu().numpy()
            stop_ref = ref["stop_at"].reshape(-1).cpu().numpy()
            judged = np.ones_like(stop, bool) if mode == "converged" else stop == stop_ref
            for lane in np.nonzero(((dev > ANGLE_TOL).any(-1)) & judged)[0]:
                failed[mode] = True
                failures.append(f"{mode} {k}[{lane}]: roll/pitch/vfov {dev[lane].round(5).tolist()} "
                                f"deg against {ANGLE_TOL}")
            if mode == "serving":
                for lane in np.nonzero(~judged)[0]:
                    apart.append(f"{k}[{lane}] {int(stop[lane])}/{int(stop_ref[lane])}")
                    if abs(stop[lane] - stop_ref[lane]) != 1:
                        failed[mode] = True
                        failures.append(f"serving {k}[{lane}]: stop_at {int(stop[lane])} against "
                                        f"{int(stop_ref[lane])}, more than one iteration apart")
            worst[mode][k] = dev.max(0).tolist()
            fmt = lambda a: np.array2string(a, precision=5, separator=",", max_line_width=10**4)
            log(f"gate {mode}, {route} vs plain, request {k}: max roll/pitch/vfov "
                f"{fmt(dev.max(0))} deg; per lane roll {fmt(dev[:, 0])} pitch {fmt(dev[:, 1])} "
                f"vfov {fmt(dev[:, 2])}; plain vfov sigma {fmt(sigma)} deg; stop_at "
                f"{stop.astype(int).tolist()} against {stop_ref.astype(int).tolist()}")
    log(f"gate serving, {route}: {len(apart)} lanes stop one iteration apart from the plain path"
        f"{': ' + ', '.join(apart) if apart else ''}")
    for mode, bad in failed.items():
        log(f"gate {mode}, {route}: {'FAILED' if bad else 'passed'}")
    log(f"gate, {route}: {'passed' if not failures else 'FAILED: ' + '; '.join(failures)}")
    return {"ok": not failures, "ok_converged": not failed["converged"],
            "ok_serving": not failed["serving"], "failures": failures, "stop_apart": apart,
            "max_dev_deg": worst}


def request_system(calib, images: np.ndarray, camera_model: str, priors: dict, **options):
    """What calibrate hands the LM solver for one request: the fields with the
    priors, the planes, the initial estimate and the config."""
    pre = calib.preprocessor(torch.from_numpy(images).to(calib.device))
    B = images.shape[0]
    with torch.inference_mode():
        data = {k: v.float() for k, v in calib.net(pre["image"].to(calib.compute_dtype)).items()}
    if "focal" in priors:  # as calibrate scales a focal prior into the crop
        data["prior_focal"] = torch.full((B,), float(priors["focal"]), device=calib.device) * \
            pre["scales"].expand(B, 2)[:, 1]
    cfg = resolve_priors(data, LMConfig(camera_model=camera_model, **options,
                                        **calib.optimizer_options))
    obs, h, w = flatten_observations(data, cfg)
    init = get_heuristic_estimation if cfg.init_mode == "heuristic" else get_trivial_estimation
    camera, gravity = init(data, cfg)
    return data, obs, camera, gravity, h, w, cfg


def lm_compare(label: str, obs, camera, gravity, h: int, w: int, cfg) -> float:
    """The LM kernel against lm_system_plain, for the loop's system and the final one."""
    max_abs = 0.0
    for sph, logf in [(True, True), (False, False)]:
        out = lm_ops.lm_system(obs, camera, gravity, h, w, cfg, sph, logf)
        ref = lm_ops.lm_system_plain(obs, camera, gravity, h, w, cfg, sph, logf)
        torch.cuda.synchronize()
        for name, a, b in zip(("G", "H", "cost"), out, ref):
            dev = rel_dev(a, b)
            log(f"lm kernel vs plain, {label} (spherical={sph}): {name} relative deviation "
                f"{dev:.3e}")
            check(dev <= LM_TOL, f"LM kernel, {label}: {name} deviates by {dev:.3e} > {LM_TOL}")
            max_abs = max(max_abs, float((a - b).abs().max()))
    return max_abs


def lm_timing(obs, camera, gravity, w: int, model: str) -> dict:
    """Kernel and plain times of one model instance on the given planes, and its bound."""
    B, N = obs["up_x"].shape
    k = torch.tensor(LM_TIMING_K[model], device=camera.f.device).expand(B, 2)
    camera = Camera(camera.size, camera.f, camera.c, k, model)
    cfg = LMConfig(camera_model=model)
    cam = camera.data.contiguous()
    grav = gravity.vec3d.contiguous()
    M = pf.manifold_matrix(gravity, True).reshape(B, 6).contiguous()
    ms = cuda_ms(lambda: lm_ops.launch(obs, cam, grav, M, model, w, cfg, True))
    plain_ms = cuda_ms(lambda: lm_ops.lm_system_plain(obs, camera, gravity, N // w, w, cfg))
    P = cfg.num_params
    nbytes = sum(t.numel() * t.element_size() for t in obs.values()) + (cam.numel()
              + grav.numel() + M.numel()) * 4 + (B * (P + P * P + 1)) * 4
    flops = LM_FLOPS_PER_PIXEL[model] * B * N
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    log(f"lm kernel {model} B={B} N={N}: {ms:.4f} ms ({nbytes / ms / 1e9:.3f} TB/s), plain "
        f"{plain_ms:.4f} ms, {nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, {flops / 1e9:.3f} GFLOP "
        f"-> {t_ops:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def device_kernels(fn) -> list:
    """Names of the device kernels one fn() call runs, from a torch.profiler trace."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def launch_latency() -> dict:
    """Milliseconds per launch of a one-element PyTorch kernel: its device time between
    launches replayed from a CUDA graph, and eager launches timed by CUDA events."""
    x = torch.zeros(1, device="cuda")
    graph_ms = cuda_ms(lambda: x.add_(1.0), reps=20, per_graph=50)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(200):
        x.add_(1.0)
    end.record()
    torch.cuda.synchronize()
    return {"graph_ms": graph_ms, "eager_ms": start.elapsed_time(end) / 200}


def lm_phase(calib, calib_h, images: np.ndarray, images_d: np.ndarray,
             images_e: np.ndarray) -> dict:
    """The LM kernel against lm_system_plain on the systems of requests a, c, d and e,
    one call traced as one kernel launch, then each model instance timed at request a's
    shape and at one lane of it (requests b and c)."""
    max_abs = lm_compare("request c, simple_radial",
                         *request_system(calib, images[1:2], "simple_radial", FOCAL_PRIOR)[1:])
    for label, cal, imgs, model, opts in [
            ("request d", calib, images_d, "radial", {"shared_intrinsics": True}),
            ("request e", calib_h, images_e, "simple_divisional", {})]:
        data, obs, camera, gravity, h, w, cfg = request_system(cal, imgs, model, {}, **opts)
        max_abs = max(max_abs, lm_compare(f"{label}, {model}, initial estimate", obs, camera,
                                          gravity, h, w, cfg))
        # at the solution the distortion is not 0, so the dphi/dr2 terms are exercised too
        with torch.inference_mode():
            res = lm_solver.run_lm(data, cfg)
        log(f"{label}: k at the solution {res.camera.k[:, :cfg.num_dist].tolist()}")
        max_abs = max(max_abs, lm_compare(f"{label}, {model}, at the solution", obs, res.camera,
                                          res.gravity, h, w, cfg))

    _, obs, camera, gravity, h, w, cfg = request_system(calib, images, "pinhole", {})
    max_abs = max(max_abs, lm_compare("request a, pinhole", obs, camera, gravity, h, w, cfg))
    config = lm_ops.kernel_config(w)
    B = camera.f.shape[0]
    cam, grav = camera.data.contiguous(), gravity.vec3d.contiguous()
    M = pf.manifold_matrix(gravity, True).reshape(B, 6).contiguous()
    traced = device_kernels(lambda: lm_ops.launch(obs, cam, grav, M, "pinhole", w, cfg, True))
    log(f"lm kernel, one call traced by torch.profiler: {len(traced)} device kernel(s) {traced}; "
        f"{config['cluster']} blocks of {config['threads']} threads per lane, one cluster; the "
        f"card holds {config['active_clusters']} such clusters (lanes) at once")
    check(len(traced) == 1 and "lm_system_kernel" in traced[0],
          f"one lm_system call ran {traced}, not one launch of the LM kernel")
    wrapper = device_kernels(lambda: lm_ops.lm_system(obs, camera, gravity, h, w, cfg))
    log(f"lm_system wrapper, one call: {len(wrapper)} device kernels (the kernel and the "
        f"wrapper's host-side ops): {wrapper}")

    one = ({k: v[:1].contiguous() for k, v in obs.items()},
           Camera.from_data(camera.data[:1], "pinhole"), Gravity(gravity.vec3d[:1]))
    per_model = {}
    for model in lm_ops.MODEL_IDS:
        per_model[model] = lm_timing(obs, camera, gravity, w, model)
        b1 = lm_timing(*one, w, model)
        per_model[model].update({f"b1_{k}": v for k, v in b1.items()})
    latency = launch_latency()
    log(f"launch latency, one-element kernel: {latency['graph_ms']:.4f} ms a launch in a CUDA "
        f"graph, {latency['eager_ms']:.4f} ms eager")
    return {"max_abs_err": max_abs, **per_model["pinhole"], "library_ms": None,
            "per_model": per_model, **config, "launch_latency_ms": latency}


def nmf_phase(calib, images: np.ndarray) -> dict:
    """The NMF kernels against nmf_plain on request (a)'s stacked head tokens."""
    crop = calib.preprocessor(torch.from_numpy(images).to(calib.device))["image"]
    with torch.inference_mode():
        tokens, bases = calib.net.front(crop.to(calib.compute_dtype))[3:]
    steps = hamburger.NMF_EVAL_STEPS
    out = nmf_ops.nmf_reconstruct(tokens, bases, steps)
    coef, bt = nmf_ops.nmf_plain(tokens, bases, steps)
    ref = torch.matmul(coef, bt)
    torch.cuda.synchronize()
    err = float(torch.linalg.norm((out.float() - ref.float()).flatten())
                / torch.linalg.norm(ref.float().flatten()))
    max_abs = float((out.float() - ref.float()).abs().max())
    log(f"nmf kernel vs plain {tuple(tokens.shape)} {tokens.dtype}: relative Frobenius {err:.3e}")
    check(err <= NMF_TOL, f"NMF kernel deviates by {err:.3e} > {NMF_TOL}")
    check(bool(torch.isfinite(out).all()), "NMF kernel output is not finite")
    first, second = nmf_ops.nmf(tokens, bases, steps), nmf_ops.nmf(tokens, bases, steps)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"nmf kernel, two launches on the same tokens: coef and bt bitwise equal: {same}")
    check(same, "NMF kernel is not deterministic")

    ms = cuda_ms(lambda: nmf_ops.nmf(tokens, bases, steps), reps=3, per_graph=2)
    plain_ms = cuda_ms(lambda: nmf_ops.nmf_plain(tokens, bases, steps), reps=3, per_graph=2)
    B, N, D = tokens.shape
    R = bases.shape[2]
    macs = ((steps + 2) * N * D * R + steps * N * R * D + (steps + 1) * N * R * R
            + steps * N * R * R + (steps + 1) * R * R * D + steps * R * R * D)
    flops = 2 * B * macs
    esize = tokens.element_size()
    nbytes = esize * B * (N * D + D * R + N * R + R * D)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    log(f"nmf kernel B={B} N={N} D={D} R={R}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"{nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, {flops / 1e9:.1f} GFLOP -> {t_ops:.4f} ms")
    # the float32 instance (FMA loops, not on the serving path) on the same tokens
    x32, b32 = tokens.float(), bases.float()
    f32_ms = cuda_ms(lambda: nmf_ops.nmf(x32, b32, steps), reps=3, per_graph=2)
    f32_bound_ms = max(4 / esize * t_bytes, flops / F32_FLOPS * 1e3)
    log(f"nmf kernel, float32 instance, same shape: {f32_ms:.4f} ms, bound {f32_bound_ms:.4f} ms "
        f"(operations at {F32_FLOPS / 1e12:.0f} TFLOP/s)")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "tensor_cores": "mma.sync", "tokens_per_chunk": nmf_ops.TOKENS_PER_CHUNK,
            "f32_ms": f32_ms, "f32_bound_ms": f32_bound_ms}


def ptxas_entries(entries: dict) -> dict:
    """Registers and spills of the kernels whose mangled names contain each given
    substring, from the build's ptxas report (empty when the library was not built here)."""
    found, entry = {}, None
    for line in build.build_log["ptxas"].splitlines():
        if "Compiling entry function" in line:
            entry = next((label for label, sub in entries.items() if sub in line), None)
        elif entry and ("spill" in line or "Used" in line):
            found[entry] = (found.get(entry, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return found


def lm_ptxas() -> dict:
    """The LM kernel's all-planes instance of each model."""
    return ptxas_entries({m: f"lm_system_kernelILi{i}ELi15E" for m, i in lm_ops.MODEL_IDS.items()})


def resident_blocks(report: str, threads: int) -> int:
    """Blocks of `threads` threads one SM holds at the register count in a ptxas report
    (registers are allocated per warp in units of 256)."""
    regs = int(re.search(r"Used (\d+) registers", report).group(1))
    per_warp = -(-regs * 32 // 256) * 256
    return min(65536 // (per_warp * (threads // 32)), 2048 // threads)


def nmf_ptxas() -> dict:
    """The NMF kernel's bf16 stage kernels, tensor-core stages first."""
    return ptxas_entries({"coef (init), tensor cores": "nmf_coef_tc_kernelILb1E",
                          "coef (update), tensor cores": "nmf_coef_tc_kernelILb0E",
                          "stats, tensor cores": "nmf_stats_tc_kernel",
                          "gram, tensor cores": "nmf_gram_tc_kernel",
                          "norm": "nmf_norm_kernelI13__nv_bfloat16E",
                          "bases": "nmf_bases_kernelI13__nv_bfloat16E"})


def spills(report: str) -> bool:
    """Whether a kernel's ptxas lines report stack or spill bytes other than 0."""
    return any(int(n) for n in re.findall(r"(\d+) bytes (?:stack frame|spill stores|spill loads)",
                                          report))


def smoke_requests(calib, calib_h) -> Tuple[dict, dict]:
    """Requests a to e, name -> (calibrator, image(s), calibrate options), and the
    rendered views' (roll, pitch, vfov) in degrees of a, d and e. ``calib_h``
    serves e and must use the heuristic init."""
    images, truth = scenes(np.random.default_rng(0), 16, 480, 640)
    images_d, truth_d = scenes(np.random.default_rng(1), 8, 480, 640, vfov=SHARED_VFOV)
    images_e, truth_e = scenes(np.random.default_rng(2), 4, 480, 640, k1=DIVISION_K1)
    requests = {
        "a": (calib, images, {"batched": True}),
        "b": (calib, images[0], {}),
        "c": (calib, images[1], {"camera_model": "simple_radial", "priors": FOCAL_PRIOR}),
        "d": (calib, images_d, {"camera_model": "radial", "shared_intrinsics": True,
                                "batched": True}),
        "e": (calib_h, images_e, {"camera_model": "simple_divisional", "batched": True}),
    }
    return requests, {"a": truth, "d": truth_d, "e": truth_e}


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this check runs only on the card", file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)  # a hung kernel becomes a traceback
    card = card_name()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"card: {card}")

    t0 = time.perf_counter()
    build.lib()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc ran: {build.build_log['built']})")

    t0 = time.perf_counter()
    weights = params_from_jax(read_flax_msgpack(WEIGHTS), "b")
    log(f"weights: {WEIGHTS.name} read in {time.perf_counter() - t0:.1f} s")
    calib = geocalib_tpu_torch.GeoCalib(weights=weights, compute_dtype="bfloat16")
    check(calib.device.type == "cuda", f"GeoCalib chose {calib.device}")

    calib_h = geocalib_tpu_torch.GeoCalib(weights=weights, compute_dtype="bfloat16",
                                          init_mode="heuristic")

    requests, truths = smoke_requests(calib, calib_h)
    images, images_d, images_e = (requests[k][1] for k in "ade")
    truth, truth_d, truth_e = (truths[k] for k in "ade")
    log(f"rendered views (roll, pitch, vfov in degrees): {json.dumps(np.round(truth, 3).tolist())}")
    titles = {"a": "a (16 x 480x640, pinhole, bf16)", "b": "b (1 image, pinhole)",
              "c": "c (1 image, simple_radial, focal prior)",
              "d": "d (8 views of one camera, radial, shared intrinsics)",
              "e": "e (4 views, simple_divisional, heuristic init)"}
    # warm the card, cuDNN and the bases cache at every request's shapes, outside the counted runs
    for cal, imgs, kw in requests.values():
        cal.calibrate(imgs, **kw)

    outs, counts = {}, {}
    for name, (cal, imgs, kw) in requests.items():
        outs[name], counts[name] = serve(cal, titles[name], imgs, **kw)
    launches = {"lm_system": sum(c["lm_system"] for c in counts.values()),
                "nmf": sum(c["nmf"] for c in counts.values())}
    log(f"launches on the serving paths, a to e: {json.dumps(launches)}")
    out_a, out_c, out_d, out_e = outs["a"], outs["c"], outs["d"], outs["e"]
    check(out_a["up_field"].shape == (16, 480, 640, 2), "request a: up_field shape")
    check(out_a["camera"].data.shape == (16, 8) and out_c["camera"].k.shape == (2,),
          "camera shapes")
    roll_err = np.abs(np.degrees(out_a["gravity"].roll.cpu().numpy()) - np.array(truth)[:, 0])
    log(f"request a: roll error against the rendered views, max {roll_err.max():.3f} deg, "
        f"median {np.median(roll_err):.3f} deg")
    check(roll_err.max() <= ROLL_TOL, f"roll error {roll_err.max():.3f} deg > {ROLL_TOL}")

    f_d = out_d["camera"].f
    check(out_d["camera"].data.shape == (8, 8) and torch.equal(f_d, f_d[:1].expand_as(f_d)),
          f"request d: the shared focal differs across lanes: {f_d[:, 1].tolist()}")
    vfov_d = np.degrees(out_d["camera"].vfov.cpu().numpy())
    log(f"request d: shared vfov {vfov_d[0]:.3f} deg against the rendered "
        f"{math.degrees(SHARED_VFOV):.3f} deg; k {out_d['camera'].k[0].tolist()}")
    roll_d = np.abs(np.degrees(out_d["gravity"].roll.cpu().numpy()) - np.array(truth_d)[:, 0])
    log(f"request d: roll error against the rendered views, max {roll_d.max():.3f} deg")
    k1_e = out_e["camera"].k[:, 0].tolist()
    roll_e = np.abs(np.degrees(out_e["gravity"].roll.cpu().numpy()) - np.array(truth_e)[:, 0])
    log(f"request e: k1 {json.dumps([round(k, 4) for k in k1_e])} against the rendered "
        f"{DIVISION_K1}; roll error max {roll_e.max():.3f} deg, median {np.median(roll_e):.3f} deg")

    lm = lm_phase(calib, calib_h, images, images_d, images_e)
    nmf = nmf_phase(calib, images)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for model, n in sorted(lm_ptxas().items()):
        per_sm = resident_blocks(n, lm["threads"])
        blocks = lm["cluster"] * 16
        log(f"lm kernel {model}, all five planes: {n}; by its registers {per_sm} block(s) per SM, "
            f"so request a's {blocks} blocks would fill {blocks / (per_sm * sms):.3f} of one wave "
            f"of {sms} SMs")
        lm["per_model"][model]["registers"] = n
    nmf_regs = nmf_ptxas()
    for stage, n in nmf_regs.items():
        log(f"nmf kernel bf16 stage {stage}: {n}")
    if build.build_log["built"]:
        check(len(nmf_regs) == 6, f"ptxas reported {len(nmf_regs)} of the 6 bf16 NMF stages")
        check(not any(spills(n) for n in nmf_regs.values()), "a bf16 NMF stage spills")

    outs_gate = gate_serve(requests)
    with plain_versions():
        refs_gate = gate_serve(requests)
    gate = gate_verdict("kernels", outs_gate, refs_gate)
    check(gate["ok"], f"whole-path gate: {gate['failures']}")

    by_model = {m: sum(c["lm_system_by_model"].get(m, 0) for c in counts.values())
                for m in lm_ops.MODEL_IDS}
    for model, entry in lm["per_model"].items():
        entry["launches"] = by_model[model]
    kernels = [
        {"name": "lm_system", "route": "cuda", "source": "geocalib_tpu_torch/csrc/lm_system.cu",
         "replaces": "geocalib_tpu/ops/lm_kernel.py:195", "launches": launches["lm_system"],
         **lm},
        {"name": "nmf", "route": "cuda", "source": "geocalib_tpu_torch/csrc/nmf.cu",
         "replaces": "geocalib_tpu/ops/nmf_kernel.py:86", "launches": launches["nmf"],
         **nmf},
    ]
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
