#!/usr/bin/env python3
"""Smoke run of geocalib_tpu_torch on one CUDA card: the port still starts.

Builds the CUDA kernels from geocalib_tpu_torch/csrc, serves three
GeoCalib.calibrate requests at MSCAN-B width on the committed weights
(weights/geocalib_synth_r05.msgpack), checks that the serving path launched
both kernels, holds each kernel against its plain PyTorch version at the
serving shapes of requests a and c, times both, and serves requests a and
c again with the plain versions to compare the results end to end.

Run from the repository root, on a machine with one card:

    python3 chip_smoke.py

It exits non-zero, and prints no result, without a card or outside the
repository. Every line is flushed as it is printed; the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import faulthandler
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import geocalib_tpu_torch
from geocalib_tpu_torch.geometry import planar_fields as pf
from geocalib_tpu_torch.models import hamburger
from geocalib_tpu_torch.models.weights import params_from_jax, read_flax_msgpack
from geocalib_tpu_torch.ops import build, lm_system as lm_ops, nmf as nmf_ops
from geocalib_tpu_torch.optim import lm as lm_solver
from geocalib_tpu_torch.optim.lm import (LMConfig, flatten_observations, get_trivial_estimation,
                                         resolve_priors)

faulthandler.dump_traceback_later(600, exit=True)  # a hung kernel becomes a traceback

ROOT = Path(__file__).resolve().parent
WEIGHTS = ROOT / "weights" / "geocalib_synth_r05.msgpack"

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the least-time bounds.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
# Float operations per pixel of csrc/lm_system.cu with all five planes, counted
# by hand from the source (an FMA as two, a sqrt or division as one).
LM_FLOPS_PER_PIXEL = {"pinhole": 200, "simple_radial": 350}

LM_TOL = 1e-4    # f32 relative deviation of G, H and cost: sums taken in another order
NMF_TOL = 2e-2   # relative Frobenius error of the bf16 reconstruction, 7 steps
ANGLE_TOL = 0.05  # degrees, whole path with kernels against the plain versions
ROLL_TOL = 3.0    # degrees, request a's roll against the rendered views (r05 weights)
FOCAL_PRIOR = {"focal": 500.0}  # request c's prior, in input pixels


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


def scenes(rng: np.random.Generator, n: int, h: int, w: int):
    """Rendered pinhole views of a checkered ground plane under a sky, with fog.

    Each camera has a random roll, pitch and vFoV, so the images carry real
    perspective (vanishing lines, a tilted horizon). Returns the images and
    the (roll, pitch, vfov) of each view in degrees.
    """
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    images = np.empty((n, h, w, 3), np.float32)
    truth = []
    for i in range(n):
        roll, pitch = rng.uniform(-0.3, 0.3, 2)
        vfov = rng.uniform(0.7, 1.3)
        f = h / 2 / math.tan(vfov / 2)
        rays = np.stack([(xx + 0.5 - w / 2) / f, (yy + 0.5 - h / 2) / f, np.ones_like(xx)], -1)
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
        truth.append([math.degrees(roll), math.degrees(pitch), math.degrees(vfov)])
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


def request_system(calib, images: np.ndarray, camera_model: str, priors: dict):
    """What calibrate hands the LM solver for one request: planes, initial estimate, config."""
    pre = calib.preprocessor(torch.from_numpy(images).to(calib.device))
    B = images.shape[0]
    with torch.inference_mode():
        data = {k: v.float() for k, v in calib.net(pre["image"].to(calib.compute_dtype)).items()}
    if "focal" in priors:  # as calibrate scales a focal prior into the crop
        data["prior_focal"] = torch.full((B,), float(priors["focal"]), device=calib.device) * \
            pre["scales"].expand(B, 2)[:, 1]
    cfg = resolve_priors(data, LMConfig(camera_model=camera_model))
    obs, h, w = flatten_observations(data, cfg)
    camera, gravity = get_trivial_estimation(data, cfg)
    return obs, camera, gravity, h, w, cfg


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


def lm_phase(calib, images: np.ndarray) -> dict:
    """The LM kernel against lm_system_plain on the systems of requests (a) and (c)."""
    max_abs = lm_compare("request c, simple_radial",
                         *request_system(calib, images[1:2], "simple_radial", FOCAL_PRIOR))
    obs, camera, gravity, h, w, cfg = request_system(calib, images, "pinhole", {})
    B, N = obs["up_x"].shape
    max_abs = max(max_abs, lm_compare("request a, pinhole", obs, camera, gravity, h, w, cfg))

    cam = camera.data.contiguous()
    grav = gravity.vec3d.contiguous()
    M = pf.manifold_matrix(gravity, True).reshape(B, 6).contiguous()
    ms = cuda_ms(lambda: lm_ops.launch(obs, cam, grav, M, "pinhole", w, cfg, True))
    plain_ms = cuda_ms(lambda: lm_ops.lm_system_plain(obs, camera, gravity, h, w, cfg))
    nbytes = sum(t.numel() * t.element_size() for t in obs.values()) + (cam.numel()
              + grav.numel() + M.numel()) * 4 + (B * (3 + 9 + 1)) * 4
    flops = LM_FLOPS_PER_PIXEL["pinhole"] * B * N
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    log(f"lm kernel B={B} N={N}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"{nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, {flops / 1e9:.3f} GFLOP -> {t_ops:.4f} ms")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


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
    log(f"nmf kernel B={B} N={N} D={D} R={R}: {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"{nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, {flops / 1e9:.1f} GFLOP -> {t_ops:.4f} ms")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this check runs only on the card", file=sys.stderr)
        return 1
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

    images, truth = scenes(np.random.default_rng(0), 16, 480, 640)
    log(f"rendered views (roll, pitch, vfov in degrees): {json.dumps(np.round(truth, 3).tolist())}")
    # warm the card, cuDNN and the bases cache at every request's shapes, outside the counted run
    calib.calibrate(images, batched=True)
    calib.calibrate(images[0])
    calib.calibrate(images[1], camera_model="simple_radial", priors=FOCAL_PRIOR)

    lm_ops.lm_system.launches = 0
    nmf_ops.nmf.launches = 0
    out_a = timed_request(calib, "a (16 x 480x640, pinhole, bf16)", images, batched=True)
    timed_request(calib, "b (1 image, pinhole)", images[0])
    out_c = timed_request(calib, "c (1 image, simple_radial, focal prior)", images[1],
                          camera_model="simple_radial", priors=FOCAL_PRIOR)
    launches = {"lm_system": lm_ops.lm_system.launches, "nmf": nmf_ops.nmf.launches}
    log(f"launches on the serving path: {json.dumps(launches)}")
    check(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")
    check(out_a["up_field"].shape == (16, 480, 640, 2), "request a: up_field shape")
    check(out_a["camera"].data.shape == (16, 8) and out_c["camera"].k.shape == (2,),
          "camera shapes")
    roll_err = np.abs(np.degrees(out_a["gravity"].roll.cpu().numpy()) - np.array(truth)[:, 0])
    log(f"request a: roll error against the rendered views, max {roll_err.max():.3f} deg, "
        f"median {np.median(roll_err):.3f} deg")
    check(roll_err.max() <= ROLL_TOL, f"roll error {roll_err.max():.3f} deg > {ROLL_TOL}")

    lm = lm_phase(calib, images)
    nmf = nmf_phase(calib, images)

    with plain_versions():
        plain_a = calib.calibrate(images, batched=True)
        plain_c = calib.calibrate(images[1], camera_model="simple_radial", priors=FOCAL_PRIOR)
    for req, out, plain in [("a", out_a, plain_a), ("c", out_c, plain_c)]:
        for name, t, p in [("roll", out["gravity"].roll, plain["gravity"].roll),
                           ("pitch", out["gravity"].pitch, plain["gravity"].pitch),
                           ("vfov", out["camera"].vfov, plain["camera"].vfov)]:
            dev = float(torch.rad2deg((t - p).abs()).max())
            log(f"request {req}, kernels vs plain versions: {name} max deviation {dev:.5f} deg")
            check(dev <= ANGLE_TOL, f"request {req}: {name} deviates by {dev} deg > {ANGLE_TOL}")
        same_stop = bool(torch.equal(out["stop_at"], plain["stop_at"]))
        log(f"request {req}, kernels vs plain versions: stop_at equal in every lane: {same_stop}")
        check(same_stop, f"request {req}: stop_at differs from the plain versions")

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
