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

Then the eval phase, a path of its own (the port's eval/pipeline.py): 64
rendered 320x320 views with their true roll, pitch and vFoV as gt_params,
held in memory behind SimpleDataset's epoch() (the card's machine has no PIL
or h5py), through SimplePipeline at batch 8, pinhole and then simple_radial
(GT k1 = 0, so the pixel projection metrics run), and 12 views of two sizes
(480x640, 640x480) preprocessed by the port's ImagePreprocessor into two
aspect buckets with padded tail lanes, behind BenchmarkDataset's batches(),
through BenchmarkPipeline. Each run's counts are set to 0 around it: every
batch must launch the NMF kernel once and the LM kernel's instance of its
camera model 31 times, and the padded lanes must be dropped. The pipeline's
first batch must equal GeoCalib.calibrate on the same views within 1e-4
degrees with equal stop_at; roll_error must equal the error computed here
from the rendered truth within 1e-4 degrees, and the median roll error lie
within ROLL_TOL. Each kernel is held against its plain version, and timed,
at the eval batch's shapes; the per-image deviations of the kernels against
the plain versions are reported (not judged: the whole-path gate judges
both kernels), with images per second at batch 8 and 16 and the host's
share of a batch.

Then the train phase, a path of its own: from the same weights (parameters
and BatchNorm statistics), MSCAN-B, bf16 network, drop path 0.1, batch 24 of
rendered 320x320 views, 3 train_steps with IFT gradients through the LM and
1 with the LM unrolled (through the LM kernel's VJP). The steps must be
finite, move the parameters and the running statistics, and launch the LM
kernel 11 times each (10 loop systems and the final cost) and the NMF kernel
never (training runs the plain NMF, as the JAX package runs XLA's). The step
time (CUDA events), the peak memory and the LM kernel's share of a step are
printed with the card. Then one step's loss and gradients through the
kernels are held against the plain versions (cuDNN deterministic, drop path
0, same state and key), in IFT and unroll mode, after two plain runs are
shown to give the same bits: loss terms within 1e-4, the gradient's global
norm within 1e-3, each leaf over 1e-6 of it within 1e-2 relative L2. A
broken VJP (zero cotangents for the confidence planes) must fail that
comparison in unroll mode.

Then the loop phase, a path of its own: the training loop as a user runs it
(geocalib_tpu_torch.training.train.training: MSCAN-B, batch 24 at 320x320,
bf16, IFT gradients, augmentation="device", from the r05 weights through
train.init_weights) for LOOP_STEPS steps with logs, one validation of
LOOP_VAL_BATCHES batches and checkpoints, then LOOP_RESTORED_STEPS more after
restore=True. The card has no PIL and no dataset, so the dataset class is
replaced at the train.SimpleDataset seam by rendered views held in memory;
the PrefetchLoader, the device augmentation, the step, the validation, the
checkpoints and the export run unchanged. The counts are set to 0 around each
step and each validation batch: a step launches the LM kernel 11 times and
the NMF kernel never, a validation batch 11 and once. Every logged scalar must
be finite, the parameters must move, metrics.jsonl must hold the records the
schedule implies, a checkpoint restored on the card must equal the saved
state bit for bit and start the restored run's first step, the exported
msgpack must read back bit for bit, and one validation batch by the kernels
must agree with the plain versions within LOOP_ANGLE_TOL, LOOP_RECALL_TOL and
LOOP_LOSS_TOL. The step time, images/s per log window, loader stall, host
share of a step, peak memory and checkpoint times are printed with the card.

Run from the repository root, on a machine with one card:

    python3 chip_smoke.py

It exits non-zero, and prints no result, without a card or outside the
repository. Every line is flushed as it is printed; the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import copy
import dataclasses
import faulthandler
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

import geocalib_tpu_torch
from geocalib_tpu_torch.data.dataset import synthesize_gt_fields
from geocalib_tpu_torch.eval import pipeline as eval_lib
from geocalib_tpu_torch.geometry import planar_fields as pf
from geocalib_tpu_torch.training import export as loop_export
from geocalib_tpu_torch.training import train as loop_lib
from geocalib_tpu_torch.training import train_step as train_lib
from geocalib_tpu_torch.utils import config as loop_config
from geocalib_tpu_torch.models import hamburger
from geocalib_tpu_torch.models.weights import params_from_jax, read_flax_msgpack
from geocalib_tpu_torch.ops import build, lm_system as lm_ops, nmf as nmf_ops
from geocalib_tpu_torch.optim import lm as lm_solver
from geocalib_tpu_torch.geometry.camera import Camera
from geocalib_tpu_torch.geometry.gravity import Gravity
from geocalib_tpu_torch.optim.lm import (LMConfig, flatten_observations, get_heuristic_estimation,
                                         get_trivial_estimation, resolve_priors)
from geocalib_tpu_torch.utils.image import ImagePreprocessor
from geocalib_tpu_torch.utils.tools import summarize_results

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
TRAIN_B, TRAIN_SIZE = 24, 320  # the JAX package's training batch and crop
TRAIN_LOSS_TOL = 1e-4  # relative, each loss term, kernels against plain versions
TRAIN_NORM_TOL = 1e-3  # relative, the gradient's global norm
TRAIN_LEAF_TOL = 1e-2  # relative L2, each gradient leaf over TRAIN_LEAF_SHARE of the norm
TRAIN_LEAF_SHARE = 1e-6
EVAL_VIEWS, EVAL_SIZE, EVAL_BATCH = 64, 320, 8  # the eval phase's SimplePipeline runs
EVAL_SPEED_BATCHES = (8, 16)  # batch sizes timed through SimplePipeline
EVAL_BUCKETS = {"landscape": (7, 480, 640), "portrait": (5, 640, 480)}  # views, h, w
EVAL_BUCKET_BATCH = 4  # each bucket ends in a padded tail batch
EVAL_TOL = 1e-4  # degrees: the pipeline against calibrate, and roll_error against the truth
LOOP_VIEWS = {"train.csv": 72, "val.csv": 48}  # rendered 320x320 views of the loop phase
LOOP_STEPS, LOOP_RESTORED_STEPS, LOOP_LOG_EVERY, LOOP_VAL_BATCHES = 12, 4, 4, 2
# one validation batch, kernels against plain versions: angle errors as the whole-path
# gate holds them with the early stop off; a recall is a share of pixels, and a pixel
# near a threshold may cross it; a loss term may move by the bf16 NMF's own bound
LOOP_ANGLE_TOL, LOOP_RECALL_TOL, LOOP_LOSS_TOL = ANGLE_TOL, 1e-2, NMF_TOL


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


def view_rays(h: int, w: int, roll: float, pitch: float, vfov: float, k1: float = 0.0
              ) -> np.ndarray:
    """World rays (h, w, 3) through the pixel centers of a camera with this roll, pitch
    (radians) and vFoV, y pointing down: the camera's rays rotated by Rx(pitch) Rz(roll).
    With k1 the lens follows the division model (see scenes)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    f = h / 2 / math.tan(vfov / 2)
    p = np.stack([(xx + 0.5 - w / 2) / f, (yy + 0.5 - h / 2) / f], -1)
    p = p / (1.0 + k1 * (p * p).sum(-1, keepdims=True))
    rays = np.concatenate([p, np.ones_like(xx)[..., None]], -1)
    cr, sr, cp, sp = math.cos(roll), math.sin(roll), math.cos(pitch), math.sin(pitch)
    rot = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]]) @ np.array(
        [[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    return rays @ rot.T


def scenes(rng: np.random.Generator, n: int, h: int, w: int, vfov: float = None,
           k1: float = 0.0):
    """Rendered views of a checkered ground plane under a sky, with fog.

    Each camera has a random roll and pitch, and a random vFoV unless `vfov`
    (radians) fixes one for all views, so the images carry real perspective
    (vanishing lines, a tilted horizon). With k1 the lens follows the division
    model: a pixel's normalised coordinate p maps to the ray (p / (1 + k1 |p|²), 1).
    Returns the images and the (roll, pitch, vfov) of each view in degrees.
    """
    images = np.empty((n, h, w, 3), np.float32)
    truth = []
    for i in range(n):
        roll, pitch = rng.uniform(-0.3, 0.3, 2)
        fov = rng.uniform(0.7, 1.3) if vfov is None else vfov
        world = view_rays(h, w, roll, pitch, fov, k1)  # the ground is the plane y = 1.5
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


# ---------------------------------------------------------------- eval phase

class RenderedViews:
    """Rendered views held in memory behind SimpleDataset's epoch(): batches of
    "image" and "gt_params" rows (w, h, vfov, roll, pitch, k1 = 0, k2 = 0), radians."""

    def __init__(self, images: np.ndarray, truth: list, batch_size: int):
        h, w = images.shape[1:3]
        self.images = torch.from_numpy(images)
        self.gt_params = torch.tensor([[w, h, math.radians(fov), math.radians(roll),
                                        math.radians(pitch), 0.0, 0.0]
                                       for roll, pitch, fov in truth], dtype=torch.float32)
        self.batch_size = batch_size

    def epoch(self, epoch: int = 0):
        B = self.batch_size
        for start in range(0, len(self.images) - B + 1, B):
            yield {"image": self.images[start:start + B],
                   "gt_params": self.gt_params[start:start + B]}


class RenderedBuckets:
    """Rendered views of other sizes behind BenchmarkDataset's batches(): each view
    preprocessed by the port's ImagePreprocessor, one bucket per original size, each
    bucket's tail padded by repeating its last view with valid False; the GT camera
    in original pixels (principal point at the center of the pixel grid)."""

    def __init__(self, rng: np.random.Generator, batch_size: int):
        self.batch_size, self.buckets, self.truth = batch_size, [], []
        pre = ImagePreprocessor()
        for name, (n, h, w) in EVAL_BUCKETS.items():
            images, truth = scenes(rng, n, h, w)
            views = []
            for i, (img, (roll, pitch, fov)) in enumerate(zip(images, truth)):
                f = h / 2 / math.tan(math.radians(fov) / 2)
                views.append({**pre(img), "name": f"{name}_{i}", "gt_cam": torch.tensor(
                    [w, h, f, f, w / 2 - 0.5, h / 2 - 0.5, 0.0, 0.0], dtype=torch.float32),
                    "gt_rp": torch.tensor([math.radians(roll), math.radians(pitch)])})
            self.buckets.append(views)
            self.truth += truth

    def batches(self):
        B = self.batch_size
        for views in self.buckets:
            for start in range(0, len(views), B):
                chunk = views[start:start + B]
                valid = np.arange(B) < len(chunk)
                chunk = chunk + [chunk[-1]] * (B - len(chunk))
                stack = lambda k: torch.stack([v[k] for v in chunk])
                yield {"image": stack("image"), "scales": stack("scales"),
                       "crop_pad": stack("crop_pad"), "gt_cam": stack("gt_cam"),
                       "gt_rp": stack("gt_rp"), "valid": valid, "names": [v["name"] for v in chunk]}


def counted_eval(label: str, pipe, data, model: str, batches: int) -> dict:
    """One eval run as a path of its own: the counts are set to 0 just before it and
    read just after; each batch must launch the NMF kernel once and the LM kernel's
    instance of `model` 31 times (30 iterations and the final cost)."""
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, names, _ = pipe.evaluate(data)
    seconds = time.perf_counter() - t0
    counts = {"lm_system": lm_ops.lm_system.launches, "nmf": nmf_ops.nmf.launches,
              "lm_system_by_model": {k: n for k, n in lm_ops.lm_system.launches_by_model.items()
                                     if n}}
    per_batch = pipe.lm_config.num_steps + 1
    log(f"eval {label}: {len(names)} images in {batches} batches, {seconds:.2f} s; launches "
        f"{json.dumps(counts)}")
    check(counts["nmf"] == batches and counts["lm_system_by_model"] == {model: per_batch * batches},
          f"eval {label}: each batch must launch the NMF kernel once and the {model} LM kernel "
          f"{per_batch} times: {counts}")
    for k, v in results.items():
        check(bool(np.isfinite(v).all()), f"eval {label}: {k} is not finite")
    summaries = summarize_results(results)
    log(f"eval {label}: median roll/pitch/vfov error {summaries['median_roll_error']} / "
        f"{summaries['median_pitch_error']} / {summaries['median_vfov_error']} deg; AUC@1/5/10 roll "
        f"{[summaries[f'auc_roll_error@{t}'] for t in (1, 5, 10)]} pitch "
        f"{[summaries[f'auc_pitch_error@{t}'] for t in (1, 5, 10)]} vfov "
        f"{[summaries[f'auc_vfov_error@{t}'] for t in (1, 5, 10)]}")
    return {"results": results, "names": names, "counts": counts, "summaries": summaries,
            "seconds": seconds}


def read_roll(roll: np.ndarray, pitch: np.ndarray) -> np.ndarray:
    """The roll (radians) that Gravity.roll reads from the gravity vector of this roll
    and pitch, in float64: asin(-x / (sqrt(1 - z^2) + 1e-4)) of
    (x, z) = (-sin r cos p, sin p), whose 1e-4 shrinks a roll r by about 1e-4 tan r."""
    x, z = -np.sin(roll) * np.cos(pitch), np.sin(pitch)
    return np.arcsin(np.clip(-x / (np.sqrt(1.0 - z * z) + 1e-4), -1.0, 1.0))


def roll_checks(label: str, results: dict, truth: list) -> float:
    """roll_error against |roll - truth| computed here, with the truth's roll as
    Gravity.roll reads it, and the median roll error against ROLL_TOL; returns the
    largest difference from the hand-computed error."""
    truth = np.radians(np.asarray(truth, np.float64))
    wrap = lambda d: np.abs((d + 180.0) % 360.0 - 180.0)
    roll = results["roll"].astype(np.float64)
    by_hand = wrap(roll - np.degrees(read_roll(truth[:, 0], truth[:, 1])))
    dev = float(np.abs(results["roll_error"] - by_hand).max())
    raw = float(np.abs(results["roll_error"] - wrap(roll - np.degrees(truth[:, 0]))).max())
    median = float(np.median(results["roll_error"]))
    log(f"eval {label}: roll_error against |roll - truth| computed by hand: largest difference "
        f"{dev:.3e} deg (bound {EVAL_TOL}; {raw:.3e} against the rendered roll itself, which "
        f"Gravity.roll's 1e-4 moves); median roll error {median:.3f} deg (bound {ROLL_TOL})")
    check(dev <= EVAL_TOL, f"eval {label}: roll_error is not |roll - truth| ({dev:.3e} deg)")
    check(median <= ROLL_TOL, f"eval {label}: median roll error {median:.3f} deg > {ROLL_TOL}")
    return dev


def eval_speed(pipe, images: np.ndarray, truth: list) -> dict:
    """Images per second through SimplePipeline at each batch size of EVAL_SPEED_BATCHES
    (after a warm batch; wall time, which ends in the copy of the metrics to the host),
    and the host's share of one batch: its wall time less its device-kernel time from
    torch.profiler, over its wall time."""
    out = {}
    for B in EVAL_SPEED_BATCHES:
        views = RenderedViews(images, truth, B)
        batch = next(views.epoch())
        one_batch = lambda: eval_lib.to_host(pipe.predict(batch)[0])
        one_batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.evaluate(views)
        seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        one_batch()
        batch_ms = (time.perf_counter() - t0) * 1e3
        lm_ms, device_ms = device_time_by_kernel(one_batch)
        out[B] = {"images_per_s": len(images) / seconds, "batch_ms": batch_ms,
                  "device_ms": device_ms, "lm_kernel_ms": lm_ms,
                  "host_share": (batch_ms - device_ms) / batch_ms}
        log(f"eval speed, SimplePipeline batch {B}: {out[B]['images_per_s']:.1f} images/s "
            f"({len(images)} images in {seconds:.3f} s); one batch {batch_ms:.1f} ms wall, "
            f"{device_ms:.1f} ms of device kernels (LM kernel {lm_ms:.3f} ms), host share "
            f"{out[B]['host_share']:.3f}")
    return out


def eval_phase(weights: dict, calib, card: str) -> dict:
    """The eval path on rendered views at MSCAN-B, bf16: SimplePipeline (pinhole, then
    simple_radial) and BenchmarkPipeline (two aspect buckets with padded tails), each
    run with its launch counts; the pipeline against calibrate, roll_error against the
    truth, the kernels against the plain versions (reported), and images per second."""
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    log(f"eval: numpy {np.__version__} (np.trapezoid needs 2.0 or later)")
    images, truth = scenes(np.random.default_rng(4), EVAL_VIEWS, EVAL_SIZE, EVAL_SIZE)
    views = RenderedViews(images, truth, EVAL_BATCH)
    conf = lambda model: eval_lib.EvalConf(camera_model=model, batch_size=EVAL_BATCH)
    pipes = {m: eval_lib.SimplePipeline(weights, conf(m)) for m in ("pinhole", "simple_radial")}
    check(pipes["pinhole"].device.type == "cuda", f"SimplePipeline chose {pipes['pinhole'].device}")
    bench = RenderedBuckets(np.random.default_rng(5), EVAL_BUCKET_BATCH)
    bench_pipe = eval_lib.BenchmarkPipeline(weights, conf("pinhole"))
    n_bench = sum(-(-len(v) // EVAL_BUCKET_BATCH) for v in bench.buckets)
    # warm cuDNN and the bases cache at every shape, outside the counted runs
    for pipe in pipes.values():
        pipe.evaluate(views, max_batches=1)
    bench_pipe.evaluate(bench)

    runs = {m: counted_eval(f"SimplePipeline, {EVAL_VIEWS} views at {EVAL_SIZE}x{EVAL_SIZE}, {m}",
                            p, views, m, EVAL_VIEWS // EVAL_BATCH) for m, p in pipes.items()}
    runs["benchmark"] = counted_eval("BenchmarkPipeline, 480x640 and 640x480 buckets, pinhole",
                                     bench_pipe, bench, "pinhole", n_bench)
    res = runs["pinhole"]["results"]
    check(runs["benchmark"]["names"] == [v["name"] for b in bench.buckets for v in b],
          f"BenchmarkPipeline kept the padded lanes: {runs['benchmark']['names']}")
    check(all(k in runs["simple_radial"]["results"] for k in
              ("k1_error", "pixel_projection_error@1", "pixel_distortion_error@1")),
          "simple_radial run: the pixel projection metrics are missing")

    # the pipeline against calibrate on the first batch: same views, device and routing
    out = calib.calibrate(images[:EVAL_BATCH], batched=True)
    ref = torch.stack([torch.rad2deg(out["gravity"].roll), torch.rad2deg(out["gravity"].pitch),
                       torch.rad2deg(out["camera"].vfov)], -1).cpu().numpy()
    got = np.stack([res[k][:EVAL_BATCH] for k in ("roll", "pitch", "vfov")], -1)
    cal_dev = float(np.abs(got - ref).max())
    same_stop = bool(np.array_equal(res["stop_at"][:EVAL_BATCH], out["stop_at"].cpu().numpy()))
    log(f"eval: SimplePipeline against GeoCalib.calibrate on its first batch: largest roll/pitch/"
        f"vfov difference {cal_dev:.3e} deg (bound {EVAL_TOL}), stop_at equal {same_stop}, bits "
        f"equal {bool(np.array_equal(got, ref))}")
    check(cal_dev <= EVAL_TOL and same_stop, "eval: SimplePipeline disagrees with calibrate")

    roll_dev = max(roll_checks("SimplePipeline pinhole", res, truth),
                   roll_checks("SimplePipeline simple_radial", runs["simple_radial"]["results"],
                               truth),
                   roll_checks("BenchmarkPipeline", runs["benchmark"]["results"], bench.truth))

    # the kernels against the plain versions on the same views (reported, not judged:
    # the whole-path gate judges both kernels)
    with plain_versions():
        plain, _, _ = pipes["pinhole"].evaluate(views)
    dev = np.abs(np.stack([res[k] - plain[k] for k in ("roll", "pitch", "vfov")], -1)
                 ).astype(np.float64)
    apart = np.nonzero(res["stop_at"] != plain["stop_at"])[0]
    fmt = lambda a: np.array2string(a, precision=5, separator=",", max_line_width=10**4)
    log(f"eval: kernels against plain versions, SimplePipeline pinhole, {EVAL_VIEWS} views: "
        f"largest roll/pitch/vfov deviation {fmt(dev.max(0))} deg, median "
        f"{fmt(np.median(dev, 0))}; per image roll {fmt(dev[:, 0])} pitch {fmt(dev[:, 1])} "
        f"vfov {fmt(dev[:, 2])}; {len(apart)} lanes stop apart (lane, kernels, plain) "
        f"{[(int(i), int(res['stop_at'][i]), int(plain['stop_at'][i])) for i in apart]}")

    # each kernel against its plain version, and timed, at the eval batch's shapes
    at_shape = {"nmf": nmf_phase(calib, images[:EVAL_BATCH])}
    for model in pipes:
        _, obs, camera, gravity, h, w, cfg = request_system(calib, images[:EVAL_BATCH], model, {})
        err = lm_compare(f"eval batch, {model}", obs, camera, gravity, h, w, cfg)
        at_shape[f"lm_system {model}"] = {**lm_timing(obs, camera, gravity, w, model),
                                          "max_abs_err": err}

    speed = eval_speed(pipes["pinhole"], images, truth)
    log(f"eval speed card: {card}")
    launches = {k: sum(r["counts"][k] for r in runs.values()) for k in ("lm_system", "nmf")}
    by_model = {m: sum(r["counts"]["lm_system_by_model"].get(m, 0) for r in runs.values())
                for m in lm_ops.MODEL_IDS}
    return {"launches": launches, "lm_by_model": by_model, "calibrate_dev_deg": cal_dev,
            "roll_error_dev_deg": roll_dev, "plain_dev_deg": dev.max(0).tolist(),
            "stop_apart": len(apart), "speed": speed, "at_shape": at_shape,
            "summaries": {k: r["summaries"] for k, r in runs.items()}}


# ---------------------------------------------------------------- train phase

def train_batch(rng: np.random.Generator) -> dict:
    """Rendered views as a loader batch: images and gt_params rows (w, h, vfov, roll,
    pitch, k1, k2) in radians, as batch_gt reads them."""
    images, truth = scenes(rng, TRAIN_B, TRAIN_SIZE, TRAIN_SIZE)
    gt = [[TRAIN_SIZE, TRAIN_SIZE, math.radians(fov), math.radians(roll), math.radians(pitch),
           0.0, 0.0] for roll, pitch, fov in truth]
    return {"image": torch.from_numpy(images).cuda(),
            "gt_params": torch.tensor(gt, dtype=torch.float32, device="cuda")}


def timed(fn):
    """(result, milliseconds) of fn() between CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def device_time_by_kernel(fn) -> Tuple[float, float]:
    """(ms of the LM kernel, ms of all device kernels) in one fn() traced by torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    lm = sum(e.time_range.elapsed_us() for e in kernels if "lm_system_kernel" in e.name) / 1e3
    return lm, total


def grad_compare(label: str, out: tuple, ref: tuple) -> dict:
    """One step's losses and gradients (compute_grads' output) against another's."""
    _, grads, _, losses, _ = out
    _, rgrads, _, rlosses, _ = ref
    loss_dev = {k: rel_dev(losses[k].detach(), rlosses[k].detach()) for k in rlosses}
    norm = lambda g: float(torch.sqrt(sum((v.double() ** 2).sum() for v in g.values())))
    gnorm, rnorm = norm(grads), norm(rgrads)
    leaves = {k: float(torch.linalg.norm((grads[k] - v).double()) / torch.linalg.norm(v.double()))
              for k, v in rgrads.items() if float(torch.linalg.norm(v.double())) > TRAIN_LEAF_SHARE * rnorm}
    worst = max(leaves, key=leaves.get)
    for k, v in sorted(leaves.items(), key=lambda kv: -kv[1])[:5]:
        share = float(torch.linalg.norm(rgrads[k].double())) / rnorm
        log(f"train gradients, {label}: leaf {k} relative L2 {v:.3e}, share of the norm "
            f"{share:.3e}")
    result = {"loss_rel": max(loss_dev.values()), "norm_rel": abs(gnorm - rnorm) / rnorm,
              "leaf_rel": leaves[worst], "worst_leaf": worst, "leaves": len(leaves),
              "leaves_over_tol": sum(v > TRAIN_LEAF_TOL for v in leaves.values())}
    result["ok"] = (result["loss_rel"] <= TRAIN_LOSS_TOL and result["norm_rel"] <= TRAIN_NORM_TOL
                    and result["leaf_rel"] <= TRAIN_LEAF_TOL)
    log(f"train gradients, {label}: loss terms {result['loss_rel']:.3e} (bound {TRAIN_LOSS_TOL}), "
        f"global norm {result['norm_rel']:.3e} ({TRAIN_NORM_TOL}), worst leaf "
        f"{result['leaf_rel']:.3e} ({TRAIN_LEAF_TOL}) in {worst}, {result['leaves_over_tol']} of "
        f"{len(leaves)} leaves over: {'passes' if result['ok'] else 'FAILS'}")
    return result


@contextlib.contextmanager
def broken_vjp():
    """The LM kernel's VJP returning zero cotangents for the confidence planes."""
    fn = lm_ops.LMSystemFunction
    backward = fn.backward

    def zero_conf(ctx, *cts):
        grads = list(backward(ctx, *cts))
        for i, key in enumerate(ctx.spec[0]):
            if key.endswith("_conf") and grads[3 + i] is not None:
                grads[3 + i] = torch.zeros_like(grads[3 + i])
        return tuple(grads)

    fn.backward = staticmethod(zero_conf)
    try:
        yield
    finally:
        fn.backward = backward


@contextlib.contextmanager
def perturbed_plain_lm():
    """The plain LM system with G scaled by 1 + 2^-22: a change of the size of a float32
    rounding, with no kernel (the control of the bf16 comparison)."""
    def perturbed(*args, **kw):
        G, H, cost = lm_ops.lm_system_plain(*args, **kw)
        return G * (1.0 + 2.0 ** -22), H, cost

    fn = lm_solver.lm_system
    lm_solver.lm_system = perturbed
    try:
        yield
    finally:
        lm_solver.lm_system = fn


def compare_routes(cfg, weights: dict, batch: dict, judged: bool) -> dict:
    """One step's gradients by the kernels against the plain versions, same state and key,
    after two plain runs are checked to give the same bits. judged: the comparison must
    pass, and in unroll mode the broken VJP must fail it; otherwise it is reported with
    the control (perturbed_plain_lm) beside it."""
    label = f"{cfg.compute_dtype} network, {cfg.lm_grad_mode}"
    net, state = train_lib.create_train_state(cfg, weights, device="cuda")
    run = lambda: train_lib.compute_grads(net, cfg, state, batch, (0, 5))
    with plain_versions(lm=True, nmf=False):
        ref, ref2 = run(), run()
    same = torch.equal(ref[0], ref2[0]) and all(torch.equal(ref[1][k], ref2[1][k]) for k in ref[1])
    log(f"train gradients, {label}: two plain runs bitwise equal: {same}")
    check(same, f"{label}: two plain runs differ, so the comparison would not measure the kernel")
    del ref2
    out = {"kernels": grad_compare(f"{label}, kernels vs plain", run(), ref)}
    if judged:
        check(out["kernels"]["ok"], f"train gradients, {label}: kernels vs plain {out['kernels']}")
        with broken_vjp():
            out["broken_vjp"] = grad_compare(f"{label}, broken VJP (confidence planes 0) vs plain",
                                             run(), ref)
        if cfg.lm_grad_mode == "unroll":
            check(not out["broken_vjp"]["ok"], "the broken VJP passed the gradient comparison")
    else:
        with perturbed_plain_lm():
            out["control"] = grad_compare(f"{label}, control (plain, G x (1 + 2^-22)) vs plain",
                                          run(), ref)
    del ref, net, state
    torch.cuda.empty_cache()
    return out


def vjp_timing(obs, camera, gravity, h: int, w: int, cfg) -> dict:
    """The VJP of one LM system at the training shape: the Function's backward (which
    recomputes the plain version) against autograd's backward through a plain forward."""
    B = camera.f.shape[0]
    P = cfg.num_params
    gen = torch.Generator(device="cuda").manual_seed(0)
    cts = [torch.randn(s, device="cuda", generator=gen) for s in ((B, P), (B, P, P), (B,))]

    def backward(fn):
        leaves = [t.detach().clone().requires_grad_() for t in (camera.data, gravity.vec3d,
                                                                *obs.values())]
        with torch.enable_grad():
            out = fn(dict(zip(obs, leaves[2:])), Camera.from_data(leaves[0], camera.model),
                     Gravity(leaves[1]), h, w, cfg)
        torch.cuda.synchronize()
        return timed(lambda: torch.autograd.grad(out, leaves, cts))

    for fn in (lm_ops.lm_system, lm_ops.lm_system_plain):  # warm
        backward(fn)
    (g_kernel, ms), (g_plain, plain_ms) = backward(lm_ops.lm_system), backward(lm_ops.lm_system_plain)
    err = max(float((a - b).abs().max()) for a, b in zip(g_kernel, g_plain))
    nbytes = sum(t.numel() * t.element_size() for t in (*obs.values(), camera.data, gravity.vec3d,
                                                         *cts)) * 2 - sum(c.numel() * 4 for c in cts)
    log(f"lm kernel VJP B={B} N={h * w}: {ms:.4f} ms (recomputes the plain system), autograd's "
        f"backward through a plain forward {plain_ms:.4f} ms, max abs difference {err:.3e}, "
        f"{nbytes / 1e6:.1f} MB -> {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    return {"route": "plain PyTorch backward of lm_system_plain (ops/lm_system.py "
                     "LMSystemFunction)", "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None}


def train_phase(weights: dict, card: str) -> dict:
    """3 IFT steps and 1 unrolled step at MSCAN-B width on the card, then kernels against
    plain versions on one step's gradients, and a broken VJP that must fail that check."""
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    batch = train_batch(np.random.default_rng(3))
    cfg = train_lib.TrainConfig()  # MSCAN-B, bf16, drop path 0.1, 10 LM steps, IFT
    cfg_u = replace_cfg(cfg, lm_grad_mode="unroll")
    net, state0 = train_lib.create_train_state(cfg, weights, device="cuda")
    log(f"train: batch {TRAIN_B} x {TRAIN_SIZE}x{TRAIN_SIZE}, {cfg}")

    zero_counts()
    lm_ops.lm_system.vjp_calls = 0
    state, step_ms, scalars_all = state0, [], []
    torch.cuda.reset_peak_memory_stats()
    for i, c in enumerate((cfg, cfg, cfg, cfg_u)):
        (state, scalars), ms = timed(lambda: train_lib.train_step(net, c, state, batch, (0, i)))
        scalars = {k: float(v) for k, v in scalars.items()}
        scalars_all.append(scalars)
        step_ms.append(ms)
        log(f"train step {i} ({c.lm_grad_mode}): {ms:.1f} ms, loss {scalars['loss/total']:.5f}, "
            f"grad_norm {scalars['grad_norm']:.4f}, roll error {scalars['metric/roll_error']:.3f} "
            f"deg, vfov error {scalars['metric/vfov_error']:.3f} deg, skipped "
            f"{scalars['skipped_nonfinite']:.0f}")
        check(all(math.isfinite(v) for v in scalars.values()), f"train step {i}: {scalars}")
        check(scalars["skipped_nonfinite"] == 0.0 and scalars["grad_nonfinite"] == 0.0,
              f"train step {i} skipped or had non-finite gradients")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    counts = {"lm_system": lm_ops.lm_system.launches, "nmf": nmf_ops.nmf.launches,
              "lm_vjp_calls": lm_ops.lm_system.vjp_calls}
    log(f"train path launches: {json.dumps(counts)}")
    check(counts["lm_system"] == 4 * (cfg.lm_steps + 1) and counts["nmf"] == 0,
          f"train path: the LM kernel must launch {cfg.lm_steps + 1} times a step and the NMF "
          f"kernel never: {counts}")
    check(counts["lm_vjp_calls"] == cfg.lm_steps, f"unrolled step: {counts['lm_vjp_calls']} VJPs")
    moved = sum(not torch.equal(state.params[k], v) for k, v in state0.params.items())
    stats_moved = sum(not torch.equal(state.batch_stats[k], v) for k, v in state0.batch_stats.items())
    log(f"train: {moved} of {len(state0.params)} parameters and {stats_moved} of "
        f"{len(state0.batch_stats)} running statistics moved")
    check(moved >= 0.9 * len(state0.params) and stats_moved == len(state0.batch_stats),
          "train: the parameters or running statistics did not move")

    lm_ms, device_ms = device_time_by_kernel(
        lambda: train_lib.train_step(net, cfg, state, batch, (0, 9)))
    ift_ms = sum(step_ms[1:3]) / 2
    log(f"train step, IFT (mean of steps 1-2, after a warm step): {ift_ms:.1f} ms; unrolled "
        f"{step_ms[3]:.1f} ms; peak memory {peak_gb:.2f} GiB; in one traced IFT step the LM kernel "
        f"takes {lm_ms:.4f} ms of {device_ms:.1f} ms of device kernels ({lm_ms / ift_ms:.5f} of the "
        f"step); card {card}")
    grads_ms = timed(lambda: train_lib.compute_grads(net, cfg, state, batch, (0, 9)))[1]
    ones = {k: torch.ones_like(v) for k, v in state.params.items()}
    opt_ms = timed(lambda: train_lib.optimizer_update(ones, state.opt_state, state.params, cfg))[1]
    log(f"train step, IFT, parts: forward, LM and backward (compute_grads) {grads_ms:.1f} ms, the "
        f"optimizer over {len(ones)} leaves {opt_ms:.1f} ms")
    del state, net

    # kernels against plain versions on one step's gradients: judged with a float32
    # network, where the comparison measures the LM kernel; with the bf16 network of the
    # steps above it is reported beside a control that changes the plain LM by one
    # rounding, because the bf16 backward turns any such change into leaf noise
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    compare = {}
    for dtype in ("float32", "bfloat16"):
        for mode in ("ift", "unroll"):
            c = replace_cfg(cfg, drop_path_rate=0.0, compute_dtype=dtype, lm_grad_mode=mode)
            compare[f"{dtype} {mode}"] = compare_routes(c, weights, batch, judged=dtype == "float32")
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
     torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) = flags

    _, obs, camera, gravity, h, w, _ = request_system_train(batch, cfg)
    vjp = vjp_timing(obs, camera, gravity, h, w, cfg.lm_config())
    vjp["calls"] = counts["lm_vjp_calls"]
    return {"launches": counts, "step_ms": step_ms, "ift_step_ms": ift_ms,
            "unroll_step_ms": step_ms[3], "peak_gib": peak_gb, "lm_kernel_ms_per_step": lm_ms,
            "device_kernel_ms_per_step": device_ms, "lm_share": lm_ms / ift_ms,
            "compute_grads_ms": grads_ms, "optimizer_ms": opt_ms,
            "scalars": scalars_all, "compare": compare, "vjp": vjp}


def replace_cfg(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


def request_system_train(batch: dict, cfg):
    """The LM system of a training step's solver, at the training shape: the trivial
    estimate on the GT cameras' fields, with confidences of 0.5 (all five planes)."""
    data = synthesize_gt_fields(batch, cfg.camera_model)
    conf = torch.full(data["up_field"].shape[:3], 0.5, device=data["up_field"].device)
    fields = {"up_field": data["up_field"], "latitude_field": data["latitude_field"],
              "up_confidence": conf, "latitude_confidence": conf}
    lm_cfg = cfg.lm_config()
    obs, h, w = flatten_observations(fields, lm_cfg)
    camera, gravity = get_trivial_estimation(fields, lm_cfg)
    return fields, obs, camera, gravity, h, w, lm_cfg


# ---------------------------------------------------------------- loop phase

def rendered_dataset_class(splits: dict):
    """A SimpleDataset whose rows are rendered views held in memory: `splits` maps a
    csv name to (images, truth). It keeps SimpleDataset's contract (conf, rows,
    __len__, epoch(epoch, shard, num_shards, start_batch)) and replaces only how a
    row is read, so the PrefetchLoader, the device augmentation, the step, the
    validation, the checkpoints and the export run unchanged on its batches."""

    class RenderedSplit(loop_lib.SimpleDataset):
        def __init__(self, conf=None, **kw):
            self.conf = conf or loop_lib.DatasetConf(**kw)
            check(self.conf.augmentation == "identity",
                  f"rendered views are fed for augmentation='device', not {self.conf.augmentation}")
            self.images, truth = splits[self.conf.csv_name]
            h, w = self.images.shape[1:3]
            self.rows = [{"fname": f"{self.conf.csv_name}_{i}", "index": i, "height": h, "width": w,
                          "vfov": math.radians(fov), "roll": math.radians(roll),
                          "pitch": math.radians(pitch)} for i, (roll, pitch, fov) in enumerate(truth)]

        def _load_row(self, row, aug_seed):
            gt = [row["width"], row["height"], row["vfov"], row["roll"], row["pitch"], 0.0, 0.0]
            return {"image": torch.from_numpy(self.images[row["index"]]),
                    "gt_params": torch.tensor(gt, dtype=torch.float32)}

    return RenderedSplit


class LoopProbe:
    """Wraps the loop's step and eval factories and its ExperimentManager: the launch
    counts are set to 0 just before each training step and each validation batch and
    read just after; each step is timed between CUDA events; the first step's input
    state and every saved state are kept, with the seconds each save took."""

    def __init__(self):
        self.steps, self.evals, self.events, self.saved, self.save_s = [], [], [], {}, []
        self.first_state = None

    def counted(self, fn, parts: list, timed_steps: bool):
        def run(*args):
            zero_counts()
            if timed_steps:
                if self.first_state is None:
                    self.first_state = args[0]
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            out = fn(*args)
            if timed_steps:
                end.record()
                self.events.append((start, end))
            parts.append({"lm_system": lm_ops.lm_system.launches, "nmf": nmf_ops.nmf.launches})
            return out
        return run

    @contextlib.contextmanager
    def installed(self, dataset_cls):
        probe = self
        make_step, make_eval = loop_lib.make_train_step, loop_lib.make_eval_step
        manager_cls, dataset = loop_lib.ExperimentManager, loop_lib.SimpleDataset

        class Manager(manager_cls):
            def save(self, state, step, *a, **kw):
                t0 = time.perf_counter()
                path = super().save(state, step, *a, **kw)
                probe.save_s.append(time.perf_counter() - t0)
                probe.saved[step] = state
                return path

        loop_lib.make_train_step = lambda *a, **kw: self.counted(make_step(*a, **kw), self.steps,
                                                                 True)
        loop_lib.make_eval_step = lambda *a, **kw: self.counted(make_eval(*a, **kw), self.evals,
                                                                False)
        loop_lib.ExperimentManager, loop_lib.SimpleDataset = Manager, dataset_cls
        try:
            yield self
        finally:
            loop_lib.make_train_step, loop_lib.make_eval_step = make_step, make_eval
            loop_lib.ExperimentManager, loop_lib.SimpleDataset = manager_cls, dataset


def states_equal(a, b) -> bool:
    """Two TrainStates bit for bit: step, parameters, statistics, Adam count and moments."""
    trees = lambda s: (s.params, s.batch_stats, s.opt_state.mu, s.opt_state.nu)
    return (int(a.step) == int(b.step) and torch.equal(a.opt_state.count.cpu(), b.opt_state.count.cpu())
            and all(set(x) == set(y) and all(torch.equal(x[k].cpu(), y[k].cpu()) for k in x)
                    for x, y in zip(trees(a), trees(b))))


def loop_phase(weights: dict, card: str) -> dict:
    """The training loop (geocalib_tpu_torch.training.train.training) on the card, as a
    user runs it: MSCAN-B, batch 24 at 320x320, bf16, 10 LM steps with IFT gradients,
    the device augmentation, from the r05 weights through train.init_weights; LOOP_STEPS
    steps with logs, a validation of LOOP_VAL_BATCHES batches and checkpoints, then
    LOOP_RESTORED_STEPS more after restore=True. The card has no PIL and no dataset,
    so the dataset class is replaced at the train.SimpleDataset seam by rendered views
    held in memory (rendered_dataset_class); everything after it runs unchanged.
    Checks: every logged scalar finite and no step skipped, the parameters moved,
    the launch counts of each step (11 LM, 0 NMF) and each validation batch (11 LM,
    1 NMF), the metrics.jsonl records, a checkpoint restored on the card bit for bit
    equal to the saved state and the restored run's first step starting from it, the
    exported msgpack read back bit for bit, and one validation batch by the kernels
    against the plain versions within LOOP_ANGLE_TOL, LOOP_RECALL_TOL and LOOP_LOSS_TOL."""
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    rng = np.random.default_rng(6)
    splits = {name: scenes(rng, n, TRAIN_SIZE, TRAIN_SIZE) for name, n in LOOP_VIEWS.items()}
    out_dir = ROOT / ".smoke" / f"loop_{os.getpid()}"
    shutil.rmtree(out_dir, ignore_errors=True)
    t = LOOP_STEPS
    conf = loop_config.merge(loop_lib.default_conf, {
        "train": {"total_steps": t, "log_every": LOOP_LOG_EVERY, "eval_every": t // 2,
                  "save_every": t // 2, "val_batches": LOOP_VAL_BATCHES, "figures_every": 0,
                  "init_weights": str(WEIGHTS)},
        "data": {"dataset_dir": "rendered views in memory", "batch_size": TRAIN_B,
                 "augmentation": "device"}})
    log(f"loop: {json.dumps(conf)}")
    probe = LoopProbe()
    torch.cuda.reset_peak_memory_stats()
    with probe.installed(rendered_dataset_class(splits)):
        t0 = time.perf_counter()
        loop_lib.training(conf, str(out_dir))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        first_steps = len(probe.steps)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        saved = probe.saved[t]

        cfg = loop_lib.make_train_config(conf)
        net, template = train_lib.create_train_state(cfg, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, step = loop_lib.ExperimentManager(out_dir).restore(template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = states_equal(restored, saved) and step == t
        log(f"loop: checkpoint {step} restored on the card in {restore_s:.2f} s, bit for bit "
            f"equal to the saved state (step, parameters, statistics, Adam count and moments): "
            f"{same}")
        check(same, "loop: the restored checkpoint differs from the saved state")

        probe.first_state = None
        conf_r = loop_config.apply_dotlist(conf, [f"train.total_steps={t + LOOP_RESTORED_STEPS}"])
        t0 = time.perf_counter()
        last = loop_lib.training(conf_r, str(out_dir), restore=True)
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
        check(probe.first_state is not None and states_equal(probe.first_state, saved),
              "loop: the restored run's first step did not start from the saved state")
        log(f"loop: the restored run's first step started from checkpoint {t}: True")

    records = [json.loads(line) for line in (out_dir / "logs" / "metrics.jsonl").read_text().splitlines()]
    final = probe.saved[t + LOOP_RESTORED_STEPS]
    nonfinite = [(r["step"], k) for r in records for k, v in r.items() if not math.isfinite(v)]
    skipped = [r["step"] for r in records if r.get("skipped_nonfinite", 0) or r.get("grad_nonfinite", 0)]
    check(not nonfinite and not skipped, f"loop: non-finite scalars {nonfinite}, skipped {skipped}")
    init = params_from_jax(read_flax_msgpack(WEIGHTS), "b")
    moved = sum(not torch.equal(final.params[k].cpu(), init[k]) for k in final.params)
    log(f"loop: {moved} of {len(final.params)} parameters moved from the r05 weights")
    check(moved >= 0.9 * len(final.params), "loop: the parameters did not move")

    steps = [r["step"] for r in records if "loss/total" in r]
    vals = [r["step"] for r in records if "val/loss/total" in r]
    want_steps = [s for s in range(t + LOOP_RESTORED_STEPS) if s % LOOP_LOG_EVERY == 0]
    want_vals = [s for s in range(1, t) if s % (t // 2) == 0]
    log(f"loop: metrics.jsonl training records at steps {steps}, validation records at {vals}")
    check(steps == want_steps and vals == want_vals,
          f"loop: records {steps} / {vals}, expected {want_steps} / {want_vals}")
    ckpts = sorted(p.name for p in out_dir.glob("checkpoint_*"))
    log(f"loop: checkpoints {ckpts}")
    check({f"checkpoint_{t // 2}", f"checkpoint_{t}", f"checkpoint_{t + LOOP_RESTORED_STEPS}",
           "checkpoint_best"} <= set(ckpts), f"loop: checkpoints {ckpts}")

    per_step = cfg.lm_steps + 1
    check(len(probe.steps) == t + LOOP_RESTORED_STEPS and len(probe.evals) == len(want_vals) * LOOP_VAL_BATCHES,
          f"loop: {len(probe.steps)} steps and {len(probe.evals)} validation batches")
    check(all(c == {"lm_system": per_step, "nmf": 0} for c in probe.steps),
          f"loop: a step must launch the LM kernel {per_step} times and the NMF kernel never: "
          f"{probe.steps}")
    check(all(c == {"lm_system": per_step, "nmf": 1} for c in probe.evals),
          f"loop: a validation batch must launch the LM kernel {per_step} times and the NMF "
          f"kernel once: {probe.evals}")
    launches = {k: sum(c[k] for c in probe.steps + probe.evals) for k in ("lm_system", "nmf")}
    log(f"loop: launches per step {probe.steps[0]}, per validation batch {probe.evals[0]}; in "
        f"all {json.dumps(launches)} over {len(probe.steps)} steps and {len(probe.evals)} "
        f"validation batches")

    t0 = time.perf_counter()
    export = out_dir / "export.msgpack"
    got = loop_export.export_checkpoint(out_dir, export)
    export_s = time.perf_counter() - t0
    back = params_from_jax(read_flax_msgpack(export), "b")
    exact = got == t + LOOP_RESTORED_STEPS and all(
        torch.equal(back[k], v.cpu()) for tree in (final.params, final.batch_stats)
        for k, v in tree.items())
    log(f"loop: exported step {got} in {export_s:.2f} s; read back by read_flax_msgpack and "
        f"params_from_jax, bit for bit equal to the final parameters and statistics: {exact}")
    check(exact, "loop: the exported msgpack differs from the final state")
    calib = geocalib_tpu_torch.GeoCalib(weights=str(export), compute_dtype="bfloat16")
    out = calib.calibrate(splits["val.csv"][0][0])
    finite(out)
    log(f"loop: GeoCalib(weights=<export>) calibrates a view: roll "
        f"{math.degrees(float(out['gravity'].roll)):.3f} deg against the rendered "
        f"{splits['val.csv'][1][0][0]:.3f}")
    del calib

    # one validation batch by the kernels and by the plain versions, same state
    val_ds = rendered_dataset_class(splits)(loop_lib.DatasetConf(csv_name="val.csv", batch_size=TRAIN_B,
                                                                 shuffle=False))
    batch = {k: v.cuda() for k, v in next(val_ds.epoch()).items()}
    eval_fn = train_lib.make_eval_step(net, cfg)
    kern = {k: float(v) for k, v in eval_fn(final, batch, (0, 7)).items()}
    with plain_versions():
        plain = {k: float(v) for k, v in eval_fn(final, batch, (0, 7)).items()}
    dev = {}
    for k, v in plain.items():
        d = abs(kern[k] - v)
        bound, kind = ((LOOP_RECALL_TOL, "abs") if "recall" in k else
                       (LOOP_ANGLE_TOL, "abs deg") if k.startswith("metric/") else
                       (LOOP_LOSS_TOL, "rel"))
        d = d / max(abs(v), 1e-12) if kind == "rel" else d
        dev[k] = {"dev": d, "bound": bound, "kind": kind, "ok": d <= bound}
    worst = {kind: max((x for x in dev.items() if x[1]["kind"] == kind), key=lambda x: x[1]["dev"])
             for kind in ("abs", "abs deg", "rel")}
    for kind, (k, x) in worst.items():
        log(f"loop validation, kernels vs plain: largest {kind} deviation {x['dev']:.3e} in {k} "
            f"(bound {x['bound']})")
    check(all(x["ok"] for x in dev.values()),
          f"loop validation, kernels vs plain: {[k for k, x in dev.items() if not x['ok']]}")

    # the host's share of one step, and its parts
    step_fn = train_lib.make_train_step(net, cfg, augment_on_device=True)
    train_batch_ = {k: v.cuda() for k, v in next(rendered_dataset_class(splits)(
        loop_lib.DatasetConf(batch_size=TRAIN_B)).epoch()).items()}
    run = lambda: step_fn(final, train_batch_, (0, 11))
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    lm_ms, device_ms = device_time_by_kernel(run)
    aug_ms = timed(lambda: train_lib.augment_batch(train_batch_, (0, 11)))[1]
    ms = sorted(s.elapsed_time(e) for s, e in probe.events[2:first_steps] + probe.events[first_steps + 1:])
    rates = [r["images_per_s"] for r in records if r.get("images_per_s")]
    stall = [r["loader_stall_s"] for r in records if "loader_stall_s" in r]
    result = {"step_ms_median": ms[len(ms) // 2], "step_ms": ms, "images_per_s_by_window": rates,
              "loader_stall_s": stall, "wall_ms_one_step": wall_ms, "device_ms_one_step": device_ms,
              "lm_kernel_ms_one_step": lm_ms, "host_share": (wall_ms - device_ms) / wall_ms,
              "augment_ms": aug_ms, "peak_gib": peak_gb, "save_s": probe.save_s,
              "restore_s": restore_s, "export_s": export_s, "first_run_s": first_s,
              "restored_run_s": second_s, "launches": launches, "validation_vs_plain": dev,
              "last_scalars": {k: last[k] for k in ("loss/total", "metric/roll_error")}}
    log(f"loop step: median {result['step_ms_median']:.1f} ms between CUDA events over "
        f"{len(ms)} steps (the first two of the first run and the first of the restored run "
        f"left out), range {ms[0]:.1f} to {ms[-1]:.1f} ms; images/s per log window "
        f"{[round(r, 1) for r in rates]}; loader_stall_s per window {[round(x, 3) for x in stall]}; "
        f"peak memory {peak_gb:.2f} GiB; card {card}")
    log(f"loop step alone: {wall_ms:.1f} ms wall, {device_ms:.1f} ms of device kernels (LM kernel "
        f"{lm_ms:.3f} ms), host share {result['host_share']:.3f}; the device augmentation of a "
        f"batch {aug_ms:.2f} ms; checkpoint saves {[round(x, 2) for x in probe.save_s]} s, restore "
        f"{restore_s:.2f} s, export {export_s:.2f} s; runs {first_s:.1f} s and {second_s:.1f} s; "
        f"card {card}")
    del net, template, restored, saved, final, probe
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return result


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

    evaluation = eval_phase(weights, calib, card)
    train = train_phase(weights, card)
    loop = loop_phase(weights, card)

    by_model = {m: sum(c["lm_system_by_model"].get(m, 0) for c in counts.values())
                + evaluation["lm_by_model"][m] for m in lm_ops.MODEL_IDS}
    by_model["pinhole"] += train["launches"]["lm_system"] + loop["launches"]["lm_system"]
    for model, entry in lm["per_model"].items():
        entry["launches"] = by_model[model]
    paths = lambda name: {"serving a-e": launches[name], "eval": evaluation["launches"][name],
                          "train": train["launches"][name], "loop": loop["launches"][name]}
    kernels = [
        {"name": "lm_system", "route": "cuda", "source": "geocalib_tpu_torch/csrc/lm_system.cu",
         "replaces": "geocalib_tpu/ops/lm_kernel.py:195",
         "launches": sum(paths("lm_system").values()),
         "launches_by_path": paths("lm_system"), **lm,
         "eval_shape": {k.split()[1]: v for k, v in evaluation["at_shape"].items() if " " in k},
         "vjp": {**train["vjp"], "replaces": "geocalib_tpu/ops/lm_kernel.py:221-249"}},
        {"name": "nmf", "route": "cuda", "source": "geocalib_tpu_torch/csrc/nmf.cu",
         "replaces": "geocalib_tpu/ops/nmf_kernel.py:86", "launches": sum(paths("nmf").values()),
         "launches_by_path": paths("nmf"), **nmf, "eval_shape": evaluation["at_shape"]["nmf"]},
    ]
    train_line = {k: train[k] for k in ("ift_step_ms", "unroll_step_ms", "step_ms", "peak_gib",
                                        "lm_kernel_ms_per_step", "device_kernel_ms_per_step",
                                        "lm_share", "compute_grads_ms", "optimizer_ms", "compare")}
    log(json.dumps({"eval": {k: v for k, v in evaluation.items()
                             if k not in ("lm_by_model", "at_shape")},
                    "card": card}, default=str))
    log(json.dumps({"train": train_line, "card": card}, default=str))
    log(json.dumps({"loop": loop, "card": card}, default=str))
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
