#!/usr/bin/env python3
"""Smoke run of geocalib_tpu_torch on one CUDA card: the port still starts.

Builds the CUDA kernels from geocalib_tpu_torch/csrc, serves six
GeoCalib.calibrate requests at MSCAN-B width on the committed weights
(weights/geocalib_synth_r05.msgpack; the baselines phase also reads
weights/deepcalib_deepcalib_r04.msgpack), one for each path:

  a  16 views at 480x640, pinhole
  b  one view, pinhole
  c  one view, simple_radial, a focal prior
  d  8 views of one camera, radial, shared intrinsics
  e  4 views through a division-model lens, simple_divisional, served by a
     second GeoCalib with the heuristic init
  f  request a's views through a third GeoCalib with compute_dtype="float32"
     (the network and the NMF kernel's float32 instance in float32)

Each request's launch counts are set to 0 just before it and read just after,
and it must have launched both kernels (the LM kernel in its camera model's
instance, the NMF kernel in its network's dtype). Then it holds each kernel
against its plain PyTorch version at the serving shapes of requests a, c, d
and e, traces one LM kernel call with torch.profiler (it must be one launch),
times the NMF kernel and each of the LM kernel's four model instances at
request a's shape and at one lane of it, checks that two NMF launches give the
same bits, and holds the NMF kernel's float32 instance (TF32 tensor cores,
three products a product) on request f's tokens against nmf_plain in full
float32 (relative Frobenius within NMF_F32_TOL, a control of one step fewer
that must exceed it, nmf_plain with cuBLAS in TF32 as a control that must
deviate more, two launches bit for bit), timed beside its bound on TF32 and
its float32 FMA bound; nmf_plain always runs with TF32 off. It prints the
registers and spills of the kernels (and fails if an NMF stage spills), and
ends with the whole-path gate: requests a, c, d, e and f, and two requests the
gate alone serves, on perspective crops at 480x640 of four synthetic panoramas
(two streets of buildings with window grids, two rooms) rendered on the card,
whose vertical structure fixes the vFoV where request a's ground plane does not:
g, 16 crops, pinhole, as request a; h, 8 crops through request e's lens,
simple_divisional with the heuristic init, as request e. Each is served again by
the kernels and by the plain versions, converged (the solver's early stop off, so
every lane runs all 30 iterations: roll, pitch and vFoV within 0.05 degrees in
every lane) and serving (early stop on, as users run it: a lane that stops at
the plain path's iteration is held, per angle, to max(4 s, 0.001 degrees), s
being the largest deviation of eight no-kernel controls from the plain path in
that lane (GATE_CONTROLS; argued in serving_rule), and to no more than 0.05
degrees unless the lane is named ill-conditioned (its bound exceeds 0.05
degrees) and is one of at most one lane in eight of its request so named;
where more are, none is widened; lanes that stop apart must be one iteration
apart, and are named). The kernels must pass every lane of every request.
The same rule must fail three planted faults: the NMF kernel one step short,
and the LM kernel's fixed point moved by 0.02 degrees in both gravity
coordinates, or in the focal alone so that the vFoV moves by 0.02 degrees; the
two LM faults must fail in g and in h. It must pass the kernels with the NMF at
1536 and 2048 tokens a chunk, save in ill-conditioned lanes of a request with
more than its share of them, where a failure is reported as open; in g and h a
chunk route's other failures are reported too, since the rule failed an honest
reordering there (gate_known_routes).

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
shown to give the same bits. With a float32 network, judged: loss terms
within 1e-4, the gradient's global norm within 1e-3, each leaf over 1e-6 of it
within 1e-2 relative L2; a broken VJP (zero cotangents for the confidence
planes) must fail that comparison in unroll mode. With the bf16 network,
reported beside a no-kernel control (the plain LM with G times 1 + 2^-22);
compare_routes says why bf16 cannot be judged so.

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

The LM phase also drives the LM kernel's cost-only instance (the TPU kernel's
with_system=False) at request a's planes for each camera model, as a path of
its own (one launch each): its cost must equal the full instance's bit for
bit and the plain version's within LM_TOL, with its time and bound.

Then the generate phase, a path of its own, through the port's per-pano
functions (data/generate.py): 4 panoramas at the openpano_synth_v2
configuration (seed 1, 640x1280 panoramas, 16 crops of 320x320, pinhole), 2 at
openpano_radial_v2's (seed 2, simple_radial) and 1 at the module's defaults
(768x1536, 16 crops of 640x640). Each panorama's synthesis on the host is timed,
its crops rendered on the card (CUDA events) and on the CPU: rows equal, each
crop pixel's sample coordinates within RENDER_COORD_TOL pano pixels of the
CPU's on the sphere, and the card's sampler equal to the CPU's on the same
coordinates within RENDER_SAMPLER_TOL. The 96 crops at 320x320 are calibrated
on the card (batch 16, each set's camera model; 1 NMF and 31 LM launches a
batch), and the median roll and pitch errors against the rows' truth (roll as
Gravity.roll reads it) must be within GENERATE_ANGLE_TOL. Last, generate_dataset
itself runs on the card with a pool of synthesis workers (4 panoramas at the
radial set's configuration; the JPEG writer replaced by an in-memory store, as
the card has no PIL): every row's crop rendered on the card, and the train
CSV's rows equal, as text, to the per-pano run's. Then the demo phase:
InteractiveDemo.process_frame with every overlay on, on 4 generated
simple_radial crops for pinhole, simple_radial and simple_divisional (counts
set to 0 around it); frames finite and of the crop's shape, undistort_image
and the overlays by the card against the same camera and gravity on the CPU,
and milliseconds per frame.

Then the baselines phase (optim/ransac.py, optim/gradient.py, the DeepCalib
network, eval/baselines_cli.py and training/train_deepcalib.py), a path of its
own: one calibrate of request a's views (1 NMF and 31 LM launches, counted)
gives the fields on which run_ransac (the default RansacConfig: 2,000
hypotheses, chunks of 100, stride 4, with the confidences) and
run_gradient_descent (100 Adam steps) run on the card and again on the CPU
from the same fields: RANSAC's samples bit for bit, each hypothesis within
1e-5 relative where its minimal sample is well-conditioned and within 4 times
its one-ulp spread where it is not (argued in ransac_rule; a planted fault of
each kind must fail), at most 1% apart, and the card's winner, scored on the
CPU, within one pixel weight of the CPU winner's score;
Adam's final roll, pitch and vFoV within GD_TOL; each solver's errors against
the rendered truth and the LM's estimate logged. DeepCalib on the committed
weights/deepcalib_deepcalib_r04.msgpack: 16 rendered 320x320 views at batch 8,
its float32 logits (TF32 off) within 1e-3 of the port's on the CPU on the same
bf16-rounded inputs, no bin apart off a tie; the deepcalib and trivial methods
through evaluate_baseline, fed from memory. Then train_deepcalib.training at
its default conf (batch 32, 320x320, the "deepcalib" augmentation) from the r04
weights on 64 staged rendered views, 6 steps, then 2 after a restore: the
restored state bit for bit the saved one, the export read back equal to the
final state with its conf, every loss finite. Times (CUDA events) and peak
memory are printed with the card. UVP is host-only (numpy and OpenCV by
design; the card's machine has no cv2): the phase says so and does not run it.

Then the hub_pose phase (hub.py, models/convert_torch.py, pose_estimation.py,
ops/winograd.py), a path of its own. Hub: an original GeoCalib checkpoint is
made in memory from the r05 Flax tree (the converter's table read backwards)
and torch.saved into a temporary directory outside the repository, with
GEOCALIB_TPU_CACHE pointing at another; hub.load converts and caches it, and
its GeoCalib must give request a's 16 views bit for bit as the r05 msgpack
does, and again after a second load from the cache (each calibrate 1 NMF and
31 LM launches, counted). Pose: AbsolutePoseEstimator with the card's
GeoCalib on request a's first POSE_VIEWS views, each with ground-plane
correspondences of a known pose and seeded outliers; the same estimator on the
CPU given the same calibration must return the same bits, and the recovered
rotation must lie within the bound argued at POSE_GRAVITY_SHARE of the
calibration's gravity error (1 NMF and 31 LM launches a view, counted).
Winograd: winograd_conv3x3 against F.conv2d in float32 with TF32 off, at
tests/test_winograd.py's shapes and at the LightHamHead's 3x3 shape, within
2e-4, both timed.

Last, the distributed phase (parallel/mesh.py), a path of its own: 2 IFT steps
of the train phase's setup with a float32 network, without a process group
and with an NCCL group of one rank in this process, bit for bit equal; then
DIST_RANKS ranks started with multiprocessing's spawn on this one card over
gloo (NCCL refuses two ranks on one GPU), each 12 rows of the batch of 24: 3
IFT steps and 1 unrolled step through the kernels (launches counted around each
step: 11 LM, 0 NMF) and through the plain versions, the ranks' states equal
bit for bit after every step, each step's mean gradient by the kernels against
the plain versions' on the same state by the train phase's float32 rule (with
a bf16 network, the first step reported beside the train phase's no-kernel
controls), the same comparison without the mesh
and with the train phase's setup (reported beside the steps' worst leaf), the
staged store split by rank (one staged step and one eval window: 11 LM, and 1
NMF of the float32 instance in the window; the window by the kernels against
the plain versions by the loop phase's rule with the float32 loss bound, the
NMF against nmf_plain on the window's own inputs within NMF_F32_TOL, each
beside a control with one NMF step fewer that must fail), and the
shared-intrinsics LM on each rank's 8 lanes of request a within DIST_VFOV_TOL
of this process on all 16 (31 LM launches). Each rank's step time, the
gradient's all-reduce and its bytes, the all-reduces a step, the peak memory
and the phase's time are printed with the card; the gloo times go through the
host and say nothing of NCCL between cards. A rank that exits non-zero or
outlives DIST_TIMEOUT_S fails the run.

Run from the repository root, on a machine with one card:

    python3 chip_smoke.py

It exits non-zero, and prints no result, without a card or outside the
repository. Every line is flushed as it is printed; the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import copy
import csv
import dataclasses
import datetime
import faulthandler
import hashlib
import json
import math
import multiprocessing as mp
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

import geocalib_tpu_torch
from geocalib_tpu_torch import hub as hub_lib, pose_estimation as pose_lib
from geocalib_tpu_torch.data import generate as gen_lib, pano as pano_lib
from geocalib_tpu_torch.data.dataset import synthesize_gt_fields
from geocalib_tpu_torch.demo import demo as demo_lib, overlays as overlays_lib
from geocalib_tpu_torch.eval import baselines_cli as baselines_lib
from geocalib_tpu_torch.eval import pipeline as eval_lib
from geocalib_tpu_torch.geometry import planar_fields as pf
from geocalib_tpu_torch.parallel import mesh as pmesh
from geocalib_tpu_torch.training import device_store as store_lib
from geocalib_tpu_torch.training import export as loop_export
from geocalib_tpu_torch.training import train as loop_lib
from geocalib_tpu_torch.training import train_deepcalib as deepcalib_train
from geocalib_tpu_torch.training import train_step as train_lib
from geocalib_tpu_torch.utils import config as loop_config
from geocalib_tpu_torch.models import convert_torch, hamburger, modules as modules_lib
from geocalib_tpu_torch.models.weights import (deepcalib_params_to_jax, params_from_jax,
                                               read_flax_msgpack)
from geocalib_tpu_torch.ops import build, lm_system as lm_ops, nmf as nmf_ops, winograd
from geocalib_tpu_torch.optim import gradient as gd_lib, lm as lm_solver, ransac as ransac_lib
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
TF32_FLOPS = 495e12  # the float32 NMF takes each product as three TF32 products
# Float operations per pixel of the LM system with all five planes and the huber
# loss, counted by hand from its formulas (IEEE divisions and square roots): an
# FMA as two, a sqrt, division, negation, max or compare as one, a subexpression
# the model's functions share (q, sigma', sigma'' of the divisional model) once.
# The 0/1 parameter mask is not counted: it multiplies the lane's sums, not the
# pixels' Jacobian rows.
LM_FLOPS_PER_PIXEL = {"pinhole": 228, "simple_radial": 351, "radial": 425,
                      "simple_divisional": 383}
# The same count for the cost-only instance (with_system=False): r², the predicted
# up vector and sin(latitude), the residuals, the huber loss's value, the
# confidences and the sums; the Jacobians, the IRLS weights and G, H drop out.
LM_COST_FLOPS_PER_PIXEL = {"pinhole": 55, "simple_radial": 71, "radial": 82,
                           "simple_divisional": 84}
# The distortion of the camera each LM instance is timed with, at request a's shape.
LM_TIMING_K = {"pinhole": (0.0, 0.0), "simple_radial": (-0.1, 0.0), "radial": (-0.1, 0.02),
               "simple_divisional": (-0.3, 0.0)}

LM_TOL = 1e-4    # f32 relative deviation of G, H and cost: sums taken in another order
NMF_TOL = 2e-2   # relative Frobenius error of the bf16 reconstruction, 7 steps
NMF_F32_TOL = 1e-4  # the same for the float32 instance
ANGLE_TOL = 0.05  # degrees, whole path with kernels against the plain versions
GATE_REQUESTS = ("a", "c", "d", "e", "f", "g", "h")  # served by both routes for the whole-path gate
# Requests g and h, the gate's own (gate_pano_requests): crops of synthetic panoramas with
# vertical structure. synthetic_pano's seeds, each of whose first draw selects a room (0, 1)
# or a street of buildings (2, 3); the panorama's size, whose pixel (pi / 1023 rad) is no
# coarser than a 480-row crop's at the centre at vFoV 1.3 rad (tan(0.65) / 240 = 0.00317
# rad); and the seeds of each request's crop draws.
GATE_PANO_SEEDS, GATE_PANO_SIZE = (0, 1, 2, 3), (1024, 2048)
GATE_VIEW_SEEDS = {"g": 11, "h": 12}
GATE_PANO_REQUESTS = tuple(GATE_VIEW_SEEDS)
# The serving comparison (argued in serving_rule): the no-kernel controls whose
# largest deviation from the plain path, per lane and angle, is the lane's spread s;
# a lane is held to max(GATE_SPREAD_FACTOR * s, GATE_FLOOR_DEG) degrees, named
# ill-conditioned where that exceeds ANGLE_TOL, and held past ANGLE_TOL only if at
# most one lane in GATE_ILL_PER_LANES of its request (rounded up) is so named.
GATE_CONTROLS = ("plain NMF, sums in float64", "plain NMF, token sums in 2 chunks",
                 "plain NMF, token sums in 4 chunks", "plain NMF, products on cuBLAS",
                 "plain LM, G x (1 + 2^-22)", "plain LM, H x (1 + 2^-22)",
                 "plain LM, pixels in reverse order", "plain LM, pixels rotated by half")
GATE_SPREAD_FACTOR, GATE_FLOOR_DEG, GATE_ILL_PER_LANES = 4.0, 1e-3, 8
# Routes whose serving verdict is known: the NMF kernel at other chunk sizes (honest
# reorderings of its sums, which must pass where the rule can judge them: see
# gate_known_routes), and three planted faults that must fail: the NMF kernel one step
# short, and the LM kernel with G + H v, which moves the solver's fixed point by -v: v =
# GATE_LM_SHIFT_DEG (in radians) in both gravity coordinates, or in the focal alone,
# sized so that the vFoV moves by GATE_LM_SHIFT_DEG (shifted_lm).
GATE_CHUNKS = (1536, 2048)
GATE_LM_SHIFT_DEG = 0.02
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
# The generate phase: name -> (panoramas, camera model, seed, dataset_conf overrides).
# The first two are the committed training sets' configurations (.gitignore records
# their commands), the third the module's defaults.
GENERATE_SETS = {
    "openpano_synth_v2": (4, "pinhole", 1, {"height": 320, "width": 320, "pano_height": 640,
                                            "pano_width": 1280}),
    "openpano_radial_v2": (2, "simple_radial", 2, {"height": 320, "width": 320,
                                                   "pano_height": 640, "pano_width": 1280}),
    "defaults": (1, "pinhole", 0, {}),
}
# The card's render against the CPU's, with the CPU tests' bounds
# (tests/test_torch_generate.py): where a crop pixel samples the pano within
# RENDER_COORD_TOL pano pixels on the sphere (8 float32 ulps of a coordinate near
# 1280; pano.sample_distance counts the seam's two columns and a pole's row as one
# direction), and the sampler on equal coordinates within RENDER_SAMPLER_TOL. The
# crops' values are reported, not judged: at a 1280-wide pano a coordinate's ulp is
# 1.2e-4 px, and at the ±π seam a ray whose x rounds to the other sign samples the
# other edge column. RENDER_TOL holds the demo's undistortion (no seam, a 320-pixel
# image).
RENDER_COORD_TOL, RENDER_SAMPLER_TOL, RENDER_VALUE_REPORT = 1e-3, 1e-6, 1e-4
RENDER_TOL = 1e-4
GENERATE_CALIB_SIZE, GENERATE_CALIB_BATCH, GENERATE_CALIB_CROPS = 320, 16, 96
GENERATE_POOL_PANOS, GENERATE_POOL_WORKERS = 4, 2  # generate_dataset's train split: 2 panos
# degrees: a sign or axis error in the renderer's rotation gives medians of 20 to 45
# for roll and pitch drawn over +-45
GENERATE_ANGLE_TOL = 5.0
DEMO_MODELS, DEMO_FRAMES, DEMO_PIXEL_SHARE = ("pinhole", "simple_radial",
                                              "simple_divisional"), 4, 1e-3
# The baselines phase (the port's optim/ransac.py, optim/gradient.py, models/deepcalib.py,
# eval/baselines_cli.py, training/train_deepcalib.py): the committed DeepCalib weights,
# its rendered views (inference at BASELINE_BATCH, the trainer's staged rows), the
# trainer's steps before and after a restore, and the bounds (see baselines_phase).
DEEPCALIB_WEIGHTS = ROOT / "weights" / "deepcalib_deepcalib_r04.msgpack"
BASELINE_VIEWS, BASELINE_SIZE, BASELINE_BATCH = 16, 320, 8
DEEPCALIB_TRAIN_VIEWS = {"train.csv": 64, "val.csv": 16}
DEEPCALIB_STEPS, DEEPCALIB_RESTORED_STEPS = 6, 2
# card against CPU: float32 logits (TF32 off on the card), and the top-two margin under
# which a head's bin may go either way
DEEPCALIB_LOGIT_TOL, DEEPCALIB_TIE = 1e-3, 1e-3
# card against CPU, argued in ransac_rule: each hypothesis within RANSAC_HYP_TOL
# relative where its minimal sample is well-conditioned, within RANSAC_SPREAD_FACTOR
# times its one-ulp spread (RANSAC_SPREAD_DRAWS draws) where it is not, and at most
# RANSAC_ILL_SHARE of them apart (a ceiling; the share is also bounded by the share of
# ill-conditioned samples, which the rule implies)
RANSAC_HYP_TOL, RANSAC_SPREAD_DRAWS, RANSAC_ILL_SHARE = 1e-5, 8, 0.01
RANSAC_SPREAD_FACTOR = 4.0
# radians, Adam's final roll, pitch and vFoV, card against CPU (argued in PERF.md §6)
GD_TOL = 1e-4

# The hub_pose phase (hub.py, models/convert_torch.py, pose_estimation.py, ops/winograd.py).
# Pose: request a's first POSE_VIEWS views, each with POSE_POINTS ground-plane
# correspondences of a known pose, POSE_OUTLIER_SHARE of them replaced by outliers drawn at
# least POSE_OUTLIER_MIN_PX from their point's true projection (twice the estimator's
# 48-pixel inlier threshold, so that an outlier is never taken for an inlier). The bound on
# the recovered rotation, argued before the first card run: the estimator's refinement
# minimises the inliers' squared reprojection error plus w·|R g_w − g_c|² (w = 50,000),
# where g_c, the calibration's gravity, is δ_g off the truth. The inliers are exact, so
# their term is 0 at the true pose and grows as κ·N·f²·φ² with the tilt error φ (N ≈ 140
# inliers, f ≥ 400 px; κ ≤ 1 is the share of that curvature the translation cannot absorb,
# at least 0.2 for ground points 2 to 40 m away). At the optimum φ = δ_g·w / (w + κ·N·f²)
# ≤ 0.011·δ_g; the yaw has no prior and the points fix it. So angle(R, R_true) ≤
# POSE_GRAVITY_SHARE·δ_g + POSE_FLOOR_DEG, the floor for Gauss-Newton's 10 steps with a
# numeric Jacobian. The bound is judged where the estimator takes the gravity branch: a
# view whose gravity uncertainty is over PoseOpts.max_uncertainty (10°) falls back to DLT
# PnP, which is degenerate on coplanar points (the JAX package's design, copied), so those
# views are reported, not judged; at least one view must take the gravity branch.
POSE_VIEWS, POSE_POINTS, POSE_OUTLIER_SHARE, POSE_OUTLIER_MIN_PX = 8, 200, 0.3, 96.0
POSE_GRAVITY_SHARE, POSE_FLOOR_DEG = 0.05, 0.01
# Winograd on the card against F.conv2d, float32 with TF32 off: the shapes of
# tests/test_winograd.py (B, H, W, C, F) and the LightHamHead's 3x3 conv_up at an eval
# batch of 8 at 320x320 (64 channels at 160x160), within that test's rtol and atol.
WINOGRAD_SHAPES = [(2, 8, 8, 4, 6), (1, 16, 12, 8, 8), (2, 32, 32, 16, 16), (2, 32, 32, 32, 32),
                   (8, 160, 160, 64, 64)]
WINOGRAD_TOL = 2e-4

# The distributed phase: the ranks spawned on the one card (gloo), how long a rank may
# run, the steps of the NCCL one-rank check, the staged rows split over the ranks, the
# shared LM's vFoV bound over the ranks against one process (radians, as the JAX
# package's 2-process test holds itself), and the timed repeats of the gradient's
# all-reduce.
DIST_RANKS, DIST_TIMEOUT_S, DIST_NCCL_STEPS, DIST_STAGED_ROWS = 2, 600, 2, 24
DIST_VFOV_TOL, DIST_ALLREDUCE_REPS = 1e-5, 5


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


def gate_panos() -> Tuple[list, float]:
    """The panoramas of requests g and h: synthetic_pano at GATE_PANO_SEEDS and
    GATE_PANO_SIZE, one host thread each (numpy releases the GIL in its array
    work; each seed has its own generator, so the arrays are the serial ones), and
    the seconds it took."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(GATE_PANO_SEEDS)) as pool:
        panos = list(pool.map(lambda s: pano_lib.synthetic_pano(s, *GATE_PANO_SIZE),
                              GATE_PANO_SEEDS))
    return panos, time.perf_counter() - t0


def pano_views(panos: list, rng: np.random.Generator, n: int, h: int, w: int,
               k1: float = 0.0, device="cuda"):
    """Perspective crops of synthetic panoramas: streets of building boxes with window
    grids, and rooms, whose vertical edges fix the vFoV where a ground plane alone
    does not.

    Crop i comes from panos[i % len(panos)]. Each draws, in this order, its roll and
    pitch in +-0.3 rad, its vFoV in 0.7-1.3 rad (as scenes does) and its yaw in
    [0, 2 pi), and is rendered by render_from_pano on `device`, its camera built as
    data/generate.py row_views builds a dataset row's; with k1 the camera is
    simple_divisional, a pixel's normalised coordinate p mapping to the ray
    (p / (1 + k1 |p|^2), 1), the lens of scenes with that k1. Returns the crops (n, h,
    w, 3) float32 on the host and each crop's (roll, pitch, vfov) in degrees.
    """
    draws = [(*rng.uniform(-0.3, 0.3, 2), rng.uniform(0.7, 1.3), rng.uniform(0.0, 2 * math.pi))
             for _ in range(n)]
    model = "simple_divisional" if k1 else "pinhole"
    images = np.empty((n, h, w, 3), np.float32)
    for p, pano in enumerate(panos):
        lanes = list(range(p, n, len(panos)))
        rows = [{"height": h, "width": w, "roll": draws[i][0], "pitch": draws[i][1],
                 "vfov": draws[i][2], "k1": k1} for i in lanes]
        yaw = np.array([draws[i][3] for i in lanes], np.float32)
        cam, grav, yaw_t = gen_lib.row_views(rows, yaw, model, device)
        crops = pano_lib.render_from_pano(torch.from_numpy(pano).to(cam.f.device), cam, grav,
                                          yaw_t)
        images[lanes] = crops.cpu().numpy()
    return images, [[math.degrees(r), math.degrees(p), math.degrees(v)] for r, p, v, _ in draws]


def gate_pano_requests(calib, calib_h, panos: list, device="cuda") -> Tuple[dict, dict]:
    """Requests g and h, served only by the whole-path gate, on pano_views of `panos`:
    g, 16 crops at 480x640, pinhole, with request a's options; h, 8 crops at 480x640
    through request e's lens (k1 DIVISION_K1), simple_divisional, served by calib_h
    (the heuristic init). Returns the requests and each one's (roll, pitch, vfov)."""
    images_g, truth_g = pano_views(panos, np.random.default_rng(GATE_VIEW_SEEDS["g"]), 16, 480,
                                   640, device=device)
    images_h, truth_h = pano_views(panos, np.random.default_rng(GATE_VIEW_SEEDS["h"]), 8, 480,
                                   640, k1=DIVISION_K1, device=device)
    return ({"g": (calib, images_g, {"batched": True}),
             "h": (calib_h, images_h, {"camera_model": "simple_divisional", "batched": True})},
            {"g": truth_g, "h": truth_h})


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
    nmf_ops.nmf.launches_by_dtype = dict.fromkeys(nmf_ops.nmf.launches_by_dtype, 0)


def serve(calib, name: str, *args, **kw):
    """One request as a path of its own: the launch counts are set to 0 just
    before it and read just after; it must have launched the NMF kernel and
    the LM kernel's instance for its camera model."""
    zero_counts()
    out = timed_request(calib, name, *args, **kw)
    model = kw.get("camera_model", "pinhole")
    dtype = str(calib.compute_dtype).removeprefix("torch.")
    counts = {"lm_system": lm_ops.lm_system.launches, "nmf": nmf_ops.nmf.launches,
              "nmf_by_dtype": dict(nmf_ops.nmf.launches_by_dtype),
              "lm_system_by_model": {k: n for k, n in lm_ops.lm_system.launches_by_model.items()
                                     if n}}
    log(f"request {name}: launches {json.dumps(counts)}")
    check(counts["nmf_by_dtype"][dtype] > 0 and counts["lm_system_by_model"].get(model, 0) > 0,
          f"request {name}: a kernel of its path was not launched ({dtype} NMF): {counts}")
    return out, counts


@contextlib.contextmanager
def plain_versions(lm: bool = True, nmf: bool = True):
    """Route the serving path through the plain PyTorch version of the chosen kernels."""
    lm_fn, nmf_fn = lm_solver.lm_system, hamburger.nmf_reconstruct
    exact_matmul()
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


def gate_serve(requests: dict, modes=("converged", "serving")) -> dict:
    """The GATE_REQUESTS among `requests` by the present routing, converged (early stop
    off) and serving (early stop on, as users run it): mode -> request -> output."""
    return {mode: {k: (cal if mode == "serving" else without_early_stop(cal)).calibrate(
        imgs, **kw) for k, (cal, imgs, kw) in requests.items() if k in GATE_REQUESTS}
        for mode in modes}


def nmf_control(x, bases, steps: int = 7, inv_t: float = 1.0, eps: float = 1e-6, *,
                chunks: int = 1, wide: bool = False, native: bool = False):
    """nmf_plain with one change to its arithmetic and none of the port's kernels: `wide`
    sums every product in float64; `chunks` sums the products over the tokens (coef^T x
    and coef^T coef) in that many chunks of tokens, each in float32, the partials added
    in float32 in order; `native` takes the products in x's dtype from cuBLAS, with its
    reduced-precision reduction off, so that every partial sum stays in float32.

    `native` changes the one thing the others cannot: with bf16 x, cuBLAS runs the
    products on the tensor cores, which multiply bf16 exactly and add the products
    into a float32 accumulator without IEEE round-to-nearest, as the NMF kernel's
    mma.sync m16n8k16 does. It shares that accumulation with the kernel, not the
    kernel's chunks of TOKENS_PER_CHUNK tokens. Measured on an H100
    (tools/gate_controls.py): on request a's first NMF (32 x 8320 tokens x 512), after
    one step, 2.18% of coef's bf16 values differ from the NMF summed in float64,
    against the kernel's 0.31% and float32 sums' 0.20%, so over 8320 tokens at once
    it is the broader there. Through the whole path it is of the other controls'
    size: per lane and angle a median 0.73 to 0.98 of the largest of the other seven
    in requests a, d and e; in request c, whose one lane the kernels move in roll 2.6
    times the other seven, it moves 2.9 times, and without it the kernels would fail
    that lane alone (0.0011 degrees against the 0.001 floor). Rounded to x's dtype
    where nmf_plain rounds."""
    acc = torch.float64 if wide else torch.float32
    if not native:
        return _nmf_sums(x, bases, steps, inv_t, eps, chunks, acc, acc)
    with seam(torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction", False):
        return _nmf_sums(x, bases, steps, inv_t, eps, chunks, acc, x.dtype)


def _nmf_sums(x, bases, steps: int, inv_t: float, eps: float, chunks: int, acc, prod):
    """nmf_control's arithmetic: sums in acc, products taken in prod."""
    dt = x.dtype

    def dot(a, b):
        return torch.matmul(a.to(prod), b.to(prod)).to(dt)

    def token_dot(a, b):  # a (B, R, N) @ b (B, N, K): a sum over the N tokens
        return sum(torch.matmul(pa.to(prod), pb.to(prod)) for pa, pb in
                   zip(a.tensor_split(chunks, -1), b.tensor_split(chunks, 1))).to(dt)

    bt = bases.transpose(1, 2).to(dt)
    norm = torch.sqrt(torch.sum(bt.to(acc) ** 2, dim=-1, keepdim=True))
    bt = bt / (norm.to(dt) + eps)
    coef = torch.softmax((inv_t * dot(x, bt.transpose(1, 2))).to(acc), dim=-1).to(dt)

    def update_coef(coef, bt):
        return coef * dot(x, bt.transpose(1, 2)) / (dot(coef, dot(bt, bt.transpose(1, 2))) + eps)

    for _ in range(steps):
        coef = update_coef(coef, bt)
        ct = coef.transpose(1, 2)
        bt = bt * token_dot(ct, x) / (dot(token_dot(ct, coef), bt) + eps)
    return update_coef(coef, bt), bt


def _lm_plain_in_order(order: str):
    """lm_system_plain over its pixels in another order (flipped, or rotated by half):
    the same terms, summed in another order."""
    move = {"reversed": lambda t: t.flip(-1),
            "rotated": lambda t: t.roll(t.shape[-1] // 2, -1)}[order]

    def system(obs, camera, gravity, h, w, cfg, *args, **kw):
        grid = pf.make_grid
        with seam(pf, "make_grid", lambda *a: tuple(move(t) for t in grid(*a))):
            return lm_ops.lm_system_plain({k: move(v) for k, v in obs.items()}, camera, gravity,
                                          h, w, cfg, *args, **kw)
    return system


@contextlib.contextmanager
def plain_lm_control(kind: str):
    """The solver's LM system replaced by its plain version with one change of the size
    of float32 rounding, and no kernel: G or H scaled by 1 + 2^-22, or its pixels summed
    in another order ("reversed", "rotated"). A control: what a correct kernel may
    change."""
    def scaled(*args, **kw):
        G, H, cost = lm_ops.lm_system_plain(*args, **kw)
        s = 1.0 + 2.0 ** -22
        return (G * s, H, cost) if kind == "G" else (G, H * s, cost)

    with seam(lm_solver, "lm_system", scaled if kind in ("G", "H") else _lm_plain_in_order(kind)):
        yield


# the LM controls of GATE_CONTROLS, by plain_lm_control's kind
LM_CONTROL_KINDS = {"plain LM, G x (1 + 2^-22)": "G", "plain LM, H x (1 + 2^-22)": "H",
                    "plain LM, pixels in reverse order": "reversed",
                    "plain LM, pixels rotated by half": "rotated"}


@contextlib.contextmanager
def gate_control(name: str):
    """The plain path with one of GATE_CONTROLS."""
    nmf_kw = {"plain NMF, sums in float64": {"wide": True},
              "plain NMF, token sums in 2 chunks": {"chunks": 2},
              "plain NMF, token sums in 4 chunks": {"chunks": 4},
              "plain NMF, products on cuBLAS": {"native": True}}
    if name in nmf_kw:
        swap = seam(hamburger, "nmf_reconstruct", lambda x, b, *a: torch.matmul(
            *nmf_control(x, b, *a, **nmf_kw[name])))
    else:
        swap = plain_lm_control(LM_CONTROL_KINDS[name])
    with plain_versions(), swap:
        yield


@contextlib.contextmanager
def shifted_lm(focal: bool = False):
    """A planted fault in the LM kernel: it returns G + H v. The solver stops where
    G + H v = 0, so its fixed point moves by about -v.

    By default v = GATE_LM_SHIFT_DEG (in radians) in both gravity coordinates and 0
    elsewhere: the gravity moves by about sqrt(2) GATE_LM_SHIFT_DEG degrees, roll and
    pitch by about that much or more. With `focal`, v is 0 but in the focal
    coordinate, where it is sized per lane so that the vFoV moves by about
    GATE_LM_SHIFT_DEG: vFoV = 2 atan(h / 2f) gives d vFoV / d log f = -sin(vFoV), so
    v = radians(GATE_LM_SHIFT_DEG) / sin(vFoV) in the log focal the loop solves in,
    and f times that in the linear focal of the final system."""
    fn = lm_solver.lm_system

    def faulty(obs, camera, gravity, h, w, cfg, spherical=None, log_focal=None, **kw):
        G, H, cost = fn(obs, camera, gravity, h, w, cfg, spherical, log_focal, **kw)
        v = torch.zeros_like(G)
        if focal:
            step = math.radians(GATE_LM_SHIFT_DEG) / torch.sin(camera.vfov.reshape(-1))
            log = cfg.use_log_focal if log_focal is None else log_focal
            v[:, 2] = step if log else step * camera.f[..., 1].reshape(-1)
        else:
            v[:, :2] = math.radians(GATE_LM_SHIFT_DEG)
        return G + (H @ v[..., None])[..., 0], H, cost

    with seam(lm_solver, "lm_system", faulty):
        yield


def angle_devs(out: dict, ref: dict) -> np.ndarray:
    """|roll|, |pitch|, |vFoV| of out against ref, degrees, (lanes, 3)."""
    dev = torch.stack([out["gravity"].roll - ref["gravity"].roll,
                       out["gravity"].pitch - ref["gravity"].pitch,
                       out["camera"].vfov - ref["camera"].vfov], -1)
    return torch.rad2deg(dev.abs()).reshape(-1, 3).cpu().numpy().astype(np.float64)


def stops(out: dict) -> np.ndarray:
    return out["stop_at"].reshape(-1).cpu().numpy().astype(int)


def gate_spread(requests: dict, refs: dict, controls=GATE_CONTROLS) -> dict:
    """The serving spread: the plain path served again (early stop on) under each of
    `controls` (names of GATE_CONTROLS). Per request: the spread (lanes, 3), the
    largest deviation of any control from the plain path in each lane and angle,
    counted only where the control stops at the plain path's iteration (a lane that
    stops apart shows the stop test's ulp, not the answer's), and each control's
    deviations and lanes apart."""
    by_control = {}
    for name in controls:
        with gate_control(name):
            by_control[name] = gate_serve(requests, ("serving",))["serving"]
    out = {}
    for k, ref in refs.items():
        devs, apart = {}, {}
        for name, outs in by_control.items():
            same = stops(outs[k]) == stops(ref)
            devs[name] = np.where(same[:, None], angle_devs(outs[k], ref), 0.0)
            apart[name] = np.flatnonzero(~same).tolist()
        spread = np.max(np.stack(list(devs.values())), 0)
        out[k] = {"spread": spread, "by_control": devs, "apart": apart}
        fmt = lambda a: np.array2string(a, precision=6, separator=",", max_line_width=10**4)
        log(f"gate spread, request {k}: per lane roll {fmt(spread[:, 0])} pitch "
            f"{fmt(spread[:, 1])} vfov {fmt(spread[:, 2])} deg; largest per control "
            + "; ".join(f"{n} {fmt(d.max(0))}" + (f" (lanes {apart[n]} stop apart)" if apart[n]
                                                  else "") for n, d in devs.items()))
    return out


def serving_rule(dev: np.ndarray, spread: np.ndarray, judged: np.ndarray) -> dict:
    """The serving comparison on one request, from the numbers alone: dev and spread
    (lanes, 3) in degrees (roll, pitch, vFoV), judged (lanes,) where stop_at agrees.

    The argument, made before any run judged with it. A correct kernel changes the
    path's arithmetic only in roundings and orders of summation, and so does each
    control: the NMF summed in float64, in chunks of tokens or on cuBLAS's tensor
    cores, the plain LM with G or H moved by one rounding or its pixels summed in
    another order. The bf16 network and the solver carry such changes to the answer
    through the same conditioning, so in a lane a kernel can move the answer about
    as far as a control does; it changes several such roundings at once, where a
    control changes one, hence a factor GATE_SPREAD_FACTOR over the largest
    control, s. Where s is below what the controls can resolve, GATE_FLOOR_DEG
    holds. So a judged lane is held, per angle, to min(ANGLE_TOL,
    max(GATE_SPREAD_FACTOR * s, GATE_FLOOR_DEG)): tighter than the flat ANGLE_TOL
    wherever that is below it. A lane whose max(...) exceeds ANGLE_TOL in some
    angle is ill-conditioned (its cost is flat there: rounding alone moves it that
    far), and it is named. Where at most one lane in GATE_ILL_PER_LANES of a
    request, rounded up, is so named, each is held to its max(...) in place of
    ANGLE_TOL, and must pass the converged comparison (ANGLE_TOL, checked in every
    lane). Where more are, the controls are too broad to be trusted there, and no
    lane of the request is held past ANGLE_TOL: `capped` says so, and `open`
    names the lanes that fail only where they would have been widened (a failure
    the rule cannot settle: the control set or the views are at fault, or the
    route).

    After the rule's first card run the cuBLAS control was added: the NMF
    kernel's tensor cores accumulate in float32 without IEEE rounding, which no
    float32 or float64 sum reproduces (nmf_control).

    A known fault of the rule: on an H100 an honest reordering, the NMF kernel at
    2048 tokens a chunk, moved request h's lane 4 (a panorama crop the rule calls
    well-conditioned) 0.003917 degrees in pitch against its 4 s of 0.003681. There
    the eight controls under-cover what a change in the order of the sums does, so
    the rule can fail a correct route (ROADMAP Queue 3 item 2).
    """
    raw = np.maximum(GATE_SPREAD_FACTOR * np.asarray(spread, np.float64), GATE_FLOOR_DEG)
    ill = (raw > ANGLE_TOL).any(-1)
    allowed = math.ceil(len(raw) / GATE_ILL_PER_LANES)
    capped = int(ill.sum()) > allowed
    tol = np.minimum(raw, ANGLE_TOL) if capped else raw
    dev = np.asarray(dev)
    fail = np.asarray(judged, bool) & (dev > tol).any(-1)
    open_ = fail & capped & (dev <= raw).all(-1)  # within the bound it was refused
    return {"tol": tol, "ill": ill, "fail": fail, "open": open_, "ill_allowed": allowed,
            "capped": capped, "ok": not fail.any()}


def gate_verdict(route: str, outs: dict, refs: dict, spread: dict) -> dict:
    """The whole-path gate: `route`'s outputs of gate_serve against the plain path's.

    Converged (the gate proper): roll, pitch and vFoV within ANGLE_TOL in every
    lane. Serving: each lane whose stop_at equals the plain path's by serving_rule,
    against the spread of gate_spread; a lane whose stop_at differs must differ by
    exactly one iteration, and such lanes are counted and named. Logs each lane;
    returns ok (both comparisons), ok per comparison, the failures as records
    (mode, request, lane, open: whether serving_rule leaves it open, and the text
    logged), the lanes that stop apart or are ill-conditioned, and the largest
    deviations per mode and request.
    """
    failures, apart, ill_lanes, worst = [], [], [], {}
    failed = dict.fromkeys(("converged", "serving"), False)

    def fail(mode, k, lane, text, open_=False):
        failures.append({"mode": mode, "request": k, "lane": int(lane), "open": bool(open_),
                         "text": f"{mode} {k}[{lane}]: {text}"})
        failed[mode] = True

    fmt = lambda a: np.array2string(np.asarray(a), precision=5, separator=",",
                                    max_line_width=10**4)
    for mode in failed:
        worst[mode] = {}
        for k, out in outs[mode].items():
            ref = refs[mode][k]
            dev = angle_devs(out, ref)
            sigma = torch.rad2deg(ref["vfov_uncertainty"]).reshape(-1).cpu().numpy()
            stop, stop_ref = stops(out), stops(ref)
            worst[mode][k] = dev.max(0).tolist()
            log(f"gate {mode}, {route} vs plain, request {k}: max roll/pitch/vfov "
                f"{fmt(dev.max(0))} deg; plain vfov sigma {fmt(sigma)} deg; stop_at "
                f"{stop.tolist()} against {stop_ref.tolist()}")
            if mode == "converged":
                for lane in np.nonzero((dev > ANGLE_TOL).any(-1))[0]:
                    fail(mode, k, lane, f"roll/pitch/vfov {dev[lane].round(5).tolist()} deg "
                                        f"against {ANGLE_TOL}")
                continue
            judged = stop == stop_ref
            rule = serving_rule(dev, spread[k]["spread"], judged)
            conv = angle_devs(outs["converged"][k], refs["converged"][k])
            for lane in range(len(dev)):
                if not judged[lane]:
                    verdict = "stops apart"
                    apart.append(f"{k}[{lane}] {stop[lane]}/{stop_ref[lane]}")
                    if abs(stop[lane] - stop_ref[lane]) != 1:
                        fail(mode, k, lane, f"stop_at {stop[lane]} against {stop_ref[lane]}, "
                                            f"more than one iteration apart")
                        verdict += ", more than one iteration: FAILS"
                else:
                    verdict = "judged" + (", ill-conditioned" if rule["ill"][lane] else "")
                    verdict += ": FAILS" if rule["fail"][lane] else ": passes"
                    if rule["fail"][lane]:
                        fail(mode, k, lane, f"roll/pitch/vfov {dev[lane].round(6).tolist()} "
                                            f"deg against {rule['tol'][lane].round(6).tolist()}",
                             rule["open"][lane])
                        if rule["open"][lane]:
                            verdict += " (open: within the spread's bound the cap refused)"
                if rule["ill"][lane]:
                    ill_lanes.append(f"{k}[{lane}]")
                    verdict += (f" (ill-conditioned; converged {fmt(conv[lane])} deg against "
                                f"{ANGLE_TOL})")
                log(f"gate serving, {route} vs plain, {k}[{lane}]: deviation roll/pitch/vfov "
                    f"{fmt(dev[lane])}, spread {fmt(spread[k]['spread'][lane])}, tolerance "
                    f"{fmt(rule['tol'][lane])} deg, stop_at {stop[lane]}/{stop_ref[lane]}: "
                    f"{verdict}")
            log(f"gate serving, {route} vs plain, request {k}: {int(rule['ill'].sum())} of "
                f"{len(dev)} lanes ill-conditioned (at most {rule['ill_allowed']} held past "
                f"{ANGLE_TOL} deg)" + (f": over that, so every lane held to {ANGLE_TOL} deg at "
                                       f"most" if rule["capped"] else ""))
    log(f"gate serving, {route}: {len(apart)} lanes stop apart from the plain path (one "
        f"iteration allowed){': ' + ', '.join(apart) if apart else ''}; ill-conditioned lanes: "
        f"{', '.join(ill_lanes) or 'none'}")
    for mode, bad in failed.items():
        log(f"gate {mode}, {route}: {'FAILED' if bad else 'passed'}")
    log(f"gate, {route}: " + ("passed" if not failures else "FAILED: " + "; ".join(
        f["text"] + (" (open)" if f["open"] else "") for f in failures)))
    return {"ok": not failures, "ok_converged": not failed["converged"],
            "ok_serving": not failed["serving"], "failures": failures,
            "stop_apart": apart, "ill_conditioned": ill_lanes, "max_dev_deg": worst}


def gate_known_routes(requests: dict, refs: dict, spread: dict) -> dict:
    """The serving rule on routes whose verdict is known: the kernels with the NMF at
    each of GATE_CHUNKS tokens a chunk (honest reorderings of its sums), then three
    planted faults whose serving comparison must fail in a lane it does not leave open:
    the NMF kernel one step short, and the LM kernel's fixed point moved by shifted_lm
    in gravity and, apart, in the focal alone (vFoV). A chunk route must pass the
    converged comparison and every serving lane but those serving_rule leaves open,
    which are reported (ROADMAP Queue 3 item 2). In GATE_PANO_REQUESTS its other
    failures are reported too, not judged: there the rule failed an honest reordering
    (on an H100 chunk 2048 moved h[4]'s pitch 1.06 times its bound, a lane the rule
    calls well-conditioned), a fault of the rule that serving_rule records; this
    exemption came after that run.

    The two LM faults must also fail outside open lanes in each of GATE_PANO_REQUESTS,
    the views whose vFoV the fields fix: a capped request (more ill-conditioned lanes
    than serving_rule allows) widens none, but still holds its other lanes to their
    spread's bound, so a 0.02 degree fault fails wherever a lane's bound is below
    that. The vFoV fault is what shows that vFoV is judged."""
    out = {}
    default = nmf_ops.TOKENS_PER_CHUNK
    try:
        for chunk in GATE_CHUNKS:
            nmf_ops.TOKENS_PER_CHUNK = chunk
            out[f"kernels, NMF chunk {chunk}"] = gate_verdict(
                f"kernels, NMF chunk {chunk}", gate_serve(requests), refs, spread)
    finally:
        nmf_ops.TOKENS_PER_CHUNK = default
    faults = {"planted: NMF kernel one step short": patched_nmf(wrong=True),
              f"planted: LM kernel fixed point moved {GATE_LM_SHIFT_DEG} deg": shifted_lm(),
              f"planted: LM kernel fixed point moved {GATE_LM_SHIFT_DEG} deg in vFoV":
                  shifted_lm(focal=True)}
    for route, fault in faults.items():
        with fault:
            out[route] = gate_verdict(route, gate_serve(requests), refs, spread)
    texts = lambda fs: [f["text"] for f in fs] or "none"  # noqa: E731
    for route, v in out.items():
        want = not route.startswith("planted")
        closed = [f for f in v["failures"] if not f["open"]]
        v["fails_in"] = sorted({f["request"] for f in closed if f["mode"] == "serving"})
        v["reported"] = [f for f in closed if want and f["request"] in GATE_PANO_REQUESTS]
        held = [f for f in closed if f not in v["reported"]]
        log(f"gate rule, {route}: converged {'passed' if v['ok_converged'] else 'FAILED'}, "
            f"serving {'passed' if v['ok_serving'] else 'FAILED'} (must "
            f"{'pass' if want else 'fail'}), outside open lanes in requests "
            f"{v['fails_in'] or 'none'}; ill-conditioned lanes {v['ill_conditioned']}; "
            f"open: {texts(f for f in v['failures'] if f['open'])}"
            + (f"; in {list(GATE_PANO_REQUESTS)} outside open lanes (reported, not judged): "
               f"{texts(v['reported'])}" if want else ""))
        check(not held if want else bool(v["fails_in"]),
              f"gate rule: {route} {'failed' if want else 'passed'} the serving comparison: "
              f"{texts(held if want else v['failures'])}")
        if route.startswith("planted: LM"):
            for k in (k for k in GATE_PANO_REQUESTS if k in refs["serving"]):
                log(f"gate rule, {route}, request {k}: must fail outside open lanes: "
                    f"{'fails' if k in v['fails_in'] else 'PASSES'}")
                check(k in v["fails_in"],
                      f"gate rule: {route} passed the serving comparison of request {k}")
    return {k: {f: v[f] for f in ("ok", "ok_converged", "ok_serving", "failures",
                                  "ill_conditioned", "max_dev_deg", "fails_in", "reported")}
            for k, v in out.items()}


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


def lm_cost_phase(obs, camera, gravity, h: int, w: int) -> dict:
    """The LM kernel's cost-only instance (with_system=False) at request a's planes, each
    camera model with LM_TIMING_K's distortion. Its path run: the count set to 0, one
    lm_system(..., with_system=False) call per model, the count read (one launch each).
    Then each model's cost against the full instance's (bit for bit: the same sums in the
    same order) and the plain version's (LM_TOL), and its time against its bound."""
    B, N = obs["up_x"].shape
    cams = {m: Camera(camera.size, camera.f, camera.c,
                      torch.tensor(LM_TIMING_K[m], device=camera.f.device).expand(B, 2), m)
            for m in lm_ops.MODEL_IDS}
    cfgs = {m: LMConfig(camera_model=m) for m in lm_ops.MODEL_IDS}
    lm_ops.lm_system.cost_launches = 0
    outs = {m: lm_ops.lm_system(obs, cams[m], gravity, h, w, cfgs[m], with_system=False)
            for m in lm_ops.MODEL_IDS}
    torch.cuda.synchronize()
    launches = lm_ops.lm_system.cost_launches
    check(launches == len(lm_ops.MODEL_IDS),
          f"cost-only LM: {launches} launches for {len(lm_ops.MODEL_IDS)} calls")
    per_model, max_abs = {}, 0.0
    for m, (G, H, cost) in outs.items():
        full = lm_ops.lm_system(obs, cams[m], gravity, h, w, cfgs[m])[2]
        plain = lm_ops.lm_system_plain(obs, cams[m], gravity, h, w, cfgs[m], with_system=False)
        torch.cuda.synchronize()
        bitwise = torch.equal(cost, full)
        dev = rel_dev(cost, plain[2])
        max_abs = max(max_abs, float((cost - plain[2]).abs().max()))
        check(bitwise, f"cost-only LM {m}: the cost differs from the full instance's: "
                       f"{(cost - full).abs().max().item():.3e}")
        check(dev <= LM_TOL, f"cost-only LM {m}: cost deviates from plain by {dev:.3e} > {LM_TOL}")
        check(not G.any() and not H.any(), f"cost-only LM {m}: G or H is not zero")
        cam, grav = cams[m].data.contiguous(), gravity.vec3d.contiguous()
        ms = cuda_ms(lambda: lm_ops.launch_cost(obs, cam, grav, m, w, cfgs[m]))
        plain_ms = cuda_ms(lambda: lm_ops.lm_system_plain(obs, cams[m], gravity, h, w, cfgs[m],
                                                          with_system=False))
        nbytes = sum(t.numel() * t.element_size() for t in obs.values()) + (
            cam.numel() + grav.numel() + B) * 4
        flops = LM_COST_FLOPS_PER_PIXEL[m] * B * N
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        per_model[m] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                        "cost_equals_full_instance": bitwise, "rel_dev_plain": dev}
        log(f"lm kernel, cost only, {m} B={B} N={N}: cost bitwise equal to the full instance's "
            f"{bitwise}, relative deviation from plain {dev:.3e}; {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, {nbytes / 1e6:.1f} MB -> {t_bytes:.4f} ms, {flops / 1e9:.3f} "
            f"GFLOP -> {t_ops:.4f} ms")
    return {"launches": launches, "max_abs_err": max_abs, **{k: per_model["pinhole"][k] for k in
            ("ms", "plain_ms", "bound_ms", "bound_by")}, "library_ms": None,
            "per_model": per_model}


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
    cost_only = lm_cost_phase(obs, camera, gravity, h, w)
    return {"max_abs_err": max_abs, **per_model["pinhole"], "library_ms": None,
            "per_model": per_model, **config, "launch_latency_ms": latency,
            "cost_only": cost_only}


def nmf_cost(x: torch.Tensor, bases: torch.Tensor, steps: int) -> Tuple[int, int]:
    """(bytes, floating-point operations) of one NMF of x (B, N, D) with R bases: x,
    the bases, coef and bt each moved once, and the products of the updates."""
    B, N, D = x.shape
    R = bases.shape[2]
    macs = ((steps + 2) * N * D * R + steps * N * R * D + (steps + 1) * N * R * R
            + steps * N * R * R + (steps + 1) * R * R * D + steps * R * R * D)
    return x.element_size() * B * (N * D + D * R + N * R + R * D), 2 * B * macs


def nmf_bound(x: torch.Tensor, bases: torch.Tensor, steps: int) -> dict:
    """The least time of one NMF on the card: the larger of its bytes over the memory
    rate and its operations over the peak of the units that can compute them at its
    accuracy: bf16 tensor cores for bf16; for float32, three TF32 products a product
    (the split that keeps float32 accuracy), with the float32 FMA bound beside it."""
    nbytes, flops = nmf_cost(x, bases, steps)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / BF16_FLOPS if x.dtype == torch.bfloat16 else 3 * flops / TF32_FLOPS) * 1e3
    out = {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else
           "operations", "bytes": nbytes, "flops": flops}
    if x.dtype == torch.float32:
        out["fma_bound_ms"] = max(t_bytes, flops / F32_FLOPS * 1e3)
    return out


def exact_matmul() -> None:
    """cuBLAS's float32 products in full float32 (no TF32), for nmf_plain as a reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matmul must not run in TF32 where nmf_plain is the reference")


def nmf_phase(calib, images: np.ndarray) -> dict:
    """The NMF kernel's bf16 instance against nmf_plain on the stacked head tokens of
    these views (request a's, or an eval batch's)."""
    exact_matmul()
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
    bound = nmf_bound(tokens, bases, steps)
    log(f"nmf kernel B={B} N={N} D={D} R={R}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"{bound['bytes'] / 1e6:.1f} MB, {bound['flops'] / 1e9:.1f} GFLOP: bound "
        f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"], "library_ms": None,
            "tensor_cores": "mma.sync", "tokens_per_chunk": nmf_ops.TOKENS_PER_CHUNK}


def nmf_f32_phase(calib_f, images: np.ndarray, card: str) -> dict:
    """The NMF kernel's float32 instance (TF32 tensor cores, three products a product)
    on request f's stacked head tokens (the float32 network on request a's views):
    against nmf_plain in full float32 within NMF_F32_TOL beside a control of one step
    fewer, which must exceed it; against nmf_plain with cuBLAS in TF32 (one product),
    which must deviate more; two launches bit for bit; timed beside its bounds."""
    exact_matmul()
    crop = calib_f.preprocessor(torch.from_numpy(images).to(calib_f.device))["image"]
    with torch.inference_mode():
        x, bases = calib_f.net.front(crop.to(calib_f.compute_dtype))[3:]
    check(x.dtype == torch.float32, f"request f's tokens are {x.dtype}")
    steps = hamburger.NMF_EVAL_STEPS
    out = nmf_check("nmf phase, request f's tokens", x, bases, steps)
    check(out["ok"], f"the float32 NMF at request f's tokens {out}")
    try:  # a control: the plain version with its products in one TF32 pass
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32_ref = torch.matmul(*nmf_ops.nmf_plain(x, bases, steps)).float()
    finally:
        exact_matmul()
    ref = torch.matmul(*nmf_ops.nmf_plain(x, bases, steps)).float()
    out["tf32_control_rel"] = float(torch.linalg.norm((tf32_ref - ref).flatten())
                                    / torch.linalg.norm(ref.flatten()))
    log(f"nmf kernel, float32 instance: {out['rel']:.3e} from nmf_plain in float32, against "
        f"{out['tf32_control_rel']:.3e} for nmf_plain with cuBLAS in TF32 (control)")
    check(out["rel"] < out["tf32_control_rel"],
          "the float32 NMF is no closer to float32 than one TF32 product")
    first, second = nmf_ops.nmf(x, bases, steps), nmf_ops.nmf(x, bases, steps)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"nmf kernel, float32 instance, two launches: coef and bt bitwise equal: {same}")
    check(same, "the float32 NMF is not deterministic")
    out |= nmf_f32_times(x, bases, steps, "request f's shape", card)
    return out


def nmf_f32_times(x: torch.Tensor, bases: torch.Tensor, steps: int, label: str, card: str,
                  *args) -> dict:
    """The float32 instance's time and nmf_plain's (full float32) beside both bounds."""
    exact_matmul()
    ms = cuda_ms(lambda: nmf_ops.nmf(x, bases, steps, *args), reps=3, per_graph=2)
    plain_ms = cuda_ms(lambda: nmf_ops.nmf_plain(x, bases, steps, *args), reps=3, per_graph=2)
    bound = nmf_bound(x, bases, steps)
    log(f"nmf kernel, float32 instance at {label} {tuple(x.shape)} R={bases.shape[2]}: "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms; bound {bound['bound_ms']:.4f} ms "
        f"({bound['bound_by']}; {bound['bytes'] / 1e6:.1f} MB, 3 x {bound['flops'] / 1e9:.1f} "
        f"GFLOP at {TF32_FLOPS / 1e12:.0f} TFLOP/s TF32), float32 FMA bound "
        f"{bound['fma_bound_ms']:.4f} ms; card {card}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            **{k: bound[k] for k in ("bound_ms", "bound_by", "fma_bound_ms")}}


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
    """The NMF kernel's stage kernels, bf16 then float32, tensor-core stages first."""
    return ptxas_entries({"coef (init), tensor cores": "nmf_coef_tc_kernelILb1E",
                          "coef (update), tensor cores": "nmf_coef_tc_kernelILb0E",
                          "stats, tensor cores": "nmf_stats_tc_kernel",
                          "gram, tensor cores": "nmf_gram_tc_kernel",
                          "norm": "nmf_norm_kernelI13__nv_bfloat16E",
                          "bases": "nmf_bases_kernelI13__nv_bfloat16E",
                          "float32 coef (init), TF32 x3": "nmf_coef_tf32_kernelILb1E",
                          "float32 coef (update), TF32 x3": "nmf_coef_tf32_kernelILb0E",
                          "float32 stats, TF32 x3": "nmf_stats_tf32_kernel",
                          "float32 gram, TF32 x3": "nmf_gram_tf32_kernel",
                          "float32 norm": "nmf_norm_kernelIfE",
                          "float32 bases": "nmf_bases_kernelIfE"})


def spills(report: str) -> bool:
    """Whether a kernel's ptxas lines report stack or spill bytes other than 0."""
    return any(int(n) for n in re.findall(r"(\d+) bytes (?:stack frame|spill stores|spill loads)",
                                          report))


def smoke_requests(calib, calib_h, calib_f=None) -> Tuple[dict, dict]:
    """Requests a to f, name -> (calibrator, image(s), calibrate options), and the
    rendered views' (roll, pitch, vfov) in degrees of a, d and e. ``calib_h``
    serves e and must use the heuristic init; ``calib_f`` (a float32 GeoCalib) serves
    f, request a's views through the float32 network, and f is left out without it."""
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
    if calib_f is not None:
        requests["f"] = (calib_f, images, {"batched": True})
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
              "worst_leaf_l2": float(torch.linalg.norm(rgrads[worst].double())),
              "worst_leaf_dev_l2": float(torch.linalg.norm((grads[worst] - rgrads[worst]).double())),
              "leaves_over_tol": sum(v > TRAIN_LEAF_TOL for v in leaves.values())}
    result["ok"] = (result["loss_rel"] <= TRAIN_LOSS_TOL and result["norm_rel"] <= TRAIN_NORM_TOL
                    and result["leaf_rel"] <= TRAIN_LEAF_TOL)
    log(f"train gradients, {label}: loss terms {result['loss_rel']:.3e} (bound {TRAIN_LOSS_TOL}), "
        f"global norm {result['norm_rel']:.3e} ({TRAIN_NORM_TOL}), worst leaf "
        f"{result['leaf_rel']:.3e} ({TRAIN_LEAF_TOL}) in {worst}, {result['leaves_over_tol']} of "
        f"{len(leaves)} leaves over: {'within' if result['ok'] else 'over'} the float32 bounds")
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


def compare_routes(cfg, weights: dict, batch: dict) -> dict:
    """One step's gradients by the kernels against the plain versions, same state and key,
    after two plain runs are checked to give the same bits. A float32 network is judged
    by grad_compare's bounds, and in unroll mode a broken VJP must fail them; a bf16 one
    is reported beside a no-kernel control, the plain LM with G x (1 + 2^-22).

    Why bf16 is not judged. With a bf16 network both routes run the same forward and
    backward bits, except where the LM's float32 answer carries another rounding into
    them: the fixed point the IFT backward starts from, and in unroll mode each
    system's VJP input too. The backward rounds to bf16 at every layer, so a change at
    the float32 ulp flips a bf16 rounding with a chance of about its relative size
    over 2^-8, each flip moving a leaf by a bf16 ulp of its terms (a leaf whose true
    gradient is near 0, a conv bias in front of a BatchNorm, by its own size). A leaf's
    deviation so counts rare, discrete events: where a route draws a flip that no
    control drew, the leaf moves by a whole bf16 ulp of a term against the controls'
    nothing, however correct the route. A per-leaf rule of 4 times the largest of four
    no-kernel controls (G or H x (1 + 2^-22), the plain LM's pixels reversed or rotated)
    put 2 of 747 IFT leaves over on an H100, one at 256 (2^8, one flip) times its bound,
    while each control moved the near-zero leaves by 0.95 to 1.05 of their size: such
    a rule judges the draw of flips, not the kernel, and more controls would only make
    the miss rarer. The float32 comparison, where the backward carries a rounding as a
    rounding, is the whole check.
    """
    label = f"{cfg.compute_dtype} network, {cfg.lm_grad_mode}"
    net, state = train_lib.create_train_state(cfg, weights, device="cuda")
    run = lambda: train_lib.compute_grads(net, cfg, state, batch, (0, 5))
    with plain_versions(lm=True, nmf=False):
        ref, ref2 = run(), run()
    same = torch.equal(ref[0], ref2[0]) and all(torch.equal(ref[1][k], ref2[1][k]) for k in ref[1])
    log(f"train gradients, {label}: two plain runs bitwise equal: {same}")
    check(same, f"{label}: two plain runs differ, so the comparison would not measure the kernel")
    del ref2
    if cfg.compute_dtype == "float32":
        out = {"kernels": grad_compare(f"{label}, kernels vs plain", run(), ref)}
        check(out["kernels"]["ok"], f"train gradients, {label}: kernels vs plain {out['kernels']}")
        with broken_vjp():
            out["broken_vjp"] = grad_compare(f"{label}, broken VJP (confidence planes 0) vs plain",
                                             run(), ref)
        if cfg.lm_grad_mode == "unroll":
            check(not out["broken_vjp"]["ok"], "the broken VJP passed the gradient comparison")
    else:
        out = {"kernels": grad_compare(f"{label}, kernels vs plain (reported)", run(), ref)}
        with plain_versions(lm=True, nmf=False), plain_lm_control("G"):
            out["control"] = grad_compare(f"{label}, control (plain LM, G x (1 + 2^-22)) vs "
                                          f"plain (reported)", run(), ref)
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
    # steps above reported beside a no-kernel control, because the bf16 backward turns
    # any change of a rounding into flips of bf16 roundings (compare_routes)
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    compare = {}
    for dtype in ("float32", "bfloat16"):
        for mode in ("ift", "unroll"):
            c = replace_cfg(cfg, drop_path_rate=0.0, compute_dtype=dtype, lm_grad_mode=mode)
            compare[f"{dtype} {mode}"] = compare_routes(c, weights, batch)
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


def validation_compare(label: str, got: dict, ref: dict, loss_tol: float) -> dict:
    """Validation scalars against another run's: recalls within LOOP_RECALL_TOL, angle
    metrics within LOOP_ANGLE_TOL degrees, loss terms within loss_tol relative; each
    key's deviation, bound and verdict, the largest of each kind logged."""
    dev = {}
    for k, v in ref.items():
        d = abs(got[k] - v)
        bound, kind = ((LOOP_RECALL_TOL, "abs") if "recall" in k else
                       (LOOP_ANGLE_TOL, "abs deg") if k.startswith("metric/") else
                       (loss_tol, "rel"))
        d = d / max(abs(v), 1e-12) if kind == "rel" else d
        dev[k] = {"dev": d, "bound": bound, "kind": kind, "ok": d <= bound}
    worst = {kind: max((x for x in dev.items() if x[1]["kind"] == kind), key=lambda x: x[1]["dev"])
             for kind in ("abs", "abs deg", "rel")}
    for kind, (k, x) in worst.items():
        log(f"{label}: largest {kind} deviation {x['dev']:.3e} in {k} (bound {x['bound']})")
    return dev


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
    dev = validation_compare("loop validation, kernels vs plain", kern, plain, LOOP_LOSS_TOL)
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


# ---------------------------------------------------------------- generate phase

def render_check(task: dict, pano_name: str, pano: np.ndarray, rows: list,
                 crops: torch.Tensor, crops_cpu: torch.Tensor) -> dict:
    """The card's render against the CPU's, in its two parts: where each crop pixel
    samples the panorama (the card's coordinates against the CPU's, on the sphere,
    pano.sample_distance), and the sampling (the card's crops against the CPU's sampler
    at the card's coordinates). The crops' value difference is reported."""
    _, yaw = gen_lib.sample_rows(pano_name, task)
    size, model = pano.shape[:2], task["camera_model"]
    card = pano_lib.pano_coordinates(size, *gen_lib.row_views(rows, yaw, model, "cuda"))
    card = tuple(t.cpu() for t in card)
    host = pano_lib.pano_coordinates(size, *gen_lib.row_views(rows, yaw, model, "cpu"))
    sampled = pano_lib._bilinear_sample(torch.from_numpy(pano), *card).reshape(crops.shape)
    diff = (crops.cpu() - crops_cpu).abs()
    return {"coord_px": float(pano_lib.sample_distance(card, host, size).max()),
            "sampler": float((crops.cpu() - sampled).abs().max()),
            "value_max": float(diff.max()),
            "value_share_over": float((diff.amax(-1) > RENDER_VALUE_REPORT).float().mean())}


def generate_phase(calib, card: str) -> dict:
    """Dataset generation through the port's own per-pano functions (data/generate.py):
    each GENERATE_SETS configuration's panoramas synthesised on the host (timed), their
    rows sampled and crops rendered on the card (CUDA events) and on the CPU; the card's
    crops against the CPU's, rows equal. Then the 320x320 crops calibrated on the r05
    weights (batch 16, each set's camera model) as a path of its own, against the rows'
    truth; median roll and pitch errors within GENERATE_ANGLE_TOL."""
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    out, crops_by_set = {}, {}
    for name, (n_panos, model, seed, overrides) in GENERATE_SETS.items():
        conf = gen_lib.dataset_conf(**overrides)
        synth_s, render_ms, cpu_s, devs, rows_all, crops_all = [], [], [], [], [], []
        for src in gen_lib.pano_sources(None, n_panos, seed):
            task = {"pano": src, "split": "train", "conf": conf, "camera_model": model,
                    "seed": seed}
            t0 = time.perf_counter()
            pano_name, pano = gen_lib.load_pano(task)
            synth_s.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            rows, crops = gen_lib.render_pano(task, pano_name, pano, "cuda")
            end.record()
            torch.cuda.synchronize()
            render_ms.append(start.elapsed_time(end))
            t0 = time.perf_counter()
            rows_cpu, crops_cpu = gen_lib.render_pano(task, pano_name, pano, "cpu")
            cpu_s.append(time.perf_counter() - t0)
            check(rows == rows_cpu, f"generate {name}: the card path's rows differ from the CPU's")
            check(crops.shape == (conf["crops_per_pano"], conf["height"], conf["width"], 3)
                  and crops.device.type == "cuda" and bool(torch.isfinite(crops).all()),
                  f"generate {name}: crops {tuple(crops.shape)} on {crops.device}")
            devs.append(render_check(task, pano_name, pano, rows, crops, crops_cpu))
            rows_all += rows
            crops_all.append(crops)
        worst = {k: max(d[k] for d in devs) for k in devs[0]}
        log(f"generate {name} ({n_panos} panos {conf['pano_height']}x{conf['pano_width']}, "
            f"{conf['crops_per_pano']} crops of {conf['height']}x{conf['width']}, {model}, seed "
            f"{seed}): host synthesis {[round(x, 3) for x in synth_s]} s a pano; card render "
            f"{[round(x, 3) for x in render_ms]} ms a pano (CUDA events, the pano's upload "
            f"included); CPU render {[round(x, 3) for x in cpu_s]} s; card against CPU: sample "
            f"coordinates {worst['coord_px']:.3e} pano px apart on the sphere (bound "
            f"{RENDER_COORD_TOL}), sampler {worst['sampler']:.3e} (bound {RENDER_SAMPLER_TOL}); "
            f"crops' values at most {worst['value_max']:.3e} apart, {worst['value_share_over']:.2e} "
            f"of a pano's pixels over {RENDER_VALUE_REPORT} (reported)")
        check(worst["coord_px"] <= RENDER_COORD_TOL,
              f"generate {name}: the card samples {worst['coord_px']:.3e} px from the CPU")
        check(worst["sampler"] <= RENDER_SAMPLER_TOL,
              f"generate {name}: the card's sampler deviates by {worst['sampler']:.3e}")
        share = sum(render_ms) / 1e3 / (sum(render_ms) / 1e3 + sum(synth_s))
        out[name] = {"synth_s": synth_s, "render_ms": render_ms, "cpu_render_s": cpu_s,
                     **worst, "render_share": share}
        crops_by_set[name] = (model, rows_all, torch.cat(crops_all))

    # the 320x320 sets calibrated on the card, as a path of its own
    zero_counts()
    errors = {}
    t0 = time.perf_counter()
    for name, (model, rows, crops) in crops_by_set.items():
        if crops.shape[1:3] != (GENERATE_CALIB_SIZE, GENERATE_CALIB_SIZE):
            continue
        preds = []
        for i in range(0, len(rows), GENERATE_CALIB_BATCH):
            res = calib.calibrate(crops[i:i + GENERATE_CALIB_BATCH].cpu().numpy(), batched=True,
                                  camera_model=model)
            preds.append(torch.stack([res["gravity"].roll, res["gravity"].pitch,
                                      res["camera"].vfov], -1).cpu().double().numpy())
        pred = np.degrees(np.concatenate(preds))
        truth = np.array([[r["roll"], r["pitch"], r["vfov"]] for r in rows], np.float64)
        wrap = lambda d: np.abs((d + 180.0) % 360.0 - 180.0)
        errors[name] = np.stack([wrap(pred[:, 0] - np.degrees(read_roll(truth[:, 0], truth[:, 1]))),
                                 np.abs(pred[:, 1] - np.degrees(truth[:, 1])),
                                 np.abs(pred[:, 2] - np.degrees(truth[:, 2]))], -1)
        log(f"generate {name}: {len(rows)} crops calibrated ({model}, batch "
            f"{GENERATE_CALIB_BATCH}): median roll/pitch/vfov error "
            f"{np.round(np.median(errors[name], 0), 4).tolist()} deg, max "
            f"{np.round(errors[name].max(0), 3).tolist()}")
    calib_s = time.perf_counter() - t0
    counts = {"lm_system": lm_ops.lm_system.launches, "nmf": nmf_ops.nmf.launches,
              "lm_by_model": {k: n for k, n in lm_ops.lm_system.launches_by_model.items() if n}}
    all_err = np.concatenate(list(errors.values()))
    median = np.median(all_err, 0)
    n_batches = sum(-(-len(crops_by_set[k][1]) // GENERATE_CALIB_BATCH) for k in errors)
    log(f"generate: {len(all_err)} crops calibrated in {calib_s:.2f} s, launches "
        f"{json.dumps(counts)}; median roll/pitch/vfov error {np.round(median, 4).tolist()} deg "
        f"(gate: roll and pitch within {GENERATE_ANGLE_TOL})")
    check(counts["nmf"] == n_batches and counts["lm_system"] == 31 * n_batches,
          f"generate: each calibrate batch must launch the NMF once and the LM 31 times: {counts}")
    check(len(all_err) == GENERATE_CALIB_CROPS, f"generate: {len(all_err)} crops calibrated")
    check(median[0] <= GENERATE_ANGLE_TOL and median[1] <= GENERATE_ANGLE_TOL,
          f"generate: median roll/pitch error {median[:2].tolist()} deg > {GENERATE_ANGLE_TOL}")
    pool = generate_entry(crops_by_set["openpano_radial_v2"][1])
    log(f"generate card: {card}")
    return {"sets": out, "pool": pool, "median_error_deg": median.tolist(),
            "median_error_deg_by_set": {k: np.median(v, 0).tolist() for k, v in errors.items()},
            "calibrate_s": calib_s, "launches": counts,
            "crops": {k: v[2] for k, v in crops_by_set.items()}}


def generate_entry(radial_rows: list) -> dict:
    """generate_dataset, the user's entry point, on the card with a pool of synthesis
    workers (GENERATE_POOL_PANOS panoramas at openpano_radial_v2's configuration), the
    JPEG writer replaced at the write_crops seam by an in-memory store (the card has no
    PIL). Checks: every row's crop was rendered on the card and is finite, and the
    train CSV's first panoramas' rows equal, as text, the rows of the per-pano run."""
    written = {}

    def store(rows, crops, img_dir):
        check(crops.device.type == "cuda", f"generate_dataset rendered on {crops.device}")
        written.update({r["fname"]: c for r, c in zip(rows, crops)})

    out_dir = ROOT / ".smoke" / f"generate_{os.getpid()}"
    shutil.rmtree(out_dir, ignore_errors=True)
    saved = gen_lib.write_crops
    gen_lib.write_crops = store
    try:
        t0 = time.perf_counter()
        gen_lib.generate_dataset(str(out_dir), n_panos=GENERATE_POOL_PANOS,
                                 camera_model="simple_radial", seed=2,
                                 workers=GENERATE_POOL_WORKERS, height=320, width=320,
                                 pano_height=640, pano_width=1280)
        seconds = time.perf_counter() - t0
    finally:
        gen_lib.write_crops = saved
    csv_rows = {}
    for split in ("train", "val", "test"):
        with open(out_dir / f"{split}.csv", newline="") as fh:
            csv_rows[split] = list(csv.DictReader(fh))
    names = [r["fname"] for rows in csv_rows.values() for r in rows]
    check(sorted(names) == sorted(written) and len(names) == 16 * GENERATE_POOL_PANOS,
          f"generate_dataset: {len(names)} rows, {len(written)} crops")
    check(all(bool(torch.isfinite(c).all()) for c in written.values()),
          "generate_dataset: a crop is not finite")
    same = [{k: str(v) for k, v in r.items()} for r in radial_rows]
    check(csv_rows["train"][:len(same)] == same,
          "generate_dataset: the train CSV differs from the per-pano run's rows")
    log(f"generate_dataset on the card, {GENERATE_POOL_PANOS} panoramas at openpano_radial_v2's "
        f"configuration, {GENERATE_POOL_WORKERS} synthesis workers: {seconds:.2f} s, "
        f"{len(names)} rows in {[len(v) for v in csv_rows.values()]} (train, val, test); the "
        f"train CSV's first {len(same)} rows equal the per-pano run's as text")
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"seconds": seconds, "rows": len(names)}


# ---------------------------------------------------------------- demo phase

def demo_phase(calib, crops: torch.Tensor, card: str) -> dict:
    """InteractiveDemo.process_frame on DEMO_FRAMES generated crops for each of
    DEMO_MODELS with every overlay on, as a path of its own (counts set to 0 around
    it): frames finite and of the crop's shape; the card's undistort_image and overlays
    against the same camera and gravity moved to the CPU (RENDER_TOL in value; at most
    DEMO_PIXEL_SHARE of a frame's pixels over it); milliseconds per frame."""
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    frames = crops[:DEMO_FRAMES].cpu().numpy()
    demo = demo_lib.InteractiveDemo(calib)
    demo.toggles = dict.fromkeys(demo.toggles, True)
    for model in DEMO_MODELS:  # warm each model's shapes outside the counted run
        demo.camera_model = model
        demo.process_frame(frames[0])
    zero_counts()
    outs, frame_ms = {}, {}
    for model in DEMO_MODELS:
        demo.camera_model = model
        for i, frame in enumerate(frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[model, i] = demo.process_frame(frame)
            frame_ms[model, i] = (time.perf_counter() - t0) * 1e3
    counts = {"lm_system": lm_ops.lm_system.launches, "nmf": nmf_ops.nmf.launches,
              "lm_by_model": {k: n for k, n in lm_ops.lm_system.launches_by_model.items() if n}}
    n_frames = len(outs)
    check(counts["nmf"] == n_frames and counts["lm_by_model"] == {
        m: 31 * len(frames) for m in DEMO_MODELS},
        f"demo: each frame must launch the NMF once and its model's LM 31 times: {counts}")

    undistort_dev, pixel_share, overlay_ms = 0.0, 0.0, []
    for (model, i), (out, result) in outs.items():
        check(out.shape == frames[i].shape and bool(np.isfinite(out).all()),
              f"demo {model}: frame {out.shape} not finite or of the wrong shape")
        check(result["camera"].f.device.type == "cuda", "demo: the result is not on the card")
        cpu = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in result.items()
               if k not in ("camera", "gravity")}
        cam, grav = result["camera"], result["gravity"]
        cpu["camera"] = Camera(*(t.cpu() for t in (cam.size, cam.f, cam.c, cam.k)), cam.model)
        cpu["gravity"] = Gravity(grav.vec3d.cpu())
        t0 = time.perf_counter()
        card_frame = overlays_lib.render_overlays(frames[i], result, demo.toggles)
        overlay_ms.append((time.perf_counter() - t0) * 1e3)
        ref = overlays_lib.render_overlays(frames[i], cpu, demo.toggles)
        pixel_share = max(pixel_share, float((np.abs(card_frame - ref) > RENDER_TOL).any(-1).mean()))
        img = torch.from_numpy(frames[i])[None]
        und = cam[None].undistort_image(img.to(cam.f.device)).cpu()
        undistort_dev = max(undistort_dev, float((und - cpu["camera"][None].undistort_image(img)
                                                  ).abs().max()))
    log(f"demo: {n_frames} frames ({len(frames)} crops x {DEMO_MODELS}), every overlay on; "
        f"launches {json.dumps(counts)}; card against CPU: undistort_image {undistort_dev:.3e} "
        f"(bound {RENDER_TOL}), overlay frames at most {pixel_share:.5f} of pixels over "
        f"{RENDER_TOL} (bound {DEMO_PIXEL_SHARE}); ms a frame (calibrate and overlays) "
        f"{json.dumps({m: [round(frame_ms[m, i], 2) for i in range(len(frames))] for m in DEMO_MODELS})}"
        f", overlays alone median {np.median(overlay_ms):.2f} ms; card {card}")
    check(undistort_dev <= RENDER_TOL, f"demo: undistort_image deviates by {undistort_dev:.3e}")
    check(pixel_share <= DEMO_PIXEL_SHARE, f"demo: {pixel_share:.5f} of an overlay frame differs")
    return {"launches": counts, "frame_ms": {m: [frame_ms[m, i] for i in range(len(frames))]
                                             for m in DEMO_MODELS},
            "overlay_ms_median": float(np.median(overlay_ms)), "undistort_dev": undistort_dev,
            "overlay_pixel_share": pixel_share}


# ---------------------------------------------------------------- baselines phase

def cpu_copy(data: dict) -> dict:
    return {k: v.detach().cpu() for k, v in data.items()}


def ulp_spread(data_cpu: dict, xs: torch.Tensor, ys: torch.Tensor, rpf: torch.Tensor
               ) -> torch.Tensor:
    """The largest change in the CPU's hypotheses when every field value moves by one
    float32 ulp in a random direction, over RANSAC_SPREAD_DRAWS draws: each minimal
    sample's float32 conditioning."""
    spread = torch.zeros_like(rpf)
    for seed in range(RANSAC_SPREAD_DRAWS):
        gen = torch.Generator().manual_seed(100 + seed)
        moved = {k: torch.nextafter(v, torch.where(torch.rand(v.shape, generator=gen) < 0.5,
                                                   -math.inf, math.inf))
                 for k, v in data_cpu.items()}
        spread = torch.maximum(spread, (ransac_lib.hypotheses(moved, xs, ys) - rpf).abs())
    return spread


def solver_errors(label: str, gravity, camera, truth: np.ndarray, lm_out: dict) -> dict:
    """Median |roll|, |pitch|, |vFoV| errors in degrees against the rendered truth (roll as
    Gravity.roll reads it) and against the LM's estimate; logged, not judged."""
    got = np.stack([np.degrees(t.cpu().numpy()) for t in (gravity.roll, gravity.pitch,
                                                          camera.vfov)], -1)
    rad = np.radians(truth)
    ref = np.stack([np.degrees(read_roll(rad[:, 0], rad[:, 1])), truth[:, 1], truth[:, 2]], -1)
    lm = np.stack([np.degrees(t.cpu().numpy()) for t in (lm_out["gravity"].roll,
                                                         lm_out["gravity"].pitch,
                                                         lm_out["camera"].vfov)], -1)
    out = {"median_err_vs_truth_deg": np.median(np.abs(got - ref), 0).tolist(),
           "median_err_vs_lm_deg": np.median(np.abs(got - lm), 0).tolist()}
    log(f"baselines {label}: median roll/pitch/vfov error against the rendered views "
        f"{np.round(out['median_err_vs_truth_deg'], 4).tolist()} deg, against the LM's estimate "
        f"{np.round(out['median_err_vs_lm_deg'], 4).tolist()} deg")
    return out


def ransac_rule(hyp: np.ndarray, ref: np.ndarray, ulp: np.ndarray, spread: np.ndarray,
                share: float) -> dict:
    """RANSAC hypotheses `hyp` against `ref`, from the numbers alone (arrays of one shape).

    The argument, made before any run judged with it. Each hypothesis is a closed
    form of five float32 field values at its minimal sample's three pixels (whose
    integer coordinates are exact). Two routes that run the same formulas differ
    only where a result is not correctly rounded or is rounded at another point:
    sin and arcsin (each libm within 2 ulp), a sum in another order (the norm in
    solve_rp), a product contracted into a fused multiply-add (XLA's, half an ulp of
    the product). Each is one intermediate moved by at most about two ulps, and the
    sample's conditioning carries it to the hypothesis. A one-ulp move of each field
    value goes through the same cancellations (nearly parallel up lines, a focal
    quadratic near its double root, an arcsin near one), so `ulp`, the largest move
    of ref over RANSAC_SPREAD_DRAWS random one-ulp draws of the fields, measures that
    conditioning, and `spread` (at least `ulp`) adds the controls of a route's other
    roundings. With the few sites that differ, a route may move a hypothesis by up
    to about RANSAC_SPREAD_FACTOR spreads. Hence, per value: where ulp is within
    RANSAC_HYP_TOL of |ref| (well-conditioned), within RANSAC_HYP_TOL relative (the
    bound as it was); elsewhere (ill-conditioned) within RANSAC_SPREAD_FACTOR *
    spread (it had no bound). The share apart is then at most the share of
    ill-conditioned samples, which their conditioning sets in each run; `share`
    stays as a ceiling, since the argument gives no smaller number before the data.
    """
    hyp, ref, ulp, spread = (np.asarray(a, np.float64) for a in (hyp, ref, ulp, spread))
    dev, floor = np.abs(hyp - ref), RANSAC_HYP_TOL * np.abs(ref)
    ill = ulp > floor
    tol = np.where(ill, RANSAC_SPREAD_FACTOR * np.maximum(spread, ulp), floor)
    ratio = np.divide(dev, tol, out=np.where(dev > 0, np.inf, 0.0), where=tol > 0)
    apart = dev > floor
    out = {"dev": dev, "tol": tol, "ill": ill, "apart": apart, "over": dev > tol,
           "apart_share": float(apart.mean()), "ill_share": float(ill.mean()),
           "worst_ratio": float(ratio.max()),
           "worst_ill_ratio": float(ratio[ill].max()) if ill.any() else 0.0}
    out["ok"] = not out["over"].any() and out["apart_share"] <= share
    return out


def ransac_check(data: dict, data_cpu: dict, card: str) -> dict:
    """RANSAC at the default RansacConfig on the card's fields, timed, and held to the same
    function on the CPU: samples bit for bit, hypotheses by ransac_rule (beside two
    planted faults it must reject), and the card's winner scored by the CPU within the
    largest single pixel weight (up plus latitude confidence) of the CPU winner's
    score."""
    cfg = ransac_lib.RansacConfig()
    B, h, w = data["up_field"].shape[:3]
    key = (0, 0)  # jax.random.PRNGKey(0), run_ransac's default
    run = lambda: ransac_lib.run_ransac(data, cfg, key)
    run()  # warm
    res, ms = timed(run)
    t0 = time.perf_counter()
    ref = ransac_lib.run_ransac(data_cpu, cfg, key)
    cpu_s = time.perf_counter() - t0

    xs, ys = ransac_lib.sample_pixels(B, cfg.n_iter, h, w, key, "cuda")
    xs_c, ys_c = ransac_lib.sample_pixels(B, cfg.n_iter, h, w, key, "cpu")
    same_samples = bool(torch.equal(xs.cpu(), xs_c) and torch.equal(ys.cpu(), ys_c))
    hyp = ransac_lib.hypotheses(data, xs, ys).cpu()
    hyp_c = ransac_lib.hypotheses(data_cpu, xs_c, ys_c)
    spread = ulp_spread(data_cpu, xs_c, ys_c, hyp_c)
    rule = ransac_rule(hyp.numpy(), hyp_c.numpy(), spread.numpy(), spread.numpy(),
                       RANSAC_ILL_SHARE)
    dev, apart, ill = (torch.from_numpy(rule[k]) for k in ("dev", "apart", "ill"))
    over_rel, hyp_ok = rule["apart_share"], rule["ok"]
    # planted faults the rule must reject: a well-conditioned hypothesis moved by twice
    # its bound, and an ill-conditioned one by 1.25 times its new bound (no bound before)
    planted = {}
    for name, pick, size in (("well-conditioned x (1 + 2e-5)", ~rule["ill"], None),
                             ("ill-conditioned + 5 spreads", rule["ill"], 1.25)):
        at = np.flatnonzero(pick & (np.abs(hyp_c.numpy()) > 0))
        if not len(at):
            continue
        i = np.unravel_index(at[0], hyp_c.shape)
        bad = hyp.numpy().copy()
        bad[i] = (hyp_c.numpy()[i] * (1 + 2 * RANSAC_HYP_TOL) if size is None
                  else hyp_c.numpy()[i] + size * rule["tol"][i])
        planted[name] = ransac_rule(bad, hyp_c.numpy(), spread.numpy(), spread.numpy(),
                                    RANSAC_ILL_SHARE)["ok"]
    log(f"baselines RANSAC rule: {int(rule['ill'].sum())} of {rule['ill'].size} hypothesis values "
        f"ill-conditioned ({rule['ill_share']:.4%}, the share the samples' conditioning lets "
        f"apart; ceiling {RANSAC_ILL_SHARE:.0%}); largest deviation over its bound "
        f"{rule['worst_ratio']:.3f} of it (ill-conditioned: {rule['worst_ill_ratio']:.3f}); "
        f"planted faults passed: {planted}")
    check(len(planted) == 2 and not any(planted.values()),
          f"RANSAC: a planted fault passed the rule, or none could be planted: {planted}")

    planes = ransac_lib.observation_planes(data_cpu, cfg)
    card_by_cpu = ransac_lib._score_chunk(res.rpf.cpu()[:, None], *planes, h, w,
                                          cfg.scoring_stride, cfg)[:, 0]
    weight = float((planes[3] + planes[4]).max())
    gap = float((ref.score - card_by_cpu).abs().max())
    log(f"baselines RANSAC: {B} lanes of {h}x{w}, {2 * cfg.n_iter} hypotheses in chunks of "
        f"{cfg.chunk}, stride {cfg.scoring_stride} ({(h // cfg.scoring_stride) * (w // cfg.scoring_stride)} "
        f"pixels a lane), with confidences: {ms:.3f} ms a batch of {B} on the card (CPU "
        f"{cpu_s:.2f} s); samples bit for bit {same_samples}; hypotheses: largest deviation "
        f"{float(dev.max()):.3e}, {int(apart.sum())} ({over_rel:.4%}) over {RANSAC_HYP_TOL} "
        f"relative, of them ill-conditioned {int((apart & ill).sum())} (one-ulp spread over "
        f"{RANSAC_HYP_TOL}; {float(ill.float().mean()):.2%} of all are), verdict {hyp_ok}; "
        f"card winner scored on the CPU against the CPU winner: largest gap {gap:.4f} (bound: "
        f"the largest pixel weight {weight:.4f}); scores card {res.score.cpu().numpy().round(2).tolist()}"
        f" CPU {ref.score.numpy().round(2).tolist()}; card {card}")
    check(same_samples, "RANSAC: the card's samples differ from the CPU's")
    check(hyp_ok, "RANSAC: a well-conditioned card hypothesis is off the CPU's, or too many are")
    check(gap <= weight, f"RANSAC: the card's winner scores {gap} below the CPU winner")
    return {"ms": ms, "cpu_s": cpu_s, "hyp_max_dev": float(dev.max()), "hyp_over_rel": over_rel,
            "hyp_apart": int(apart.sum()), "hyp_apart_ill": int((apart & ill).sum()),
            "winner_gap": gap, "pixel_weight": weight, "result": res}


def gd_check(data: dict, data_cpu: dict, card: str) -> dict:
    """Adam at the default GDConfig on the card's fields, timed, against the CPU: final
    roll, pitch and vFoV within GD_TOL."""
    cfg = gd_lib.GDConfig()
    run = lambda: gd_lib.run_gradient_descent(data, cfg)
    run()  # warm
    res, ms = timed(run)
    t0 = time.perf_counter()
    ref = gd_lib.run_gradient_descent(data_cpu, cfg)
    cpu_s = time.perf_counter() - t0
    params = lambda r: torch.stack([r.gravity.roll, r.gravity.pitch, r.camera.vfov], -1).cpu()
    dev = (params(res) - params(ref)).abs().max(0).values
    log(f"baselines Adam: {cfg.num_steps} steps over {tuple(data['up_field'].shape[:3])}: {ms:.3f} "
        f"ms on the card (CPU {cpu_s:.2f} s); final roll/pitch/vfov card against "
        f"CPU {dev.numpy().tolist()} rad (bound {GD_TOL}); final cost card "
        f"{res.costs[-1].cpu().numpy().tolist()}; card {card}")
    check(bool((dev <= GD_TOL).all()), f"Adam: the card's estimate is {dev.tolist()} rad off the CPU's")
    return {"ms": ms, "cpu_s": cpu_s, "max_dev_rad": dev.tolist(), "result": res}


def deepcalib_inference(images: np.ndarray, truth: list, card: str) -> dict:
    """evaluate_baseline("deepcalib")'s prediction on the r04 weights at BASELINE_BATCH, fed
    rendered views from memory, against the port on the CPU on the same bf16-rounded
    inputs: logits within DEEPCALIB_LOGIT_TOL, and each head's bin equal wherever the
    CPU's top two logits are more than DEEPCALIB_TIE apart; timed; the summary logged."""
    net = baselines_lib.load_deepcalib(DEEPCALIB_WEIGHTS)
    net_cpu = baselines_lib.load_deepcalib(DEEPCALIB_WEIGHTS, "cpu")
    batches = [images[i:i + BASELINE_BATCH] for i in range(0, len(images), BASELINE_BATCH)]
    baselines_lib.deepcalib_outputs(net, batches[0])  # warm cuDNN
    logit_dev, tie_flips, flips = 0.0, 0, 0
    for batch in batches:
        out = baselines_lib.deepcalib_outputs(net, batch)
        ref = baselines_lib.deepcalib_outputs(net_cpu, batch)
        for head in deepcalib_train.HEADS:
            a, b = out[f"{head}_logits"].cpu(), ref[f"{head}_logits"]
            logit_dev = max(logit_dev, float((a - b).abs().max()))
            top = b.topk(2, -1).values
            differ = a.argmax(-1) != b.argmax(-1)
            flips += int(differ.sum())
            tie_flips += int((differ & ((top[:, 0] - top[:, 1]) > DEEPCALIB_TIE)).sum())
    x = batches[0]
    run = lambda: baselines_lib.deepcalib_outputs(net, x)
    ms = float(np.median([timed(run)[1] for _ in range(5)]))
    log(f"baselines DeepCalib r04: {len(images)} rendered {BASELINE_SIZE}x{BASELINE_SIZE} views at "
        f"batch {BASELINE_BATCH}, float32 network (TF32 off) on bf16-rounded inputs: logits card "
        f"against CPU {logit_dev:.3e} (bound {DEEPCALIB_LOGIT_TOL}); {flips} bins differ, {tie_flips} "
        f"of them with a top-two margin over {DEEPCALIB_TIE}; {ms:.3f} ms a batch of "
        f"{BASELINE_BATCH} ({BASELINE_BATCH / ms * 1e3:.1f} images/s); card {card}")
    check(logit_dev <= DEEPCALIB_LOGIT_TOL, f"DeepCalib: logits {logit_dev:.3e} off the CPU's")
    check(tie_flips == 0, f"DeepCalib: {tie_flips} bins differ from the CPU's off a tie")

    dataset = rendered_dataset_class({"test.csv": (images, truth)})
    summaries = {}
    with seam(baselines_lib, "SimpleDataset", dataset):
        for method in ("deepcalib", "trivial"):
            summaries[method] = baselines_lib.evaluate_baseline(
                method, "rendered", weights=str(DEEPCALIB_WEIGHTS))
            s = summaries[method]
            check(s["n_images"] == len(images) and all(
                np.isfinite(v) for k, v in s.items() if not isinstance(v, str)),
                f"{method}: the summary is not finite or misses images: {s}")
            log(f"baselines {method} through evaluate_baseline: median roll/pitch/vfov error "
                f"{s['median_roll_error']:.3f} / {s['median_pitch_error']:.3f} / "
                f"{s['median_vfov_error']:.3f} deg; AUC@1/5/10 roll "
                f"{[round(s[f'auc_roll_error@{t}'], 4) for t in (1, 5, 10)]} pitch "
                f"{[round(s[f'auc_pitch_error@{t}'], 4) for t in (1, 5, 10)]}")
    return {"logit_dev": logit_dev, "bin_flips": flips, "ms_per_batch": ms,
            "images_per_s": BASELINE_BATCH / ms * 1e3, "summaries": summaries}


@contextlib.contextmanager
def seam(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def deepcalib_training(card: str) -> dict:
    """train_deepcalib.training at its default conf (batch 32, 320x320, the "deepcalib"
    augmentation, block_config [4, 8, 12, 8], growth 32, 256 bins) on the card, warm-started
    from the r04 weights through train.init_weights, on rendered views staged from
    memory: DEEPCALIB_STEPS steps, then DEEPCALIB_RESTORED_STEPS more after restore=True.
    The restored state must equal the saved one bit for bit, the export read back by
    the port's reader must equal the final state and carry the conf, and every logged loss
    must be finite; each step is timed between CUDA events, with the peak memory."""
    rng = np.random.default_rng(8)
    splits = {csv: scenes(rng, n, BASELINE_SIZE, BASELINE_SIZE)
              for csv, n in DEEPCALIB_TRAIN_VIEWS.items()}
    work = ROOT / ".smoke" / "deepcalib"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    conf = loop_config.merge(deepcalib_train.default_conf, {
        "train": {"total_steps": DEEPCALIB_STEPS, "log_every": 1, "eval_every": 10**6,
                  "save_every": 10**6, "init_weights": str(DEEPCALIB_WEIGHTS)},
        "data": {"dataset_dir": "rendered"}})
    events, saved, restored = [], {}, {}
    make_step, manager_cls = deepcalib_train.make_train_step, deepcalib_train.ExperimentManager

    def timed_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(*args):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = step(*args)
            end.record()
            events.append((start, end))
            return out
        return run

    class Manager(manager_cls):
        def save(self, state, step, *a, **kw):
            saved[step] = state
            return super().save(state, step, *a, **kw)

        def restore(self, template, which="last"):
            state, step = super().restore(template, which)
            restored[step] = state
            return state, step

    cwd = Path.cwd()
    os.chdir(work)  # the export goes to weights/ under the working directory
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    try:
        with seam(deepcalib_train, "SimpleDataset", rendered_dataset_class(splits)), \
                seam(deepcalib_train, "make_train_step", timed_step), \
                seam(deepcalib_train, "ExperimentManager", Manager):
            deepcalib_train.training(copy.deepcopy(conf), work / "exp")
            first_export = read_flax_msgpack(work / "weights" / "deepcalib_exp.msgpack")
            conf["train"]["total_steps"] = DEEPCALIB_STEPS + DEEPCALIB_RESTORED_STEPS
            deepcalib_train.training(copy.deepcopy(conf), work / "exp", restore=True)
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {"lm_system": lm_ops.lm_system.launches, "nmf": nmf_ops.nmf.launches}
    step_ms = [s.elapsed_time(e) for s, e in events]
    records = [json.loads(line) for line in
               (work / "exp" / "logs" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss/total"] for r in records if "loss/total" in r]
    restore_ok = DEEPCALIB_STEPS in restored and states_equal(restored[DEEPCALIB_STEPS],
                                                              saved[DEEPCALIB_STEPS])
    final = saved[DEEPCALIB_STEPS + DEEPCALIB_RESTORED_STEPS]
    export = read_flax_msgpack(work / "weights" / "deepcalib_exp.msgpack")
    tree = deepcalib_params_to_jax({**final.params, **final.batch_stats},
                                   tuple(conf["train"]["block_config"]))
    same = lambda a, b: set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)
    export_ok = all(same(flat_tree(tree[c]), flat_tree(export[c])) for c in ("params", "batch_stats"))
    conf_ok = export["conf"] == {"num_bins": 256, "block_config": {"0": 4, "1": 8, "2": 12, "3": 8},
                                 "growth_rate": 32}
    moved = not same(flat_tree(tree["params"]), flat_tree(first_export["params"]))
    log(f"baselines DeepCalib training: {len(step_ms)} steps ({DEEPCALIB_STEPS}, then "
        f"{DEEPCALIB_RESTORED_STEPS} after the restore) at batch {conf['data']['batch_size']}, "
        f"{BASELINE_SIZE}x{BASELINE_SIZE}, from the r04 weights: step ms "
        f"{[round(x, 2) for x in step_ms]} (median after the first "
        f"{float(np.median(step_ms[1:])):.2f}), peak {peak:.2f} GiB; losses "
        f"{[round(x, 4) for x in losses]}; restore bit for bit {restore_ok}; export equal to the "
        f"state {export_ok}, conf {conf_ok}, moved since the first export {moved}; launches "
        f"{json.dumps(launches)}; card {card}")
    check(len(losses) == DEEPCALIB_STEPS + DEEPCALIB_RESTORED_STEPS
          and all(np.isfinite(losses)), f"DeepCalib training: losses {losses}")
    check(restore_ok, "DeepCalib training: the restored state differs from the saved one")
    check(export_ok and conf_ok, "DeepCalib training: the export differs from the state")
    check(moved, "DeepCalib training: the restored steps did not move the parameters")
    shutil.rmtree(work, ignore_errors=True)
    return {"step_ms": step_ms, "step_ms_median": float(np.median(step_ms[1:])),
            "peak_gib": peak, "losses": losses, "launches": launches}


def flat_tree(tree: dict, prefix: str = "") -> dict:
    """path -> leaf of a nested dict."""
    out = {}
    for k, v in tree.items():
        out.update(flat_tree(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def baselines_phase(calib, images: np.ndarray, truth: list, card: str) -> dict:
    """The baselines on the card (see the module docstring): RANSAC and Adam on the fields of
    one calibrate of request a's views (a path of its own: 1 NMF and 31 LM launches),
    held to the CPU; DeepCalib inference on the r04 weights and the trivial method through
    evaluate_baseline; DeepCalib training with a restore and the export. UVP is host-only."""
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    t_phase = time.perf_counter()
    calib.calibrate(images, batched=True)  # warm
    zero_counts()
    out = calib.calibrate(images, batched=True)
    torch.cuda.synchronize()
    counts = {"lm_system": lm_ops.lm_system.launches, "nmf": nmf_ops.nmf.launches,
              "lm_by_model": {k: n for k, n in lm_ops.lm_system.launches_by_model.items() if n}}
    check(counts["nmf"] == 1 and counts["lm_by_model"] == {"pinhole": 31},
          f"baselines: the fields' calibrate must launch 1 NMF and 31 LM: {counts}")
    data = {k: out[k].float().contiguous() for k in ("up_field", "latitude_field", "up_confidence",
                                                    "latitude_confidence")}
    data_cpu = cpu_copy(data)
    truth = np.asarray(truth)
    log(f"baselines: fields of request a's views {tuple(data['up_field'].shape)}, launches "
        f"{json.dumps(counts)}; UVP is host-only by design (numpy and OpenCV line detection), and "
        f"the card's machine has no cv2, so it does not run here")
    ransac = ransac_check(data, data_cpu, card)
    gd = gd_check(data, data_cpu, card)
    errors = {"ransac": solver_errors("RANSAC", ransac["result"].gravity, ransac["result"].camera,
                                      truth, out),
              "adam": solver_errors("Adam", gd["result"].gravity, gd["result"].camera, truth, out)}
    views, view_truth = scenes(np.random.default_rng(7), BASELINE_VIEWS, BASELINE_SIZE,
                               BASELINE_SIZE)
    inference = deepcalib_inference(views, view_truth, card)
    training = deepcalib_training(card)
    seconds = time.perf_counter() - t_phase
    log(f"baselines phase: {seconds:.1f} s; card {card}")
    return {"launches": {k: counts[k] for k in ("lm_system", "nmf")},
            "lm_by_model": counts["lm_by_model"], "seconds": seconds,
            "ransac": {k: v for k, v in ransac.items() if k != "result"},
            "adam": {k: v for k, v in gd.items() if k != "result"}, "errors": errors,
            "deepcalib": {k: v for k, v in inference.items() if k != "summaries"},
            "summaries": inference["summaries"], "deepcalib_train": training}


# ---------------------------------------------------------------- hub_pose phase

def original_state_dict(tree: dict) -> dict:
    """The original GeoCalib torch state_dict (as tensors) whose conversion is the Flax
    `tree`: the converter's table read backwards (HWIO kernels back to OIHW), with the
    BatchNorm counters the original carries."""
    sd = {}
    for key, (path, kind) in convert_torch._build_mapping().items():
        node = tree
        for k in path:
            node = node[k]
        leaf = np.asarray(node)
        sd[key] = torch.from_numpy(np.ascontiguousarray(
            leaf.transpose(3, 2, 0, 1) if kind == "conv" else leaf))
        if key.endswith(".running_var"):
            sd[key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def counted_calibrate(cal, label: str, images, **kw) -> Tuple[dict, dict]:
    """One calibrate as a path of its own: 1 NMF (bf16) and 31 pinhole LM launches."""
    zero_counts()
    out = cal.calibrate(images, **kw)
    torch.cuda.synchronize()
    counts = {"lm_system": lm_ops.lm_system.launches, "nmf": nmf_ops.nmf.launches,
              "lm_by_model": {k: n for k, n in lm_ops.lm_system.launches_by_model.items() if n}}
    check(counts["nmf"] == 1 and counts["lm_by_model"] == {"pinhole": 31},
          f"{label}: a calibrate must launch 1 NMF and 31 LM: {counts}")
    return out, counts


def outputs_equal(a: dict, b: dict) -> bool:
    """Two calibrate outputs bit for bit: every tensor, the camera and the gravity."""
    same = a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if k in ("camera", "gravity"):
            x, y = (x.data, y.data) if k == "camera" else (x.vec3d, y.vec3d)
        same = same and (not torch.is_tensor(x) or torch.equal(x, y))
    return same


def hub_check(calib, images: np.ndarray, card: str) -> dict:
    """hub.load of an original .tar checkpoint made from the r05 tree, in temporary
    directories outside the repository: request a's views bit for bit as the r05 msgpack
    gives them, and again from the cached conversion."""
    work = Path(tempfile.mkdtemp(prefix="gc_ckpt_"))
    cache = Path(tempfile.mkdtemp(prefix="gc_cache_"))
    before = os.environ.get("GEOCALIB_TPU_CACHE")
    os.environ["GEOCALIB_TPU_CACHE"] = str(cache)
    try:
        t0 = time.perf_counter()
        tar = work / "geocalib-r05.tar"
        torch.save({"model": original_state_dict(read_flax_msgpack(WEIGHTS))}, tar)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cal = hub_lib.load(str(tar))
        load_s = time.perf_counter() - t0
        cached = cache / "geocalib-r05.msgpack"
        check(cal.device.type == "cuda" and cached.exists(),
              f"hub: device {cal.device}, cached {cached.exists()}")
        stamp = cached.stat().st_mtime_ns
        cal.calibrate(images, batched=True)  # warm
        out, c_hub = counted_calibrate(cal, "hub", images, batched=True)
        ref, c_ref = counted_calibrate(calib, "r05 msgpack", images, batched=True)
        first = outputs_equal(out, ref)
        del cal
        t0 = time.perf_counter()
        cal = hub_lib.load(str(tar))
        reload_s = time.perf_counter() - t0
        again, c_again = counted_calibrate(cal, "hub from its cache", images, batched=True)
        second = outputs_equal(again, ref) and cached.stat().st_mtime_ns == stamp
        del cal
        log(f"hub: original checkpoint written in {save_s:.1f} s, converted and loaded in "
            f"{load_s:.1f} s, loaded from the cache in {reload_s:.1f} s; request a bit for bit "
            f"as the r05 msgpack gives it: {first}, from the cache: {second}; card {card}")
        check(first and second, "hub: the converted weights do not give the r05 msgpack's bits")
        launches = [c_hub, c_ref, c_again]
        return {"bitwise": first, "cached_bitwise": second, "save_s": save_s, "load_s": load_s,
                "reload_s": reload_s, "launches": launches}
    finally:
        if before is None:
            os.environ.pop("GEOCALIB_TPU_CACHE", None)
        else:
            os.environ["GEOCALIB_TPU_CACHE"] = before
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(cache, ignore_errors=True)


def pose_scene(rng: np.random.Generator, roll: float, pitch: float, vfov: float, h: int, w: int):
    """A known pose of a camera with this roll, pitch and vFoV (radians) and a random yaw
    about the world's gravity (0, 0, -1), POSE_POINTS points of a ground plane 1.5 below it
    that project into the h x w image, and their pixels, the first POSE_OUTLIER_SHARE of
    them replaced by outliers at least POSE_OUTLIER_MIN_PX from the true projection."""
    g_world = np.array([0.0, 0.0, -1.0])
    # Gravity.from_rp's vector, in float64 so that the true rotation is orthonormal
    g_cam = np.array([-math.sin(roll) * math.cos(pitch), -math.cos(roll) * math.cos(pitch),
                      math.sin(pitch)])
    R = pose_lib.rotation_aligning(g_world, g_cam) @ pose_lib.rot_z(rng.uniform(-math.pi, math.pi))
    f = h / 2 / math.tan(vfov / 2)
    camera = {"model": "PINHOLE", "width": w, "height": h, "params": [f, f, w / 2, h / 2]}
    centre = np.array([*rng.uniform(-5, 5, 2), 0.0])
    t = -R @ centre
    X = np.concatenate([centre[:2] + rng.uniform(-40, 40, (20000, 2)), np.zeros((20000, 1))], 1)
    for side in (1.5, -1.5):  # the plane on the side of the camera the image sees
        X[:, 2] = side
        p2d, front = pose_lib.project((R @ X.T).T + t, camera)
        seen = front & (p2d >= 0).all(1) & (p2d[:, 0] < w) & (p2d[:, 1] < h)
        if seen.sum() >= POSE_POINTS:
            break
    idx = rng.choice(np.nonzero(seen)[0], POSE_POINTS, replace=False)
    X, p2d = X[idx], p2d[idx].copy()
    k = int(POSE_OUTLIER_SHARE * POSE_POINTS)
    out = rng.uniform([0, 0], [w, h], (k, 2))
    near = np.linalg.norm(out - p2d[:k], axis=1) < POSE_OUTLIER_MIN_PX
    while near.any():
        out[near] = rng.uniform([0, 0], [w, h], (int(near.sum()), 2))
        near = np.linalg.norm(out - p2d[:k], axis=1) < POSE_OUTLIER_MIN_PX
    p2d[:k] = out
    return R, t, X, p2d, camera, g_cam


def angle_deg(a: np.ndarray, b: np.ndarray) -> float:
    """The angle of two vectors, accurate when it is small (atan2 of sine and cosine)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return math.degrees(math.atan2(np.linalg.norm(np.cross(a, b)), a @ b))


def rotation_deg(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """The angle of Ra Rbᵀ from its chord ‖Ra − Rb‖_F = 2√2 sin(θ/2): accurate when small."""
    return math.degrees(2 * math.asin(min(1.0, np.linalg.norm(Ra - Rb) / (2 * math.sqrt(2)))))


class FixedCalibration:
    """A calibrator that answers with a calibration already made (for the CPU rerun)."""

    def __init__(self, calib: dict):
        self.calib = calib

    def calibrate(self, image, priors=None):
        return {"gravity": Gravity(torch.from_numpy(self.calib["gravity_vec"])),
                "gravity_uncertainty": torch.tensor(self.calib["gravity_uncertainty"])}


def pose_check(calib, images: np.ndarray, truth: list, card: str) -> dict:
    """AbsolutePoseEstimator with the card's GeoCalib on request a's first views, against
    the same estimator on the CPU given the same calibration, and against the true pose."""
    rng = np.random.default_rng(11)
    est = pose_lib.AbsolutePoseEstimator(calibrator=calib)
    h, w = images.shape[1:3]
    views, launches = [], []
    for i in range(POSE_VIEWS):
        roll, pitch, vfov = (math.radians(x) for x in truth[i])
        R, t, X, p2d, camera, g_true = pose_scene(rng, roll, pitch, vfov, h, w)
        zero_counts()
        t0 = time.perf_counter()
        ret, cal = est(images[i], p2d, X, camera)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {"lm_system": lm_ops.lm_system.launches, "nmf": nmf_ops.nmf.launches,
                  "lm_by_model": {k: n for k, n in lm_ops.lm_system.launches_by_model.items()
                                  if n}}
        check(counts["nmf"] == 1 and counts["lm_by_model"] == {"pinhole": 31},
              f"pose view {i}: its calibrate must launch 1 NMF and 31 LM: {counts}")
        launches.append(counts)
        ret_cpu, cal_cpu = pose_lib.AbsolutePoseEstimator(calibrator=FixedCalibration(cal))(
            images[i], p2d, X, camera)
        same = ret.keys() == ret_cpu.keys() and all(
            np.array_equal(np.asarray(ret[k]), np.asarray(ret_cpu[k]))
            for k in ("success", "R", "tvec", "qvec", "inliers", "num_inliers") if k in ret)
        branch = ("gravity" if cal["gravity_uncertainty"] <= est.opts.max_uncertainty
                  else "pnp (planar: degenerate, not judged)")
        g_err = angle_deg(cal["gravity_vec"], g_true)
        bound = POSE_GRAVITY_SHARE * g_err + POSE_FLOOR_DEG
        solved = bool(ret.get("success"))
        entry = {"branch": branch, "success": solved, "gravity_err_deg": g_err,
                 "gravity_uncertainty_deg": math.degrees(cal["gravity_uncertainty"]),
                 "rotation_err_deg": rotation_deg(ret["R"], R) if solved else None,
                 "bound_deg": bound,
                 "translation_err": float(np.linalg.norm(ret["tvec"] - t)) if solved else None,
                 "inliers": int(ret.get("num_inliers", 0)), "cpu_bitwise": same, "ms": ms}
        log(f"pose view {i}: {json.dumps(entry)}; card {card}")
        check(same, f"pose view {i}: the CPU rerun differs from the card's run")
        if branch == "gravity":
            check(solved and entry["rotation_err_deg"] <= bound,
                  f"pose view {i}: rotation {entry['rotation_err_deg']} deg over its bound "
                  f"{bound:.4f}")
        views.append(entry)
    check(any(v["branch"] == "gravity" for v in views), "pose: no view took the gravity branch")
    return {"views": views, "launches": launches}


def winograd_check(card: str) -> dict:
    """winograd_conv3x3 on the card against F.conv2d, float32, TF32 off, both timed."""
    rng = np.random.default_rng(5)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    rows = []
    try:
        for shape in WINOGRAD_SHAPES:
            B, H, W, C, F = shape
            x = torch.from_numpy(rng.normal(size=(B, H, W, C)).astype(np.float32)).cuda()
            k = torch.from_numpy((rng.normal(size=(3, 3, C, F)) / 3).astype(np.float32)).cuda()
            b = torch.from_numpy(rng.normal(size=(F,)).astype(np.float32)).cuda()
            x_nchw, k_oihw = x.permute(0, 3, 1, 2).contiguous(), k.permute(3, 2, 0, 1).contiguous()
            u = winograd.transform_kernel(k)
            wino = lambda: winograd.winograd_conv3x3(x, None, b, u=u)  # noqa: E731
            conv = lambda: torch.nn.functional.conv2d(x_nchw, k_oihw, b, padding=1)  # noqa: E731
            got, want = wino(), conv().permute(0, 2, 3, 1)
            err = (got - want).abs()
            ok = bool((err <= WINOGRAD_TOL + WINOGRAD_TOL * want.abs()).all())
            row = {"shape": list(shape), "max_abs_err": float(err.max()), "ok": ok,
                   "ms": cuda_ms(wino), "conv2d_ms": cuda_ms(conv)}
            log(f"winograd {json.dumps(row)}; card {card}")
            check(ok, f"winograd {shape}: off F.conv2d by {row['max_abs_err']:.3g}")
            rows.append(row)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return {"shapes": rows}


def hub_pose_phase(calib, images: np.ndarray, truth: list, card: str) -> dict:
    """The hub, pose estimation and Winograd on the card (see the module docstring)."""
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    t_phase = time.perf_counter()
    hub = hub_check(calib, images, card)
    pose = pose_check(calib, images, truth, card)
    wino = winograd_check(card)
    counted = hub["launches"] + pose["launches"]
    seconds = time.perf_counter() - t_phase
    log(f"hub_pose phase: {seconds:.1f} s; card {card}")
    return {"launches": {k: sum(c[k] for c in counted) for k in ("lm_system", "nmf")},
            "lm_by_model": {"pinhole": sum(c["lm_by_model"]["pinhole"] for c in counted)},
            "hub": {k: v for k, v in hub.items() if k != "launches"},
            "pose": pose["views"], "winograd": wino["shapes"], "seconds": seconds}


# ---------------------------------------------------------------- distributed phase

def state_digest(state) -> str:
    """sha256 over every tensor of a TrainState (parameters, statistics, Adam count and
    moments) and its step, in name order: equal digests are equal states, bit for bit."""
    h = hashlib.sha256(str(int(state.step)).encode())
    opt = state.opt_state
    for tree in (state.params, state.batch_stats, opt.mu, opt.nu):
        for k in sorted(tree):
            h.update(k.encode())
            h.update(tree[k].detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    h.update(opt.count.cpu().numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def deterministic():
    """cuDNN deterministic, no TF32: the same state and key give the same bits."""
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) = flags


@contextlib.contextmanager
def counted_collectives(counts: dict):
    """Count, while active, every all-reduce of parallel/mesh.py (calls and bytes) and
    the BatchNorm statistics' means over the ranks (forward calls; each has one
    all-reduce in the backward too)."""
    reduce, bn_mean = pmesh._all_reduce, modules_lib.mean_over_ranks

    def counted_reduce(x, *a, **kw):
        counts["all_reduce"] += 1
        counts["bytes"] += x.numel() * x.element_size()
        return reduce(x, *a, **kw)

    def counted_bn(x, mesh):
        counts["batchnorm_forward"] += 1
        return bn_mean(x, mesh)

    pmesh._all_reduce, modules_lib.mean_over_ranks = counted_reduce, counted_bn
    try:
        yield counts
    finally:
        pmesh._all_reduce, modules_lib.mean_over_ranks = reduce, bn_mean


def mean_grads(out: tuple, mesh) -> tuple:
    """compute_grads' output with its gradients replaced by their mean over the ranks,
    taken as the step takes it: one all-reduce of the leaves concatenated."""
    loss, grads, stats, losses, metrics = out
    flat = pmesh.mean_over_ranks(torch.cat([g.reshape(-1) for g in grads.values()]), mesh)
    parts = flat.split([g.numel() for g in grads.values()])
    return loss, {k: p.view(g.shape) for (k, g), p in zip(grads.items(), parts)}, stats, losses, \
        metrics


def nccl_one_rank(weights: dict, work: Path) -> dict:
    """DIST_NCCL_STEPS IFT steps of the train phase's setup (MSCAN-B, the r05 weights,
    batch 24 at 320x320, a float32 network) without a process group and with an NCCL
    group of one rank: the states and scalars must be equal bit for bit."""
    batch = train_batch(np.random.default_rng(3))
    cfg = train_lib.TrainConfig(compute_dtype="float32")

    def run(mesh):
        net, state = train_lib.create_train_state(cfg, weights, device="cuda", mesh=mesh)
        out = []
        for i in range(DIST_NCCL_STEPS):
            state, scalars = train_lib.train_step(net, cfg, state, batch, (0, i))
            out.append((state, scalars))
        return out

    with deterministic():
        ref = run(None)
        dist.init_process_group("nccl", store=dist.FileStore(str(work / "nccl_store"), 1),
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
        try:
            mesh = pmesh.make_mesh("cuda:0")
            backend = dist.get_backend()
            zero_counts()
            got = run(mesh)
            torch.cuda.synchronize()
            launches = {"lm_system": lm_ops.lm_system.launches, "nmf": nmf_ops.nmf.launches}
        finally:
            dist.destroy_process_group()
    equal = [states_equal(a, b) and set(sa) == set(sb) and all(torch.equal(sa[k], sb[k])
                                                               for k in sa)
             for (a, sa), (b, sb) in zip(ref, got)]
    log(f"distributed, {backend} with one rank in this process: {DIST_NCCL_STEPS} IFT steps "
        f"(MSCAN-B, batch {TRAIN_B} at {TRAIN_SIZE}x{TRAIN_SIZE}, float32 network) bit for bit "
        f"equal to the same steps without a group, step by step: {equal}; launches {launches}")
    check(backend == "nccl" and all(equal) and len(equal) == DIST_NCCL_STEPS,
          f"distributed: NCCL with one rank differs from no group: {equal}")
    check(launches == {"lm_system": DIST_NCCL_STEPS * (cfg.lm_steps + 1), "nmf": 0},
          f"distributed, NCCL one rank: launches {launches}")
    del ref, got
    torch.cuda.empty_cache()
    return {"equal": equal, "launches": launches}


def leaf_controls(weights: dict) -> dict:
    """The float32 comparison of kernels against plain versions at the first state, in
    one process on the whole batch of 24, with the distributed steps' setup (drop path,
    key (0, 0)) and with the train phase's (no drop path, key (0, 5))."""
    batch = train_batch(np.random.default_rng(3))
    out = {}
    for label, c, key in leaf_setups(train_lib.TrainConfig(compute_dtype="float32")):
        net, state = train_lib.create_train_state(c, weights, device="cuda")
        run = lambda: train_lib.compute_grads(net, c, state, batch, key)  # noqa: E731
        with plain_versions(lm=True, nmf=False):
            ref = run()
        out[f"one process, {TRAIN_B} rows, {label}"] = grad_compare(
            f"one process, {TRAIN_B} rows, {label}, kernels vs plain", run(), ref)
        del ref, net, state
    torch.cuda.empty_cache()
    return out


def leaf_setups(cfg) -> list:
    """(label, config, key) of the two setups the worst leaf is compared in (the drop
    path rate is the network's, set where create_train_state builds it)."""
    return [("the step's setup", cfg, (0, 0)),
            ("the train phase's setup", replace_cfg(cfg, drop_path_rate=0.0), (0, 5))]


def distributed_rank(rank: int, work: str, body=None) -> None:
    """A rank of the distributed phase, in a process of its own (started by spawn): it
    joins a gloo group of DIST_RANKS over a FileStore, drives the card cuda:0 that it
    shares with the other rank, runs body(mesh, work) (distributed_rank_run by default)
    and writes its results to rank<r>.json; its stdout goes to rank<r>.log."""
    work = Path(work)
    faulthandler.dump_traceback_later(DIST_TIMEOUT_S, exit=True)
    sys.stdout = open(work / f"rank{rank}.log", "w", buffering=1)
    sys.stderr = sys.stdout
    dist.init_process_group("gloo", store=dist.FileStore(str(work / "gloo_store"), DIST_RANKS),
                            rank=rank, world_size=DIST_RANKS,
                            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        with deterministic():
            out = (body or distributed_rank_run)(pmesh.make_mesh("cuda:0"), work)
    finally:
        dist.destroy_process_group()
    (work / f"rank{rank}.json").write_text(json.dumps(out))


def distributed_rank_run(mesh, work: Path) -> dict:
    """This rank's 12 rows of the train phase's batch: 3 IFT steps and 1 unrolled step
    through the kernels (launches counted around each step, CUDA events, a digest of the
    state after each), each step's mean gradient by the kernels against the plain
    versions on the same state (the train phase's float32 rule), the same 4 steps
    through the plain versions (digests), the bf16 comparison (reported), the staged
    store, step and eval window (the window and its NMF against the plain versions),
    the first state's comparison in other setups, the shared-intrinsics LM on this
    rank's lanes of request a, the flat-gradient all-reduce timed, and the peak
    memory."""
    rank, per = mesh.rank, TRAIN_B // mesh.size
    torch.cuda.reset_peak_memory_stats()
    weights = params_from_jax(read_flax_msgpack(WEIGHTS), "b")
    batch = train_batch(np.random.default_rng(3))
    local = {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}
    cfg = train_lib.TrainConfig(compute_dtype="float32")
    cfgs = (cfg, cfg, cfg, replace_cfg(cfg, lm_grad_mode="unroll"))
    net, state0 = train_lib.create_train_state(cfg, weights, mesh=mesh)
    out = {"rank": rank, "rows": per, "steps": [], "plain_digests": []}

    state = state0
    for i, c in enumerate(cfgs):
        run = lambda s=state, c=c, i=i: mean_grads(  # noqa: E731
            train_lib.compute_grads(net, c, s, local, (0, i)), mesh)
        with plain_versions(lm=True, nmf=False):
            ref = run()
            if i == 0:
                again = run()
                out["plain_repeatable"] = torch.equal(ref[0], again[0]) and all(
                    torch.equal(ref[1][k], again[1][k]) for k in ref[1])
                del again
        compare = grad_compare(f"rank {rank} step {i} ({c.lm_grad_mode}), kernels vs plain",
                               run(), ref)
        del ref
        zero_counts()
        counts = {"all_reduce": 0, "bytes": 0, "batchnorm_forward": 0}
        with counted_collectives(counts):
            (state, scalars), ms = timed(lambda: train_lib.train_step(net, c, state, local,
                                                                      (0, i)))
        out["steps"].append({
            "mode": c.lm_grad_mode, "ms": ms, "digest": state_digest(state),
            "launches": {"lm_system": lm_ops.lm_system.launches, "nmf": nmf_ops.nmf.launches},
            "collectives": counts, "compare": compare,
            "scalars": {k: float(v) for k, v in scalars.items()}})
    kernel_state = state

    state = state0
    with plain_versions(lm=True, nmf=False):
        for i, c in enumerate(cfgs):
            state, _ = train_lib.train_step(net, c, state, local, (0, i))
            out["plain_digests"].append(state_digest(state))
    out["kernels_vs_plain_after_4_steps"] = max(
        float((kernel_state.params[k] - v).abs().max()) for k, v in state.params.items())
    del state, kernel_state

    c16 = replace_cfg(cfg, compute_dtype="bfloat16")
    run16 = lambda: mean_grads(  # noqa: E731
        train_lib.compute_grads(net, c16, state0, local, (0, 0)), mesh)
    with plain_versions(lm=True, nmf=False):
        ref = run16()
    out["bf16_reported"] = grad_compare(f"rank {rank} bf16 network, ift, kernels vs plain "
                                        f"(reported, not judged)", run16(), ref)
    del ref

    images, truth = scenes(np.random.default_rng(8), DIST_STAGED_ROWS, TRAIN_SIZE, TRAIN_SIZE)
    ds = rendered_dataset_class({"train.csv": (images, truth)})(
        loop_lib.DatasetConf(csv_name="train.csv", batch_size=TRAIN_B))
    store = store_lib.DeviceStore.stage_sharded(ds, mesh, progress=None)
    rows = DIST_STAGED_ROWS // mesh.size
    want = np.clip(images[rank * rows:(rank + 1) * rows] * 255.0, 0, 255).astype(np.uint8)
    out["store"] = {"rows": len(store), "own_slice": len(store) == rows and bool(
        np.array_equal(store.images.cpu().numpy(), want))}
    step = store_lib.make_staged_train_step(net, cfg, TRAIN_B, augment=True)
    zero_counts()
    (staged, scalars), ms = timed(lambda: step(state0, store.images, store.gt_params, (0, 9)))
    out["staged_step"] = {"ms": ms, "digest": state_digest(staged),
                          "launches": {"lm_system": lm_ops.lm_system.launches,
                                       "nmf": nmf_ops.nmf.launches},
                          "loss": float(scalars["loss/total"])}
    window = store_lib.make_staged_eval_step(net, cfg, TRAIN_B)
    run_window = lambda: {k: float(v) for k, v in window(  # noqa: E731
        state0, store.images, store.gt_params, 0, (0, 9)).items()}
    calls = []
    zero_counts()
    with patched_nmf(calls):
        val = run_window()
    out["staged_eval"] = {"launches": {"lm_system": lm_ops.lm_system.launches,
                                       "nmf": nmf_ops.nmf.launches,
                                       "nmf_by_dtype": dict(nmf_ops.nmf.launches_by_dtype)},
                          "finite": all(math.isfinite(v) for v in val.values()),
                          "loss": val["loss/total"]}
    # the window's NMF (the float32 instance) against nmf_plain on the inputs it was
    # given, and the window by the kernels against the plain versions, each beside a
    # control with one NMF step fewer that its rule must reject
    with plain_versions(lm=True, nmf=True):
        val_plain = run_window()
    with patched_nmf(wrong=True):
        val_wrong = run_window()
    out["staged_eval"]["vs_plain"] = validation_compare(
        f"rank {rank} staged eval window, kernels vs plain", val, val_plain, TRAIN_LOSS_TOL)
    out["staged_eval"]["wrong_nmf_vs_plain"] = validation_compare(
        f"rank {rank} staged eval window, one NMF step fewer (control) vs plain", val_wrong,
        val_plain, TRAIN_LOSS_TOL)
    out["staged_eval"]["nmf"] = nmf_check(f"rank {rank} staged eval window", *calls[0])
    if rank == 0:
        torch.save([t.cpu() if torch.is_tensor(t) else t for t in calls[0]], work / "nmf_inputs.pt")
    del store, staged, calls

    # the same comparison as each step's, without the mesh on this rank's rows: with the
    # distributed phase's setup (drop path, the step's key) and with the train phase's
    # (no drop path, its key), the latter under the mesh too; which of lanes, setup and
    # collectives sets the worst leaf
    setups = [(f"one process, rank {rank}'s {per} rows, {label}", None, c, key)
              for label, c, key in leaf_setups(cfg)]
    setups.append((f"the mesh, {mesh.size} x {per} rows, the train phase's setup", mesh,
                   *leaf_setups(cfg)[1][1:]))
    out["leaf_controls"] = {}
    for label, m, c, key in setups:
        n_, _ = train_lib.create_train_state(c, weights, device=mesh.device, mesh=m)
        run = lambda: mean_grads(train_lib.compute_grads(  # noqa: E731
            n_, c, state0, local, key), m)
        with plain_versions(lm=True, nmf=False):
            ref = run()
        out["leaf_controls"][label] = grad_compare(f"rank {rank}, {label}, kernels vs plain",
                                                   run(), ref)
        del ref, n_

    fields = torch.load(work / "request_a.pt", weights_only=True)
    lanes = len(fields["up_field"]) // mesh.size
    data = {k: v[rank * lanes:(rank + 1) * lanes].to(mesh.device) for k, v in fields.items()}
    zero_counts()
    res = lm_solver.run_lm(data, LMConfig(shared_intrinsics=True, early_stop=False, mesh=mesh))
    out["shared_lm"] = {"vfov": res.camera.vfov.tolist(), "roll": res.gravity.roll.tolist(),
                        "pitch": res.gravity.pitch.tolist(),
                        "launches": lm_ops.lm_system.launches_by_model.get("pinhole", 0)}

    n = sum(v.numel() for v in state0.params.values())
    flat = torch.ones(n, device=mesh.device)
    times = []
    for _ in range(DIST_ALLREDUCE_REPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pmesh.mean_over_ranks(flat, mesh)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["grad_all_reduce"] = {"ms_median": float(np.median(times[1:])), "ms": times[1:],
                              "bytes": n * 4}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


@contextlib.contextmanager
def patched_nmf(calls: list = None, wrong: bool = False):
    """While active, the network's NMF reconstructions append their arguments (copies
    of x and the bases, then steps, inv_t, eps) to `calls`; wrong: they run one
    multiplicative step fewer, a control that the NMF checks must reject."""
    fn = hamburger.nmf_reconstruct

    def recon(x, b, steps, *a):
        if calls is not None:
            calls.append((x.detach().clone(), b.detach().clone(), steps, *a))
        return fn(x, b, steps - 1 if wrong else steps, *a)

    hamburger.nmf_reconstruct = recon
    try:
        yield
    finally:
        hamburger.nmf_reconstruct = fn


def nmf_check(label: str, x, bases, steps: int, *args) -> dict:
    """The NMF kernel's reconstruction against nmf_plain's on these inputs (relative
    Frobenius error, bound NMF_TOL for bf16, NMF_F32_TOL for float32), beside the
    kernel with one step fewer, which must exceed the bound."""
    exact_matmul()
    ref = torch.matmul(*nmf_ops.nmf_plain(x, bases, steps, *args)).float()
    rel = lambda y: float(torch.linalg.norm((y.float() - ref).flatten())  # noqa: E731
                          / torch.linalg.norm(ref.flatten()))
    got = nmf_ops.nmf_reconstruct(x, bases, steps, *args)
    wrong = nmf_ops.nmf_reconstruct(x, bases, steps - 1, *args)
    bound = NMF_TOL if x.dtype == torch.bfloat16 else NMF_F32_TOL
    out = {"shape": list(x.shape) + [bases.shape[2]], "dtype": str(x.dtype), "steps": steps,
           "rel": rel(got), "max_abs_err": float((got.float() - ref).abs().max()),
           "wrong_rel": rel(wrong), "bound": bound,
           "finite": bool(torch.isfinite(got).all())}
    out["ok"] = out["rel"] <= bound and out["finite"] and out["wrong_rel"] > bound
    log(f"{label}: nmf kernel vs plain {tuple(x.shape)} R={bases.shape[2]} {x.dtype}: relative "
        f"Frobenius {out['rel']:.3e} (bound {bound}), max abs {out['max_abs_err']:.3e}; one step "
        f"fewer (control) {out['wrong_rel']:.3e}: {'passes' if out['ok'] else 'FAILS'}")
    return out


def run_ranks(work: Path, body=None) -> list:
    """Start DIST_RANKS ranks with multiprocessing's spawn (CUDA is already initialised
    here, so no fork), each running `body` (distributed_rank), and return their results;
    wait for them within DIST_TIMEOUT_S: a rank that exits
    non-zero or outlives the timeout fails the phase, and every other rank is stopped."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=distributed_rank, args=(r, str(work), body))
             for r in range(DIST_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DIST_TIMEOUT_S
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.5)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * DIST_RANKS:
        for r in range(DIST_RANKS):
            log_path = work / f"rank{r}.log"
            tail = log_path.read_text()[-4000:] if log_path.exists() else "(no log)"
            log(f"distributed rank {r} exited {codes[r]}; its log ends:\n{tail}")
    check(codes == [0] * DIST_RANKS, f"distributed: the ranks exited {codes} (killed at "
                                     f"{DIST_TIMEOUT_S} s if still running)")
    return [json.loads((work / f"rank{r}.json").read_text()) for r in range(DIST_RANKS)]


def distributed_phase(weights: dict, calib, images: np.ndarray, card: str,
                      train_leaf: float) -> dict:
    """Data-parallel training (parallel/mesh.py) on the card: NCCL with one rank in this
    process bit for bit equal to no group; then DIST_RANKS ranks over gloo on this one
    card (NCCL refuses two ranks on one GPU), each 12 rows of the train phase's batch of
    24 (float32 network): the ranks' states equal after every step, each step's mean
    gradient by the kernels within the train phase's float32 rule of the plain versions'
    (the bf16 comparison reported), the shared-intrinsics LM over the ranks' lanes of
    request a within DIST_VFOV_TOL of this process on all 16 lanes, the staged store's
    rows split by rank, and the staged eval window's float32 NMF against nmf_plain on
    its inputs (timed here on rank 0's). The gloo times go through the host and say
    nothing of NCCL between cards."""
    t_start = time.perf_counter()
    faulthandler.dump_traceback_later(2 * DIST_TIMEOUT_S, exit=True)
    work = ROOT / ".smoke" / f"distributed_{os.getpid()}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    nccl = nccl_one_rank(weights, work)
    with deterministic():
        whole = leaf_controls(weights)

    data = request_system(calib, images, "pinhole", {})[0]
    fields = {k: data[k].float().contiguous() for k in ("up_field", "latitude_field",
                                                        "up_confidence", "latitude_confidence")}
    ref = lm_solver.run_lm(fields, LMConfig(shared_intrinsics=True, early_stop=False))
    torch.save({k: v.cpu() for k, v in fields.items()}, work / "request_a.pt")
    del data, fields
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = run_ranks(work)
    ranks_s = time.perf_counter() - t0
    per_step = train_lib.TrainConfig().lm_steps + 1
    for name in ("steps", "plain"):
        digests = [[s["digest"] for s in r["steps"]] if name == "steps" else r["plain_digests"]
                   for r in ranks]
        equal = [len(set(d)) == 1 for d in zip(*digests)]
        log(f"distributed, gloo, {DIST_RANKS} ranks on one card, {name}: the ranks' states "
            f"(parameters, Adam state, running statistics) bit for bit equal after each step: "
            f"{equal}")
        check(all(equal) and len(equal) == 4, f"distributed: the ranks' states differ ({name})")
        check(len(set(digests[0])) == 4, f"distributed: the state did not move ({name})")
    check(len({r["staged_step"]["digest"] for r in ranks}) == 1,
          "distributed: the ranks' states differ after the staged step")
    worst = {}
    for r in ranks:
        check(r["plain_repeatable"], f"rank {r['rank']}: two plain runs differ")
        for i, s in enumerate(r["steps"]):
            check(s["compare"]["ok"], f"distributed rank {r['rank']} step {i}: kernels vs plain "
                                      f"{s['compare']}")
            check(s["launches"] == {"lm_system": per_step, "nmf": 0},
                  f"distributed rank {r['rank']} step {i}: launches {s['launches']}")
            check(all(math.isfinite(v) for v in s["scalars"].values())
                  and s["scalars"]["skipped_nonfinite"] == 0.0, f"step {i}: {s['scalars']}")
            if s["compare"]["leaf_rel"] >= worst.get("leaf_rel", -1.0):
                worst = dict(s["compare"], rank=r["rank"], step=i)
        check(r["store"]["own_slice"], f"rank {r['rank']}: the staged store {r['store']}")
        ev = r["staged_eval"]
        check(r["staged_step"]["launches"] == {"lm_system": per_step, "nmf": 0}
              and ev["launches"] == {"lm_system": per_step, "nmf": 1,
                                     "nmf_by_dtype": {"float32": 1, "bfloat16": 0}}
              and ev["finite"],
              f"rank {r['rank']}: staged step {r['staged_step']} eval {ev['launches']}")
        check(ev["nmf"]["ok"], f"rank {r['rank']}: the eval window's NMF {ev['nmf']}")
        check(all(x["ok"] for x in ev["vs_plain"].values()),
              f"rank {r['rank']}: the eval window, kernels vs plain: {ev['vs_plain']}")
        check(not all(x["ok"] for x in ev["wrong_nmf_vs_plain"].values()),
              f"rank {r['rank']}: the eval window with one NMF step fewer passed its rule")
        for kind in ("vs_plain", "wrong_nmf_vs_plain"):
            worst_rel = max((k for k, x in ev[kind].items() if x["kind"] == "rel"),
                            key=lambda k: ev[kind][k]["dev"])
            log(f"distributed rank {r['rank']}, the staged eval window {kind.replace('_', ' ')} "
                f"(float32 loss bound {TRAIN_LOSS_TOL}): largest relative loss deviation "
                f"{ev[kind][worst_rel]['dev']:.3e} in {worst_rel}; over the rule: "
                f"{[k for k, x in ev[kind].items() if not x['ok']]}")
        check(r["shared_lm"]["launches"] == 31, f"rank {r['rank']}: shared LM {r['shared_lm']}")
    log(f"distributed, kernels vs plain, each step's mean gradient over the ranks (float32 "
        f"network, the train phase's rule): worst leaf {worst['leaf_rel']:.3e} in "
        f"{worst['worst_leaf']} (rank {worst['rank']}, step {worst['step']}), loss terms "
        f"{max(s['compare']['loss_rel'] for r in ranks for s in r['steps']):.3e}, global norm "
        f"{max(s['compare']['norm_rel'] for r in ranks for s in r['steps']):.3e}: passes")

    # the worst leaf's relative L2 is its deviation over its norm: each setup's, with both
    controls = whole | {k: v for r in ranks for k, v in r["leaf_controls"].items()
                        if "the mesh" not in k or r["rank"] == 0}
    controls[f"the mesh, {DIST_RANKS} x {TRAIN_B // DIST_RANKS} rows, the step's setup (step 0 "
             f"above)"] = ranks[0]["steps"][0]["compare"]
    for label, c in controls.items():
        log(f"distributed, kernels vs plain at the first state, {label}: worst leaf "
            f"{c['leaf_rel']:.3e} in {c['worst_leaf']} (its L2 {c['worst_leaf_l2']:.4e}, the "
            f"deviation's {c['worst_leaf_dev_l2']:.4e}), loss terms {c['loss_rel']:.3e}, norm "
            f"{c['norm_rel']:.3e}")
        check(c["ok"], f"distributed, {label}: kernels vs plain {c}")
    log(f"distributed, the setups: the step's drop path "
        f"{train_lib.TrainConfig().drop_path_rate} and key (0, 0), the train phase's no drop "
        f"path and key (0, 5); the train phase's own comparison (one process, its state): "
        f"{train_leaf:.3e}")

    x, bases, steps, *args = torch.load(work / "nmf_inputs.pt", weights_only=True)
    x, bases = x.cuda(), bases.cuda()
    nmf32 = nmf_check("distributed, rank 0's eval window inputs in this process", x, bases, steps,
                      *args)
    check(nmf32["ok"], f"distributed: the float32 NMF at the eval window's inputs {nmf32}")
    nmf32 |= nmf_f32_times(x, bases, steps, "the eval window's shape", card, *args)
    del x, bases

    vfov = np.concatenate([r["shared_lm"]["vfov"] for r in ranks])
    rp = np.concatenate([np.stack([r["shared_lm"]["roll"], r["shared_lm"]["pitch"]], -1)
                         for r in ranks])
    ref_rp = torch.stack([ref.gravity.roll, ref.gravity.pitch], -1).cpu().numpy()
    vfov_dev = float(np.abs(vfov - ref.camera.vfov.cpu().numpy()).max())
    rp_dev = float(np.abs(rp - ref_rp).max())
    log(f"distributed, shared-intrinsics LM (LM kernel, early stop off) over {DIST_RANKS} ranks "
        f"of 8 lanes of request a against this process on its 16 lanes: vFoV within "
        f"{vfov_dev:.3e} rad (bound {DIST_VFOV_TOL}), roll and pitch within {rp_dev:.3e} rad "
        f"(reported); one vFoV over the ranks: {len(set(vfov.tolist())) == 1}")
    check(vfov_dev <= DIST_VFOV_TOL and len(set(vfov.tolist())) == 1,
          f"distributed: the shared LM over the ranks deviates by {vfov_dev:.3e} rad")

    for r in ranks:
        ift = sorted(s["ms"] for s in r["steps"] if s["mode"] == "ift")
        col = r["steps"][0]["collectives"]
        red = r["grad_all_reduce"]
        log(f"distributed rank {r['rank']} (gloo through the host, 2 ranks sharing one card; "
            f"says nothing of NCCL between cards): IFT step median {ift[len(ift) // 2]:.1f} ms "
            f"of {[round(x, 1) for x in ift]} (CUDA events, first step with warm-up), unrolled "
            f"{r['steps'][3]['ms']:.1f} ms, staged step {r['staged_step']['ms']:.1f} ms; the "
            f"flat-gradient all-reduce {red['ms_median']:.1f} ms (median of "
            f"{DIST_ALLREDUCE_REPS}) for {red['bytes'] / 1e6:.1f} MB; per IFT step "
            f"{col['all_reduce']} all-reduces ({col['bytes'] / 1e6:.1f} MB), of them "
            f"{col['batchnorm_forward']} BatchNorm forward and as many backward; peak "
            f"{r['peak_gib']:.2f} GiB; bf16 kernels vs plain (reported) worst leaf "
            f"{r['bf16_reported']['leaf_rel']:.3e} in {r['bf16_reported']['worst_leaf']}; "
            f"card {card}")
        check(col["all_reduce"] == 2 * col["batchnorm_forward"] + 3,
              f"rank {r['rank']}: {col} (BatchNorm forward and backward, the gradient, the "
              f"scalars and the NaN vote)")
    launches = {"lm_system": nccl["launches"]["lm_system"] + sum(
        sum(s["launches"]["lm_system"] for s in r["steps"]) + r["staged_step"]["launches"][
            "lm_system"] + r["staged_eval"]["launches"]["lm_system"] + r["shared_lm"]["launches"]
        for r in ranks),
        "nmf": sum(r["staged_eval"]["launches"]["nmf_by_dtype"]["bfloat16"] for r in ranks),
        "nmf_float32": sum(r["staged_eval"]["launches"]["nmf_by_dtype"]["float32"]
                           for r in ranks)}
    seconds = time.perf_counter() - t_start
    log(f"distributed: launches {json.dumps(launches)}; the phase {seconds:.1f} s (the ranks "
        f"{ranks_s:.1f} s, their start included); card {card}")
    shutil.rmtree(work, ignore_errors=True)
    return {"launches": launches, "seconds": seconds, "ranks_s": ranks_s, "nccl": nccl,
            "vfov_dev": vfov_dev, "rp_dev": rp_dev, "worst_leaf": worst,
            "worst_leaf_by_setup": {k: {f: c[f] for f in ("leaf_rel", "worst_leaf", "worst_leaf_l2",
                                                          "worst_leaf_dev_l2")}
                                    for k, c in controls.items()}, "nmf_float32": nmf32,
            "ranks": [{k: r[k] for k in ("rank", "grad_all_reduce", "peak_gib", "store",
                                         "bf16_reported", "kernels_vs_plain_after_4_steps")}
                      | {"step_ms": [s["ms"] for s in r["steps"]],
                         "collectives": r["steps"][0]["collectives"],
                         "staged_step_ms": r["staged_step"]["ms"]} for r in ranks]}


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
    calib_f = geocalib_tpu_torch.GeoCalib(weights=weights, compute_dtype="float32")

    requests, truths = smoke_requests(calib, calib_h, calib_f)
    images, images_d, images_e = (requests[k][1] for k in "ade")
    truth, truth_d, truth_e = (truths[k] for k in "ade")
    log(f"rendered views (roll, pitch, vfov in degrees): {json.dumps(np.round(truth, 3).tolist())}")
    titles = {"a": "a (16 x 480x640, pinhole, bf16)", "b": "b (1 image, pinhole)",
              "c": "c (1 image, simple_radial, focal prior)",
              "d": "d (8 views of one camera, radial, shared intrinsics)",
              "e": "e (4 views, simple_divisional, heuristic init)",
              "f": "f (16 x 480x640, pinhole, float32)"}
    # warm the card, cuDNN and the bases cache at every request's shapes, outside the counted runs
    for cal, imgs, kw in requests.values():
        cal.calibrate(imgs, **kw)

    outs, counts = {}, {}
    for name, (cal, imgs, kw) in requests.items():
        outs[name], counts[name] = serve(cal, titles[name], imgs, **kw)
    launches = {"lm_system": sum(c["lm_system"] for c in counts.values()),
                "nmf": sum(c["nmf_by_dtype"]["bfloat16"] for c in counts.values()),
                "nmf_float32": sum(c["nmf_by_dtype"]["float32"] for c in counts.values())}
    log(f"launches on the serving paths, a to f: {json.dumps(launches)}")
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
    nmf_f32 = nmf_f32_phase(calib_f, images, card)
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
        log(f"nmf kernel stage {stage}: {n}")
    if build.build_log["built"]:
        check(len(nmf_regs) == 12, f"ptxas reported {len(nmf_regs)} of the 12 NMF stages")
        check(not any(spills(n) for n in nmf_regs.values()), "an NMF stage spills")
    nmf_f32["registers"] = {k: v for k, v in nmf_regs.items() if k.startswith("float32")}

    panos, synth_s = gate_panos()
    t0 = time.perf_counter()
    pano_requests, pano_truths = gate_pano_requests(calib, calib_h, panos)
    render_s = time.perf_counter() - t0
    del panos
    log(f"gate views g and h: {len(GATE_PANO_SEEDS)} panoramas of {GATE_PANO_SIZE} "
        f"(synthetic_pano seeds {list(GATE_PANO_SEEDS)}) synthesised on the host in "
        f"{synth_s:.1f} s ({len(GATE_PANO_SEEDS)} threads), 24 crops at 480x640 rendered on the "
        f"card in {render_s:.1f} s (the host copy included); (roll, pitch, vfov) in degrees: "
        + "; ".join(f"{k} {json.dumps(np.round(t, 3).tolist())}" for k, t in pano_truths.items()))
    gate_requests = {**requests, **pano_requests}
    outs_gate = gate_serve(gate_requests)
    with plain_versions():
        refs_gate = gate_serve(gate_requests)
    for k, t in pano_truths.items():
        out = refs_gate["serving"][k]
        err = np.abs(np.degrees(torch.stack([out["gravity"].roll, out["gravity"].pitch,
                                             out["camera"].vfov], -1).reshape(-1, 3).cpu()
                                .numpy()) - np.array(t))
        log(f"gate views, request {k}, the plain path against the rendered truth (reported): "
            f"median roll/pitch/vfov error {np.round(np.median(err, 0), 3).tolist()} deg, max "
            f"{np.round(err.max(0), 3).tolist()} deg")
    t0 = time.perf_counter()
    spread = gate_spread(gate_requests, refs_gate["serving"])
    gate = gate_verdict("kernels", outs_gate, refs_gate, spread)
    check(gate["ok"], f"whole-path gate: {[f['text'] for f in gate['failures']]}")
    gate["known_routes"] = gate_known_routes(gate_requests, refs_gate, spread)
    gate["rule_s"] = time.perf_counter() - t0
    gate["views_s"] = {"synthesis": synth_s, "render": render_s}
    log(f"gate rule's own work (the {len(GATE_CONTROLS)} controls, NMF chunks "
        f"{list(GATE_CHUNKS)}, 3 planted faults; {len(GATE_CONTROLS) + 5 * 2} servings of "
        f"{len(GATE_REQUESTS)} requests): {gate['rule_s']:.1f} s; card {card}")

    evaluation = eval_phase(weights, calib, card)
    train = train_phase(weights, card)
    loop = loop_phase(weights, card)
    generate = generate_phase(calib, card)
    demo = demo_phase(calib, generate["crops"]["openpano_radial_v2"], card)
    baselines = baselines_phase(calib, images, truth, card)
    hub_pose = hub_pose_phase(calib, images, truth, card)
    distributed = distributed_phase(weights, calib, images, card,
                                    train["compare"]["float32 ift"]["kernels"]["leaf_rel"])

    by_model = {m: sum(c["lm_system_by_model"].get(m, 0) for c in counts.values())
                + evaluation["lm_by_model"][m] + generate["launches"]["lm_by_model"].get(m, 0)
                + demo["launches"]["lm_by_model"].get(m, 0)
                + baselines["lm_by_model"].get(m, 0) + hub_pose["lm_by_model"].get(m, 0)
                for m in lm_ops.MODEL_IDS}
    by_model["pinhole"] += (train["launches"]["lm_system"] + loop["launches"]["lm_system"]
                            + distributed["launches"]["lm_system"])
    for model, entry in lm["per_model"].items():
        entry["launches"] = by_model[model]
    paths = lambda name: {"serving a-f": launches[name], "eval": evaluation["launches"][name],
                          "train": train["launches"][name], "loop": loop["launches"][name],
                          "generate": generate["launches"][name], "demo": demo["launches"][name],
                          "baselines": baselines["launches"][name],
                          "hub_pose": hub_pose["launches"][name],
                          "distributed": distributed["launches"][name]}
    cost_only = lm.pop("cost_only")
    kernels = [
        {"name": "lm_system", "route": "cuda", "source": "geocalib_tpu_torch/csrc/lm_system.cu",
         "replaces": "geocalib_tpu/ops/lm_kernel.py:195",
         "launches": sum(paths("lm_system").values()),
         "launches_by_path": paths("lm_system"), **lm,
         "eval_shape": {k.split()[1]: v for k, v in evaluation["at_shape"].items() if " " in k},
         "vjp": {**train["vjp"], "replaces": "geocalib_tpu/ops/lm_kernel.py:221-249"}},
        {"name": "lm_system_cost_only", "route": "cuda",
         "source": "geocalib_tpu_torch/csrc/lm_system.cu",
         "replaces": "geocalib_tpu/ops/lm_kernel.py:195", "instance": "with_system=False",
         "launches_by_path": {"lm phase": cost_only["launches"]}, **cost_only},
        {"name": "nmf", "route": "cuda", "source": "geocalib_tpu_torch/csrc/nmf.cu",
         "replaces": "geocalib_tpu/ops/nmf_kernel.py:86", "launches": sum(paths("nmf").values()),
         "launches_by_path": paths("nmf"), **nmf, "eval_shape": evaluation["at_shape"]["nmf"]},
        {"name": "nmf_float32", "route": "cuda", "source": "geocalib_tpu_torch/csrc/nmf.cu",
         "replaces": "geocalib_tpu/ops/nmf_kernel.py:86", "instance": "float32",
         "tensor_cores": "mma.sync m16n8k8 TF32, three products",
         "launches": launches["nmf_float32"] + distributed["launches"]["nmf_float32"],
         "launches_by_path": {"serving a-f": launches["nmf_float32"],
                              "distributed": distributed["launches"]["nmf_float32"]},
         **{k: nmf_f32[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "fma_bound_ms", "shape", "rel",
                                    "tf32_control_rel", "registers")},
         "eval_window": {k: distributed["nmf_float32"][k] for k in (
             "shape", "rel", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "fma_bound_ms")}},
    ]
    train_line = {k: train[k] for k in ("ift_step_ms", "unroll_step_ms", "step_ms", "peak_gib",
                                        "lm_kernel_ms_per_step", "device_kernel_ms_per_step",
                                        "lm_share", "compute_grads_ms", "optimizer_ms", "compare")}
    log(json.dumps({"gate": {**gate, "spread_max_deg": {k: v["spread"].max(0).tolist()
                                                        for k, v in spread.items()}},
                    "card": card}, default=str))
    log(json.dumps({"eval": {k: v for k, v in evaluation.items()
                             if k not in ("lm_by_model", "at_shape")},
                    "card": card}, default=str))
    log(json.dumps({"train": train_line, "card": card}, default=str))
    log(json.dumps({"loop": loop, "card": card}, default=str))
    log(json.dumps({"generate": {k: v for k, v in generate.items() if k != "crops"},
                    "demo": demo, "card": card}, default=str))
    log(json.dumps({"baselines": baselines, "card": card}, default=str))
    log(json.dumps({"hub_pose": hub_pose, "card": card}, default=str))
    log(json.dumps({"distributed": distributed, "card": card}, default=str))
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
