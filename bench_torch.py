#!/usr/bin/env python3
"""Stage-isolated benchmark of the PyTorch port (geocalib_tpu_torch) on one card.

Prints one JSON line: images/s through the serving computation (MSCAN-B and
both LightHam heads in bf16, then the float32 LM with ``LMConfig()``'s
defaults: 30 steps, early stop, huber loss) at batch 16 of 320x320 images
made on the card, as the median and spread of REPEATS timed runs of N_ITERS
batches each after warm-up; the training step's images/s at batch 24
(MSCAN-B, bf16, 10 LM steps, IFT gradients, AdamW) on a synthetic batch of
random GT cameras and their rendered fields; the host loader's images/s
(PrefetchLoader with the "identity" and "geocalib" augmentations) when a
dataset directory with a train.csv is present, else nothing for that stage;
each kernel's largest deviation from its plain version; FLOPs, achieved
TFLOP/s and MFU against the H100 SXM's dense bf16 peak of 989 TFLOP/s; and
the card's name and power limit (nvidia-smi).

FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` over one
batch of the timed work: for serving with the kernels' plain versions in
place (the same math), so that the NMF's products count, which the kernel,
called through ctypes, would hide; the LM's per-pixel arithmetic is
elementwise and FlopCounterMode counts no elementwise operation, so the
count is a floor.

Each stage runs in a subprocess of its own, so that one stage's memory and
libraries cannot disturb the next; the orchestrator merges their JSON lines.
The stages share chip_smoke.py's helpers (the plain-version switch, the
card's name).
There is no fallback: a stage that fails raises, and the orchestrator exits
non-zero. ``vs_baseline`` is left out: its base was a CPU rate of the
original implementation, which this machine cannot measure.

    python3 bench_torch.py              # all stages, one JSON line
    python3 bench_torch.py --stage calibrate
"""

import json
import os
import subprocess
import sys
import time

B, H, W = 16, 320, 320
TRAIN_B = 24
N_ITERS = 10  # batches per timed run
REPEATS = 7   # timed runs, after warm-up
PEAK_BF16_TFLOPS = 989.0  # H100 SXM, dense bf16 (NVIDIA data sheet)
PARITY_TOL = 5e-4  # radians: roll, pitch and vFoV of the LM with kernels against plain
ROOT = os.path.dirname(os.path.abspath(__file__))


def spread(values) -> dict:
    import numpy as np

    v = np.asarray(values, np.float64)
    return {"median": float(np.median(v)), "q1": float(np.quantile(v, 0.25)),
            "q3": float(np.quantile(v, 0.75)), "min": float(v.min()), "max": float(v.max()),
            "n": int(v.size)}


def _cuda():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("bench_torch: no CUDA card; the benchmark runs only on the card")
    return torch.device("cuda")


def lm_parity(camera_model: str, dev) -> float:
    """Largest |roll, pitch, vFoV| difference (radians) of the LM run with the kernel
    and with its plain version, on random fields (4, 64, 64); raises beyond PARITY_TOL."""
    import torch

    from chip_smoke import plain_versions
    from geocalib_tpu_torch.optim.lm import LMConfig, run_lm

    gen = torch.Generator(device=dev).manual_seed(7)
    data = {"up_field": torch.rand((4, 64, 64, 2), generator=gen, device=dev) - 0.5,
            "latitude_field": torch.rand((4, 64, 64, 1), generator=gen, device=dev) - 0.5}
    cfg = LMConfig(camera_model=camera_model)
    a = run_lm(dict(data), cfg)
    with plain_versions():
        b = run_lm(dict(data), cfg)
    dev_ = max(float((a.gravity.rp - b.gravity.rp).abs().max()),
               float((a.camera.vfov - b.camera.vfov).abs().max()))
    if not dev_ < PARITY_TOL:
        raise RuntimeError(f"LM kernel ({camera_model}) deviates from its plain version by {dev_}")
    return dev_


def stage_calibrate() -> dict:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from chip_smoke import card_name, plain_versions
    from geocalib_tpu_torch.models.geocalib_net import GeoCalibNet
    from geocalib_tpu_torch.ops import nmf as nmf_ops
    from geocalib_tpu_torch.optim.lm import LMConfig, run_lm

    dev = _cuda()
    torch.manual_seed(0)
    net = GeoCalibNet("b").eval().to(device=dev, dtype=torch.bfloat16)
    cfg = LMConfig()
    gen = torch.Generator(device=dev).manual_seed(42)
    images = [torch.rand((B, H, W, 3), generator=gen, device=dev, dtype=torch.bfloat16)
              for _ in range(N_ITERS)]

    @torch.inference_mode()
    def fwd(image):
        fields = {k: v.float() for k, v in net(image).items()}
        res = run_lm(fields, cfg)
        return res.gravity.rp, res.camera.vfov

    for image in images[:2]:  # warm-up: cuDNN, the allocator, the bases cache
        fwd(image)
    torch.cuda.synchronize()
    rates = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        outs = [fwd(image) for image in images]
        torch.cuda.synchronize()
        rates.append(B * N_ITERS / (time.perf_counter() - t0))
        del outs
    out = {"calibrate_images_per_s": spread(rates)}

    with torch.inference_mode():
        tokens = net.front(images[0])[3:]
        kern = nmf_ops.nmf(*tokens, 7, 1.0, 1e-6)
        plain = nmf_ops.nmf_plain(*tokens, 7, 1.0, 1e-6)
        rk, rp = (torch.matmul(*x).float() for x in (kern, plain))
        out["kernel_parity_nmf_rel_dev"] = float(torch.linalg.norm(rk - rp) / torch.linalg.norm(rp))
        out["kernel_parity_max_dev"] = lm_parity("pinhole", dev)
        out["kernel_parity_radial_max_dev"] = lm_parity("simple_radial", dev)

    counter = FlopCounterMode(display=False)
    with plain_versions(), counter:
        fwd(images[0])
    flops = counter.get_total_flops()
    seconds = B / out["calibrate_images_per_s"]["median"]
    out["serve_gflops_per_image"] = flops / B / 1e9
    out["serve_tflops_achieved"] = flops / seconds / 1e12
    out["serve_mfu"] = out["serve_tflops_achieved"] / PEAK_BF16_TFLOPS
    out["card"] = card_name()
    out["torch"] = torch.__version__
    return out


def synthetic_batch(n: int, h: int, w: int, dev, model: str = "pinhole") -> dict:
    """Random GT cameras and gravities, their rendered fields, and a random image:
    the port's counterpart of __graft_entry__._synthetic_batch."""
    import numpy as np
    import torch

    from geocalib_tpu_torch.geometry.camera import Camera
    from geocalib_tpu_torch.geometry.gravity import Gravity
    from geocalib_tpu_torch.geometry.perspective_fields import get_perspective_field

    rng = np.random.default_rng(0)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    cam = Camera.from_dict({"height": f32(np.full(n, float(h))), "width": f32(np.full(n, float(w))),
                            "vfov": f32(rng.uniform(0.6, 1.4, n))}, model=model)
    grav = Gravity.from_rp(f32(rng.uniform(-0.5, 0.5, n)), f32(rng.uniform(-0.5, 0.5, n)))
    up, lat = get_perspective_field(cam, grav, h, w)
    return {"image": f32(rng.uniform(0, 1, (n, h, w, 3))), "up_field": up,
            "latitude_field": lat, "camera": cam, "gravity": grav}


def stage_train() -> dict:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from geocalib_tpu_torch.training.train_step import TrainConfig, create_train_state, train_step

    dev = _cuda()
    cfg = TrainConfig()
    net, state = create_train_state(cfg, seed=0, device=dev)
    batch = synthetic_batch(TRAIN_B, H, W, dev)
    for i in range(3):  # warm-up
        state, out = train_step(net, cfg, state, batch, (1, i))
        float(out["loss/total"])
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for i in range(REPEATS):
        t0 = time.perf_counter()
        state, out = train_step(net, cfg, state, batch, (2, i))
        float(out["loss/total"])  # a host fetch: the step has ended
        rates.append(TRAIN_B / (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 2**30
    counter = FlopCounterMode(display=False)
    with counter:
        state, out = train_step(net, cfg, state, batch, (3, 0))
        float(out["loss/total"])
    flops = counter.get_total_flops()
    seconds = TRAIN_B / spread(rates)["median"]
    return {"train_images_per_s": spread(rates), "train_step_ms": seconds * 1e3,
            "train_peak_gib": peak, "train_gflops_per_image": flops / TRAIN_B / 1e9,
            "train_tflops_achieved": flops / seconds / 1e12,
            "train_mfu": flops / seconds / 1e12 / PEAK_BF16_TFLOPS}


def _dataset_dir():
    """The first of the repo's generated sets whose train.csv and first image exist."""
    import csv

    for name in ("openpano_synth_v2", "openpano_synth"):
        path = os.path.join(ROOT, "data", name)
        if os.path.exists(os.path.join(path, "train.csv")):
            with open(os.path.join(path, "train.csv")) as fh:
                first = next(csv.DictReader(fh), None)
            if first and os.path.exists(os.path.join(path, "images", first["fname"])):
                return path
    return None


def stage_loader() -> dict:
    """Host loader images/s on a dataset directory of the repo, when one exists."""
    ds_dir = _dataset_dir()
    if ds_dir is None:
        return {}
    from geocalib_tpu_torch.data.dataset import DatasetConf, PrefetchLoader, SimpleDataset

    def rate(augmentation: str, n_batches: int) -> float:
        ds = SimpleDataset(DatasetConf(dataset_dir=ds_dir, csv_name="train.csv",
                                       batch_size=TRAIN_B, augmentation=augmentation))
        it = PrefetchLoader(ds).epoch(epoch=0)
        next(it)  # warm the workers before the clock starts
        seen, t0 = 0, time.perf_counter()
        for i, batch in enumerate(it):
            if i >= n_batches:
                break
            seen += len(batch["image"])
        it.close()
        return seen / (time.perf_counter() - t0)

    # "identity" is what training runs with augmentation="device"
    return {"loader_images_per_s": rate("identity", 12),
            "loader_host_aug_images_per_s": rate("geocalib", 6),
            "loader_dataset": os.path.relpath(ds_dir, ROOT)}


STAGES = {"calibrate": stage_calibrate, "train": stage_train, "loader": stage_loader}


def run_stage(name: str, timeout_s: int = 1200) -> dict:
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--stage", name],
                          capture_output=True, text=True, timeout=timeout_s)
    sys.stderr.write(proc.stderr[-4000:])
    lines = [line for line in proc.stdout.strip().splitlines() if line.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"stage {name} failed (exit {proc.returncode})")
    return json.loads(lines[-1])


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--stage":
        print(json.dumps(STAGES[sys.argv[2]]()), flush=True)
        return 0
    merged = {}
    for name in STAGES:
        merged.update(run_stage(name))
    print(json.dumps({"metric": "calibrate_images_per_s",
                      "value": merged["calibrate_images_per_s"]["median"], "unit": "images/s",
                      "batch": B, **merged}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
