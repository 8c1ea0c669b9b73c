#!/usr/bin/env python3
"""Which CUDA kernel moves the port's calibrate answers away from the plain path.

Serves request a of chip_smoke.py (16 images at 480x640, pinhole, bf16
network, weights/geocalib_synth_r05.msgpack) through geocalib_tpu_torch on
one card, by four routes: both kernels, both plain PyTorch versions, the LM
kernel alone (NMF plain) and the NMF kernel alone (LM plain). It does so on
two image sets made from numpy.random.default_rng(0):

- "flat": flat drawings of a tilted horizon, sky, ground and boxes, with no
  perspective to fix the focal length;
- "rendered": chip_smoke.py's pinhole renderings of a checkered ground plane.

For each set and route it prints, lane by lane, vFoV, roll, pitch, stop_at,
the final cost and the solver's vFoV uncertainty, then each route's largest
deviation from the plain route, the lanes whose stop_at differs from it, and
how far the network's fields move when only the NMF kernel is swapped in.
The kernel route is served twice to show that it is deterministic.

Run from the repository root, on a machine with one card:

    python3 tools/torch_path_witness.py
"""

import faulthandler
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
import geocalib_tpu_torch  # noqa: E402
from geocalib_tpu_torch.models.weights import params_from_jax, read_flax_msgpack  # noqa: E402

ROUTES = {  # name -> (LM plain, NMF plain)
    "kernels": (False, False),
    "plain": (True, True),
    "lm kernel only": (False, True),
    "nmf kernel only": (True, False),
}
WATCHDOG_S = 600  # the run takes about 40 s on one H100; a hang ends here


def flat_scenes(rng: np.random.Generator, n: int, h: int, w: int) -> np.ndarray:
    """Street-like drawings: a tilted horizon, sky and ground, boxes, noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((n, h, w, 3), np.float32)
    for i in range(n):
        roll = rng.uniform(-0.35, 0.35)
        horizon = h * rng.uniform(0.3, 0.7)
        d = (yy - horizon) * math.cos(roll) - (xx - w / 2) * math.sin(roll)
        sky = rng.uniform(0.5, 0.95, 3) * (1.0 - 0.3 * yy / h)[..., None]
        ground = rng.uniform(0.1, 0.45, 3) * (0.7 + 0.3 * yy / h)[..., None]
        img = np.where(d[..., None] < 0, sky, ground)
        for _ in range(12):
            x0, bw = rng.integers(0, w - 40), rng.integers(20, 120)
            y1 = int(horizon + rng.integers(-20, 40))
            y0 = max(0, y1 - int(rng.integers(40, 200)))
            img[y0:y1, x0 : x0 + bw] = rng.uniform(0.2, 0.8, 3)
        out[i] = np.clip(img + rng.normal(0.0, 0.02, img.shape), 0.0, 1.0)
    return out


def lanes(out: dict) -> dict:
    deg = lambda t: np.degrees(t.reshape(-1).cpu().numpy().astype(np.float64))
    return {"vfov": deg(out["camera"].vfov), "roll": deg(out["gravity"].roll),
            "pitch": deg(out["gravity"].pitch),
            "stop_at": out["stop_at"].reshape(-1).cpu().numpy().astype(int),
            "final_cost": out["final_cost"].reshape(-1).cpu().numpy().astype(np.float64),
            "vfov_unc": deg(out["vfov_uncertainty"])}


def serve(calib, images: np.ndarray, lm_plain: bool, nmf_plain: bool) -> dict:
    with smoke.plain_versions(lm=lm_plain, nmf=nmf_plain):
        return calib.calibrate(images, batched=True)


def fields(calib, images: np.ndarray, nmf_plain: bool) -> dict:
    crop = calib.preprocessor(torch.from_numpy(images).to(calib.device))["image"]
    with smoke.plain_versions(lm=False, nmf=nmf_plain), torch.inference_mode():
        return {k: v.float() for k, v in calib.net(crop.to(calib.compute_dtype)).items()}


def witness(calib, name: str, images: np.ndarray) -> dict:
    smoke.log(f"== {name} images")
    res = {route: lanes(serve(calib, images, *flags)) for route, flags in ROUTES.items()}
    again = lanes(serve(calib, images, *ROUTES["kernels"]))
    same = all(np.array_equal(again[k], res["kernels"][k]) for k in again)
    smoke.log(f"kernel route served twice: bitwise equal = {same}")
    for route, r in res.items():
        smoke.log(f"{route}:")
        for k in ("vfov", "roll", "pitch", "stop_at", "final_cost", "vfov_unc"):
            smoke.log(f"  {k:10s} {np.array2string(r[k], precision=4, max_line_width=400)}")
    ref = res["plain"]
    summary = {}
    for route, r in res.items():
        if route == "plain":
            continue
        dev = {k: float(np.abs(r[k] - ref[k]).max()) for k in ("vfov", "roll", "pitch")}
        worst = int(np.argmax(np.abs(r["vfov"] - ref["vfov"])))
        flips = [int(i) for i in np.nonzero(r["stop_at"] != ref["stop_at"])[0]]
        summary[route] = {"max_dev_deg": dev, "worst_vfov_lane": worst,
                          "worst_lane_vfov_unc_deg": float(ref["vfov_unc"][worst]),
                          "stop_at_differs_in_lanes": flips}
        smoke.log(f"{route} vs plain: {json.dumps(summary[route])}")
    fk, fp = fields(calib, images, False), fields(calib, images, True)
    for k in fk:
        smoke.log(f"field {k}: NMF kernel vs plain, max abs difference "
                  f"{float((fk[k] - fp[k]).abs().max()):.4e}")
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_path_witness: no CUDA card", file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    smoke.log(f"card: {smoke.card_name()}")
    weights = params_from_jax(read_flax_msgpack(smoke.WEIGHTS), "b")
    calib = geocalib_tpu_torch.GeoCalib(weights=weights, compute_dtype="bfloat16")
    sets = {"flat": flat_scenes(np.random.default_rng(0), 16, 480, 640),
            "rendered": smoke.smoke_requests(calib, calib)[0]["a"][1]}
    calib.calibrate(sets["flat"], batched=True)  # warm up
    result = {name: witness(calib, name, images) for name, images in sets.items()}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
