#!/usr/bin/env python3
"""The port's LM normal equations against the JAX package's, in float32 ulps.

On the CPU, for each camera model, builds the fixture of
tests/test_torch_lm.py::test_run_lm_matches_jax (B = 4 lanes of 24 x 32
fields from numpy.random.default_rng(0)), takes the solver's initial
estimate (get_trivial_estimation in both packages) and compares, bit for
bit, the port's lm_system_plain with the JAX solver's own path on the CPU
(_residuals, _costs_and_weights, build_system). It prints, per model, in how
many lanes the cost differs and by how many ulps at most, and how many
entries of G and H differ.

Needs JAX and the JAX package, so it runs where the tests run, not on the
machine with the card:

    JAX_PLATFORMS=cpu python3 tools/lm_jax_ulps.py
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from geocalib_tpu.geometry.camera import Camera as JCamera  # noqa: E402
from geocalib_tpu.geometry.gravity import Gravity as JGravity  # noqa: E402
from geocalib_tpu.geometry.perspective_fields import get_perspective_field  # noqa: E402
from geocalib_tpu.optim import lm as jlm  # noqa: E402
from geocalib_tpu_torch.geometry.camera import Camera  # noqa: E402
from geocalib_tpu_torch.geometry.gravity import Gravity  # noqa: E402
from geocalib_tpu_torch.ops.lm_system import lm_system_plain  # noqa: E402
from geocalib_tpu_torch.optim.lm import LMConfig  # noqa: E402

MODELS = ["pinhole", "simple_radial", "radial", "simple_divisional"]


def fixture(model: str, B: int = 4, h: int = 24, w: int = 32) -> dict:
    """The fields of tests/test_torch_lm.py::_setup, with confidences."""
    rng = np.random.default_rng(0)
    k1 = rng.uniform(-0.2, 0.0, (B,)) if model != "pinhole" else np.zeros(B)
    k2 = np.random.default_rng(1).uniform(-0.1, 0.1, B) if model == "radial" else np.zeros(B)
    cam = JCamera.from_dict({"height": jnp.full((B,), float(h)), "width": jnp.full((B,), float(w)),
                             "vfov": jnp.asarray(rng.uniform(0.6, 1.4, (B,)), jnp.float32),
                             "k1": jnp.asarray(k1, jnp.float32),
                             "k2": jnp.asarray(k2, jnp.float32)}, model=model)
    grav = JGravity.from_rp(jnp.asarray(rng.uniform(-0.4, 0.4, (B,)), jnp.float32),
                            jnp.asarray(rng.uniform(-0.4, 0.4, (B,)), jnp.float32))
    up, lat = get_perspective_field(cam, grav, h, w)
    return {"up_field": np.asarray(up + 0.05 * rng.normal(size=up.shape).astype(np.float32)),
            "latitude_field": np.asarray(lat + 0.05 * rng.normal(size=lat.shape).astype(np.float32)),
            "up_confidence": rng.uniform(0.2, 1.0, (B, h, w)).astype(np.float32),
            "latitude_confidence": rng.uniform(0.2, 1.0, (B, h, w)).astype(np.float32)}


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 ulps (ordered integer representation)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def compare(model: str) -> dict:
    data = {k: jnp.asarray(v) for k, v in fixture(model).items()}
    jcfg = jlm.resolve_priors(data, jlm.LMConfig(camera_model=model))
    obs, h, w = jlm.flatten_observations(data, jcfg)
    jcam, jgrav = jlm.get_trivial_estimation(data, jcfg)
    r_up, r_lat = jlm._residuals(jcam, jgrav, obs, h, w)
    cost, w_up, w_lat = jlm._costs_and_weights(r_up, r_lat, obs, jcfg)
    G, H = jlm.build_system(jcam, jgrav, r_up, r_lat, w_up, w_lat, h, w, jcfg)

    tobs = {k: torch.from_numpy(np.array(v)) for k, v in obs._asdict().items() if v is not None}
    tcam = Camera.from_data(torch.from_numpy(np.array(jcam.data)), model)
    tgrav = Gravity(torch.from_numpy(np.array(jgrav.vec3d)))
    tG, tH, tcost = lm_system_plain(tobs, tcam, tgrav, h, w, LMConfig(camera_model=model))
    du = ulps(tcost.numpy(), np.asarray(cost))
    return {"cost_lanes_differing": int((du > 0).sum()), "cost_max_ulps": int(du.max()),
            "G_entries_differing": int((tG.numpy() != np.asarray(G)).sum()),
            "H_entries_differing": int((tH.numpy() != np.asarray(H)).sum()),
            "G_entries": int(tG.numel()), "H_entries": int(tH.numel())}


def main() -> int:
    result = {model: compare(model) for model in MODELS}
    for model, r in result.items():
        print(f"{model}: cost differs in {r['cost_lanes_differing']} of 4 lanes, by at most "
              f"{r['cost_max_ulps']} ulps; G differs in {r['G_entries_differing']} of "
              f"{r['G_entries']} entries, H in {r['H_entries_differing']} of {r['H_entries']}",
              flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
