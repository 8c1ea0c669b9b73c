#!/usr/bin/env python3
"""The port's LM against the JAX package's, in float32 ulps, eager and compiled.

On the CPU, for each camera model, builds the fixture of
tests/test_torch_lm.py::test_run_lm_matches_jax (B = 4 lanes of 24 x 32
fields from numpy.random.default_rng(0)) and compares at the solver's
initial estimate (get_trivial_estimation in both packages):

- eager: the port's lm_system_plain against the JAX solver's functions run
  op by op (_residuals, _costs_and_weights, build_system): lanes whose cost
  differs and by how many ulps, entries of G and H that differ;
- compiled: the latitude residual planes against the same functions inside
  ``lax.scan`` as ``run_lm`` compiles them, for the port's residual
  (``lat_sin - sinlat_planes``) and for this tool's copy of XLA's x86
  arithmetic (``compiled_residual``: the ``vrsqrtps`` estimate and two
  Newton steps for ``1 / sqrt``, LLVM's fused multiply-adds): pixels apart;
- host: whether the copy holds on this CPU, its rsqrt against
  ``jax.jit(lax.rsqrt)`` and its fused multiply-add against the jitted
  ``a * b + c``, on samples (every fourth float32 of [1, 4) and sums a hair
  off a float32 tie). The estimate's table is the CPU's: on another vendor's
  CPU, or under AVX-512's ``vrsqrt14ps``, the copy may not hold, and then
  neither do its pixel counts.

Then, with ``--trajectories``, each case of test_run_lm_matches_jax (four
models x no prior, focal, gravity) runs the whole solver in both packages,
the port once as it is and once with the copied residual in its plain LM
(``compiled``): the JAX solver's state after each iteration is read from its
scan (the body is wrapped to return the state it already carries), and the
tool prints per case whether stop_at and the estimate agree as the test
requires, the largest distance in ulps of the focal after the first step and
the first iteration where a lane's cost is more than 4 ulps from JAX's.

The copy lives here and nowhere in the port: the port's LM computes the
source's arithmetic, and the bits of the JAX solver's compiled step depend on
the CPU it runs on.

Needs JAX and the JAX package, so it runs where the tests run, not on the
machine with the card:

    JAX_PLATFORMS=cpu python3 tools/lm_jax_ulps.py [--trajectories]
"""

import argparse
import inspect
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from geocalib_tpu.geometry.camera import Camera as JCamera  # noqa: E402
from geocalib_tpu.geometry.gravity import Gravity as JGravity  # noqa: E402
from geocalib_tpu.geometry.perspective_fields import get_perspective_field  # noqa: E402
from geocalib_tpu.optim import lm as jlm  # noqa: E402
from geocalib_tpu_torch.geometry import planar_fields as pf  # noqa: E402
from geocalib_tpu_torch.geometry.camera import Camera  # noqa: E402
from geocalib_tpu_torch.geometry.gravity import Gravity  # noqa: E402
from geocalib_tpu_torch.ops import lm_system as tls  # noqa: E402
from geocalib_tpu_torch.optim import lm as tlm  # noqa: E402
from geocalib_tpu_torch.ops.lm_system import lm_system_plain  # noqa: E402
from geocalib_tpu_torch.optim.lm import LMConfig  # noqa: E402

MODELS = ["pinhole", "simple_radial", "radial", "simple_divisional"]
PRIORS = [None, "focal", "gravity"]


def fixture(model: str, B: int = 4, h: int = 24, w: int = 32, prior=None) -> dict:
    """The fields of tests/test_torch_lm.py::_setup, with confidences and the
    priors of test_run_lm_matches_jax."""
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
    data = {"up_field": np.asarray(up + 0.05 * rng.normal(size=up.shape).astype(np.float32)),
            "latitude_field": np.asarray(lat + 0.05 * rng.normal(size=lat.shape).astype(np.float32)),
            "up_confidence": rng.uniform(0.2, 1.0, (B, h, w)).astype(np.float32),
            "latitude_confidence": rng.uniform(0.2, 1.0, (B, h, w)).astype(np.float32)}
    if prior == "focal":
        data["prior_focal"] = np.full(B, 30.0, np.float32)
    if prior == "gravity":
        data["prior_gravity"] = np.asarray(JGravity.from_rp(jnp.full(B, 0.1), jnp.full(B, -0.2)).vec3d)
    return data


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 ulps (ordered integer representation)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def _initial(model: str, prior=None):
    data = {k: jnp.asarray(v) for k, v in fixture(model, prior=prior).items()}
    jcfg = jlm.resolve_priors(data, jlm.LMConfig(camera_model=model))
    obs, h, w = jlm.flatten_observations(data, jcfg)
    jcam, jgrav = jlm.get_trivial_estimation(data, jcfg)
    tobs = {k: torch.from_numpy(np.array(v)) for k, v in obs._asdict().items() if v is not None}
    tcam = Camera.from_data(torch.from_numpy(np.array(jcam.data)), model)
    tgrav = Gravity(torch.from_numpy(np.array(jgrav.vec3d)))
    return jcfg, obs, h, w, jcam, jgrav, tobs, tcam, tgrav


def _fma(a, b, c) -> torch.Tensor:
    """a·b + c rounded once to float32, as a fused multiply-add does.

    The product of two float32 values is exact in float64, so the sum rounded to
    float64, then to float32, is the fused result unless the float64 sum lands on
    a float32 tie that the exact sum is not. There the sum is rounded to odd
    instead, from its exact error (TwoSum), so that the one rounding to float32
    that follows is the right one.
    """
    p = a.double() * b  # float64 times float32 promotes: exact
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)  # exact: s + err = p + c
    bits = s.view(torch.int64)
    tie = (bits & 0x1FFFFFFF) == 0x10000000  # the 29 bits float32 drops: exactly one half
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(tie & (err != 0), bits + step, bits).view(torch.float64).float()


def _rsqrt_estimate(x: torch.Tensor) -> torch.Tensor:
    """The ``rsqrtps`` estimate of 1/√x for a normal x > 0, as read off an Intel
    CPU: 1/√ of the middle of x's interval of 10 leading mantissa bits (and
    exponent parity), rounded to 13 significant bits, scaled by x's power of four."""
    bits = x.view(torch.int32)
    e = (bits >> 23) - 127
    odd = e & 1
    mid = (1.0 + (((bits >> 13) & 0x3FF).double() + 0.5) / 1024.0) * (1 + odd).double()
    y = torch.round(8192.0 / torch.sqrt(mid)) / 8192.0
    scale = ((1023 - (e - odd) // 2).long() << 52).view(torch.float64)
    return (y * scale).float()


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1/√x as XLA compiles ``1 / sqrt(x)`` on an x86 CPU: the ``rsqrtps``
    estimate, then two Newton steps y ← y + (−y/2)·(x·y·y − 1) with fused
    multiply-adds. Zero, subnormal, infinite, negative and NaN inputs take
    torch's rsqrt."""
    y = _rsqrt_estimate(x)
    for _ in range(2):
        y = _fma(y * -0.5, _fma(x * y, y, -1.0), y)
    normal = (x >= torch.finfo(torch.float32).tiny) & (x <= torch.finfo(torch.float32).max)
    return torch.where(normal, y, torch.rsqrt(x))


def _bearing_compiled(camera, gravity, u, v):
    """(gravity · w, |w|²) for the bearing w = (ud, vd, 1), with the products that
    XLA's CPU backend fuses into multiply-adds fused here too."""
    a, b, cg = pf._gravity_planes(gravity)
    k1, k2 = pf._k_planes(camera)
    r2 = _fma(u, u, v * v)
    if camera.model == "simple_radial":
        su = _fma(-k1, r2, 1.0)
    elif camera.model == "radial":
        su = _fma(r2, _fma(_fma(k1 * k1, 3.0, -k2), r2, -k1), 1.0)
    elif camera.model == "simple_divisional":
        denom = _fma(k1, r2, 1.0)
        su = 1.0 / torch.where(denom == 0, 1e6, denom)
    else:
        su = None
    ud, vd = (u, v) if su is None else (su * u, su * v)
    return _fma(ud, a, b * vd) + cg, _fma(ud, ud, vd * vd) + 1.0


def compiled_residual(camera, gravity, u, v, lat_sin):
    """The latitude residual lat_sin − sin(latitude) with the bits of the JAX LM's
    compiled step on an x86 CPU with Intel's estimate table: XLA's rsqrt, its
    fused multiply-adds, and the product by the rsqrt and the subtraction as one
    fused multiply-add. Values only."""
    with torch.no_grad():
        gw, sq = _bearing_compiled(camera, gravity, u, v)
        return _fma(-gw, _rsqrt(sq), lat_sin)


def _plain_residual(camera, gravity, u, v, lat_sin):
    """The latitude residual as the port computes it (the JAX source's formula)."""
    return lat_sin - pf.sinlat_planes(camera, gravity, u, v)


_RESIDUAL_LINE = 'r_lat = obs["lat_sin"] - pf.sinlat_planes(camera, gravity, u, v)'


def _lm_system_plain_compiled():
    """The port's ``lm_system_plain`` with its latitude residual replaced by
    ``compiled_residual`` (from its own source, so nothing else differs)."""
    src = inspect.getsource(tls.lm_system_plain)
    if _RESIDUAL_LINE not in src:
        raise RuntimeError("lm_system_plain no longer forms the residual as this tool expects")
    ns = dict(vars(tls), compiled_residual=compiled_residual)
    exec(src.replace(_RESIDUAL_LINE,
                     'r_lat = compiled_residual(camera, gravity, u, v, obs["lat_sin"])'), ns)
    return ns["lm_system_plain"]


def host_check() -> dict:
    """Whether the copy holds on this CPU: values where ``_rsqrt`` and ``_fma``
    differ from XLA's jitted rsqrt and a·b + c."""
    rng = np.random.default_rng(0)
    xs = [(np.arange(0, 1 << 24, 4, dtype=np.uint32) + 0x3F800000).view(np.float32)]
    for lo, hi in [(2.0**-30, 1.0), (4.0, 2.0**40)]:
        xs.append(np.exp(rng.uniform(np.log(lo), np.log(hi), 1 << 18)).astype(np.float32))
    x = np.concatenate(xs)
    want = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(x)))
    rsqrt_apart = int((_rsqrt(torch.from_numpy(x)).numpy() != want).sum())
    # products 2 + δ with 0 < |δ| < 2⁻²⁸ plus c = 2²⁵ lie a hair off a float32
    # tie, where rounding twice (to float64, then float32) goes wrong
    base = np.float32(np.sqrt(2.0)).view(np.int32)
    a = (base + np.arange(-20000, 20000, dtype=np.int32)).view(np.float32)
    b = (np.float32(2.0) / a).view(np.int32)[:, None] + np.arange(-2, 3, dtype=np.int32)
    a, b = np.broadcast_to(a[:, None], b.shape).ravel(), b.view(np.float32).ravel()
    d = a.astype(np.float64) * b.astype(np.float64) - 2.0
    keep = (d != 0) & (np.abs(d) < 2.0**-28)
    a = np.concatenate([rng.normal(size=4096).astype(np.float32), a[keep]])
    b = np.concatenate([rng.normal(size=4096).astype(np.float32), b[keep]])
    c = np.concatenate([rng.normal(size=4096).astype(np.float32),
                        np.full(int(keep.sum()), 2.0**25, np.float32)])
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    got = _fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    return {"rsqrt_values": int(x.size), "rsqrt_apart": rsqrt_apart,
            "fma_values": int(a.size), "fma_apart": int((got != want).sum())}


def compare(model: str) -> dict:
    jcfg, obs, h, w, jcam, jgrav, tobs, tcam, tgrav = _initial(model)
    r_up, r_lat = jlm._residuals(jcam, jgrav, obs, h, w)
    cost, w_up, w_lat = jlm._costs_and_weights(r_up, r_lat, obs, jcfg)
    G, H = jlm.build_system(jcam, jgrav, r_up, r_lat, w_up, w_lat, h, w, jcfg)
    tG, tH, tcost = lm_system_plain(tobs, tcam, tgrav, h, w, LMConfig(camera_model=model))
    du = ulps(tcost.numpy(), np.asarray(cost))

    def step(carry, _):
        cam, grav = carry
        return carry, jlm._residuals(cam, grav, obs, h, w)[1]

    _, scan_lat = jax.jit(lambda c: jax.lax.scan(step, c, None, length=1))((jcam, jgrav))
    scan_lat = np.asarray(scan_lat[0])
    u, v = pf.make_grid(tcam, h, w)
    apart = {}
    for name, residual in (("port", _plain_residual), ("copy", compiled_residual)):
        r = residual(tcam, tgrav, u, v, tobs["lat_sin"]).numpy()
        apart[name] = int((r != scan_lat).sum())
    return {"cost_lanes_differing": int((du > 0).sum()), "cost_max_ulps": int(du.max()),
            "G_entries_differing": int((tG.numpy() != np.asarray(G)).sum()),
            "H_entries_differing": int((tH.numpy() != np.asarray(H)).sum()),
            "G_entries": int(tG.numel()), "H_entries": int(tH.numel()),
            "lat_residual_pixels_apart_from_compiled": apart, "pixels": int(scan_lat.size)}


def _jax_states(model: str, prior):
    """The JAX solver's (cost, camera data) after each iteration of its scan."""
    jcfg, obs, h, w, jcam, jgrav, *_ = _initial(model, prior)
    held, scan = {}, jax.lax.scan

    def spy(body, init, xs, **kw):
        def wrapped(state, it):
            new, _ = body(state, it)
            return new, (new[3], new[0].data)
        out, held["ys"] = scan(wrapped, init, xs, **kw)
        return out, None

    jlm.jax.lax.scan = spy
    try:
        jlm._optimize_loop(obs, jcam, jgrav, h, w, jcfg)
    finally:
        jlm.jax.lax.scan = scan
    return [np.asarray(y) for y in held["ys"]]


def trajectory(model: str, prior, compiled: bool) -> dict:
    """Both solvers on one case: the test's verdict and where the lanes part."""
    data = fixture(model, prior=prior)
    jres = jlm.run_lm({k: jnp.asarray(v) for k, v in data.items()}, jlm.LMConfig(camera_model=model))
    jcost, jcam = _jax_states(model, prior)
    costs, cams = [], []
    plain_system, port_plain = tls.lm_system, tls.lm_system_plain

    def recorded(obs, camera, gravity, h, w, cfg, **kw):
        out = plain_system(obs, camera, gravity, h, w, cfg, **kw)
        if not kw:
            costs.append(out[2].numpy().copy())
            cams.append(camera.data.numpy().copy())
        return out

    tlm.lm_system = recorded
    if compiled:
        tls.lm_system_plain = _lm_system_plain_compiled()
    try:
        tres = tlm.run_lm({k: torch.from_numpy(np.array(v)) for k, v in data.items()},
                          tlm.LMConfig(camera_model=model))
    finally:
        tlm.lm_system, tls.lm_system_plain = plain_system, port_plain
    tcost, tcam = np.stack(costs[:30]), np.stack(cams[:30])
    off = [k for k in range(30) if ulps(tcost[k], jcost[k]).max() > 4]
    stop_equal = bool(np.array_equal(tres.info["stop_at"].numpy(), np.asarray(jres.info["stop_at"])))
    vfov = float(np.abs(tres.camera.vfov.numpy() - np.asarray(jres.camera.vfov)).max())
    return {"stop_at_equal": stop_equal, "vfov_max_diff": vfov,
            "passes": stop_equal and vfov <= 1e-4 and float(np.abs(
                tres.gravity.roll.numpy() - np.asarray(jres.gravity.roll)).max()) <= 1e-4,
            "focal_ulps_after_step_1": int(ulps(tcam[1][:, 2], jcam[0][:, 2]).max()),
            "first_iteration_cost_over_4_ulps": off[0] if off else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trajectories", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(1)
    result = {"host": host_check()}
    print(f"this CPU against the copy: {json.dumps(result['host'])}", flush=True)
    result.update({model: compare(model) for model in MODELS})
    for model in MODELS:
        r = result[model]
        print(f"{model}: cost differs in {r['cost_lanes_differing']} of 4 lanes, by at most "
              f"{r['cost_max_ulps']} ulps; G differs in {r['G_entries_differing']} of "
              f"{r['G_entries']} entries, H in {r['H_entries_differing']} of {r['H_entries']}; "
              f"latitude residual pixels apart from the compiled step: "
              f"{r['lat_residual_pixels_apart_from_compiled']} of {r['pixels']}", flush=True)
    if args.trajectories:
        cases = {}
        for model in MODELS:
            for prior in PRIORS:
                for compiled in (False, True):
                    key = f"{model}/{prior}/{'compiled' if compiled else 'port'}"
                    cases[key] = trajectory(model, prior, compiled)
                    print(key, json.dumps(cases[key]), flush=True)
        result["trajectories"] = cases
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
