"""The port's LM residual planes against the JAX LM as XLA compiles it on the CPU.

``run_lm`` runs each LM iteration inside ``lax.scan``, so the JAX package's
numbers are XLA's compiled arithmetic, not its source's. Here the port's
residual planes at the solver's initial estimate are held against those of one
iteration of the JAX solver's system compiled as ``run_lm`` compiles it (its
cost equal to ``run_lm``'s initial cost bit for bit), for the four camera
models: the up residuals bit for bit.

One exception, stated with its cause: the latitude residual. XLA rewrites the
``1 / sqrt`` of ``sinlat_planes`` into its ``rsqrt``, which on x86 is the
CPU's ``rsqrtps`` estimate (a table whose bits differ between CPU vendors and
instruction sets) refined by two Newton steps, and LLVM fuses the bearing's
products into multiply-adds. The port computes the source's arithmetic, as the
card's kernel does, so the two residuals differ by rounding, and by how much
depends on the CPU (``tools/lm_jax_ulps.py`` holds a copy of the x86
arithmetic and says whether it holds on a given CPU). They are held here within
the forward error bound of float32 arithmetic instead: with u = 2⁻²⁴ and
S = (|a·ud| + |b·vd| + |cg|)/|w| the size of the terms of sin(latitude), each
side's error is at most ~6u·S from the undistorted bearing (r², the distortion
scale and its product), 3u·S from the dot product, 1.5u·S from the norm, 2u·S
from the rsqrt (one rounding for torch's 1/sqrt, ≤ 2 ulps after XLA's Newton
steps) and 0.5u·S from the product, ~13u·S in all, and the subtraction from
lat_sin rounds once more on each side. So

    |Δ residual| ≤ 32u·(S + |lat_sin|),

which an error of the formula (a sign, a distortion term) exceeds by orders of
magnitude. The same bound holds sin(latitude) against ``jax.jit(sinlat_planes)``.

The observations: ``flatten_observations`` takes the latitude's sine eagerly,
which XLA computes with glibc's ``sinf``; the port takes torch's. They differ by
at most one float32 ulp (held below), so the residuals here are compared on
the same observation planes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geocalib_tpu.geometry import planar_fields as jpf
from geocalib_tpu.optim import lm as jlm
from geocalib_tpu_torch.geometry import planar_fields as tpf
from geocalib_tpu_torch.geometry.camera import Camera
from geocalib_tpu_torch.geometry.gravity import Gravity
from geocalib_tpu_torch.optim import lm as tlm

from test_torch_lm import MODELS, _setup

U = 2.0**-24  # float32's unit roundoff
BOUND_UNITS = 32  # the forward error bound above, in units of U


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _ulps(a, b) -> np.ndarray:
    def ordered(x):
        i = _bits(x).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def _initial(model):
    data, *_ = _setup(model, B=4, h=24, w=32)
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    cfg = jlm.resolve_priors(jd, jlm.LMConfig(camera_model=model))
    obs, h, w = jlm.flatten_observations(jd, cfg)
    cam, grav = jlm.get_trivial_estimation(jd, cfg)
    return data, jd, cfg, obs, h, w, cam, grav


def _compiled_step(cfg, obs, h, w, cam, grav):
    """One iteration of the JAX solver's system as ``_optimize_loop`` runs it
    (``lax.scan`` over ``_residuals``, ``_costs_and_weights``, ``build_system``,
    the estimate carried as the scan's state), its residual planes returned
    beside the cost."""
    def body(carry, _):
        cam, grav = carry
        r_up, r_lat = jlm._residuals(cam, grav, obs, h, w)
        cost, w_up, w_lat = jlm._costs_and_weights(r_up, r_lat, obs, cfg)
        G, H = jlm.build_system(cam, grav, r_up, r_lat, w_up, w_lat, h, w, cfg)
        return carry, (r_up[0], r_up[1], r_lat, cost, G, H)

    _, ys = jax.jit(lambda c: jax.lax.scan(body, c, None, length=1))((cam, grav))
    return [np.asarray(y[0]) for y in ys]


def _term_size(camera, gravity, u, v) -> np.ndarray:
    """S = (|a·ud| + |b·vd| + |cg|)/|w|, in float64 from the port's bearing."""
    a, b, cg = (t.double() for t in tpf._gravity_planes(gravity))
    k1, k2 = (t.double() for t in tpf._k_planes(camera))
    u, v = u.double(), v.double()
    r2 = u * u + v * v
    if camera.model == "simple_radial":
        su = 1 - k1 * r2
    elif camera.model == "radial":
        su = 1 - k1 * r2 + (3 * k1 * k1 - k2) * r2 * r2
    elif camera.model == "simple_divisional":
        su = 1 / (1 + k1 * r2)
    else:
        su = torch.ones_like(r2)
    ud, vd = su * u, su * v
    return ((a * ud).abs() + (b * vd).abs() + cg.abs()) / torch.sqrt(ud * ud + vd * vd + 1)


def _within_bound(got, want, size) -> bool:
    """|got − want| ≤ BOUND_UNITS·U·size everywhere (equal where size is 0)."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return bool(np.all(diff <= BOUND_UNITS * U * np.asarray(size)))


@pytest.mark.parametrize("model", MODELS)
def test_residual_planes_match_jitted_jax(model):
    data, jd, cfg, obs, h, w, cam, grav = _initial(model)
    r_upx, r_upy, r_lat, cost, G, H = _compiled_step(cfg, obs, h, w, cam, grav)
    jres = jlm.run_lm(jd, jlm.LMConfig(camera_model=model))
    # premise: the scan above compiles as run_lm's does
    np.testing.assert_array_equal(_bits(cost), _bits(jres.info["initial_cost"]))

    tcam = Camera.from_data(torch.from_numpy(np.array(cam.data)), model)
    tgrav = Gravity(torch.from_numpy(np.array(grav.vec3d)))
    u, v = tpf.make_grid(tcam, h, w)
    px, py = tpf.up_planes(tcam, tgrav, u, v)
    np.testing.assert_array_equal(_bits(torch.from_numpy(np.array(obs.up_x)) - px), _bits(r_upx))
    np.testing.assert_array_equal(_bits(torch.from_numpy(np.array(obs.up_y)) - py), _bits(r_upy))

    # the exception: the latitude residual, within its forward error bound
    lat_sin = torch.from_numpy(np.array(obs.lat_sin))
    sinlat = tpf.sinlat_planes(tcam, tgrav, u, v)
    size = _term_size(tcam, tgrav, u, v).numpy()
    assert _within_bound(lat_sin - sinlat, r_lat, size + np.abs(lat_sin.numpy()))
    # and sin(latitude) itself against the standalone jit
    want = jax.jit(jpf.sinlat_planes)(cam, grav, jnp.asarray(u.numpy()), jnp.asarray(v.numpy()))
    assert _within_bound(sinlat, want, size)


@pytest.mark.parametrize("model", ["pinhole", "simple_divisional"])
def test_observation_sine_within_one_ulp(model):
    """The port's observation sine against glibc's sinf (eager XLA) is within one
    float32 ulp, and the other planes are equal."""
    data, jd, cfg, obs, h, w, cam, grav = _initial(model)
    td = {k: torch.from_numpy(np.array(v)) for k, v in data.items()}
    cfg_t = tlm.resolve_priors(td, tlm.LMConfig(camera_model=model))
    tobs, _, _ = tlm.flatten_observations(td, cfg_t)
    for k, v in obs._asdict().items():
        if v is None:
            continue
        if k == "lat_sin":
            assert _ulps(tobs[k].numpy(), v).max() <= 1
        else:
            np.testing.assert_array_equal(_bits(tobs[k]), _bits(v))
