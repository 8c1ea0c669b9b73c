"""The port's LM solver and the LM kernel's plain version against the JAX package.

The plain version of the LM kernel (``lm_system_plain``) is held against the
Pallas kernel in interpret mode and against its XLA twin ``_forward_planar``
on the fixtures of tests/test_pallas_kernel.py. G, H and the cost are sums
over 256 pixels taken in other orders, so they agree to float32 rounding of
the sums: rtol 1e-4 with an absolute floor of 1e-5 of the largest entry.
The solver runs 30 float32 iterations in both packages; roll, pitch and vFoV
agree to 1e-4 rad and stop_at exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geocalib_tpu.geometry.camera import Camera as JCamera
from geocalib_tpu.geometry.gravity import Gravity as JGravity
from geocalib_tpu.geometry.perspective_fields import get_perspective_field
from geocalib_tpu.ops.lm_kernel import _forward_planar, lm_system_pallas
from geocalib_tpu.optim import linalg as jlinalg
from geocalib_tpu.optim import losses as jlosses
from geocalib_tpu.optim.lm import LMConfig as JLMConfig
from geocalib_tpu.optim.lm import flatten_observations, run_lm as jrun_lm
from geocalib_tpu.optim.lm import get_heuristic_estimation as jheuristic
from geocalib_tpu_torch.geometry.camera import Camera
from geocalib_tpu_torch.geometry.gravity import Gravity
from geocalib_tpu_torch.ops.lm_system import lm_system, lm_system_plain
from geocalib_tpu_torch.optim import linalg, losses
from geocalib_tpu_torch.optim.lm import LMConfig, get_heuristic_estimation, run_lm

MODELS = ["pinhole", "simple_radial", "radial", "simple_divisional"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work, as the other port test files run:
    the port's sums then take one order in every run, whatever the worker's core count.
    (On these 768-pixel fixtures 1 to 8 threads already gave the same bits, and the JAX
    side the same stop_at at every XLA thread count, vector width and ISA tried, so
    test_run_lm_matches_jax[None-simple_divisional] fails the same way in every run: the
    port stops lane 3 at 12, JAX at 11, the stop test one float32 ulp from its threshold.)"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(model, B=3, h=16, w=16, conf=True):
    """The fixture of tests/test_pallas_kernel.py::_setup, as numpy arrays; the radial
    model also gets a k2, from a stream of its own so the other fixtures stay as they were."""
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
            "latitude_field": np.asarray(lat + 0.05 * rng.normal(size=lat.shape).astype(np.float32))}
    if conf:
        data["up_confidence"] = rng.uniform(0.2, 1.0, (B, h, w)).astype(np.float32)
        data["latitude_confidence"] = rng.uniform(0.2, 1.0, (B, h, w)).astype(np.float32)
    cam2 = JCamera.from_dict({"height": jnp.full((B,), float(h)), "width": jnp.full((B,), float(w)),
                              "vfov": jnp.full((B,), 1.0, jnp.float32),
                              "k1": jnp.asarray(k1 * 0.5, jnp.float32),
                              "k2": jnp.asarray(k2 * 0.5, jnp.float32)}, model=model)
    grav2 = JGravity.from_rp(jnp.zeros((B,)), jnp.zeros((B,)))
    return data, cam2, grav2, h, w


def _to_torch(cam, grav):
    return (Camera.from_data(torch.from_numpy(np.asarray(cam.data)), cam.model),
            Gravity(torch.from_numpy(np.asarray(grav.vec3d))))


def _system_close(t, j):
    for a, b in zip(t, j):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("model", MODELS)
def test_plain_cost_only_matches_pallas(model):
    """with_system=False: the cost against the Pallas kernel's cost-only instance in
    interpret mode, G and H zeros in both, and the cost the full system's bit for bit."""
    data, cam, grav, h, w = _setup(model)
    jcfg = JLMConfig(camera_model=model)
    obs, _, _ = flatten_observations({k: jnp.asarray(v) for k, v in data.items()}, jcfg)
    obs = {k: v for k, v in obs._asdict().items() if v is not None}
    pallas = lm_system_pallas(obs, cam, grav, h, w, jcfg, False, True)

    cfg = LMConfig(camera_model=model)
    tobs = {k: torch.from_numpy(np.asarray(v)) for k, v in obs.items()}
    tcam, tgrav = _to_torch(cam, grav)
    out = lm_system_plain(tobs, tcam, tgrav, h, w, cfg, with_system=False)
    _system_close(out, pallas)
    assert not out[0].any() and not out[1].any()
    assert torch.equal(out[2], lm_system_plain(tobs, tcam, tgrav, h, w, cfg)[2])
    for a, b in zip(lm_system(tobs, tcam, tgrav, h, w, cfg, with_system=False), out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["squared", "huber", "barron"])
def test_losses(name):
    x = np.random.default_rng(0).uniform(0, 5, 64).astype(np.float32)
    t = losses.scaled_loss(torch.from_numpy(x), losses.get_loss_fn(name), 0.5)
    j = jlosses.scaled_loss(jnp.asarray(x), jlosses.get_loss_fn(name), 0.5)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("P", [3, 4])
def test_linalg(P):
    rng = np.random.default_rng(P)
    A = rng.normal(size=(5, P, P)).astype(np.float32)
    H = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(P, dtype=np.float32)
    g = rng.normal(size=(5, P)).astype(np.float32)
    lamb = rng.uniform(0.01, 1, 5).astype(np.float32)
    Ht, gt = torch.from_numpy(H), torch.from_numpy(g)
    for t, j in [
        (linalg.cholesky_solve_small(Ht, gt), jlinalg.cholesky_solve_small(H, g)),
        (linalg.inv_small(Ht), jlinalg.inv_small(H)),
        (linalg.damp_hessian(Ht, torch.from_numpy(lamb)), jlinalg.damp_hessian(H, lamb)),
        (linalg.max_eig_2x2(Ht[:, :2, :2]), jlinalg.max_eig_2x2(H[:, :2, :2])),
    ]:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_solve_arrow(p):
    """The shared-intrinsics Schur solve, with one gravity block singular (det guard)."""
    rng = np.random.default_rng(10 + p)
    B = 4
    A = rng.normal(size=(B, 2 + p, 2 + p)).astype(np.float32)
    Hb = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(2 + p, dtype=np.float32)
    D, U = Hb[:, :2, :2].copy(), Hb[:, :2, 2:].copy()
    D[0] = [[1.0, 2.0], [2.0, 4.0]]  # det = 0
    S = Hb[:, 2:, 2:].sum(0) + 10.0 * np.eye(p, dtype=np.float32)
    g_g = rng.normal(size=(B, 2)).astype(np.float32)
    g_i = rng.normal(size=(p,)).astype(np.float32)
    t = linalg.solve_arrow(*(torch.from_numpy(a) for a in (D, U, S, g_g, g_i)))
    j = jlinalg.solve_arrow(D, U, S, g_g, g_i)
    for a, b in zip(t, j):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("conf", [True, False])
@pytest.mark.parametrize("loss_fn,spherical", [("huber", True), ("squared", False), ("barron", True)])
def test_plain_system_matches_pallas(model, conf, loss_fn, spherical):
    data, cam, grav, h, w = _setup(model, conf=conf)
    jcfg = JLMConfig(camera_model=model, loss_fn=loss_fn, use_spherical_manifold=spherical,
                     estimate_focal=loss_fn != "barron")
    obs, _, _ = flatten_observations({k: jnp.asarray(v) for k, v in data.items()}, jcfg)
    obs = {k: v for k, v in obs._asdict().items() if v is not None}
    pallas = lm_system_pallas(obs, cam, grav, h, w, jcfg, True, True)
    planar = _forward_planar(obs, cam, grav, h, w, jcfg, True)

    cfg = LMConfig(camera_model=model, loss_fn=loss_fn, use_spherical_manifold=spherical,
                   estimate_focal=loss_fn != "barron")
    tobs = {k: torch.from_numpy(np.asarray(v)) for k, v in obs.items()}
    tcam, tgrav = _to_torch(cam, grav)
    out = lm_system_plain(tobs, tcam, tgrav, h, w, cfg)
    _system_close(out, pallas)
    _system_close(out, planar)
    # on CPU tensors the wrapper is the plain version, and launches nothing
    before = lm_system.launches
    for a, b in zip(lm_system(tobs, tcam, tgrav, h, w, cfg), out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert lm_system.launches == before


def _check_run(jres, tres, keys=("initial_cost", "final_cost", "roll_uncertainty",
                                   "pitch_uncertainty", "gravity_uncertainty",
                                   "focal_uncertainty", "vfov_uncertainty", "initial_vfov")):
    for attr in ("roll", "pitch"):
        np.testing.assert_allclose(getattr(tres.gravity, attr).numpy(),
                                   np.asarray(getattr(jres.gravity, attr)), atol=1e-4)
    np.testing.assert_allclose(tres.camera.vfov.numpy(), np.asarray(jres.camera.vfov), atol=1e-4)
    np.testing.assert_allclose(tres.camera.k.numpy(), np.asarray(jres.camera.k), atol=1e-4)
    np.testing.assert_array_equal(tres.info["stop_at"].numpy(), np.asarray(jres.info["stop_at"]))
    for key in keys:
        np.testing.assert_allclose(tres.info[key].numpy(), np.asarray(jres.info[key]),
                                   rtol=1e-3, atol=1e-6, err_msg=key)


def _run_both(model, data, **opts):
    jres = jrun_lm({k: jnp.asarray(v) for k, v in data.items()}, JLMConfig(camera_model=model, **opts))
    tres = run_lm({k: torch.from_numpy(np.asarray(v)) for k, v in data.items()},
                  LMConfig(camera_model=model, **opts))
    return jres, tres


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("prior", [None, "focal", "gravity"])
def test_run_lm_matches_jax(model, prior):
    data, _, _, _, _ = _setup(model, B=4, h=24, w=32)
    if prior == "focal":
        data["prior_focal"] = np.full(4, 30.0, np.float32)
    if prior == "gravity":
        data["prior_gravity"] = np.asarray(JGravity.from_rp(jnp.full(4, 0.1), jnp.full(4, -0.2)).vec3d)
    jres, tres = _run_both(model, data)
    _check_run(jres, tres)


@pytest.mark.parametrize("model", ["pinhole", "radial"])
def test_run_lm_shared_intrinsics_matches_jax(model):
    """One camera for the batch: one focal in every lane, one stop_at broadcast."""
    data, _, _, _, _ = _setup(model, B=3, h=24, w=32)
    jres, tres = _run_both(model, data, shared_intrinsics=True)
    _check_run(jres, tres)
    f = tres.camera.f.numpy()
    assert np.all(f == f[:1]) and np.all(tres.camera.k.numpy() == tres.camera.k.numpy()[:1])
    assert np.unique(tres.info["stop_at"].numpy()).size == 1


@pytest.mark.parametrize("case", ["fields", "priors", "run_lm"])
def test_heuristic_init_matches_jax(case):
    """get_heuristic_estimation with and without priors, and run_lm started from it."""
    data, _, _, _, _ = _setup("simple_radial", B=4, h=24, w=32)
    if case == "priors":
        data["prior_focal"] = np.full(4, 30.0, np.float32)
        data["prior_dist"] = np.tile(np.float32([[-0.1, 0.0]]), (4, 1))
        data["prior_gravity"] = np.asarray(JGravity.from_rp(jnp.full(4, 0.1), jnp.full(4, -0.2)).vec3d)
    if case == "run_lm":
        jres, tres = _run_both("simple_radial", data, init_mode="heuristic")
        _check_run(jres, tres)
        return
    cfg = dict(camera_model="simple_radial", init_mode="heuristic")
    jcam, jgrav = jheuristic({k: jnp.asarray(v) for k, v in data.items()}, JLMConfig(**cfg))
    tcam, tgrav = get_heuristic_estimation({k: torch.from_numpy(v) for k, v in data.items()},
                                           LMConfig(**cfg))
    np.testing.assert_allclose(tcam.data.numpy(), np.asarray(jcam.data), rtol=1e-6)
    np.testing.assert_allclose(tgrav.vec3d.numpy(), np.asarray(jgrav.vec3d), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("opts", [{"grad_mode": "implicit"}])
def test_unported_options_raise(opts):
    """Every grad_mode of the JAX package is ported ("unroll", "ift"); a mode it
    does not have is refused."""
    for mode in ("unroll", "ift"):
        assert LMConfig(grad_mode=mode).grad_mode == mode
    with pytest.raises(ValueError):
        LMConfig(**opts)



def test_lm_system_is_differentiable_on_cpu():
    """The refusal of inputs that require grad is for CUDA tensors only: on CPU tensors
    the wrapper is the plain version, and a backward through it gives finite gradients."""
    data, cam, grav, h, w = _setup("simple_radial")
    cfg = LMConfig(camera_model="simple_radial")
    obs, _, _ = flatten_observations({k: jnp.asarray(v) for k, v in data.items()},
                                     JLMConfig(camera_model="simple_radial"))
    tobs = {k: torch.from_numpy(np.array(v)).requires_grad_()
            for k, v in obs._asdict().items() if v is not None}
    tcam, tgrav = _to_torch(cam, grav)
    cam_data = tcam.data.clone().requires_grad_()
    tcam = Camera.from_data(cam_data, "simple_radial")
    with torch.enable_grad():
        G, H, cost = lm_system(tobs, tcam, tgrav, h, w, cfg)
        (G.square().sum() + H.square().sum() + cost.sum()).backward()
    for t in (*tobs.values(), cam_data):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
    assert bool(cam_data.grad.abs().sum() > 0) and bool(tobs["up_x"].grad.abs().sum() > 0)
