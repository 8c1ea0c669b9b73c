"""geocalib_tpu_torch geometry against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. Tolerances
are float32 ones: the two frameworks evaluate the same formulas with other
operation orders and transcendental implementations, so values agree to a
few ulps (rtol 1e-5 / atol 1e-6) and Jacobian chains, which multiply several
such values, to about 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geocalib_tpu.geometry import camera as jcam
from geocalib_tpu.geometry import gravity as jgrav
from geocalib_tpu.geometry import jacobians as jjac
from geocalib_tpu.geometry import manifolds as jman
from geocalib_tpu.geometry import perspective_fields as jpf
from geocalib_tpu.geometry import planar_fields as jpl
from geocalib_tpu.utils import conversions as jconv
from geocalib_tpu_torch.geometry import camera as tcam
from geocalib_tpu_torch.geometry import gravity as tgrav
from geocalib_tpu_torch.geometry import jacobians as tjac
from geocalib_tpu_torch.geometry import manifolds as tman
from geocalib_tpu_torch.geometry import perspective_fields as tpf
from geocalib_tpu_torch.geometry import planar_fields as tpl
from geocalib_tpu_torch.utils import conversions as tconv

RTOL, ATOL = 1e-5, 1e-6
MODELS = ["pinhole", "simple_radial"]


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol)


def _params(model, B=3, h=12, w=16, seed=0):
    rng = np.random.default_rng(seed)
    p = {
        "height": np.full(B, float(h), np.float32),
        "width": np.full(B, float(w), np.float32),
        "vfov": rng.uniform(0.6, 1.4, B).astype(np.float32),
        "k1": (rng.uniform(-0.3, 0.1, B) if model != "pinhole" else np.zeros(B)).astype(np.float32),
    }
    rp = rng.uniform(-0.5, 0.5, (2, B)).astype(np.float32)
    return p, rp


def _both(model, **kw):
    p, rp = _params(model, **kw)
    jc = jcam.Camera.from_dict({k: jnp.asarray(v) for k, v in p.items()}, model=model)
    tc = tcam.Camera.from_dict({k: torch.from_numpy(v) for k, v in p.items()}, model=model)
    jg = jgrav.Gravity.from_rp(jnp.asarray(rp[0]), jnp.asarray(rp[1]))
    tg = tgrav.Gravity.from_rp(torch.from_numpy(rp[0]), torch.from_numpy(rp[1]))
    return jc, tc, jg, tg


def test_conversions():
    rng = np.random.default_rng(1)
    r, p, y = (rng.uniform(-1, 1, 5).astype(np.float32) for _ in range(3))
    close(tconv.rad2rotmat(torch.from_numpy(r), torch.from_numpy(p), torch.from_numpy(y)),
          jconv.rad2rotmat(r, p, y))
    f, s = rng.uniform(100, 500, 5).astype(np.float32), rng.uniform(200, 400, 5).astype(np.float32)
    close(tconv.focal2fov(torch.from_numpy(f), torch.from_numpy(s)), jconv.focal2fov(f, s))
    close(tconv.fov2focal(torch.from_numpy(r + 1.5), torch.from_numpy(s)), jconv.fov2focal(r + 1.5, s))


def test_spherical_manifold():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 3)).astype(np.float32)
    x[0] = [0.0, 0.0, -1.0]  # pivot branch
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    d = (rng.normal(size=(6, 2)) * 0.3).astype(np.float32)
    d[1] = 0.0  # Taylor branch
    close(tman.SphericalManifold.plus(torch.from_numpy(x), torch.from_numpy(d)),
          jman.SphericalManifold.plus(x, d))
    close(tman.SphericalManifold.J_plus(torch.from_numpy(x)), jman.SphericalManifold.J_plus(x))


@pytest.mark.parametrize("spherical", [False, True])
def test_gravity(spherical):
    _, _, jg, tg = _both("pinhole", B=5)
    close(tg.roll, jg.roll)
    close(tg.pitch, jg.pitch)
    close(tg.J_rp(), jg.J_rp())
    close(tg.R, jg.R)
    delta = np.random.default_rng(3).normal(size=(5, 2)).astype(np.float32) * 0.1
    close(tg.update(torch.from_numpy(delta), spherical).vec3d, jg.update(delta, spherical).vec3d)
    close(tg.J_update(spherical), jg.J_update(spherical))


@pytest.mark.parametrize("model", MODELS)
def test_camera(model):
    jc, tc, _, _ = _both(model)
    close(tc.data, jc.data)
    close(tc.vfov, jc.vfov)
    close(tc.K, jc.K)
    rng = np.random.default_rng(4)
    df = rng.normal(size=(3,)).astype(np.float32)
    close(tc.update_focal(torch.from_numpy(df), as_log=True).data, jc.update_focal(df, as_log=True).data)
    close(tc.update_focal(torch.from_numpy(df * 3), as_log=False).data,
          jc.update_focal(df * 3, as_log=False).data)
    dk = rng.normal(size=(3, 1)).astype(np.float32)
    close(tc.update_dist(torch.from_numpy(dk)).data, jc.update_dist(dk).data)
    undo = {"scales": np.array([[0.5, 0.6]] * 3, np.float32), "crop_pad": np.array([[-3.0, -5.0]] * 3, np.float32)}
    close(tc.undo_scale_crop({k: torch.from_numpy(v) for k, v in undo.items()}).data,
          jc.undo_scale_crop({k: jnp.asarray(v) for k, v in undo.items()}).data)


@pytest.mark.parametrize("model", ["radial", "simple_divisional"])
def test_unported_models_raise(model):
    assert model in tcam.CAMERA_MODELS and model in tcam.NUM_DIST_PARAMS
    assert tcam.NUM_DIST_PARAMS == jcam.NUM_DIST_PARAMS and tcam.DIST_RANGE == jcam.DIST_RANGE
    with pytest.raises(NotImplementedError):
        tcam.Camera.from_data(torch.zeros(1, 8), model=model)


@pytest.mark.parametrize("model", MODELS)
def test_perspective_field(model):
    jc, tc, jg, tg = _both(model)
    tu, tl = tpf.get_perspective_field(tc, tg, 12, 16)
    ju, jl = jpf.get_perspective_field(jc, jg, 12, 16)
    close(tu, ju)
    close(tl, jl)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("spherical,log_focal", [(False, False), (True, True)])
def test_perspective_jacobians(model, spherical, log_focal):
    jc, tc, jg, tg = _both(model)
    tJu, tJl = tpf.J_perspective_field(tc, tg, 12, 16, spherical, log_focal)
    jJu, jJl = jpf.J_perspective_field(jc, jg, 12, 16, spherical, log_focal)
    close(tJu, jJu, atol=1e-5)
    close(tJl, jJl, atol=1e-5)


@pytest.mark.parametrize("model", MODELS)
def test_jacobians_match_jacfwd(model):
    """Analytic up/latitude Jacobians against torch.func.jacfwd of the forward fields
    (Euclidean roll/pitch, linear focal, k1), as tests/test_jacobians.py does with jax.jacfwd."""
    _, tc, _, tg = _both(model, B=1, h=6, w=8)
    tc, tg = tc[0], tg[0]
    h, w = 6, 8

    def fields(theta):
        g = tgrav.Gravity.from_rp(theta[0], theta[1])
        f = torch.stack([theta[2], theta[2]])
        k = torch.stack([theta[3], torch.zeros_like(theta[3])])
        cam = tcam.Camera(tc.size[None], f[None], tc.c[None], k[None], model)
        up = tpf.get_up_field_flat(cam, tgrav.Gravity(g.vec3d[None]), h, w)[0]
        uv1, _ = cam.image2world(cam.pixel_coordinates(h, w))
        sinlat = (cam.pixel_bearing_many(uv1) * g.vec3d).sum(-1)[0]
        return torch.cat([up, sinlat[:, None]], dim=-1)

    theta = torch.stack([tg.roll, tg.pitch, tc.f[1], tc.k[0]])
    auto = torch.func.jacfwd(fields)(theta)  # (N, 3, 4)
    cam1 = tcam.Camera(tc.size[None], tc.f[None], tc.c[None], tc.k[None], model)
    g1 = tgrav.Gravity(tg.vec3d[None])
    Ju = tpf.J_up_field(cam1, g1, h, w)[0]
    Jl = tpf.J_latitude_field(cam1, g1, h, w)[0]
    P = 3 + tcam.NUM_DIST_PARAMS[model]
    np.testing.assert_allclose(Ju.numpy(), auto[:, :2, :P].numpy(), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(Jl.numpy(), auto[:, 2:, :P].numpy(), rtol=1e-3, atol=1e-4)


def test_jacobian_helpers():
    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
    auto = torch.stack([torch.func.jacfwd(lambda x: x / torch.linalg.norm(x))(vi) for vi in v])
    close(tjac.J_vecnorm(v), auto, atol=1e-5)
    close(tjac.J_vecnorm(v), jjac.J_vecnorm(v.numpy()))
    f, hh = torch.tensor([300.0, 150.0]), torch.tensor([240.0, 320.0])
    close(tjac.J_focal2fov(f, hh), torch.func.vmap(torch.func.grad(tconv.focal2fov))(f, hh))
    uv = torch.from_numpy(rng.normal(size=(2, 5, 2)).astype(np.float32))
    abc = torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32))
    for wrt in ("uv", "abc"):
        close(tjac.J_up_projection(uv, abc, wrt), jjac.J_up_projection(uv.numpy(), abc.numpy(), wrt))


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("spherical,log_focal", [(False, False), (True, True)])
def test_planar_fields(model, spherical, log_focal):
    jc, tc, jg, tg = _both(model)
    tu, tv = tpl.make_grid(tc, 12, 16)
    ju, jv = jpl.make_grid(jc, 12, 16)
    close(tu, ju)
    close(tpl.up_planes(tc, tg, tu, tv), jpl.up_planes(jc, jg, ju, jv))
    close(tpl.sinlat_planes(tc, tg, tu, tv), jpl.sinlat_planes(jc, jg, ju, jv))
    close(tpl.manifold_matrix(tg, spherical), jpl.manifold_matrix(jg, spherical))
    tJ = tpl.J_up_planes(tc, tg, tu, tv, spherical, log_focal)
    jJ = jpl.J_up_planes(jc, jg, ju, jv, spherical, log_focal)
    for c in range(2):
        close(torch.stack(tJ[c]), jnp.stack(jJ[c]), atol=1e-5)
    close(torch.stack(tpl.J_lat_planes(tc, tg, tu, tv, spherical, log_focal)),
          jnp.stack(jpl.J_lat_planes(jc, jg, ju, jv, spherical, log_focal)), atol=1e-5)
