"""The port's baselines against the JAX package, on the CPU: the RANSAC and Adam
field solvers, the conversion helpers they and the baselines use, the native
UVP, the import-gated wrappers and ``evaluate_baseline`` for ``trivial`` and
``uvp``.

Inputs are made with numpy from a seed (the fields of tests/test_solvers.py's
``make_data``, 64×64, B = 2) or read from the committed data/openpano_synth.
Tolerances, set before any run:
- RANSAC: the sampled pixels equal; every hypothesis within 1e-5 relative
  unless its minimal sample is ill-conditioned: random one-ulp perturbations
  of the input fields (8 draws, ``_ulp_spread``) move the port's own
  hypothesis by more than 1e-5 relative; and under 5% of them apart. XLA
  contracts the cross products of the vanishing point into fused
  multiply-adds, so 1.3% of test_solvers.py's 6,000 hypotheses differ by
  more than 1e-5 (up to 6.5e-3), every one ill-conditioned (one-ulp spread
  2e-5 or more), measured first; the rule was set after. The winners:
  equal scores (on these noise-free fields every score is a whole count of
  pixels, so a float32 sum in another order gives the same bits), roll,
  pitch and focal within 1e-5 relative, and each winner, scored by the other
  package, reaches the other's score. They can be different samples of equal
  score: the earliest best sample may be ill-conditioned and score a pixel
  less in the other package.
- Adam over 150 steps: each step's cost within 1e-4 of the lane's first cost
  (the costs fall to the float32 floor, where the cost itself is rounding
  residue, so the bound is relative to the scale of the problem), and the
  final roll, pitch and vFoV within 1e-4 rad.
- The conversion helpers and strided_grid within 1e-6 relative.
- UVP's (f, g) equal to JAX's bit for bit (the same float64 host code).
- evaluate_baseline: ``trivial`` equal; ``uvp`` within 1e-4 relative (the
  metrics run in float32 on the same estimates).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geocalib_tpu.eval import baselines_cli as jcli
from geocalib_tpu.geometry import planar_fields as jpf
from geocalib_tpu.geometry.camera import Camera as JCamera
from geocalib_tpu.geometry.gravity import Gravity as JGravity
from geocalib_tpu.geometry.perspective_fields import get_perspective_field
from geocalib_tpu.models import baselines as jbaselines
from geocalib_tpu.models import uvp as juvp
from geocalib_tpu.optim import gradient as jgd
from geocalib_tpu.optim import ransac as jr
from geocalib_tpu.utils import conversions as jconv
from geocalib_tpu_torch.eval import baselines_cli as tcli
from geocalib_tpu_torch.geometry import planar_fields as tpf
from geocalib_tpu_torch.geometry.camera import Camera
from geocalib_tpu_torch.models import baselines as tbaselines
from geocalib_tpu_torch.models import uvp as tuvp
from geocalib_tpu_torch.optim import gradient as tgd
from geocalib_tpu_torch.optim import ransac as tr
from geocalib_tpu_torch.utils import conversions as tconv
from geocalib_tpu_torch.utils.threefry import prng_key

ROOT = Path(__file__).resolve().parents[1]
SYNTH = ROOT / "data" / "openpano_synth"
H = W = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work (see tests/test_torch_eval.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_data(B=2, seed=0):
    """tests/test_solvers.py's fields, as numpy."""
    rng = np.random.default_rng(seed)
    vfov = jnp.asarray(rng.uniform(0.7, 1.3, (B,)), jnp.float32)
    roll = jnp.asarray(rng.uniform(-0.5, 0.5, (B,)), jnp.float32)
    pitch = jnp.asarray(rng.uniform(-0.5, 0.5, (B,)), jnp.float32)
    cam = JCamera.from_dict({"height": jnp.full((B,), float(H)), "width": jnp.full((B,), float(W)),
                             "vfov": vfov})
    up, lat = get_perspective_field(cam, JGravity.from_rp(roll, pitch), H, W)
    return {"up_field": np.asarray(up), "latitude_field": np.asarray(lat)}


def _torch(data):
    return {k: torch.from_numpy(np.array(v)) for k, v in data.items()}


def _jax_hypotheses(data, cfg, rng):
    """geocalib_tpu/optim/ransac.py run_ransac's samples and hypotheses (:163-199),
    through the JAX module's own solvers."""
    up_field = jnp.asarray(data["up_field"])
    B, h, w = up_field.shape[:3]
    n = cfg.n_iter
    kx, ky = jax.random.split(rng)
    xs = jax.random.randint(kx, (B, n, 3), 0, w)
    ys = jax.random.randint(ky, (B, n, 3), 0, h)
    bidx = jnp.arange(B)[:, None, None]
    up = up_field[bidx, ys, xs]
    xy = jnp.stack([xs, ys], axis=-1).astype(jnp.float32)
    c = jnp.stack([jnp.full((B,), w / 2.0), jnp.full((B,), h / 2.0)], axis=-1)
    vvp = jr.vertical_vanishing_point(xy[..., 0, :], up[..., 0, :], xy[..., 1, :], up[..., 1, :])
    if "prior_focal" in data:
        f_pos = f_neg = jnp.broadcast_to(jnp.asarray(data["prior_focal"], jnp.float32)[:, None],
                                         (B, n))
    else:
        L = jnp.sin(jnp.asarray(data["latitude_field"])[bidx, ys, xs][..., 2, 0])
        f_pos, f_neg = jr.solve_focal(L, xy[..., 2, :], vvp, c)
    hyps = []
    for f in (f_pos, f_neg):
        f = jnp.clip(f, 0.1 * max(h, w), 10.0 * max(h, w))
        roll, pitch = jr.solve_rp(vvp, c, f)
        hyps.append(jnp.stack([roll, pitch, f], axis=-1))
    rpf = jnp.nan_to_num(jnp.concatenate(hyps, axis=1), nan=0.0, posinf=1e6, neginf=-1e6)
    return np.asarray(xs), np.asarray(ys), np.asarray(rpf)


def _ulp_spread(data, xs, ys, rpf, n=8):
    """The largest change in the port's hypotheses when every value of the input fields
    moves by one float32 ulp in a random direction, over n draws: the float32
    conditioning of each minimal sample."""
    spread = np.zeros_like(rpf)
    for seed in range(n):
        r = np.random.default_rng(100 + seed)
        moved = {k: np.nextafter(v, np.where(r.random(v.shape) < 0.5, np.float32(-np.inf),
                                             np.float32(np.inf)).astype(v.dtype))
                 if k != "prior_focal" else v for k, v in data.items()}
        spread = np.maximum(spread, np.abs(tr.hypotheses(_torch(moved), xs, ys).numpy() - rpf))
    return spread


# (seed, n_iter, chunk, stride, prior focal, key): test_solvers.py's case, one whose
# 2·n_iter is not a multiple of chunk (zero-padded hypotheses of focal 0 in the last
# chunk), and one with a focal prior
RANSAC_CASES = {"default": (1, 500, 50, 2, False, 0), "ragged": (1, 300, 70, 2, False, 3),
                "prior": (2, 300, 50, 2, True, 1)}


@pytest.mark.parametrize("case", list(RANSAC_CASES))
def test_ransac_matches_jax(case):
    seed, n_iter, chunk, stride, prior, key = RANSAC_CASES[case]
    data = make_data(seed=seed)
    if prior:
        vfov = np.random.default_rng(seed).uniform(0.7, 1.3, (2,)).astype(np.float32)
        data["prior_focal"] = (H / 2.0 / np.tan(vfov / 2.0)).astype(np.float32)
    jcfg = jr.RansacConfig(n_iter=n_iter, chunk=chunk, scoring_stride=stride)
    tcfg = tr.RansacConfig(n_iter=n_iter, chunk=chunk, scoring_stride=stride)
    xs, ys, jrpf = _jax_hypotheses(data, jcfg, jax.random.PRNGKey(key))

    txs, tys = tr.sample_pixels(2, n_iter, H, W, prng_key(key), "cpu")
    np.testing.assert_array_equal(txs.numpy(), xs)
    np.testing.assert_array_equal(tys.numpy(), ys)
    trpf = tr.hypotheses(_torch(data), txs, tys).numpy()
    apart = np.abs(trpf - jrpf) > 1e-5 * np.abs(jrpf)
    ill = _ulp_spread(data, txs, tys, trpf) > 1e-5 * np.abs(trpf)
    assert not (apart & ~ill).any(), np.abs(trpf - jrpf)[apart & ~ill].max()
    assert apart.mean() < 0.05

    jres = jax.jit(lambda d: jr.run_ransac(d, jcfg, jax.random.PRNGKey(key)))(
        {k: jnp.asarray(v) for k, v in data.items()})
    tres = tr.run_ransac(_torch(data), tcfg, prng_key(key))
    np.testing.assert_array_equal(tres.score.numpy(), np.asarray(jres.score))
    np.testing.assert_allclose(tres.rpf.numpy(), np.asarray(jres.rpf), rtol=1e-5, atol=0)
    # each winner, scored by the other package, reaches the other's winning score (the
    # two may be different samples of equal score: the earliest such sample can be an
    # ill-conditioned one, which scores a pixel less in the other package)
    tplanes = tr.observation_planes(_torch(data), tcfg)
    jplanes = [None if p is None else jnp.asarray(p.numpy()) for p in tplanes]
    by_jax = jr._score_chunk(jnp.asarray(tres.rpf.numpy())[:, None], *jplanes, H, W, stride, jcfg)
    by_port = tr._score_chunk(torch.from_numpy(np.asarray(jres.rpf))[:, None], *tplanes, H, W,
                              stride, tcfg)
    np.testing.assert_array_equal(np.asarray(by_jax)[:, 0], np.asarray(jres.score))
    np.testing.assert_array_equal(by_port.numpy()[:, 0], tres.score.numpy())
    np.testing.assert_allclose(tres.camera.f.numpy(), np.asarray(jres.camera.f), rtol=1e-5)
    np.testing.assert_allclose(tres.gravity.vec3d.numpy(), np.asarray(jres.gravity.vec3d),
                               rtol=0, atol=1e-5)


def test_ransac_scores_ragged_chunks_as_jax():
    """The last chunk's zero-padded hypotheses (roll = pitch = focal = 0) score as in the
    JAX scan: every plane is NaN there, so they count no pixel."""
    data = make_data(seed=1)
    cfg = tr.RansacConfig(n_iter=30, chunk=7, scoring_stride=4)
    planes = tr.observation_planes(_torch(data), cfg)
    zeros = torch.zeros(2, 7, 3)
    score = tr._score_chunk(zeros, *planes, H, W, 4, cfg)
    jplanes = [jnp.asarray(p.numpy()) for p in planes]
    jscore = jr._score_chunk(jnp.zeros((2, 7, 3)), *jplanes, H, W, 4, jr.RansacConfig(
        n_iter=30, chunk=7, scoring_stride=4))
    np.testing.assert_array_equal(score.numpy(), np.asarray(jscore))
    assert not score.any()


def test_argmax_takes_nan_as_the_maximum_as_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 9)).astype(np.float32)
    x[0, 3] = x[0, 7] = np.nan
    x[1, 2] = x[1, 5] = x[1].max() + 1  # ties: the first index
    x[2, :] = np.nan
    x[3, 4], x[3, 6] = np.inf, np.nan
    np.testing.assert_array_equal(tr.argmax_first(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(x), axis=-1)))


def test_minimal_solvers_match_jax():
    rng = np.random.default_rng(3)
    xy = [rng.uniform(0, 64, (2, 40, 2)).astype(np.float32) for _ in range(3)]
    up = [rng.normal(size=(2, 40, 2)).astype(np.float32) for _ in range(2)]
    c = np.full((2, 2), 32.0, np.float32)
    L = rng.uniform(-0.9, 0.9, (2, 40)).astype(np.float32)
    t = lambda a: torch.from_numpy(a)
    jv = jr.vertical_vanishing_point(xy[0], up[0], xy[1], up[1])
    tv = tr.vertical_vanishing_point(t(xy[0]), t(up[0]), t(xy[1]), t(up[1]))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    for a, b in zip(tr.solve_focal(t(L), t(xy[2]), tv, t(c)), jr.solve_focal(L, xy[2], jv, c)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    f = np.abs(rng.normal(60, 20, (2, 40))).astype(np.float32)
    for a, b in zip(tr.solve_rp(tv, t(c), t(f)), jr.solve_rp(jv, c, f)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_gradient_descent_matches_jax():
    data = make_data(seed=3)
    jres = jax.jit(lambda d: jgd.run_gradient_descent(d, jgd.GDConfig(num_steps=150)))(
        {k: jnp.asarray(v) for k, v in data.items()})
    tres = tgd.run_gradient_descent(_torch(data), tgd.GDConfig(num_steps=150))
    jc, tc = np.asarray(jres.costs), tres.costs.numpy()
    assert tc.shape == jc.shape == (150, 2)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-4 * float(jc[0].min()))
    for attr in ("roll", "pitch"):
        np.testing.assert_allclose(getattr(tres.gravity, attr).numpy(),
                                   np.asarray(getattr(jres.gravity, attr)), atol=1e-4)
    np.testing.assert_allclose(tres.camera.vfov.numpy(), np.asarray(jres.camera.vfov), atol=1e-4)


def test_vfov_clip_gradient_at_its_bounds_matches_jax():
    """min(max(v, 5°), 170°) gives 1/2 at a bound, as JAX's gradient of jnp.clip."""
    v = np.array([np.radians(5.0), 0.01, 1.0, np.radians(170.0), 3.1], np.float32)
    jg = jax.grad(lambda x: jnp.clip(x, jnp.radians(5.0), jnp.radians(170.0)).sum())(jnp.asarray(v))
    x = torch.from_numpy(v).requires_grad_()
    (tg,) = torch.autograd.grad(tgd._clip_vfov(x).sum(), x)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


def test_conversions_and_strided_grid_match_jax():
    rng = np.random.default_rng(5)
    pitch, f = rng.uniform(-1, 1, 8).astype(np.float32), rng.uniform(100, 900, 8).astype(np.float32)
    h = np.full(8, 480.0, np.float32)
    v = rng.normal(size=(8, 3)).astype(np.float32)
    t = torch.from_numpy
    pairs = [(tconv.rad2deg(t(pitch)), jconv.rad2deg(pitch)),
             (tconv.pitch2rho(t(pitch), t(f), t(h)), jconv.pitch2rho(pitch, f, h)),
             (tconv.rho2pitch(t(pitch), t(f), t(h)), jconv.rho2pitch(pitch, f, h)),
             (tconv.skew_symmetric(t(v)), jconv.skew_symmetric(v))]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    cam = {"height": np.full(3, 30.0, np.float32), "width": np.full(3, 45.0, np.float32),
           "f": rng.uniform(20, 60, 3).astype(np.float32)}
    for s in (1, 4, 7):
        a = tpf.strided_grid(Camera.from_dict({k: t(x) for k, x in cam.items()}), 30, 45, s)
        b = jpf.strided_grid(JCamera.from_dict({k: jnp.asarray(x) for k, x in cam.items()}), 30, 45, s)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6)


def _synth_images(n):
    from PIL import Image

    rows = (SYNTH / "test.csv").read_text().splitlines()[1:n + 1]
    return [np.asarray(Image.open(SYNTH / "images" / r.split(",")[0]).convert("RGB"),
                       np.float32) / 255.0 for r in rows]


def test_uvp_matches_jax_bit_for_bit():
    for img in _synth_images(4):
        ref = juvp.NativeUVP().estimate(img, np.array([0.0, 1.0, 0.0]))
        out = tuvp.NativeUVP().estimate(img, np.array([0.0, 1.0, 0.0]))
        assert out[0] == ref[0]
        np.testing.assert_array_equal(out[1], ref[1])
    jout = juvp.NativeUVP()({"image": img})
    tout = tuvp.NativeUVP()({"image": img})
    np.testing.assert_allclose(tout["camera"].data.numpy(), np.asarray(jout["camera"].data),
                               rtol=1e-6)
    np.testing.assert_array_equal(tout["gravity"].vec3d.numpy(), np.asarray(jout["gravity"].vec3d))


@pytest.mark.parametrize("cls", ["VPEstimator", "Dust3R"])
def test_gated_wrappers_raise_import_error(cls):
    with pytest.raises(ImportError, match="vp_estimation|VP-Estimation|dust3r"):
        getattr(jbaselines, cls)()  # the JAX package's own gate, for the record
    with pytest.raises(ImportError, match="VP-Estimation-with-Prior-Gravity|dust3r"):
        getattr(tbaselines, cls)()


def test_vp_line_detection_cv2_fallback():
    det = tbaselines.VPEstimator.__new__(tbaselines.VPEstimator)  # skip the package gate
    det.line_type = "lsd"
    img = np.zeros((120, 160), np.uint8)
    img[40:42, :] = 255
    img[:, 80:82] = 255
    lines = det._detect_lines(img)
    assert lines.ndim == 3 and lines.shape[1:] == (2, 2) and len(lines) >= 2


def _summaries_close(out, ref, rtol):
    assert set(out) == set(ref)
    for k, v in ref.items():
        if isinstance(v, str):
            assert out[k] == v, k
        else:
            np.testing.assert_allclose(out[k], v, rtol=rtol, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("method,rtol", [("trivial", 0), ("uvp", 1e-4)])
def test_evaluate_baseline_matches_jax(method, rtol, tmp_path):
    ref = jcli.evaluate_baseline(method, str(SYNTH), max_images=8)
    out = tcli.evaluate_baseline(method, str(SYNTH), max_images=8, device="cpu",
                                 experiment_dir=str(tmp_path))
    assert out["n_images"] == ref["n_images"] == 8
    _summaries_close(out, ref, rtol)
    assert (tmp_path / "summaries.json").exists()


def test_baselines_cli_main_writes_the_summary(tmp_path, capsys):
    tcli.main([str(SYNTH), "--method", "trivial", "--max_images", "8", "--device", "cpu",
               "--output", str(tmp_path / "out")])
    assert (tmp_path / "out" / "summaries.json").exists()
    assert '"method": "trivial"' in capsys.readouterr().out
