"""The port's evaluation modules against the JAX package, on the CPU, with no
network: the preprocessor's conf, the camera's projection methods, the eval
metrics, the AUC and summaries, the two datasets, the prediction cache,
calibrate_path, and the conventions of chip_smoke.py's rendered views.

Inputs are made with numpy from a seed, or read from the committed
data/openpano_synth files. Tolerances, set before any run: preprocessed
images within 1e-5, their scales, crop_pad and sizes within 1e-7 relative;
camera methods within 1e-5 relative with equal valid masks; continuous
metrics within 1e-4 relative, each pixel recall equal or within two points
of the 64×64 grid (2/4096: a grid point at a threshold or an image border
can fall either side in another float32 order); AUCs and summaries exactly
equal; dataset batches equal and benchmark GT cameras within 1e-6.
"""

import csv
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geocalib_tpu.data import benchmark as jbench
from geocalib_tpu.data import dataset as jdata
from geocalib_tpu.eval import metrics as jmetrics
from geocalib_tpu.geometry import camera as jcam
from geocalib_tpu.geometry import gravity as jgrav
from geocalib_tpu.geometry.perspective_fields import get_perspective_field
from geocalib_tpu.models import cache_loader as jcache
from geocalib_tpu.utils import image as jimage
from geocalib_tpu.utils import tools as jtools
from geocalib_tpu_torch import GeoCalib
from geocalib_tpu_torch.data import benchmark as tbench
from geocalib_tpu_torch.data import dataset as tdata
from geocalib_tpu_torch.eval import benchmarks as tbenchmarks
from geocalib_tpu_torch.eval import metrics as tmetrics
from geocalib_tpu_torch.geometry import camera as tcam
from geocalib_tpu_torch.geometry import gravity as tgrav
from geocalib_tpu_torch.models import cache_loader as tcache
from geocalib_tpu_torch.utils import image as timage
from geocalib_tpu_torch.utils import tools as ttools

ROOT = Path(__file__).resolve().parents[1]
SYNTH = ROOT / "data" / "openpano_synth"
MODELS = ["pinhole", "simple_radial", "radial", "simple_divisional"]
RECALL_TOL = 2 / 4096


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work: under the parallel test
    run, torch's default of one thread per core, in every worker at once,
    oversubscribes the cores (a 2 s calibrate took 443 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ preprocessing

CONFS = [{"resize": 64}, {"resize": None}, {"side": "long"}, {"square_crop": True},
         {"edge_divisible_by": None}, {"antialias": False}]


@pytest.mark.parametrize("shape", [(480, 640), (640, 480), (720, 540), (100, 70)])
@pytest.mark.parametrize("conf", CONFS, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_preprocessor_conf_matches(conf, shape):
    img = np.random.default_rng(0).uniform(size=shape + (3,)).astype(np.float32)
    ref = jimage.ImagePreprocessor(jimage.PreprocessorConf(**conf))(img)
    out = timage.ImagePreprocessor(timage.PreprocessorConf(**conf))(img)
    assert out["image"].shape == ref["image"].shape
    np.testing.assert_allclose(out["image"].numpy(), ref["image"], rtol=0, atol=1e-5)
    for k in ("scales", "crop_pad", "image_size", "original_image_size"):
        np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=1e-7, err_msg=k)


def test_preprocessor_batch_equals_single_images():
    imgs = np.random.default_rng(1).uniform(size=(3, 100, 70, 3)).astype(np.float32)
    pre = timage.ImagePreprocessor(resize=64, side="long")
    batch = pre(imgs)
    for i, img in enumerate(imgs):
        one = pre(img)
        assert torch.equal(batch["image"][i], one["image"])
        for k in ("scales", "crop_pad", "image_size", "original_image_size"):
            assert torch.equal(batch[k], one[k]), k


def test_image_io_matches(tmp_path):
    img = np.random.default_rng(2).uniform(size=(30, 40, 3)).astype(np.float32)
    jimage.write_image(img, tmp_path / "j.png")
    timage.write_image(torch.from_numpy(img), tmp_path / "t.png")
    ref = jimage.load_image(tmp_path / "j.png")
    out = timage.load_image(tmp_path / "t.png")
    assert out.dtype == torch.float32 and np.array_equal(out.numpy(), ref)
    jpg = sorted((SYNTH / "images").glob("*.jpg"))[0]
    assert np.array_equal(timage.load_image(jpg).numpy(), jimage.load_image(jpg))


# ------------------------------------------------------------------ camera methods

def _cameras(model, B=3, seed=0, size=(48.0, 64.0)):
    rng = np.random.default_rng(seed)
    h = rng.uniform(*size, B).astype(np.float32).round()
    p = {"height": h, "width": (h * rng.uniform(0.7, 1.5, B)).round().astype(np.float32),
         "vfov": rng.uniform(0.6, 1.4, B).astype(np.float32)}
    if model != "pinhole":
        p["k1"] = rng.uniform(-0.3, 0.3, B).astype(np.float32)
    if model == "radial":
        p["k2"] = rng.uniform(-0.1, 0.1, B).astype(np.float32)
    jc = jcam.Camera.from_dict({k: jnp.asarray(v) for k, v in p.items()}, model=model)
    tc = tcam.Camera.from_dict({k: torch.from_numpy(v) for k, v in p.items()}, model=model)
    return jc, tc


def _close(out, ref, err_msg="", rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=err_msg)


@pytest.mark.parametrize("model", MODELS)
def test_camera_projection_methods(model):
    jc, tc = _cameras(model)
    rng = np.random.default_rng(5)
    # rays in front, behind and at the depth guard; wide enough that some leave
    # the image and, for the division model, pass its square-root clip
    p3d = rng.uniform(-1.5, 1.5, (3, 200, 3)).astype(np.float32)
    p3d[:, :150, 2] = rng.uniform(0.2, 2.0, (3, 150))
    p3d[:, 190:, 2] = 1e-3
    jp, tp = jnp.asarray(p3d), torch.from_numpy(p3d)

    (j2, jv), (t2, tv) = jc.project(jp), tc.project(tp)
    _close(t2, j2, "project")
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    (jd, jdv), (td, tdv) = jc.distort(j2), tc.distort(t2)
    _close(td, jd, "distort")
    assert np.array_equal(tdv.numpy(), np.asarray(jdv))
    _close(tc.denormalize(td), jc.denormalize(jd), "denormalize")
    pix = jc.denormalize(jd)
    assert np.array_equal(tc.in_image(torch.tensor(np.asarray(pix))).numpy(),
                          np.asarray(jc.in_image(pix)))
    (jw, jwv), (tw, twv) = jc.world2image(jp), tc.world2image(tp)
    _close(tw, jw, "world2image")
    assert np.array_equal(twv.numpy(), np.asarray(jwv))
    assert 0 < twv.sum() < twv.numel()
    jpin, tpin = jc.pinhole(), tc.pinhole()
    assert tpin.model == jpin.model == "pinhole"
    _close(tpin.data, jpin.data, "pinhole")


@pytest.mark.parametrize("k1", [0.6, 2.9])
def test_divisional_distort_guard_matches(k1):
    """The division model's clip of 1 - 4 k1 r² at 1e-6 branches as in the JAX package."""
    p = {"height": np.array([40.0], np.float32), "width": np.array([50.0], np.float32),
         "vfov": np.array([1.2], np.float32), "k1": np.array([k1], np.float32)}
    jc = jcam.Camera.from_dict({k: jnp.asarray(v) for k, v in p.items()}, "simple_divisional")
    tc = tcam.Camera.from_dict({k: torch.from_numpy(v) for k, v in p.items()},
                               "simple_divisional")
    r = np.linspace(0.0, 1.0, 400, dtype=np.float32)
    pts = np.stack([r, 0.5 * r], -1)[None]
    (jd, _), (td, _) = jc.distort(jnp.asarray(pts)), tc.distort(torch.from_numpy(pts))
    clipped = 1.0 - 4.0 * k1 * (pts**2).sum(-1) < 1e-6
    assert clipped.any() and not clipped.all()
    _close(td, jd)


# ------------------------------------------------------------------ metrics

def _pred_cameras(model, seed):
    """GT and predicted cameras, each in both packages; the prediction near the GT."""
    jgt, tgt = _cameras(model, seed=seed, size=(400.0, 700.0))
    rng = np.random.default_rng(seed + 1)
    data = np.asarray(jgt.data).copy()
    data[:, 2:4] *= rng.uniform(0.9, 1.1, (3, 1))
    data[:, 6:8] += rng.uniform(-0.05, 0.05, (3, 2)) * (model != "pinhole")
    return (jcam.Camera.from_data(jnp.asarray(data), model), jgt,
            tcam.Camera.from_data(torch.from_numpy(data), model), tgt)


def _check_metrics(out, ref):
    assert set(out) == set(ref)
    for k in ref:
        t, j = out[k].numpy(), np.asarray(ref[k])
        if k.startswith("pixel_"):
            assert np.abs(t - j).max() <= RECALL_TOL, (k, t, j)
        else:
            _close(t, j, k, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("model", MODELS)
def test_camera_and_gravity_metrics(model):
    jpred, jgt, tpred, tgt = _pred_cameras(model, seed=7)
    _check_metrics(tmetrics.camera_metrics(tpred, tgt), jmetrics.camera_metrics(jpred, jgt))
    for distortion_only in (False, True):
        ref = jmetrics.pixel_projection_errors(jpred, jgt, distortion_only=distortion_only)
        out = tmetrics.pixel_projection_errors(tpred, tgt, distortion_only=distortion_only)
        valid = np.asarray(ref["valid"]) & out["valid"].numpy()
        # a distance between two float32 pixel positions: a few ulps of the image size
        ulps = 4 * np.spacing(np.asarray(jgt.size).max())
        _close(out["dist"].numpy()[valid], np.asarray(ref["dist"])[valid], "dist",
               rtol=1e-4, atol=ulps)
        for k in ("valid", "valid_gt"):
            assert np.mean(out[k].numpy() != np.asarray(ref[k])) <= RECALL_TOL, k
    rp = np.random.default_rng(8).uniform(-0.6, 0.6, (2, 2, 3)).astype(np.float32)
    rp[0, 0, 0] = 3.1  # roll wraps around ±180°
    rp[1, 0, 0] = -3.1
    jg = [jgrav.Gravity.from_rp(jnp.asarray(r), jnp.asarray(p)) for r, p in rp]
    tg = [tgrav.Gravity.from_rp(torch.from_numpy(r), torch.from_numpy(p)) for r, p in rp]
    _check_metrics(tmetrics.gravity_metrics(*tg), jmetrics.gravity_metrics(*jg))


def test_pixel_projection_identical_cameras():
    """The JAX package's own fixture (tests/test_data_eval.py) on the port."""
    cam = tcam.Camera.from_dict({"height": torch.full((2,), 64.0), "width": torch.full((2,), 64.0),
                                 "vfov": torch.full((2,), 1.0), "k1": torch.full((2,), -0.1)},
                                model="simple_radial")
    assert float(tmetrics.pixel_projection_errors(cam, cam, n=16)["dist"].max()) < 1e-3
    assert float(tmetrics.camera_metrics(cam, cam)["pixel_projection_error@1"].min()) > 0.99


# ------------------------------------------------------------------ AUC and summaries

def _errors(seed, n=200):
    rng = np.random.default_rng(seed)
    e = np.abs(rng.standard_cauchy(n)) * rng.uniform(0.5, 4.0)
    e[rng.choice(n, 7, replace=False)] = np.nan
    return e.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auc_and_summaries_equal(seed):
    e = _errors(seed)
    finite = e[~np.isnan(e)]
    for min_error in (None, 1.0, 0.3):
        assert ttools.compute_auc(finite, [1, 5, 10], min_error) == \
            jtools.compute_auc(finite, [1, 5, 10], min_error)
    assert ttools.AUCMetric([1, 5, 10], e, min_error=1).compute() == \
        jtools.AUCMetric([1, 5, 10], e, min_error=1).compute()
    for t_cls, j_cls in [(ttools.AverageMetric, jtools.AverageMetric),
                         (ttools.MedianMetric, jtools.MedianMetric)]:
        t, j = t_cls(), j_cls()
        for chunk in np.array_split(e, 3):
            t.update(chunk)
            j.update(chunk)
        assert t.compute() == j.compute()
    q = (ttools.QuantileMetric(0.25), jtools.QuantileMetric(0.25))
    r = (ttools.RecallMetric([1, 5]), jtools.RecallMetric([1, 5]))
    for m in (*q, *r):
        m.update(e)
    assert q[0].compute() == q[1].compute() and r[0].compute() == r[1].compute()
    results = {"roll_error": e, "vfov_error": _errors(seed + 10), "focal_error": _errors(seed + 20),
               "pixel_projection_error@1": np.random.default_rng(seed).uniform(size=200),
               "stop_at": np.arange(200.0), "names": np.array(["x"] * 200)}
    assert ttools.summarize_results(results) == jtools.summarize_results(results)


def test_auc_fixtures():
    """The JAX package's own AUC fixtures (tests/test_data_eval.py) on the port."""
    assert ttools.AUCMetric([1, 5, 10], elements=np.zeros(100), min_error=1).compute() == [1, 1, 1]
    auc = ttools.compute_auc(np.full(100, 2.0), [1, 5, 10], min_error=1)
    assert auc[0] == 0.0
    np.testing.assert_allclose(auc[2], 0.8, atol=0.01)


# ------------------------------------------------------------------ datasets

def test_simple_dataset_matches():
    kw = dict(dataset_dir=str(SYNTH), csv_name="test.csv", batch_size=3, shuffle=True, seed=4,
              return_names=True)
    jds, tds = jdata.SimpleDataset(jdata.DatasetConf(**kw)), tdata.SimpleDataset(**kw)
    assert len(tds) == len(jds) == 512
    for epoch, shard, start in [(0, 1, 1), (2, 0, 0)]:
        jit, tit = jds.epoch(epoch, shard, 2, start), tds.epoch(epoch, shard, 2, start)
        for _ in range(2):
            ref, out = next(jit), next(tit)
            assert out["names"] == ref["names"]
            assert out["image"].shape == (3, 320, 320, 3)
            assert np.array_equal(out["image"].numpy(), ref["image"])
            assert np.array_equal(out["gt_params"].numpy(), ref["gt_params"])
    with pytest.raises(ValueError, match="unknown augmentation"):
        tdata.SimpleDataset(dataset_dir=str(SYNTH), csv_name="test.csv", augmentation="sepia")
    kw.update(augmentation="geocalib", batch_size=2)
    ref = next(jdata.SimpleDataset(jdata.DatasetConf(**kw)).epoch(1))
    out = next(tdata.SimpleDataset(**kw).epoch(1))
    assert np.array_equal(out["image"].numpy(), ref["image"])


SIZES = [(480, 640), (640, 480), (720, 540), (480, 640), (480, 640)]


@pytest.fixture(scope="module")
def benchmark_dir(tmp_path_factory):
    """The lamar2k layout with mixed sizes, built as tests/test_benchmark_eval.py
    builds it, with a k1 column and a principal point on one row."""
    root = tmp_path_factory.mktemp("lamar2k_fixture")
    (root / "images").mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i, (h, w) in enumerate(SIZES):
        jimage.write_image(rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
                           root / "images" / f"img_{i}.jpg")
        rows.append({"fname": f"img_{i}.jpg", "height": h, "width": w,
                     "vfov": rng.uniform(0.6, 1.4), "roll": rng.uniform(-0.5, 0.5),
                     "pitch": rng.uniform(-0.5, 0.5), "k1": rng.uniform(-0.1, 0.0),
                     "px": "", "py": ""})
    rows[1]["px"], rows[1]["py"] = 250.0, 310.0
    with open(root / "images.csv", "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return root


@pytest.mark.parametrize("resize,batch_size", [(64, 2), (320, 2), (320, 4)])
def test_benchmark_dataset_matches(benchmark_dir, resize, batch_size):
    kw = dict(dataset_dir=str(benchmark_dir), batch_size=batch_size, resize=resize)
    jds = jbench.BenchmarkDataset(jbench.BenchmarkDataConf(**kw))
    tds = tbench.BenchmarkDataset(tbench.BenchmarkDataConf(**kw))
    assert tds._buckets() == jds._buckets()
    refs, outs = list(jds.batches()), list(tds.batches())
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        assert out["names"] == ref["names"]
        assert np.array_equal(out["valid"], ref["valid"])
        assert out["image"].shape == ref["image"].shape
        np.testing.assert_allclose(out["image"].numpy(), ref["image"], rtol=0, atol=1e-5)
        for k in ("scales", "crop_pad"):
            np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=1e-7, err_msg=k)
        for k in ("gt_cam", "gt_rp"):
            np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=1e-6, err_msg=k)


# ------------------------------------------------------------------ cache, CLI, calibrate_path

def test_prediction_cache_round_trip(tmp_path):
    rng = np.random.default_rng(9)
    preds = {name: {"up_field": rng.normal(size=(4, 5, 2)).astype(np.float32),
                    "roll": np.float32(rng.normal())}
             for name in ("a.jpg", "scene/b.jpg", "scene/deep/c.jpg")}
    tcache.export_predictions(tmp_path / "t.h5", preds)
    jcache.export_predictions(tmp_path / "j.h5", preds)
    for path in ("t.h5", "j.h5"):
        loader, ref = tcache.CacheLoader(tmp_path / path), jcache.CacheLoader(tmp_path / path)
        try:
            assert sorted(loader.names()) == sorted(ref.names()) == sorted(preds)
            for name, pred in preds.items():
                got = loader(name)
                assert set(got) == set(pred)
                for k, v in pred.items():
                    assert np.array_equal(got[k], v) and np.array_equal(got[k], ref(name)[k])
            assert set(tcache.CacheLoader(tmp_path / path, keys=["roll"])("a.jpg")) == {"roll"}
        finally:
            loader.close()
            ref.close()


def test_prepare_benchmark(tmp_path):
    assert tbenchmarks.prepare_benchmark("openpano_synth", ROOT / "data") == SYNTH
    with pytest.raises(FileNotFoundError, match="geocalib_tpu.data.generate"):
        tbenchmarks.prepare_benchmark("openpano_synth", tmp_path)
    assert set(tbenchmarks.BENCHMARKS) == {
        "lamar2k", "megadepth2k", "megadepth2k_radial", "tartanair", "stanford2d3d",
        "openpano", "openpano_radial", "openpano_synth"}


def test_calibrate_path_is_calibrate_of_load_image(tmp_path):
    torch.manual_seed(0)
    calib = GeoCalib(device="cpu", compute_dtype="float32", variant="tiny")
    img = np.random.default_rng(3).uniform(size=(48, 72, 3)).astype(np.float32)
    timage.write_image(img, tmp_path / "view.png")
    out = calib.calibrate_path(tmp_path / "view.png", camera_model="simple_radial")
    ref = calib.calibrate(timage.load_image(tmp_path / "view.png"), camera_model="simple_radial")
    assert set(out) == set(ref)
    assert torch.equal(out["camera"].data, ref["camera"].data)
    assert torch.equal(out["gravity"].vec3d, ref["gravity"].vec3d)
    for k, v in ref.items():
        if torch.is_tensor(v):
            assert torch.equal(out[k], v), k


# ------------------------------------------------------------------ chip_smoke's views

@pytest.mark.parametrize("roll,pitch,vfov", [(0.25, -0.2, 0.9), (-0.1, 0.3, 1.25)])
def test_smoke_views_follow_package_conventions(roll, pitch, vfov):
    """chip_smoke.view_rays(roll, pitch, vfov) sees the world as the package's camera
    and gravity of the same roll, pitch and vFoV do: the sine of each pixel's
    latitude, -y of its world ray, equals the package's latitude field. The views
    sample pixel centers (x + 0.5), the package pixel corners (x), so the package's
    camera has its principal point half a pixel up and left of the center."""
    from chip_smoke import view_rays

    h, w = 24, 32
    world = view_rays(h, w, roll, pitch, vfov)
    sin_lat = -world[..., 1] / np.linalg.norm(world, axis=-1)
    cam = jcam.Camera.from_dict({"height": jnp.array([h * 1.0]), "width": jnp.array([w * 1.0]),
                                 "vfov": jnp.array([vfov]), "cx": jnp.array([w / 2 - 0.5]),
                                 "cy": jnp.array([h / 2 - 0.5])})
    grav = jgrav.Gravity.from_rp(jnp.array([roll]), jnp.array([pitch]))
    _, lat = get_perspective_field(cam, grav, h, w)
    np.testing.assert_allclose(np.sin(np.asarray(lat[0, ..., 0])), sin_lat, atol=1e-5)
