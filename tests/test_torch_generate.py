"""The port's dataset generation against the JAX package, on the CPU, with no
network: the procedural panoramas, the panorama renderer and its sampler, the
generator's CSV rows and crops, the committed datasets' rows, tonemapping,
the download and alignment helpers, and prepare_benchmark.

Inputs are made with numpy from a seed. Tolerances, set before any run:
- synthetic_pano and tonemapping are numpy in both packages: bit for bit;
- the render and the sampler: 1e-4 in value on a 64×128 noise pano. The
  pixel's world ray is rotated and turned into longitude and latitude in
  float32 in another order (two matrix products, atan2), which moves a
  sample by float32 rounding of its coordinates, and bilinear sampling is
  continuous there (measured: at most 1.4e-5). The sampler alone, on equal
  coordinates: 1e-6;
- where the crops sample at the committed training sets' and the module's
  default configurations (640×1280 and 768×1536 panoramas): within
  COORD_TOL = 1e-3 pano pixels on the sphere (``pano.sample_distance``:
  the longitude offset the short way round the seam and scaled by
  cos(latitude), since near a pole a rounding of the ray swings the
  longitude, and the seam's two columns are one direction). That is 8
  float32 ulps of a coordinate between 1024 and 2048 (measured: at most
  3.7e-4 against JAX; the raw column offset reaches 3.3e-2 next to a
  pole). The same bound holds the card's render against the CPU's in
  chip_smoke.py, where a value tolerance would not carry over: a 1280-wide
  pano's coordinate ulp is 1.2e-4 px, and at the seam the sample jumps to
  the other edge column;
- the CSVs: equal as text (the rows are sampled in numpy float32 in both);
- the committed data/openpano_synth_v2 (seed 1, pinhole) and
  data/openpano_radial_v2 (seed 2, simple_radial) train CSVs: their first 16
  rows, text for text.
"""

import csv
import io
import zipfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geocalib_tpu.data import align_megadepth as jalign
from geocalib_tpu.data import download as jdownload
from geocalib_tpu.data import generate as jgen
from geocalib_tpu.data import pano as jpano
from geocalib_tpu.data import tonemapping as jtone
from geocalib_tpu.eval import benchmarks as jbenchmarks
from geocalib_tpu.geometry.camera import Camera as JCamera
from geocalib_tpu.geometry.gravity import Gravity as JGravity
from geocalib_tpu_torch.data import align_megadepth as talign
from geocalib_tpu_torch.data import download as tdownload
from geocalib_tpu_torch.data import generate as tgen
from geocalib_tpu_torch.data import pano as tpano
from geocalib_tpu_torch.data import tonemapping as ttone
from geocalib_tpu_torch.eval import benchmarks as tbenchmarks
from geocalib_tpu_torch.geometry.camera import Camera
from geocalib_tpu_torch.geometry.gravity import Gravity

ROOT = Path(__file__).resolve().parents[1]
MODELS = ["pinhole", "simple_radial", "radial", "simple_divisional"]
RENDER_TOL = 1e-4
COORD_TOL = 1e-3
# seeds whose first draw picks each scene family (synthetic_pano: < 0.40 city,
# < 0.65 room, < 0.85 terrain, else the distant-city stripes)
FAMILIES = {"city": (2, 0.0, 0.40), "room": (0, 0.40, 0.65), "terrain": (5, 0.65, 0.85),
            "legacy": (4, 0.85, 1.0)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work (the parallel test run would
    oversubscribe the cores otherwise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("family", FAMILIES)
def test_synthetic_pano_matches_jax(family):
    seed, lo, hi = FAMILIES[family]
    assert lo <= np.random.default_rng(seed).random() < hi  # the seed picks this family
    out = tpano.synthetic_pano(seed, 64, 128)
    assert out.shape == (64, 128, 3) and out.dtype == np.float32
    assert np.array_equal(out, jpano.synthetic_pano(seed, 64, 128))


def test_bilinear_sample_matches_jax():
    """Points inside, on the border and outside the image (clamped as JAX clamps)."""
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(9, 13, 3)).astype(np.float32)
    x = np.concatenate([rng.uniform(-3, 16, 200), [0.0, 12.0, 12.5, -0.5, 11.99]]).astype(np.float32)
    y = np.concatenate([rng.uniform(-3, 12, 200), [0.0, 8.0, 8.5, 9.0, -0.01]]).astype(np.float32)
    out = tpano._bilinear_sample(torch.from_numpy(img), torch.from_numpy(x), torch.from_numpy(y))
    ref = np.asarray(jpano._bilinear_sample(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))
    assert out.shape == ref.shape == (205, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def _views(rng, B, model):
    params = {"height": np.full(B, 24.0, np.float32), "width": np.full(B, 32.0, np.float32),
              "vfov": rng.uniform(0.5, 1.8, B).astype(np.float32)}
    if model != "pinhole":
        params["k1"] = rng.uniform(-0.3, 0.1, B).astype(np.float32)
    if model == "radial":
        params["k2"] = rng.uniform(-0.05, 0.05, B).astype(np.float32)
    rp = rng.uniform(-0.8, 0.8, (2, B)).astype(np.float32)
    return params, rp, rng.uniform(0, 2 * np.pi, B).astype(np.float32)


@pytest.mark.parametrize("model", MODELS)
def test_render_from_pano_matches_jax(model):
    rng = np.random.default_rng(MODELS.index(model))
    pano = rng.uniform(size=(64, 128, 3)).astype(np.float32)
    params, (roll, pitch), yaw = _views(rng, 4, model)
    out = tpano.render_from_pano(
        torch.from_numpy(pano), Camera.from_dict({k: torch.from_numpy(v) for k, v in params.items()},
                                                 model=model),
        Gravity.from_rp(torch.from_numpy(roll), torch.from_numpy(pitch)), torch.from_numpy(yaw))
    ref = jpano.render_from_pano(
        jnp.asarray(pano), JCamera.from_dict({k: jnp.asarray(v) for k, v in params.items()},
                                             model=model),
        JGravity.from_rp(jnp.asarray(roll), jnp.asarray(pitch)), jnp.asarray(yaw))
    assert out.shape == (4, 24, 32, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=RENDER_TOL)


def _jax_coordinates(pano_size, camera, gravity, yaw):
    """The JAX package's sample coordinates: the lines of geocalib_tpu/data/pano.py
    render_from_pano before its sampler."""
    from geocalib_tpu.utils.conversions import rad2rotmat

    B = camera.batch_shape[0]
    h, w = int(camera.size[0, 1]), int(camera.size[0, 0])
    yaw = jnp.broadcast_to(jnp.asarray(yaw, jnp.float32), (B,))
    uv1, _ = camera.image2world(camera.pixel_coordinates(h, w))
    bearings = camera.pixel_bearing_many(uv1)
    zeros = jnp.zeros_like(yaw)
    rotated = jnp.einsum("bni,bij,bjk->bnk", bearings, gravity.R, rad2rotmat(zeros, zeros, yaw))
    lon = jnp.arctan2(rotated[..., 0], rotated[..., 2])
    lat = jnp.arctan2(rotated[..., 1], jnp.linalg.norm(rotated[..., ::2], axis=-1))
    Hp, Wp = pano_size
    return ((lon + jnp.pi) / (2 * jnp.pi) * (Wp - 1.0), (lat + jnp.pi / 2) / jnp.pi * (Hp - 1.0))


@pytest.mark.parametrize("model,seed,overrides,views", [
    ("pinhole", 1, dict(height=320, width=320, pano_height=640, pano_width=1280), 16),
    ("simple_radial", 2, dict(height=320, width=320, pano_height=640, pano_width=1280), 16),
    ("pinhole", 0, {}, 4)], ids=["synth_v2", "radial_v2", "defaults"])
def test_pano_coordinates_match_jax(model, seed, overrides, views):
    """The first panorama's crops of each chip_smoke.py generate configuration."""
    conf = tgen.dataset_conf(**overrides)
    task = _task("train", conf, model, seed)
    rows, yaw = tgen.sample_rows("synth0000", task)
    rows, yaw = rows[:views], yaw[:views]
    size = (conf["pano_height"], conf["pano_width"])
    out = tpano.pano_coordinates(size, *tgen.row_views(rows, yaw, model, "cpu"))
    col = lambda key: jnp.asarray([r[key] for r in rows], jnp.float32)
    ref = _jax_coordinates(size, JCamera.from_dict(
        {"height": col("height"), "width": col("width"), "vfov": col("vfov"), "k1": col("k1")},
        model=model), JGravity.from_rp(col("roll"), col("pitch")), jnp.asarray(yaw))
    ref = tuple(torch.from_numpy(np.array(r)) for r in ref)
    assert out[0].shape == (views, conf["height"] * conf["width"])
    dist = tpano.sample_distance(out, ref, size)
    assert float(dist.max()) <= COORD_TOL
    # the measure itself: the seam's two columns and a pole's row are one direction
    edge = (torch.tensor([0.0, size[1] - 1.0, 7.0]), torch.tensor([5.0, 5.0, 0.0]))
    other = (torch.tensor([size[1] - 1.0, 0.0, 300.0]), torch.tensor([5.0, 5.0, 0.0]))
    assert float(tpano.sample_distance(edge, other, size).max()) < 1e-4


def _task(split, conf, model, seed):
    return dict(split=split, conf=conf, camera_model=model, seed=seed)


def test_generate_dataset_matches_jax(tmp_path):
    """3 panoramas, 4 crops of 32² each from 64×128 panoramas, simple_radial (so k1 is
    sampled): the CSVs as text, the images' names, and each pano's crops before JPEG."""
    kw = dict(n_panos=3, height=32, width=32, crops_per_pano=4, pano_height=64, pano_width=128,
              camera_model="simple_radial", seed=3)
    tgen.generate_dataset(str(tmp_path / "torch"), device="cpu", **kw)
    jgen.generate_dataset(str(tmp_path / "jax"), **kw)
    for split in ("train", "val", "test"):
        assert (tmp_path / "torch" / f"{split}.csv").read_text() == \
            (tmp_path / "jax" / f"{split}.csv").read_text()
    names = sorted(p.name for p in (tmp_path / "torch" / "images").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax" / "images").iterdir())
    assert len(names) == 12

    conf = tgen.dataset_conf(**{k: kw[k] for k in ("height", "width", "crops_per_pano",
                                                    "pano_height", "pano_width")})
    panos = tgen.pano_sources(None, 3, kw["seed"])
    for split, src in zip(("train", "val", "test"), panos):
        task = dict(_task(split, conf, kw["camera_model"], kw["seed"]), pano=src)
        name, pano = tgen.load_pano(task)
        rows, crops = tgen.render_pano(task, name, pano, "cpu")
        _, yaw = tgen.sample_rows(name, task)
        col = lambda key: jnp.asarray([r[key] for r in rows], jnp.float32)
        ref = jpano.render_from_pano(
            jnp.asarray(pano), JCamera.from_dict({"height": col("height"), "width": col("width"),
                                                  "vfov": col("vfov"), "k1": col("k1")},
                                                 model=kw["camera_model"]),
            JGravity.from_rp(col("roll"), col("pitch")), jnp.asarray(yaw))
        assert crops.shape == (4, 32, 32, 3)
        np.testing.assert_allclose(crops.numpy(), np.asarray(ref), rtol=0, atol=RENDER_TOL)


@pytest.mark.parametrize("dataset,model,seed", [("openpano_synth_v2", "pinhole", 1),
                                                ("openpano_radial_v2", "simple_radial", 2)])
def test_committed_rows_reproduced(dataset, model, seed):
    """The first pano's 16 rows of the committed train CSV (320² crops, 640×1280
    panoramas), from render_pano on a small panorama (the rows do not depend on it)."""
    conf = tgen.dataset_conf(height=320, width=320, crops_per_pano=16, pano_height=640,
                             pano_width=1280)
    pano = np.random.default_rng(0).uniform(size=(16, 32, 3)).astype(np.float32)
    rows, crops = tgen.render_pano(_task("train", conf, model, seed), "synth0000", pano, "cpu")
    assert crops.shape == (16, 320, 320, 3) and bool(torch.isfinite(crops).all())
    buf = io.StringIO()
    writer = csv.DictWriter(buf, fieldnames=list(rows[0]))
    writer.writeheader()
    writer.writerows(rows)
    with open(ROOT / "data" / dataset / "train.csv", newline="") as fh:
        committed = "".join(fh.readlines()[:17])
    assert buf.getvalue() == committed


def test_tonemapping_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    hdr = (rng.lognormal(0.0, 2.0, (20, 30, 3)) * (rng.uniform(size=(20, 30, 3)) > 0.02))
    hdr = hdr.astype(np.float32)
    hdr[0, 0] = np.nan
    for op, kw in [("log", {}), ("log", {"exposure": 2.0, "percentile": 75.0}),
                   ("gamma", {}), ("gamma", {"gamma": 1.8})]:
        out = ttone.tonemap(hdr, op, **kw)
        assert np.array_equal(out, jtone.tonemap(hdr, op, **kw)), (op, kw)
    src = tmp_path / "hdr"
    src.mkdir()
    np.save(src / "pano0.npy", hdr)
    (src / "notes.txt").write_text("not a panorama")
    ttone.main(["--hdr_dir", str(src), "--out_dir", str(tmp_path / "t"), "--exposure", "1.5"])
    jtone.main(["--hdr_dir", str(src), "--out_dir", str(tmp_path / "j"), "--exposure", "1.5"])
    assert (tmp_path / "t" / "pano0.jpg").read_bytes() == (tmp_path / "j" / "pano0.jpg").read_bytes()


def test_download_and_align_without_network(tmp_path, monkeypatch):
    """A pano zip given by hand is extracted and flattened as the JAX package does; a
    missing colmap raises in both."""
    archive = tmp_path / "openpano.zip"
    with zipfile.ZipFile(archive, "w") as zf:
        for name in ("train/a.jpg", "val/b.png", "test/c.jpeg", "readme.txt"):
            zf.writestr(name, name)
    listing = {}
    for label, mod in (("torch", tdownload), ("jax", jdownload)):
        pano_dir = mod.download_openpano(str(tmp_path / label), pano_zip=str(archive))
        listing[label] = sorted(p.name for p in pano_dir.iterdir())
    assert listing["torch"] == listing["jax"] == ["a.jpg", "b.png", "c.jpeg"]
    monkeypatch.setattr("shutil.which", lambda name: None)
    for mod in (talign, jalign):
        with pytest.raises(RuntimeError, match="colmap not found"):
            mod.align_scene(tmp_path, tmp_path, tmp_path / "out")


def test_prepare_benchmark_generates_openpano_synth(tmp_path, monkeypatch):
    """A missing openpano_synth is generated with the JAX package's arguments (the
    generators are replaced here; the full 24-pano run is the slow test below)."""
    calls = {}

    def recorder(label):
        def generate(out_dir, **kw):
            calls[label] = (Path(out_dir).name, kw)
        return generate

    monkeypatch.setattr(tgen, "generate_dataset", recorder("torch"))
    monkeypatch.setattr(jgen, "generate_dataset", recorder("jax"))
    assert tbenchmarks.prepare_benchmark("openpano_synth", tmp_path / "t", device="cpu") == \
        tmp_path / "t" / "openpano_synth"
    jbenchmarks.prepare_benchmark("openpano_synth", tmp_path / "j")
    name, kw = calls["torch"]
    assert kw.pop("device") == "cpu"
    assert (name, kw) == calls["jax"]
    assert kw == {"n_panos": 24, "camera_model": "pinhole", "height": 320, "width": 320}


@pytest.mark.slow
def test_prepare_benchmark_openpano_synth_full(tmp_path):
    """The whole 24-pano openpano_synth set on the CPU, as a user's first benchmark run
    makes it: 640×1280 panoramas, 320² crops; the CSVs equal the JAX package's."""
    target = tbenchmarks.prepare_benchmark("openpano_synth", tmp_path / "t", device="cpu")
    jtarget = jbenchmarks.prepare_benchmark("openpano_synth", tmp_path / "j")
    for split in ("train", "val", "test"):
        assert (target / f"{split}.csv").read_text() == (jtarget / f"{split}.csv").read_text()
    rows = sum(len((target / f"{split}.csv").read_text().splitlines()) - 1
               for split in ("train", "val", "test"))
    # the splits take round(24 * 0.8), round(24 * 0.1) and round(24 * 0.1) panoramas
    assert len(list((target / "images").iterdir())) == rows == 16 * (19 + 2 + 2)
