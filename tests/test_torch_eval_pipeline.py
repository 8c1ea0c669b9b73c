"""The eval slice as a whole, the port against the JAX package, on the CPU:
SimplePipeline on the first 8 rows of the committed data/openpano_synth test
split (batch 4), and BenchmarkPipeline (through evaluate_real_benchmark) on
mixed-size fixtures at resize 64, pinhole and simple_radial.

The tiny variant in float32, parameters from the JAX network's seeded init
carried across by params_from_jax; the JAX pipelines run their default
fused tower. Three JAX network compiles in all (one per pipeline and camera
model). Tolerances, set before any run, per image, with the stop_at rule of
tests/test_torch_calibrate.py: where both solvers stop at the same iteration,
every angle and *_error key in degrees within 0.012 (2e-4 rad); lanes that
stop one iteration apart within 0.6 (1e-2 rad); no lane further apart. The
GT columns within 1e-4 relative. The port's results.h5 holds JAX's keys and
names, and the port's summarize_results of JAX's per-image arrays equals
JAX's summaries.json exactly.
"""

import csv
import json
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geocalib_tpu.data.dataset import DatasetConf as JConf, SimpleDataset as JDataset
from geocalib_tpu.eval import pipeline as jpipe
from geocalib_tpu.models import GeoCalibNet as JNet
from geocalib_tpu.utils.image import write_image
from geocalib_tpu_torch.data.dataset import DatasetConf, SimpleDataset
from geocalib_tpu_torch.eval import pipeline as tpipe
from geocalib_tpu_torch.models import params_from_jax
from geocalib_tpu_torch.utils.tools import summarize_results

ROOT = Path(__file__).resolve().parents[1]
SYNTH = ROOT / "data" / "openpano_synth"
DEG_TOL, APART_TOL = 0.012, 0.6
DEGREE_KEYS = ("roll", "pitch", "vfov", "roll_error", "pitch_error", "gravity_error",
               "vfov_error")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work: under the parallel test
    run, torch's default of one thread per core, in every worker at once,
    oversubscribes the cores (a 2 s calibrate took 443 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    """The JAX tiny network's seeded init, and the same as the port's state_dict."""
    jparams = jax.jit(JNet(variant="tiny").init)({"params": jax.random.PRNGKey(0)},
                                                 jnp.zeros((1, 64, 64, 3)))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), "tiny")


def _read(path: Path):
    with h5py.File(path / "results.h5") as fh:
        results = {k: np.asarray(fh[k]) for k in fh if k != "names"}
        names = [n.decode() for n in fh["names"]]
    return results, names, json.loads((path / "summaries.json").read_text())


def _check(out_dir: Path, ref_dir: Path, gt_keys=()):
    out, out_names, out_summ = _read(out_dir)
    ref, ref_names, ref_summ = _read(ref_dir)
    assert set(out) == set(ref) and out_names == ref_names
    assert set(out_summ) == set(ref_summ)
    assert summarize_results(ref) == ref_summ
    stop, ref_stop = out["stop_at"], ref["stop_at"]
    assert np.all(np.abs(stop - ref_stop) <= 1), (stop, ref_stop)
    same = stop == ref_stop
    for k in DEGREE_KEYS:
        np.testing.assert_allclose(out[k][same], ref[k][same], rtol=0, atol=DEG_TOL, err_msg=k)
        np.testing.assert_allclose(out[k][~same], ref[k][~same], rtol=0, atol=APART_TOL,
                                   err_msg=k)
    for k in gt_keys:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, err_msg=k)
    return out, ref


def test_simple_pipeline_matches_jax(params, tmp_path):
    jparams, state = params
    with open(SYNTH / "test.csv") as fh:
        rows = list(csv.DictReader(fh))[:8]
    with open(tmp_path / "test.csv", "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    kw = dict(variant="tiny", compute_dtype="float32", batch_size=4)
    ds_kw = dict(dataset_dir=str(tmp_path), csv_name="test.csv", image_dir=str(SYNTH / "images"),
                 batch_size=4, shuffle=False, return_names=True)
    jpipe.SimplePipeline(jparams, jpipe.EvalConf(**kw)).run(JDataset(JConf(**ds_kw)),
                                                            str(tmp_path / "j"))
    summ = tpipe.SimplePipeline(state, tpipe.EvalConf(**kw), device="cpu").run(
        SimpleDataset(DatasetConf(**ds_kw)), str(tmp_path / "t"))
    out, _ = _check(tmp_path / "t", tmp_path / "j")
    assert summ == summarize_results(out)
    assert len(out["roll"]) == 8 and all(np.isfinite(v).all() for v in out.values())


SIZES = {"pinhole": [(480, 640), (640, 480), (720, 540), (480, 640), (480, 640)],
         "simple_radial": [(480, 640), (640, 480), (540, 720), (480, 640)]}


def _fixture(root: Path, model: str) -> Path:
    """The layouts of tests/test_benchmark_eval.py: images/ and images.csv, mixed
    sizes; the radial one with a GT k1."""
    (root / "images").mkdir(parents=True)
    rng = np.random.default_rng(0 if model == "pinhole" else 3)
    rows = []
    for i, (h, w) in enumerate(SIZES[model]):
        write_image(rng.uniform(0, 1, (h, w, 3)).astype(np.float32), root / "images" / f"{i}.jpg")
        row = {"fname": f"{i}.jpg", "height": h, "width": w, "vfov": rng.uniform(0.7, 1.2),
               "roll": rng.uniform(-0.4, 0.4), "pitch": rng.uniform(-0.4, 0.4)}
        if model != "pinhole":
            row |= {"k1": rng.uniform(-0.15, -0.02), "k2": 0.0}
        rows.append(row)
    with open(root / "images.csv", "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return root


@pytest.mark.parametrize("model", ["pinhole", "simple_radial"])
def test_benchmark_pipeline_matches_jax(params, tmp_path, model):
    jparams, state = params
    root = _fixture(tmp_path / "data", model)
    kw = dict(camera_model=model, resize=64, batch_size=2, variant="tiny",
              compute_dtype="float32")
    jpipe.evaluate_real_benchmark(jparams, str(root), experiment_dir=str(tmp_path / "j"), **kw)
    tpipe.evaluate_real_benchmark(state, str(root), experiment_dir=str(tmp_path / "t"),
                                  device="cpu", **kw)
    out, ref = _check(tmp_path / "t", tmp_path / "j", gt_keys=("roll_gt", "vfov_gt", "focal_gt"))
    assert len(out["roll"]) == len(SIZES[model])  # the padded lane is dropped
    pixel = [k for k in ref if k.startswith("pixel_")]
    assert len(pixel) == (8 if model != "pinhole" else 0)
    same = out["stop_at"] == ref["stop_at"]
    for k in pixel:
        assert np.abs(out[k][same] - ref[k][same]).max(initial=0.0) <= 2 / 4096, k
