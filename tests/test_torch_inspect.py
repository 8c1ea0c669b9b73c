"""The port's eval inspector against the JAX package's, headless.

The port's ``SimplePipeline.run`` (tiny variant, float32, seeded random
weights, ``cache_fields``) writes results.h5 and predictions.h5 for four
views of the committed data/openpano_synth; both packages' inspectors read
that directory. Their ``ExperimentResults`` must hold the same metrics, names
and cached predictions, exactly; ``--save`` renders the scatter through Agg,
and the per-image frame too, pixel for pixel the JAX inspector's.
"""

import csv
from pathlib import Path

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

from geocalib_tpu.eval import inspect as jinspect  # noqa: E402
from geocalib_tpu_torch.data.dataset import DatasetConf, SimpleDataset  # noqa: E402
from geocalib_tpu_torch.eval import inspect as tinspect  # noqa: E402
from geocalib_tpu_torch.eval import pipeline as tpipe  # noqa: E402

SYNTH = Path(__file__).resolve().parents[1] / "data" / "openpano_synth"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    root = tmp_path_factory.mktemp("inspect")
    with open(SYNTH / "test.csv") as fh:
        rows = list(csv.DictReader(fh))[:4]
    with open(root / "test.csv", "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    torch.manual_seed(0)
    conf = tpipe.EvalConf(variant="tiny", compute_dtype="float32", batch_size=4,
                          cache_fields=True)
    ds = SimpleDataset(DatasetConf(dataset_dir=str(root), csv_name="test.csv",
                                   image_dir=str(SYNTH / "images"), batch_size=4,
                                   shuffle=False, return_names=True))
    tpipe.SimplePipeline(None, conf, device="cpu").run(ds, str(root / "exp"))
    return root / "exp"


def _pixels(fig) -> np.ndarray:
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba()).copy()


def test_experiment_results_match_jax(experiment):
    t, j = tinspect.ExperimentResults(str(experiment)), jinspect.ExperimentResults(str(experiment))
    assert t.names == j.names and len(t.names) == 4
    assert t.metric_keys() == j.metric_keys() and "roll_error" in t.metric_keys()
    for k in t.metric_keys():
        np.testing.assert_array_equal(t.metrics[k], j.metrics[k])
    for name in t.names:
        pt, pj = t.prediction(name), j.prediction(name)
        assert pt is not None and set(pt) == set(pj)
        for k in pt:
            np.testing.assert_array_equal(pt[k], pj[k])
    assert t.prediction("absent.jpg") is None


def test_save_renders_the_scatter_headless(experiment, tmp_path, capsys):
    out_t, out_j = tmp_path / "t.png", tmp_path / "j.png"
    tinspect.main([str(experiment), "--x", "roll_error", "--y", "pitch_error",
                   "--save", str(out_t)])
    assert f"saved {out_t}" in capsys.readouterr().out
    jinspect.main([str(experiment), "--x", "roll_error", "--y", "pitch_error",
                   "--save", str(out_j)])
    np.testing.assert_array_equal(plt.imread(out_t), plt.imread(out_j))
    with pytest.raises(SystemExit, match="not in results"):
        tinspect.main([str(experiment), "--x", "no_such_metric", "--save", str(out_t)])
    plt.close("all")


def test_image_frame_matches_jax(experiment):
    frames = []
    for mod in (tinspect, jinspect):
        res = mod.ExperimentResults(str(experiment))
        fig = mod.ImageFrame(res, 1, str(SYNTH / "images")).show()
        assert len(fig.axes) == 3
        frames.append(_pixels(fig))
        gf = mod.GlobalFrame([res], "roll_error", "pitch_error")
        gf.draw()
        assert list(gf._artists.values()) == [res]
    np.testing.assert_array_equal(frames[0], frames[1])
    plt.close("all")
