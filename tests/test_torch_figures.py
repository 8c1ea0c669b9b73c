"""The port's figures against the JAX package's, on the CPU: every viz2d
function and make_perspective_figures on the same seeded arrays, drawn by
matplotlib's Agg to RGBA and held pixel for pixel; the metrics writer's
figure files; and the training loop's figures (tiny variant, 2 steps,
figures with every validation) under the names JAX's writer gives them.

The port's functions get torch tensors and cameras, the JAX package's the
same values as arrays and its own cameras. The horizon line is the one
computed value drawn: both packages compute it in float32, and a line that
moves by float32 rounding stays on the same pixels at Agg's 1/256-pixel
precision.
"""

import sys

import matplotlib

matplotlib.use("Agg")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from geocalib_tpu.geometry.camera import Camera as JCamera  # noqa: E402
from geocalib_tpu.geometry.gravity import Gravity as JGravity  # noqa: E402
from geocalib_tpu.utils.summary_writer import SummaryWriter as JWriter  # noqa: E402
from geocalib_tpu.visualization import visualize_batch as jbatch  # noqa: E402
from geocalib_tpu.visualization import viz2d as jviz  # noqa: E402
from geocalib_tpu_torch.data.generate import generate_dataset  # noqa: E402
from geocalib_tpu_torch.geometry.camera import Camera  # noqa: E402
from geocalib_tpu_torch.geometry.gravity import Gravity  # noqa: E402
from geocalib_tpu_torch.training import train as ttrain  # noqa: E402
from geocalib_tpu_torch.utils.config import merge  # noqa: E402
from geocalib_tpu_torch.utils.summary_writer import SummaryWriter as TWriter  # noqa: E402
from geocalib_tpu_torch.visualization import visualize_batch as tbatch  # noqa: E402
from geocalib_tpu_torch.visualization import viz2d as tviz  # noqa: E402

B, H, W = 3, 48, 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work (the parallel test run would
    oversubscribe the cores otherwise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rgba(fig) -> np.ndarray:
    fig.canvas.draw()
    out = np.asarray(fig.canvas.buffer_rgba()).copy()
    matplotlib.pyplot.close(fig)
    return out


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    up = rng.normal(size=(B, H, W, 2)).astype(np.float32)
    up /= np.linalg.norm(up, axis=-1, keepdims=True)
    return {"image": rng.uniform(size=(B, H, W, 3)).astype(np.float32),
            "up_field": up,
            "latitude_field": rng.uniform(-1.2, 1.2, (B, H, W, 1)).astype(np.float32),
            "confidence": rng.uniform(1e-4, 1.0, (B, H, W)).astype(np.float32),
            "pred_up": np.roll(up, 1, axis=-1),
            "pred_lat": rng.uniform(-1.2, 1.2, (B, H, W, 1)).astype(np.float32),
            "vfov": rng.uniform(0.6, 1.4, B).astype(np.float32),
            "k1": rng.uniform(-0.2, 0.0, B).astype(np.float32),
            "roll": rng.uniform(-0.5, 0.5, B).astype(np.float32),
            "pitch": rng.uniform(-0.4, 0.4, B).astype(np.float32)}


def _t(a, key):
    return [torch.from_numpy(x) for x in a[key]]


def _j(a, key):
    return [jnp.asarray(x) for x in a[key]]


def _cameras(a):
    params = {"height": np.full(B, float(H), np.float32), "width": np.full(B, float(W), np.float32),
              "vfov": a["vfov"], "k1": a["k1"]}
    return ((Camera.from_dict({k: torch.from_numpy(v) for k, v in params.items()}, "simple_radial"),
             Gravity.from_rp(torch.from_numpy(a["roll"]), torch.from_numpy(a["pitch"]))),
            (JCamera.from_dict({k: jnp.asarray(v) for k, v in params.items()}, "simple_radial"),
             JGravity.from_rp(jnp.asarray(a["roll"]), jnp.asarray(a["pitch"]))))


def _draw(viz, a, case, lib):
    conv = _t if lib == "torch" else _j
    (tcam, tgrav), (jcam, jgrav) = _cameras(a)
    cam, grav = (tcam, tgrav) if lib == "torch" else (jcam, jgrav)
    if case == "perspective_fields":
        return viz.plot_perspective_fields(conv(a, "image"), conv(a, "up_field"),
                                           conv(a, "latitude_field"), conv(a, "confidence"))[0]
    fig, axs = viz.plot_images(conv(a, "image"), titles=["a", "b", "c"])
    if case == "vector_fields":
        viz.plot_vector_fields(axs, conv(a, "up_field"), subsample=7, color="#cc3311")
    elif case == "latitudes":
        viz.plot_latitudes(axs, conv(a, "latitude_field"))
    elif case == "confidences":
        viz.plot_confidences(axs, conv(a, "confidence"))
    elif case == "horizon_lines":
        viz.plot_horizon_lines(axs, cam, grav)
    return fig


CASES = ["images", "vector_fields", "latitudes", "confidences", "horizon_lines",
         "perspective_fields"]


@pytest.mark.parametrize("case", CASES)
def test_viz2d_matches_jax(arrays, case):
    out = _rgba(_draw(tviz, arrays, case, "torch"))
    ref = _rgba(_draw(jviz, arrays, case, "jax"))
    assert out.shape == ref.shape and out.shape[-1] == 4
    assert np.array_equal(out, ref)


def test_horizon_line_values_match_jax(arrays):
    from geocalib_tpu.geometry.perspective_fields import get_horizon_line as jhorizon
    from geocalib_tpu_torch.geometry.perspective_fields import get_horizon_line

    (tcam, tgrav), (jcam, jgrav) = _cameras(arrays)
    for relative in (True, False):
        np.testing.assert_allclose(get_horizon_line(tcam, tgrav, relative).numpy(),
                                   np.asarray(jhorizon(jcam, jgrav, relative)), rtol=1e-5,
                                   atol=1e-5)


def test_save_plot_matches_jax(arrays, tmp_path):
    tviz.save_plot(_draw(tviz, arrays, "latitudes", "torch"), tmp_path / "t.png")
    jviz.save_plot(_draw(jviz, arrays, "latitudes", "jax"), tmp_path / "j.png")
    assert np.array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                          np.asarray(Image.open(tmp_path / "j.png")))


@pytest.mark.parametrize("n_pairs", [2, 3])
def test_make_perspective_figures_matches_jax(arrays, n_pairs):
    data = {k: arrays[k] for k in ("image", "up_field", "latitude_field")}
    pred = {"up_field": arrays["pred_up"], "latitude_field": arrays["pred_lat"]}
    tfigs = tbatch.make_perspective_figures({k: torch.from_numpy(v) for k, v in pred.items()},
                                            {k: torch.from_numpy(v) for k, v in data.items()},
                                            n_pairs)
    jfigs = jbatch.make_perspective_figures({k: jnp.asarray(v) for k, v in pred.items()},
                                            {k: jnp.asarray(v) for k, v in data.items()}, n_pairs)
    assert set(tfigs) == set(jfigs) == {"up_field", "latitude_field"}
    for k in tfigs:
        assert np.array_equal(_rgba(tfigs[k]), _rgba(jfigs[k])), k
    only_up = tbatch.make_perspective_figures({"up_field": torch.from_numpy(arrays["pred_up"])},
                                              data)
    assert set(only_up) == {"up_field"}
    matplotlib.pyplot.close("all")


@pytest.fixture()
def no_tensorboard(monkeypatch):
    """The writers fall back to PNG files, as where TensorBoard is not installed."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def test_writer_figure_files_match_jax(arrays, tmp_path, no_tensorboard):
    names = {}
    for label, writer_cls, viz in (("torch", TWriter, tviz), ("jax", JWriter, jviz)):
        writer = writer_cls(tmp_path / label)
        fig = _draw(viz, arrays, "latitudes", label)
        writer.add_figure("figures/latitude_field", fig, 7)
        writer.add_histogram("hist", arrays["vfov"], 7)
        writer.add_text("note", "text", 7)
        writer.close()
        matplotlib.pyplot.close(fig)
        names[label] = sorted(p.name for p in (tmp_path / label / "figures").iterdir())
    assert names["torch"] == names["jax"] == ["figures_latitude_field_7.png"]
    read = lambda label: np.asarray(Image.open(tmp_path / label / "figures" / names[label][0]))
    assert np.array_equal(read("torch"), read("jax"))


def test_training_writes_figures(tmp_path, no_tensorboard):
    """The default conf's figures at the tiny variant: 2 steps at 64², a validation
    and its figures at step 1."""
    ds = generate_dataset(str(tmp_path / "ds"), n_panos=3, height=64, width=64,
                          crops_per_pano=4, device="cpu")
    conf = merge(ttrain.default_conf, {
        "train": {"variant": "tiny", "lm_steps": 2, "input_size": 64, "total_steps": 2,
                  "log_every": 1, "eval_every": 1, "save_every": 100, "val_batches": 1,
                  "figures_every": 1, "drop_path_rate": 0.0, "warmup_steps": 1},
        "data": {"dataset_dir": str(ds), "batch_size": 2, "augmentation": "identity"}})
    ttrain.training(conf, tmp_path / "run", device="cpu")
    fig_dir = tmp_path / "run" / "logs" / "figures"
    names = sorted(p.name for p in fig_dir.iterdir())
    assert names == ["figures_latitude_field_1.png", "figures_up_field_1.png"]
    for name in names:
        img = np.asarray(Image.open(fig_dir / name))
        assert img.ndim == 3 and img.shape[0] > 100 and img.std() > 0
