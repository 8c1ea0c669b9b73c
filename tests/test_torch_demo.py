"""The port's demo against the JAX package's, on the CPU: undistort_image and
get_horizon_line, each frame overlay and render_overlays with every toggle
on, InteractiveDemo's keys, text and frames, the console report, annotate,
and the gated web app.

The scene is tests/test_demo_overlays.py's (a 96×128 noise frame, vFoV 1 rad,
k1 = -0.05, roll 0.1, pitch -0.2), for pinhole, simple_radial and
simple_divisional. The fields are computed once by the JAX package and given
to both demos; the camera work (horizon, projection, undistortion) is each
package's own. Tolerances, set before any run: undistort_image and the
horizon within 1e-4; an overlay frame may differ from JAX's (by more than
1e-4 in a channel) in at most 0.1% of its pixels, since a drawn line moves by
a pixel where a projected point sits at a rounding edge of np.round; text,
strings and annotate's figure exactly equal.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import matplotlib

matplotlib.use("Agg")
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from geocalib_tpu.demo import demo as jdemo  # noqa: E402
from geocalib_tpu.demo import gradio_app as jgradio  # noqa: E402
from geocalib_tpu.demo import overlays as jover  # noqa: E402
from geocalib_tpu.geometry.camera import Camera as JCamera  # noqa: E402
from geocalib_tpu.geometry.gravity import Gravity as JGravity  # noqa: E402
from geocalib_tpu.geometry.perspective_fields import get_horizon_line as jhorizon  # noqa: E402
from geocalib_tpu.geometry.perspective_fields import get_perspective_field  # noqa: E402
from geocalib_tpu_torch.demo import demo as tdemo  # noqa: E402
from geocalib_tpu_torch.demo import gradio_app as tgradio  # noqa: E402
from geocalib_tpu_torch.demo import overlays as tover  # noqa: E402
from geocalib_tpu_torch.geometry.camera import Camera  # noqa: E402
from geocalib_tpu_torch.geometry.gravity import Gravity  # noqa: E402
from geocalib_tpu_torch.geometry.perspective_fields import get_horizon_line  # noqa: E402

MODELS = ["pinhole", "simple_radial", "simple_divisional"]
H, W = 96, 128
VALUE_TOL = 1e-4
PIXEL_SHARE = 1e-3
TOGGLES = ("horizon", "up", "latitude", "confidence", "undistort", "grid", "box")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work (the parallel test run would
    oversubscribe the cores otherwise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=MODELS)
def scene(request):
    """(frame, port result, JAX result) of one camera model."""
    model = request.param
    params = {"height": float(H), "width": float(W), "vfov": 1.0, "k1": -0.05}
    jcam = JCamera.from_dict(params, model=model)
    jgrav = JGravity.from_rp(jnp.asarray(0.1), jnp.asarray(-0.2))
    frame = np.random.default_rng(0).uniform(0, 1, (H, W, 3)).astype(np.float32)
    up, lat = get_perspective_field(jax.tree.map(lambda x: jnp.asarray(x)[None], jcam),
                                    jax.tree.map(lambda x: jnp.asarray(x)[None], jgrav), H, W)
    fields = {"up_field": np.asarray(up[0]), "latitude_field": np.asarray(lat[0]),
              "latitude_confidence": np.random.default_rng(1).uniform(0.1, 1, (H, W)).astype(
                  np.float32)}
    tcam = Camera.from_data(torch.from_numpy(np.array(jcam.data)), model)
    tgrav = Gravity(torch.from_numpy(np.array(jgrav.vec3d)))
    tresult = {"camera": tcam, "gravity": tgrav,
               **{k: torch.from_numpy(v) for k, v in fields.items()}}
    jresult = {"camera": jcam, "gravity": jgrav, **fields}
    return frame, tresult, jresult


def _frames_close(out, ref):
    assert out.shape == ref.shape
    differ = (np.abs(np.asarray(out, np.float64) - ref) > VALUE_TOL).any(-1)
    assert differ.mean() <= PIXEL_SHARE, f"{differ.sum()} of {differ.size} pixels differ"


def test_undistort_image_matches_jax(scene):
    frame, tres, jres = scene
    out = tres["camera"][None].undistort_image(torch.from_numpy(frame)[None])
    ref = jax.tree.map(lambda x: x[None], jres["camera"]).undistort_image(jnp.asarray(frame)[None])
    assert out.shape == (1, H, W, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=VALUE_TOL)


def test_horizon_line_matches_jax(scene):
    _, tres, jres = scene
    for relative in (True, False):
        out = get_horizon_line(tres["camera"], tres["gravity"], relative)
        assert out.shape == (2,)
        np.testing.assert_allclose(out.numpy(), np.asarray(jhorizon(jres["camera"],
                                                                    jres["gravity"], relative)),
                                   rtol=0, atol=VALUE_TOL)


@pytest.mark.parametrize("overlay", ["up_field", "latitude", "confidence", "horizon", "grid",
                                     "box", "undistort_preview", "render_overlays"])
def test_overlay_matches_jax(scene, overlay):
    frame, tres, jres = scene

    def draw(mod, res):
        if overlay == "up_field":
            return mod.overlay_up_field(frame, res["up_field"])
        if overlay == "latitude":
            return mod.overlay_latitude(frame, res["latitude_field"])
        if overlay == "confidence":
            return mod.overlay_confidence(frame, res["latitude_confidence"])
        if overlay in ("horizon", "grid", "box"):
            return getattr(mod, f"overlay_{overlay}")(frame, res["camera"], res["gravity"])
        if overlay == "undistort_preview":
            return mod.undistort_preview(frame, res["camera"])
        return mod.render_overlays(frame, res, dict.fromkeys(TOGGLES, True))

    out, ref = draw(tover, tres), draw(jover, jres)
    assert isinstance(out, np.ndarray)
    _frames_close(out, ref)
    if overlay not in ("undistort_preview", "latitude", "confidence"):
        assert np.abs(out - frame).max() > 0.05  # it drew something


class _Stub:
    def __init__(self, result):
        self.result = result

    def calibrate(self, rgb, camera_model="pinhole"):
        return self.result


def test_interactive_demo_matches_jax(scene):
    frame, tres, jres = scene
    tdem, jdem = tdemo.InteractiveDemo(_Stub(tres)), jdemo.InteractiveDemo(_Stub(jres))
    for key in ["l", "2", "c", "d", "g", "b", "x", "3", "u", "1", "h", "h", "q", "\x1b"]:
        assert tdem.handle_key(key) == jdem.handle_key(key)
        assert tdem.toggles == jdem.toggles and tdem.camera_model == jdem.camera_model
        if key not in ("q", "\x1b"):
            assert tdem.format_results(tres) == jdem.format_results(jres)
    out, res = tdem.process_frame(frame)
    assert res is tres
    _frames_close(out, jdem.process_frame(frame)[0])


def test_print_calibration_matches_jax(scene):
    _, tres, jres = scene
    extra = {"roll_uncertainty": 0.01, "pitch_uncertainty": 0.02, "vfov_uncertainty": 0.03,
             "focal_uncertainty": 4.5}
    text = {}
    for label, mod, res in (("torch", tdemo, tres), ("jax", jdemo, jres)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.print_calibration({**res, **extra})
        text[label] = buf.getvalue()
    assert text["torch"] == text["jax"] and "Roll" in text["torch"]


def test_annotate_matches_jax(scene):
    frame, tres, jres = scene
    show = ("horizon", "up", "latitude")
    out = tdemo.annotate(torch.from_numpy(frame), tres, show)
    ref = jdemo.annotate(frame, jres, show)
    assert out.dtype == np.uint8 and out.shape == ref.shape and out.shape[-1] == 3
    assert np.array_equal(out, ref)


def test_web_app_is_gated(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "gradio", None)
    for mod in (tgradio, jgradio):
        with pytest.raises(RuntimeError, match="pip install gradio"):
            mod.build_app()


@pytest.mark.slow
def test_demo_main_on_committed_images(tmp_path):
    """The CLI end to end at MSCAN-B on the r05 weights, on the CPU: one committed
    image, calibrated, reported and annotated."""
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    img = sorted((root / "data" / "openpano_synth" / "images").glob("*.jpg"))[0]
    out = tmp_path / "annotated.jpg"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tdemo.main([str(img), "--out", str(out), "--device", "cpu",
                    "--weights", str(root / "weights" / "geocalib_synth_r05.msgpack")])
    assert "Roll" in buf.getvalue() and out.exists()
