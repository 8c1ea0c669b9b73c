"""GeoCalib.calibrate end to end, the port against the JAX package, on the CPU.

The tiny variant in float32, parameters from the JAX GeoCalib's own seeded
init carried across by params_from_jax, on a 64×96 image (the preprocessor
resizes it to 320×480). The network's fields agree to a few 1e-4
(test_torch_net) and both solvers run the same 30 float32 iterations, so
roll, pitch and vFoV agree to 2e-4 rad where both stop at the same
iteration.

The solver's convergence test, |Δcost| <= 1e-8 + 1e-8·cost, sits at the
float32 resolution of costs near 1e-2, so it can fire one iteration apart
when the sums are taken in another order: a random network's fields leave
the focal length drifting, and a lane then stops one step earlier or later
in one package than in the other. Such lanes must differ by exactly one
iteration and lie within 1e-2 rad (the size of one step there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geocalib_tpu.extractor import GeoCalib as JGeoCalib
from geocalib_tpu.utils.image import ImagePreprocessor as JPreprocessor
from geocalib_tpu_torch import GeoCalib
from geocalib_tpu_torch.models import params_from_jax
from geocalib_tpu_torch.utils.image import ImagePreprocessor


@pytest.fixture(scope="module")
def pair():
    jcal = JGeoCalib(variant="tiny", compute_dtype="float32")
    sd = params_from_jax(jax.tree.map(np.asarray, jcal.params), "tiny")
    tcal = GeoCalib(weights=sd, device="cpu", compute_dtype="float32", variant="tiny")
    return jcal, tcal


@pytest.mark.parametrize("shape", [(480, 640), (64, 96), (100, 70), (320, 320)])
def test_preprocessor_matches(shape):
    img = np.random.default_rng(0).uniform(size=shape + (3,)).astype(np.float32)
    ref = JPreprocessor()(img)
    out = ImagePreprocessor()(img)
    assert out["image"].shape == ref["image"].shape
    np.testing.assert_allclose(out["image"].numpy(), ref["image"], rtol=0, atol=1e-5)
    for k in ("scales", "crop_pad", "image_size", "original_image_size"):
        np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=1e-7, err_msg=k)


@pytest.mark.parametrize("camera_model,priors", [
    ("pinhole", None),
    ("simple_radial", {"focal": 90.0}),
    ("pinhole", {"gravity": [0.1, -0.98, 0.15]}),
])
def test_calibrate_matches_jax(pair, camera_model, priors):
    jcal, tcal = pair
    img = np.random.default_rng(3).uniform(size=(2, 64, 96, 3)).astype(np.float32)
    jp = dict(priors or {})
    if "gravity" in jp:
        g = np.asarray(jp["gravity"], np.float32)
        jp["gravity"] = g / np.linalg.norm(g)
    ref = jcal.calibrate(img, camera_model=camera_model, priors=jp or None, batched=True)
    out = tcal.calibrate(img, camera_model=camera_model, priors=jp or None, batched=True)
    stop, ref_stop = out["stop_at"].numpy(), np.asarray(ref["stop_at"])
    same = stop == ref_stop
    assert np.all(np.abs(stop - ref_stop) <= 1), (stop, ref_stop)
    for name, t, j in [("roll", out["gravity"].roll, ref["gravity"].roll),
                       ("pitch", out["gravity"].pitch, ref["gravity"].pitch),
                       ("vfov", out["camera"].vfov, ref["camera"].vfov),
                       ("k1", out["camera"].k[:, 0], ref["camera"].k[:, 0])]:
        t, j = t.numpy(), np.asarray(j)
        np.testing.assert_allclose(t[same], j[same], atol=2e-4, err_msg=name)
        np.testing.assert_allclose(t[~same], j[~same], atol=1e-2, err_msg=name)
    np.testing.assert_allclose(out["camera"].data.numpy()[same],
                               np.asarray(ref["camera"].data)[same], rtol=1e-4, atol=1e-3)
    for k in ("up_field", "latitude_field", "up_confidence", "latitude_confidence"):
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=5e-4, err_msg=k)


def test_single_image(pair):
    _, tcal = pair
    img = np.random.default_rng(4).uniform(size=(64, 96, 3)).astype(np.float32)
    out = tcal.calibrate(img)
    assert out["camera"].data.shape == (8,) and out["up_field"].shape == (64, 96, 2)
    assert np.isfinite(out["vfov_uncertainty"].item())


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: GeoCalib() would run there")
    with pytest.raises(RuntimeError, match="CUDA"):
        GeoCalib(variant="tiny")
