"""GeoCalib.calibrate with the solver options of the second slice, port against JAX.

Two end-to-end cases on the CPU, set up as in tests/test_torch_calibrate.py
(the tiny variant in float32 with the JAX GeoCalib's seeded parameters, a
(2, 64, 96, 3) image): the ``radial`` model with shared intrinsics, and the
``simple_divisional`` model started from the heuristic init. Each JAX
instance compiles its calibrate once, so there is one per init_mode, shared
by the module.

Tolerances are those of tests/test_torch_calibrate.py: roll, pitch, vFoV
and k1 within 2e-4 rad where both solvers stop at the same iteration, and
within 1e-2 where the early stop, which compares costs at the float32
resolution, fires one iteration apart.
"""

import jax
import numpy as np
import pytest

from geocalib_tpu.extractor import GeoCalib as JGeoCalib
from geocalib_tpu_torch import GeoCalib
from geocalib_tpu_torch.models import params_from_jax


@pytest.fixture(scope="module")
def pairs():
    made = {}

    def get(init_mode):
        if init_mode not in made:
            jcal = JGeoCalib(variant="tiny", compute_dtype="float32", init_mode=init_mode)
            sd = params_from_jax(jax.tree.map(np.asarray, jcal.params), "tiny")
            tcal = GeoCalib(weights=sd, device="cpu", compute_dtype="float32", variant="tiny",
                            init_mode=init_mode)
            made[init_mode] = (jcal, tcal)
        return made[init_mode]

    return get


@pytest.mark.parametrize("camera_model,init_mode,shared", [
    ("radial", "trivial", True),
    ("simple_divisional", "heuristic", False),
])
def test_calibrate_options_match_jax(pairs, camera_model, init_mode, shared):
    jcal, tcal = pairs(init_mode)
    assert tcal.optimizer_options == {"init_mode": init_mode}
    img = np.random.default_rng(5).uniform(size=(2, 64, 96, 3)).astype(np.float32)
    kw = dict(camera_model=camera_model, shared_intrinsics=shared, batched=True)
    ref = jcal.calibrate(img, **kw)
    out = tcal.calibrate(img, **kw)

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
    if shared:  # one camera for the batch, one stop_at
        f, k = out["camera"].f.numpy(), out["camera"].k.numpy()
        assert np.all(f == f[:1]) and np.all(k == k[:1]) and np.unique(stop).size == 1
    for k in ("up_field", "latitude_field", "up_confidence", "latitude_confidence"):
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=5e-4, err_msg=k)


def test_shared_intrinsics_needs_a_batch(pairs):
    _, tcal = pairs("trivial")
    img = np.zeros((64, 96, 3), np.float32)
    with pytest.raises(ValueError, match="batch"):
        tcal.calibrate(img, shared_intrinsics=True)
