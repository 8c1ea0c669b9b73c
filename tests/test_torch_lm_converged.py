"""The port's LM solver against the JAX package with the early stop off.

The premise of chip_smoke.py's whole-path gate: with ``early_stop=False`` both
solvers run the 30 fixed iterations, so the stop test |Δcost| <= 1e-8 +
1e-8·cost, which sits at the float32 ulp, drops out of the comparison, and the
port agrees with the reference in every lane. That includes the lane of
``tests/test_torch_lm.py::test_run_lm_matches_jax[None-simple_divisional]``
that stops one iteration apart with the early stop on. Fixtures are those of
tests/test_torch_lm.py (``_setup``, ``_run_both``), with no prior; roll, pitch
and vFoV agree to 2e-4 rad, as in the tiny ``calibrate`` tests.
"""

import numpy as np
import pytest

from test_torch_lm import MODELS, _run_both, _setup

ANGLE_ATOL = 2e-4  # rad


@pytest.mark.parametrize("model", MODELS)
def test_run_lm_converged_matches_jax(model):
    data, _, _, _, _ = _setup(model, B=4, h=24, w=32)
    jres, tres = _run_both(model, data, early_stop=False)
    for attr in ("roll", "pitch"):
        np.testing.assert_allclose(getattr(tres.gravity, attr).numpy(),
                                   np.asarray(getattr(jres.gravity, attr)), atol=ANGLE_ATOL,
                                   err_msg=attr)
    np.testing.assert_allclose(tres.camera.vfov.numpy(), np.asarray(jres.camera.vfov),
                               atol=ANGLE_ATOL, err_msg="vfov")
