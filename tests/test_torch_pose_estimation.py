"""The port's pose estimation against the JAX package's, on the five cases of
tests/test_pose_estimation.py.

Both modules are numpy on the host, the port's a copy, so every result is
compared exactly (rotations, translations, inlier masks, quaternions,
calibrations), and each case also keeps its accuracy check against the
scene's true pose.
"""

import numpy as np
import pytest
import torch

import geocalib_tpu.pose_estimation as jpose
import geocalib_tpu_torch.pose_estimation as tpose

from test_pose_estimation import CAM, G_W, _pose_errors, _scene


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _equal(a, b):
    """Exact equality of nested results (dicts, tuples, arrays, scalars)."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _gravity_minimal_exact(mod):
    R, t, X, p2d, g_cam = _scene(seed=1)
    ret = mod.estimate_absolute_pose_gravity(p2d, X, CAM, g_cam, G_W, max_reproj_error=2.0)
    assert ret["success"] and ret["num_inliers"] > 0.95 * len(p2d)
    ang, terr = _pose_errors(ret["R"], ret["tvec"], R, t)
    assert ang < 0.1 and terr < 0.01
    return ret


def _gravity_ransac_with_outliers_and_refinement(mod):
    R, t, X, p2d, g_cam = _scene(seed=2, noise=0.5, outliers=0.3)
    ret = mod.estimate_absolute_pose_gravity(p2d, X, CAM, g_cam, G_W, max_reproj_error=4.0)
    assert ret["success"]
    R2, t2 = mod.refine_pose_gravity(ret["R"], ret["tvec"], p2d, X, CAM, ret["inliers"],
                                     gravity_cam=g_cam, gravity_world=G_W,
                                     gravity_weight=50_000.0)
    ang, terr = _pose_errors(R2, t2, R, t)
    assert ang < 0.5 and terr < 0.05
    return ret, R2, t2


def _pnp_dlt_fallback(mod):
    R, t, X, p2d, _ = _scene(seed=3)
    ret = mod.estimate_absolute_pose(p2d, X, CAM, max_reproj_error=2.0)
    assert ret["success"]
    ang, terr = _pose_errors(ret["R"], ret["tvec"], R, t)
    assert ang < 0.5 and terr < 0.05
    return ret


def _quaternion_roundtrip(mod):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(10):
        v = rng.normal(size=3)
        R = mod.rotation_aligning(v, rng.normal(size=3)) @ mod.rot_z(rng.uniform(-3, 3))
        q = mod.quat_from_matrix(R)
        assert abs(np.linalg.norm(q) - 1) < 1e-9
        out.append((R, q))
    return out


def _estimator_driver_with_stub_calibrator(mod):
    """The driver with a stub calibrate(): gravity as a torch tensor, as the port's
    GeoCalib returns it, for the port; as numpy for the JAX package."""
    R, t, X, p2d, g_cam = _scene(seed=4, noise=0.3)
    as_tensor = mod is tpose

    class StubCalib:
        def calibrate(self, image, priors=None):
            class G:
                vec3d = torch.from_numpy(g_cam.astype(np.float32)) if as_tensor \
                    else g_cam.astype(np.float32)

            unc = torch.tensor(0.01) if as_tensor else np.float32(0.01)
            return {"gravity": G(), "gravity_uncertainty": unc}

    est = mod.AbsolutePoseEstimator(mod.PoseOpts(), calibrator=StubCalib())
    ret, calib = est(np.zeros((32, 32, 3), np.float32), p2d, X, CAM)
    assert ret["success"]
    ang, terr = _pose_errors(ret["R"], ret["tvec"], R, t)
    assert ang < 0.5 and terr < 0.05
    np.testing.assert_allclose(calib["gravity_vec"], g_cam, atol=1e-6)
    return ret, calib


CASES = [_gravity_minimal_exact, _gravity_ransac_with_outliers_and_refinement,
         _pnp_dlt_fallback, _quaternion_roundtrip, _estimator_driver_with_stub_calibrator]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__.strip("_") for c in CASES])
def test_pose_matches_jax(case):
    _equal(case(tpose), case(jpose))
