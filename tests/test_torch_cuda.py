"""The CUDA kernels of geocalib_tpu_torch against their plain PyTorch versions.

These tests need a CUDA card (marker ``cuda``) and skip without one: a CUDA
kernel has no CPU mode. The file imports neither JAX nor the JAX package,
because the machine with the card has neither; run it there without the
repository's conftest (which configures JAX):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: the LM sums are taken in another order (rtol 1e-4 against the
largest entry); the NMF in float32 agrees to 1e-4 relative Frobenius error,
and in bf16, where every product rounds to 8 bits, to 2e-2.
"""

import numpy as np
import pytest
import torch

from geocalib_tpu_torch.geometry.camera import Camera
from geocalib_tpu_torch.geometry.gravity import Gravity
from geocalib_tpu_torch.geometry.perspective_fields import get_perspective_field
from geocalib_tpu_torch.ops.lm_system import OBS_KEYS, lm_system, lm_system_plain
from geocalib_tpu_torch.ops.nmf import nmf, nmf_plain, nmf_reconstruct
from geocalib_tpu_torch.optim.lm import LMConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _lm_inputs(model, B, h, w, dev, seed=0):
    rng = np.random.default_rng(seed)
    k1 = rng.uniform(-0.2, 0.0, B) if model != "pinhole" else np.zeros(B)
    cam = Camera.from_dict({"height": np.full(B, float(h)), "width": np.full(B, float(w)),
                            "vfov": rng.uniform(0.6, 1.4, B), "k1": k1}, model=model)
    grav = Gravity.from_rp(torch.from_numpy(rng.uniform(-0.4, 0.4, B)).float(),
                           torch.from_numpy(rng.uniform(-0.4, 0.4, B)).float())
    up, lat = get_perspective_field(cam, grav, h, w)
    noise = lambda t: t + torch.from_numpy(0.05 * rng.normal(size=t.shape)).float()
    up, lat = noise(up).reshape(B, -1, 2), noise(lat).reshape(B, -1)
    obs = {"up_x": up[..., 0], "up_y": up[..., 1], "lat_sin": torch.sin(lat),
           "up_conf": torch.from_numpy(rng.uniform(0.2, 1, (B, h * w))).float(),
           "lat_conf": torch.from_numpy(rng.uniform(0.2, 1, (B, h * w))).float()}
    obs = {k: v.contiguous().to(dev) for k, v in obs.items()}
    cam0 = Camera.from_dict({"height": np.full(B, float(h)), "width": np.full(B, float(w)),
                             "vfov": np.full(B, 1.0), "k1": k1 * 0.5}, model=model)
    cam0 = Camera.from_data(cam0.data.to(dev), model)
    return obs, cam0, Gravity.from_rp(torch.zeros(B, device=dev), torch.zeros(B, device=dev))


def _close(out, ref):
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * b.abs().max().item())


@pytest.mark.parametrize("model", ["pinhole", "simple_radial"])
@pytest.mark.parametrize("shape", [(3, 48, 40), (2, 61, 37)])  # the second has a ragged tail
@pytest.mark.parametrize("keys", [OBS_KEYS, ("up_x", "up_y"), ("lat_sin", "lat_conf")])
def test_lm_kernel_matches_plain(card, model, shape, keys):
    B, h, w = shape
    obs, cam, grav = _lm_inputs(model, B, h, w, card)
    obs = {k: obs[k] for k in keys}
    for loss, sph, logf, est_f in [("huber", True, True, True), ("squared", False, False, True),
                                   ("barron", True, False, False)]:
        cfg = LMConfig(camera_model=model, loss_fn=loss, estimate_focal=est_f)
        before = lm_system.launches
        out = lm_system(obs, cam, grav, h, w, cfg, sph, logf)
        assert lm_system.launches == before + 1
        _close(out, lm_system_plain(obs, cam, grav, h, w, cfg, sph, logf))


def test_lm_kernel_is_deterministic(card):
    obs, cam, grav = _lm_inputs("simple_radial", 4, 160, 200, card)
    cfg = LMConfig(camera_model="simple_radial")
    first = lm_system(obs, cam, grav, 160, 200, cfg)
    for a, b in zip(first, lm_system(obs, cam, grav, 160, 200, cfg)):
        assert torch.equal(a, b)


def _rel(a, b):
    return float(torch.linalg.norm((a.float() - b.float()).flatten())
                 / torch.linalg.norm(b.float().flatten()))


@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(2, 256, 64, 16), (3, 200, 120, 64), (2, 700, 512, 64)])
def test_nmf_kernel_matches_plain(card, dtype, bound, shape):
    B, N, D, R = shape
    rng = np.random.default_rng(4)
    x = torch.from_numpy(np.maximum(rng.normal(size=(B, N, D)), 0)).to(card, dtype)
    bases = torch.from_numpy(rng.uniform(size=(B, D, R))).to(card, dtype)
    before = nmf.launches
    coef, bt = nmf(x, bases, 7)
    assert nmf.launches == before + 1 and coef.dtype == dtype and bt.shape == (B, R, D)
    ref_coef, ref_bt = nmf_plain(x, bases, 7)
    assert _rel(torch.matmul(coef, bt), torch.matmul(ref_coef, ref_bt)) < bound
    assert _rel(nmf_reconstruct(x, bases, 0), torch.matmul(*nmf_plain(x, bases, 0))) < bound


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = torch.ones(1, 8, 4, device=card, dtype=torch.float16)
    with pytest.raises(ValueError):
        nmf(x, torch.ones(1, 4, 2, device=card, dtype=torch.float16))
    with pytest.raises(ValueError):
        nmf(x.float(), torch.ones(1, 4, 65, device=card))
    obs, cam, grav = _lm_inputs("pinhole", 1, 8, 8, card)
    with pytest.raises(ValueError):
        lm_system({"up_x": obs["up_x"]}, cam, grav, 8, 8, LMConfig())
