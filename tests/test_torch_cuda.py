"""The CUDA kernels of geocalib_tpu_torch against their plain PyTorch versions.

These tests need a CUDA card (marker ``cuda``) and skip without one: a CUDA
kernel has no CPU mode. The file imports neither JAX nor the JAX package,
because the machine with the card has neither; run it there without the
repository's conftest (which configures JAX):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: the LM sums are taken in another order (rtol 1e-4 against the
largest entry); the NMF in float32 agrees to 1e-4 relative Frobenius error,
and in bf16, where every product rounds to 8 bits, to 2e-2. The LM kernel's
VJP differentiates the plain version recomputed on the same inputs, so its
gradients equal autograd's through the plain version to 1e-6 relative.
"""

import numpy as np
import pytest
import torch

from geocalib_tpu_torch.geometry.camera import Camera
from geocalib_tpu_torch.geometry.gravity import Gravity
from geocalib_tpu_torch.geometry import planar_fields as pf
from geocalib_tpu_torch.geometry.perspective_fields import get_perspective_field
from geocalib_tpu_torch.ops import build
from geocalib_tpu_torch.ops.lm_system import (LOSS_IDS, MODEL_IDS, OBS_KEYS, lm_system,
                                              lm_system_plain)
from geocalib_tpu_torch.ops.nmf import nmf, nmf_plain, nmf_reconstruct
from geocalib_tpu_torch.optim.lm import LMConfig

pytestmark = pytest.mark.cuda

MODELS = ["pinhole", "simple_radial", "radial", "simple_divisional"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _lm_inputs(model, B, h, w, dev, seed=0):
    rng = np.random.default_rng(seed)
    k1 = rng.uniform(-0.2, 0.0, B) if model != "pinhole" else np.zeros(B)
    k2 = np.random.default_rng(seed + 1).uniform(-0.1, 0.1, B) if model == "radial" else np.zeros(B)
    cam = Camera.from_dict({"height": np.full(B, float(h)), "width": np.full(B, float(w)),
                            "vfov": rng.uniform(0.6, 1.4, B), "k1": k1, "k2": k2}, model=model)
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
                             "vfov": np.full(B, 1.0), "k1": k1 * 0.5, "k2": k2 * 0.5},
                            model=model)
    cam0 = Camera.from_data(cam0.data.to(dev), model)
    return obs, cam0, Gravity.from_rp(torch.zeros(B, device=dev), torch.zeros(B, device=dev))


def _close(out, ref):
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * b.abs().max().item())


@pytest.mark.parametrize("model", MODELS)
# the second has a ragged tail; the third is wider than the kernel's column table (4096)
@pytest.mark.parametrize("shape", [(3, 48, 40), (2, 61, 37), (2, 3, 4500)])
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


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("shape", [(3, 48, 40), (2, 61, 37)])
@pytest.mark.parametrize("keys", [OBS_KEYS, ("up_x", "up_y"), ("lat_sin", "lat_conf")])
def test_lm_cost_kernel_matches_full_and_plain(card, model, shape, keys):
    """The cost-only instance (with_system=False): its cost is the full instance's bit for
    bit (the same sums in the same order), within the LM tolerance of the plain version,
    and G and H are zeros."""
    B, h, w = shape
    obs, cam, grav = _lm_inputs(model, B, h, w, card)
    obs = {k: obs[k] for k in keys}
    for loss in ("huber", "squared", "barron"):
        cfg = LMConfig(camera_model=model, loss_fn=loss)
        before = lm_system.cost_launches
        G, H, cost = lm_system(obs, cam, grav, h, w, cfg, with_system=False)
        assert lm_system.cost_launches == before + 1
        assert not G.any() and not H.any()
        assert torch.equal(cost, lm_system(obs, cam, grav, h, w, cfg)[2])
        _close((cost,), (lm_system_plain(obs, cam, grav, h, w, cfg, with_system=False)[2],))


def test_lm_kernel_divisional_guards(card):
    """simple_divisional at its guards: lane 0 has a pixel where 1 + k1 r² is exactly 0
    (u = 1, v = 0, k1 = -1), lanes 1 and 2 pixels where 1 - 4 k1 r² is clipped at 1e-6."""
    B, h, w = 3, 16, 16
    obs, _, _ = _lm_inputs("simple_divisional", B, h, w, card, seed=3)
    cam = Camera.from_data(torch.tensor([[16.0, 16, 4, 4, 8, 8, -1.0, 0],
                                         [16.0, 16, 4, 4, 8, 8, 0.25, 0],
                                         [16.0, 16, 6, 6, 8, 8, 0.3, 0]], device=card),
                           "simple_divisional")
    grav = Gravity.from_rp(torch.tensor([0.1, -0.2, 0.3], device=card),
                           torch.tensor([0.2, 0.1, -0.1], device=card))
    for loss, sph, logf in [("huber", True, True), ("squared", False, False)]:
        cfg = LMConfig(camera_model="simple_divisional", loss_fn=loss)
        out = lm_system(obs, cam, grav, h, w, cfg, sph, logf)
        assert all(bool(torch.isfinite(t).all()) for t in out)
        _close(out, lm_system_plain(obs, cam, grav, h, w, cfg, sph, logf))


def _call_entry(obs, cam, grav, h, w, model_id, P):
    """gc_lm_system called directly, past the wrapper's checks; returns its cudaError_t."""
    B, N = cam.f.shape[0], h * w
    dev = cam.f.device
    M = pf.manifold_matrix(grav, True).reshape(B, 6).contiguous()
    G, H, cost = (torch.full(s, float("nan"), device=dev) for s in ((B, P), (B, P, P), (B,)))
    code = build.lib().gc_lm_system(
        *(build.ptr(obs.get(k)) for k in OBS_KEYS), cam.data.contiguous().data_ptr(),
        grav.vec3d.contiguous().data_ptr(), M.data_ptr(), G.data_ptr(), H.data_ptr(),
        cost.data_ptr(), B, N, w, model_id, P, LOSS_IDS["huber"], 1e-2, 1e-2, (1 << P) - 1, 1,
        torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert torch.isnan(G).all() and torch.isnan(cost).all(), "a refused call wrote its outputs"
    return code


@pytest.mark.parametrize("model_id,P,keys", [
    (4, 4, OBS_KEYS),                            # model id outside 0-3
    (-1, 3, OBS_KEYS),
    (MODEL_IDS["radial"], 4, OBS_KEYS),          # P is not the model's
    (MODEL_IDS["pinhole"], 3, ("up_x", "up_conf", "lat_sin")),  # no up_y: no instance
])
def test_lm_entry_refuses_what_it_has_no_instance_for(card, model_id, P, keys):
    obs, cam, grav = _lm_inputs("pinhole", 2, 8, 8, card)
    code = _call_entry({k: obs[k] for k in keys}, cam, grav, 8, 8, model_id, P)
    assert code == 1  # cudaErrorInvalidValue
    with pytest.raises(RuntimeError, match="gc_lm_system"):
        build.check(code, "gc_lm_system")


def test_lm_kernel_is_deterministic(card):
    obs, cam, grav = _lm_inputs("simple_radial", 4, 160, 200, card)
    cfg = LMConfig(camera_model="simple_radial")
    first = lm_system(obs, cam, grav, 160, 200, cfg)
    for a, b in zip(first, lm_system(obs, cam, grav, 160, 200, cfg)):
        assert torch.equal(a, b)


def _lane(cam, grav, lanes):
    return Camera.from_data(cam.data[lanes], cam.model), Gravity(grav.vec3d[lanes])


@pytest.mark.parametrize("model", MODELS)
def test_lm_kernel_is_batch_invariant(card, model):
    """A lane's sums depend on N alone: lane 0 of a 16-lane launch gives the same bits
    as a launch on lane 0's planes alone (request a's width and height)."""
    B, h, w = 16, 320, 416
    obs, cam, grav = _lm_inputs(model, B, h, w, card, seed=8)
    cfg = LMConfig(camera_model=model)
    batch = lm_system(obs, cam, grav, h, w, cfg)
    alone = lm_system({k: v[:1].contiguous() for k, v in obs.items()}, *_lane(cam, grav, [0]), h,
                      w, cfg)
    for a, b in zip(batch, alone):
        assert torch.equal(a[:1], b)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("B", [1, 40])  # one lane; more lanes than the card holds at once
def test_lm_kernel_batch_sizes(card, model, B):
    h, w = 96, 128
    obs, cam, grav = _lm_inputs(model, B, h, w, card, seed=9)
    for loss, sph, logf in [("huber", True, True), ("squared", False, False)]:
        cfg = LMConfig(camera_model=model, loss_fn=loss)
        _close(lm_system(obs, cam, grav, h, w, cfg, sph, logf),
               lm_system_plain(obs, cam, grav, h, w, cfg, sph, logf))


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("shape", [(3, 64, 80), (2, 61, 37)])  # N % 4 == 0, N % 4 == 1
def test_lm_kernel_takes_unaligned_planes(card, model, shape):
    """Planes that are contiguous views one element into their storage (not 16-byte
    aligned): element loads, the plain version's sums, and the same bits twice."""
    B, h, w = shape
    obs, cam, grav = _lm_inputs(model, B, h, w, card, seed=10)
    moved = {}
    for k, v in obs.items():
        storage = torch.zeros(B * h * w + 1, device=card)
        moved[k] = storage[1:].view(B, h * w)
        moved[k].copy_(v)
        assert moved[k].is_contiguous() and moved[k].data_ptr() % 16 != 0
    cfg = LMConfig(camera_model=model)
    out = lm_system(moved, cam, grav, h, w, cfg)
    _close(out, lm_system_plain(obs, cam, grav, h, w, cfg))
    for a, b in zip(out, lm_system(moved, cam, grav, h, w, cfg)):
        assert torch.equal(a, b)


def _rel(a, b):
    return float(torch.linalg.norm((a.float() - b.float()).flatten())
                 / torch.linalg.norm(b.float().flatten()))


@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(2, 256, 64, 16), (3, 200, 120, 64), (2, 700, 512, 64),
                                   (2, 8320, 512, 64),  # request a's per sample
                                   (2, 300, 121, 15),  # D, R odd: element loads, odd columns
                                   (2, 300, 100, 20)])  # D, R even, not multiples of 8
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 2500, 200, 48),  # ragged N and D, R below 64
                                   (32, 1000, 512, 64),  # more blocks than the card holds at once
                                   (2, 300, 121, 15)])  # D, R odd: element loads, odd columns
def test_nmf_kernel_is_deterministic(card, shape, dtype):
    """No atomics and no block reads what another writes: two launches give the same bits."""
    rng = np.random.default_rng(5)
    B, N, D, R = shape
    x = torch.from_numpy(np.maximum(rng.normal(size=(B, N, D)), 0)).to(card, dtype)
    bases = torch.from_numpy(rng.uniform(size=(B, D, R))).to(card, dtype)
    first = nmf(x, bases, 7)
    for a, b in zip(first, nmf(x, bases, 7)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 2500, 512, 64), (3, 300, 121, 15)])
def test_nmf_kernel_is_batch_invariant(card, shape, dtype):
    """Each sample's NMF is its own: the NMF of B samples in one call equals, bit for
    bit, each sample's NMF run alone."""
    rng = np.random.default_rng(8)
    B, N, D, R = shape
    x = torch.from_numpy(np.maximum(rng.normal(size=(B, N, D)), 0)).to(card, dtype)
    bases = torch.from_numpy(rng.uniform(size=(B, D, R))).to(card, dtype)
    coef, bt = nmf(x, bases, 7)
    for i in range(B):
        one_coef, one_bt = nmf(x[i:i + 1], bases[i:i + 1], 7)
        assert torch.equal(coef[i:i + 1], one_coef) and torch.equal(bt[i:i + 1], one_bt)


@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_nmf_kernel_takes_unaligned_tensors(card, dtype, bound):
    """x a contiguous view one element into its storage (not 16-byte aligned): the
    kernels load element by element, match the plain version and repeat their bits."""
    B, N, D, R = 2, 700, 512, 64
    rng = np.random.default_rng(7)
    x_np = np.maximum(rng.normal(size=(B, N, D)), 0)
    storage = torch.zeros(B * N * D + 1, device=card, dtype=dtype)
    x = storage[1:].view(B, N, D)
    x.copy_(torch.from_numpy(x_np))
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    bases = torch.from_numpy(rng.uniform(size=(B, D, R))).to(card, dtype)
    coef, bt = nmf(x, bases, 7)
    ref_coef, ref_bt = nmf_plain(x.clone(), bases, 7)
    assert _rel(torch.matmul(coef, bt), torch.matmul(ref_coef, ref_bt)) < bound
    for a, b in zip((coef, bt), nmf(x, bases, 7)):
        assert torch.equal(a, b)


def test_kernels_refuse_autograd(card):
    """The NMF kernel has no backward: under grad, an input that requires grad is refused
    (not routed to the plain version); under no_grad the same call launches."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(np.maximum(rng.normal(size=(1, 64, 32)), 0)).to(card, torch.bfloat16)
    bases = torch.from_numpy(rng.uniform(size=(1, 32, 8))).to(card, torch.bfloat16)
    with torch.enable_grad():
        for xs, bs in [(x.clone().requires_grad_(), bases), (x, bases.clone().requires_grad_())]:
            with pytest.raises(RuntimeError, match="no backward"):
                nmf(xs, bs, 2)
    with torch.no_grad():
        before = nmf.launches
        nmf(x.clone().requires_grad_(), bases.clone().requires_grad_(), 2)
        assert nmf.launches == before + 1


@pytest.mark.parametrize("model", MODELS)
# request a's planes (16 lanes of a 320x416 crop) and one lane of them (requests b, c)
@pytest.mark.parametrize("B", [16, 1])
def test_lm_kernel_vjp_matches_plain(card, model, B):
    """lm_system on CUDA tensors that require grad launches the kernel once and takes the
    VJP of the plain version: the planes', camera's and gravity's gradients for seeded
    cotangents of G, H and cost equal those of autograd through lm_system_plain."""
    obs, cam, grav = _lm_inputs(model, 16, 320, 416, card)
    obs = {k: v[:B].contiguous() for k, v in obs.items()}
    cam = Camera.from_data(cam.data[:B], model)
    grav = Gravity(grav.vec3d[:B] + 0.05)  # off the trivial estimate: every term is exercised
    cfg = LMConfig(camera_model=model)
    rng = np.random.default_rng(7)
    P = cfg.num_params
    cts = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(card)
           for s in ((B, P), (B, P, P), (B,))]
    grads = []
    for fn in (lm_system, lm_system_plain):
        leaves = [t.clone().contiguous().requires_grad_() for t in (cam.data, grav.vec3d,
                                                                     *obs.values())]
        before = lm_system.launches
        with torch.enable_grad():
            out = fn(dict(zip(obs, leaves[2:])), Camera.from_data(leaves[0], model),
                     Gravity(leaves[1]), 320, 416, cfg)
            grads.append(torch.autograd.grad(out, leaves, cts))
        assert lm_system.launches == before + (fn is lm_system)
    for name, a, b in zip(["camera", "gravity", *obs], *grads):
        assert bool(torch.isfinite(a).all()) and b.abs().max() > 0, name
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * b.abs().max().item(), msg=name)


@pytest.mark.parametrize("mode", ["ift", "unroll"])
def test_train_step_runs_on_the_card(card, mode):
    """One tiny-variant train_step on CUDA tensors (bf16 network, drop path 0.1): finite
    loss, gradients and scalars, the LM kernel launched, and the parameters moved."""
    from geocalib_tpu_torch.training.train_step import (TrainConfig, compute_grads,
                                                        create_train_state, train_step)

    cfg = TrainConfig(variant="tiny", lm_steps=3, lm_grad_mode=mode)
    net, state = create_train_state(cfg, seed=0, device=card)
    rng = np.random.default_rng(0)
    B, S = 2, 64
    batch = {"image": torch.from_numpy(rng.uniform(size=(B, S, S, 3)).astype(np.float32)).to(card),
             "gt_params": torch.tensor([[S, S, 0.9, 0.1, -0.2, 0, 0], [S, S, 1.1, -0.1, 0.1, 0, 0]],
                                       dtype=torch.float32, device=card)}
    before = lm_system.launches
    loss, grads, _, _, _ = compute_grads(net, cfg, state, batch, (0, 7))
    assert lm_system.launches - before == cfg.lm_steps + 1
    assert bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads.values())
    new, scalars = train_step(net, cfg, state, batch, (0, 7))
    assert all(bool(torch.isfinite(v)) for v in scalars.values())
    assert float(scalars["skipped_nonfinite"]) == 0.0
    moved = [not torch.equal(new.params[k], state.params[k]) for k in state.params]
    assert sum(moved) >= 0.9 * len(moved)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = torch.ones(1, 8, 4, device=card, dtype=torch.float16)
    with pytest.raises(ValueError):
        nmf(x, torch.ones(1, 4, 2, device=card, dtype=torch.float16))
    with pytest.raises(ValueError):
        nmf(x.float(), torch.ones(1, 4, 65, device=card))
    obs, cam, grav = _lm_inputs("pinhole", 1, 8, 8, card)
    with pytest.raises(ValueError):
        lm_system({"up_x": obs["up_x"]}, cam, grav, 8, 8, LMConfig())


def test_device_augment_on_the_card_matches_the_cpu(card):
    """device_augment on CUDA tensors against the same function on the CPU, same key:
    99.9% of the elements within 1e-5 (powers, exponentials and the erfinv's log1p
    round in other ways on each side) and every element within one quantization
    level of the JPEG stand-in, 1/24, where a value sits at a rounding step."""
    from geocalib_tpu_torch.data.device_augment import DEVICE_AUGMENTATIONS

    img = torch.from_numpy(np.random.default_rng(0).uniform(size=(4, 64, 48, 3)).astype(np.float32))
    for name in ("geocalib", "dark", "deepcalib"):
        for key in ((0, 1), (3, 9)):
            cpu = DEVICE_AUGMENTATIONS[name](img, key)
            gpu = DEVICE_AUGMENTATIONS[name](img.to(card), key).cpu()
            d = (gpu - cpu).abs()
            assert float((d <= 1e-5).float().mean()) >= 0.999, (name, key)
            assert float(d.max()) <= 1 / 24, (name, key)


class _MemoryDataset:
    """SimpleDataset rows held in memory (the card has no PIL): random images and
    random GT rows, one split per csv name."""

    @staticmethod
    def make(size: int, rows: int):
        from geocalib_tpu_torch.data.dataset import DatasetConf, SimpleDataset

        rng = np.random.default_rng(1)
        splits = {name: (rng.uniform(size=(rows, size, size, 3)).astype(np.float32),
                         rng.uniform([0.7, -0.3, -0.3], [1.2, 0.3, 0.3], (rows, 3)))
                  for name in ("train.csv", "val.csv")}

        class Split(SimpleDataset):
            def __init__(self, conf=None, **kw):
                self.conf = conf or DatasetConf(**kw)
                self.images, gt = splits[self.conf.csv_name]
                self.rows = [{"fname": str(i), "i": i, "gt": [size, size, *g, 0.0, 0.0]}
                             for i, g in enumerate(gt)]

            def _load_row(self, row, aug_seed):
                return {"image": torch.from_numpy(self.images[row["i"]]),
                        "gt_params": torch.tensor(row["gt"], dtype=torch.float32)}

        return Split


@pytest.mark.parametrize("staged", [False, True])
def test_training_loop_saves_and_restores_on_the_card(card, tmp_path, monkeypatch, staged):
    """Two steps of the training loop on the card (tiny variant, 64x64, bf16, the device
    augmentation), a checkpoint restored on the card equal to the saved file bit for
    bit, one more step after restore=True, and the export read back."""
    from geocalib_tpu_torch.models.weights import params_from_jax, read_flax_msgpack
    from geocalib_tpu_torch.training import train as loop
    from geocalib_tpu_torch.training.checkpoint import ExperimentManager
    from geocalib_tpu_torch.training.export import export_checkpoint
    from geocalib_tpu_torch.training.train_step import TrainConfig, create_train_state
    from geocalib_tpu_torch.utils.config import merge

    monkeypatch.setattr(loop, "SimpleDataset", _MemoryDataset.make(64, 8))
    conf = merge(loop.default_conf, {
        "train": {"variant": "tiny", "lm_steps": 3, "input_size": 64, "total_steps": 2,
                  "log_every": 1, "eval_every": 1, "save_every": 1, "val_batches": 1,
                  "figures_every": 0},
        "data": {"batch_size": 4, "augmentation": "device"}})
    scalars = loop.training(conf, str(tmp_path), staged=staged)
    assert all(np.isfinite(v) for v in scalars.values())
    _, template = create_train_state(TrainConfig(variant="tiny"), device=card)
    state, step = ExperimentManager(tmp_path).restore(template)
    saved = torch.load(tmp_path / "checkpoint_2" / "state.pt", weights_only=True)
    assert step == 2 and state.opt_state.count.device.type == card.type
    for tree, key in ((state.params, "params"), (state.opt_state.mu, "mu"),
                      (state.opt_state.nu, "nu"), (state.batch_stats, "batch_stats")):
        assert all(torch.equal(v.cpu(), saved[key][k]) for k, v in tree.items()), key
    conf["train"]["total_steps"] = 3
    assert np.isfinite(loop.training(conf, str(tmp_path), restore=True, staged=staged)["loss/total"])
    got = export_checkpoint(tmp_path, tmp_path / "w.msgpack")
    back = params_from_jax(read_flax_msgpack(tmp_path / "w.msgpack"), "tiny")
    final = torch.load(tmp_path / "checkpoint_3" / "state.pt", weights_only=True)
    assert got == 3 and all(torch.equal(back[k], v) for k, v in final["params"].items())


@pytest.mark.parametrize("model", ["pinhole", "simple_radial"])
def test_render_and_undistort_on_the_card_match_the_cpu(card, model):
    """The dataset generator's render on the card: where each crop pixel samples the
    panorama within 1e-3 pano pixels of the CPU on the sphere (the bound of
    tests/test_torch_generate.py), the sampler on equal coordinates within 1e-6, the
    rows equal; and undistort_image within 1e-4 of the CPU's."""
    from geocalib_tpu_torch.data import generate, pano as pano_lib

    conf = generate.dataset_conf(height=48, width=64, crops_per_pano=4, pano_height=96,
                                 pano_width=192)
    task = {"split": "train", "conf": conf, "camera_model": model, "seed": 5}
    pano = np.random.default_rng(0).uniform(size=(96, 192, 3)).astype(np.float32)
    rows, crops = generate.render_pano(task, "synth0000", pano, card)
    rows_cpu, _ = generate.render_pano(task, "synth0000", pano, "cpu")
    assert rows == rows_cpu and crops.device.type == "cuda" and crops.shape == (4, 48, 64, 3)
    _, yaw = generate.sample_rows("synth0000", task)
    views = lambda dev: generate.row_views(rows, yaw, model, dev)
    on_card = tuple(t.cpu() for t in pano_lib.pano_coordinates(pano.shape[:2], *views(card)))
    on_cpu = pano_lib.pano_coordinates(pano.shape[:2], *views("cpu"))
    assert float(pano_lib.sample_distance(on_card, on_cpu, pano.shape[:2]).max()) <= 1e-3
    sampled = pano_lib._bilinear_sample(torch.from_numpy(pano), *on_card).reshape(crops.shape)
    torch.testing.assert_close(crops.cpu(), sampled, rtol=0, atol=1e-6)

    cam = views(card)[0]
    und = cam.undistort_image(crops)
    ref = generate.row_views(rows, yaw, model, "cpu")[0].undistort_image(crops.cpu())
    torch.testing.assert_close(und.cpu(), ref, rtol=0, atol=1e-4)
