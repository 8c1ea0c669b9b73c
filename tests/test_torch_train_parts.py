"""The parts of the port's training step against the JAX package, on the CPU.

Tolerances, each stated where it is used:
- threefry keys and draws: bit for bit;
- BatchNorm in training mode: output and new running statistics at 1e-5
  relative (float32 statistics of the same inputs, summed in other orders);
  from bfloat16 inputs the statistics at 1e-5 and the bf16 output within one
  bf16 rounding (2^-8 relative);
- the training NMF from given bases: rtol 1e-4 / atol 1e-5, as the
  evaluation NMF in tests/test_torch_nmf.py;
- losses and metrics: 1e-5 relative;
- the optimizer: three steps against optax's chain at 1e-6 relative;
- the schedule: equal float32 values;
- run_lm's gradients with respect to the fields, in "ift" and "unroll"
  mode: 1e-3 relative L2 per field (measured: a few 1e-6);
- the LM system's autograd.Function against autograd through the plain
  version: 1e-6 relative (the same operations, recomputed).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geocalib_tpu.geometry.camera import Camera as JCamera
from geocalib_tpu.geometry.gravity import Gravity as JGravity
from geocalib_tpu.geometry.perspective_fields import get_perspective_field as jfield
from geocalib_tpu.models import GeoCalibNet as JNet
from geocalib_tpu.models.fused_heads import fused_forward_train
from geocalib_tpu.models.hamburger import NMF2D
from geocalib_tpu.models.modules import BatchNorm as JBatchNorm
from geocalib_tpu.optim.lm import LMConfig as JLMConfig
from geocalib_tpu.optim.lm import run_lm as jrun_lm
from geocalib_tpu.training import losses as jlosses
from geocalib_tpu_torch.geometry.camera import Camera
from geocalib_tpu_torch.geometry.gravity import Gravity
from geocalib_tpu_torch.models import GeoCalibNet
from geocalib_tpu_torch.models.hamburger import nmf_2d_train, train_bases
from geocalib_tpu_torch.models.modules import BatchNorm, DropPath, dropout
from geocalib_tpu_torch.models.weights import params_from_jax, params_to_jax
from geocalib_tpu_torch.ops.lm_system import lm_system, lm_system_plain
from geocalib_tpu_torch.optim.lm import LMConfig, run_lm
from geocalib_tpu_torch.training import losses as tlosses
from geocalib_tpu_torch.utils import threefry

J = importlib.import_module("geocalib_tpu.training.train_step")
T = importlib.import_module("geocalib_tpu_torch.training.train_step")

MODELS = ["pinhole", "simple_radial", "radial", "simple_divisional"]


def _key(jkey):
    return tuple(int(x) for x in np.asarray(jkey))


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, path + (k,)) if isinstance(v, dict) else {path + (k,): np.asarray(v)})
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------------ threefry


@pytest.mark.parametrize("seed", [0, 3, 2**31 + 5])
def test_threefry_keys_match_jax(seed):
    jk = jax.random.PRNGKey(seed)
    k = threefry.prng_key(seed)
    assert k == _key(jk)
    for num in (2, 3):
        assert threefry.split(k, num) == tuple(_key(x) for x in jax.random.split(jk, num))
    for data in (0, 1, 7, 2**31 + 3):
        assert threefry.fold_in(k, data) == _key(jax.random.fold_in(jk, data))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 120, 64), (3, 5), (7,)])
def test_uniform_from_a_split_key_matches_jax(dtype, shape):
    """The training bases' draw: uniform(split(fold_in(key, 0))[1], (2B, C, 64), dtype)."""
    jk = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(11), 0))[1]
    ref = np.asarray(jax.random.uniform(jk, shape, dtype=getattr(jnp, dtype))).astype(np.float32)
    ours = threefry.uniform_tensor(_key(jk), shape, getattr(torch, dtype))
    assert ours.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(ours.float().numpy(), ref)
    np.testing.assert_array_equal(threefry.uniform(_key(jk), shape, dtype), ref)
    if len(shape) == 3:
        bases = train_bases(_key(jk), shape[0], shape[1], "cpu", getattr(torch, dtype), shape[2])
        np.testing.assert_array_equal(bases.float().numpy(), ref)


# ------------------------------------------------------------------ modules


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_flax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 6, 5, 7)) * 3 + 2).astype(np.float32)  # NHWC
    scale, bias = rng.uniform(0.5, 1.5, 7).astype(np.float32), rng.normal(size=7).astype(np.float32)
    mean0, var0 = rng.normal(size=7).astype(np.float32), rng.uniform(0.5, 2, 7).astype(np.float32)
    jdt = getattr(jnp, dtype)
    xj = jnp.asarray(x, jdt)
    variables = {"params": {"BatchNorm_0": {"scale": jnp.asarray(scale, jdt),
                                            "bias": jnp.asarray(bias, jdt)}},
                 "batch_stats": {"BatchNorm_0": {"mean": jnp.asarray(mean0),
                                                 "var": jnp.asarray(var0)}}}
    ref, mut = JBatchNorm().apply(variables, xj, train=True, mutable=["batch_stats"])
    ref = np.asarray(ref.astype(jnp.float32))

    bn = BatchNorm(7)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    tdt = getattr(torch, dtype)
    bn = bn.to(tdt).train()  # running statistics stay float32, as in a training state
    bn.running_mean.data = torch.from_numpy(mean0.copy())
    bn.running_var.data = torch.from_numpy(var0.copy())
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = bn(xt).permute(0, 2, 3, 1)
    assert out.dtype == tdt and bn.running_var.dtype == torch.float32
    stats = mut["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-5)
    tol = 1e-5 if dtype == "float32" else 2.0**-8
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=tol, atol=tol * np.abs(ref).max())
    # the running variance is the biased one: torch's own BatchNorm2d would differ
    xb = x.reshape(-1, 7).astype(np.float64)
    if dtype == "float32":
        np.testing.assert_allclose(bn.running_var.numpy(), 0.9 * var0 + 0.1 * xb.var(0), rtol=1e-5)
    if dtype == "float32":  # evaluation stays torch's own
        bn.eval()
        with torch.no_grad():
            ev = bn(xt)
        assert torch.equal(ev, torch.nn.functional.batch_norm(
            xt, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, 1e-5))


def test_droppath_keeps_at_its_rate_and_rescales():
    rate = 0.3
    dp = DropPath(rate).train()
    x = torch.ones(20000, 3, 2, 2)
    gen = torch.Generator().manual_seed(0)
    y = dp(x, gen)
    per_sample = y.reshape(20000, -1)
    kept = (per_sample != 0).all(1)
    assert ((per_sample == 0).all(1) | kept).all(), "a sample is dropped whole or not at all"
    np.testing.assert_allclose(kept.float().mean().item(), 1 - rate, atol=0.01)
    torch.testing.assert_close(per_sample[kept], torch.full_like(per_sample[kept], 1 / (1 - rate)))
    assert torch.equal(dp(x, torch.Generator().manual_seed(0)), y), "the generator decides"
    assert torch.equal(dp.eval()(x, gen), x) and torch.equal(DropPath(0.0).train()(x), x)
    z = dropout(x, 0.5, True, torch.Generator().manual_seed(1))
    assert set(torch.unique(z).tolist()) == {0.0, 2.0} and torch.equal(dropout(x, 0.5, False), x)


def test_drop_path_schedule_matches_mscan():
    """Block i of n drops at rate·i/(n-1), over all four stages (mscan.py:54-56)."""
    net = GeoCalibNet("b", drop_path_rate=0.1)
    rates = [blk.drop_path.rate for stage in net.backbone.stages for blk in stage]
    assert len(rates) == 21
    np.testing.assert_allclose(rates, [0.1 * i / 20 for i in range(21)], rtol=0, atol=0)


@pytest.mark.parametrize("steps", [1, 6])
def test_train_nmf_matches_nmf2d(steps):
    rng = np.random.default_rng(4)
    x = np.maximum(rng.normal(size=(4, 128, 40)), 0).astype(np.float32)
    bases = rng.uniform(size=(4, 40, 16)).astype(np.float32)
    ref = NMF2D(rank=16, train_steps=steps).apply({}, jnp.asarray(x), train=True,
                                                  bases=jnp.asarray(bases))
    xt = torch.from_numpy(x).requires_grad_()
    out = nmf_2d_train(xt, torch.from_numpy(bases), steps)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    g = jax.grad(lambda a: jnp.sum(NMF2D(rank=16, train_steps=steps).apply(
        {}, a, train=True, bases=jnp.asarray(bases)) ** 2))(jnp.asarray(x))
    (gt,) = torch.autograd.grad(out.square().sum(), xt)
    assert _rel(gt.numpy(), np.asarray(g)) < 1e-4


def test_forward_train_matches_fused_forward_train():
    """The training forward (tiny, float32, drop path 0): fields and new running
    statistics against fused_forward_train, the bases drawn from the same key."""
    H = 64
    net = JNet(variant="tiny")
    v = net.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, H, H, 3)))
    image = np.random.default_rng(2).uniform(size=(2, H, H, 3)).astype(np.float32)
    jk = jax.random.PRNGKey(5)
    fields, mut = jax.jit(lambda vv, im: fused_forward_train(
        vv, im, variant="tiny", rngs={"dropout": jk, "nmf": jk}))(v, jnp.asarray(image))
    tree = jax.tree.map(np.asarray, v)
    tnet = GeoCalibNet("tiny")
    tnet.load_state_dict(params_from_jax(tree, "tiny"))
    tnet.train()
    with torch.no_grad():
        out, stats = tnet(torch.from_numpy(image), _key(jk))
    for k, ref in fields.items():
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref), rtol=1e-4, atol=2e-4, err_msg=k)
    jstats = _flat(mut["batch_stats"])
    tstats = _flat(params_to_jax(stats, "tiny")["batch_stats"])
    assert set(jstats) == set(tstats)
    for k in jstats:
        np.testing.assert_allclose(tstats[k], jstats[k], rtol=1e-4, atol=1e-6, err_msg=str(k))


def test_params_to_jax_inverts_params_from_jax():
    v = jax.tree.map(np.asarray, JNet(variant="tiny").init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3))))
    back = params_to_jax(params_from_jax(v, "tiny"), "tiny")
    ref = _flat({"params": v["params"], "batch_stats": v["batch_stats"]})
    got = _flat(back)
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k].astype(np.float32), err_msg=str(k))


# ------------------------------------------------------------------ losses


def _loss_inputs(seed=0, B=3, h=12, w=16):
    rng = np.random.default_rng(seed)
    pred = {"width": np.full(B, w, np.float32), "height": np.full(B, h, np.float32),
            "vfov": rng.uniform(0.6, 1.2, B).astype(np.float32),
            "k1": rng.uniform(-0.2, 0.1, B).astype(np.float32)}
    gt = dict(pred, vfov=rng.uniform(0.6, 1.2, B).astype(np.float32),
              k1=rng.uniform(-0.2, 0.1, B).astype(np.float32))
    rp = rng.uniform(-0.5, 0.5, (4, B)).astype(np.float32)
    up = rng.normal(size=(B, h, w, 2)).astype(np.float32)
    up /= np.linalg.norm(up, axis=-1, keepdims=True)
    fields = {"up_field": up, "latitude_field": rng.uniform(-1, 1, (B, h, w, 1)).astype(np.float32),
              "up_confidence": rng.uniform(0.1, 1, (B, h, w)).astype(np.float32),
              "latitude_confidence": rng.uniform(0.1, 1, (B, h, w)).astype(np.float32)}
    tgt = rng.normal(size=(B, h, w, 2)).astype(np.float32)
    data = {"up_field": tgt / np.linalg.norm(tgt, axis=-1, keepdims=True),
            "latitude_field": rng.uniform(-1, 1, (B, h, w, 1)).astype(np.float32)}
    return pred, gt, rp, fields, data


def test_losses_and_metrics_match_jax():
    pred, gt, rp, fields, data = _loss_inputs()
    jargs = (jax.tree.map(jnp.asarray, fields), JCamera.from_dict(pred, "simple_radial"),
             JGravity.from_rp(rp[0], rp[1]), jax.tree.map(jnp.asarray, data),
             JCamera.from_dict(gt, "simple_radial"), JGravity.from_rp(rp[2], rp[3]))
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    targs = (t(fields), Camera.from_dict(t(pred), "simple_radial"),
             Gravity.from_rp(torch.from_numpy(rp[0]), torch.from_numpy(rp[1])), t(data),
             Camera.from_dict(t(gt), "simple_radial"),
             Gravity.from_rp(torch.from_numpy(rp[2]), torch.from_numpy(rp[3])))
    for jf, tf in [(jlosses.geocalib_losses, tlosses.geocalib_losses),
                   (jlosses.geocalib_metrics, tlosses.geocalib_metrics)]:
        ref, out = jf(*jargs), tf(*targs)
        assert set(ref) == set(out)
        for k in ref:
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    for kind in ("l1", "l2", "dot", "cauchy", "huber"):
        ref = jlosses.field_loss(jnp.asarray(fields["up_field"]), jnp.asarray(data["up_field"]),
                                 jnp.asarray(fields["up_confidence"]), kind)
        out = tlosses.field_loss(torch.from_numpy(fields["up_field"]),
                                 torch.from_numpy(data["up_field"]),
                                 torch.from_numpy(fields["up_confidence"]), kind)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, err_msg=kind)


def test_confidence_weights_are_detached():
    _, _, _, fields, data = _loss_inputs()
    conf = torch.from_numpy(fields["up_confidence"]).requires_grad_()
    pred = torch.from_numpy(fields["up_field"]).requires_grad_()
    tlosses.field_loss(pred, torch.from_numpy(data["up_field"]), conf).sum().backward()
    assert conf.grad is None and pred.grad is not None


# ------------------------------------------------------------------ optimizer


def _opt_tree(rng, step):
    scale = np.float32(0.01 if step == 1 else 2.0)
    return {"a": rng.normal(size=(3, 4)).astype(np.float32) * scale,
            "b": rng.normal(size=(5,)).astype(np.float32) * scale,
            "c": rng.normal(size=(2, 2, 2)).astype(np.float32) * scale}


@pytest.mark.parametrize("sanitize", [True, False])
def test_optimizer_matches_optax_chain(sanitize):
    """Three steps of optimizer_update against optax's chain(zero_nans,
    clip_by_global_norm, adamw) on a tree with a NaN in one leaf and an inf in
    another: zeroed first as train_step does (sanitize), or fed raw, where the inf
    poisons the clip as it does in optax. Steps 0 and 2 are clipped (‖g‖ > 1)."""
    cfg = T.TrainConfig(lr=1e-2, warmup_steps=2, decay_milestones=(3,))
    jcfg = J.TrainConfig(lr=1e-2, warmup_steps=2, decay_milestones=(3,))
    opt = J.make_optimizer(jcfg)
    rng = np.random.default_rng(0)
    params = {k: v * 0 + rng.normal(size=v.shape).astype(np.float32)
              for k, v in _opt_tree(rng, 0).items()}
    jparams, jstate = jax.tree.map(jnp.asarray, params), opt.init(jax.tree.map(jnp.asarray, params))
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = T.optimizer_init(tparams)
    for step in range(3):
        g = _opt_tree(rng, step)
        g["b"][1] = np.nan
        g["c"][0, 1, 0] = np.inf
        if sanitize:
            g = {k: np.where(np.isfinite(v), v, 0).astype(np.float32) for k, v in g.items()}
        norm = np.sqrt(sum(float((np.nan_to_num(v, posinf=0) ** 2).sum()) for v in g.values()))
        assert (norm > 1.0) == (step != 1)
        upd, jstate = opt.update(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tupd, tstate = T.optimizer_update({k: torch.from_numpy(v) for k, v in g.items()}, tstate,
                                          tparams, cfg)
        tparams = {k: p + tupd[k] for k, p in tparams.items()}
        for k in params:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-7, equal_nan=not sanitize, err_msg=f"{step} {k}")
    assert int(tstate.count) == 3
    # raw, the inf makes the global norm inf, and inf/inf a NaN in its leaf alone
    assert np.isfinite(np.asarray(jparams["c"])).all() == sanitize
    assert np.isfinite(tparams["a"].numpy()).all()


def test_schedule_matches_optax():
    cfg = T.TrainConfig()
    ref = J.make_schedule(J.TrainConfig())
    sched = T.make_schedule(cfg)
    counts = [0, 1, 2, cfg.warmup_steps - 1, cfg.warmup_steps, cfg.warmup_steps + 1,
              cfg.decay_milestones[0] - 1, cfg.decay_milestones[0], cfg.decay_milestones[1],
              cfg.decay_milestones[1] + 7]
    for n in counts:
        assert float(sched(n)) == float(np.float32(ref(n))), n
    assert float(sched(0)) == pytest.approx(cfg.lr * 1e-3, rel=1e-6)
    assert float(sched(cfg.decay_milestones[1])) == pytest.approx(cfg.lr * 0.01, rel=1e-6)


# ------------------------------------------------------------------ LM gradients


def _lm_data(model, B=2, h=32, w=32, seed=0):
    rng = np.random.default_rng(seed)
    k1 = rng.uniform(-0.15, 0.0, B) if model != "pinhole" else np.zeros(B)
    cam = JCamera.from_dict({"height": jnp.full((B,), float(h)), "width": jnp.full((B,), float(w)),
                             "vfov": jnp.asarray(rng.uniform(0.8, 1.2, B), jnp.float32),
                             "k1": jnp.asarray(k1, jnp.float32)}, model=model)
    grav = JGravity.from_rp(jnp.asarray(rng.uniform(-0.3, 0.3, B), jnp.float32),
                            jnp.asarray(rng.uniform(-0.3, 0.3, B), jnp.float32))
    up, lat = jfield(cam, grav, h, w)
    return {"up_field": np.asarray(up) + rng.normal(0, 0.01, up.shape).astype(np.float32),
            "latitude_field": np.asarray(lat) + rng.normal(0, 0.01, lat.shape).astype(np.float32),
            "up_confidence": rng.uniform(0.3, 1.0, (B, h, w)).astype(np.float32),
            "latitude_confidence": rng.uniform(0.3, 1.0, (B, h, w)).astype(np.float32)}


@pytest.mark.parametrize("model", ["pinhole", "simple_radial"])
@pytest.mark.parametrize("mode", ["ift", "unroll"])
def test_run_lm_gradients_match_jax(mode, model):
    """d/d(fields) of a loss on run_lm's camera and gravity, as tests/test_ift.py
    takes it, with the training solver's options."""
    data = _lm_data(model)
    opts = dict(camera_model=model, num_steps=10, early_stop=False, loss_fn="squared",
                with_uncertainty=False, grad_mode=mode)

    def jloss(d):
        res = jrun_lm(d, JLMConfig(**opts))
        return (jnp.sum(res.gravity.rp ** 2) + jnp.sum((res.camera.vfov - 1.0) ** 2)
                + jnp.sum(res.camera.k ** 2))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(jnp.asarray, data))
    td = {k: torch.from_numpy(v).requires_grad_() for k, v in data.items()}
    res = run_lm(dict(td), LMConfig(**opts))
    tl = (res.gravity.rp.square().sum() + (res.camera.vfov - 1.0).square().sum()
          + res.camera.k.square().sum())
    grads = torch.autograd.grad(tl, list(td.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for k, g in zip(td, grads):
        assert np.abs(np.asarray(jg[k])).max() > 0, k
        assert _rel(g.numpy(), jg[k]) < 1e-3, (k, _rel(g.numpy(), jg[k]))


@pytest.mark.parametrize("model", MODELS)
def test_lm_system_function_matches_plain_autograd(model):
    """lm_system on CPU tensors goes through LMSystemFunction (forward without a
    graph, backward recomputing the plain version); its gradients equal those of
    autograd straight through lm_system_plain, for cotangents of G, H and cost."""
    data = _lm_data(model, B=3, h=12, w=10, seed=1)
    rng = np.random.default_rng(2)
    B, N = 3, 120
    up = torch.from_numpy(data["up_field"]).reshape(B, N, 2)
    obs = {"up_x": up[..., 0], "up_y": up[..., 1],
           "lat_sin": torch.sin(torch.from_numpy(data["latitude_field"]).reshape(B, N)),
           "up_conf": torch.from_numpy(data["up_confidence"]).reshape(B, N),
           "lat_conf": torch.from_numpy(data["latitude_confidence"]).reshape(B, N)}
    k = rng.uniform(-0.1, 0.0, (B, 2)) * (model != "pinhole")
    cam_data = torch.tensor(np.concatenate([np.tile([10.0, 12.0, 9.0, 9.5, 5.0, 6.0], (B, 1)), k],
                                           -1), dtype=torch.float32)
    vec = torch.tensor(rng.normal(size=(B, 3)), dtype=torch.float32)
    vec = vec / vec.norm(dim=-1, keepdim=True)
    cfg = LMConfig(camera_model=model, loss_fn="huber")
    P = cfg.num_params
    cts = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((B, P), (B, P, P), (B,))]
    grads = []
    for fn in (lm_system, lm_system_plain):
        leaves = [t.clone().contiguous().requires_grad_() for t in (cam_data, vec, *obs.values())]
        o = dict(zip(obs, leaves[2:]))
        out = fn(o, Camera.from_data(leaves[0], model), Gravity(leaves[1]), 12, 10, cfg)
        grads.append(torch.autograd.grad(out, leaves, cts))
    for name, a, b in zip(["camera", "gravity", *obs], *grads):
        assert b.abs().max() > 0, name
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * b.abs().max().item(), msg=name)
