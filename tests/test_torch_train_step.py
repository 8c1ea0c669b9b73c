"""One training step of the port against the JAX package's train_step, on the CPU.

The tiny variant at 64×64, float32 compute, drop path 0 (Flax draws its
DropPath masks per module, the port from its own generator), B = 2, 3 LM
steps, the JAX step run in shard_map over a one-device mesh. Both start
from the same JAX-initialised parameters, carried across by
params_from_jax, and the same key; every gradient leaf comes back through
params_to_jax.

Tolerances:
- the loss and every loss term, 1e-4 relative (float32 sums in other orders);
- every gradient leaf, 1e-3 relative L2, for the leaves whose norm is over
  1e-6 of the gradient's global norm (the biases of the convolutions in
  front of a BatchNorm have a true gradient of 0, so theirs is float32
  noise: under 1e-8 of the global norm here);
- the global norm, 1e-3 relative;
- the new parameters: every element within 2·lr of JAX's value (Adam's first
  step moves each element by about ±lr, so a gradient element at float32
  noise may flip its update's sign), and 99% of the elements of the judged
  leaves equal to JAX's within 2 float32 ulps (the step, ~1e-7, is near the
  ulp of the parameters, so the update itself cannot be compared closer);
- the new BatchNorm statistics, 1e-4 relative (E[x²] - E[x]² of the stem's
  inputs at ~1e3 loses 3 digits to the cancellation).

The field losses are L1, whose gradient flips sign where a prediction
crosses its target. The fields of the two packages differ by up to ~1e-5,
so the comparison holds only where no residual element changes sign
between them; the test checks that premise first, from both packages' fields.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from geocalib_tpu.models.fused_heads import fused_forward_train
from geocalib_tpu.parallel.mesh import DATA_AXIS
from geocalib_tpu_torch.data.dataset import synthesize_gt_fields
from geocalib_tpu_torch.models.weights import params_from_jax, params_to_jax
from geocalib_tpu_torch.utils.threefry import fold_in, split

J = importlib.import_module("geocalib_tpu.training.train_step")
T = importlib.import_module("geocalib_tpu_torch.training.train_step")

B, SIZE, LM_STEPS, SEED = 2, 64, 3, 1
SHARE = 1e-6


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, path + (k,)) if isinstance(v, dict) else {path + (k,): np.asarray(v)})
    return out


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / max(np.linalg.norm(b), 1e-30))


def _batch(seed):
    rng = np.random.default_rng(seed)
    image = rng.uniform(size=(B, SIZE, SIZE, 3)).astype(np.float32)
    gt = np.stack([np.full(B, SIZE), np.full(B, SIZE), rng.uniform(0.7, 1.2, B),
                   rng.uniform(-0.3, 0.3, B), rng.uniform(-0.3, 0.3, B), np.zeros(B),
                   np.zeros(B)], -1).astype(np.float32)
    return image, gt


def _jax_step(cfg, state, net, batch, key):
    """JAX: loss terms, gradients, fields, and the new state and scalars of train_step."""

    def run(st, b, k):
        kk = jax.random.fold_in(k, jax.lax.axis_index(DATA_AXIS))
        (_, (_, losses, _)), grads = jax.value_and_grad(
            lambda p: J.loss_and_updates(net, cfg, p, st.batch_stats, b, kk), has_aux=True)(
                st.params)
        d_rng, n_rng = jax.random.split(kk)
        fields, _ = fused_forward_train({"params": st.params, "batch_stats": st.batch_stats},
                                        b["image"], variant=cfg.variant, rngs={"dropout": d_rng,
                                                                               "nmf": n_rng},
                                        bn_axis_name=DATA_AXIS)
        new_state, scalars = J.train_step(net, cfg, st, b, k)
        return losses, grads, fields, new_state, scalars

    mesh = Mesh(np.asarray(jax.devices()[:1]), (DATA_AXIS,))
    fn = jax.jit(jax.shard_map(run, mesh=mesh, in_specs=(P(), P(DATA_AXIS), P()),
                               out_specs=P(), check_vma=False))
    return jax.tree.map(np.asarray, fn(state, batch, key))


@pytest.mark.parametrize("mode", ["ift", "unroll"])
def test_train_step_matches_jax(mode):
    kw = dict(variant="tiny", lm_steps=LM_STEPS, drop_path_rate=0.0, compute_dtype="float32",
              lm_grad_mode=mode)
    jcfg, tcfg = J.TrainConfig(**kw), T.TrainConfig(**kw)
    net, state = J.create_train_state(jax.random.PRNGKey(0), jcfg, (1, SIZE, SIZE, 3))
    image, gt = _batch(SEED)
    key = jax.random.PRNGKey(3)
    losses, grads, fields, new_state, scalars = _jax_step(
        jcfg, state, net, {"image": jnp.asarray(image), "gt_params": jnp.asarray(gt)}, key)

    tree = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    tnet, tstate = T.create_train_state(tcfg, params_from_jax(tree, "tiny"), device="cpu")
    tkey = tuple(int(x) for x in np.asarray(key))
    tbatch = {"image": torch.from_numpy(image), "gt_params": torch.from_numpy(gt)}

    # the premise: no L1 residual element changes sign between the packages
    gt_fields = synthesize_gt_fields(tbatch)
    with torch.no_grad():
        tfields, _ = tnet(torch.from_numpy(image), split(fold_in(tkey, 0))[1])
    for k in ("up_field", "latitude_field"):
        target = gt_fields[k].numpy()
        flips = np.sign(tfields[k].numpy() - target) != np.sign(fields[k] - target)
        assert not flips.any(), (f"{k}: {int(flips.sum())} L1 residuals change sign between the "
                                 f"packages at {np.argwhere(flips).tolist()}: the fixture sits "
                                 f"at the kink, and the gradients cannot be compared there")

    loss, tgrads, _, tlosses, _ = T.compute_grads(tnet, tcfg, tstate, tbatch, tkey)
    for k, v in losses.items():
        np.testing.assert_allclose(tlosses[k].detach().numpy(), v, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(loss), float(losses["total"].mean()), rtol=1e-4)

    jg, tg = _flat(grads), _flat(params_to_jax(tgrads, "tiny")["params"])
    assert set(jg) == set(tg)
    norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in jg.values()))
    judged = [k for k in jg if np.linalg.norm(jg[k]) > SHARE * norm]
    assert len(judged) > 0.8 * len(jg)
    bad = {k: _rel(tg[k], jg[k]) for k in judged if _rel(tg[k], jg[k]) > 1e-3}
    assert not bad, f"gradient leaves beyond 1e-3 relative L2: {bad}"

    tnew, tscalars = T.train_step(tnet, tcfg, tstate, tbatch, tkey)
    np.testing.assert_allclose(float(tscalars["grad_norm"]), float(scalars["grad_norm"]), rtol=1e-3)
    for k in ("loss/total", "loss/param_total", "metric/roll_error", "metric/vfov_error"):
        np.testing.assert_allclose(float(tscalars[k]), float(scalars[k]), rtol=1e-4, err_msg=k)
    assert float(tscalars["skipped_nonfinite"]) == 0.0 == float(scalars["skipped_nonfinite"])
    assert tnew.step == 1 and int(tnew.opt_state.count) == 1 == int(new_state.step)

    old, jnew = _flat(state.params), _flat(new_state.params)
    tparams = _flat(params_to_jax(tnew.params, "tiny")["params"])
    lr = float(J.make_schedule(jcfg)(0))
    for k in jnew:
        assert np.abs(tparams[k] - jnew[k]).max() <= 2 * lr * (1 + 1e-3), k
    same = np.concatenate([np.isclose(tparams[k], jnew[k], rtol=2.4e-7, atol=0).ravel()
                           for k in judged])
    assert same.mean() >= 0.99, same.mean()
    assert not any(np.array_equal(jnew[k], old[k]) for k in judged)

    jstats = _flat(new_state.batch_stats)
    tstats = _flat(params_to_jax(tnew.batch_stats, "tiny")["batch_stats"])
    assert set(jstats) == set(tstats)
    for k in jstats:
        np.testing.assert_allclose(tstats[k], jstats[k], rtol=1e-4, atol=1e-6, err_msg=str(k))
        assert not np.array_equal(jstats[k], _flat(state.batch_stats)[k]), k
