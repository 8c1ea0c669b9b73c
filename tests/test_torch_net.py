"""The port's network against GeoCalibNet.apply, in float32 on the CPU.

The tiny variant with random Flax parameters, carried across by
params_from_jax. The fields pass through ~20 convolutions, two NMFs of 8
multiplicative updates and normalizations; float32 sums in other orders give
deviations of a few 1e-5, so the bound is atol 2e-4 on unit-range fields.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geocalib_tpu.models import GeoCalibNet as JNet
from geocalib_tpu.models import MSCAN as JMSCAN
from geocalib_tpu.models.fused_heads import fused_forward
from geocalib_tpu_torch.models import GeoCalibNet, params_from_jax, read_flax_msgpack

KEYS = ("up_field", "up_confidence", "latitude_field", "latitude_confidence")


def _jax_variables(variant, H, W, seed=0):
    net = JNet(variant=variant)
    v = net.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, H, W, 3)))
    # non-trivial BN statistics and layer scales so the mapping of each is exercised
    rng = np.random.default_rng(seed)
    bs = jax.tree.map(lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32), v["batch_stats"])
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32)
        if "layer_scale" in jax.tree_util.keystr(path) else a, v["params"])
    return {"params": params, "batch_stats": bs}


def _port(variables, variant):
    tree = jax.tree.map(np.asarray, variables)
    net = GeoCalibNet(variant)
    net.load_state_dict(params_from_jax(tree, variant))
    return net.eval()


@pytest.fixture(scope="module")
def tiny():
    H, W = 64, 96
    variables = _jax_variables("tiny", H, W)
    image = np.random.default_rng(1).uniform(size=(2, H, W, 3)).astype(np.float32)
    return variables, _port(variables, "tiny"), image


def test_backbone_matches(tiny):
    variables, net, image = tiny
    from geocalib_tpu.models.mscan import MSCAN_VARIANTS

    dims, ratios, depths = MSCAN_VARIANTS["tiny"]
    ref = JMSCAN(embed_dims=dims, mlp_ratios=ratios, depths=depths).apply(
        {"params": variables["params"]["MSCAN_0"], "batch_stats": variables["batch_stats"]["MSCAN_0"]},
        jnp.asarray(image))
    with torch.no_grad():
        out = net.backbone(torch.from_numpy(image).permute(0, 3, 1, 2))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.permute(0, 2, 3, 1).numpy(), np.asarray(r), rtol=1e-4, atol=2e-4)


def test_fields_match_apply_and_fused(tiny):
    variables, net, image = tiny
    ref = JNet(variant="tiny").apply(variables, jnp.asarray(image))
    fused = fused_forward(variables, jnp.asarray(image), "tiny")
    with torch.no_grad():
        out = net(torch.from_numpy(image))
    for k in KEYS:
        assert tuple(out[k].shape) == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=2e-4, err_msg=k)
        np.testing.assert_allclose(out[k].numpy(), np.asarray(fused[k]), rtol=1e-4, atol=2e-4, err_msg=k)


def test_state_dict_is_complete(tiny):
    variables, net, _ = tiny
    sd = params_from_jax(jax.tree.map(np.asarray, variables), "tiny")
    assert set(sd) == set(net.state_dict())
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(variables))
    n_bn = sum(1 for k in sd if k.endswith("num_batches_tracked"))
    assert sum(t.numel() for t in sd.values()) == n_jax + n_bn


@pytest.mark.slow
def test_r05_weights_at_320():
    """The committed weights at full width, MSCAN-B at 320², against the JAX net."""
    from flax import serialization

    path = "weights/geocalib_synth_r05.msgpack"
    variables = serialization.msgpack_restore(open(path, "rb").read())
    net = GeoCalibNet("b")
    net.load_state_dict(params_from_jax(read_flax_msgpack(path), "b"))
    image = np.random.default_rng(2).uniform(size=(1, 320, 320, 3)).astype(np.float32)
    ref = JNet(variant="b").apply(variables, jnp.asarray(image))
    with torch.no_grad():
        out = net.eval()(torch.from_numpy(image))
    for k in KEYS:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-3, atol=2e-3, err_msg=k)
