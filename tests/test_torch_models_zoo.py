"""The port's model zoo against the JAX package, on the CPU: the perspective-bin
encodings, the VGG and ResNet encoders, the FPN decoder (sum, GLU and
feed-forward fusion), the up and latitude decoders, and the registry.

Inputs come from a numpy seed; each JAX module is initialised by Flax, its
weights carried across with models/weights.py's ``zoo_params_from_jax`` (no
leaf left over either way) and run on the same inputs. Tolerances, set
before any run: bins equal, decodes within 1e-6; VGG, ResNet and FPN outputs
within 1e-5 of the largest output (relative), in evaluation and, for the
BatchNorm of ResNet, training mode, with the batch statistics within 1e-5;
the decoders within 1e-4 (their NMF sums 7 steps in float32 in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geocalib_tpu.models import encoders as jenc
from geocalib_tpu.models import fpn as jfpn
from geocalib_tpu.models import geocalib_net as jnet
from geocalib_tpu.models import perspective_encoding as jpe
from geocalib_tpu.models import registry as jreg
from geocalib_tpu_torch.models import encoders as tenc
from geocalib_tpu_torch.models import fpn as tfpn
from geocalib_tpu_torch.models import geocalib_net as tnet
from geocalib_tpu_torch.models import perspective_encoding as tpe
from geocalib_tpu_torch.models import registry as treg
from geocalib_tpu_torch.models.weights import params_from_jax, zoo_params_from_jax, zoo_params_to_jax


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work (see tests/test_torch_eval.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _trees_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _trees_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], b[k])


def _close(out, ref, tol=1e-5):
    ref = np.asarray(ref)
    out = out.detach().numpy() if torch.is_tensor(out) else np.asarray(out)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-6))


def _carry(port, variables):
    """Load the Flax variables into the port's module, checking the mapping both ways."""
    tree = _np({"params": variables["params"], "batch_stats": variables.get("batch_stats", {})})
    port.load_state_dict(zoo_params_from_jax(port, tree), strict=True)
    back = zoo_params_to_jax(port)
    _trees_equal(back["params"], tree["params"])
    _trees_equal(back["batch_stats"], tree["batch_stats"])
    return port


# ------------------------------------------------------------------ encodings

def test_up_bins_match_jax():
    rng = np.random.default_rng(0)
    angles = rng.uniform(-np.pi, np.pi, (4, 8, 8)).astype(np.float32)
    field = np.stack([np.cos(angles), np.sin(angles)], -1)
    field[0, 0] = 0.0  # invalid pixel
    field[0, 1] = [-1.0, 0.0]  # atan2 at ±180°, the modulo's edge
    for n in (73, 5, 360):
        jb = np.asarray(jpe.encode_up_bin(jnp.asarray(field), n))
        tb = tpe.encode_up_bin(torch.from_numpy(field), n)
        assert tb.dtype == torch.int32
        np.testing.assert_array_equal(tb.numpy(), jb)
        np.testing.assert_allclose(tpe.decode_up_bin(tb, n).numpy(),
                                   np.asarray(jpe.decode_up_bin(jnp.asarray(jb), n)), atol=1e-6)


def test_latitude_bins_match_jax():
    lat = np.random.default_rng(1).uniform(-1.4, 1.4, (4, 8, 8)).astype(np.float32)
    lat[0, 0, :4] = np.radians([-90.0, 0.0, 45.0, 89.0]).astype(np.float32)  # on boundaries
    for n in (180, 7, 64):
        jb = np.asarray(jpe.encode_bin_latitude(jnp.asarray(lat), n))
        tb = tpe.encode_bin_latitude(torch.from_numpy(lat), n)
        np.testing.assert_array_equal(tb.numpy(), jb)
        np.testing.assert_allclose(tpe.decode_bin_latitude(tb, n).numpy(),
                                   np.asarray(jpe.decode_bin_latitude(jnp.asarray(jb), n)),
                                   atol=1e-6)


# ------------------------------------------------------------------ encoders and FPN

@pytest.mark.parametrize("name", ["vgg", "resnet"])
def test_encoders_match_jax(name):
    img = np.random.default_rng(2).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    if name == "vgg":
        jm, tm = jenc.VGG(dims=(8, 12, 16, 24), convs_per_stage=1), tenc.VGG((8, 12, 16, 24), 1)
    else:
        jm, tm = (jenc.ResNet(dims=(8, 12, 16, 24), blocks_per_stage=1),
                  tenc.ResNet((8, 12, 16, 24), 1))
    variables = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(img))
    if "batch_stats" in variables:  # non-trivial running statistics for evaluation
        variables = {**variables, "batch_stats": jax.tree.map(
            lambda v: v + jnp.asarray(np.random.default_rng(v.size).uniform(0.1, 0.5, v.shape),
                                      v.dtype), variables["batch_stats"])}
    _carry(tm, variables)
    x = torch.from_numpy(img).permute(0, 3, 1, 2)
    ref = jm.apply(variables, jnp.asarray(img))
    out = tm.eval()(x)
    assert [o.shape[2] for o in out] == [16, 8, 4, 2]
    for o, r in zip(out, ref):
        _close(o.permute(0, 2, 3, 1), r)
    if name == "resnet":  # training mode: batch statistics and their running update
        ref, mut = jm.apply(variables, jnp.asarray(img), train=True, mutable=["batch_stats"])
        out = tm.train()(x)
        for o, r in zip(out, ref):
            _close(o.permute(0, 2, 3, 1), r)
        stats = zoo_params_to_jax(tm)["batch_stats"]
        for a, b in zip(jax.tree.leaves(stats), jax.tree.leaves(_np(mut["batch_stats"]))):
            _close(a, b)


@pytest.mark.parametrize("fusion", ["sum", "glu", "ff"])
def test_fpn_matches_jax(fusion):
    rng = np.random.default_rng(3)
    hl = [rng.normal(size=(1, 16 // 2**i, 16 // 2**i, c)).astype(np.float32)
          for i, c in enumerate((8, 12, 16, 24))]
    ll = rng.normal(size=(1, 64, 64, 16)).astype(np.float32)
    jm = jfpn.FPN(out_channels=16, fusion=fusion)
    variables = jm.init({"params": jax.random.PRNGKey(0)}, [jnp.asarray(h) for h in hl],
                        jnp.asarray(ll))
    tm = _carry(tfpn.FPN(16, fusion, (8, 12, 16, 24), 16), variables)
    feats, conf = jm.apply(variables, [jnp.asarray(h) for h in hl], jnp.asarray(ll))
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    tf, tc = tm([nchw(h) for h in hl], nchw(ll))
    assert tf.shape == (1, 16, 64, 64) and tc.shape == (1, 64, 64)
    _close(tf.permute(0, 2, 3, 1), feats)
    _close(tc, conf)


def test_zoo_mapping_refuses_a_tree_of_another_configuration():
    img = jnp.zeros((1, 64, 64, 3))
    variables = jenc.VGG(dims=(8, 12, 16, 24), convs_per_stage=2).init(
        {"params": jax.random.PRNGKey(0)}, img)
    with pytest.raises(ValueError, match="unmapped"):
        zoo_params_from_jax(tenc.VGG((8, 12, 16, 24), 1), _np(variables))


@pytest.mark.parametrize("name", ["up", "latitude"])
def test_decoders_match_jax(name):
    """The registry's decoders.up_decoder / latitude_decoder (evaluation path)."""
    rng = np.random.default_rng(4)
    hl = [rng.normal(size=(1, 8 // 2**i, 8 // 2**i, c)).astype(np.float32)
          for i, c in enumerate((16, 24, 32, 48))]
    ll = rng.normal(size=(1, 32, 32, 16)).astype(np.float32)
    jcls, tcls = ((jnet.UpDecoder, tnet.UpDecoder) if name == "up"
                  else (jnet.LatitudeDecoder, tnet.LatitudeDecoder))
    jm = jcls(out_channels=16, ham_channels=64)
    variables = jm.init({"params": jax.random.PRNGKey(0)}, [jnp.asarray(h) for h in hl],
                        jnp.asarray(ll))
    ref = jm.apply(variables, [jnp.asarray(h) for h in hl], jnp.asarray(ll))
    # the decoder's leaves are GeoCalibNet's up (or latitude) head's, under its name
    wrapped = {"params": {jcls.__name__ + "_0": _np(variables["params"])}, "batch_stats": {}}
    tm = tcls(16, 64, 120)
    tm.load_state_dict(_decoder_state(wrapped, "up" if name == "up" else "lat"), strict=True)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    out = tm.eval()([nchw(h) for h in hl], nchw(ll))
    assert set(out) == set(ref)
    for k in ref:
        _close(out[k], ref[k], 1e-4)


def _decoder_state(tree, head):
    """The decoder's state_dict from the JAX decoder's tree, through GeoCalibNet's own
    table of leaves (models/weights.py ``_entries``): its ``{head}_head`` and
    ``{head}_proj`` entries, renamed to the decoder's ``head`` and ``proj``."""
    from geocalib_tpu_torch.models.weights import _entries, _state_from

    entries = [(name.replace(f"{head}_head.", "head.", 1).replace(f"{head}_proj", "proj", 1),
                coll, path, kind) for name, coll, path, kind in _entries("tiny")
               if name.startswith((f"{head}_head.", f"{head}_proj"))]
    return _state_from(tree, entries)


# ------------------------------------------------------------------ registry

def test_registry_resolves_the_same_names():
    assert set(treg._REGISTRY) == set(jreg._REGISTRY)
    for name in treg._REGISTRY:
        if name in ("optimization.vp_from_prior", "networks.dust3r"):
            continue  # import-gated; resolving imports the wrapper module only
        cls, jcls = treg.get_model(name), jreg.get_model(name)
        assert cls.__name__ == jcls.__name__, name
        assert cls.__module__.startswith("geocalib_tpu_torch."), name
    assert treg.get_model("optimization.vp_from_prior").__name__ == "VPEstimator"
    with pytest.raises(ValueError, match="unknown model"):
        treg.get_model("networks.nothing")


def test_default_conf_reads_the_constructor():
    conf = treg.default_conf(treg.get_model("networks.geocalib"))
    assert conf["variant"] == "b" and conf["drop_path_rate"] == 0.0
    jconf = jreg.default_conf(jreg.get_model("networks.deepcalib"))
    assert treg.default_conf(treg.get_model("networks.deepcalib")) == jconf
    assert treg.default_conf(treg.get_model("decoders.fpn"))["fusion"] == "sum"


def test_build_model_merges_and_validates():
    net, params = treg.build_model("networks.geocalib", {"variant": "tiny"})
    assert net.variant == "tiny" and params is None
    with pytest.raises(ValueError, match="unknown conf keys"):
        treg.build_model("networks.geocalib", {"not_a_field": 1})
    dc, _ = treg.build_model("networks.deepcalib", {"block_config": (2, 2), "growth_rate": 8,
                                                    "num_bins": 32})
    assert dc.num_bins == 32 and len(dc.trunk.blocks) == 2


def test_build_model_autoloads_geocalib_weights(tmp_path):
    from geocalib_tpu.extractor import save_params

    net = jnet.GeoCalibNet(variant="tiny")
    shapes = jax.eval_shape(lambda: net.init({"params": jax.random.PRNGKey(0)},
                                             jnp.zeros((1, 64, 64, 3))))
    rng = np.random.default_rng(5)
    variables = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(a.dtype), shapes)
    path = tmp_path / "params.msgpack"
    save_params(variables, path)
    module, loaded = treg.build_model("networks.geocalib", {"variant": "tiny", "weights": str(path)})
    ref = params_from_jax(_np(variables), "tiny")
    assert set(loaded) == set(ref)
    for k, v in ref.items():
        assert torch.equal(loaded[k], v) and torch.equal(module.state_dict()[k], v), k


def test_build_model_refuses_other_weights():
    with pytest.raises(ValueError, match="only supported for 'networks.geocalib'"):
        treg.build_model("networks.deepcalib", {"weights": "weights/deepcalib_deepcalib_r04.msgpack"})
    for name in ("pinhole", "distorted", "checkpoint.tar"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
            treg.build_model("networks.geocalib", {"weights": name})
