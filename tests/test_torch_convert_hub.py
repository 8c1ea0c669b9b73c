"""The port's torch-checkpoint converter and hub against the JAX package's.

No original GeoCalib checkpoint is on this machine, so one is made: the
committed r05 Flax tree turned back into the original torch state_dict by
inverting the converter's table (``_original_state_dict``, a test helper).
Converted by both packages, it must give the r05 tensors back bit for bit;
the ``siclib`` prefix strip, the ``gravity_head`` → ``up_head`` rename and the
refusals of unmapped and absent keys behave as the JAX converter's. The hub
is held on a ``torch.save``d checkpoint in a temporary directory: its
converted msgpack is the JAX hub's byte for byte and loads in the JAX
package, and a release name is resolved only from a converted file already
in the cache (the hub's download is replaced by a refusal: nothing here
touches the network).
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from geocalib_tpu.models import convert_torch as jconvert
from geocalib_tpu_torch import hub
from geocalib_tpu_torch.models import convert_torch as tconvert
from geocalib_tpu_torch.models import registry
from geocalib_tpu_torch.models.weights import params_from_jax, read_flax_msgpack

R05 = Path(__file__).resolve().parents[1] / "weights" / "geocalib_synth_r05.msgpack"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _original_state_dict(tree):
    """The original torch state_dict (numpy) whose conversion is ``tree``: the
    converter's table read backwards (HWIO → OIHW), with BatchNorm counters."""
    sd = {}
    for key, (path, kind) in tconvert._build_mapping().items():
        leaf = np.asarray(functools.reduce(lambda node, k: node[k], path, tree))
        sd[key] = np.ascontiguousarray(leaf.transpose(3, 2, 0, 1) if kind == "conv" else leaf)
        if key.endswith(".running_var"):
            sd[key[: -len("running_var")] + "num_batches_tracked"] = np.array(7, np.int64)
    return sd


@pytest.fixture(scope="module")
def r05():
    tree = read_flax_msgpack(R05)
    return tree, _original_state_dict(tree), params_from_jax(tree)


@pytest.fixture
def no_network(tmp_path, monkeypatch):
    """An empty hub cache in tmp_path, and a hub whose download raises."""
    cache = tmp_path / "cache"
    monkeypatch.setenv("GEOCALIB_TPU_CACHE", str(cache))

    def refuse(url, dest):
        raise RuntimeError(f"download of {url} refused")

    monkeypatch.setattr(hub, "_download", refuse)
    return cache


def _equal_state(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_converter_matches_jax_bit_for_bit(r05):
    tree, sd, want = r05
    def leaves(node):
        return sum(leaves(v) for v in node.values()) if isinstance(node, dict) else 1

    assert len(tconvert._build_mapping()) == leaves(tree)  # the table covers r05 wholly
    port = tconvert.state_dict_from_torch(sd)
    jax_side = params_from_jax(jconvert.convert_state_dict(sd))
    _equal_state(port, want)
    _equal_state(jax_side, want)
    # the Flax-shaped trees themselves, key order included
    assert list(tconvert.convert_state_dict(sd)) == list(jconvert.convert_state_dict(sd))


def test_siclib_prefix_and_gravity_head_rename(r05):
    tree, sd, want = r05
    renamed = {k.replace("up_head", "gravity_head"): v for k, v in sd.items()}
    nested = {".".join(k.split(".")[:1] + ["model"] + k.split(".")[1:]): v
              for k, v in renamed.items()}
    for variant in (renamed, nested):
        _equal_state(tconvert.state_dict_from_torch(variant), want)
        _equal_state(params_from_jax(jconvert.convert_state_dict(variant)), want)


@pytest.mark.parametrize("fault", ["unmapped", "absent"])
def test_converter_refusals(r05, fault):
    tree, sd, _ = r05
    bad = dict(sd)
    if fault == "unmapped":
        bad["perspective_decoder.extra_head.weight"] = np.zeros(3, np.float32)
        match = "unmapped reference keys"
    else:
        del bad["ll_enc.conv1.conv.bias"]
        match = "reference keys absent from checkpoint"
    with pytest.raises(ValueError, match=match) as port:
        tconvert.convert_state_dict(bad)
    with pytest.raises(ValueError, match=match) as jax_side:
        jconvert.convert_state_dict(bad)
    assert str(port.value) == str(jax_side.value)


def test_hub_converts_a_checkpoint_once_and_loads_it(r05, tmp_path, no_network, monkeypatch):
    tree, sd, want = r05
    tar = tmp_path / "geocalib-test.tar"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, tar)
    assert {k: v.dtype for k, v in tconvert.load_torch_checkpoint(str(tar)).items()} == \
        {k: v.dtype for k, v in sd.items()}

    path = hub.cached_params_path(str(tar))
    assert path == no_network / "geocalib-test.msgpack" and path.exists()
    _equal_state(params_from_jax(read_flax_msgpack(path)), want)
    # the JAX hub writes the same bytes into its own cache
    from geocalib_tpu import hub as jhub

    monkeypatch.setenv("GEOCALIB_TPU_CACHE", str(tmp_path / "jax_cache"))
    jpath = jhub.cached_params_path(str(tar))
    assert jpath.read_bytes() == path.read_bytes()
    monkeypatch.setenv("GEOCALIB_TPU_CACHE", str(no_network))

    # a second call reads the cache and does not write it again
    stamp = path.stat().st_mtime_ns
    calib = hub.load(str(tar), device="cpu", compute_dtype="float32")
    assert path.stat().st_mtime_ns == stamp and calib.device.type == "cpu"
    _equal_state({k: v for k, v in calib.net.state_dict().items()}, want)
    with pytest.raises(FileNotFoundError, match="neither a release name nor a file"):
        hub.cached_params_path(str(tmp_path / "missing.tar"))


def test_cached_msgpack_loads_in_the_jax_package(r05, tmp_path, no_network):
    """The port's converted file, read by the JAX package's own ``load_params``."""
    import jax

    from geocalib_tpu.extractor import load_params

    tree, sd, _ = r05
    tar = tmp_path / "ckpt.tar"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, tar)
    loaded = load_params(hub.cached_params_path(str(tar)))
    flat_want = jax.tree_util.tree_leaves_with_path(tree)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(loaded))
    assert len(flat_got) == len(flat_want)
    for key, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[key]), leaf, err_msg=str(key))


def test_release_name_only_from_the_cache(r05, tmp_path, no_network):
    """"pinhole" resolves to the converted file in the cache, with no download; the
    registry's weight autoload and ``hub.load`` take it; "distorted", absent, would
    download, and the refusal shows that it tried."""
    tree, sd, want = r05
    tar = tmp_path / "src.tar"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, tar)
    converted = hub.cached_params_path(str(tar))
    cached = no_network / "geocalib-pinhole.msgpack"
    converted.rename(cached)

    assert hub.cached_params_path("pinhole") == cached
    _, params = registry.build_model("networks.geocalib", {"weights": "pinhole"})
    _equal_state({k: v for k, v in params.items()}, want)
    calib = hub.load("pinhole", device="cpu", compute_dtype="float32")
    _equal_state(calib.net.state_dict(), want)
    with pytest.raises(RuntimeError, match="geocalib-distorted.tar refused"):
        hub.cached_params_path("distorted")
