"""The training loop's I/O against the JAX package, on the CPU: config, the msgpack
writer, checkpoints, export, the metrics writer and the debug tools.

Bounds: everything here is exact. The msgpack writer keeps each dict's key
order, as Flax's ``to_bytes`` (the JAX ``save_params``) does, so its bytes
equal Flax's for the same tree; the port's ``save_params`` sorts the keys
below the two collections, as a jitted Flax init has them, so it rewrites the
committed r05 file byte for byte and writes the JAX ``save_params`` bytes of
a JAX-initialised state.
"""

import importlib
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from geocalib_tpu.extractor import load_params as jax_load_params, save_params as jax_save_params
from geocalib_tpu.training.debug import audit_gradients as jax_audit
from geocalib_tpu.utils import config as jconfig
from geocalib_tpu.utils.summary_writer import SummaryWriter as JWriter
from geocalib_tpu_torch.extractor import save_params
from geocalib_tpu_torch.models.weights import (params_from_jax, params_to_jax, read_flax_msgpack,
                                               write_flax_msgpack)
from geocalib_tpu_torch.training import debug
from geocalib_tpu_torch.training.checkpoint import ExperimentManager
from geocalib_tpu_torch.training.export import export_checkpoint
from geocalib_tpu_torch.training.train import default_conf
from geocalib_tpu_torch.training.train_step import (AdamState, TrainConfig, TrainState,
                                                    create_train_state)
from geocalib_tpu_torch.utils import config as tconfig
from geocalib_tpu_torch.utils.summary_writer import SummaryWriter as TWriter

ROOT = Path(__file__).resolve().parents[1]
R05 = ROOT / "weights" / "geocalib_synth_r05.msgpack"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ config

RAW = ["1", "-3", "+5", "0", "010", "0x1F", "0b101", "1_000", "1:30", "1.5", "1e-5", "1.0e-05",
       "1.0e5", ".5", "-.inf", "1.", "3.0e+2", "true", "False", "yes", "off", "null", "~", "",
       "foo", "foo bar", "[1, 2]", "[]", "[a, 'b c', \"d\", 1.5, null, [1, 2]]",
       "[80000, 130000]", " 7 ", "'x'", '"y\\n"', "1:30.5", "-0", "[1,2,]", "unroll"]


@pytest.mark.parametrize("raw", RAW)
def test_parse_value_matches_yaml(raw):
    out, ref = tconfig._parse_value(raw), yaml.safe_load(raw)
    assert out == ref and type(out) is type(ref)


DOTLISTS = [[], ["train.lr=1e-5", "train.variant=tiny"], ["seed=3", "data.batch_size=8"],
            ["train.decay_milestones=[10, 20]", "new.key.deep=null", "train.lm_grad_mode=unroll"],
            ["train.staged_subset=0x10", "data.augmentation=device", "train.fused_forward=off"]]


@pytest.mark.parametrize("dotlist", DOTLISTS, ids=lambda d: ",".join(d) or "none")
def test_merge_and_dotlist_match_jax(dotlist, tmp_path):
    extra = {"train": {"lr": 3e-4, "total_steps": 8}, "data": {"dataset_dir": "x"}}
    out = tconfig.apply_dotlist(tconfig.merge(default_conf, extra, None), dotlist)
    ref = jconfig.apply_dotlist(jconfig.merge(default_conf, extra, None), dotlist)
    assert out == ref
    tconfig.save_yaml(out, tmp_path / "c.yaml")
    assert jconfig.load_yaml(tmp_path / "c.yaml") == out == tconfig.load_yaml(tmp_path / "c.yaml")
    assert tconfig.get_path(out, "train.lr") == jconfig.get_path(ref, "train.lr")


def test_save_yaml_floats_read_back_as_floats(tmp_path):
    conf = {"a": 1e-5, "b": 1e20, "c": -2.5e-300, "d": 0.1, "e": 3.0, "f": [1e-7, 2],
            "s": "quote \" and \\ and \n and é", "n": None, "t": True, "nested": {"x": {}}}
    tconfig.save_yaml(conf, tmp_path / "c.yaml")
    assert yaml.safe_load((tmp_path / "c.yaml").read_text()) == conf
    assert json.loads((tmp_path / "c.yaml").read_text()) == conf
    with pytest.raises(ValueError):
        tconfig.save_yaml({"x": float("nan")}, tmp_path / "bad.yaml")


def test_load_yaml_reads_block_yaml_with_pyyaml():
    path = ROOT / "geocalib_tpu" / "configs" / "geocalib.yaml"
    assert tconfig.load_yaml(path) == jconfig.load_yaml(path)


# ------------------------------------------------------------------ msgpack writer

def _tiny_tree():
    _, state = create_train_state(TrainConfig(variant="tiny"), device="cpu")
    return params_to_jax({**state.params, **state.batch_stats}, "tiny")


def _equal_trees(a, b):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b)
        for k in b:
            _equal_trees(a[k], b[k])
    else:
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("which", ["tiny", "r05"])
def test_msgpack_writer_matches_flax(which, tmp_path):
    tree = _tiny_tree() if which == "tiny" else read_flax_msgpack(R05)
    path = tmp_path / "w.msgpack"
    write_flax_msgpack(tree, path)
    data = path.read_bytes()
    assert data == serialization.to_bytes(tree)
    _equal_trees(serialization.msgpack_restore(data), tree)
    _equal_trees(read_flax_msgpack(path), tree)
    if which == "tiny":
        jax_save_params(tree, tmp_path / "j.msgpack")
        assert (tmp_path / "j.msgpack").read_bytes() == data
    else:
        assert data == R05.read_bytes()
        save_params(params_from_jax(tree, "b"), tmp_path / "s.msgpack")
        assert (tmp_path / "s.msgpack").read_bytes() == R05.read_bytes()


def test_save_params_writes_jax_save_params_bytes(tmp_path):
    jtrain = importlib.import_module("geocalib_tpu.training.train_step")
    _, jstate = jtrain.create_train_state(jax.random.PRNGKey(0), jtrain.TrainConfig(variant="tiny"),
                                          (1, 64, 64, 3))
    jax_save_params({"params": jstate.params, "batch_stats": jstate.batch_stats},
                    tmp_path / "j.msgpack")
    tree = jax.tree.map(np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    save_params(params_from_jax(tree, "tiny"), tmp_path / "t.msgpack", "tiny")
    assert (tmp_path / "t.msgpack").read_bytes() == (tmp_path / "j.msgpack").read_bytes()
    _equal_trees(jax.tree.map(np.asarray, jax_load_params(tmp_path / "t.msgpack", "tiny")), tree)
    with pytest.raises(ValueError, match="missing"):
        save_params({}, tmp_path / "x.msgpack", "tiny")


# ------------------------------------------------------------------ checkpoints

def _state(seed):
    _, state = create_train_state(TrainConfig(variant="tiny"), seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed)
    rnd = lambda tree: {k: torch.rand(v.shape, generator=g) for k, v in tree.items()}
    return TrainState(seed, state.params, rnd(state.batch_stats),
                      AdamState(torch.tensor(seed, dtype=torch.int32), rnd(state.params),
                                rnd(state.params)))


def _same(a, b):
    trees = lambda s: (s.params, s.batch_stats, s.opt_state.mu, s.opt_state.nu)
    return (a.step == b.step and torch.equal(a.opt_state.count, b.opt_state.count) and all(
        set(x) == set(y) and all(torch.equal(x[k], y[k]) for k in x)
        for x, y in zip(trees(a), trees(b))))


def test_checkpoints_restore_bit_for_bit_with_retention_and_best(tmp_path):
    manager = ExperimentManager(tmp_path, keep_last=2)
    states = {s: _state(s) for s in (1, 2, 3)}
    manager.save(states[1], 1, dict(default_conf), {"loss/param_total": 1.0}, is_best=True)
    manager.save(states[2], 2, dict(default_conf))
    manager.save(states[3], 3)
    names = sorted(p.name for p in tmp_path.glob("checkpoint_*"))
    assert names == ["checkpoint_2", "checkpoint_3", "checkpoint_best"]
    assert manager.latest_step() == 3
    template = _state(9)
    for which, step in (("last", 3), ("best", 1), (2, 2), ("2", 2)):
        state, got = manager.restore(template, which)
        assert got == step and _same(state, states[step]), which
    assert json.loads((tmp_path / "checkpoint_best" / "meta.json").read_text()) == {
        "step": 1, "eval": {"loss/param_total": 1.0}}
    assert jconfig.load_yaml(tmp_path / "checkpoint_2" / "config.yaml") == default_conf
    with pytest.raises(FileNotFoundError):
        manager.restore(template, 1)
    with pytest.raises(FileNotFoundError):
        ExperimentManager(tmp_path / "empty").restore(template)


def test_restore_refuses_another_shape(tmp_path):
    ExperimentManager(tmp_path).save(_state(1), 1)
    _, other = create_train_state(TrainConfig(variant="tiny"), device="cpu")
    key = next(iter(other.params))
    other.params[key] = torch.zeros(3)
    with pytest.raises(ValueError, match=key):
        ExperimentManager(tmp_path).restore(other)


def test_export_checkpoint_is_read_by_jax_load_params(tmp_path):
    conf = tconfig.merge(default_conf, {"train": {"variant": "tiny"}})
    state = _state(4)
    manager = ExperimentManager(tmp_path)
    tconfig.save_yaml(conf, tmp_path / "config.yaml")
    manager.save(state, 4, conf, {"x": 1.0}, is_best=True)
    manager.save(_state(5), 5, conf)
    for kw, want in (({}, _state(5)), ({"best": True}, state), ({"step": 4}, state)):
        out = tmp_path / "w.msgpack"
        export_checkpoint(tmp_path, out, **kw)
        ref = params_to_jax({**want.params, **want.batch_stats}, "tiny")
        _equal_trees(jax.tree.map(np.asarray, jax_load_params(out, "tiny")), ref)
        back = params_from_jax(read_flax_msgpack(out), "tiny")
        assert all(torch.equal(back[k], v) for k, v in want.params.items())


# ------------------------------------------------------------------ metrics writer

def test_summary_writer_records_match_jax(tmp_path):
    calls = [({"loss/total": 1.5, "metric/roll_error": np.float32(0.25)}, 0, ""),
             ({"loss/total": torch.tensor(1.25)}, 10, "val/"),
             ({"images_per_s": 3}, 20, "")]
    for name, cls in (("jax", JWriter), ("torch", TWriter)):
        writer = cls(tmp_path / name, backend="none")
        for scalars, step, prefix in calls:
            writer.add_scalars({k: float(v) for k, v in scalars.items()}, step, prefix=prefix)
        writer.close()
    read = lambda name: [{k: v for k, v in json.loads(line).items() if k != "time"} for line in
                         (tmp_path / name / "metrics.jsonl").read_text().splitlines()]
    assert read("torch") == read("jax") and len(read("jax")) == 3
    with pytest.raises(ImportError):
        TWriter(tmp_path / "w", backend="wandb")


# ------------------------------------------------------------------ debug tools

def test_audit_gradients_names_match_jax():
    _, state = create_train_state(TrainConfig(variant="tiny"), device="cpu")
    g = torch.Generator().manual_seed(0)
    grads = {k: torch.randn(v.shape, generator=g) for k, v in state.params.items()}
    dead = ["up_proj.weight", "backbone.stages.1.0.attn.proj1.bias", "lat_head.conf.bias"]
    for k in dead:
        grads[k] = torch.zeros_like(grads[k])
    out = debug.audit_gradients(grads, "tiny")
    ref = jax_audit(params_to_jax(grads, "tiny")["params"])
    assert out == ref and len(out) == len(dead)


def test_detect_anomaly_raises():
    loss = torch.tensor(1.0)
    grads = {"a": torch.ones(3), "b": torch.tensor([1.0, float("inf")])}
    debug.check_finite(torch.tensor(float("nan")), grads)  # off: nothing raises
    with debug.detect_anomaly():
        with pytest.raises(FloatingPointError, match="b"):
            debug.check_finite(loss, grads)
        with pytest.raises(FloatingPointError, match="loss"):
            debug.check_finite(torch.tensor(float("nan")), {})
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    assert not torch.is_anomaly_enabled()


# ------------------------------------------------------------------ the CLI

def test_cli_refuses_figures_and_parses_the_dotlist(tmp_path):
    """The default conf asks for figures (train.figures_every 1000), which need the
    unported visualization/: training raises at the start and names the fix. With
    figures off, the dotlist reaches the loop, which then fails on the missing data."""
    from geocalib_tpu_torch.training import train

    with pytest.raises(NotImplementedError, match="train.figures_every=0"):
        train.main(["exp", "--output_root", str(tmp_path), "--device", "cpu"])
    assert not (tmp_path / "exp").exists()
    with pytest.raises(FileNotFoundError, match="nowhere"):
        train.main(["exp", "--output_root", str(tmp_path), "--device", "cpu",
                    "train.figures_every=0", "train.variant=tiny",
                    f"data.dataset_dir={tmp_path / 'nowhere'}"])
    conf = tconfig.load_yaml(tmp_path / "exp" / "config.yaml")
    assert conf["train"]["variant"] == "tiny" and conf["train"]["figures_every"] == 0
