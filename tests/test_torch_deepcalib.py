"""The port's DeepCalib baseline against the JAX package, on the CPU: the bin
centers and decoding, the network at a tiny size in training and evaluation
mode, the committed weights/deepcalib_deepcalib_r04.msgpack, the
``deepcalib`` route of evaluate_baseline, and the trainer.

Inputs come from a numpy seed, the committed data/openpano_synth, or a tiny
dataset that the JAX package generates (tests/test_deepcalib_training.py's).
Tolerances, set before any run:
- bin centers bit for bit; decoded values within 1e-6;
- the tiny network ((2, 2), growth 8, 32 bins) from Flax's initialisation:
  logits within 1e-4, batch statistics within 1e-5, loss within 1e-5;
- the r04 weights: every leaf maps both ways; logits within 1e-4 on 2 images
  at 96×96 through the bf16 route of the JAX callers;
- evaluate_baseline("deepcalib") on 8 images: each head's bin equal wherever
  its top two logits (JAX's) are more than 1e-3 apart, and the summary within
  1e-4 relative when every bin is equal;
- the trainer's step against JAX's make_train_step (same state, key and staged
  rows, no augmentation; 2 steps): loss within 1e-5 relative, each head's error
  within 1e-5, and the state by ``_params_close`` (each leaf within 1e-4 of
  its largest value, but for at most 0.1% of elements whose gradient sits at
  the float32 floor, which Adam moves by up to twice the summed step sizes);
  the port's export read by the JAX package's evaluate_baseline (median roll
  error within 1e-3 relative); the checkpoint restored bit for bit;
- slow (JAX's whole trainer compiles the augmentation into its step, over a
  minute): the two trainers from one msgpack of JAX's initialisation, 3
  steps: each batch's rows equal and its augmented images by
  tests/test_torch_augment.py's rule for the device augmentation (99.9%
  within 1e-6, all within 1/24); fed JAX's own batches, the port's logged
  loss within 1e-4 relative and each head's error within 1e-4 at every step,
  and its final parameters by ``_params_close``; with its own batches (the
  control: only the augmentation's last bits differ), the loss within 1e-2.
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from geocalib_tpu.eval import baselines_cli as jcli
from geocalib_tpu.models import deepcalib as jdc
from geocalib_tpu.training import device_store as jstore
from geocalib_tpu.training import train_deepcalib as jtrain
from geocalib_tpu.utils.config import merge as jmerge
from geocalib_tpu_torch.eval import baselines_cli as tcli
from geocalib_tpu_torch.models import deepcalib as tdc
from geocalib_tpu_torch.models.weights import (deepcalib_params_from_jax,
                                               deepcalib_params_to_jax, read_flax_msgpack)
from geocalib_tpu_torch.training import device_store as tstore
from geocalib_tpu_torch.training import train_deepcalib as ttrain
from geocalib_tpu_torch.utils import threefry

ROOT = Path(__file__).resolve().parents[1]
SYNTH = ROOT / "data" / "openpano_synth"
R04 = ROOT / "weights" / "deepcalib_deepcalib_r04.msgpack"
HEADS = ("roll", "rho", "vfov", "k1_hat")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work (see tests/test_torch_eval.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_net(variables, block_config, **kw):
    tree = _np({"params": variables["params"], "batch_stats": variables["batch_stats"]})
    net = tdc.DeepCalib(block_config=block_config, **kw)
    net.load_state_dict(deepcalib_params_from_jax(tree, block_config), strict=True)
    return net


def _close(out, ref, tol):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(out.detach().float().numpy(), ref, rtol=0,
                               atol=tol * max(float(np.abs(ref).max()), 1e-6))


# ------------------------------------------------------------------ bins

@pytest.mark.parametrize("num_bins", [256, 32, 16])
def test_bin_centers_match_jax(num_bins):
    for head in HEADS:
        np.testing.assert_array_equal(tdc.bin_centers(*tdc.BOUNDS[head], num_bins).numpy(),
                                      np.asarray(jdc.bin_centers(*jdc.BOUNDS[head], num_bins)))


def test_bins_to_val_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 32)).astype(np.float32)
    logits[1, 4] = logits[1, 9] = logits[1].max() + 1  # a tie: the first bin
    centers = jdc.bin_centers(*jdc.BOUNDS["vfov"], 32)
    tcenters = tdc.bin_centers(*tdc.BOUNDS["vfov"], 32)
    for soft in (False, True):
        np.testing.assert_allclose(
            tdc.bins_to_val(tcenters, torch.from_numpy(logits), soft).numpy(),
            np.asarray(jdc.bins_to_val(centers, jnp.asarray(logits), soft)), rtol=1e-6)


# ------------------------------------------------------------------ the network

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_deepcalib_matches_jax(train, dtype):
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    jnet = jdc.DeepCalib(num_bins=32, block_config=(2, 2), growth_rate=8)
    variables = jnet.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(img))
    variables = {**variables, "batch_stats": jax.tree.map(  # non-trivial running statistics
        lambda v: v + jnp.asarray(rng.uniform(0.1, 0.5, v.shape), v.dtype), variables["batch_stats"])}
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    apply = jax.jit(lambda v, x: jnet.apply(v, x.astype(jdt), train=train,
                                            mutable=["batch_stats"] if train else False))
    ref = apply(variables, jnp.asarray(img))
    ref, stats = ref if train else (ref, None)
    net = _port_net(variables, (2, 2), num_bins=32, growth_rate=8).train(train)
    out = net(torch.from_numpy(img).to(tdt))
    for head in HEADS:
        assert out[f"{head}_logits"].dtype == torch.float32
        _close(out[f"{head}_logits"], ref[f"{head}_logits"], 1e-4)
    gt = {h: rng.uniform(*tdc.BOUNDS[h], 2).astype(np.float32) for h in HEADS}
    jl = jdc.DeepCalib.loss({k: v.astype(jnp.float32) for k, v in ref.items()},
                            {k: jnp.asarray(v) for k, v in gt.items()}, 32)
    tl = tdc.DeepCalib.loss(out, {k: torch.from_numpy(v) for k, v in gt.items()}, 32)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=1e-5)
    if train:
        got = deepcalib_params_to_jax(net.state_dict(), (2, 2))["batch_stats"]
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(_np(stats["batch_stats"]))):
            _close(torch.from_numpy(a), b, 1e-5)


def test_r04_weights_map_and_match_jax():
    payload = read_flax_msgpack(R04)
    bc = [payload["conf"]["block_config"][k] for k in sorted(payload["conf"]["block_config"], key=int)]
    assert bc == [4, 8, 12, 8]
    sd = deepcalib_params_from_jax(payload, bc)  # refuses a leaf left over either way
    net = tdc.DeepCalib(num_bins=256, block_config=bc, growth_rate=32)
    net.load_state_dict(sd, strict=True)
    back = deepcalib_params_to_jax(net.state_dict(), bc)
    for coll in ("params", "batch_stats"):
        ja, jb = jax.tree.leaves(back[coll]), jax.tree.leaves(payload[coll])
        assert len(ja) == len(jb) == {"params": 312, "batch_stats": 200}[coll]
        for a, b in zip(ja, jb):
            np.testing.assert_array_equal(a, b)

    img = np.random.default_rng(2).uniform(size=(2, 96, 96, 3)).astype(np.float32)
    jnet = jdc.DeepCalib(num_bins=256, block_config=tuple(bc), growth_rate=32)
    variables = {"params": payload["params"], "batch_stats": payload["batch_stats"]}
    ref = jax.jit(lambda x: jnet.apply(variables, x.astype(jnp.bfloat16)))(jnp.asarray(img))
    out = tcli.deepcalib_outputs(net.eval(), img)
    for head in HEADS:
        _close(out[f"{head}_logits"], ref[f"{head}_logits"], 1e-4)


def _top_two_gap(logits):
    top = np.sort(np.asarray(logits), -1)
    return top[:, -1] - top[:, -2]


def test_evaluate_baseline_deepcalib_matches_jax(tmp_path):
    from PIL import Image

    rows = (SYNTH / "test.csv").read_text().splitlines()[1:9]
    imgs = np.stack([np.asarray(Image.open(SYNTH / "images" / r.split(",")[0]).convert("RGB"),
                                np.float32) / 255.0 for r in rows])
    payload = read_flax_msgpack(R04)
    jnet = jdc.DeepCalib(num_bins=256, block_config=(4, 8, 12, 8), growth_rate=32)
    variables = {"params": payload["params"], "batch_stats": payload["batch_stats"]}
    ref = jax.jit(lambda x: jnet.apply(variables, x.astype(jnp.bfloat16)))(jnp.asarray(imgs))
    out = tcli.deepcalib_outputs(tcli.load_deepcalib(R04, "cpu"), imgs)
    all_equal = True
    for head in HEADS:
        same = out[f"{head}_logits"].argmax(-1).numpy() == np.asarray(ref[f"{head}_logits"]).argmax(-1)
        assert same[_top_two_gap(ref[f"{head}_logits"]) > 1e-3].all(), head
        all_equal &= bool(same.all())

    jsum = jcli.evaluate_baseline("deepcalib", str(SYNTH), max_images=8, weights=str(R04))
    tsum = tcli.evaluate_baseline("deepcalib", str(SYNTH), max_images=8, weights=str(R04),
                                  device="cpu")
    assert set(tsum) == set(jsum) and tsum["n_images"] == jsum["n_images"] == 8
    if all_equal:
        for k, v in jsum.items():
            if not isinstance(v, str):
                np.testing.assert_allclose(tsum[k], v, rtol=1e-4, atol=1e-6, err_msg=k)


# ------------------------------------------------------------------ the trainer

OVERRIDES = {"train": {"total_steps": 3, "warmup_steps": 1, "log_every": 1, "eval_every": 10,
                       "save_every": 10, "input_size": 64, "num_bins": 16, "block_config": [1, 1],
                       "growth_rate": 8},
             "data": {"batch_size": 4}}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX trainer and the port's, from one msgpack of JAX's initialisation, on
    tests/test_deepcalib_training.py's tiny dataset: the port once with its own batches
    and once with the JAX package's (its sample_batch replaced by JAX's, same keys)."""
    from geocalib_tpu.data import generate_dataset

    root = tmp_path_factory.mktemp("deepcalib")
    ds = generate_dataset(str(root / "ds"), n_panos=4, height=64, width=64, crops_per_pano=4)
    conf = jmerge(jtrain.default_conf, OVERRIDES)
    conf["data"]["dataset_dir"] = str(ds)
    conf["train"]["init_weights"] = str(_jax_init(root))

    cwd = Path.cwd()
    runs = {}
    try:
        for name in ("jax", "port", "port_jax_batches"):
            (root / name).mkdir()
            os.chdir(root / name)  # the trainers export to weights/ under the working dir
            if name == "jax":
                runs[name] = jtrain.training(json.loads(json.dumps(conf)), root / name / "exp")
            else:
                sample = ttrain.sample_batch
                if name == "port_jax_batches":
                    ttrain.sample_batch = _jax_sample_batch
                try:
                    runs[name] = ttrain.training(json.loads(json.dumps(conf)), root / name / "exp",
                                                 device="cpu")
                finally:
                    ttrain.sample_batch = sample
    finally:
        os.chdir(cwd)
    logs = {name: [json.loads(line) for line in
                   (root / name / "exp" / "logs" / "metrics.jsonl").read_text().splitlines()]
            for name in runs}
    return {"root": root, "ds": ds, "conf": conf, "logs": logs}


def _jax_sample_batch(images, gt_params, key, batch_size, augment=True):
    """The JAX package's sample_batch on the port's staged rows, as torch tensors."""
    out = jstore.sample_batch(jnp.asarray(images.numpy()), jnp.asarray(gt_params.numpy()),
                              jnp.asarray(np.array(key, np.uint32)), batch_size, augment=augment)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.mark.slow
def test_trainer_batches_match_jax(trained):
    from geocalib_tpu.data.dataset import DatasetConf as JConf, SimpleDataset as JDataset
    from geocalib_tpu_torch.data.dataset import DatasetConf, SimpleDataset

    ds = trained["ds"]
    jstored = jstore.DeviceStore.stage(JDataset(JConf(dataset_dir=str(ds), csv_name="train.csv",
                                                      batch_size=4)), progress=None)
    tstored = tstore.DeviceStore.stage(SimpleDataset(DatasetConf(dataset_dir=str(ds),
                                                                 csv_name="train.csv",
                                                                 batch_size=4)),
                                       device="cpu", progress=None)
    np.testing.assert_array_equal(tstored.images.numpy(), np.asarray(jstored.images))
    jkey, tkey = jax.random.PRNGKey(1), threefry.prng_key(1)
    for _ in range(3):
        jkey, jstep = jax.random.split(jkey)
        tkey, tstep = threefry.split(tkey)
        ref = jstore.sample_batch(jstored.images, jstored.gt_params, jax.random.split(jstep)[0], 4,
                                  augment="deepcalib")
        out = tstore.sample_batch(tstored.images, tstored.gt_params, threefry.split(tstep)[0], 4,
                                  augment="deepcalib")
        np.testing.assert_array_equal(out["gt_params"].numpy(), np.asarray(ref["gt_params"]))
        d = np.abs(out["image"].numpy() - np.asarray(ref["image"]))
        assert (d <= 1e-6).mean() >= 0.999 and d.max() <= 1 / 24, (d.max(), (d > 1e-6).mean())


@pytest.mark.slow
def test_trainer_matches_jax(trained):
    logs = trained["logs"]
    jl = [r for r in logs["jax"] if "loss/total" in r]
    assert len(jl) == 3
    for name, rtol in (("port_jax_batches", 1e-4), ("port", 1e-2)):
        tl = [r for r in logs[name] if "loss/total" in r]
        assert [r["step"] for r in tl] == [r["step"] for r in jl]
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(a["loss/total"], b["loss/total"], rtol=rtol, err_msg=name)
            if name == "port_jax_batches":
                for head in HEADS:
                    k = f"metric/{head}_err"
                    np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-4, err_msg=k)

    root = trained["root"]
    jpay = serialization.msgpack_restore((root / "jax" / "weights" / "deepcalib_exp.msgpack")
                                         .read_bytes())
    tpay = read_flax_msgpack(root / "port_jax_batches" / "weights" / "deepcalib_exp.msgpack")
    assert tpay["conf"] == jax.tree.map(lambda x: x, jpay["conf"])
    _params_close(tpay, jpay, STEP_SUM)


@pytest.fixture(scope="module")
def port_trained(tmp_path_factory):
    """The port's trainer alone (3 steps on the CPU) from a msgpack of JAX's initialisation,
    on the same tiny dataset made by the port's generator (the same CSVs as JAX's)."""
    from geocalib_tpu_torch.data.generate import generate_dataset

    root = tmp_path_factory.mktemp("deepcalib_port")
    ds = generate_dataset(str(root / "ds"), n_panos=4, height=64, width=64, crops_per_pano=4,
                          device="cpu")
    conf = jmerge(jtrain.default_conf, OVERRIDES)
    conf["data"]["dataset_dir"] = str(ds)
    conf["train"]["init_weights"] = str(_jax_init(root))
    cwd = Path.cwd()
    os.chdir(root)
    try:
        scalars = ttrain.training(json.loads(json.dumps(conf)), root / "exp", device="cpu")
    finally:
        os.chdir(cwd)
    return {"root": root, "ds": ds, "conf": conf, "scalars": scalars}


def _jax_init(root: Path) -> Path:
    net = jdc.DeepCalib(num_bins=16, block_config=(1, 1), growth_rate=8)
    variables = jax.jit(net.init)({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)))
    init = root / "init.msgpack"
    init.write_bytes(serialization.to_bytes({"params": variables["params"],
                                             "batch_stats": variables["batch_stats"]}))
    return init


def _params_close(tpay, jpay, step_sum):
    """Each leaf within 1e-4 of its largest value, except where an element's gradient sits
    at the float32 floor: Adam moves it by up to the step size whatever the gradient's
    size, so a sign that rounds the other way moves it by up to twice the summed step
    sizes (step_sum); at most 0.1% of all elements may need that."""
    loose = total = 0
    for coll in ("params", "batch_stats"):
        for a, b in zip(jax.tree.leaves(tpay[coll]), jax.tree.leaves(jpay[coll])):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            d = np.abs(a - b)
            tight = d <= 1e-4 * max(np.abs(b).max(), 1e-6)
            assert (d[~tight] <= 2 * step_sum).all(), d.max()
            loose, total = loose + int((~tight).sum()), total + d.size
    assert loose <= 1e-3 * total, (loose, total)


# lr(0) + lr(1) + lr(2) of OVERRIDES' schedule: 0, then the cosine from 1e-4 over 2 steps
STEP_SUM = 1e-4 * (0.0 + 1.0 + 0.5)


def test_trainer_step_matches_jax_on_a_batch(port_trained):
    """One step of each package's make_train_step from the same state and key on the same
    staged rows, without augmentation: loss, errors and the updated state."""
    from geocalib_tpu.data.dataset import DatasetConf as JConf, SimpleDataset as JDataset
    from geocalib_tpu_torch.data.dataset import DatasetConf, SimpleDataset
    import optax

    ds, conf = port_trained["ds"], port_trained["conf"]
    jstored = jstore.DeviceStore.stage(JDataset(JConf(dataset_dir=str(ds), csv_name="train.csv",
                                                      batch_size=4)), progress=None)
    tstored = tstore.DeviceStore.stage(SimpleDataset(DatasetConf(
        dataset_dir=str(ds), csv_name="train.csv", batch_size=4)), device="cpu", progress=None)
    payload = serialization.msgpack_restore(Path(conf["train"]["init_weights"]).read_bytes())
    jnet = jdc.DeepCalib(num_bins=16, block_config=(1, 1), growth_rate=8)
    t_conf = conf["train"]
    schedule = optax.join_schedules([
        optax.linear_schedule(0.0, t_conf["lr"], t_conf["warmup_steps"]),
        optax.cosine_decay_schedule(t_conf["lr"], t_conf["total_steps"] - t_conf["warmup_steps"])],
        [t_conf["warmup_steps"]])
    opt = optax.chain(optax.clip_by_global_norm(t_conf["clip_grad"]),
                      optax.adamw(schedule, weight_decay=t_conf["weight_decay"]))
    jstate = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=payload["params"],
                               batch_stats=payload["batch_stats"],
                               opt_state=opt.init(payload["params"]))
    # one warm-up step each, so the step under test has a non-zero rate and Adam state
    jstep = jtrain.make_train_step(jnet, opt, 16, 4, "identity")
    net = tdc.DeepCalib(num_bins=16, block_config=(1, 1), growth_rate=8).train()
    sd = deepcalib_params_from_jax(_np(payload), (1, 1))
    tstate = ttrain.create_state(net)
    tstate = ttrain.TrainState(0, {k: sd[k] for k in tstate.params},
                               {k: sd[k] for k in tstate.batch_stats},
                               ttrain.optimizer_init({k: sd[k] for k in tstate.params}))
    cfg = ttrain.TrainConfig(lr=t_conf["lr"], weight_decay=t_conf["weight_decay"],
                             clip_grad=t_conf["clip_grad"])
    tstep = ttrain.make_train_step(net, cfg, ttrain.make_schedule(
        t_conf["lr"], t_conf["warmup_steps"], t_conf["total_steps"]), 16, 4, "identity")
    for k in range(2):
        key = jax.random.PRNGKey(10 + k)
        jstate, jout = jstep(jstate, jstored.images, jstored.gt_params, key)
        tstate, tout = tstep(tstate, tstored.images, tstored.gt_params, threefry.prng_key(10 + k))
        np.testing.assert_allclose(float(tout["loss/total"]), float(jout["loss/total"]), rtol=1e-5)
        for head in HEADS:
            k_ = f"metric/{head}_err"
            np.testing.assert_allclose(float(tout[k_]), float(jout[k_]), rtol=0, atol=1e-5)
    tree = ttrain.export_tree(tstate, (1, 1), 16, 8)
    _params_close(tree, _np({"params": jstate.params, "batch_stats": jstate.batch_stats}),
                  1e-4 * (0.0 + 1.0))


def test_port_export_loads_in_jax_evaluate_baseline(port_trained):
    path = port_trained["root"] / "weights" / "deepcalib_exp.msgpack"
    jsum = jcli.evaluate_baseline("deepcalib", str(port_trained["ds"]), split="test",
                                  weights=str(path))
    tsum = tcli.evaluate_baseline("deepcalib", str(port_trained["ds"]), split="test",
                                  weights=str(path), device="cpu")
    assert jsum["n_images"] == tsum["n_images"] > 0
    np.testing.assert_allclose(tsum["median_roll_error"], jsum["median_roll_error"], rtol=1e-3)


def test_trainer_restores_and_continues(port_trained, tmp_path, monkeypatch):
    """restore=True picks up the last checkpoint bit for bit and runs the remaining steps;
    the export holds the saved state and the conf."""
    from geocalib_tpu_torch.training.checkpoint import ExperimentManager

    monkeypatch.chdir(tmp_path)
    exp = port_trained["root"] / "exp"
    assert np.isfinite(port_trained["scalars"]["loss/total"])
    net = tdc.DeepCalib(num_bins=16, block_config=(1, 1), growth_rate=8)
    state, step = ExperimentManager(exp).restore(ttrain.create_state(net))
    assert step == 3 and state.step == 3 and int(state.opt_state.count) == 3
    exported = read_flax_msgpack(port_trained["root"] / "weights" / "deepcalib_exp.msgpack")
    assert exported["conf"] == {"num_bins": 16, "block_config": {"0": 1, "1": 1}, "growth_rate": 8}
    tree = ttrain.export_tree(state, (1, 1), 16, 8)
    for coll in ("params", "batch_stats"):
        for a, b in zip(jax.tree.leaves(tree[coll]), jax.tree.leaves(exported[coll])):
            np.testing.assert_array_equal(a, b)
    conf = json.loads(json.dumps(port_trained["conf"]))
    conf["train"]["total_steps"] = 4
    scalars = ttrain.training(conf, exp, restore=True, device="cpu")
    assert np.isfinite(scalars["loss/total"])
    assert ExperimentManager(exp).latest_step() == 4
