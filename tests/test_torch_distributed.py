"""The port's data parallelism (parallel/mesh.py) over 2 gloo ranks against the JAX
package on a 2-device mesh, on the CPU.

torchrun (``python -m torch.distributed.run --standalone``) starts the two ranks
of tests/_torch_dist_worker.py, one torch thread each, which join the group from
torchrun's environment through ``maybe_initialize_distributed``; a third process
runs the one-rank cases. Every spawn and the group carry a timeout, so a hung
rank fails the test. The ranks read their inputs from a file and write numpy
results back; the JAX side runs here, in shard_map over
``Mesh(jax.devices()[:2], ("data",))`` (the conftest's virtual devices), while
the ranks run. Rank r is fed the rows of JAX device r (the d-th contiguous
slice of the global batch), never the loader. Parameters cross by
params_from_jax.

Tolerances:
- (a) ``mean_over_ranks`` and its gradient against ``pmean`` and its gradient
  inside shard_map: equal. The inputs are multiples of 1/8 below 4 in
  magnitude, so every sum is exact in float32 in any order;
- (b) one synced BatchNorm in training against the JAX package's
  ``BatchNorm(axis_name)`` (Flax's): output, running statistics and input
  gradient within 1e-5 relative, with an absolute floor of 1e-5 of the array's
  largest magnitude (gradient elements near 0);
- (c) shared-intrinsics ``run_lm`` over the ranks against JAX's with
  ``axis_name``, pinhole and simple_divisional, early stop off (Queue 3 item 5
  of ROADMAP.md: the stop test sits at the float32 ulp): vFoV within 1e-5 rad,
  as tests/test_multiprocess.py holds JAX against itself, roll and pitch within
  2e-4 rad;
- (d) one sharded train step (the tiny variant, 64×64, float32 compute, drop
  path 0, global batch 4, 3 LM steps), with IFT and with unrolled LM
  gradients, against ``make_sharded_train_step``'s step, at
  tests/test_torch_train_step.py's tolerances and with its premise that no L1
  residual changes sign between the packages: the loss terms, the mean of the
  ranks' gradients and its norm in both modes, and the scalars, new
  parameters and running statistics with IFT (the update after the gradient
  is the same code in both modes, so the unrolled case compiles JAX's
  gradient alone); the two ranks' new parameters, Adam state and running
  statistics equal bit for bit;
- (e) ``stage_sharded``: each rank's rows equal to the JAX device's bit for
  bit; one staged train step (augmentation off: the device augmentation's own
  comparison is tests/test_torch_augment.py's) and one staged eval window,
  the loss terms and angle errors within 1e-4 relative, each recall within
  one pixel's share, 1/(B·H·W), as tests/test_torch_train_loop.py holds them
  (a pixel whose angle error sits within float32 noise of a threshold counts
  on one side in each package); the ranks' new states equal;
- (f) a one-rank gloo group: the train step and the shared LM bit for bit as
  without a group;
- (g) the training loop on the 2 ranks (host loader 3 steps with a validation
  and checkpoints, then a restore through the CLI's ``main`` for one step more;
  the staged loop 2 steps): only rank 0 writes, both ranks hold the same state
  after every step, and the restored state equals the saved one bit for bit.
"""

import functools
import importlib
import os
import pickle
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from geocalib_tpu.data import generate_dataset
from geocalib_tpu.data.dataset import DatasetConf as JConf, SimpleDataset as JDataset
from geocalib_tpu.extractor import save_params as jax_save_params
from geocalib_tpu.geometry.camera import Camera as JCamera
from geocalib_tpu.geometry.gravity import Gravity as JGravity
from geocalib_tpu.geometry.perspective_fields import get_perspective_field
from geocalib_tpu.models.fused_heads import fused_forward_train
from geocalib_tpu.models.modules import BatchNorm as JBatchNorm
from geocalib_tpu.optim.lm import LMConfig as JLMConfig, run_lm as jrun_lm
from geocalib_tpu.parallel.mesh import DATA_AXIS
from geocalib_tpu.training import device_store as jstore
from geocalib_tpu_torch.data.dataset import synthesize_gt_fields
from geocalib_tpu_torch.models.weights import params_from_jax, params_to_jax
from geocalib_tpu_torch.training import train as ttrain
from geocalib_tpu_torch.utils.config import merge

J = importlib.import_module("geocalib_tpu.training.train_step")

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "_torch_dist_worker.py"
SPAWN_TIMEOUT_S = 600
SIZE, B, LOCAL_B, LM_STEPS = 64, 4, 2, 3
SHARE = 1e-6
PIXEL = 1.0 / (B * SIZE * SIZE)  # one pixel's share of a recall
LM_MODELS = ("pinhole", "simple_divisional")
MODES = ("ift", "unroll")  # the LM's gradients in the train step
STEP_CFG = dict(variant="tiny", lm_steps=LM_STEPS, drop_path_rate=0.0, compute_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh():
    return Mesh(np.asarray(jax.devices()[:2]), (DATA_AXIS,))


def _smap(fn, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=_mesh(), in_specs=in_specs, out_specs=out_specs,
                                 check_vma=False))


def _ranks(x):
    """A global (2·n, ...) array as the two ranks' (n, ...) slices."""
    x = np.asarray(x)
    return np.stack([x[: len(x) // 2], x[len(x) // 2:]])


def _lm_fields(model, rng):
    """4 noisy views of one camera (shared intrinsics), 16×16, with confidences."""
    h = w = 16
    k1 = {"pinhole": 0.0, "simple_divisional": -0.2}[model]
    cam = JCamera.from_dict({"height": jnp.full((B,), float(h)), "width": jnp.full((B,), float(w)),
                             "vfov": jnp.full((B,), 0.9, jnp.float32),
                             "k1": jnp.full((B,), k1, jnp.float32)}, model=model)
    grav = JGravity.from_rp(jnp.asarray(rng.uniform(-0.4, 0.4, B), jnp.float32),
                            jnp.asarray(rng.uniform(-0.4, 0.4, B), jnp.float32))
    up, lat = get_perspective_field(cam, grav, h, w)
    return {"up_field": np.asarray(up + 0.05 * rng.normal(size=up.shape).astype(np.float32)),
            "latitude_field": np.asarray(
                lat + 0.05 * rng.normal(size=lat.shape).astype(np.float32)),
            "up_confidence": rng.uniform(0.2, 1.0, (B, h, w)).astype(np.float32),
            "latitude_confidence": rng.uniform(0.2, 1.0, (B, h, w)).astype(np.float32)}


def _step_case(net, jcfg, full, st, b, k):
    """JAX on one device of the mesh: its rows' loss terms and the mean gradient; when
    full, also its rows' fields of the training forward (the premise) and train_step's
    new state and scalars."""
    kk = jax.random.fold_in(k, jax.lax.axis_index(DATA_AXIS))
    (_, (_, losses, _)), grads = jax.value_and_grad(
        lambda p: J.loss_and_updates(net, jcfg, p, st.batch_stats, b, kk), has_aux=True)(
            st.params)
    if not full:
        return losses, jax.lax.pmean(grads, DATA_AXIS)
    d_rng, n_rng = jax.random.split(kk)
    fields, _ = fused_forward_train({"params": st.params, "batch_stats": st.batch_stats},
                                    b["image"], variant=jcfg.variant,
                                    rngs={"dropout": d_rng, "nmf": n_rng}, bn_axis_name=DATA_AXIS)
    new_state, scalars = J.train_step(net, jcfg, st, b, k)
    return losses, jax.lax.pmean(grads, DATA_AXIS), fields, new_state, scalars


def _loop_conf(ds, init, **train):
    return merge(ttrain.default_conf, {
        "seed": 0,
        "train": {"variant": "tiny", "lm_steps": 2, "input_size": SIZE, "total_steps": 3,
                  "log_every": 1, "eval_every": 2, "save_every": 2, "val_batches": 1,
                  "warmup_steps": 2, "decay_milestones": [6], "lr": 3e-4, "drop_path_rate": 0.0,
                  "figures_every": 0, "init_weights": str(init), **train},
        "data": {"dataset_dir": str(ds), "batch_size": B, "augmentation": "identity"}})


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The inputs, written for the ranks, and the ranks started."""
    root = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    ds = generate_dataset(str(root / "ds"), n_panos=5, height=SIZE, width=SIZE, crops_per_pano=4)
    jcfg = J.TrainConfig(**STEP_CFG)
    net, state = J.create_train_state(jax.random.PRNGKey(0), jcfg, (1, SIZE, SIZE, 3))
    tree = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    init = root / "init.msgpack"
    jax_save_params(tree, init)
    image = rng.uniform(size=(B, SIZE, SIZE, 3)).astype(np.float32)
    gt = np.stack([np.full(B, SIZE), np.full(B, SIZE), rng.uniform(0.7, 1.2, B),
                   rng.uniform(-0.3, 0.3, B), rng.uniform(-0.3, 0.3, B), np.zeros(B),
                   np.zeros(B)], -1).astype(np.float32)
    bn = {"x": (rng.normal(size=(B, 3, 3, 5)) * 2 + 1).astype(np.float32),
          "w": rng.normal(size=(B, 3, 3, 5)).astype(np.float32),
          "weight": rng.uniform(0.5, 1.5, 5).astype(np.float32),
          "bias": rng.normal(size=5).astype(np.float32),
          "running_mean": rng.normal(size=5).astype(np.float32),
          "running_var": rng.uniform(0.5, 2.0, 5).astype(np.float32)}
    lm = {m: _lm_fields(m, rng) for m in LM_MODELS}
    inputs = {
        "workdir": str(root), "dataset": str(ds),
        "mean_x": (rng.integers(-32, 32, size=(2, 4)) / 8).astype(np.float32),
        "bn": dict(bn, x=_ranks(bn["x"]), w=_ranks(bn["w"])),
        "lm": {m: {k: _ranks(v) for k, v in f.items()} for m, f in lm.items()},
        "step": {"cfg": STEP_CFG, "modes": list(MODES), "local_b": LOCAL_B, "image": image,
                 "gt": gt,
                 "key": [int(x) for x in np.asarray(jax.random.PRNGKey(3))],
                 "weights": {k: v.numpy() for k, v in params_from_jax(tree, "tiny").items()}},
        "staged": {"batch": B, "key": [int(x) for x in np.asarray(jax.random.PRNGKey(5))]},
        "loop_conf": _loop_conf(ds, init),
        "staged_conf": _loop_conf(ds, init, total_steps=2, eval_every=1, save_every=2),
    }
    with open(root / "inputs.pkl", "wb") as fh:
        pickle.dump(inputs, fh)
    envs = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    run = lambda *args, log: subprocess.Popen(  # noqa: E731
        [sys.executable, *args], cwd=REPO, env=envs, stdout=open(root / log, "w"),
        stderr=subprocess.STDOUT)
    procs = [run("-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2",
                 str(WORKER), str(root), log="ranks.log"),
             run(str(WORKER), str(root), "one_rank", log="one_rank.log")]
    yield {"root": root, "procs": procs, "net": net, "state": state, "jcfg": jcfg,
           "image": image, "gt": gt, "bn": bn, "lm": lm, "ds": ds, "inputs": inputs}
    for p in procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def jax_refs(env):
    """The JAX package's results on the 2-device mesh, computed while the ranks run."""
    out = {}
    x = np.concatenate(env["inputs"]["mean_x"])

    def mean_case(x):
        loss = lambda x: (jax.lax.pmean(x.mean(), DATA_AXIS) * x).sum()  # noqa: E731
        return jax.lax.pmean(x, DATA_AXIS), jax.grad(loss)(x)

    out["mean"] = jax.tree.map(np.asarray, _smap(mean_case, P(DATA_AXIS), P(DATA_AXIS))(x))

    bn = env["bn"]
    jbn = JBatchNorm(axis_name=DATA_AXIS)
    (name,) = jbn.init(jax.random.PRNGKey(0), bn["x"][:1])["params"]
    variables = {"params": {name: {"scale": bn["weight"], "bias": bn["bias"]}},
                 "batch_stats": {name: {"mean": bn["running_mean"], "var": bn["running_var"]}}}

    def bn_case(x, w):
        def loss(x):
            y, mut = jbn.apply(variables, x, train=True, mutable=["batch_stats"])
            return (y * w).sum(), (y, mut["batch_stats"])
        (_, (y, st)), g = jax.value_and_grad(loss, has_aux=True)(x)
        return y, g, st[name]["mean"], st[name]["var"]

    out["bn"] = jax.tree.map(np.asarray, _smap(bn_case, (P(DATA_AXIS), P(DATA_AXIS)),
                                               (P(DATA_AXIS), P(DATA_AXIS), P(), P()))(
        bn["x"], bn["w"]))

    out["lm"] = {}
    for model in LM_MODELS:
        cfg = JLMConfig(camera_model=model, shared_intrinsics=True, early_stop=False,
                        axis_name=DATA_AXIS)

        def lm_case(d, cfg=cfg):
            res = jrun_lm(d, cfg)
            return res.gravity.roll, res.gravity.pitch, res.camera.vfov

        out["lm"][model] = jax.tree.map(np.asarray, _smap(lm_case, P(DATA_AXIS), P(DATA_AXIS))(
            {k: jnp.asarray(v) for k, v in env["lm"][model].items()}))

    net, state, jcfg = env["net"], env["state"], env["jcfg"]
    out["step"] = {}
    for mode in MODES:
        full = mode == "ift"
        fn = _smap(functools.partial(_step_case, net, replace(jcfg, lm_grad_mode=mode), full),
                   (P(), P(DATA_AXIS), P()),
                   (P(DATA_AXIS), P(), P(DATA_AXIS), P(), P()) if full else (P(DATA_AXIS), P()))
        out["step"][mode] = jax.tree.map(np.asarray, fn(
            state, {"image": jnp.asarray(env["image"]), "gt_params": jnp.asarray(env["gt"])},
            jax.random.PRNGKey(3)))

    jds = JDataset(JConf(dataset_dir=str(env["ds"]), csv_name="train.csv", batch_size=B,
                         augmentation="identity"))
    store = jstore.DeviceStore.stage_sharded(jds, _mesh(), progress=None)
    copy_state = lambda: jax.tree.map(jnp.copy, state)  # noqa: E731 (the step donates it)
    step = jstore.make_staged_train_step(net, jcfg, _mesh(), B, augment=False)
    _, scalars = step(copy_state(), store.images, store.gt_params, jax.random.PRNGKey(5))
    window = jstore.make_staged_eval_step(net, jcfg, B, mesh=_mesh())
    val = window(state, store.images, store.gt_params, jnp.asarray(0, jnp.int32),
                 jax.random.PRNGKey(5))
    out["staged"] = {"images": np.asarray(store.images), "gt_params": np.asarray(store.gt_params),
                     "scalars": {k: float(v) for k, v in scalars.items()},
                     "val": {k: float(v) for k, v in val.items()}}
    return out


@pytest.fixture(scope="module")
def ranks(env, jax_refs):
    """The ranks' results, once both launches have exited 0 within the timeout."""
    root = env["root"]
    for p, log in zip(env["procs"], ("ranks.log", "one_rank.log")):
        try:
            code = p.wait(timeout=SPAWN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            code = f"killed after {SPAWN_TIMEOUT_S} s"
        assert code == 0, f"{log}: exit {code}\n{(root / log).read_text()[-6000:]}"
    load = lambda name: pickle.loads((root / f"out_{name}.pkl").read_bytes())  # noqa: E731
    return {0: load(0), 1: load(1), "one_rank": load("one_rank")}


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, path + (k,)) if isinstance(v, dict) else {path + (k,): np.asarray(v)})
    return out


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / max(np.linalg.norm(b), 1e-30))


def _equal_states(a, b):
    for name in ("params", "batch_stats", "mu", "nu"):
        assert set(a[name]) == set(b[name])
        for k in a[name]:
            assert np.array_equal(a[name][k], b[name][k]), f"{name} {k}"
    assert np.array_equal(a["count"], b["count"]) and a["step"] == b["step"]


def test_ranks_join_from_torchruns_environment(ranks):
    for r in (0, 1):
        assert ranks[r]["rank"] == ranks[r]["env_rank"] == r
        assert ranks[r]["size"] == 2 and ranks[r]["process"] == (r, 2)
    assert ranks["one_rank"]["mesh"] == (0, 1)


def test_mean_over_ranks_and_its_gradient_match_pmean(ranks, jax_refs):
    value, grad = jax_refs["mean"]
    for r in (0, 1):
        np.testing.assert_array_equal(ranks[r]["mean"]["value"], value[4 * r: 4 * r + 4])
        np.testing.assert_array_equal(ranks[r]["mean"]["grad"], grad[4 * r: 4 * r + 4])


def test_synced_batchnorm_matches_flax(ranks, jax_refs):
    y, grad, mean, var = jax_refs["bn"]
    close = lambda t, j: np.testing.assert_allclose(  # noqa: E731
        t, j, rtol=1e-5, atol=1e-5 * np.abs(j).max())
    for r in (0, 1):
        out = ranks[r]["batchnorm"]
        close(out["y"], y[LOCAL_B * r: LOCAL_B * (r + 1)])
        close(out["grad"], grad[LOCAL_B * r: LOCAL_B * (r + 1)])
        close(out["mean"], mean)
        close(out["var"], var)
    # the running update is the whole batch's, the same on both ranks
    assert np.array_equal(ranks[0]["batchnorm"]["mean"], ranks[1]["batchnorm"]["mean"])


@pytest.mark.parametrize("model", LM_MODELS)
def test_shared_intrinsics_lm_across_ranks_matches_jax(ranks, jax_refs, model):
    roll, pitch, vfov = jax_refs["lm"][model]
    for r in (0, 1):
        out, lanes = ranks[r]["lm"][model], slice(LOCAL_B * r, LOCAL_B * (r + 1))
        np.testing.assert_allclose(out["vfov"], vfov[lanes], rtol=0, atol=1e-5)
        np.testing.assert_allclose(out["roll"], roll[lanes], rtol=0, atol=2e-4)
        np.testing.assert_allclose(out["pitch"], pitch[lanes], rtol=0, atol=2e-4)
    # one camera over both ranks' lanes
    assert np.all(ranks[0]["lm"][model]["vfov"] == ranks[1]["lm"][model]["vfov"][0])


@pytest.mark.parametrize("mode", MODES)
def test_sharded_train_step_matches_jax(env, ranks, jax_refs, mode):
    losses, grads = jax_refs["step"][mode][:2]
    fields = jax_refs["step"]["ift"][2]  # the forward does not depend on the LM's gradients
    outs = [ranks[r]["step"][mode] for r in (0, 1)]

    # the premise: no L1 residual element changes sign between the packages
    for r, out in enumerate(outs):
        rows = slice(LOCAL_B * r, LOCAL_B * (r + 1))
        gt_fields = synthesize_gt_fields({"image": torch.from_numpy(env["image"][rows]),
                                          "gt_params": torch.from_numpy(env["gt"][rows])})
        for k in ("up_field", "latitude_field"):
            target = gt_fields[k].numpy()
            flips = np.sign(out["fields"][k] - target) != np.sign(fields[k][rows] - target)
            assert not flips.any(), (f"rank {r} {k}: {int(flips.sum())} L1 residuals change "
                                     f"sign between the packages: the fixture sits at the kink")

    for r, out in enumerate(outs):
        for k, v in losses.items():
            np.testing.assert_allclose(out["losses"][k], v[LOCAL_B * r: LOCAL_B * (r + 1)],
                                       rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(np.float32(outs[0]["loss"] + outs[1]["loss"]) / 2,
                               float(losses["total"].mean()), rtol=1e-4)

    # the mean of the ranks' gradients, as the all-reduce forms it, against JAX's pmean
    mean = {k: (outs[0]["grads"][k] + outs[1]["grads"][k]) / np.float32(2)
            for k in outs[0]["grads"]}
    jg = _flat(grads)
    tg = _flat(params_to_jax({k: torch.from_numpy(v) for k, v in mean.items()}, "tiny")["params"])
    assert set(jg) == set(tg)
    norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in jg.values()))
    judged = [k for k in jg if np.linalg.norm(jg[k]) > SHARE * norm]
    assert len(judged) > 0.8 * len(jg)
    bad = {k: _rel(tg[k], jg[k]) for k in judged if _rel(tg[k], jg[k]) > 1e-3}
    assert not bad, f"gradient leaves beyond 1e-3 relative L2: {bad}"

    # the two ranks hold the same state, bit for bit
    assert outs[0]["digest"] == outs[1]["digest"]
    _equal_states(outs[0]["new"], outs[1]["new"])
    for out in outs:
        np.testing.assert_allclose(out["scalars"]["grad_norm"], norm, rtol=1e-3)
        assert out["scalars"]["skipped_nonfinite"] == 0.0
        assert out["new"]["step"] == 1 and int(out["new"]["count"]) == 1
    if mode != "ift":
        return  # the update after the gradient is the same code in both modes

    new_state, scalars = jax_refs["step"][mode][3:]
    for out in outs:
        s = out["scalars"]
        np.testing.assert_allclose(s["grad_norm"], float(scalars["grad_norm"]), rtol=1e-3)
        for k in ("loss/total", "loss/param_total", "metric/roll_error", "metric/vfov_error"):
            np.testing.assert_allclose(s[k], float(scalars[k]), rtol=1e-4, err_msg=k)
        assert float(scalars["skipped_nonfinite"]) == 0.0 and int(new_state.step) == 1

    tnew = outs[0]["new"]
    old, jnew = _flat(jax.tree.map(np.asarray, env["state"].params)), _flat(new_state.params)
    tparams = _flat(params_to_jax({k: torch.from_numpy(v) for k, v in tnew["params"].items()},
                                  "tiny")["params"])
    lr = float(J.make_schedule(env["jcfg"])(0))
    for k in jnew:
        assert np.abs(tparams[k] - jnew[k]).max() <= 2 * lr * (1 + 1e-3), k
    same = np.concatenate([np.isclose(tparams[k], jnew[k], rtol=2.4e-7, atol=0).ravel()
                           for k in judged])
    assert same.mean() >= 0.99, same.mean()
    assert not any(np.array_equal(jnew[k], old[k]) for k in judged)

    jstats = _flat(new_state.batch_stats)
    tstats = _flat(params_to_jax({k: torch.from_numpy(v) for k, v in tnew["batch_stats"].items()},
                                 "tiny")["batch_stats"])
    assert set(jstats) == set(tstats)
    for k in jstats:
        np.testing.assert_allclose(tstats[k], jstats[k], rtol=1e-4, atol=1e-6, err_msg=str(k))


def test_staged_store_and_steps_match_jax(ranks, jax_refs):
    ref = jax_refs["staged"]
    per = len(ref["images"]) // 2
    for r in (0, 1):
        out = ranks[r]["staged"]
        assert np.array_equal(out["images"], ref["images"][per * r: per * (r + 1)])
        assert np.array_equal(out["gt_params"], ref["gt_params"][per * r: per * (r + 1)])
        for name in ("scalars", "val"):
            judged = [k for k in ref[name] if k.startswith(("loss/", "metric/"))]
            assert "loss/total" in judged
            for k in judged:
                if "recall" in k:
                    assert abs(out[name][k] - ref[name][k]) <= PIXEL * (1 + 1e-6), f"{name} {k}"
                else:
                    np.testing.assert_allclose(out[name][k], ref[name][k], rtol=1e-4, atol=1e-7,
                                               err_msg=f"{name} {k}")
    assert ranks[0]["staged"]["digest"] == ranks[1]["staged"]["digest"]


def test_one_rank_group_is_bitwise_no_group(ranks):
    out = ranks["one_rank"]
    _equal_states(out["none"]["new"], out["group"]["new"])
    assert set(out["none"]["scalars"]) == set(out["group"]["scalars"])
    for k, v in out["none"]["scalars"].items():
        assert np.array_equal(v, out["group"]["scalars"][k]), k
    for k in ("lm", "lm_gravity"):
        assert np.array_equal(out["none"][k], out["group"][k]), k


def test_two_rank_loops_write_once_and_stay_equal(env, ranks):
    loops = [ranks[r]["loops"] for r in (0, 1)]
    for name, steps in (("staged", 2), ("loop", 3)):
        a, b = loops[0][name], loops[1][name]
        assert len(a["digests"]) == steps and a["digests"] == b["digests"], name
        assert len(set(a["digests"])) == steps, f"{name}: the state did not move"
        assert b["writes"] == {"save": 0, "writer": 0, "config": 0}, name
        assert all(a["writes"][k] > 0 for k in ("save", "writer", "config")), a["writes"]
    a, b = loops[0]["loop"], loops[1]["loop"]
    assert b["restored_writes"] == {"save": 0, "writer": 0, "config": 0}
    assert a["restored_digests"] == b["restored_digests"] and len(a["restored_digests"]) == 1

    # the restored state is the saved one, on both ranks
    saved = torch.load(env["root"] / "loop" / "checkpoint_3" / "state.pt", weights_only=True)
    for r in (0, 1):
        got = loops[r]["loop"]["restored_input"]
        _equal_states(got, loops[r]["loop"]["final"])
        for k, v in saved["params"].items():
            assert np.array_equal(got["params"][k], v.numpy()), k
        assert loops[r]["loop"]["restored_input_digest"] == a["digests"][-1]
        assert loops[r]["loop"]["group_destroyed"]
    assert np.isfinite(a["scalars"]["loss/total"])


def test_stdout_capturing_tees_as_jax(tmp_path, capsys):
    """(h) The port's capture_outputs writes the same file as the JAX package's and
    still prints."""
    from geocalib_tpu.utils.stdout_capturing import capture_outputs as jcapture
    from geocalib_tpu_torch.utils.stdout_capturing import capture_outputs

    for name, fn in (("jax", jcapture), ("torch", capture_outputs)):
        with fn(tmp_path / name / "log.txt"):
            print("line one")
            print("to stderr", file=sys.stderr)
            sys.stdout.flush()
        print("after")
    out = capsys.readouterr()
    assert out.out.count("line one") == 2 and out.err.count("to stderr") == 2
    text = (tmp_path / "torch" / "log.txt").read_text()
    assert text == (tmp_path / "jax" / "log.txt").read_text() == "line one\nto stderr\n"


def test_profiling_times_and_traces(tmp_path):
    """(h) benchmark_fn and Timer return the JAX package's keys and plausible times, and
    trace writes a Chrome trace holding the enclosed ops."""
    import json
    import time

    from geocalib_tpu.utils.profiling import benchmark_fn as jbench
    from geocalib_tpu_torch.utils import profiling

    x = torch.ones(64, 64)
    out = profiling.benchmark_fn(lambda a: time.sleep(0.002) or a @ a, x, iters=3, label="mm")
    assert set(out) == set(jbench(lambda: None, iters=1))
    assert out["label"] == "mm" and out["iters"] == 3
    assert 2.0 <= out["min_ms"] <= out["p50_ms"] and out["min_ms"] <= out["mean_ms"]
    with profiling.Timer() as t:
        time.sleep(0.01)
    assert t.duration >= 0.01
    with profiling.trace(str(tmp_path / "trace")) as path:
        torch.matmul(x, x)
    events = json.loads(path.read_text())["traceEvents"]
    assert any("matmul" in str(e.get("name", "")) for e in events)
