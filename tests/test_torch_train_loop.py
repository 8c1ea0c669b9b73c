"""The port's training loop against the JAX package's, on the CPU.

Both loops run on the same generated dataset (tiny variant, 64×64, batch 4,
2 LM steps, float32 compute, drop path 0, the identity augmentation) from the
same weights: the JAX package's initialisation, written as a msgpack and read
by both through ``train.init_weights``. The JAX loop runs on a one-device mesh
(``make_mesh`` is patched on the test side); ``make_train_config`` is patched
in both packages to compute in float32. The host-loader loop takes 3 steps
(log every step, validation and a checkpoint at step 2, one val batch), the
port's with the gradient audit; the staged loop 2 steps.

Bounds:
- every metrics.jsonl record's loss terms, angle errors and gradient norm:
  1e-4 relative at step 0 (the same inputs and weights; float32 sums in
  another order), 1e-3 after it (Adam's first steps move each element by
  about ±lr, so a gradient element at float32 noise can flip its update;
  measured up to 2.0e-5 in the training records). The validation records
  are read after the first steps too and are held at 1e-3: their parameters
  already differ by that update noise, which moves their loss terms by up
  to 1.24e-4 and their angle errors by up to 2.44e-4 relative, so the 1e-4
  bound of the validation scalars is held on equal parameters instead (next
  item). Each recall within one pixel's share, 1/(B·H·W), at step 0 and
  four after it (measured: none at step 0, up to two after);
- the validation scalars on equal parameters (each package's eval step on
  the initial weights and the val batch): 1e-4 relative, and each recall
  within one pixel's share (a pixel whose angle error sits within float32
  noise of a threshold counts on one side in each package);
- the final parameters, by the per-leaf rule of tests/test_torch_train_step.py:
  the leaves whose first-batch gradient is over 1e-6 of the gradient's global
  norm (the biases of the convolutions in front of a BatchNorm have a true
  gradient of 0 and are not judged), each within 1e-3 relative L2, except
  the leaves initialised to zero: those hold only the steps' Adam updates,
  where float32 noise in the gradient elements near Adam's eps becomes update
  noise (up to 1.42e-3 relative L2 here), and each of their elements is held
  within 0.05·lr of JAX's value (measured within 2.6e-6, under 0.01·lr; a
  left-out or negated update of such a leaf is off by up to ~1.5·lr, which
  a planted-fault case checks is caught for every one of them);
- config.yaml, the checkpoint steps and the gradient audit: equal.

The field losses are L1, whose gradient flips sign where a prediction crosses
its target, so the comparison holds only where no residual element changes
sign between the packages; the first step's premise is checked first.
"""

import contextlib
import copy
import dataclasses
import importlib
import io
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from geocalib_tpu.data import generate_dataset
from geocalib_tpu.extractor import save_params as jax_save_params
from geocalib_tpu.models.fused_heads import fused_forward_train
from geocalib_tpu.parallel.mesh import DATA_AXIS
from geocalib_tpu.training.debug import audit_gradients
from geocalib_tpu.training.checkpoint import ExperimentManager as JManager
from geocalib_tpu.utils.config import load_yaml as jax_load_yaml
from geocalib_tpu_torch.data.dataset import DatasetConf, SimpleDataset, synthesize_gt_fields
from geocalib_tpu_torch.models.weights import params_from_jax, params_to_jax
from geocalib_tpu_torch.training.checkpoint import ExperimentManager as TManager
from geocalib_tpu_torch.utils.config import merge
from geocalib_tpu_torch.utils.threefry import fold_in, prng_key, split

J = importlib.import_module("geocalib_tpu.training.train")
JS = importlib.import_module("geocalib_tpu.training.train_step")
T = importlib.import_module("geocalib_tpu_torch.training.train")
TS = importlib.import_module("geocalib_tpu_torch.training.train_step")

SIZE, BATCH, SEED = 64, 4, 0
STEP0_TOL, LATER_TOL, VAL_TOL, LEAF_TOL, SHARE = 1e-4, 1e-3, 1e-4, 1e-3, 1e-6
ZERO_LEAF_LR = 0.05  # each element of a zero-initialised leaf, in units of lr
PIXEL = 1.0 / (BATCH * SIZE * SIZE)  # one pixel's share of a recall
LATER_PIXELS = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conf(ds, init, **train):
    return merge(T.default_conf, {
        "seed": SEED,
        "train": {"variant": "tiny", "lm_steps": 2, "input_size": SIZE, "total_steps": 3,
                  "log_every": 1, "eval_every": 2, "save_every": 2, "val_batches": 1,
                  "warmup_steps": 2, "decay_milestones": [6], "lr": 3e-4,
                  "drop_path_rate": 0.0, "figures_every": 0, "init_weights": str(init), **train},
        "data": {"dataset_dir": str(ds), "batch_size": BATCH, "augmentation": "identity"}})


@contextlib.contextmanager
def _patched():
    """JAX on a one-device mesh; both packages' step configs computing in float32."""
    f32 = lambda make: lambda conf: dataclasses.replace(make(conf), compute_dtype="float32")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J, "make_mesh", lambda: Mesh(np.asarray(jax.devices()[:1]), (DATA_AXIS,)))
        mp.setattr(J, "make_train_config", f32(J.make_train_config))
        mp.setattr(T, "make_train_config", f32(T.make_train_config))
        yield


def _run_both(tmp, conf, port_kw=(), **kw):
    """(JAX dir, port dir, JAX stdout, port stdout) of one run of each loop."""
    out = {}
    for name, mod, extra in (("jax", J, {}), ("torch", T, {"device": "cpu", **dict(port_kw)})):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.training(copy.deepcopy(conf), str(tmp / name), **kw, **extra)
        out[name] = buf.getvalue()
    return tmp / "jax", tmp / "torch", out["jax"], out["torch"]


def _records(path):
    return [json.loads(line) for line in (path / "logs" / "metrics.jsonl").read_text().splitlines()]


def _compare_record(j, t, after_steps):
    """One record of each package: the loss terms, the metrics and the gradient norm
    at the bounds above, the recalls within whole pixels' shares."""
    assert set(t) == set(j)
    tol, pixels = (LATER_TOL, LATER_PIXELS) if after_steps else (STEP0_TOL, 1)
    judged = [k for k in j if k.startswith(("loss/", "metric/", "val/loss/", "val/metric/"))
              or k == "grad_norm"]
    assert any(k.startswith(("metric/", "val/metric/")) for k in judged)
    for k in judged:
        if "recall" in k:
            assert abs(t[k] - j[k]) <= pixels * PIXEL * (1 + 1e-6), f"{j['step']} {k}"
        else:
            np.testing.assert_allclose(t[k], j[k], rtol=tol, atol=1e-7, err_msg=f"{j['step']} {k}")


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, path + (k,)) if isinstance(v, dict) else {path + (k,): np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    ds = generate_dataset(str(root / "ds"), n_panos=5, height=SIZE, width=SIZE, crops_per_pano=4)
    jcfg = JS.TrainConfig(variant="tiny", lm_steps=2, drop_path_rate=0.0,
                          compute_dtype="float32")
    net, state = JS.create_train_state(jax.random.PRNGKey(0), jcfg, (1, SIZE, SIZE, 3))
    init = root / "init.msgpack"
    jax_save_params({"params": state.params, "batch_stats": state.batch_stats}, init)
    return {"root": root, "ds": ds, "init": init, "jcfg": jcfg, "net": net, "state": state}


@pytest.fixture(scope="module")
def first_grads(env):
    """JAX's gradient of the first batch's loss as JAX's audit takes it (the loop's
    first key, unfolded), computed inside shard_map over a one-device mesh."""
    tds = SimpleDataset(DatasetConf(dataset_dir=str(env["ds"]), batch_size=BATCH, seed=SEED))
    batch = next(iter(tds.epoch(epoch=0)))
    net, state = env["net"], env["state"]

    def grads(params, b):
        return jax.grad(lambda p: JS.loss_and_updates(net, env["jcfg"], p, state.batch_stats, b,
                                                      jax.random.PRNGKey(SEED + 1))[0])(params)

    mesh = Mesh(np.asarray(jax.devices()[:1]), (DATA_AXIS,))
    return jax.jit(jax.shard_map(grads, mesh=mesh, in_specs=(P(), P(DATA_AXIS)), out_specs=P(),
                                 check_vma=False))(
        state.params, {k: v.numpy() for k, v in batch.items()})


@pytest.fixture(scope="module")
def loop(env):
    conf = _conf(env["ds"], env["init"])
    with _patched():
        jdir, tdir, jout, tout = _run_both(env["root"] / "loop", conf,
                                           port_kw={"audit_grads": True})
    return {"conf": conf, "jdir": jdir, "tdir": tdir, "jout": jout, "tout": tout}


def test_first_step_premise_no_residual_changes_sign(env):
    """The fields of the loop's first training forward, both packages, same weights,
    batch and key: no L1 residual may change sign between them."""
    tds = SimpleDataset(DatasetConf(dataset_dir=str(env["ds"]), batch_size=BATCH, seed=SEED))
    batch = next(iter(tds.epoch(epoch=0)))
    step_key = split(prng_key(SEED + 1))[1]
    d_key, n_key = split(fold_in(step_key, 0))

    def fwd(variables, image):
        return fused_forward_train(variables, image, variant="tiny",
                                   rngs={"dropout": np.asarray(d_key, np.uint32),
                                         "nmf": np.asarray(n_key, np.uint32)},
                                   bn_axis_name=DATA_AXIS)[0]

    mesh = Mesh(np.asarray(jax.devices()[:1]), (DATA_AXIS,))
    jfields = jax.jit(jax.shard_map(fwd, mesh=mesh, in_specs=(P(), P(DATA_AXIS)), out_specs=P(),
                                    check_vma=False))(
        {"params": env["state"].params, "batch_stats": env["state"].batch_stats},
        batch["image"].numpy())
    tree = jax.tree.map(np.asarray, {"params": env["state"].params,
                                     "batch_stats": env["state"].batch_stats})
    tcfg = TS.TrainConfig(variant="tiny", lm_steps=2, drop_path_rate=0.0, compute_dtype="float32")
    tnet, _ = TS.create_train_state(tcfg, params_from_jax(tree, "tiny"), device="cpu")
    with torch.no_grad():
        tfields, _ = tnet(batch["image"], n_key)
    gt = synthesize_gt_fields(batch)
    for k in ("up_field", "latitude_field"):
        target = gt[k].numpy()
        flips = np.sign(tfields[k].numpy() - target) != np.sign(np.asarray(jfields[k]) - target)
        assert not flips.any(), f"{k}: {int(flips.sum())} L1 residuals change sign"


def test_loop_records_match_jax(loop):
    jrec, trec = _records(loop["jdir"]), _records(loop["tdir"])
    train = lambda recs: [r for r in recs if "loss/total" in r]
    assert [r["step"] for r in train(trec)] == [r["step"] for r in train(jrec)] == [0, 1, 2]
    for j, t in zip(train(jrec), train(trec)):
        _compare_record(j, t, after_steps=j["step"] > 0)
        assert t["skipped_nonfinite"] == j["skipped_nonfinite"] == 0.0


def test_loop_validation_records_match_jax(loop):
    val = lambda recs: [r for r in recs if any(k.startswith("val/") for k in r)]
    jval, tval = val(_records(loop["jdir"])), val(_records(loop["tdir"]))
    assert [r["step"] for r in tval] == [r["step"] for r in jval] == [2]
    _compare_record(jval[0], tval[0], after_steps=True)


def test_validation_step_matches_jax_on_equal_params(env):
    """Each package's eval step (loss_and_updates(train=False): running statistics,
    the evaluation NMF) on the initial weights and the first val batch."""
    vds = SimpleDataset(DatasetConf(dataset_dir=str(env["ds"]), csv_name="val.csv",
                                    batch_size=BATCH, shuffle=False))
    batch = next(iter(vds.epoch(epoch=0)))
    key = prng_key(SEED + 1)
    jout = jax.jit(J.make_eval_step(env["net"], env["jcfg"]).__wrapped__)(
        env["state"], {k: v.numpy() for k, v in batch.items()}, jax.random.PRNGKey(SEED + 1))
    tree = jax.tree.map(np.asarray, {"params": env["state"].params,
                                     "batch_stats": env["state"].batch_stats})
    tcfg = TS.TrainConfig(variant="tiny", lm_steps=2, drop_path_rate=0.0, compute_dtype="float32")
    tnet, tstate = TS.create_train_state(tcfg, params_from_jax(tree, "tiny"), device="cpu")
    tout = TS.make_eval_step(tnet, tcfg)(tstate, batch, key)
    assert set(tout) == set(jout)
    for k, v in jout.items():
        if "recall" in k:
            assert abs(float(tout[k]) - float(v)) <= PIXEL * (1 + 1e-6), k
        else:
            np.testing.assert_allclose(float(tout[k]), float(v), rtol=VAL_TOL, atol=1e-7,
                                       err_msg=k)


def _final_params(env, jdir, tdir):
    template = JS.create_train_state(jax.random.PRNGKey(0), env["jcfg"], (1, SIZE, SIZE, 3))[1]
    jstate, jstep = JManager(jdir).restore(template)
    tcfg = TS.TrainConfig(variant="tiny", lm_steps=2, compute_dtype="float32")
    tstate, tstep = TManager(tdir).restore(TS.create_train_state(tcfg, device="cpu")[1])
    return (_flat(jax.tree.map(np.asarray, jstate.params)),
            _flat(params_to_jax(tstate.params, "tiny")["params"]), jstep, tstep)


def _leaf_faults(jp, tp, grads, init, lr):
    """The judged leaves (gradient over SHARE of the first batch's global gradient norm)
    that break the per-leaf rule, each with its reading: relative L2 over LEAF_TOL,
    or, for a leaf initialised to zero, an element further than ZERO_LEAF_LR·lr from
    JAX's. Also the judged zero-initialised leaves."""
    assert set(jp) == set(tp)
    g = _flat(jax.tree.map(np.asarray, grads))
    norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in g.values()))
    judged = [k for k in jp if np.linalg.norm(g[k]) > SHARE * norm]
    assert len(judged) > 0.8 * len(jp)
    zero = [k for k in judged if not init[k].any()]
    bad = {k: float(np.abs(tp[k] - jp[k]).max() / lr) for k in zero
           if np.abs(tp[k] - jp[k]).max() > ZERO_LEAF_LR * lr}
    for k in judged:
        rel = float(np.linalg.norm(tp[k].astype(np.float64) - jp[k]) / np.linalg.norm(jp[k]))
        if k not in zero and rel > LEAF_TOL:
            bad[k] = rel
    return bad, zero


def _check_params(jp, tp, grads, init, lr):
    bad, zero = _leaf_faults(jp, tp, grads, init, lr)
    assert zero, "no zero-initialised leaf is judged"
    assert not bad, f"parameter leaves beyond the per-leaf rule: {bad}"


def test_loop_final_params_match_jax(env, loop, first_grads):
    jp, tp, jstep, tstep = _final_params(env, loop["jdir"], loop["tdir"])
    assert jstep == tstep == 3
    init = _flat(jax.tree.map(np.asarray, env["state"].params))
    _check_params(jp, tp, first_grads, init, loop["conf"]["train"]["lr"])
    assert sum(not np.array_equal(tp[k], init[k]) for k in init) > 0.8 * len(init)


@pytest.mark.parametrize("fault", ["left_out", "negated"])
def test_param_rule_catches_planted_faults(env, loop, first_grads, fault):
    """The per-leaf rule must catch a broken update of a zero-initialised leaf: with
    the port's final value of one such leaf replaced by its initial zeros (its
    updates left out) or by its negation, that leaf, and no other, breaks the rule,
    for every judged zero-initialised leaf."""
    jp, tp, _, _ = _final_params(env, loop["jdir"], loop["tdir"])
    init = _flat(jax.tree.map(np.asarray, env["state"].params))
    lr = loop["conf"]["train"]["lr"]
    zero = _leaf_faults(jp, tp, first_grads, init, lr)[1]
    for k in zero:
        planted = {**tp, k: np.zeros_like(tp[k]) if fault == "left_out" else -tp[k]}
        assert list(_leaf_faults(jp, planted, first_grads, init, lr)[0]) == [k], k


def test_loop_checkpoints_and_config(loop):
    names = lambda d: sorted(p.name for p in d.glob("checkpoint_*"))
    assert names(loop["tdir"]) == names(loop["jdir"]) == [
        "checkpoint_2", "checkpoint_3", "checkpoint_best"]
    for d in ("checkpoint_2", "checkpoint_best"):
        tm = json.loads((loop["tdir"] / d / "meta.json").read_text())
        jm = json.loads((loop["jdir"] / d / "meta.json").read_text())
        assert tm["step"] == jm["step"] == 2 and set(tm["eval"]) == set(jm["eval"])
    assert jax_load_yaml(loop["tdir"] / "config.yaml") == loop["conf"]
    assert jax_load_yaml(loop["tdir"] / "checkpoint_3" / "config.yaml") == loop["conf"]


def test_loop_gradient_audit_matches_jax(loop, first_grads):
    """The port loop's audit (audit_grads=True) against JAX's audit_gradients on the
    gradients of JAX's audit, computed inside shard_map: the JAX loop's own
    ``_audit_first_batch`` differentiates outside it, where its BatchNorm's axis
    name is unbound, and raises."""
    dead = audit_gradients(first_grads)
    expected = ([f"WARNING: {len(dead)} parameters receive zero gradient:"]
                + [f"  {name}" for name in dead[:20]]) if dead else [
        "gradient audit: every parameter receives gradient"]
    printed = [line for line in loop["tout"].splitlines()
               if line.startswith(("WARNING:", "  [", "gradient audit"))]
    assert printed == expected


def test_staged_loop_matches_jax(env, first_grads):
    conf = _conf(env["ds"], env["init"], total_steps=2, eval_every=1, save_every=2)
    with _patched():
        jdir, tdir, _, _ = _run_both(env["root"] / "staged", conf, staged=True)
    jrec, trec = _records(jdir), _records(tdir)
    assert [r["step"] for r in trec] == [r["step"] for r in jrec]
    assert sum("loss/total" in r for r in jrec) == 2 and any("val/loss/total" in r for r in jrec)
    for j, t in zip(jrec, trec):
        _compare_record(j, t, after_steps=j["step"] > 0 or "val/loss/total" in j)
    jp, tp, jstep, tstep = _final_params(env, jdir, tdir)
    assert jstep == tstep == 2
    _check_params(jp, tp, first_grads, _flat(jax.tree.map(np.asarray, env["state"].params)),
                  conf["train"]["lr"])
