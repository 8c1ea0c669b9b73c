"""A rank of tests/test_torch_distributed.py: the port's data-parallel pieces over gloo.

    python -m torch.distributed.run --standalone --nproc-per-node=2 \\
        tests/_torch_dist_worker.py <workdir>
    python tests/_torch_dist_worker.py <workdir> one_rank

Under torchrun each rank joins the group through
``parallel.mesh.maybe_initialize_distributed`` (torchrun's environment, gloo
on the CPU) and runs every case of the test file on its own rows, read from
``<workdir>/inputs.pkl``: the mean over ranks and its gradient, one synced
BatchNorm, the shared-intrinsics LM, one sharded train step, the staged store
and step, the staged loop, and the host loop with a checkpoint, then restored
through the CLI's ``main``. With ``one_rank`` it runs the train step and the
shared LM without a group and with a one-rank gloo group (a FileStore). It
writes its results to ``<workdir>/out_<rank>.pkl`` (``out_one_rank.pkl``) and
imports neither JAX nor the JAX package.
"""

import contextlib
import copy
import datetime
import hashlib
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from geocalib_tpu_torch.models.modules import BatchNorm  # noqa: E402
from geocalib_tpu_torch.optim.lm import LMConfig, run_lm  # noqa: E402
from geocalib_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from geocalib_tpu_torch.training import device_store as tstore  # noqa: E402
from geocalib_tpu_torch.training import train as ttrain  # noqa: E402
from geocalib_tpu_torch.training import train_step as tstep  # noqa: E402
from geocalib_tpu_torch.data.dataset import DatasetConf, SimpleDataset  # noqa: E402
from geocalib_tpu_torch.utils.threefry import fold_in, split  # noqa: E402

TIMEOUT_S = 240.0  # a rank blocked in a collective its peer never reaches raises after this


def _np(t):
    return t.detach().cpu().numpy().copy()


def _tree(tree):
    return {k: _np(v) for k, v in tree.items()}


def state_arrays(state):
    """A TrainState as numpy: params, batch_stats, mu, nu and the Adam count."""
    opt = state.opt_state
    return {"params": _tree(state.params), "batch_stats": _tree(state.batch_stats),
            "mu": _tree(opt.mu), "nu": _tree(opt.nu), "count": _np(opt.count),
            "step": int(state.step)}


def digest(state) -> str:
    """sha256 over every tensor of a TrainState, in name order."""
    h = hashlib.sha256()
    arrays = state_arrays(state)
    for name in ("params", "batch_stats", "mu", "nu"):
        for k in sorted(arrays[name]):
            h.update(k.encode())
            h.update(arrays[name][k].tobytes())
    h.update(arrays["count"].tobytes())
    h.update(str(arrays["step"]).encode())
    return h.hexdigest()


def case_mean(inp, mesh):
    """(a) mean_over_ranks of this rank's x, and the gradient of the rank's loss
    (mean_over_ranks(mean(x)) · x).sum() with respect to its x."""
    x = torch.from_numpy(inp["mean_x"][mesh.rank]).requires_grad_()
    fwd = pmesh.mean_over_ranks(x, mesh)
    loss = (pmesh.mean_over_ranks(x.mean(), mesh) * x).sum()
    (grad,) = torch.autograd.grad(loss, x)
    return {"value": _np(fwd), "grad": _np(grad)}


def case_batchnorm(inp, mesh):
    """(b) one synced BatchNorm in training: output, running statistics and the input
    gradient of (y · w).sum() over this rank's rows."""
    b = inp["bn"]
    x = torch.from_numpy(b["x"][mesh.rank]).permute(0, 3, 1, 2).contiguous().requires_grad_()
    bn = BatchNorm(x.shape[1], mesh).train()
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, name).copy_(torch.from_numpy(b[name]))
    y = bn(x)
    w = torch.from_numpy(b["w"][mesh.rank]).permute(0, 3, 1, 2)
    (grad,) = torch.autograd.grad((y * w).sum(), x)
    return {"y": _np(y.permute(0, 2, 3, 1)), "grad": _np(grad.permute(0, 2, 3, 1)),
            "mean": _np(bn.running_mean), "var": _np(bn.running_var)}


def case_lm(inp, mesh):
    """(c) shared-intrinsics run_lm over the ranks, early stop off: each rank's lanes."""
    out = {}
    for model, data in inp["lm"].items():
        fields = {k: torch.from_numpy(v[mesh.rank]) for k, v in data.items()}
        cfg = LMConfig(camera_model=model, shared_intrinsics=True, early_stop=False, mesh=mesh)
        res = run_lm(fields, cfg)
        out[model] = {"roll": _np(res.gravity.roll), "pitch": _np(res.gravity.pitch),
                      "vfov": _np(res.camera.vfov), "k": _np(res.camera.k)}
    return out


def _step_setup(inp, mesh, mode="ift"):
    s = inp["step"]
    cfg = tstep.TrainConfig(**s["cfg"], lm_grad_mode=mode)
    weights = {k: torch.from_numpy(v) for k, v in s["weights"].items()}
    net, state = tstep.create_train_state(cfg, weights, device="cpu", mesh=mesh)
    rank = pmesh.axis_index(mesh)
    rows = slice(rank * s["local_b"], (rank + 1) * s["local_b"])
    batch = {"image": torch.from_numpy(s["image"][rows]),
             "gt_params": torch.from_numpy(s["gt"][rows])}
    return cfg, net, state, batch, tuple(s["key"])


def case_step(inp, mesh):
    """(d) one sharded train step: this rank's fields of the training forward (the
    premise), its loss terms and gradients, and the new state and scalars."""
    out = {}
    for mode in inp["step"]["modes"]:
        cfg, net, state, batch, key = _step_setup(inp, mesh, mode)
        with torch.no_grad():
            fields, _ = net(batch["image"], split(fold_in(key, mesh.rank))[1])
        loss, grads, _, losses, _ = tstep.compute_grads(net, cfg, state, batch, key)
        new, scalars = tstep.train_step(net, cfg, state, batch, key)
        out[mode] = {"fields": {k: _np(v) for k, v in fields.items()}, "loss": float(loss),
                     "losses": _tree(losses), "grads": _tree(grads), "new": state_arrays(new),
                     "digest": digest(new), "scalars": {k: float(v) for k, v in scalars.items()}}
    return out


def _dataset(inp, csv, batch_size):
    return SimpleDataset(DatasetConf(dataset_dir=inp["dataset"], csv_name=csv,
                                     batch_size=batch_size, augmentation="identity"))


def case_staged(inp, mesh):
    """(e) stage_sharded over the ranks, one staged train step and one staged eval
    window on this rank's slice."""
    s = inp["staged"]
    ds = _dataset(inp, "train.csv", s["batch"])
    store = tstore.DeviceStore.stage_sharded(ds, mesh, device="cpu", progress=None)
    cfg, net, state, _, _ = _step_setup(inp, mesh)
    step = tstore.make_staged_train_step(net, cfg, s["batch"], augment=False)
    new, scalars = step(state, store.images, store.gt_params, tuple(s["key"]))
    window = tstore.make_staged_eval_step(net, cfg, s["batch"])
    val = window(state, store.images, store.gt_params, 0, tuple(s["key"]))
    return {"images": _np(store.images), "gt_params": _np(store.gt_params),
            "scalars": {k: float(v) for k, v in scalars.items()},
            "val": {k: float(v) for k, v in val.items()}, "digest": digest(new)}


class Probe:
    """Records, around the loop, the states each step receives and returns, and who
    writes: checkpoints saved, metrics writers opened and configs written."""

    def __init__(self):
        self.inputs, self.outputs = [], []
        self.writes = {"save": 0, "writer": 0, "config": 0}

    @contextlib.contextmanager
    def installed(self):
        probe = self
        names = ("make_train_step", "ExperimentManager", "SummaryWriter", "save_yaml")
        saved = {n: getattr(ttrain, n) for n in names}
        staged = tstore.make_staged_train_step

        def wrap(make):
            def factory(*a, **kw):
                fn = make(*a, **kw)

                def step(state, *args):
                    probe.inputs.append(state)
                    new, scalars = fn(state, *args)
                    probe.outputs.append(new)
                    return new, scalars
                return step
            return factory

        class Manager(saved["ExperimentManager"]):
            def save(self, *a, **kw):
                probe.writes["save"] += 1
                return super().save(*a, **kw)

        class Writer(saved["SummaryWriter"]):
            def __init__(self, *a, **kw):
                probe.writes["writer"] += 1
                super().__init__(*a, **kw)

        def save_yaml(*a, **kw):
            probe.writes["config"] += 1
            return saved["save_yaml"](*a, **kw)

        ttrain.make_train_step = wrap(saved["make_train_step"])
        tstore.make_staged_train_step = wrap(staged)
        ttrain.ExperimentManager, ttrain.SummaryWriter = Manager, Writer
        ttrain.save_yaml = save_yaml
        try:
            yield self
        finally:
            for n, v in saved.items():
                setattr(ttrain, n, v)
            tstore.make_staged_train_step = staged


def _dotlist(tree, prefix=""):
    """A conf as the CLI's a.b=c overrides."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _dotlist(v, f"{prefix}{k}.")
        elif isinstance(v, (list, tuple)):
            out.append(f"{prefix}{k}=[{','.join(str(x) for x in v)}]")
        else:
            out.append(f"{prefix}{k}={v}")
    return out


def case_loops(inp, mesh):
    """The staged loop (2 steps, a validation), then (g): the host loop for 3 steps with
    a validation and checkpoints, and a restore through the CLI's main for one step
    more. main destroys the group at its end, so this case comes last."""
    root = Path(inp["workdir"])
    out = {}
    staged = Probe()
    with staged.installed():
        ttrain.training(copy.deepcopy(inp["staged_conf"]), str(root / "staged"), staged=True,
                        device="cpu")
    out["staged"] = {"digests": [digest(s) for s in staged.outputs], "writes": staged.writes}

    run = Probe()
    with run.installed():
        scalars = ttrain.training(copy.deepcopy(inp["loop_conf"]), str(root / "loop"),
                                  device="cpu")
    restored = Probe()
    conf = dict(inp["loop_conf"], train=dict(inp["loop_conf"]["train"], total_steps=4))
    with restored.installed():
        ttrain.main(["loop", "--restore", "--device", "cpu", "--output_root", str(root)]
                    + _dotlist(conf))
    out["loop"] = {"scalars": scalars, "digests": [digest(s) for s in run.outputs],
                   "writes": run.writes, "final": state_arrays(run.outputs[-1]),
                   "restored_input": state_arrays(restored.inputs[0]),
                   "restored_input_digest": digest(restored.inputs[0]),
                   "restored_digests": [digest(s) for s in restored.outputs],
                   "restored_writes": restored.writes,
                   "group_destroyed": not dist.is_initialized()}
    return out


def one_rank(inp, workdir: Path):
    """(f) the train step and the shared LM with no group, then with a one-rank gloo
    group: the results of both, to be held equal bit for bit."""
    def run(mesh):
        cfg, net, state, batch, key = _step_setup(inp, mesh)
        new, scalars = tstep.train_step(net, cfg, state, batch, key)
        data = inp["lm"]["pinhole"]
        fields = {k: torch.from_numpy(v[0]) for k, v in data.items()}
        res = run_lm(fields, LMConfig(shared_intrinsics=True, early_stop=False, mesh=mesh))
        return {"new": state_arrays(new), "scalars": {k: _np(v) for k, v in scalars.items()},
                "lm": _np(res.camera.data), "lm_gravity": _np(res.gravity.vec3d)}

    out = {"none": run(None)}
    store = dist.FileStore(str(workdir / "one_rank_store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    mesh = pmesh.make_mesh("cpu")
    out["group"] = run(mesh)
    out["mesh"] = (mesh.rank, mesh.size)
    dist.destroy_process_group()
    return out


def main():
    workdir = Path(sys.argv[1])
    torch.set_num_threads(1)
    with open(workdir / "inputs.pkl", "rb") as fh:
        inp = pickle.load(fh)
    if sys.argv[2:] == ["one_rank"]:
        out, name = one_rank(inp, workdir), "one_rank"
    else:
        assert pmesh.maybe_initialize_distributed("cpu", timeout_s=TIMEOUT_S)
        mesh = pmesh.make_mesh("cpu")
        out = {"rank": mesh.rank, "size": mesh.size, "env_rank": int(os.environ["RANK"]),
               "process": (pmesh.process_index(), pmesh.process_count())}
        for name, case in (("mean", case_mean), ("batchnorm", case_batchnorm), ("lm", case_lm),
                           ("step", case_step), ("staged", case_staged),
                           ("loops", case_loops)):
            out[name] = case(inp, mesh)
        name = str(mesh.rank)
    with open(workdir / f"out_{name}.pkl", "wb") as fh:
        pickle.dump(out, fh)


if __name__ == "__main__":
    main()
