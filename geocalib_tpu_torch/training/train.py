"""Training CLI: the training loop, data-parallel over the cards of a process group.

Port of geocalib_tpu/training/train.py: the host loop feeds batches from the
threaded PrefetchLoader (or the staged device store), runs the training step,
logs, validates over a rotating window of the val split, saves and restores
checkpoints, and runs benchmark evaluations. The keys follow the JAX loop:
``PRNGKey(seed + 1)``, split once per step. Everything runs on ``cuda``
unless the caller asks for the CPU (``device="cpu"``, ``--device cpu``).

Launched by torchrun, one process per card, the loop trains data-parallel as
the JAX loop does over a mesh (parallel/mesh.py): the conf's ``batch_size`` is
the global batch, which must divide by the number of ranks W, and rank r loads
the rows ``epoch(shard=r, num_shards=W)`` (the staged mode stages the r-th
1/W of the rows); the step means the gradients over the ranks and syncs the
BatchNorm statistics. The state is broadcast from rank 0 at the start (after a
restore, which every rank reads); only rank 0 writes the config, the logs, the
figures, the checkpoints and the benchmark results, and every rank evaluates
the validation windows as JAX's processes do. Without a process group the
loop runs on one device as before.

Without ``train.init_weights`` the network starts from torch's own
initialisation seeded with ``seed``, not from the JAX package's Flax
initialisation; with it (a Flax msgpack, as training/export.py writes) both
packages start from the same weights. Every ``train.figures_every`` steps,
at a validation, the loop writes the up and latitude field figures of the
first validation batch (``visualization/``), as the JAX loop does; they need
matplotlib, and a conf that asks for them where it is absent raises at the
start (set ``train.figures_every=0``).

Usage (the conf's YAML needs PyYAML; dotlist overrides do not):
    python -m geocalib_tpu_torch.training.train my_exp data.dataset_dir=data/openpano
    torchrun --nproc_per_node=N -m geocalib_tpu_torch.training.train my_exp \
        data.dataset_dir=data/openpano data.batch_size=24
"""

import argparse
import contextlib
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from geocalib_tpu_torch.data.dataset import (DatasetConf, PrefetchLoader, SimpleDataset,
                                             synthesize_gt_fields)
from geocalib_tpu_torch.extractor import DTYPES, resolve_device
from geocalib_tpu_torch.models.weights import params_from_jax, read_flax_msgpack
from geocalib_tpu_torch.parallel.mesh import (Mesh, axis_index, axis_size, barrier, make_mesh,
                                              maybe_initialize_distributed, replicated,
                                              shard_batch)
from geocalib_tpu_torch.training.checkpoint import ExperimentManager
from geocalib_tpu_torch.training.train_step import (TrainConfig, TrainState, create_train_state,
                                                    eval_fields, make_eval_step,
                                                    make_train_step, param_grads)
from geocalib_tpu_torch.utils.config import apply_dotlist, load_yaml, merge, save_yaml
from geocalib_tpu_torch.utils.summary_writer import SummaryWriter
from geocalib_tpu_torch.utils.threefry import Key, prng_key, split

default_conf: Dict[str, Any] = {
    "seed": 0,
    "train": {
        "lr": 1e-4,
        "weight_decay": 1e-2,
        "clip_grad": 1.0,
        "warmup_steps": 4_000,
        "decay_milestones": [80_000, 130_000],
        "total_steps": 150_000,
        "camera_model": "pinhole",
        "lm_steps": 10,
        # LM gradients: "ift" (at the fixed point, the stable default) or
        # "unroll" (backprop through every iteration)
        "lm_grad_mode": "ift",
        "variant": "b",
        "drop_path_rate": 0.1,
        # the JAX package's fused dual-head training tower; the port runs each
        # head at its own width, the same math, whatever this says
        "fused_forward": True,
        "log_every": 100,
        "eval_every": 1000,
        "save_every": 5000,
        "best_key": "loss/param_total",
        "input_size": 320,
        # benchmark evaluations during training (names from eval/benchmarks); 0 disables
        "benchmark_every": 0,
        "benchmarks": ["openpano_synth"],
        # up/latitude field figures with each validation (0 disables); need matplotlib
        "figures_every": 1000,
        "val_batches": 10,
        # warm-start weights (a Flax msgpack from training/export.py)
        "init_weights": "",
        # staged mode: rows staged at a time (0 = the whole split), how often a
        # fresh draw is staged, and the val rows staged
        "staged_subset": 0,
        "staged_refresh_every": 5000,
        "staged_val_rows": 2048,
    },
    "data": {
        "dataset_dir": "",
        "batch_size": 24,
        "augmentation": "geocalib",
        "camera_model": "pinhole",
    },
}


def make_train_config(conf: Dict[str, Any]) -> TrainConfig:
    t = conf["train"]
    return TrainConfig(
        lr=float(t["lr"]),
        weight_decay=float(t["weight_decay"]),
        clip_grad=float(t["clip_grad"]),
        warmup_steps=int(t["warmup_steps"]),
        decay_milestones=tuple(t["decay_milestones"]),
        total_steps=int(t["total_steps"]),
        camera_model=t["camera_model"],
        lm_steps=int(t["lm_steps"]),
        lm_grad_mode=t.get("lm_grad_mode", "ift"),
        variant=t["variant"],
        drop_path_rate=float(t["drop_path_rate"]),
    )


def _loop_batches(dataset: SimpleDataset, overfit: bool, loader: Optional[PrefetchLoader] = None,
                  mesh: Optional[Mesh] = None):
    """This rank's batches (``epoch(shard=rank, num_shards=W)``, as the JAX loop's
    processes load theirs) of epoch after epoch through the PrefetchLoader; in
    overfit mode the first batch forever (the single-batch sanity check of the
    losses)."""
    loader = loader or PrefetchLoader(dataset)
    shard = {"shard": axis_index(mesh), "num_shards": axis_size(mesh)}
    if overfit:
        first = next(iter(dataset.epoch(epoch=0, **shard)))
        while True:
            yield first
    epoch = 0
    while True:
        yield from loader.epoch(epoch=epoch, **shard)
        epoch += 1


def _audit_first_batch(net, cfg: TrainConfig, state: TrainState, batch, key: Key,
                       verbose: bool = True) -> list:
    """One-off missing-gradient audit: prints (when verbose), and returns, the
    parameters whose gradient on this batch is exactly zero."""
    from geocalib_tpu_torch.training.debug import audit_gradients

    dead = audit_gradients(param_grads(net, cfg, state, batch, key)[1], cfg.variant)
    if verbose and dead:
        print(f"WARNING: {len(dead)} parameters receive zero gradient:")
        for name in dead[:20]:
            print(f"  {name}")
    elif verbose:
        print("gradient audit: every parameter receives gradient")
    return dead


def _variables(state: TrainState) -> Dict[str, torch.Tensor]:
    """The state's parameters and running statistics as GeoCalibNet's state_dict."""
    out = {**state.params, **state.batch_stats}
    for k in state.batch_stats:
        if k.endswith("running_var"):
            out[k[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return out


def _replicated(state: TrainState, mesh: Optional[Mesh]) -> TrainState:
    """The state with every tensor overwritten by rank 0's (the JAX loop's replicated
    placement); as it is without a mesh."""
    opt = state.opt_state
    replicated([*state.params.values(), *state.batch_stats.values(), opt.count,
                *opt.mu.values(), *opt.nu.values()], mesh)
    return state


def _global_batch(conf: Dict[str, Any], mesh: Optional[Mesh]) -> int:
    """The conf's batch_size, the global batch, checked to divide by the ranks."""
    batch_size = int(conf["data"]["batch_size"])
    if batch_size % axis_size(mesh):
        raise ValueError(f"batch_size {batch_size} is not divisible by {axis_size(mesh)} ranks")
    return batch_size


def _setup(conf: Dict[str, Any], output_dir, restore: bool, device):
    """(mesh, device, writer, config, net, state, manager, start step) of a run: the
    mesh of the initialised process group (None without one) and this rank's device;
    the writer is None on ranks other than 0."""
    mesh = make_mesh(device)
    dev = mesh.device if mesh is not None else resolve_device(device)
    is_main = axis_index(mesh) == 0
    out_dir = Path(output_dir)
    writer = SummaryWriter(out_dir / "logs") if is_main else None
    if is_main:
        save_yaml(conf, out_dir / "config.yaml")
    cfg = make_train_config(conf)
    net, state = create_train_state(cfg, seed=int(conf["seed"]), device=dev, mesh=mesh)
    manager = ExperimentManager(out_dir)
    start_step = 0
    if restore and manager.latest_step() is not None:
        state, start_step = manager.restore(state)
        if is_main:
            print(f"restored checkpoint at step {start_step}")
    else:
        state = _maybe_init_weights(state, conf, is_main)
    return mesh, dev, writer, cfg, net, _replicated(state, mesh), manager, start_step


def training(conf: Dict[str, Any], output_dir, restore: bool = False,
             max_steps: Optional[int] = None, overfit: bool = False, audit_grads: bool = False,
             staged: bool = False, device=None) -> Dict[str, float]:
    """Run the training loop; returns the last logged scalars.

    staged=True copies the whole dataset to the card once and assembles every
    batch there (training/device_store.py); it writes no figures, as the JAX
    package's staged loop. The host loop raises at the start when
    ``train.figures_every`` asks for figures and matplotlib is absent.
    """
    if staged:
        return _staged_training(conf, output_dir, restore, max_steps, device)
    if int(conf["train"].get("figures_every", 0) or 0) > 0:
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            raise ImportError("train.figures_every > 0 asks for field figures, which need "
                              "matplotlib; install it or set train.figures_every=0") from e
    mesh, dev, writer, cfg, net, state, manager, start_step = _setup(conf, output_dir, restore,
                                                                     device)
    is_main = writer is not None
    dconf, t_conf = conf["data"], conf["train"]
    batch_size = _global_batch(conf, mesh)
    # augmentation="device": a decode-only host loader and the photometric
    # augmentation inside the step, on the card
    aug_mode = dconf.get("augmentation", "geocalib")
    on_device_aug = aug_mode == "device"
    camera_model = dconf.get("camera_model", cfg.camera_model)
    train_ds = SimpleDataset(DatasetConf(
        dataset_dir=dconf["dataset_dir"], csv_name="train.csv",
        batch_size=batch_size // axis_size(mesh),
        augmentation="identity" if on_device_aug else aug_mode, seed=int(conf["seed"]),
        camera_model=camera_model))
    val_ds = SimpleDataset(DatasetConf(
        dataset_dir=dconf["dataset_dir"], csv_name="val.csv", batch_size=batch_size,
        shuffle=False, augmentation="identity", camera_model=camera_model))

    step_fn = make_train_step(net, cfg, augment_on_device=on_device_aug)
    eval_fn = make_eval_step(net, cfg)
    total = min(int(t_conf["total_steps"]), max_steps or 10**12)
    best = float("inf")
    rng = prng_key(int(conf["seed"]) + 1)
    step = start_step
    scalars: Dict[str, float] = {}
    t0 = time.time()
    loader = PrefetchLoader(train_ds)
    last_stall = 0.0
    for batch in _loop_batches(train_ds, overfit, loader=loader, mesh=mesh):
        if step >= total:
            break
        batch = shard_batch(batch, dev)
        if audit_grads and step == start_step:
            # every rank runs it: the training forward's BatchNorms sync over the ranks
            _audit_first_batch(net, cfg, state, batch, rng, verbose=is_main)
        rng, step_rng = split(rng)
        state, out = step_fn(state, batch, step_rng)

        if step % int(t_conf["log_every"]) == 0:
            scalars = {k: float(v) for k, v in out.items()}
            rate = (batch_size * int(t_conf["log_every"]) / (time.time() - t0)
                    if step > start_step else 0.0)
            stall = loader.stall_s - last_stall
            last_stall = loader.stall_s
            t0 = time.time()
            if is_main:
                writer.add_scalars(scalars | {"images_per_s": rate, "loader_stall_s": stall},
                                   step)
                print(f"[{step}/{total}] loss {scalars.get('loss/total', np.nan):.4f} "
                      f"param {scalars.get('loss/param_total', np.nan):.4f} "
                      f"({rate:.1f} img/s, loader stall {stall:.2f}s)", flush=True)

        if step > start_step and step % int(t_conf["eval_every"]) == 0:
            val = evaluate(eval_fn, state, val_ds, rng, dev,
                           max_batches=int(t_conf.get("val_batches", 10)),
                           eval_idx=step // int(t_conf["eval_every"]))
            key = t_conf["best_key"]
            if is_main:
                writer.add_scalars(val, step, prefix="val/")
                fig_every = int(t_conf.get("figures_every", 0) or 0)
                if fig_every and step % fig_every == 0:
                    _log_figures(writer, net, cfg, state, val_ds, step, dev)
                if val.get(key, float("inf")) < best:
                    best = val[key]
                    manager.save(state, step, conf, val, is_best=True)

        if is_main:
            _maybe_benchmark(conf, state, cfg, writer, step, start_step, dev)
            if step > start_step and step % int(t_conf["save_every"]) == 0:
                manager.save(state, step, conf)
        step += 1

    _finish(manager, writer, state, step, conf, scalars, mesh)
    return scalars


def _finish(manager: ExperimentManager, writer: Optional[SummaryWriter], state: TrainState,
            step: int, conf: Dict[str, Any], scalars: Dict[str, float],
            mesh: Optional[Mesh]) -> None:
    """Rank 0 saves the last checkpoint and closes the logs; every rank returns only
    once it is written (a later restore on any rank reads it)."""
    if writer is not None:
        manager.save(state, step, conf, scalars)
        writer.close()
    barrier(mesh)


def _log_figures(writer: SummaryWriter, net, cfg: TrainConfig, state: TrainState,
                 val_ds: SimpleDataset, step: int, dev, n: int = 3) -> None:
    """Up and latitude field figures, predicted against the ground truth, of the first
    validation batch's first n images, through the network in evaluation mode."""
    from geocalib_tpu_torch.visualization.visualize_batch import make_perspective_figures
    from geocalib_tpu_torch.visualization.viz2d import _plt

    data = synthesize_gt_fields(shard_batch(next(iter(val_ds.epoch(epoch=0))), dev),
                                cfg.camera_model)
    dtype = DTYPES[cfg.compute_dtype]
    params = {k: v.to(dtype) if v.dtype == torch.float32 else v for k, v in state.params.items()}
    with torch.no_grad():
        pred = eval_fields(net, params, state.batch_stats, data["image"].to(dtype))
    for tag, fig in make_perspective_figures(pred, data, n_pairs=n).items():
        writer.add_figure(f"figures/{tag}", fig, step)
        _plt().close(fig)


def _maybe_benchmark(conf, state: TrainState, cfg: TrainConfig, writer: SummaryWriter,
                     step: int, start_step: int, dev) -> None:
    """Benchmark evaluations every ``benchmark_every`` steps; a benchmark whose data
    is missing is reported and skipped, any other failure raises."""
    every = int(conf["train"].get("benchmark_every", 0) or 0)
    if not every or step <= start_step or step % every:
        return
    from geocalib_tpu_torch.eval.benchmarks import run_benchmark

    for name in conf["train"].get("benchmarks", []):
        try:
            summary = run_benchmark(name, _variables(state), device=dev, variant=cfg.variant)
        except FileNotFoundError as e:
            print(f"benchmark {name} skipped: {e}")
            continue
        writer.add_scalars(summary, step, prefix=f"bench/{name}/")


def _maybe_init_weights(state: TrainState, conf: Dict[str, Any], verbose: bool = True
                        ) -> TrainState:
    """Parameters and running statistics from ``train.init_weights`` (a Flax msgpack;
    the radial fine-tune starts from the pinhole model), the optimizer state as it is.
    Not used when a checkpoint is restored."""
    init_w = str(conf["train"].get("init_weights", "") or "")
    if not init_w:
        return state
    sd = params_from_jax(read_flax_msgpack(init_w), conf["train"].get("variant", "b"))
    place = lambda tree: {k: sd[k].to(v.device, v.dtype) for k, v in tree.items()}
    if verbose:
        print(f"initialized weights from {init_w}")
    return TrainState(state.step, place(state.params), place(state.batch_stats),
                      state.opt_state)


def _staged_training(conf: Dict[str, Any], output_dir, restore: bool = False,
                     max_steps: Optional[int] = None, device=None) -> Dict[str, float]:
    """The training loop on a dataset staged on the card: the schedule, logging and
    checkpoints of ``training``, with every batch sampled and augmented there (over a
    mesh, each rank stages its 1/W of the rows and samples its 1/W of the batch)."""
    from geocalib_tpu_torch.training.device_store import (DeviceStore, make_staged_eval_step,
                                                          make_staged_train_step,
                                                          staged_evaluate)

    mesh, dev, writer, cfg, net, state, manager, start_step = _setup(conf, output_dir, restore,
                                                                     device)
    is_main = writer is not None
    dconf, t_conf = conf["data"], conf["train"]
    batch_size = _global_batch(conf, mesh)
    mk_ds = lambda csv: SimpleDataset(DatasetConf(
        dataset_dir=dconf["dataset_dir"], csv_name=csv, batch_size=batch_size,
        augmentation="identity", camera_model=dconf.get("camera_model", cfg.camera_model)))
    train_ds = mk_ds("train.csv")

    # a split larger than its device budget is staged as rotating random subsets
    staged_subset = int(t_conf.get("staged_subset", 0) or 0)
    refresh_every = int(t_conf.get("staged_refresh_every", 5000))
    store_rng = np.random.default_rng(int(conf["seed"]) + 17)
    subset = staged_subset and staged_subset < len(train_ds.rows)

    def stage_train() -> DeviceStore:
        idx = (store_rng.choice(len(train_ds.rows), size=staged_subset, replace=False)
               if subset else None)
        return DeviceStore.stage_sharded(train_ds, mesh, row_indices=idx, device=dev,
                                         progress=print if is_main else None)

    store = stage_train()
    val_ds = mk_ds("val.csv")
    val_cap = int(t_conf.get("staged_val_rows", 2048) or 0)
    val_idx = range(min(val_cap, len(val_ds.rows))) if val_cap else None
    val_store = DeviceStore.stage_sharded(val_ds, mesh, row_indices=val_idx, device=dev,
                                          progress=print if is_main else None)

    augment = dconf.get("augmentation", "geocalib") != "identity"
    step_fn = make_staged_train_step(net, cfg, batch_size, augment=augment)
    eval_fn = make_staged_eval_step(net, cfg, batch_size)
    total = min(int(t_conf["total_steps"]), max_steps or 10**12)
    best = float("inf")
    rng = prng_key(int(conf["seed"]) + 1)
    scalars: Dict[str, float] = {}
    t0 = time.time()
    for step in range(start_step, total):
        if subset and step > start_step and step % refresh_every == 0:
            store = None  # free the old store before the new one is staged
            store = stage_train()
        rng, step_rng = split(rng)
        state, out = step_fn(state, store.images, store.gt_params, step_rng)

        if step % int(t_conf["log_every"]) == 0:
            scalars = {k: float(v) for k, v in out.items()}
            rate = (batch_size * int(t_conf["log_every"]) / (time.time() - t0)
                    if step > start_step else 0.0)
            t0 = time.time()
            if is_main:
                writer.add_scalars(scalars | {"images_per_s": rate}, step)
                print(f"[{step}/{total}] loss {scalars.get('loss/total', np.nan):.4f} "
                      f"param {scalars.get('loss/param_total', np.nan):.4f} ({rate:.1f} img/s)",
                      flush=True)

        if step > start_step and step % int(t_conf["eval_every"]) == 0:
            val = staged_evaluate(eval_fn, state, val_store, rng,
                                  max_batches=int(t_conf.get("val_batches", 10)),
                                  eval_idx=step // int(t_conf["eval_every"]))
            key = t_conf["best_key"]
            if is_main:
                writer.add_scalars(val, step, prefix="val/")
                print(f"[{step}] val {key} = {val.get(key, np.nan):.4f}", flush=True)
                if val.get(key, float("inf")) < best:
                    best = val[key]
                    manager.save(state, step, conf, val, is_best=True)

        if is_main and step > start_step and step % int(t_conf["save_every"]) == 0:
            manager.save(state, step, conf)

    _finish(manager, writer, state, total, conf, scalars, mesh)
    return scalars


def evaluate(eval_fn, state: TrainState, dataset: SimpleDataset, key: Key, device,
             max_batches: int = 10, eval_idx: int = 0) -> Dict[str, float]:
    """Deterministic validation over a rotating window of the val split: call
    eval_idx = 0, 1, ... walks disjoint max_batches-sized windows, so that the best
    checkpoint is judged on the whole split over time."""
    n_batches = max(1, len(dataset) // dataset.conf.batch_size)
    start = (eval_idx * max_batches) % n_batches if n_batches > max_batches else 0
    agg: Dict[str, list] = {}
    taken = 0
    for batch in dataset.epoch(epoch=0, start_batch=start):
        if taken >= max_batches:
            break
        taken += 1
        for k, v in eval_fn(state, shard_batch(batch, device), key).items():
            agg.setdefault(k, []).append(float(v))
    if not agg:
        print("WARNING: val split smaller than one batch; no val metrics computed")
    return {k: float(np.mean(v)) for k, v in agg.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("experiment", help="experiment name (under --output_root)")
    ap.add_argument("--conf", default=None, help="YAML config path (needs PyYAML)")
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--overfit", action="store_true",
                    help="repeat one batch forever (loss sanity check)")
    ap.add_argument("--staged", action="store_true",
                    help="stage the whole dataset on the card once and assemble batches there")
    ap.add_argument("--detect_anomaly", action="store_true",
                    help="raise on the first NaN/Inf of the backward, loss or gradients")
    ap.add_argument("--audit_grads", action="store_true",
                    help="name the parameters with a zero gradient on the first step")
    ap.add_argument("--output_root", default="outputs/training")
    ap.add_argument("--device", default=None,
                    help="cuda (default; under torchrun cuda:LOCAL_RANK) or cpu")
    ap.add_argument("dotlist", nargs="*", help="a.b=c overrides")
    args = ap.parse_args(argv)

    conf = merge(default_conf, load_yaml(args.conf) if args.conf else None)
    conf = apply_dotlist(conf, args.dotlist)
    from geocalib_tpu_torch.training.debug import detect_anomaly

    group = maybe_initialize_distributed(args.device)
    try:
        with detect_anomaly() if args.detect_anomaly else contextlib.nullcontext():
            training(conf, Path(args.output_root) / args.experiment, restore=args.restore,
                     overfit=args.overfit, audit_grads=args.audit_grads, staged=args.staged,
                     device=args.device)
    finally:
        if group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
