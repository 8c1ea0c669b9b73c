"""DeepCalib baseline trainer: staged on-device loop for the bin classifier.

Port of geocalib_tpu/training/train_deepcalib.py. A bounded random subset of
the train split is staged on the device once (training/device_store.py), and
every step draws its batch there with the ``"deepcalib"`` augmentation
(data/device_augment.py), keyed as the JAX loop keys it: ``PRNGKey(seed +
1)`` split once a step, the step's key split into the batch key and an unused
one. The subset is ``np.random.default_rng(seed + 3).choice``, as in JAX.

The optimizer is optax's ``chain(clip_by_global_norm(clip), adamw(schedule,
weight_decay))`` with adamw's default mask, so every leaf decays (BatchNorm
scales and biases too), after non-finite gradient values are zeroed; it is
training/train_step.py's ``optimizer_update`` with this loop's schedule, a
linear warm-up from 0 joined to a cosine decay to 0. Images are rounded to
bf16 and the network runs in float32, as in the JAX package (and with TF32
off on the card, backward included).

Without ``train.init_weights`` the network starts from torch's own
initialisation seeded with ``seed``, not Flax's; with it (a msgpack this
trainer or the JAX one exported) both packages start from the same weights.
Checkpoints are the port's (training/checkpoint.py); the final export is the
JAX package's format, ``weights/deepcalib_<exp>.msgpack`` under the working
directory, ``{"params", "batch_stats", "conf"}``, which both packages'
``baselines_cli`` read.

Usage (the card by default; ``--device cpu`` for the CPU):
    python -m geocalib_tpu_torch.training.train_deepcalib deepcalib_r04 \\
        data.dataset_dir=data/openpano_synth_v2 train.total_steps=4000
"""

import argparse
import math
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from geocalib_tpu_torch.data.dataset import DatasetConf, SimpleDataset
from geocalib_tpu_torch.extractor import resolve_device
from geocalib_tpu_torch.models.deepcalib import HEADS, DeepCalib, exact_float32
from geocalib_tpu_torch.models.geocalib_net import RUNNING_STATS
from geocalib_tpu_torch.models.weights import (deepcalib_params_from_jax,
                                               deepcalib_params_to_jax, read_flax_msgpack,
                                               write_flax_msgpack)
from geocalib_tpu_torch.training.checkpoint import ExperimentManager
from geocalib_tpu_torch.training.device_store import DeviceStore, sample_batch
from geocalib_tpu_torch.training.train_step import (TrainConfig, TrainState, optimizer_init,
                                                    optimizer_update)
from geocalib_tpu_torch.utils.config import apply_dotlist, merge, save_yaml
from geocalib_tpu_torch.utils.conversions import fov2focal, pitch2rho
from geocalib_tpu_torch.utils.summary_writer import SummaryWriter
from geocalib_tpu_torch.utils.threefry import Key, prng_key, split

Tensor = torch.Tensor

default_conf: Dict[str, Any] = {
    "seed": 0,
    "train": {
        "lr": 1e-4,
        "weight_decay": 1e-2,
        "clip_grad": 1.0,
        "warmup_steps": 200,
        "total_steps": 4000,
        "num_bins": 256,
        "log_every": 50,
        "eval_every": 500,
        "save_every": 1000,
        "input_size": 320,
        # tiny-ish DenseNet trunk, trained from scratch
        "block_config": [4, 8, 12, 8],
        "growth_rate": 32,
        "staged_subset": 8192,
        # device augmentation preset (data/device_augment.DEVICE_AUGMENTATIONS)
        "augmentation": "deepcalib",
        # warm-start from an exported msgpack (empty = train from scratch)
        "init_weights": "",
    },
    "data": {"dataset_dir": "", "batch_size": 32},
}


def gt_heads(gt_params: Tensor) -> Dict[str, Tensor]:
    """gt_params rows (w, h, vfov, roll, pitch, k1, k2) → per-head targets."""
    w, h, vfov, roll, pitch, k1 = (gt_params[:, i] for i in range(6))
    f = fov2focal(vfov, h)
    rho = pitch2rho(pitch, f, h)
    k1_hat = k1 / (f / h) ** 2
    return {"roll": roll, "rho": rho, "vfov": vfov, "k1_hat": k1_hat}


def make_schedule(lr: float, warmup_steps: int, total_steps: int
                  ) -> Callable[[Tensor], Tensor]:
    """optax's ``join_schedules([linear_schedule(0, lr, warmup), cosine_decay_schedule(lr,
    max(1, total - warmup))], [warmup])`` in float32, as optax computes it."""
    T, D = int(warmup_steps), max(1, int(total_steps) - int(warmup_steps))
    f32 = lambda v: float(np.float32(v))

    def warmup(count: Tensor) -> Tensor:
        if T <= 0:  # optax: a constant schedule at the initial value
            return torch.zeros((), dtype=torch.float32, device=count.device)
        frac = 1.0 - torch.clamp(count, 0, T).float() / T
        return frac * f32(0.0 - lr) + f32(lr)

    def cosine(count: Tensor) -> Tensor:
        c = torch.clamp(count.float(), max=float(D))
        return f32(lr) * (0.5 * (1 + torch.cos(math.pi * c / float(D))))

    def schedule(count) -> Tensor:
        count = torch.as_tensor(count, dtype=torch.int32)
        return torch.where(count < T, warmup(count), cosine(count - T))

    return schedule


def _outputs(net: DeepCalib, params: Dict[str, Tensor], stats: Dict[str, Tensor],
             image: Tensor) -> Dict[str, Tensor]:
    out = torch.func.functional_call(net, (params, stats), (image.to(torch.bfloat16),))
    return {k: v.float() for k, v in out.items()}


def _scalars(loss: Tensor, out: Dict[str, Tensor], gt: Dict[str, Tensor]) -> Dict[str, Tensor]:
    scalars = {"loss/total": loss.detach()}
    for head in HEADS:
        scalars[f"metric/{head}_err"] = torch.abs(out[head].detach() - gt[head]).mean()
    return scalars


def make_train_step(net: DeepCalib, cfg: TrainConfig, schedule, num_bins: int,
                    batch_size: int, augment: str = "deepcalib"):
    """step(state, images, gt_params, key) -> (state, scalars) on a network in training
    mode: the batch from the first half of ``split(key)``, the NLL's gradient in float32
    with TF32 off, the running statistics updated from the batch, and the optimizer."""

    def step(state: TrainState, images: Tensor, gt_params: Tensor, key: Key):
        k_batch, _ = split(key)
        batch = sample_batch(images, gt_params, k_batch, batch_size, augment=augment)
        gt = gt_heads(batch["gt_params"])
        params = {k: v.detach().requires_grad_() for k, v in state.params.items()}
        stats = {k: v.clone() for k, v in state.batch_stats.items()}
        names = list(params)
        with exact_float32():
            out = _outputs(net, params, stats, batch["image"])
            loss = DeepCalib.loss(out, gt, num_bins).mean()
            grads = torch.autograd.grad(loss, [params[k] for k in names])
        new_params, opt_state, _ = optimizer_update(dict(zip(names, grads)), state.opt_state,
                                                    state.params, cfg, schedule=schedule)
        new_state = TrainState(state.step + 1, new_params, stats, opt_state)
        return new_state, _scalars(loss, out, gt)

    return step


def make_eval_step(net: DeepCalib, num_bins: int, batch_size: int):
    """eval_window(state, images, gt_params, start): the loss and errors of the staged
    rows start .. start + batch_size - 1 (modulo the rows), in evaluation mode."""

    @torch.no_grad()
    def eval_window(state: TrainState, images: Tensor, gt_params: Tensor, start: int):
        idx = (start + torch.arange(batch_size, device=images.device)) % images.shape[0]
        img = images[idx].float() / 255.0
        gt = gt_heads(gt_params[idx])
        was_training = net.training
        net.eval()
        try:
            out = _outputs(net, state.params, state.batch_stats, img)
        finally:
            net.train(was_training)
        return _scalars(DeepCalib.loss(out, gt, num_bins).mean(), out, gt)

    return eval_window


def create_state(net: DeepCalib) -> TrainState:
    """The training state of the network's own parameters and running statistics."""
    params = {k: v.detach().clone() for k, v in net.named_parameters()}
    stats = {k: v.detach().clone() for k, v in net.named_buffers() if k.endswith(RUNNING_STATS)}
    return TrainState(0, params, stats, optimizer_init(params))


def export_tree(state: TrainState, block_config, num_bins: int, growth_rate: int
                ) -> Dict[str, Any]:
    """The export's tree {"params", "batch_stats", "conf"}, the conf's block_config a
    {"0": ..., ...} map, as flax.serialization writes a list."""
    tree = deepcalib_params_to_jax({**state.params, **state.batch_stats}, block_config)
    tree["conf"] = {"num_bins": int(num_bins),
                    "block_config": {str(i): int(v) for i, v in enumerate(block_config)},
                    "growth_rate": int(growth_rate)}
    return tree


def training(conf: Dict[str, Any], output_dir, restore: bool = False, device=None
             ) -> Dict[str, float]:
    out_dir = Path(output_dir)
    writer = SummaryWriter(out_dir / "logs")
    save_yaml(conf, out_dir / "config.yaml")
    t_conf, dconf = conf["train"], conf["data"]
    batch = int(dconf["batch_size"])
    num_bins = int(t_conf["num_bins"])
    block_config = tuple(int(b) for b in t_conf["block_config"])
    dev = resolve_device(device)

    torch.manual_seed(int(conf["seed"]))
    net = DeepCalib(num_bins=num_bins, block_config=block_config,
                    growth_rate=int(t_conf["growth_rate"])).to(dev).train()
    cfg = TrainConfig(lr=float(t_conf["lr"]), weight_decay=float(t_conf["weight_decay"]),
                      clip_grad=float(t_conf["clip_grad"]))
    schedule = make_schedule(float(t_conf["lr"]), int(t_conf["warmup_steps"]),
                             int(t_conf["total_steps"]))
    state = create_state(net)
    manager = ExperimentManager(out_dir)
    start_step = 0
    if restore and manager.latest_step() is not None:
        state, start_step = manager.restore(state)
        print(f"restored checkpoint at step {start_step}")
    elif str(t_conf.get("init_weights", "") or ""):
        sd = deepcalib_params_from_jax(read_flax_msgpack(str(t_conf["init_weights"])), block_config)
        state = TrainState(0, {k: sd[k].to(dev) for k in state.params},
                           {k: sd[k].to(dev) for k in state.batch_stats},
                           optimizer_init({k: sd[k].to(dev) for k in state.params}))
        print(f"initialized weights from {t_conf['init_weights']}")

    mk = lambda csv: SimpleDataset(DatasetConf(dataset_dir=dconf["dataset_dir"], csv_name=csv,
                                               batch_size=batch, augmentation="identity"))
    # stage a bounded random subset (the full split would not share the card's
    # memory with the DenseNet's activations)
    train_rows = mk("train.csv")
    cap = int(t_conf.get("staged_subset", 8192) or 0)
    idx = None
    if cap and cap < len(train_rows.rows):
        idx = np.random.default_rng(int(conf["seed"]) + 3).choice(len(train_rows.rows), size=cap,
                                                                    replace=False)
    store = DeviceStore.stage(train_rows, device=dev, row_indices=idx)
    val_ds = mk("val.csv")
    val_store = DeviceStore.stage(val_ds, device=dev, row_indices=range(min(1024, len(val_ds.rows))))

    step_fn = make_train_step(net, cfg, schedule, num_bins, batch,
                              t_conf.get("augmentation", "deepcalib"))
    eval_fn = make_eval_step(net, num_bins, batch)

    total = int(t_conf["total_steps"])
    loop_key = prng_key(int(conf["seed"]) + 1)
    t0 = time.time()
    scalars: Dict[str, float] = {}
    for step in range(start_step, total):
        loop_key, step_key = split(loop_key)
        state, out = step_fn(state, store.images, store.gt_params, step_key)
        if step % int(t_conf["log_every"]) == 0:
            scalars = {k: float(v) for k, v in out.items()}
            rate = (batch * int(t_conf["log_every"]) / (time.time() - t0)
                    if step > start_step else 0.0)
            t0 = time.time()
            writer.add_scalars(scalars | {"images_per_s": rate}, step)
            print(f"[{step}/{total}] loss {scalars['loss/total']:.3f} "
                  f"roll_err {scalars['metric/roll_err']:.4f} "
                  f"vfov_err {scalars['metric/vfov_err']:.4f} ({rate:.1f} img/s)", flush=True)
        if step > start_step and step % int(t_conf["eval_every"]) == 0:
            vals = [{k: float(v) for k, v in eval_fn(state, val_store.images, val_store.gt_params,
                                                     i * batch).items()} for i in range(8)]
            val = {k: float(np.mean([v[k] for v in vals])) for k in vals[0]}
            writer.add_scalars(val, step, prefix="val/")
            print(f"[{step}] val loss {val['loss/total']:.3f} "
                  f"roll_err {val['metric/roll_err']:.4f}", flush=True)
        if step > start_step and step % int(t_conf["save_every"]) == 0:
            manager.save(state, step, conf)
    manager.save(state, total, conf, scalars)
    writer.close()

    # msgpack export for the eval pipeline / accuracy table
    weights_dir = Path("weights")
    weights_dir.mkdir(exist_ok=True)
    path = weights_dir / f"deepcalib_{out_dir.name}.msgpack"
    write_flax_msgpack(export_tree(state, block_config, num_bins, int(t_conf["growth_rate"])),
                       path)
    print(f"exported {path}")
    return scalars


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("experiment")
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--output_root", default="outputs/training")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("dotlist", nargs="*")
    args = ap.parse_args(argv)
    conf = apply_dotlist(merge(default_conf, None), args.dotlist)
    training(conf, Path(args.output_root) / args.experiment, restore=args.restore,
             device=args.device)


if __name__ == "__main__":
    main()
