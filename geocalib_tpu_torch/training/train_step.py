"""One training step: the network, the differentiable LM, the losses, the
backward and AdamW, data-parallel over the ranks of a mesh.

Port of geocalib_tpu/training/train_step.py, whose shard_map step is here one
process per device (parallel/mesh.py). The step reads the mesh from the
network (``net.mesh``, given to ``create_train_state``), and with it:
- the key is folded with the rank (the JAX step's data-axis index) for
  DropPath and the NMF, and ``fold_in(fold_in(key, 1), rank)`` keys the device
  augmentation;
- the BatchNorms sync their batch statistics over the ranks (models/modules.py);
- the flat gradient vector that ``optimizer_update`` builds takes one mean over
  the ranks, before the zeroing of non-finite values and the clip, so every
  rank makes the same update; the loss and every scalar are means over the
  ranks (one collective), and a non-finite loss on any rank skips the step on
  every rank (the NaN vote, a minimum over the ranks).
Without a mesh the rank is 0 and nothing crosses processes; with a one-rank
group every result is bit for bit the same as without one.

- Mixed precision as the JAX step: float32 master parameters, cast to the
  compute dtype for the forward through ``torch.func.functional_call``, so
  that the gradients land on the float32 leaves; BatchNorm keeps float32
  running statistics; the solver, losses and optimizer run in float32.
- The key is split into a DropPath key and an NMF key, as the JAX step
  splits it into its "dropout" and "nmf" streams. The NMF bases match JAX
  bit for bit; DropPath draws its own masks from a generator seeded by its
  key (Flax draws per-module masks, which are not reproduced).
- The optimizer (``optimizer_update``) is optax's ``chain(zero_nans(),
  clip_by_global_norm(clip), adamw(schedule, weight_decay))`` written out:
  non-finite gradient values zeroed (NaNs as zero_nans does), then g·clip/‖g‖
  when ‖g‖ ≥ clip, then Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected),
  decoupled weight decay on every leaf, and the scheduled step, each
  operation one kernel over all leaves concatenated into one vector
  (``torch._foreach_*`` ops would allocate one tensor per leaf per
  operation, 748 for MSCAN-B, whose host time outweighs the arithmetic). Its
  state is (count, mu, nu), each tree's leaves views of one vector.
- A non-finite loss keeps the parameters, optimizer state and running
  statistics.
- ``loss_and_updates(train=False)`` is validation (``make_eval_step``), and
  ``make_train_step(augment_on_device=True)`` augments the batch on the device
  first, keyed as the JAX package's sharded step keys it.
"""

import dataclasses
from pathlib import Path
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from geocalib_tpu_torch.data.dataset import synthesize_gt_fields
from geocalib_tpu_torch.data.device_augment import device_augment
from geocalib_tpu_torch.extractor import DTYPES, resolve_device
from geocalib_tpu_torch.models.geocalib_net import RUNNING_STATS, GeoCalibNet
from geocalib_tpu_torch.models.weights import params_from_jax, read_flax_msgpack
from geocalib_tpu_torch.optim.lm import LMConfig, run_lm
from geocalib_tpu_torch.parallel.mesh import Mesh, axis_index, mean_over_ranks, min_over_ranks
from geocalib_tpu_torch.training.debug import check_finite
from geocalib_tpu_torch.training.losses import geocalib_losses, geocalib_metrics
from geocalib_tpu_torch.utils.threefry import Key, fold_in, split

Tensor = torch.Tensor
Tree = Dict[str, Tensor]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Static training configuration; the defaults are the JAX package's recipe.

    The JAX package's ``fused_forward`` (the two heads as one block-diagonal
    tower) has no counterpart: the port runs each head at its own width, the
    same math.
    """

    lr: float = 1e-4
    weight_decay: float = 1e-2
    clip_grad: float = 1.0
    warmup_steps: int = 4_000
    decay_milestones: Tuple[int, ...] = (80_000, 130_000)
    decay_gamma: float = 0.1
    total_steps: int = 150_000
    camera_model: str = "pinhole"
    lm_steps: int = 10
    lm_grad_mode: str = "ift"  # "ift" | "unroll"
    variant: str = "b"
    drop_path_rate: float = 0.1
    compute_dtype: str = "bfloat16"

    def lm_config(self) -> LMConfig:
        """The training solver: squared loss, a fixed number of steps, no uncertainty."""
        return LMConfig(camera_model=self.camera_model, num_steps=self.lm_steps,
                        loss_fn="squared", early_stop=False, with_uncertainty=False,
                        grad_mode=self.lm_grad_mode)


def make_schedule(cfg: TrainConfig) -> Callable[[Union[int, Tensor]], Tensor]:
    """optax's ``join_schedules`` of a linear warmup from lr·1e-3 to lr over
    ``warmup_steps`` and a piecewise-constant decay by ``decay_gamma`` at each
    milestone, in float32 as optax computes it. Count 0 is the first step. The
    constants reach the kernels as float32-exact scalars: no host-to-device copy."""
    init, end, T = cfg.lr * 1e-3, cfg.lr, cfg.warmup_steps
    f32 = lambda v: float(np.float32(v))

    def warmup(count: Tensor) -> Tensor:
        frac = 1.0 - torch.clamp(count, 0, T).float() / T
        return frac * f32(init - end) + f32(end)

    def decays(count: Tensor) -> Tensor:
        v = torch.full((), f32(cfg.lr), dtype=torch.float32, device=count.device)
        for milestone in sorted(cfg.decay_milestones):
            ind = torch.clamp(torch.sign(milestone - count).float(), min=0.0)
            v = v * ind + (1.0 - ind) * cfg.decay_gamma * v
        return v

    def schedule(count: Union[int, Tensor]) -> Tensor:
        count = torch.as_tensor(count, dtype=torch.int32)
        return torch.where(count < T, warmup(count), decays(count - T + T))

    return schedule


class AdamState(NamedTuple):
    count: Tensor  # int32, steps taken
    mu: Tree
    nu: Tree


def optimizer_init(params: Tree) -> AdamState:
    dev = next(iter(params.values())).device
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    return AdamState(torch.zeros((), dtype=torch.int32, device=dev), zeros,
                     {k: torch.zeros_like(v) for k, v in params.items()})


def _flat(tree: Tree, names) -> Tensor:
    """The leaves of `tree`, in the order of `names`, in one float32 vector (a copy)."""
    return torch.cat([tree[k].reshape(-1) for k in names])


def _unflat(flat: Tensor, like: Tree) -> Tree:
    """``_flat``'s inverse: views of `flat` shaped as the leaves of `like`."""
    parts = flat.split([v.numel() for v in like.values()])
    return {k: p.view(v.shape) for (k, v), p in zip(like.items(), parts)}


def optimizer_update(grads: Tree, state: AdamState, params: Tree, cfg: TrainConfig,
                     finite: Union[bool, Tensor] = True, mesh: Optional[Mesh] = None,
                     schedule: Optional[Callable[[Tensor], Tensor]] = None
                     ) -> Tuple[Tree, AdamState, Dict[str, Tensor]]:
    """The step's optimizer: (new parameters, new state, {"grad_norm", "grad_nonfinite"}).
    The rate comes from ``schedule`` (count -> float32 rate), by default
    ``make_schedule(cfg)``; cfg gives the clip and the weight decay.

    The gradients, concatenated into one vector, take their mean over the mesh's
    ranks (one collective; none without a mesh). Non-finite gradient values are
    zeroed (which subsumes optax's zero_nans), then optax's clip_by_global_norm and
    adamw, each element's arithmetic optax's in its order, and the update applied. Where `finite` is false (a non-finite loss) the
    parameters and state are kept. Each operation is one kernel over the leaves
    concatenated into one vector; the results are views of those vectors. grad_norm
    is the norm after the mean and the zeroing, before the clip.
    """
    names = list(params)
    g = mean_over_ranks(_flat(grads, names), mesh)
    ok = torch.isfinite(g)
    g = torch.where(ok, g, 0.0)
    p, mu, nu = (_flat(t, names) for t in (params, state.mu, state.nu))
    norm = torch.linalg.vector_norm(g)
    g = torch.where(norm < cfg.clip_grad, g, g / norm * cfg.clip_grad)
    new_mu = (1 - ADAM_B1) * g + ADAM_B1 * mu
    new_nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu
    step = (state.count + 1).float()
    decay = lambda b: torch.full((), b, dtype=torch.float32, device=step.device)
    bc1 = 1.0 - torch.pow(decay(ADAM_B1), step)
    bc2 = 1.0 - torch.pow(decay(ADAM_B2), step)
    lr = (schedule or make_schedule(cfg))(state.count)
    u = (new_mu / bc1) / (torch.sqrt(new_nu / bc2) + ADAM_EPS)
    new_p = p + -lr * (u + cfg.weight_decay * p)
    finite = torch.as_tensor(finite, device=p.device)
    keep = lambda new, old: _unflat(torch.where(finite, new, old), params)
    new_state = AdamState(torch.where(finite, state.count + 1, state.count), keep(new_mu, mu),
                          keep(new_nu, nu))
    return keep(new_p, p), new_state, {"grad_nonfinite": 1.0 - ok.all().float(), "grad_norm": norm}


@dataclasses.dataclass
class TrainState:
    step: int
    params: Tree       # float32 master parameters, by GeoCalibNet name
    batch_stats: Tree  # BatchNorm running statistics, float32
    opt_state: AdamState


def create_train_state(cfg: TrainConfig, weights: Optional[Union[str, Path, Tree]] = None,
                       seed: int = 0, device: Optional[Union[str, torch.device]] = "cuda",
                       mesh: Optional[Mesh] = None) -> Tuple[GeoCalibNet, TrainState]:
    """The network in training mode on `device` (the mesh's device, with a mesh) and
    its training state; the network carries the mesh (``net.mesh``).

    weights: a Flax msgpack file of the JAX package, a state_dict, or None for
    torch's own initialization seeded with `seed`. ``device="cuda"`` raises
    when there is no card. The state is not broadcast here: the loop replicates
    it from rank 0 (``parallel.mesh.replicated``).
    """
    dev = mesh.device if mesh is not None else resolve_device(device)
    torch.manual_seed(seed)
    net = GeoCalibNet(cfg.variant, cfg.drop_path_rate, mesh)
    if weights is not None:
        if isinstance(weights, (str, Path)):
            weights = params_from_jax(read_flax_msgpack(weights), cfg.variant)
        net.load_state_dict(weights)
    net = net.to(dev).train()
    params = {k: v.detach().clone() for k, v in net.named_parameters()}
    stats = {k: v.detach().clone() for k, v in net.named_buffers() if k.endswith(RUNNING_STATS)}
    return net, TrainState(0, params, stats, optimizer_init(params))


def _generator(key: Key, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((key[0] << 32) | key[1])
    return gen


def eval_fields(net: GeoCalibNet, params: Tree, batch_stats: Tree, image: Tensor
                ) -> Dict[str, Tensor]:
    """The network's fields in evaluation mode (running statistics, no DropPath, the
    evaluation NMF) on these parameters; the module's mode is restored after."""
    was_training = net.training
    net.eval()
    try:
        return torch.func.functional_call(net, (params, batch_stats), (image,))
    finally:
        net.train(was_training)


def loss_and_updates(net: GeoCalibNet, cfg: TrainConfig, params: Tree, batch_stats: Tree,
                     batch: Dict[str, Any], key: Key, train: bool = True):
    """The forward (network and differentiable LM) and the training losses.

    batch: "image" (B, H, W, 3) and either "gt_params" (B, 7) or the GT fields
    with "camera" and "gravity". Returns (mean total loss, (running statistics,
    losses, metrics)); ``batch_stats`` itself is left as it is. train=False is
    validation, as the JAX package's: the network in evaluation mode (running
    statistics, no DropPath, the evaluation NMF from the ``PRNGKey(0)`` bases,
    the kernel on the card, so call it under ``torch.no_grad``), and the
    statistics returned unchanged.
    """
    if "up_field" not in batch:
        batch = synthesize_gt_fields(batch, cfg.camera_model)
    d_key, n_key = split(key)
    dtype = DTYPES[cfg.compute_dtype]
    cast = {k: v.to(dtype) if v.dtype == torch.float32 else v for k, v in params.items()}
    image = batch["image"].to(dtype)
    if train:
        stats = {k: v.clone() for k, v in batch_stats.items()}
        fields, new_stats = torch.func.functional_call(
            net, (cast, stats), (image, n_key), {"generator": _generator(d_key, image.device)})
    else:
        fields = eval_fields(net, cast, batch_stats, image)
        new_stats = batch_stats
    fields = {k: v.float() for k, v in fields.items()}
    res = run_lm(dict(fields), cfg.lm_config())
    losses = geocalib_losses(fields, res.camera, res.gravity, batch, batch["camera"],
                             batch["gravity"])
    metrics = geocalib_metrics(fields, res.camera, res.gravity, batch, batch["camera"],
                               batch["gravity"])
    return losses["total"].mean(), (new_stats, losses, metrics)


def param_grads(net: GeoCalibNet, cfg: TrainConfig, state: TrainState, batch: Dict[str, Any],
                key: Key):
    """(loss, gradients of the float32 parameters, new statistics, losses, metrics) of
    ``loss_and_updates`` with this key; a parameter the loss does not reach gets zeros."""
    params = {k: v.detach().requires_grad_() for k, v in state.params.items()}
    loss, (new_stats, losses, metrics) = loss_and_updates(net, cfg, params, state.batch_stats,
                                                          batch, key)
    names = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
    grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(names, grads)}
    return loss.detach(), grads, new_stats, losses, metrics


def compute_grads(net: GeoCalibNet, cfg: TrainConfig, state: TrainState, batch: Dict[str, Any],
                  key: Key):
    """This rank's ``param_grads`` of one step, before the mean over the ranks and any
    sanitising, with the step's key folded with the rank as train_step folds it."""
    return param_grads(net, cfg, state, batch, fold_in(key, axis_index(net.mesh)))


def train_step(net: GeoCalibNet, cfg: TrainConfig, state: TrainState, batch: Dict[str, Any],
               key: Key) -> Tuple[TrainState, Dict[str, Tensor]]:
    """One step on this rank's rows: (new state, scalars). The scalars are the mean
    of every loss and metric over the whole batch (over the ranks),
    skipped_nonfinite (1 when the loss was not finite and nothing moved),
    grad_nonfinite and grad_norm (after the mean over the ranks and the zeroing,
    before the clip). The optimizer, the update and the keep-if-finite run on the
    leaves concatenated into one vector each, a few dozen launches in all and no
    host sync; the new state's leaves are views of those vectors."""
    mesh = net.mesh
    loss, grads, new_stats, losses, metrics = compute_grads(net, cfg, state, batch, key)
    check_finite(loss, grads)
    names = [f"loss/{k}" for k in losses] + [f"metric/{k}" for k in metrics]
    means = mean_over_ranks(torch.stack([loss] + [v.detach().mean() for v in losses.values()]
                                        + [v.detach().mean() for v in metrics.values()]), mesh)
    # JAX's pmin vote; the mean is already equal on every rank, so the vote changes no
    # result and keeps the step's collectives those of the JAX step
    finite = min_over_ranks(torch.isfinite(means[0]).float(), mesh) > 0.5
    params, opt_state, grad_scalars = optimizer_update(grads, state.opt_state, state.params, cfg,
                                                       finite, mesh)
    state = TrainState(
        step=state.step + 1,
        params=params,
        batch_stats={k: torch.where(finite, new_stats[k].detach(), v)
                     for k, v in state.batch_stats.items()},
        opt_state=opt_state,
    )
    scalars = dict(zip(names, means[1:].unbind(0)))
    scalars["skipped_nonfinite"] = 1.0 - finite.float()
    scalars |= grad_scalars
    return state, scalars


def augment_batch(batch: Dict[str, Any], key: Key, mesh: Optional[Mesh] = None
                  ) -> Dict[str, Any]:
    """The batch with its images through the device augmentation, keyed as the JAX
    package's sharded step keys it: fold_in(fold_in(key, 1), rank)."""
    k_aug = fold_in(fold_in(key, 1), axis_index(mesh))
    return dict(batch, image=device_augment(batch["image"], k_aug))


def make_train_step(net: GeoCalibNet, cfg: TrainConfig, augment_on_device: bool = False):
    """step(state, batch, key) -> (state, scalars): train_step on this rank's rows,
    after the device augmentation of the batch's images when augment_on_device (the
    loader's augmentation="device" mode); the JAX package's make_sharded_train_step."""

    def step(state: TrainState, batch: Dict[str, Any], key: Key):
        if augment_on_device:
            batch = augment_batch(batch, key, net.mesh)
        return train_step(net, cfg, state, batch, key)

    return step


def make_eval_step(net: GeoCalibNet, cfg: TrainConfig):
    """eval_step(state, batch, key) -> {"loss/...", "metric/..."} batch means:
    validation (``loss_and_updates(train=False)``) without autograd."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, Any], key: Key) -> Dict[str, Tensor]:
        _, (_, losses, metrics) = loss_and_updates(net, cfg, state.params, state.batch_stats,
                                                   batch, key, train=False)
        out = {f"loss/{k}": v.mean() for k, v in losses.items()}
        out |= {f"metric/{k}": v.mean() for k, v in metrics.items()}
        return out

    return eval_step
