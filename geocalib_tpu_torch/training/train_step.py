"""One training step on one device: the network, the differentiable LM, the
losses, the backward and AdamW.

Port of geocalib_tpu/training/train_step.py for a single device, so with no
collectives: the data-axis index folded into the key is 0, and the
gradient, loss and BatchNorm means over the mesh are the device's own.

- Mixed precision as the JAX step: float32 master parameters, cast to the
  compute dtype for the forward through ``torch.func.functional_call``, so
  that the gradients land on the float32 leaves; BatchNorm keeps float32
  running statistics; the solver, losses and optimizer run in float32.
- The key is split into a DropPath key and an NMF key, as the JAX step
  splits it into its "dropout" and "nmf" streams. The NMF bases match JAX
  bit for bit; DropPath draws its own masks from a generator seeded by its
  key (Flax draws per-module masks, which are not reproduced).
- The optimizer is optax's ``chain(zero_nans(), clip_by_global_norm(clip),
  adamw(schedule, weight_decay))`` written out: NaNs zeroed, then g·clip/‖g‖
  when ‖g‖ ≥ clip, then Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected),
  decoupled weight decay on every leaf, and the scheduled step. Its state is
  (count, mu, nu).
- A non-finite loss keeps the parameters, optimizer state and running
  statistics; non-finite gradient values are zeroed before the optimizer.
"""

import dataclasses
from pathlib import Path
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from geocalib_tpu_torch.data.dataset import synthesize_gt_fields
from geocalib_tpu_torch.extractor import DTYPES, resolve_device
from geocalib_tpu_torch.models.geocalib_net import RUNNING_STATS, GeoCalibNet
from geocalib_tpu_torch.models.weights import params_from_jax, read_flax_msgpack
from geocalib_tpu_torch.optim.lm import LMConfig, run_lm
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
    milestone, in float32 as optax computes it. Count 0 is the first step."""
    init, end, T = cfg.lr * 1e-3, cfg.lr, cfg.warmup_steps
    f32 = lambda v, like: torch.as_tensor(v, dtype=torch.float32, device=like.device)

    def warmup(count: Tensor) -> Tensor:
        frac = 1.0 - torch.clamp(count, 0, T).float() / T
        return f32(init - end, count) * frac + f32(end, count)

    def decays(count: Tensor) -> Tensor:
        v = f32(cfg.lr, count)
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


def global_norm(tree: Tree) -> Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in tree.values()))


def optimizer_update(grads: Tree, state: AdamState, params: Tree, cfg: TrainConfig
                     ) -> Tuple[Tree, AdamState]:
    """optax's chain(zero_nans, clip_by_global_norm, adamw): (updates, new state)."""
    grads = {k: torch.where(torch.isnan(g), torch.zeros_like(g), g) for k, g in grads.items()}
    norm = global_norm(grads)
    keep = norm < cfg.clip_grad
    grads = {k: torch.where(keep, g, g / norm * cfg.clip_grad) for k, g in grads.items()}
    mu = {k: (1 - ADAM_B1) * g + ADAM_B1 * state.mu[k] for k, g in grads.items()}
    nu = {k: (1 - ADAM_B2) * (g * g) + ADAM_B2 * state.nu[k] for k, g in grads.items()}
    count = state.count + 1
    step = count.float()
    bc1 = 1.0 - torch.pow(torch.tensor(ADAM_B1, device=step.device), step)
    bc2 = 1.0 - torch.pow(torch.tensor(ADAM_B2, device=step.device), step)
    lr = make_schedule(cfg)(state.count)
    updates = {}
    for k in grads:
        u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)
        updates[k] = -lr * (u + cfg.weight_decay * params[k])
    return updates, AdamState(count, mu, nu)


@dataclasses.dataclass
class TrainState:
    step: int
    params: Tree       # float32 master parameters, by GeoCalibNet name
    batch_stats: Tree  # BatchNorm running statistics, float32
    opt_state: AdamState


def create_train_state(cfg: TrainConfig, weights: Optional[Union[str, Path, Tree]] = None,
                       seed: int = 0, device: Optional[Union[str, torch.device]] = "cuda"
                       ) -> Tuple[GeoCalibNet, TrainState]:
    """The network in training mode on `device` and its training state.

    weights: a Flax msgpack file of the JAX package, a state_dict, or None for
    torch's own initialization seeded with `seed`. ``device="cuda"`` raises
    when there is no card.
    """
    dev = resolve_device(device)
    torch.manual_seed(seed)
    net = GeoCalibNet(cfg.variant, cfg.drop_path_rate)
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


def loss_and_updates(net: GeoCalibNet, cfg: TrainConfig, params: Tree, batch_stats: Tree,
                     batch: Dict[str, Any], key: Key):
    """The training forward (network and differentiable LM) and the training losses.

    batch: "image" (B, H, W, 3) and either "gt_params" (B, 7) or the GT fields
    with "camera" and "gravity". Returns (mean total loss, (new running
    statistics, losses, metrics)); ``batch_stats`` is left as it is.
    """
    if "up_field" not in batch:
        batch = synthesize_gt_fields(batch, cfg.camera_model)
    d_key, n_key = split(key)
    dtype = DTYPES[cfg.compute_dtype]
    cast = {k: v.to(dtype) if v.dtype == torch.float32 else v for k, v in params.items()}
    image = batch["image"].to(dtype)
    stats = {k: v.clone() for k, v in batch_stats.items()}
    fields, new_stats = torch.func.functional_call(
        net, (cast, stats), (image, n_key), {"generator": _generator(d_key, image.device)})
    fields = {k: v.float() for k, v in fields.items()}
    res = run_lm(dict(fields), cfg.lm_config())
    losses = geocalib_losses(fields, res.camera, res.gravity, batch, batch["camera"],
                             batch["gravity"])
    metrics = geocalib_metrics(fields, res.camera, res.gravity, batch, batch["camera"],
                               batch["gravity"])
    return losses["total"].mean(), (new_stats, losses, metrics)


def compute_grads(net: GeoCalibNet, cfg: TrainConfig, state: TrainState, batch: Dict[str, Any],
                  key: Key):
    """(loss, gradients of the float32 parameters, new statistics, losses, metrics)
    of one step, before any sanitising; the step's key is folded as train_step folds it."""
    key = fold_in(key, 0)  # the data-axis index of the one device
    params = {k: v.detach().requires_grad_() for k, v in state.params.items()}
    loss, (new_stats, losses, metrics) = loss_and_updates(net, cfg, params, state.batch_stats,
                                                          batch, key)
    names = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
    grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(names, grads)}
    return loss.detach(), grads, new_stats, losses, metrics


def train_step(net: GeoCalibNet, cfg: TrainConfig, state: TrainState, batch: Dict[str, Any],
               key: Key) -> Tuple[TrainState, Dict[str, Tensor]]:
    """One step: (new state, scalars). The scalars are the mean of every loss and
    metric, skipped_nonfinite (1 when the loss was not finite and nothing
    moved), grad_nonfinite and grad_norm (after zeroing, before the clip)."""
    loss, grads, new_stats, losses, metrics = compute_grads(net, cfg, state, batch, key)
    grad_finite = torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()
    finite = torch.isfinite(loss)
    grads = {k: torch.where(torch.isfinite(g), g, torch.zeros_like(g)) for k, g in grads.items()}
    updates, new_opt = optimizer_update(grads, state.opt_state, state.params, cfg)
    keep = lambda new, old: {k: torch.where(finite, new[k], old[k]) for k in old}
    new_params = {k: p + updates[k] for k, p in state.params.items()}
    state = TrainState(
        step=state.step + 1,
        params=keep(new_params, state.params),
        batch_stats=keep({k: v.detach() for k, v in new_stats.items()}, state.batch_stats),
        opt_state=AdamState(torch.where(finite, new_opt.count, state.opt_state.count),
                            keep(new_opt.mu, state.opt_state.mu),
                            keep(new_opt.nu, state.opt_state.nu)),
    )
    scalars = {f"loss/{k}": v.detach().mean() for k, v in losses.items()}
    scalars |= {f"metric/{k}": v.detach().mean() for k, v in metrics.items()}
    scalars["skipped_nonfinite"] = 1.0 - finite.float()
    scalars["grad_nonfinite"] = 1.0 - grad_finite.float()
    scalars["grad_norm"] = global_norm(grads)
    return state, scalars
