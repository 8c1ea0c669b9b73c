"""Device-resident dataset: stage once, sample and augment every batch on the card.

Port of geocalib_tpu/training/device_store.py. The whole split (uint8 images
and the 7-float GT rows) is copied to the card once; each step then draws its
rows with ``jax.random.randint``'s algorithm (utils/threefry.py, bit for bit),
decodes them to float32, augments them on the device (data/device_augment.py)
and synthesizes the GT fields, with no host-to-device image traffic. Sampling
is i.i.d. with replacement, as in the JAX package.

Over a data-parallel mesh (parallel/mesh.py; the network's ``net.mesh``),
``stage_sharded`` gives rank r of W the r-th contiguous 1/W of the rows (the
rows the JAX mesh's device r holds), each rank decoding and copying only its
own; the train step samples batch_size / W rows from the rank's slice with the
batch key folded with the rank, and the eval step's scalars are means over the
ranks.
"""

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from geocalib_tpu_torch.data.device_augment import DEVICE_AUGMENTATIONS
from geocalib_tpu_torch.extractor import resolve_device
from geocalib_tpu_torch.parallel.mesh import Mesh, axis_index, axis_size, mean_over_ranks
from geocalib_tpu_torch.training.train_step import make_eval_step, train_step
from geocalib_tpu_torch.utils.threefry import Key, fold_in, randint, split

Tensor = torch.Tensor


@dataclasses.dataclass
class DeviceStore:
    """images uint8 (N, H, W, 3) and gt_params (N, 7) float32, rows (w, h, vfov,
    roll, pitch, k1, k2) as SimpleDataset's batches carry them, on one device (a
    rank's slice of the rows, when staged over a mesh)."""

    images: Tensor
    gt_params: Tensor

    def __len__(self) -> int:
        return int(self.images.shape[0])

    @classmethod
    def stage(cls, dataset, device="cuda", chunk_images: int = 256,
              progress: Optional[Callable[[str], None]] = print,
              row_indices: Optional[Sequence[int]] = None) -> "DeviceStore":
        """Decode the rows on the host (the dataset's ``_load_row``) and copy them
        to `device` in chunks, as uint8 clip(image · 255); every image must have
        the first one's size. row_indices stages a subset."""
        dev = resolve_device(device)
        rows = dataset.rows if row_indices is None else [dataset.rows[int(i)]
                                                         for i in row_indices]
        n = len(rows)
        chunks, params = [], np.zeros((n, 7), np.float32)
        t0 = time.time()
        for start in range(0, n, chunk_images):
            host = []
            for i in range(start, min(start + chunk_images, n)):
                sample = dataset._load_row(rows[i], 0)
                host.append(np.clip(sample["image"].numpy() * 255.0, 0, 255).astype(np.uint8))
                params[i] = sample["gt_params"].numpy()
                if host[-1].shape != (chunks[0].shape[1:] if chunks else host[0].shape):
                    raise ValueError(f"staged datasets must be fixed-size; {rows[i]['fname']} "
                                     f"is {host[-1].shape[:2]}")
            chunks.append(torch.from_numpy(np.stack(host)).to(dev))
            if progress:
                done = min(start + chunk_images, n)
                mb = done * host[0].nbytes / 1e6
                progress(f"staging {done}/{n} images ({mb:.0f} MB, "
                         f"{mb / max(time.time() - t0, 1e-9):.1f} MB/s)")
        images = torch.cat(chunks)
        if progress:
            progress(f"staged {n} images in {time.time() - t0:.0f}s")
        return cls(images=images, gt_params=torch.from_numpy(params).to(dev))

    @classmethod
    def stage_sharded(cls, dataset, mesh: Optional[Mesh] = None,
                      row_indices: Optional[Sequence[int]] = None, device="cuda", **kw
                      ) -> "DeviceStore":
        """This rank's contiguous 1/W of the rows (all of them without a mesh) staged
        on its device (the mesh's, else `device`). A split of fewer than W rows is
        padded cyclically, and the rows are truncated to a multiple of W, as in the
        JAX package."""
        rows_idx = ([int(i) for i in row_indices] if row_indices is not None
                    else list(range(len(dataset.rows))))
        if not rows_idx:
            raise ValueError("empty dataset")
        n_dev = axis_size(mesh)
        if len(rows_idx) < n_dev:
            rows_idx = [rows_idx[i % len(rows_idx)] for i in range(n_dev)]
        per_dev = len(rows_idx) // n_dev
        lo = axis_index(mesh) * per_dev
        return cls.stage(dataset, device=mesh.device if mesh is not None else device,
                         row_indices=rows_idx[lo:lo + per_dev], **kw)


def sample_batch(images: Tensor, gt_params: Tensor, key: Key, batch_size: int,
                 augment: Any = True) -> Dict[str, Tensor]:
    """Draw batch_size rows (``randint`` from the first half of ``split(key)``),
    decode them to [0, 1] and augment them with the preset `augment` (a name of
    DEVICE_AUGMENTATIONS; True and False mean "geocalib" and "identity") keyed
    by the second half."""
    k_idx, k_aug = split(key)
    idx = randint(k_idx, (batch_size,), 0, images.shape[0], images.device)
    img = images[idx].float() / 255.0
    preset = {True: "geocalib", False: "identity"}.get(augment, augment)
    return {"image": DEVICE_AUGMENTATIONS[preset](img, k_aug), "gt_params": gt_params[idx]}


def _local_batch(batch_size: int, mesh: Optional[Mesh]) -> int:
    n_dev = axis_size(mesh)
    if batch_size % n_dev:
        raise ValueError(f"batch_size {batch_size} is not divisible by {n_dev} ranks")
    return batch_size // n_dev


def make_staged_train_step(net, cfg, batch_size: int, augment: Any = True):
    """step(state, images, gt_params, key) -> (state, scalars): this rank's
    batch_size / W rows drawn from its slice and augmented on its device with the
    first half of ``split(key)`` folded with the rank, then ``train_step`` with the
    second half (the mesh is the network's)."""
    local_b = _local_batch(batch_size, net.mesh)

    def step(state, images: Tensor, gt_params: Tensor, key: Key):
        k_batch, k_step = split(key)
        batch = sample_batch(images, gt_params, fold_in(k_batch, axis_index(net.mesh)), local_b,
                             augment)
        return train_step(net, cfg, state, batch, k_step)

    return step


def make_staged_eval_step(net, cfg, batch_size: int):
    """eval_window(state, images, gt_params, start, key): validation means over the
    rows start .. start + batch_size / W - 1 of this rank's slice (modulo the slice),
    without augmentation, then means over the ranks. ``eval_window.local_batch`` is
    batch_size / W."""
    eval_step = make_eval_step(net, cfg)
    mesh, local_b = net.mesh, _local_batch(batch_size, net.mesh)

    def eval_window(state, images: Tensor, gt_params: Tensor, start: int, key: Key
                    ) -> Dict[str, Tensor]:
        idx = (start + torch.arange(local_b, device=images.device)) % images.shape[0]
        batch = {"image": images[idx].float() / 255.0, "gt_params": gt_params[idx]}
        out = eval_step(state, batch, key)
        if mesh is None:
            return out
        return dict(zip(out, mean_over_ranks(torch.stack(list(out.values())), mesh).unbind(0)))

    eval_window.local_batch = local_b
    return eval_window


def staged_evaluate(eval_window, state, store: DeviceStore, key: Key, max_batches: int = 10,
                    eval_idx: int = 0) -> Dict[str, float]:
    """Rotating-window validation over the staged rows (train.evaluate's windows): over
    a mesh each rank walks its own slice, the window's local batch at a time."""
    n = len(store)
    local_b = eval_window.local_batch
    n_batches = max(1, n // local_b)
    start0 = (eval_idx * max_batches) % n_batches if n_batches > max_batches else 0
    agg: Dict[str, list] = {}
    for i in range(min(max_batches, n_batches)):
        start = ((start0 + i) * local_b) % max(n - local_b + 1, 1)
        for k, v in eval_window(state, store.images, store.gt_params, start, key).items():
            agg.setdefault(k, []).append(float(v))
    return {k: float(np.mean(v)) for k, v in agg.items()}
