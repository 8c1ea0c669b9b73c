"""Device-resident dataset: stage once, sample and augment every batch on the card.

Port of geocalib_tpu/training/device_store.py for one device. The whole split
(uint8 images and the 7-float GT rows) is copied to the card once; each step
then draws its rows with ``jax.random.randint``'s algorithm (utils/threefry.py,
bit for bit), decodes them to float32, augments them on the device
(data/device_augment.py) and synthesizes the GT fields, with no host-to-device
image traffic. Sampling is i.i.d. with replacement, as in the JAX package.

``stage_sharded`` (rows split over a mesh's devices, multi-process) is mesh
work, queued with the distributed port (ROADMAP Queue 1 item 4): on one shard
it is ``stage``, and on more it raises.
"""

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from geocalib_tpu_torch.data.device_augment import DEVICE_AUGMENTATIONS
from geocalib_tpu_torch.extractor import resolve_device
from geocalib_tpu_torch.training.train_step import make_eval_step, train_step
from geocalib_tpu_torch.utils.threefry import Key, fold_in, randint, split

Tensor = torch.Tensor
_MESH = ("DeviceStore: rows sharded over several devices need the distributed port "
         "(parallel/mesh.py, ROADMAP Queue 1 item 4), which is not done")


@dataclasses.dataclass
class DeviceStore:
    """images uint8 (N, H, W, 3) and gt_params (N, 7) float32, rows (w, h, vfov,
    roll, pitch, k1, k2) as SimpleDataset's batches carry them, on one device."""

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
    def stage_sharded(cls, dataset, num_shards: int = 1, row_indices=None, **kw
                      ) -> "DeviceStore":
        """``stage`` on one shard; several shards raise (ROADMAP Queue 1 item 4)."""
        if num_shards != 1:
            raise NotImplementedError(_MESH)
        return cls.stage(dataset, row_indices=row_indices, **kw)


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


def make_staged_train_step(net, cfg, batch_size: int, augment: Any = True):
    """step(state, images, gt_params, key) -> (state, scalars): the batch drawn and
    augmented on the card with the first half of ``split(key)`` folded with the
    device index 0, then ``train_step`` with the second half."""

    def step(state, images: Tensor, gt_params: Tensor, key: Key):
        k_batch, k_step = split(key)
        batch = sample_batch(images, gt_params, fold_in(k_batch, 0), batch_size, augment)
        return train_step(net, cfg, state, batch, k_step)

    return step


def make_staged_eval_step(net, cfg, batch_size: int):
    """eval_window(state, images, gt_params, start, key): validation means over the
    rows start .. start + batch_size - 1 (modulo the store), without augmentation."""
    eval_step = make_eval_step(net, cfg)

    def eval_window(state, images: Tensor, gt_params: Tensor, start: int, key: Key
                    ) -> Dict[str, Tensor]:
        idx = (start + torch.arange(batch_size, device=images.device)) % images.shape[0]
        batch = {"image": images[idx].float() / 255.0, "gt_params": gt_params[idx]}
        return eval_step(state, batch, key)

    return eval_window


def staged_evaluate(eval_window, state, store: DeviceStore, key: Key, batch_size: int,
                    max_batches: int = 10, eval_idx: int = 0) -> Dict[str, float]:
    """Rotating-window validation over the staged rows (train.evaluate's windows)."""
    n = len(store)
    n_batches = max(1, n // batch_size)
    start0 = (eval_idx * max_batches) % n_batches if n_batches > max_batches else 0
    agg: Dict[str, list] = {}
    for i in range(min(max_batches, n_batches)):
        start = ((start0 + i) * batch_size) % max(n - batch_size + 1, 1)
        for k, v in eval_window(state, store.images, store.gt_params, start, key).items():
            agg.setdefault(k, []).append(float(v))
    return {k: float(np.mean(v)) for k, v in agg.items()}
