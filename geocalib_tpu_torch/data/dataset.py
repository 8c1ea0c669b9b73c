"""CSV-driven calibration dataset and the ground truth of its batches.

Port of geocalib_tpu/data/dataset.py: ``SimpleDataset`` reads rows of
(fname, height, width, vfov, roll, pitch[, k1, k2]) and their image files and
yields static-shape batches of "image" (B, H, W, 3) and "gt_params" (B, 7)
rows (w, h, vfov, roll, pitch, k1, k2), angles in radians, as CPU tensors;
the partial tail is dropped and `epoch(shard=k, num_shards=n)` deals rows
round-robin. Each image goes through the conf's host augmentation
(data/augmentations.py) seeded per row and epoch, as in the JAX package, so
the batches are the same bits. ``PrefetchLoader`` yields the same batches from
a thread pool, double-buffered. The GT camera, gravity and perspective fields
are made on the batch's device.
"""

import csv
import dataclasses
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from geocalib_tpu_torch.data.augmentations import get_augmentation
from geocalib_tpu_torch.geometry.camera import Camera
from geocalib_tpu_torch.geometry.gravity import Gravity
from geocalib_tpu_torch.geometry.perspective_fields import get_perspective_field

Tensor = torch.Tensor


@dataclasses.dataclass
class DatasetConf:
    dataset_dir: str = ""
    csv_name: str = "train.csv"  # under {dataset_dir}/
    image_dir: str = "images"
    batch_size: int = 24
    shuffle: bool = True
    augmentation: str = "identity"
    seed: int = 0
    camera_model: str = "pinhole"
    # include the file names in each batch (the eval pipeline keys its results by them)
    return_names: bool = False


class SimpleDataset:
    """Rows of (fname, h, w, vfov, roll, pitch[, k1, k2]) and their image files."""

    def __init__(self, conf: Optional[DatasetConf] = None, **kw):
        self.conf = conf or DatasetConf(**kw)
        get_augmentation(self.conf.augmentation)  # an unknown name raises here
        root = Path(self.conf.dataset_dir)
        self.image_dir = root / self.conf.image_dir
        with open(root / self.conf.csv_name) as fh:
            self.rows = list(csv.DictReader(fh))
        if not self.rows:
            raise ValueError(f"empty dataset {root / self.conf.csv_name}")

    def __len__(self) -> int:
        return len(self.rows)

    def _load_row(self, row: Dict[str, str], aug_seed: int) -> Dict[str, Tensor]:
        """One decoded, augmented row; thread-safe (a fresh augmentation per call)."""
        from geocalib_tpu_torch.utils.image import load_image

        img = load_image(self.image_dir / row["fname"]).numpy()
        if self.conf.augmentation != "identity":
            img = get_augmentation(self.conf.augmentation, aug_seed)(img).astype(np.float32)
        img = torch.from_numpy(img)
        h, w = img.shape[:2]
        params = [float(w), float(h), float(row["vfov"]), float(row["roll"]),
                  float(row["pitch"]), float(row.get("k1", 0.0) or 0.0),
                  float(row.get("k2", 0.0) or 0.0)]
        return {"image": img, "gt_params": torch.tensor(params, dtype=torch.float32)}

    def order(self, epoch: int, shard: int, num_shards: int) -> np.ndarray:
        """The rows of this epoch and shard: a numpy generator seeded with seed +
        epoch shuffles them, then every num_shards-th from shard is taken."""
        order = np.arange(len(self.rows))
        if self.conf.shuffle:
            np.random.default_rng(self.conf.seed + epoch).shuffle(order)
        return order[shard::num_shards]

    def batch(self, idx: Sequence[int], epoch: int, mapper=map) -> Dict:
        """The batch of rows idx in this epoch; `mapper` (map, or a pool's map)
        runs _load_row over them."""
        seeds = [self.conf.seed + epoch * 1_000_003 + int(i) for i in idx]
        rows = [self.rows[i] for i in idx]
        samples = list(mapper(self._load_row, rows, seeds))
        batch = {"image": torch.stack([s["image"] for s in samples]),
                 "gt_params": torch.stack([s["gt_params"] for s in samples])}
        if self.conf.return_names:
            batch["names"] = [r["fname"] for r in rows]
        return batch

    def epoch(self, epoch: int = 0, shard: int = 0, num_shards: int = 1,
              start_batch: int = 0) -> Iterator[Dict]:
        """Static-shape batches of one epoch (the partial tail is dropped);
        start_batch skips batches without decoding them."""
        order = self.order(epoch, shard, num_shards)
        B = self.conf.batch_size
        for start in range(start_batch * B, len(order) - B + 1, B):
            yield self.batch(order[start : start + B], epoch)


class PrefetchLoader:
    """Threaded, double-buffered host input pipeline.

    Decodes and augments the rows of each batch in a thread pool (PIL decoding
    and the numpy/PIL ops release the GIL) and keeps up to ``prefetch``
    assembled batches ready in a queue. Its batches are bit for bit those of
    ``dataset.epoch`` for the same epoch and shard. ``stall_s`` accumulates the
    time the consumer waited for a batch: near 0, the input is not the bound.
    Closing the iterator early stops the producer and joins it.
    """

    def __init__(self, dataset: SimpleDataset, num_workers: int = 8, prefetch: int = 2):
        self.dataset = dataset
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.stall_s = 0.0

    def epoch(self, epoch: int = 0, shard: int = 0, num_shards: int = 1) -> Iterator[Dict]:
        import queue
        import threading
        import time
        from concurrent.futures import ThreadPoolExecutor

        ds = self.dataset
        order = ds.order(epoch, shard, num_shards)
        B = ds.conf.batch_size
        starts = list(range(0, len(order) - B + 1, B))
        if not starts:
            return
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        done = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer(pool):
            try:
                for start in starts:
                    if stop.is_set():
                        return
                    if not put(ds.batch(order[start : start + B], epoch, pool.map)):
                        return
            except Exception as e:  # handed to the consumer, which raises it
                put(e)
            finally:
                put(done)

        with ThreadPoolExecutor(self.num_workers) as pool:
            thread = threading.Thread(target=producer, args=(pool,), daemon=True)
            thread.start()
            try:
                while True:
                    t0 = time.perf_counter()
                    batch = out_q.get()
                    self.stall_s += time.perf_counter() - t0
                    if batch is done:
                        break
                    if isinstance(batch, Exception):
                        raise batch
                    yield batch
            finally:
                stop.set()
                while not out_q.empty():  # unblock a waiting producer
                    out_q.get_nowait()
                thread.join()


def batch_gt(batch: Dict, camera_model: str = "pinhole") -> Tuple[Camera, Gravity]:
    """GT Camera and Gravity from the batch's gt_params rows."""
    p = torch.as_tensor(batch["gt_params"], dtype=torch.float32)
    cam = Camera.from_dict({"width": p[:, 0], "height": p[:, 1], "vfov": p[:, 2],
                            "k1": p[:, 5], "k2": p[:, 6]}, model=camera_model)
    return cam, Gravity.from_rp(p[:, 3], p[:, 4])


def synthesize_gt_fields(batch: Dict, camera_model: str = "pinhole") -> Dict:
    """The full training batch: image, up_field, latitude_field, camera, gravity."""
    cam, grav = batch_gt(batch, camera_model)
    h, w = batch["image"].shape[1:3]
    up, lat = get_perspective_field(cam, grav, h, w)
    return {"image": batch["image"], "up_field": up, "latitude_field": lat,
            "camera": cam, "gravity": grav}
