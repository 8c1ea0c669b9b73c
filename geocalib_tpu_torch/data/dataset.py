"""CSV-driven calibration dataset and the ground truth of its batches.

Port of geocalib_tpu/data/dataset.py: ``SimpleDataset`` reads rows of
(fname, height, width, vfov, roll, pitch[, k1, k2]) and their image files and
yields static-shape batches of "image" (B, H, W, 3) and "gt_params" (B, 7)
rows (w, h, vfov, roll, pitch, k1, k2), angles in radians, as CPU tensors;
the partial tail is dropped and `epoch(shard=k, num_shards=n)` deals rows
round-robin. Only the "identity" augmentation is ported (the augmentations
and the threaded PrefetchLoader come with the training loop). The GT camera,
gravity and perspective fields are made on the batch's device.
"""

import csv
import dataclasses
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

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
        if self.conf.augmentation != "identity":
            raise ValueError(f"augmentation {self.conf.augmentation!r} is not ported; only "
                             "'identity' is (the augmentations come with the training loop)")
        root = Path(self.conf.dataset_dir)
        self.image_dir = root / self.conf.image_dir
        with open(root / self.conf.csv_name) as fh:
            self.rows = list(csv.DictReader(fh))
        if not self.rows:
            raise ValueError(f"empty dataset {root / self.conf.csv_name}")

    def __len__(self) -> int:
        return len(self.rows)

    def _load_row(self, row: Dict[str, str]) -> Dict[str, Tensor]:
        from geocalib_tpu_torch.utils.image import load_image

        img = load_image(self.image_dir / row["fname"])
        h, w = img.shape[:2]
        params = [float(w), float(h), float(row["vfov"]), float(row["roll"]),
                  float(row["pitch"]), float(row.get("k1", 0.0) or 0.0),
                  float(row.get("k2", 0.0) or 0.0)]
        return {"image": img, "gt_params": torch.tensor(params, dtype=torch.float32)}

    def epoch(self, epoch: int = 0, shard: int = 0, num_shards: int = 1,
              start_batch: int = 0) -> Iterator[Dict]:
        """Static-shape batches of one epoch (the partial tail is dropped), in the
        order of a numpy generator seeded with seed + epoch; start_batch skips
        batches without decoding them."""
        conf = self.conf
        order = np.arange(len(self.rows))
        if conf.shuffle:
            np.random.default_rng(conf.seed + epoch).shuffle(order)
        order = order[shard::num_shards]

        B = conf.batch_size
        for start in range(start_batch * B, len(order) - B + 1, B):
            idx = order[start : start + B]
            samples = [self._load_row(self.rows[i]) for i in idx]
            batch = {"image": torch.stack([s["image"] for s in samples]),
                     "gt_params": torch.stack([s["gt_params"] for s in samples])}
            if conf.return_names:
                batch["names"] = [self.rows[i]["fname"] for i in idx]
            yield batch


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
