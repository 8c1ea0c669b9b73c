"""Variable-size benchmark dataset: preprocessing and shape-bucketed batches.

Port of geocalib_tpu/data/benchmark.py. A benchmark directory holds
``images/`` and a CSV of GT rows (fname, height, width, vfov, roll, pitch in
radians; optional px, py, k1, k2). Every image is preprocessed on the host,
on CPU tensors (resize the short side to 320, center-crop to a multiple of
32), rows are bucketed by their processed (h, w), and each bucket yields
static-shape batches whose tail is padded by repeating its last row, with a
``valid`` mask that drops the padded lanes from the metrics. GT cameras stay
in ORIGINAL pixel space; the eval pipeline maps predictions back with
``undo_scale_crop``.
"""

import csv
import dataclasses
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from geocalib_tpu_torch.utils.conversions import fov2focal
from geocalib_tpu_torch.utils.image import ImagePreprocessor, PreprocessorConf, load_image

Tensor = torch.Tensor


@dataclasses.dataclass
class BenchmarkDataConf:
    dataset_dir: str = ""
    csv_name: str = "images.csv"
    image_dir: str = "images"
    batch_size: int = 8
    resize: Optional[int] = 320
    edge_divisible_by: int = 32


def _row_float(row: Dict[str, str], key: str, default: float) -> float:
    val = row.get(key, "")
    return float(val) if val not in ("", None) else default


def parse_gt_row(row: Dict[str, str]) -> Tuple[Tensor, Tensor]:
    """A CSV row → the packed original-space camera (8,) [w, h, fx, fy, cx, cy,
    k1, k2] and (roll, pitch) (2,); f = fov2focal(vfov, h) in float32, the
    principal point defaults to the image center."""
    h = float(row["height"])
    w = float(row["width"])
    f = float(fov2focal(torch.tensor(float(row["vfov"]), dtype=torch.float32), h))
    px = _row_float(row, "px", w / 2.0)
    py = _row_float(row, "py", h / 2.0)
    k1 = _row_float(row, "k1", 0.0)
    k2 = _row_float(row, "k2", 0.0)
    cam = torch.tensor([w, h, f, f, px, py, k1, k2], dtype=torch.float32)
    rp = torch.tensor([float(row["roll"]), float(row["pitch"])], dtype=torch.float32)
    return cam, rp


class BenchmarkDataset:
    """Shape-bucketed iterator over a variable-size benchmark directory."""

    def __init__(self, conf: Optional[BenchmarkDataConf] = None, **kw):
        self.conf = conf or BenchmarkDataConf(**kw)
        root = Path(self.conf.dataset_dir)
        self.image_dir = root / self.conf.image_dir
        with open(root / self.conf.csv_name) as fh:
            self.rows = list(csv.DictReader(fh))
        if not self.rows:
            raise ValueError(f"empty benchmark {root / self.conf.csv_name}")
        self.preprocessor = ImagePreprocessor(PreprocessorConf(
            resize=self.conf.resize, edge_divisible_by=self.conf.edge_divisible_by))

    def __len__(self) -> int:
        return len(self.rows)

    def _processed_shape(self, h: int, w: int) -> Tuple[int, int]:
        """(h, w) after preprocessing, without decoding the image."""
        th, tw = self.preprocessor.target_size(h, w)
        d = self.conf.edge_divisible_by
        if d:
            th, tw = (th // d) * d, (tw // d) * d
        return th, tw

    def _buckets(self) -> Dict[Tuple[int, int], List[int]]:
        buckets: Dict[Tuple[int, int], List[int]] = {}
        for i, row in enumerate(self.rows):
            try:
                h, w = int(float(row["height"])), int(float(row["width"]))
            except (KeyError, ValueError):
                # no or invalid size columns: read the image header only
                from PIL import Image

                with Image.open(self.image_dir / row["fname"]) as im:
                    w, h = im.size
            buckets.setdefault(self._processed_shape(h, w), []).append(i)
        return buckets

    def _load(self, idx: int) -> Dict:
        row = self.rows[idx]
        data = self.preprocessor(load_image(self.image_dir / row["fname"]))
        cam, rp = parse_gt_row(row)
        return {"image": data["image"], "scales": data["scales"], "crop_pad": data["crop_pad"],
                "gt_cam": cam, "gt_rp": rp, "name": row["fname"]}

    def batches(self) -> Iterator[Dict]:
        """Static-shape batches, bucket by bucket in sorted shape order: image,
        scales, crop_pad, gt_cam and gt_rp as CPU tensors, valid (B,) a numpy
        bool mask, names a list."""
        B = self.conf.batch_size
        buckets = self._buckets()
        for shape in sorted(buckets):
            idxs = buckets[shape]
            for start in range(0, len(idxs), B):
                chunk = idxs[start : start + B]
                valid = np.zeros((B,), bool)
                valid[: len(chunk)] = True
                samples = [self._load(i) for i in chunk + [chunk[-1]] * (B - len(chunk))]
                img = torch.stack([s["image"] for s in samples])
                if tuple(img.shape[1:3]) != shape:
                    raise ValueError(f"decoded shape {tuple(img.shape[1:3])} != bucket {shape}: "
                                     "the CSV's height/width disagree with the image files")
                batch = {k: torch.stack([s[k] for s in samples])
                         for k in ("scales", "crop_pad", "gt_cam", "gt_rp")}
                yield {"image": img, **batch, "valid": valid,
                       "names": [s["name"] for s in samples]}
