"""Offline dataset generation: panoramas → perspective crops and CSV splits.

Port of geocalib_tpu/data/generate.py. For each panorama, ``crops_per_pano``
views with random roll, pitch, vFoV and yaw (and k1 for distorted training
data) are sampled in numpy float32, all of them are rendered in one batched
``render_from_pano`` call on the device, and the crops are written as JPEGs
beside one CSV per split. The sampling is the JAX package's, so both
packages write the same CSV text for the same arguments.

The per-pano work is two functions: ``render_pano`` samples the rows and
renders the crops (rows as dicts, crops as a tensor on the device), and
``write_crops`` writes the JPEGs (PIL, inside ``utils/image.write_image``).
Without ``--pano_dir``, procedural panoramas (``data/pano.synthetic_pano``)
are used, so the whole pipeline runs without any download.

The render runs on the card unless the caller passes ``device="cpu"``. With
``workers > 1`` on the card, spawned workers synthesise the panoramas (numpy
only, no CUDA in the children) and the parent renders them in order; on the
CPU the workers also render and write, as the JAX package's do. The rows are
sorted by file name, so the CSV does not depend on the pool's order.

CLI:
    python -m geocalib_tpu_torch.data.generate --out_dir data/openpano_synth [--device cpu]
"""

import argparse
import csv
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from geocalib_tpu_torch.data.pano import render_from_pano, synthetic_pano
from geocalib_tpu_torch.geometry.camera import Camera
from geocalib_tpu_torch.geometry.gravity import Gravity
from geocalib_tpu_torch.utils.image import load_image, write_image

DEFAULTS = dict(
    # sampling ranges, as GeoCalib's OpenPano dataset configuration
    roll_range=(-45.0, 45.0),  # degrees
    pitch_range=(-45.0, 45.0),
    vfov_range=(20.0, 105.0),
    height=640,
    width=640,
    crops_per_pano=16,
)


def max_radius(a: float, b: float) -> float:
    """Largest valid normalized radius for the distortion a r + b r³ (monotonicity)."""
    discrim = a * a - 4 * b
    if b > 0:
        return float("inf") if discrim < 0 else np.sqrt((-a - np.sqrt(discrim)) / (2 * b))
    if b < 0:
        return np.sqrt((-a + np.sqrt(discrim)) / (2 * b)) if discrim >= 0 else float("inf")
    return float("inf") if a >= 0 else np.sqrt(-1.0 / (3.0 * a))


def brown_max_radius(k1: float, k2: float = 0.0) -> float:
    """Largest radius at which the Brown model stays monotonic."""
    return max_radius(3 * k1, 5 * k2)


def sample_k1(rng: np.random.Generator, vfov: float, h: float, w: float) -> float:
    """Sample k1_hat from a clipped normal and keep the k1 it gives only where the
    model stays monotonic out to the image corner (32 tries, then 0)."""
    for _ in range(32):
        k1_hat = rng.normal(-0.3, 0.3)
        k1_hat = float(np.clip(k1_hat, -0.8, 0.2))
        f = h / 2.0 / np.tan(vfov / 2.0)
        k1 = k1_hat * (f / h) ** 2
        # image corner radius in normalized coords
        rmax_img = np.sqrt((w / 2) ** 2 + (h / 2) ** 2) / f
        if brown_max_radius(k1) > rmax_img:
            return k1
    return 0.0


def _stable_seed(*parts) -> int:
    """Deterministic per-pano seed (Python's hash() is salted per process,
    which would make splits irreproducible and differ across pool workers)."""
    return zlib.crc32("|".join(str(p) for p in parts).encode()) % 2**31


def load_pano(task: Dict) -> Tuple[str, np.ndarray]:
    """The task's panorama: (name, (Hp, Wp, 3) float32 array), read from its file or
    synthesised from its (name, seed) pair. numpy only."""
    src = task["pano"]
    if isinstance(src, (str, Path)):
        return Path(src).stem, load_image(src).numpy()
    name, pano_seed = src
    conf = task["conf"]
    return name, synthetic_pano(seed=pano_seed, height=conf["pano_height"],
                                width=conf["pano_width"])


def sample_rows(name: str, task: Dict) -> Tuple[List[Dict], np.ndarray]:
    """The CSV rows of one panorama's crops and their yaws (radians), drawn in
    numpy float32 from the pano's stable seed."""
    split, conf, camera_model = task["split"], task["conf"], task["camera_model"]
    n = conf["crops_per_pano"]
    h, w = conf["height"], conf["width"]
    rng = np.random.default_rng(_stable_seed(name, split, task["seed"]))

    roll = np.radians(rng.uniform(*conf["roll_range"], n)).astype(np.float32)
    pitch = np.radians(rng.uniform(*conf["pitch_range"], n)).astype(np.float32)
    vfov = np.radians(rng.uniform(*conf["vfov_range"], n)).astype(np.float32)
    yaw = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    if camera_model == "pinhole":
        k1 = np.zeros(n, np.float32)
    else:
        k1 = np.array([sample_k1(rng, float(v), h, w) for v in vfov], np.float32)
    rows = [{"fname": f"{name}_{split}_{i:02d}.jpg", "height": h, "width": w,
             "vfov": float(vfov[i]), "roll": float(roll[i]), "pitch": float(pitch[i]),
             "k1": float(k1[i]), "k2": 0.0} for i in range(n)]
    return rows, yaw


def row_views(rows: Sequence[Dict], yaw: np.ndarray, camera_model: str, device
              ) -> Tuple[Camera, Gravity, torch.Tensor]:
    """The rows' cameras, gravities and yaws as tensors on `device`."""
    dev = torch.device(device)
    col = lambda key: torch.tensor([r[key] for r in rows], dtype=torch.float32, device=dev)
    cam = Camera.from_dict({"height": col("height"), "width": col("width"),
                            "vfov": col("vfov"), "k1": col("k1")}, model=camera_model)
    return cam, Gravity.from_rp(col("roll"), col("pitch")), torch.from_numpy(yaw).to(dev)


def render_pano(task: Dict, name: str, pano, device="cpu") -> Tuple[List[Dict], torch.Tensor]:
    """Sample one panorama's rows and render its crops on `device`: (rows, crops
    (n, h, w, 3) float32 on `device`)."""
    rows, yaw = sample_rows(name, task)
    cam, grav, yaw_t = row_views(rows, yaw, task["camera_model"], device)
    pano = torch.as_tensor(pano, dtype=torch.float32).to(cam.f.device)
    return rows, render_from_pano(pano, cam, grav, yaw_t)


def write_crops(rows: Sequence[Dict], crops: torch.Tensor, img_dir) -> None:
    """Write each crop as the JPEG its row names."""
    crops = crops.cpu().numpy()
    for row, crop in zip(rows, crops):
        write_image(crop, Path(img_dir) / row["fname"])


def _render_one_pano(task: Dict) -> List[Dict]:
    """Load, render and write one panorama; returns its rows. Module-level so that a
    spawn pool can pickle it."""
    name, pano = load_pano(task)
    rows, crops = render_pano(task, name, pano, task["device"])
    write_crops(rows, crops, task["img_dir"])
    return rows


def generate_split(out_dir: Path, split: str, pano_paths: Sequence, conf: Dict,
                   camera_model: str = "pinhole", seed: int = 0, workers: int = 0,
                   device=None) -> None:
    """Render every pano of a split and write its CSV (optionally with a process pool)."""
    from geocalib_tpu_torch.extractor import resolve_device

    dev = resolve_device(device)
    img_dir = out_dir / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    tasks = [dict(pano=p, split=split, conf=conf, camera_model=camera_model, seed=seed,
                  img_dir=str(img_dir), device=str(dev)) for p in pano_paths]
    rows: list = []

    def progress(done: int) -> None:
        if done % 50 == 0:
            print(f"  [{split}] {done}/{len(tasks)} panos", flush=True)

    if workers > 1 and len(tasks) > 1:
        import multiprocessing as mp

        # spawn: a forked child would inherit the parent's torch (and CUDA) state
        ctx = mp.get_context("spawn")
        with ctx.Pool(workers) as pool:
            if dev.type == "cpu":
                for done, r in enumerate(pool.imap_unordered(_render_one_pano, tasks,
                                                             chunksize=2), 1):
                    rows.extend(r)
                    progress(done)
            else:
                for done, (task, (name, pano)) in enumerate(
                        zip(tasks, pool.imap(load_pano, tasks, chunksize=2)), 1):
                    r, crops = render_pano(task, name, pano, dev)
                    write_crops(r, crops, img_dir)
                    rows.extend(r)
                    progress(done)
    else:
        for t in tasks:
            rows.extend(_render_one_pano(t))
    rows.sort(key=lambda r: r["fname"])  # pool order is nondeterministic

    with open(out_dir / f"{split}.csv", "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)


def pano_sources(pano_dir: Optional[str], n_panos: int, seed: int) -> list:
    """The panoramas of a dataset: image files of pano_dir, sorted, or (name,
    pano_seed) pairs of procedural panoramas."""
    if pano_dir is not None:
        return sorted(p for p in Path(pano_dir).iterdir()
                      if p.suffix.lower() in (".jpg", ".png", ".jpeg"))
    return [(f"synth{i:04d}", seed * 10_007 + i) for i in range(n_panos)]


def dataset_conf(**overrides) -> Dict:
    """DEFAULTS with the overrides; the pano resolution scales with the crop size
    (tiny test datasets get cheap panos, full 320² datasets 768×1536)."""
    conf = {**DEFAULTS, **overrides}
    conf.setdefault("pano_height", max(256, min(768, 2 * int(conf["height"]))))
    conf.setdefault("pano_width", 2 * conf["pano_height"])
    return conf


def generate_dataset(out_dir: str, pano_dir: Optional[str] = None, n_panos: int = 16,
                     camera_model: str = "pinhole", seed: int = 0,
                     splits=(("train", 0.8), ("val", 0.1), ("test", 0.1)), workers: int = 0,
                     device=None, **overrides) -> Path:
    """Generate a full dataset; returns the output directory."""
    conf = dataset_conf(**overrides)
    out = Path(out_dir)
    panos = pano_sources(pano_dir, n_panos, seed)

    # allocate panos to splits: at least one each, never past the end
    counts = [max(1, int(round(len(panos) * frac))) for _, frac in splits]
    while sum(counts) > len(panos):
        counts[int(np.argmax(counts))] -= 1
    start = 0
    for (split, _), count in zip(splits, counts):
        assert count >= 1, f"not enough panos for split {split!r} ({len(panos)} total)"
        generate_split(out, split, panos[start: start + count], conf, camera_model, seed,
                       workers=workers, device=device)
        start += count
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--pano_dir", default=None)
    ap.add_argument("--n_panos", type=int, default=16)
    ap.add_argument("--camera_model", default="pinhole")
    ap.add_argument("--height", type=int, default=DEFAULTS["height"])
    ap.add_argument("--width", type=int, default=DEFAULTS["width"])
    ap.add_argument("--crops_per_pano", type=int, default=DEFAULTS["crops_per_pano"])
    ap.add_argument("--pano_size", type=int, default=None,
                    help="equirect pano height (width = 2x); default adapts to crop size")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=0,
                    help="process-pool size for per-pano synthesis (and rendering on the CPU)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    extra = {}
    if args.pano_size:
        extra = dict(pano_height=args.pano_size, pano_width=2 * args.pano_size)
    out = generate_dataset(args.out_dir, pano_dir=args.pano_dir, n_panos=args.n_panos,
                           camera_model=args.camera_model, height=args.height,
                           width=args.width, crops_per_pano=args.crops_per_pano, seed=args.seed,
                           workers=args.workers, device=args.device, **extra)
    print(f"dataset written to {out}")


if __name__ == "__main__":
    main()
