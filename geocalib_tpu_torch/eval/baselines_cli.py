"""Evaluate the baselines on a generated benchmark split.

Port of geocalib_tpu/eval/baselines_cli.py: the same summary dict (mean /
median errors + AUC@1/5/10) as the learned pipeline, from the port's metrics
(eval/metrics.py) and summaries (utils/tools.py).

Methods:
    uvp        native line-based VP calibration (models/uvp.py, numpy and
               OpenCV on the host)
    trivial    roll = pitch = 0, f = 0.7 * max(h, w)
    deepcalib  the bin classifier trained by training/train_deepcalib.py, from
               its Flax msgpack (read with the port's reader); rho decoded to
               pitch through rho2pitch. The image is rounded to bf16 and the
               network runs in float32, as in the JAX package.

The predictions run on `device` (the card by default; uvp runs on the host
and puts its estimate there); the metrics are taken on the host.

CLI:
    python -m geocalib_tpu_torch.eval.baselines_cli openpano_synth --method uvp [--device cpu]
"""

import argparse
import json
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from geocalib_tpu_torch.data.dataset import DatasetConf, SimpleDataset, batch_gt
from geocalib_tpu_torch.eval.metrics import camera_metrics, gravity_metrics
from geocalib_tpu_torch.extractor import resolve_device
from geocalib_tpu_torch.geometry.camera import Camera
from geocalib_tpu_torch.geometry.gravity import Gravity
from geocalib_tpu_torch.models.deepcalib import DeepCalib
from geocalib_tpu_torch.models.weights import deepcalib_params_from_jax, read_flax_msgpack
from geocalib_tpu_torch.utils.conversions import fov2focal, rho2pitch
from geocalib_tpu_torch.utils.tools import summarize_results

EVAL_PATH = Path("outputs/results")
Predictor = Callable[[np.ndarray], Tuple[Camera, Gravity]]


def load_deepcalib(weights: Union[str, Path], device=None) -> DeepCalib:
    """DeepCalib in evaluation mode on `device` from a msgpack of the trainer's export
    ({"params", "batch_stats", "conf"}); a block_config stored as {"0": 4, ...} (how
    Flax writes a list) is read back as a list."""
    payload = read_flax_msgpack(weights)
    net_conf = payload.get("conf", {})
    bc = net_conf.get("block_config", (4, 8, 12, 8))
    if isinstance(bc, dict):
        bc = [bc[k] for k in sorted(bc, key=int)]
    bc = tuple(int(x) for x in bc)
    net = DeepCalib(num_bins=int(net_conf.get("num_bins", 256)), block_config=bc,
                    growth_rate=int(net_conf.get("growth_rate", 32)))
    net.load_state_dict(deepcalib_params_from_jax(payload, bc))
    return net.eval().to(resolve_device(device))


def deepcalib_outputs(net: DeepCalib, images) -> Dict[str, torch.Tensor]:
    """The network's float32 outputs (logits and decoded values) on (B, H, W, 3) images
    in [0, 1], rounded to bf16 on the network's device first."""
    dev = next(net.parameters()).device
    with torch.no_grad():
        out = net(torch.as_tensor(np.asarray(images)).to(dev).to(torch.bfloat16))
    return {k: v.float() for k, v in out.items()}


def _full(B: int, v: float, device) -> torch.Tensor:
    return torch.full((B,), float(v), dtype=torch.float32, device=device)


def make_predictor(method: str, weights: Optional[str] = None, device=None) -> Predictor:
    """predict(images (B, H, W, 3) numpy) -> (Camera, Gravity) on the device, by method."""
    dev = resolve_device(device)
    if method == "uvp":
        from geocalib_tpu_torch.models.uvp import NativeUVP

        solver, prior = NativeUVP(), np.array([0.0, 1.0, 0.0])

        def predict(images):
            h, w = images.shape[1:3]
            fs, gs = zip(*(solver.estimate(im, prior) for im in images))
            cam = Camera.from_dict({"height": _full(len(fs), h, dev),
                                    "width": _full(len(fs), w, dev),
                                    "f": torch.tensor(fs, dtype=torch.float32, device=dev)})
            grav = Gravity.from_vec3d(torch.tensor(np.stack(gs), dtype=torch.float32, device=dev))
            return cam, grav

    elif method == "deepcalib":
        if not weights:
            raise ValueError("the deepcalib baseline needs a trained weights path")
        net = load_deepcalib(weights, dev)

        def predict(images):
            B, h, w = images.shape[:3]
            out = deepcalib_outputs(net, images)
            f = fov2focal(out["vfov"], float(h))
            pitch = rho2pitch(out["rho"], f, float(h))
            cam = Camera.from_dict({"height": _full(B, h, dev), "width": _full(B, w, dev),
                                    "vfov": out["vfov"]})
            return cam, Gravity.from_rp(out["roll"], pitch)

    elif method == "trivial":

        def predict(images):
            B, h, w = images.shape[:3]
            cam = Camera.from_dict({"height": _full(B, h, dev), "width": _full(B, w, dev),
                                    "f": _full(B, 0.7 * max(h, w), dev)})
            return cam, Gravity.from_rp(_full(B, 0.0, dev), _full(B, 0.0, dev))

    else:
        raise ValueError(f"unknown baseline method {method!r}")
    return predict


def _cpu(cam: Camera, grav: Gravity) -> Tuple[Camera, Gravity]:
    return (Camera(cam.size.cpu(), cam.f.cpu(), cam.c.cpu(), cam.k.cpu(), cam.model),
            Gravity(grav.vec3d.cpu()))


def evaluate_baseline(method: str, dataset_dir: str, split: str = "test",
                      camera_model: str = "pinhole", experiment_dir: Optional[str] = None,
                      max_images: Optional[int] = None, weights: Optional[str] = None,
                      device=None) -> Dict[str, float]:
    """The summary of `method` over the split's batches of 8 (all rows in one batch when
    the split has fewer), as the JAX package's evaluate_baseline."""
    ds = SimpleDataset(DatasetConf(dataset_dir=dataset_dir, csv_name=f"{split}.csv",
                                   batch_size=8, shuffle=False, augmentation="identity",
                                   camera_model=camera_model))
    if len(ds.rows) < ds.conf.batch_size:  # tiny test splits: don't drop all rows
        ds.conf.batch_size = max(1, len(ds.rows))
    predict = make_predictor(method, weights, device)

    results: Dict[str, list] = {}
    seen = 0
    for batch in ds.epoch(epoch=0):
        if max_images is not None and seen >= max_images:
            break
        images = np.asarray(batch["image"])
        seen += len(images)
        cam_pred, grav_pred = _cpu(*predict(images))
        cam_gt, grav_gt = batch_gt(batch, camera_model)
        out = camera_metrics(cam_pred, cam_gt)
        out |= gravity_metrics(grav_pred, grav_gt)
        for k, v in out.items():
            results.setdefault(k, []).append(v.numpy())

    summaries = summarize_results({k: np.concatenate(v) for k, v in results.items()})
    summaries["n_images"] = seen
    summaries["method"] = method

    if experiment_dir is not None:
        exp = Path(experiment_dir)
        exp.mkdir(parents=True, exist_ok=True)
        (exp / "summaries.json").write_text(json.dumps(summaries, indent=2))
    return summaries


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("benchmark", help="benchmark name (eval/benchmarks.py) or a dataset dir")
    ap.add_argument("--method", default="uvp", choices=["uvp", "trivial", "deepcalib"])
    ap.add_argument("--weights", default=None, help="deepcalib weights .msgpack")
    ap.add_argument("--split", default="test")
    ap.add_argument("--camera_model", default="pinhole")
    ap.add_argument("--max_images", type=int, default=None)
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if Path(args.benchmark).is_dir():
        target, name = Path(args.benchmark), Path(args.benchmark).name
    else:
        from geocalib_tpu_torch.eval.benchmarks import prepare_benchmark

        target, name = prepare_benchmark(args.benchmark, device=args.device), args.benchmark

    out_dir = Path(args.output) if args.output else EVAL_PATH / f"{name}_{args.method}"
    summary = evaluate_baseline(args.method, str(target), split=args.split,
                                camera_model=args.camera_model, experiment_dir=str(out_dir),
                                max_images=args.max_images, weights=args.weights,
                                device=args.device)
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
