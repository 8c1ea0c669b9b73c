"""Evaluation pipelines: predict, per-image metrics, summaries, results on disk.

Port of geocalib_tpu/eval/pipeline.py. Per batch, under inference mode: the
network in the compute dtype on the device, the float32 LM solver
(``LMConfig(camera_model=...)``), the metrics on the device, and one copy of
the per-image metrics to the host. Per-image arrays go to results.h5 (with
the image names), the AUC@1/5/10 summaries (min_error=1) to summaries.json,
and with ``cache_fields`` the per-image fields and parameters to
predictions.h5 (read back by ``models/cache_loader.CacheLoader``). h5py is
imported only to write those files.

Every pipeline takes the weights as a msgpack path of the JAX package, a
state_dict or None (random initialization), as ``GeoCalib`` does, and runs
on ``device`` (``cuda`` unless told otherwise; it raises without a card).
``EvalConf`` has no ``fused_heads``: the port's network has one layout, the
two heads as they are, and the JAX package's fused tower computes the same
fields.
"""

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from geocalib_tpu_torch.data.dataset import DatasetConf, SimpleDataset, batch_gt
from geocalib_tpu_torch.eval.metrics import camera_metrics, gravity_metrics
from geocalib_tpu_torch.extractor import DTYPES, load_net, resolve_device
from geocalib_tpu_torch.geometry.camera import Camera
from geocalib_tpu_torch.geometry.gravity import Gravity
from geocalib_tpu_torch.optim.lm import LMConfig, LMResult, run_lm
from geocalib_tpu_torch.utils.tools import summarize_results

Tensor = torch.Tensor
Weights = Optional[Union[str, Path, Dict[str, Tensor]]]


@dataclasses.dataclass
class EvalConf:
    camera_model: str = "pinhole"
    batch_size: int = 8
    thresholds: tuple = (1.0, 5.0, 10.0)
    compute_dtype: str = "bfloat16"
    variant: str = "b"
    # also write each image's fields, confidences and camera/gravity parameters
    # to predictions.h5
    cache_fields: bool = False


def to_host(metrics: Dict[str, Tensor]) -> Dict[str, np.ndarray]:
    """Per-image (B,) float32 metrics to numpy in one device-to-host copy."""
    packed = torch.stack([v.float() for v in metrics.values()]).cpu().numpy()
    return dict(zip(metrics, packed))


class SimplePipeline:
    """Evaluate GeoCalib's network and solver on a SimpleDataset split (its
    images fed as they are, the metrics against each batch's gt_params)."""

    def __init__(self, weights: Weights = None, conf: Optional[EvalConf] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.conf = conf or EvalConf()
        self.device = resolve_device(device)
        self.dtype = DTYPES[self.conf.compute_dtype]
        self.net = load_net(weights, self.conf.variant, self.device, self.dtype)
        self.lm_config = LMConfig(camera_model=self.conf.camera_model)

    def solve(self, image: Tensor) -> Tuple[Dict[str, Tensor], LMResult]:
        """The fields of a batch (B, H, W, 3) in float32, and the LM result."""
        fields = self.net(image.to(self.device, self.dtype))
        fields = {k: v.float() for k, v in fields.items()}
        return fields, run_lm(dict(fields), self.lm_config)

    @torch.inference_mode()
    def predict(self, batch: Dict) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        """Per-image metrics (B,) and, with cache_fields, the cached predictions,
        on the device."""
        fields, res = self.solve(batch["image"])
        gt = {"gt_params": torch.as_tensor(batch["gt_params"], dtype=torch.float32,
                                           device=self.device)}
        cam_gt, grav_gt = batch_gt(gt, self.conf.camera_model)
        out = camera_metrics(res.camera, cam_gt)
        out |= gravity_metrics(res.gravity, grav_gt)
        out |= {k: v for k, v in res.info.items() if v.ndim <= 1}
        cache = {}
        if self.conf.cache_fields:
            cache = {"up_field": fields["up_field"], "latitude_field": fields["latitude_field"],
                     "roll": res.gravity.rp[..., 0], "pitch": res.gravity.rp[..., 1],
                     "vfov": res.camera.vfov}
            cache |= {k: fields[k] for k in ("up_confidence", "latitude_confidence")
                      if k in fields}
        return out, cache

    def batches(self, dataset):
        return dataset.epoch(epoch=0)

    def evaluate(self, dataset, max_batches: Optional[int] = None
                 ) -> Tuple[Dict[str, np.ndarray], List[str], Dict[str, Dict[str, np.ndarray]]]:
        """Per-image metric arrays without the lanes a batch marks invalid, the
        image names (the batch's "names", else image_<index>) and, with
        cache_fields, the predictions by name."""
        results: Dict[str, list] = {}
        names: List[str] = []
        cached: Dict[str, Dict[str, np.ndarray]] = {}
        for i, batch in enumerate(self.batches(dataset)):
            if max_batches is not None and i >= max_batches:
                break
            out, cache = self.predict(batch)
            B = len(batch["image"])
            valid = np.asarray(batch.get("valid", np.ones(B, bool)), bool)
            for k, v in to_host(out).items():
                results.setdefault(k, []).append(v[valid])
            batch_names = batch.get("names", [f"image_{len(names) + j}" for j in range(B)])
            names.extend(n for n, ok in zip(batch_names, valid) if ok)
            if cache:
                cache_np = {k: v.cpu().numpy() for k, v in cache.items()}
                for j, name in enumerate(batch_names):
                    cached[name] = {k: v[j] for k, v in cache_np.items()}
        return {k: np.concatenate(v) for k, v in results.items()}, names, cached

    def run(self, dataset, experiment_dir: Optional[str] = None,
            max_batches: Optional[int] = None) -> Dict[str, float]:
        """The summaries; with experiment_dir also results.h5 (each per-image
        array and the names), summaries.json and, with cache_fields, predictions.h5."""
        results, names, cached = self.evaluate(dataset, max_batches)
        summaries = summarize_results(results, self.conf.thresholds)
        if experiment_dir is not None:
            import h5py

            exp = Path(experiment_dir)
            exp.mkdir(parents=True, exist_ok=True)
            with h5py.File(exp / "results.h5", "w") as fh:
                for k, v in results.items():
                    fh.create_dataset(k, data=v)
                fh.create_dataset("names", data=np.array([str(n).encode("utf-8")
                                                          for n in names]))
            (exp / "summaries.json").write_text(json.dumps(summaries, indent=2))
            if cached:
                from geocalib_tpu_torch.models.cache_loader import export_predictions

                export_predictions(exp / "predictions.h5", cached)
        return summaries


class BenchmarkPipeline(SimplePipeline):
    """Evaluate on a variable-size benchmark (the lamar2k layout), fed by an object
    with BenchmarkDataset's ``batches()``: images preprocessed on the host, the
    network and solver in the crop's pixels, the predicted camera mapped back
    with undo_scale_crop, and every camera metric taken in ORIGINAL pixels
    against the CSV's GT; padded lanes (valid False) are dropped."""

    @torch.inference_mode()
    def predict(self, batch: Dict) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        _, res = self.solve(batch["image"])
        dev = lambda k: torch.as_tensor(batch[k], dtype=torch.float32, device=self.device)
        cam_pred = res.camera.undo_scale_crop({"scales": dev("scales"),
                                               "crop_pad": dev("crop_pad")})
        cam_gt = Camera.from_data(dev("gt_cam"), model=self.conf.camera_model)
        gt_rp = dev("gt_rp")
        grav_gt = Gravity.from_rp(gt_rp[:, 0], gt_rp[:, 1])
        out = camera_metrics(cam_pred, cam_gt)
        out |= gravity_metrics(res.gravity, grav_gt)
        out |= {k: v for k, v in res.info.items() if v.ndim <= 1}
        out |= {"roll_gt": torch.rad2deg(grav_gt.roll), "pitch_gt": torch.rad2deg(grav_gt.pitch),
                "vfov_gt": torch.rad2deg(cam_gt.vfov), "focal_gt": cam_gt.f[..., 1]}
        return out, {}

    def batches(self, dataset):
        return dataset.batches()


def evaluate_real_benchmark(weights: Weights, dataset_dir: str, camera_model: str = "pinhole",
                            experiment_dir: Optional[str] = None, csv_name: str = "images.csv",
                            resize: Optional[int] = 320,
                            device: Optional[Union[str, torch.device]] = None,
                            **conf_kw) -> Dict[str, float]:
    """Evaluate on a downloaded benchmark directory (variable-size images)."""
    from geocalib_tpu_torch.data.benchmark import BenchmarkDataConf, BenchmarkDataset

    conf = EvalConf(camera_model=camera_model, **conf_kw)
    ds = BenchmarkDataset(BenchmarkDataConf(dataset_dir=dataset_dir, csv_name=csv_name,
                                            batch_size=conf.batch_size, resize=resize))
    return BenchmarkPipeline(weights, conf, device).run(ds, experiment_dir)


def evaluate_benchmark(weights: Weights, dataset_dir: str, split: str = "test",
                       camera_model: str = "pinhole", experiment_dir: Optional[str] = None,
                       device: Optional[Union[str, torch.device]] = None,
                       **conf_kw) -> Dict[str, float]:
    """Evaluate on a generated benchmark's split ({split}.csv, fixed-size images)."""
    conf = EvalConf(camera_model=camera_model, **conf_kw)
    ds = SimpleDataset(DatasetConf(dataset_dir=dataset_dir, csv_name=f"{split}.csv",
                                   batch_size=conf.batch_size, shuffle=False,
                                   camera_model=camera_model, return_names=True))
    return SimplePipeline(weights, conf, device).run(ds, experiment_dir)
