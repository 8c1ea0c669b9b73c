"""High-level calibration API: GeoCalib().calibrate(image).

Port of geocalib_tpu/extractor.py (GeoCalib.calibrate): host preprocessing
to a crop whose sides are multiples of 32, the network in the compute
dtype, the float32 LM solver, then the camera mapped back to the input's
pixels and the fields resized to the input size.

The entry point runs on the card: ``GeoCalib()`` uses ``cuda`` and raises
when there is none. Pass ``device="cpu"`` to run the plain PyTorch versions
of the kernels on the CPU.
"""

from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from geocalib_tpu_torch.geometry.gravity import Gravity
from geocalib_tpu_torch.models.geocalib_net import GeoCalibNet
from geocalib_tpu_torch.models.weights import params_from_jax, read_flax_msgpack
from geocalib_tpu_torch.optim.lm import LMConfig, run_lm
from geocalib_tpu_torch.utils.image import ImagePreprocessor, load_image, resize_image

Tensor = torch.Tensor
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``cuda`` unless told otherwise; raises when the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("GeoCalib runs on a CUDA card and none is available; "
                           "pass device='cpu' to run on the CPU")
    return dev


def load_net(weights: Optional[Union[str, Path, Dict[str, Tensor]]], variant: str,
             device: torch.device, dtype: torch.dtype) -> GeoCalibNet:
    """GeoCalibNet in eval mode on `device` in `dtype`, from a Flax msgpack file of
    the JAX package, a state_dict, or its own random initialization (None)."""
    net = GeoCalibNet(variant)
    if weights is not None:
        if isinstance(weights, (str, Path)):
            weights = params_from_jax(read_flax_msgpack(weights), variant)
        net.load_state_dict(weights)
    return net.eval().to(device=device, dtype=dtype)


class GeoCalib:
    """Single-image calibration: CNN perspective fields + LM refinement.

    weights: a Flax msgpack file of the JAX package, a state_dict, or None
    for the network's own random initialization (seed it with torch.manual_seed).
    optimizer_options: fields of ``LMConfig`` for every request, for example
    ``init_mode="heuristic"``.
    """

    def __init__(self, weights: Optional[Union[str, Path, Dict[str, Tensor]]] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 compute_dtype: str = "bfloat16", variant: str = "b",
                 **optimizer_options: Any):
        self.device = resolve_device(device)
        self.compute_dtype = DTYPES[compute_dtype]
        self.variant = variant
        self.preprocessor = ImagePreprocessor()
        self.optimizer_options = optimizer_options
        self.net = load_net(weights, variant, self.device, self.compute_dtype)

    @torch.inference_mode()
    def calibrate(self, image, camera_model: str = "pinhole",
                  priors: Optional[Dict[str, Any]] = None, batched: bool = False,
                  shared_intrinsics: bool = False) -> Dict[str, Any]:
        """Calibrate one image (H, W, 3) or a same-size batch (B, H, W, 3), RGB in [0, 1].

        camera_model: pinhole | simple_radial | radial | simple_divisional.
        priors: optional {"focal": scalar or (B,) pixels, "gravity": Gravity or (B, 3),
        "k1": scalar or (B,)}. shared_intrinsics: one focal and distortion for the
        whole batch (needs a batch of two or more images). Returns "camera" (input
        pixel space), "gravity", the fields resized to the input size, confidences,
        and the solver's info (costs, stop_at, uncertainties).
        """
        img = torch.as_tensor(np.asarray(image, np.float32))
        if not batched:
            img = img[None]
        B = img.shape[0]
        if shared_intrinsics and B == 1:
            raise ValueError("shared_intrinsics needs a batch of images")
        cfg = LMConfig(camera_model=camera_model, shared_intrinsics=shared_intrinsics,
                       **self.optimizer_options)

        dev = self.device
        pre = self.preprocessor(img.to(dev))
        crop = pre["image"]
        scales = pre["scales"].expand(B, 2)
        crop_pad = pre["crop_pad"].expand(B, 2)

        data: Dict[str, Any] = {}
        priors = priors or {}
        if "focal" in priors:
            f = torch.as_tensor(priors["focal"], dtype=torch.float32, device=dev)
            data["prior_focal"] = torch.broadcast_to(f, (B,)) * scales[:, 1]
        if "gravity" in priors:
            g = priors["gravity"]
            vec = g.vec3d if isinstance(g, Gravity) else torch.as_tensor(g, dtype=torch.float32)
            data["prior_gravity"] = torch.broadcast_to(vec.to(dev), (B, 3))
        if "k1" in priors:
            k1 = torch.broadcast_to(torch.as_tensor(priors["k1"], dtype=torch.float32,
                                                    device=dev), (B,))
            data["prior_dist"] = torch.stack([k1, torch.zeros_like(k1)], dim=-1)

        fields = self.net(crop.to(self.compute_dtype))
        fields = {k: v.float() for k, v in fields.items()}
        res = run_lm({**fields, **data}, cfg)

        camera = res.camera.undo_scale_crop({"scales": scales, "crop_pad": crop_pad})
        H0, W0 = img.shape[1:3]
        out: Dict[str, Any] = {"camera": camera, "gravity": res.gravity}
        for k, v in fields.items():
            vv = v if v.ndim == 4 else v[..., None]
            # antialiased, as jax.image.resize's bilinear default (a downsizing when the
            # input was smaller than the crop)
            out[k] = resize_image(vv, (H0, W0))  # (B, H0, W0, C), confidences too
        out.update(res.info)
        if not batched:
            out = {k: v[0] for k, v in out.items()}
        return out

    def calibrate_path(self, path: Union[str, Path], **kw) -> Dict[str, Any]:
        """Load an image from disk (PIL) and calibrate it."""
        return self.calibrate(load_image(path), **kw)
