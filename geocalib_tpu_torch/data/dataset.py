"""Ground truth of a training batch, port of two functions of
geocalib_tpu/data/dataset.py (:215-250).

A loader batch holds "image" (B, H, W, 3) and "gt_params" (B, 7) rows
(w, h, vfov, roll, pitch, k1, k2), angles in radians. The GT camera, gravity
and perspective fields are made on the batch's device.
"""

from typing import Dict, Tuple

import torch

from geocalib_tpu_torch.geometry.camera import Camera
from geocalib_tpu_torch.geometry.gravity import Gravity
from geocalib_tpu_torch.geometry.perspective_fields import get_perspective_field

Tensor = torch.Tensor


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
