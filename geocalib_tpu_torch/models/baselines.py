"""Third-party baseline wrappers: VP-from-prior and DUSt3R focal estimation.

Port of geocalib_tpu/models/baselines.py. Both baselines wrap external
native libraries that are not part of the core framework
(VP-Estimation-with-Prior-Gravity's hybrid line solvers; the DUSt3R
transformer), import-gated: constructing a wrapper raises ImportError naming
the package when it is absent, and the rest of the port never imports this
module implicitly.

Both adapt the external estimate into the port's output convention:
{"camera": Camera, "gravity": Gravity} of tensors in the scaled pixel space.
"""

from typing import Any, Dict, Optional

import numpy as np

__all__ = ["VPEstimator", "Dust3R"]


class VPEstimator:
    """Vanishing-point calibration with a gravity prior (UVP baseline).

    Wraps the external `vp_estimation_with_prior_gravity` package (line
    detection + hybrid minimal solvers). Reference:
    siclib/models/optimization/vp_from_prior.py:1-182.
    """

    def __init__(self, line_type: str = "deeplsd", magsac_scoring: bool = True):
        try:
            import vp_estimation_with_prior_gravity  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "VPEstimator needs the external VP-Estimation-with-Prior-Gravity "
                "package (https://github.com/cvg/VP-Estimation-with-Prior-Gravity); "
                "it is a comparison baseline, not part of the core framework"
            ) from e
        self.line_type = line_type
        self.magsac_scoring = magsac_scoring

    def __call__(self, data: Dict[str, Any]) -> Dict[str, Any]:
        from vp_estimation_with_prior_gravity.evaluation import project_vp_to_image, get_labels_from_vp  # noqa: F401,E501
        from vp_estimation_with_prior_gravity.solvers import run_hybrid_uncalibrated

        from geocalib_tpu_torch.geometry.camera import Camera
        from geocalib_tpu_torch.geometry.gravity import Gravity

        image = np.asarray(data["image"])
        if image.ndim == 4:
            raise ValueError("VPEstimator runs one image at a time (like the reference)")
        h, w = image.shape[:2]
        gray = (image.mean(-1) * 255).astype(np.uint8)
        lines = self._detect_lines(gray)
        prior = np.asarray(data.get("prior_gravity", [0.0, 1.0, 0.0]), np.float64)
        f, vp = run_hybrid_uncalibrated(
            lines - np.array([w / 2, h / 2]), vertical=prior, th_pixels=3.0
        )
        vfov = 2.0 * np.arctan2(h / 2.0, f)
        cam = Camera.from_dict({"height": float(h), "width": float(w), "vfov": float(vfov)})
        # reference convention (vp_from_prior.py:134,150-155): flip the solver's
        # vp y, pick the vp best aligned with the vertical prior, then
        # ANTI-align it (gravity points down: Gravity.from_rp(0,0) = (0,-1,0)).
        vp = np.asarray(vp, np.float64)
        vp[:, 1] *= -1
        norms = np.linalg.norm(vp, axis=-1)
        cossim = (vp @ prior) / np.maximum(norms, 1e-12)
        vvp = vp[np.argmax(np.abs(cossim))]
        vvp = -vvp * np.sign(np.dot(prior, vvp))
        g = vvp / np.linalg.norm(vvp)
        return {"camera": cam, "gravity": Gravity.from_vec3d(np.asarray(g, np.float32))}

    def _detect_lines(self, gray: np.ndarray) -> np.ndarray:
        if self.line_type == "lsd":
            try:
                import pytlsd

                return pytlsd.lsd(gray.astype(np.float64))[:, :4].reshape(-1, 2, 2)
            except ImportError:
                # OpenCV's built-in LSD (same von-Gioi algorithm family as
                # pytlsd); cv2 is already a reference dependency
                import cv2

                lines = cv2.createLineSegmentDetector().detect(gray)[0]
                if lines is None:
                    return np.zeros((0, 2, 2), np.float64)
                # (N, 4) in cv2>=5, (N, 1, 4) in cv2 4.x
                return lines.reshape(-1, 4).astype(np.float64).reshape(-1, 2, 2)
        from deeplsd.models.deeplsd_inference import DeepLSD  # noqa: F401

        raise NotImplementedError(
            "deeplsd line detection requires its released checkpoint; use line_type='lsd'"
        )


class Dust3R:
    """DUSt3R focal-length baseline (transformer 3D reconstruction).

    Wraps the external `dust3r` package; reference:
    siclib/models/networks/dust3r.py:1-81 (focal from the predicted
    pointmap's depth/principal-ray geometry).
    """

    def __init__(self, checkpoint: Optional[str] = None):
        try:
            import dust3r  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "Dust3R baseline needs the external dust3r package "
                "(https://github.com/naver/dust3r); it is a comparison baseline, "
                "not part of the core framework"
            ) from e
        self.checkpoint = checkpoint

    def __call__(self, data: Dict[str, Any]) -> Dict[str, Any]:
        from dust3r.inference import inference, load_model
        from dust3r.utils.image import load_images

        from geocalib_tpu_torch.geometry.camera import Camera

        model = load_model(self.checkpoint, "cpu")
        imgs = load_images([data["path"], data["path"]], size=512)
        out = inference([tuple(imgs)], model, "cpu", batch_size=1)
        pts = np.asarray(out["pred1"]["pts3d"][0])
        h, w = pts.shape[:2]
        # focal from the pointmap: median of (pixel offset × depth / xy)
        u = np.arange(w) - w / 2
        v = np.arange(h) - h / 2
        uu, vv = np.meshgrid(u, v)
        z = pts[..., 2]
        fx = np.nanmedian(np.abs(uu * z / np.where(np.abs(pts[..., 0]) < 1e-6, np.nan, pts[..., 0])))
        fy = np.nanmedian(np.abs(vv * z / np.where(np.abs(pts[..., 1]) < 1e-6, np.nan, pts[..., 1])))
        f = float(np.nanmean([fx, fy]))
        vfov = 2.0 * np.arctan2(h / 2.0, f)
        cam = Camera.from_dict({"height": float(h), "width": float(w), "vfov": float(vfov)})
        return {"camera": cam}
