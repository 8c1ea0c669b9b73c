"""Native uncalibrated vanishing-point calibration with a gravity prior.

Port of geocalib_tpu/models/uvp.py: the estimation is the same numpy and
OpenCV code on the host, the same float64 operations in the same order with
the same ``np.random.default_rng(seed)``, so ``estimate`` gives the JAX
package's (f, g) bit for bit; only ``__call__`` builds the port's Camera and
Gravity. The JAX module's own description follows.

A from-scratch, dependency-free implementation of the "UVP" baseline the
reference only wraps (siclib/models/optimization/vp_from_prior.py drives the
external VP-Estimation-with-Prior-Gravity package's hybrid line solvers,
which are not installable here). Same role — the strongest non-learned
comparison row in the benchmark tables — with the full estimation native:

1. line segments from OpenCV's built-in LSD (same von Gioi detector family
   the reference's pytlsd uses);
2. vertical vanishing point by 2-line RANSAC with length-weighted sampling,
   scored by angular consistency of all segments, candidates gated by
   anti-alignment with the gravity prior (default: upright camera);
3. focal length from VP orthogonality: a second RANSAC over the residual
   segments proposes horizontal VPs; each candidate pair gives
   f^2 = -(v_vert . v_h) in centered pixel coordinates, scored by joint
   inlier support (fallback: the trivial f = 0.7 * max(h, w) prior);
4. gravity = the unprojected vertical VP bearing, anti-aligned with the
   prior (the reference's convention, vp_from_prior.py:150-155).

Everything is numpy on the host: per-image line geometry is tiny (hundreds
of segments), latency is dominated by LSD itself — no reason to burn a
device program on it.
"""

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

__all__ = ["NativeUVP", "UVPConfig"]


@dataclasses.dataclass(frozen=True)
class UVPConfig:
    n_iters: int = 500  # RANSAC iterations per VP
    th_deg: float = 1.5  # angular inlier threshold (segment vs VP direction)
    min_len: float = 10.0  # drop segments shorter than this many pixels
    vertical_max_tilt_deg: float = 67.5  # prior gate on vertical candidates
    min_f_factor: float = 0.15  # valid focal range, x max(h, w)
    max_f_factor: float = 5.0
    seed: int = 0


def detect_lsd_lines(gray_u8: np.ndarray) -> np.ndarray:
    """LSD segments (N, 2, 2) [[x1,y1],[x2,y2]] from a uint8 grayscale image."""
    import cv2

    lines = cv2.createLineSegmentDetector().detect(gray_u8)[0]
    if lines is None:
        return np.zeros((0, 2, 2), np.float64)
    return lines.reshape(-1, 4).astype(np.float64).reshape(-1, 2, 2)


def _segment_geometry(lines: np.ndarray, cx: float, cy: float):
    """Centered midpoints (N,2), unit directions (N,2), lengths (N),
    homogeneous line coefficients (N,3) for centered coordinates."""
    p1 = lines[:, 0] - np.array([cx, cy])
    p2 = lines[:, 1] - np.array([cx, cy])
    mid = 0.5 * (p1 + p2)
    d = p2 - p1
    length = np.linalg.norm(d, axis=-1)
    d = d / np.maximum(length[:, None], 1e-12)
    # homogeneous line through the two points: cross([x1,y1,1],[x2,y2,1])
    l = np.cross(
        np.concatenate([p1, np.ones_like(p1[:, :1])], -1),
        np.concatenate([p2, np.ones_like(p2[:, :1])], -1),
    )
    return mid, d, length, l


def _vp_residuals(vp: np.ndarray, mid: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Angle (rad) between each segment direction and the direction from its
    midpoint toward the VP (projective: handles VPs at/near infinity)."""
    # direction toward vp from midpoint: vp_xy - m * vp_z
    to_vp = vp[None, :2] - mid * vp[2]
    n = np.linalg.norm(to_vp, axis=-1)
    to_vp = to_vp / np.maximum(n[:, None], 1e-12)
    cos = np.abs(np.sum(to_vp * d, axis=-1))
    return np.arccos(np.clip(cos, 0.0, 1.0))


def _ransac_vp(
    rng: np.random.Generator,
    mid: np.ndarray,
    d: np.ndarray,
    length: np.ndarray,
    l_hom: np.ndarray,
    cand_mask: np.ndarray,
    cfg: UVPConfig,
) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """Best VP from pairs sampled inside cand_mask, scored over cand_mask.

    Returns (vp (3,) with |vp| = 1 or None, inlier mask over ALL segments).
    """
    idx = np.flatnonzero(cand_mask)
    if idx.size < 2:
        return None, np.zeros(len(mid), bool)
    w = length[idx] / length[idx].sum()
    th = np.radians(cfg.th_deg)

    best_score, best_vp = -1.0, None
    for _ in range(cfg.n_iters):
        i, j = rng.choice(idx, size=2, replace=False, p=w)
        vp = np.cross(l_hom[i], l_hom[j])
        nv = np.linalg.norm(vp)
        if nv < 1e-9:
            continue
        vp = vp / nv
        r = _vp_residuals(vp, mid[idx], d[idx])
        score = float(np.sum((r < th) * length[idx]))
        if score > best_score:
            best_score, best_vp = score, vp
    if best_vp is None:
        return None, np.zeros(len(mid), bool)
    inl = _vp_residuals(best_vp, mid, d) < th
    return best_vp, inl


def _vp_direction(vp: np.ndarray, f: float) -> np.ndarray:
    """Unit bearing of a homogeneous VP (centered pixels) at focal f."""
    v = np.array([vp[0], vp[1], vp[2] * f])
    return v / np.maximum(np.linalg.norm(v), 1e-12)


class NativeUVP:
    """Line-based single-image calibration (vertical VP + focal), native.

    __call__(data) -> {"camera": Camera, "gravity": Gravity} like the other
    baselines; data needs "image" (H, W, 3) float [0, 1] and may carry
    "prior_gravity" (3,) to steer the vertical VP choice.
    """

    def __init__(self, conf: Optional[UVPConfig] = None, **kw):
        self.conf = conf or UVPConfig(**kw)

    def __call__(self, data: Dict[str, Any]) -> Dict[str, Any]:
        from geocalib_tpu_torch.geometry.camera import Camera
        from geocalib_tpu_torch.geometry.gravity import Gravity

        image = np.asarray(data["image"])
        if image.ndim == 4:
            raise ValueError("NativeUVP runs one image at a time (like the reference)")
        h, w = image.shape[:2]
        prior = np.asarray(data.get("prior_gravity", [0.0, 1.0, 0.0]), np.float64)
        prior = prior / np.linalg.norm(prior)

        f, g = self.estimate(image, prior)
        vfov = 2.0 * np.arctan2(h / 2.0, f)
        cam = Camera.from_dict(
            {"height": float(h), "width": float(w), "vfov": float(vfov)}
        )
        return {
            "camera": cam,
            "gravity": Gravity.from_vec3d(np.asarray(g, np.float32)),
        }

    # ------------------------------------------------------------------ #

    def estimate(
        self, image: np.ndarray, prior: np.ndarray
    ) -> Tuple[float, np.ndarray]:
        """Returns (focal px, gravity unit vec3 in camera frame)."""
        cfg = self.conf
        h, w = image.shape[:2]
        cx, cy = w / 2.0, h / 2.0
        f_trivial = 0.7 * max(h, w)

        gray = np.clip(image.mean(-1) * 255.0, 0, 255).astype(np.uint8)
        lines = detect_lsd_lines(gray)
        if len(lines):
            mid, d, length, l_hom = _segment_geometry(lines, cx, cy)
            keep = length >= cfg.min_len
            lines, mid, d, length, l_hom = (
                lines[keep], mid[keep], d[keep], length[keep], l_hom[keep]
            )
        if len(lines) < 4:
            # not enough structure: trivial estimate, upright gravity
            return f_trivial, -prior * np.sign(prior[1] if prior[1] else 1.0)

        rng = np.random.default_rng(cfg.seed)

        # ---- vertical VP: candidates = segments tilted less than the prior
        # gate away from the image vertical (generous: roll/pitch reach 45 deg)
        tilt = np.degrees(np.arccos(np.clip(np.abs(d[:, 1]), 0, 1)))
        vert_mask = tilt <= cfg.vertical_max_tilt_deg
        vp_v, inl_v = _ransac_vp(rng, mid, d, length, l_hom, vert_mask, cfg)
        if vp_v is None:
            return f_trivial, -prior

        # ---- focal from orthogonality with a horizontal VP
        rest = ~inl_v
        f_best, support_best = None, 0.0
        vp_h, inl_h = _ransac_vp(rng, mid, d, length, l_hom, rest, cfg)
        if vp_h is not None:
            f_sq = self._orthogonality_focal(vp_v, vp_h)
            if f_sq is not None:
                f_cand = float(np.sqrt(f_sq))
                if cfg.min_f_factor * max(h, w) <= f_cand <= cfg.max_f_factor * max(h, w):
                    f_best = f_cand
                    support_best = float(np.sum(length[inl_h]))
            # second horizontal VP from what is left (a Manhattan third axis
            # often exists); keep the better-supported valid focal
            rest2 = rest & ~inl_h
            vp_h2, inl_h2 = _ransac_vp(rng, mid, d, length, l_hom, rest2, cfg)
            if vp_h2 is not None:
                f_sq2 = self._orthogonality_focal(vp_v, vp_h2)
                if f_sq2 is not None:
                    f_cand2 = float(np.sqrt(f_sq2))
                    support2 = float(np.sum(length[inl_h2]))
                    if (
                        cfg.min_f_factor * max(h, w)
                        <= f_cand2
                        <= cfg.max_f_factor * max(h, w)
                        and support2 > support_best
                    ):
                        f_best = f_cand2

        f = f_best if f_best is not None else f_trivial

        # ---- gravity: unproject the vertical VP, anti-align with the prior
        # (reference convention, vp_from_prior.py:150-155: gravity "up" vector
        # has negative y in image coordinates)
        u = _vp_direction(vp_v, f)
        # match the reference's y-flip of solver output before alignment
        sign = np.dot(u, prior)
        g = -u * np.sign(sign if sign != 0 else 1.0)
        return f, g

    @staticmethod
    def _orthogonality_focal(vp_a: np.ndarray, vp_b: np.ndarray) -> Optional[float]:
        """f^2 from (K^-1 va) . (K^-1 vb) = 0 for finite VPs in centered px:
        f^2 = -(xa xb + ya yb) / (za zb). None if degenerate/negative."""
        za, zb = vp_a[2], vp_b[2]
        if abs(za) < 1e-8 or abs(zb) < 1e-8:
            return None
        a = np.array([vp_a[0] / za, vp_a[1] / za])
        b = np.array([vp_b[0] / zb, vp_b[1] / zb])
        f_sq = -float(np.dot(a, b))
        return f_sq if f_sq > 1.0 else None
