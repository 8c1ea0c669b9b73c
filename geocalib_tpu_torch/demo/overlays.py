"""Frame overlays for the interactive demo (numpy rasteriser, no OpenCV).

Port of geocalib_tpu/demo/overlays.py: up-field arrows, latitude heatmap,
confidence shading, horizon line, undistortion preview, and a gravity-aligned
ground grid and box, drawn straight into float RGB numpy frames with a
sampled-line rasteriser, so that they run headless and without OpenCV. The
camera work (horizon, projection, undistortion) goes through the port's
``Camera`` and ``Gravity`` on the device of the calibration result; the
drawing is numpy on the host.
"""

from typing import Dict

import numpy as np
import torch

Array = np.ndarray


def _np(x) -> Array:
    """A host array of a tensor (any device) or an array."""
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def draw_line(img: Array, p0, p1, color, thickness: int = 1) -> None:
    """In-place line with thickness, sampled twice per pixel of its length; clips to
    the frame."""
    h, w = img.shape[:2]
    x0, y0 = float(p0[0]), float(p0[1])
    x1, y1 = float(p1[0]), float(p1[1])
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
    xs = np.linspace(x0, x1, n)
    ys = np.linspace(y0, y1, n)
    r = max(0, thickness // 2)
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            xi = np.round(xs + dx).astype(int)
            yi = np.round(ys + dy).astype(int)
            ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            img[yi[ok], xi[ok]] = color


def _colormap(v: Array) -> Array:
    """Cheap diverging blue→white→red map for v in [-1, 1], (..., 3)."""
    v = np.clip(v, -1.0, 1.0)
    r = np.clip(1.0 + v, 0, 1)
    b = np.clip(1.0 - v, 0, 1)
    g = 1.0 - np.abs(v) * 0.7
    return np.stack([r, g, b], axis=-1)


def overlay_up_field(frame: Array, up, stride: int = 24, color=(0.0, 0.8, 0.2)) -> Array:
    """Sparse up-vector arrows."""
    up = _np(up)
    out = frame.copy()
    h, w = frame.shape[:2]
    scale = stride * 0.75
    for y in range(stride // 2, h, stride):
        for x in range(stride // 2, w, stride):
            dx, dy = float(up[y, x, 0]) * scale, float(up[y, x, 1]) * scale
            draw_line(out, (x, y), (x + dx, y + dy), color, 2)
    return out


def overlay_latitude(frame: Array, latitude, alpha: float = 0.35) -> Array:
    """Latitude heatmap blended over the frame."""
    lat = _np(latitude)
    if lat.ndim == 3:
        lat = lat[..., 0]
    colors = _colormap(np.sin(lat))
    return (1 - alpha) * frame + alpha * colors


def overlay_confidence(frame: Array, conf, alpha: float = 0.4) -> Array:
    """Confidence shading: low confidence darkens."""
    c = _np(conf)
    if c.ndim == 3:
        c = c[..., 0]
    c = c / max(float(c.max()), 1e-6)
    return frame * ((1 - alpha) + alpha * c[..., None])


def overlay_horizon(frame: Array, camera, gravity, color=(1.0, 0.1, 0.1)) -> Array:
    """Horizon line across the image (its left and right border intersections)."""
    from geocalib_tpu_torch.geometry.perspective_fields import get_horizon_line

    out = frame.copy()
    w = frame.shape[1]
    ys = _np(get_horizon_line(camera, gravity, relative=False)).reshape(2)
    draw_line(out, (0.0, ys[0]), (w - 1.0, ys[1]), color, 3)
    return out


def undistort_preview(frame: Array, camera) -> Array:
    """The frame with the camera's distortion removed, computed on the camera's device."""
    img = torch.as_tensor(np.asarray(frame, np.float32), device=camera.f.device)[None]
    cam_b = camera if camera.f.ndim == 2 else camera[None]
    return _np(cam_b.undistort_image(img)[0])


def _project_segments(camera, gravity, segments: Array):
    """World-frame segments (N, 2, 3) → pixel segments (N, 2, 2) and whether both ends
    project into the image."""
    R = _np(gravity.R).reshape(3, 3)
    pts = segments.reshape(-1, 3) @ R.T  # world → camera
    p3d = torch.as_tensor(pts, dtype=torch.float32, device=camera.f.device)[None]
    p2d, valid = camera.world2image(p3d)
    p2d = _np(p2d)[0].reshape(-1, 2, 2)
    valid = _np(valid)[0].reshape(-1, 2)
    return p2d, valid.all(-1)


def overlay_grid(frame: Array, camera, gravity, color=(0.2, 0.5, 1.0)) -> Array:
    """Gravity-aligned ground-plane grid."""
    out = frame.copy()
    lines = []
    for i in np.linspace(-2, 2, 9):
        lines.append([[i, 1.0, 2.0], [i, 1.0, 6.0]])  # depth lines on the floor
    for z in np.linspace(2, 6, 5):
        lines.append([[-2.0, 1.0, z], [2.0, 1.0, z]])
    segs, valid = _project_segments(camera, gravity, np.asarray(lines))
    for (a, b), ok in zip(segs, valid):
        if ok:
            draw_line(out, a, b, color, 1)
    return out


def overlay_box(frame: Array, camera, gravity, color=(1.0, 0.6, 0.1)) -> Array:
    """Gravity-aligned cube of side 1 at 3 m depth."""
    out = frame.copy()
    c = np.array([0.0, 0.5, 3.0])
    d = 0.5
    corners = np.array([[sx, sy, sz] for sx in (-d, d) for sy in (-d, d) for sz in (-d, d)]) + c
    edges = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    lines = np.asarray([[corners[i], corners[j]] for i, j in edges])
    segs, valid = _project_segments(camera, gravity, lines)
    for (a, b), ok in zip(segs, valid):
        if ok:
            draw_line(out, a, b, color, 2)
    return out


def render_overlays(frame, result: Dict, toggles: Dict[str, bool]) -> Array:
    """Compose the enabled overlays onto a float RGB frame (H, W, 3); result is one
    image's calibration (unbatched camera and gravity, fields (H, W, C))."""
    out = np.asarray(_np(frame), np.float32)
    camera, gravity = result["camera"], result["gravity"]
    if toggles.get("undistort") and float(camera.k.abs().max()) > 0:
        out = undistort_preview(out, camera)
    if toggles.get("confidence") and "latitude_confidence" in result:
        out = overlay_confidence(out, result["latitude_confidence"])
    if toggles.get("latitude") and "latitude_field" in result:
        out = overlay_latitude(out, result["latitude_field"])
    if toggles.get("up") and "up_field" in result:
        out = overlay_up_field(out, result["up_field"])
    if toggles.get("grid"):
        out = overlay_grid(out, camera, gravity)
    if toggles.get("box"):
        out = overlay_box(out, camera, gravity)
    if toggles.get("horizon"):
        out = overlay_horizon(out, camera, gravity)
    return np.clip(out, 0.0, 1.0)
