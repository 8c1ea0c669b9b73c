"""Panorama → perspective-crop rendering (the dataset generator's core), and
the procedural panoramas it renders from.

Port of geocalib_tpu/data/pano.py. ``render_from_pano`` builds, for every
output pixel, the camera ray, rotates it by gravity and yaw, converts it to
longitude and latitude, and samples the equirectangular panorama bilinearly:
plain tensor operations on the device of the panorama and the camera (a
gather, no kernel; the JAX package writes it in jnp outside any Pallas
kernel). ``_bilinear_sample`` clamps as the JAX function does: the integer
corner is clipped before the weight ``clip(x - x0, 0, 1)`` is taken, and the
far corner is ``min(x0 + 1, W - 1)``.

The procedural scenes (``synthetic_pano``: streets, rooms, open terrain and
the distant-city stripes) are numpy, copied from the JAX package, and give
the same arrays bit for bit for the same seed, so that both packages
generate the same datasets without any download.
"""

from typing import Tuple

import numpy as np
import torch

from geocalib_tpu_torch.geometry.camera import Camera
from geocalib_tpu_torch.geometry.gravity import Gravity
from geocalib_tpu_torch.utils.conversions import rad2rotmat

Tensor = torch.Tensor


def _bilinear_sample(img: Tensor, x: Tensor, y: Tensor) -> Tensor:
    """Sample img (H, W, C) at float pixel coordinates x, y (any shape), clamped
    to the image; returns x.shape + (C,)."""
    H, W = img.shape[:2]
    x0 = torch.clamp(torch.floor(x).long(), 0, W - 1)
    y0 = torch.clamp(torch.floor(y).long(), 0, H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    wx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
    wy = torch.clamp(y - y0, 0.0, 1.0)[..., None]

    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy) + v10 * (1 - wx) * wy
            + v11 * wx * wy)


def pano_coordinates(pano_size, camera: Camera, gravity: Gravity, yaw=0.0):
    """Where each crop pixel samples the panorama: float pixel coordinates (nx, ny),
    each (B, h*w), in a panorama of pano_size = (Hp, Wp). Longitude ±π maps to the
    first and last columns, so nx jumps across the panorama's seam where the world
    ray's x changes sign with z < 0."""
    B = camera.batch_shape[0]
    h = int(camera.size[0, 1])
    w = int(camera.size[0, 0])
    dev = camera.f.device
    yaw = torch.as_tensor(yaw, dtype=torch.float32, device=dev).expand(B)

    xy = camera.pixel_coordinates(h, w)
    uv1, _ = camera.image2world(xy)
    bearings = camera.pixel_bearing_many(uv1)  # (B, N, 3)

    zeros = torch.zeros_like(yaw)
    R_yaw = rad2rotmat(zeros, zeros, yaw)  # (B, 3, 3)
    rotated = bearings @ (gravity.R @ R_yaw)

    lon = torch.atan2(rotated[..., 0], rotated[..., 2])
    lat = torch.atan2(rotated[..., 1], torch.linalg.norm(rotated[..., ::2], dim=-1))

    Hp, Wp = pano_size
    nx = (lon + np.pi) / (2 * np.pi) * (Wp - 1.0)
    ny = (lat + np.pi / 2) / np.pi * (Hp - 1.0)
    return nx, ny


def sample_distance(a: Tuple[Tensor, Tensor], b: Tuple[Tensor, Tensor], pano_size) -> Tensor:
    """How far apart two samples (nx, ny) of a panorama of pano_size = (Hp, Wp) lie on
    the sphere, in pano pixels: the larger of the latitude offset and the longitude
    offset taken the short way round the seam and scaled by cos(latitude), so that the
    seam's two columns and the poles' rows count as the same direction."""
    Hp, Wp = pano_size
    dx = (a[0] - b[0]).abs()
    dx = torch.minimum(dx, (Wp - 1.0) - dx)
    lat = b[1] / (Hp - 1.0) * np.pi - np.pi / 2
    return torch.maximum(dx * torch.cos(lat).abs(), (a[1] - b[1]).abs())


def render_from_pano(pano: Tensor, camera: Camera, gravity: Gravity, yaw=0.0) -> Tensor:
    """Render perspective crops from an equirectangular panorama.

    pano: (Hp, Wp, 3) float [0, 1], on the device of the camera. camera: batched
    Camera (B,) whose entries share width and height. gravity: batched Gravity
    (B,). yaw: a scalar or (B,) yaw angles in radians. Returns (B, h, w, 3).
    """
    B = camera.batch_shape[0]
    h, w = int(camera.size[0, 1]), int(camera.size[0, 0])
    nx, ny = pano_coordinates(pano.shape[:2], camera, gravity, yaw)
    return _bilinear_sample(pano, nx, ny).reshape(B, h, w, pano.shape[-1])


def _legacy_pano(rng, height: int, width: int) -> np.ndarray:
    """Original round-1 pano: sky/ground gradient + distant facade stripes.

    Kept as one scene family — "city at infinity" — of the procedural mix.
    """
    # NOTE sign: render_from_pano maps world-UP directions to NEGATIVE
    # pano-array latitude (gravity = +y; verified against get_latitude_field:
    # a pitch>0 crop samples rows < H/2). Negate so "sky" here is physically
    # up in rendered crops.
    lat = -np.linspace(-np.pi / 2, np.pi / 2, height)[:, None]
    lon = np.linspace(-np.pi, np.pi, width)[None, :]

    # sky→ground gradient keyed on latitude (horizon at lat=0)
    sky = np.clip(lat / (np.pi / 2), 0, 1)
    ground = np.clip(-lat / (np.pi / 2), 0, 1)
    base = np.stack(
        [
            0.4 + 0.4 * sky + 0.25 * ground + 0 * lon,
            0.5 + 0.3 * sky + 0.2 * ground + 0 * lon,
            0.7 + 0.25 * sky + 0.05 * ground + 0 * lon,
        ],
        axis=-1,
    )

    # vertical "building" stripes with random colors and heights
    img = base.copy()
    for _ in range(rng.integers(8, 16)):
        lon0 = rng.uniform(-np.pi, np.pi)
        lon_w = rng.uniform(0.1, 0.6)
        top = rng.uniform(0.05, 0.6)  # angular height above horizon
        color = rng.uniform(0.1, 0.9, 3)
        mask = (
            (np.abs(((lon - lon0 + np.pi) % (2 * np.pi)) - np.pi) < lon_w / 2)
            & (lat > -0.5)
            & (lat < top)
        )
        # window texture
        tex = 0.5 + 0.5 * np.sin(lon * 40) * np.sin(lat * 40)
        img = np.where(mask[..., None], color * (0.7 + 0.3 * tex[..., None]), img)

    noise = rng.normal(0, 0.02, img.shape)
    return np.clip(img + noise, 0, 1).astype(np.float32)


# ---------------------------------------------------------------------------
# Procedural 3D scenes (round 4): true ray-traced geometry so crops contain
# REAL perspective structure — vertical building edges, ground-plane texture
# converging at the horizon, room corners — instead of the lat/lon stripe
# approximation. This matters because the up/latitude field networks learn
# from exactly these cues (GeoCalib trains on real OpenPano panoramas; without
# them, geometry realism has to come from procedural scenes).
# All numpy float32.
# ---------------------------------------------------------------------------


def _upsample_bilinear(a: np.ndarray, H: int, W: int) -> np.ndarray:
    """Bilinear upsample a (h, w) grid to (H, W) with edge clamping."""
    h, w = a.shape
    y = np.linspace(0, h - 1, H)
    x = np.linspace(0, w - 1, W)
    y0 = np.clip(np.floor(y).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(x).astype(int), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (y - y0)[:, None]
    wx = (x - x0)[None, :]
    return (
        a[np.ix_(y0, x0)] * (1 - wy) * (1 - wx)
        + a[np.ix_(y0, x1)] * (1 - wy) * wx
        + a[np.ix_(y1, x0)] * wy * (1 - wx)
        + a[np.ix_(y1, x1)] * wy * wx
    ).astype(np.float32)


def _value_noise(rng, H: int, W: int, octaves=(8, 16, 32), amp: float = 1.0):
    """Multi-octave value noise in [0, 1], (H, W)."""
    out = np.zeros((H, W), np.float32)
    total = 0.0
    a = amp
    for o in octaves:
        g = rng.random((max(2, o), max(2, 2 * o))).astype(np.float32)
        out += a * _upsample_bilinear(g, H, W)
        total += a
        a *= 0.5
    return out / total


def _ray_dirs(height: int, width: int):
    """Unit SCENE-frame ray directions for every equirect pixel.

    Scene frame: +y is up (ground below, sky above). render_from_pano's
    world frame has gravity = +y (world-up directions land at NEGATIVE
    pano-array latitude; verified against get_latitude_field), so the scene
    y is the NEGATED array latitude: row i ↔ lat = -(-pi/2 + pi*i/(H-1)).
    """
    lat = -np.linspace(-np.pi / 2, np.pi / 2, height, dtype=np.float32)[:, None]
    lon = np.linspace(-np.pi, np.pi, width, dtype=np.float32)[None, :]
    y = np.broadcast_to(np.sin(lat), (height, width))
    c = np.cos(lat)
    x = c * np.sin(lon)
    z = c * np.cos(lon)
    return np.stack([x, y, z], axis=-1).astype(np.float32)  # (H, W, 3)


def _intersect_boxes(d: np.ndarray, boxes: np.ndarray, inside: bool = False):
    """Nearest ray/AABB hit from the origin for every pixel.

    d: (H, W, 3) unit directions; boxes: (M, 2, 3) [min, max] corners.
    Returns (t, box_id, axis, sign): hit distance (inf if none), which box,
    which slab axis was entered (0/1/2), and the face sign (+1/-1).
    inside=True intersects from INSIDE the box (exit face, for rooms).
    """
    H, W, _ = d.shape
    dd = d.reshape(-1, 1, 3)  # (N, 1, 3)
    inv = 1.0 / np.where(np.abs(dd) < 1e-9, 1e-9, dd)
    t_lo = boxes[None, :, 0, :] * inv  # (N, M, 3)
    t_hi = boxes[None, :, 1, :] * inv
    t1 = np.minimum(t_lo, t_hi)
    t2 = np.maximum(t_lo, t_hi)
    t_near = t1.max(axis=-1)  # (N, M)
    t_far = t2.min(axis=-1)
    if inside:
        t = t_far
        hit = t_far > 1e-6
        axis = np.argmin(np.abs(t2 - t_far[..., None]), axis=-1)
    else:
        t = t_near
        hit = (t_near <= t_far) & (t_near > 1e-6)
        axis = np.argmax(t1, axis=-1)
    t = np.where(hit, t, np.inf)
    box_id = np.argmin(t, axis=-1)  # (N,)
    tmin = t[np.arange(t.shape[0]), box_id]
    axis = axis[np.arange(t.shape[0]), box_id]
    # face sign: which side of the box the ray came through on that axis
    sign = np.sign(np.take_along_axis(dd[:, 0, :], axis[:, None], axis=1))[:, 0]
    if not inside:
        sign = -sign  # entering face normal opposes the ray
    return (
        tmin.reshape(H, W),
        box_id.reshape(H, W),
        axis.reshape(H, W),
        sign.reshape(H, W),
    )


def _facade(u, v, rng, base_color):
    """Window-grid facade texture sampled at wall coords (u horizontal,
    v vertical, metres). Returns (..., 3) colors."""
    wu = rng.uniform(1.6, 3.5)  # window pitch
    wv = rng.uniform(1.8, 3.2)  # floor pitch
    du = rng.uniform(0.45, 0.7)  # window duty cycle
    dv = rng.uniform(0.4, 0.65)
    fu = np.mod(u / wu, 1.0)
    fv = np.mod(v / wv, 1.0)
    win = (fu < du) & (fv < dv)
    win_color = np.array(rng.uniform(0.05, 0.35, 3), np.float32)
    glass = win_color + 0.15 * np.sin(u * 3.1)[..., None].astype(np.float32)
    wall = base_color * (0.85 + 0.3 * np.mod(v / wv, 1.0))[..., None]
    return np.where(win[..., None], glass, wall).astype(np.float32)


def _sky(dirs, rng, H, W):
    """Sky dome: latitude gradient + cloud noise + optional sun disk."""
    y = dirs[..., 1]
    horizon = np.array(rng.uniform([0.55, 0.6, 0.65], [0.8, 0.85, 0.95]), np.float32)
    zenith = np.array(rng.uniform([0.15, 0.3, 0.55], [0.45, 0.6, 0.95]), np.float32)
    tgrad = np.clip(y, 0, 1)[..., None]
    sky = horizon * (1 - tgrad) + zenith * tgrad
    clouds = _value_noise(rng, H, W, octaves=(6, 12, 24))
    cloud_amt = rng.uniform(0.0, 0.8)
    cmask = np.clip((clouds - 0.55) * 4, 0, 1) * cloud_amt * np.clip(y * 3, 0, 1)
    sky = sky * (1 - cmask[..., None]) + cmask[..., None] * 0.95
    sun = rng.uniform(0, 2 * np.pi)
    sun_dir = np.array(
        [np.cos(0.4) * np.sin(sun), np.sin(0.4), np.cos(0.4) * np.cos(sun)], np.float32
    )
    cosang = dirs @ sun_dir
    sky += np.clip((cosang - 0.9995) * 4000, 0, 1.2)[..., None]
    return sky.astype(np.float32)


def _ground(dirs, rng, h_cam, H, W, urban: bool):
    """Ground plane y = -h_cam with perspective-correct texture."""
    dy = dirs[..., 1]
    t = np.where(dy < -1e-4, h_cam / np.maximum(-dy, 1e-4), np.inf)
    tc = np.where(np.isfinite(t), t, 1e6)  # finite stand-in for texture math
    px = dirs[..., 0] * tc
    pz = dirs[..., 2] * tc
    base = np.array(
        rng.uniform([0.25, 0.2, 0.15], [0.55, 0.5, 0.4]), np.float32
    )
    tex = _value_noise(rng, H, W, octaves=(16, 32, 64))
    col = base * (0.7 + 0.6 * tex)[..., None]
    if urban:
        # sidewalk grid + road stripes: strong converging lines on the ground
        pitch = rng.uniform(2.0, 6.0)
        lw = rng.uniform(0.06, 0.18)
        grid = (np.mod(px, pitch) < lw * pitch) | (np.mod(pz, pitch) < lw * pitch)
        col = np.where(grid[..., None], col * 0.55, col)
        road_w = rng.uniform(4.0, 9.0)
        road = np.abs(px) < road_w
        road_col = np.array([0.18, 0.18, 0.2], np.float32) * (
            0.8 + 0.4 * tex[..., None]
        )
        col = np.where(road[..., None], road_col, col)
        dash = (np.abs(px) < 0.2) & (np.mod(pz, 4.0) < 2.0)
        col = np.where(dash[..., None], np.float32(0.85), col)
    else:
        # patchy grass/dirt
        patch = _value_noise(rng, H, W, octaves=(8, 24))
        green = np.array([0.2, 0.4, 0.15], np.float32) * (0.6 + 0.8 * tex)[..., None]
        col = np.where((patch > 0.5)[..., None], green, col)
    return t, col.astype(np.float32)


def _city_pano(rng, height: int, width: int) -> np.ndarray:
    """Street-level scene: ground plane + ray-traced building boxes."""
    H, W = height, width
    dirs = _ray_dirs(H, W)
    h_cam = rng.uniform(1.5, 8.0)

    # place boxes on a ring around the camera, none containing the origin
    M = int(rng.integers(10, 26))
    boxes = np.zeros((M, 2, 3), np.float32)
    colors = rng.uniform(0.25, 0.85, (M, 3)).astype(np.float32)
    specs = []
    for m in range(M):
        ang = rng.uniform(0, 2 * np.pi)
        dist = rng.uniform(6.0, 60.0)
        cx, cz = dist * np.sin(ang), dist * np.cos(ang)
        sx = rng.uniform(3.0, 18.0)
        sz = rng.uniform(3.0, 18.0)
        hgt = rng.uniform(4.0, 45.0)
        lo = np.array([cx - sx / 2, -h_cam, cz - sz / 2])
        hi = np.array([cx + sx / 2, -h_cam + hgt, cz + sz / 2])
        # keep a clear bubble around the camera
        if lo[0] < 2 and hi[0] > -2 and lo[2] < 2 and hi[2] > -2:
            lo[0] += 8 * np.sign(cx if cx != 0 else 1)
            hi[0] += 8 * np.sign(cx if cx != 0 else 1)
        boxes[m, 0], boxes[m, 1] = lo, hi
        specs.append(dict(wu=None))
    t_box, box_id, axis, sign = _intersect_boxes(dirs, boxes)

    t_gnd, gnd_col = _ground(dirs, rng, h_cam, H, W, urban=True)
    sky_col = _sky(dirs, rng, H, W)

    # shade the nearest surface per pixel
    hit_pt = dirs * np.where(np.isfinite(t_box), t_box, 0.0)[..., None]
    img = sky_col.copy()
    gnd_mask = t_gnd < t_box
    img = np.where(gnd_mask[..., None] & np.isfinite(t_gnd)[..., None], gnd_col, img)

    box_mask = np.isfinite(t_box) & ~gnd_mask
    # facade texture per box (windows keyed on world coords so edges align)
    fac = np.zeros((H, W, 3), np.float32)
    light = np.array([0.45, 0.75, 0.48], np.float32)
    light /= np.linalg.norm(light)
    for m in range(M):
        sel = box_mask & (box_id == m)
        if not sel.any():
            continue
        ax = axis[sel]
        pt = hit_pt[sel]
        v = pt[:, 1] + h_cam  # height above ground
        u = np.where(ax == 0, pt[:, 2], pt[:, 0])
        cols = _facade(u, v, np.random.default_rng(rng.integers(2**31)), colors[m])
        top = ax == 1
        cols[top] = colors[m] * 0.5  # roof
        n_dot = np.abs(light[ax]) * 0.9 + 0.25
        fac[sel] = cols * n_dot[:, None]
    img = np.where(box_mask[..., None], fac, img)

    # distance haze toward the horizon color
    t_all = np.where(box_mask, t_box, np.where(gnd_mask, t_gnd, np.inf))
    haze = (1 - np.exp(-np.where(np.isfinite(t_all), t_all, 0) / 120.0)) * np.isfinite(
        t_all
    )
    img = img * (1 - haze[..., None] * 0.6) + sky_col * haze[..., None] * 0.6

    img += rng.normal(0, 0.015, img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def _room_pano(rng, height: int, width: int) -> np.ndarray:
    """Indoor scene: camera inside a textured box room + furniture boxes."""
    H, W = height, width
    dirs = _ray_dirs(H, W)
    h_cam = rng.uniform(1.0, 2.0)
    rw = rng.uniform(3.0, 12.0)  # room half-width (x)
    rd = rng.uniform(3.0, 12.0)  # room half-depth (z)
    rh = rng.uniform(2.4, 5.0)  # ceiling height
    cx = rng.uniform(-rw * 0.5, rw * 0.5)
    cz = rng.uniform(-rd * 0.5, rd * 0.5)
    room = np.array(
        [[[-rw - cx, -h_cam, -rd - cz], [rw - cx, rh - h_cam, rd - cz]]], np.float32
    )
    t_room, _, axis_r, sign_r = _intersect_boxes(dirs, room, inside=True)

    # furniture: boxes on the floor, not containing the camera
    Mf = int(rng.integers(2, 7))
    fboxes, fcols = [], []
    for _ in range(Mf):
        fx = rng.uniform(-rw - cx + 0.5, rw - cx - 0.5)
        fz = rng.uniform(-rd - cz + 0.5, rd - cz - 0.5)
        sx, sz = rng.uniform(0.4, 2.5, 2)
        fh = rng.uniform(0.4, 2.0)
        lo = [fx - sx / 2, -h_cam, fz - sz / 2]
        hi = [fx + sx / 2, -h_cam + fh, fz + sz / 2]
        if lo[0] < 0.3 and hi[0] > -0.3 and lo[2] < 0.3 and hi[2] > -0.3:
            continue  # would contain the camera
        fboxes.append([lo, hi])
        fcols.append(rng.uniform(0.15, 0.8, 3))
    if fboxes:
        fb = np.asarray(fboxes, np.float32)
        t_f, fid, axis_f, sign_f = _intersect_boxes(dirs, fb)
    else:
        t_f = np.full((H, W), np.inf, np.float32)

    hit_room = dirs * t_room[..., None]
    px, py, pz = hit_room[..., 0], hit_room[..., 1], hit_room[..., 2]
    v = py + h_cam

    wall_base = np.array(rng.uniform([0.45, 0.4, 0.35], [0.9, 0.85, 0.8]), np.float32)
    floor_base = np.array(rng.uniform([0.2, 0.12, 0.08], [0.6, 0.45, 0.35]), np.float32)
    tex = _value_noise(rng, H, W, octaves=(12, 24, 48))

    img = np.zeros((H, W, 3), np.float32)
    is_floor = (axis_r == 1) & (sign_r < 0)
    is_ceil = (axis_r == 1) & (sign_r > 0)
    is_wall = axis_r != 1

    # floor: planks along x
    plank = np.mod(px, rng.uniform(0.5, 1.2)) < 0.05
    floor_col = floor_base * (0.7 + 0.5 * tex)[..., None]
    floor_col = np.where(plank[..., None], floor_col * 0.5, floor_col)
    # optional checkerboard tiling
    if rng.random() < 0.4:
        ts = rng.uniform(0.4, 1.0)
        check = (np.floor(px / ts) + np.floor(pz / ts)) % 2 < 1
        floor_col = np.where(
            check[..., None], floor_col, floor_col * 0.55 + 0.3
        )
    img = np.where(is_floor[..., None], floor_col, img)
    img = np.where(is_ceil[..., None], 0.9 * (0.85 + 0.15 * tex)[..., None], img)

    # walls: stripes or paint + a dado line, with picture/door decals
    wu = np.where(axis_r == 0, pz, px)
    stripe = np.sin(wu * rng.uniform(2.0, 8.0)) > rng.uniform(-0.5, 0.8)
    wall_col = wall_base * (0.8 + 0.25 * tex)[..., None]
    wall_col = np.where(
        stripe[..., None], wall_col, wall_col * rng.uniform(0.6, 0.9)
    )
    dado = np.abs(v - rng.uniform(0.8, 1.2)) < 0.03
    wall_col = np.where((dado & is_wall)[..., None], wall_col * 0.4, wall_col)
    for _ in range(int(rng.integers(1, 5))):  # rectangular decals (pictures, doors)
        u0 = rng.uniform(-8, 8)
        v0 = rng.uniform(0.0, 2.0)
        du_, dv_ = rng.uniform(0.4, 1.6), rng.uniform(0.5, 2.0)
        dec = (
            (np.abs(wu - u0) < du_ / 2)
            & (v > v0)
            & (v < v0 + dv_)
            & is_wall
            & (axis_r == (0 if rng.random() < 0.5 else 2))
        )
        wall_col = np.where(dec[..., None], rng.uniform(0.1, 0.9, 3), wall_col)
    img = np.where(is_wall[..., None], wall_col, img)

    # ceiling light pools + wall shading by distance
    fall = 1.0 / (1.0 + 0.02 * t_room**2)
    img *= (0.55 + 0.6 * fall)[..., None]

    # composite furniture in front of the room shell
    if fboxes:
        fmask = t_f < t_room
        hit_f = dirs * np.where(np.isfinite(t_f), t_f, 0.0)[..., None]
        fcol_img = np.zeros_like(img)
        for m in range(len(fboxes)):
            sel = fmask & (fid == m)
            if not sel.any():
                continue
            shade = 0.6 + 0.4 * (axis_f[sel] == 1)
            fcol_img[sel] = np.asarray(fcols[m], np.float32) * shade[:, None]
        img = np.where(fmask[..., None], fcol_img, img)

    img += rng.normal(0, 0.015, img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def _terrain_pano(rng, height: int, width: int) -> np.ndarray:
    """Open outdoor scene: textured ground + sky + a few distant boxes."""
    H, W = height, width
    dirs = _ray_dirs(H, W)
    h_cam = rng.uniform(1.4, 30.0)
    t_gnd, gnd_col = _ground(dirs, rng, h_cam, H, W, urban=rng.random() < 0.3)
    sky_col = _sky(dirs, rng, H, W)
    img = np.where(np.isfinite(t_gnd)[..., None], gnd_col, sky_col)

    # hills: displace the horizon with low-frequency noise on the skyline
    y = dirs[..., 1]
    ridge = (_value_noise(rng, 1, W, octaves=(4, 8, 16))[0] - 0.5) * rng.uniform(
        0.05, 0.3
    )
    hill = (y > 0) & (y < ridge[None, :])
    hill_col = np.array([0.25, 0.35, 0.2], np.float32) * (
        0.7 + 0.6 * _value_noise(rng, H, W, octaves=(16, 32))[..., None]
    )
    img = np.where(hill[..., None], hill_col, img)

    haze = np.clip(1 - np.abs(y) * 4, 0, 1) * 0.4
    img = img * (1 - haze[..., None]) + sky_col * haze[..., None]
    img += rng.normal(0, 0.015, img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def synthetic_pano(
    seed: int = 0, height: int = 768, width: int = 1536
) -> np.ndarray:
    """Procedural equirect panorama with true 3D perspective structure.

    Scene mix (seeded): ray-traced street scenes (ground plane + building
    boxes with window grids), indoor rooms (walls/floor/ceiling + furniture),
    open terrain, and the round-1 "distant city" stripes. All families give
    the up/latitude networks real vanishing-line cues — vertical edges,
    converging ground lines, a physical horizon — standing in for the
    real OpenPano panoramas (``data/download.py`` fetches those, and
    ``data/generate.py --pano_dir`` renders from them).
    """
    rng = np.random.default_rng(seed)
    r = rng.random()
    if r < 0.40:
        return _city_pano(rng, height, width)
    if r < 0.65:
        return _room_pano(rng, height, width)
    if r < 0.85:
        return _terrain_pano(rng, height, width)
    return _legacy_pano(rng, height, width)
