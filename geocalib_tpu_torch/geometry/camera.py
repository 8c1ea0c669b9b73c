"""Camera models with the packed (..., 8) layout of the JAX package.

Port of geocalib_tpu/geometry/camera.py. A ``Camera`` holds the packed
parameters (size, f, c, k) and a camera-model name; per-model distortion
math lives in scalar functions of r² (``_DIST_SPECS``), which is what lets
the LM kernel work on per-pixel scalar planes.

All four models of the reference are implemented: ``pinhole``,
``simple_radial``, ``radial`` and ``simple_divisional``.
"""

import dataclasses
from typing import Dict, Tuple

import torch

from geocalib_tpu_torch.utils.conversions import deg2rad, focal2fov, fov2focal

Tensor = torch.Tensor

CAMERA_MODELS = ("pinhole", "simple_radial", "radial", "simple_divisional")

# number of active distortion parameters per model
NUM_DIST_PARAMS = {
    "pinhole": 0,
    "simple_radial": 1,
    "radial": 2,
    "simple_divisional": 1,
}

# valid range for additive distortion updates in the LM solver
DIST_RANGE = {
    "simple_radial": (-0.7, 0.7),
    "radial": (-0.7, 0.7),
    "simple_divisional": (-3.0, 3.0),
}

_EPS = 1e-3  # least depth of a projected point


def _f32(x, like: Tensor = None) -> Tensor:
    device = like.device if like is not None else None
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Packed camera parameters; every field is (..., 2) float32.

    size: (w, h) pixels; f: (fx, fy); c: (cx, cy); k: distortion, zero-padded to 2.
    """

    size: Tensor
    f: Tensor
    c: Tensor
    k: Tensor
    model: str = "pinhole"

    # ---------------------------------------------------------------- #
    # constructors
    # ---------------------------------------------------------------- #

    @classmethod
    def from_data(cls, data, model: str = "pinhole") -> "Camera":
        """From packed (..., {6,7,8}) = [w, h, fx, fy, cx, cy, k1, k2]."""
        _spec(model)
        data = torch.as_tensor(data, dtype=torch.float32)
        n = data.shape[-1]
        assert n in (6, 7, 8), data.shape
        if n != 8:
            pad = data.new_zeros(data.shape[:-1] + (8 - n,))
            data = torch.cat([data, pad], dim=-1)
        return cls(data[..., 0:2], data[..., 2:4], data[..., 4:6], data[..., 6:8], model)

    @classmethod
    def from_dict(cls, params: Dict[str, Tensor], model: str = "pinhole") -> "Camera":
        """From "height"/"width" and one of "f"/"vfov"; optional "cx", "cy",
        "k1", "k2", "dist", "k1_hat", "scales"."""
        h = _f32(params["height"])
        w = _f32(params["width"], h)
        get = lambda key, default: _f32(params.get(key, default), h)
        cx, cy = get("cx", w / 2.0), get("cy", h / 2.0)

        if "f" in params:
            f = _f32(params["f"], h)
        elif "vfov" in params:
            f = fov2focal(_f32(params["vfov"], h), h)
        else:
            raise ValueError("Either 'f' or 'vfov' must be provided.")

        if "dist" in params:
            dist = _f32(params["dist"], h)
            k1 = dist[..., 0]
            k2 = dist[..., 1] if dist.shape[-1] > 1 else torch.zeros_like(k1)
        elif "k1_hat" in params:
            k1 = get("k1_hat", 0.0) * (f / h) ** 2
            k2 = get("k2", torch.zeros_like(k1))
        else:
            k1 = get("k1", torch.zeros_like(f))
            k2 = get("k2", torch.zeros_like(f))

        fx = f
        if "scales" in params:
            scales = _f32(params["scales"], h)
            fx = fx * scales[..., 0] / scales[..., 1]

        t = torch.broadcast_tensors(w, h, fx, f, cx, cy, k1, k2)
        return cls.from_data(torch.stack(t, dim=-1), model=model)

    # ---------------------------------------------------------------- #
    # basic properties
    # ---------------------------------------------------------------- #

    @property
    def data(self) -> Tensor:
        """Packed (..., 8) parameter tensor."""
        return torch.cat([self.size, self.f, self.c, self.k], dim=-1)

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.size.shape[:-1])

    @property
    def num_dist_params(self) -> int:
        return NUM_DIST_PARAMS[self.model]

    @property
    def has_distortion(self) -> bool:
        return self.num_dist_params > 0

    @property
    def vfov(self) -> Tensor:
        return focal2fov(self.f[..., 1], self.size[..., 1])

    @property
    def K(self) -> Tensor:
        """Intrinsic matrix (..., 3, 3)."""
        z = torch.zeros_like(self.f[..., 0])
        o = torch.ones_like(z)
        rows = torch.stack(
            [self.f[..., 0], z, self.c[..., 0], z, self.f[..., 1], self.c[..., 1], z, z, o],
            dim=-1,
        )
        return rows.reshape(self.batch_shape + (3, 3))

    def pinhole(self) -> "Camera":
        """The same camera without distortion."""
        return Camera(self.size, self.f, self.c, torch.zeros_like(self.k), "pinhole")

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)

    def __getitem__(self, idx) -> "Camera":
        return Camera(self.size[idx], self.f[idx], self.c[idx], self.k[idx], self.model)

    # ---------------------------------------------------------------- #
    # parameter updates (LM loop)
    # ---------------------------------------------------------------- #

    def update_focal(self, delta: Tensor, as_log: bool = False) -> "Camera":
        """Shift the focal length (optionally in log space), clamped to FoV ∈ [5°, 150°]."""
        delta = torch.as_tensor(delta, dtype=self.f.dtype, device=self.f.device)
        if delta.ndim == self.f.ndim - 1:
            delta = delta[..., None]
        f = torch.exp(torch.log(self.f) + delta) if as_log else self.f + delta

        h = self.size[..., 1:2]
        min_f = fov2focal(torch.full_like(h, deg2rad(150.0)), h)
        max_f = fov2focal(torch.full_like(h, deg2rad(5.0)), h)
        f = torch.minimum(torch.maximum(f, min_f), max_f)

        fx = f[..., 1] * self.f[..., 0] / self.f[..., 1]
        return self.replace(f=torch.stack([fx, f[..., 1]], dim=-1))

    def update_dist(self, delta: Tensor) -> "Camera":
        """Shift the active distortion parameters, clamped to the model's range."""
        if not self.has_distortion:
            return self
        lo, hi = DIST_RANGE[self.model]
        nk = self.num_dist_params
        delta = torch.as_tensor(delta, dtype=self.k.dtype, device=self.k.device)
        if delta.ndim == self.k.ndim - 1:
            delta = delta[..., None]
        delta_full = torch.nn.functional.pad(delta, (0, 2 - delta.shape[-1]))
        active = torch.arange(2, device=self.k.device) < nk
        k = torch.where(active, torch.clamp(self.k + delta_full, lo, hi), self.k)
        return self.replace(k=k)

    def scale(self, scales) -> "Camera":
        """Rescale after an image resize; scales is a scalar or (..., 2) (sx, sy)."""
        s = torch.as_tensor(scales, dtype=self.f.dtype, device=self.f.device)
        if s.ndim == 0:
            s = torch.stack([s, s], dim=-1)
        return self.replace(size=self.size * s, f=self.f * s, c=self.c * s)

    def crop(self, pad) -> "Camera":
        """Adjust for a symmetric crop/pad of (pad_w, pad_h) pixels."""
        pad = torch.as_tensor(pad, dtype=self.size.dtype, device=self.size.device)
        return self.replace(size=self.size + pad, c=self.c + pad / 2.0)

    def undo_scale_crop(self, data: Dict[str, Tensor]) -> "Camera":
        """Invert the preprocessing scale/crop recorded in `data`."""
        cam = self.crop(-torch.as_tensor(data["crop_pad"])) if "crop_pad" in data else self
        scales = torch.as_tensor(data["scales"], dtype=self.f.dtype, device=self.f.device)
        return cam.scale(1.0 / scales)

    # ---------------------------------------------------------------- #
    # pinhole (un)projection, normalized coordinates
    # ---------------------------------------------------------------- #

    def project(self, p3d: Tensor) -> Tuple[Tensor, Tensor]:
        """Perspective division; returns (p2d, valid: depth above _EPS)."""
        z = p3d[..., -1]
        valid = z > _EPS
        z = torch.clamp(z, min=_EPS)
        return p3d[..., :-1] / z[..., None], valid

    def denormalize(self, p2d: Tensor) -> Tensor:
        """Normalized coordinates → pixels."""
        return p2d * self.f[..., None, :] + self.c[..., None, :]

    def normalize(self, p2d: Tensor) -> Tensor:
        return (p2d - self.c[..., None, :]) / self.f[..., None, :]

    def J_normalize(self, p2d: Tensor, wrt: str = "f") -> Tensor:
        """Jacobian of normalize wrt 'f' or 'pts', (..., N, 2, 2) diagonal."""
        if wrt == "f":
            return torch.diag_embed(-(p2d - self.c[..., None, :]) / self.f[..., None, :] ** 2)
        if wrt == "pts":
            return torch.diag_embed((1.0 / self.f[..., None, :]).expand(p2d.shape))
        raise ValueError(f"Unknown wrt: {wrt}")

    def in_image(self, p2d: Tensor) -> Tensor:
        """Whether pixel coordinates lie in [0, size - 1]."""
        size = self.size[..., None, :]
        return torch.all((p2d >= 0) & (p2d <= size - 1), dim=-1)

    def pixel_coordinates(self, h: int, w: int) -> Tensor:
        """Pixel grid (h*w, 2), x fastest."""
        dev = self.f.device
        x = torch.arange(w, dtype=torch.float32, device=dev)
        y = torch.arange(h, dtype=torch.float32, device=dev)
        yy, xx = torch.meshgrid(y, x, indexing="ij")
        return torch.stack([xx, yy], dim=-1).reshape(-1, 2)

    # ---------------------------------------------------------------- #
    # distortion dispatch
    # ---------------------------------------------------------------- #

    def _k1(self) -> Tensor:
        return self.k[..., None, 0:1]

    def _k2(self) -> Tensor:
        return self.k[..., None, 1:2]

    def distort_scale(self, p2d: Tensor) -> Tensor:
        return _spec(self.model).scale(self._k1(), self._k2(), _r2(p2d))

    def distort(self, p2d: Tensor) -> Tuple[Tensor, Tensor]:
        """Apply the distortion; returns (distorted, valid: all true)."""
        valid = torch.ones(p2d.shape[:-1], dtype=torch.bool, device=p2d.device)
        return p2d * self.distort_scale(p2d), valid

    def undistort(self, p2d: Tensor) -> Tuple[Tensor, Tensor]:
        s = _spec(self.model).undistort_scale(self._k1(), self._k2(), _r2(p2d))
        return p2d * s, torch.ones(p2d.shape[:-1], dtype=torch.bool, device=p2d.device)

    def J_distort(self, p2d: Tensor, wrt: str = "scale2pts") -> Tensor:
        spec = _spec(self.model)
        r2 = _r2(p2d)
        if wrt == "scale2pts":
            return spec.phi(self._k1(), self._k2(), r2) * p2d
        if wrt == "scale2dist":
            cols = spec.ds_dk(self._k1(), self._k2(), r2)
            if not cols:
                return p2d.new_zeros(p2d.shape[:-1] + (0,))
            return torch.cat(cols, dim=-1)
        raise ValueError(f"Unknown wrt: {wrt}")

    def J_undistort(self, p2d: Tensor, wrt: str = "pts") -> Tensor:
        spec = _spec(self.model)
        r2 = _r2(p2d)
        if wrt == "pts":
            su = spec.undistort_scale(self._k1(), self._k2(), r2)
            dsu = spec.dsu_dr2(self._k1(), self._k2(), r2)
            eye = torch.eye(2, dtype=p2d.dtype, device=p2d.device)
            return su[..., None] * eye + 2.0 * dsu[..., None] * _outer(p2d, p2d)
        if wrt == "dist":
            cols = spec.dsu_dk(self._k1(), self._k2(), r2)
            if not cols:
                return p2d.new_zeros(p2d.shape[:-1] + (2, 0))
            return torch.stack([g * p2d for g in cols], dim=-1)
        raise ValueError(f"Unknown wrt: {wrt}")

    def up_projection_offset(self, p2d: Tensor) -> Tensor:
        return self.J_distort(p2d, wrt="scale2pts")

    def J_up_projection_offset(self, p2d: Tensor, wrt: str = "uv") -> Tensor:
        spec = _spec(self.model)
        r2 = _r2(p2d)
        if wrt == "uv":
            phi = spec.phi(self._k1(), self._k2(), r2)
            dphi = spec.dphi_dr2(self._k1(), self._k2(), r2)
            eye = torch.eye(2, dtype=p2d.dtype, device=p2d.device)
            return phi[..., None] * eye + 2.0 * dphi[..., None] * _outer(p2d, p2d)
        if wrt == "dist":
            cols = spec.dphi_dk(self._k1(), self._k2(), r2)
            if not cols:
                return p2d.new_zeros(p2d.shape[:-1] + (2, 0))
            return torch.stack([g * p2d for g in cols], dim=-1)
        raise ValueError(f"Unknown wrt: {wrt}")

    # ---------------------------------------------------------------- #
    # image <-> world
    # ---------------------------------------------------------------- #

    def image2world(self, p2d: Tensor) -> Tuple[Tensor, Tensor]:
        """Pixels → unit-plane rays (..., N, 3)."""
        uv, valid = self.undistort(self.normalize(p2d))
        ones = uv.new_ones(uv.shape[:-1] + (1,))
        return torch.cat([uv, ones], dim=-1), valid

    def J_image2world(self, p2d: Tensor, wrt: str = "f") -> Tensor:
        if wrt == "dist":
            return self.J_undistort(self.normalize(p2d), "dist")
        if wrt == "f":
            J_norm2f = self.J_normalize(p2d, "f")
            J_dist2norm = self.J_undistort(self.normalize(p2d), "pts")
            return J_dist2norm @ J_norm2f
        raise ValueError(f"Unknown wrt: {wrt}")

    def world2image(self, p3d: Tensor) -> Tuple[Tensor, Tensor]:
        """3D points (..., N, 3) → pixels; returns (p2d, valid: in front and in the image)."""
        p2d, visible = self.project(p3d)
        p2d, mask = self.distort(p2d)
        p2d = self.denormalize(p2d)
        return p2d, visible & mask & self.in_image(p2d)

    def pixel_bearing_many(self, p3d: Tensor) -> Tensor:
        norm = torch.linalg.norm(p3d, dim=-1, keepdim=True)
        return p3d / torch.clamp(norm, min=1e-12)

    def undistort_image(self, img: Tensor) -> Tensor:
        """Remove the lens distortion from an image batch (B, h, w, C): each output
        pixel's normalised coordinates are distorted, and the source is sampled there
        bilinearly (the panorama renderer's sampler, as in the JAX package)."""
        from geocalib_tpu_torch.data.pano import _bilinear_sample

        B, h, w = img.shape[:3]
        uv = self.normalize(self.pixel_coordinates(h, w))
        duv, _ = self.distort(uv)
        pts = self.denormalize(duv)  # (B, N, 2)
        out = torch.stack([_bilinear_sample(img[b], pts[b, :, 0], pts[b, :, 1])
                           for b in range(B)])
        return out.reshape(B, h, w, img.shape[-1])


# ---------------------------------------------------------------------- #
# distortion model specs: scalar functions of k1, k2 (..., 1, 1) and r² (..., N, 1)
#   scale s, undistort_scale su, phi with offset = φ·uv, and their derivatives
# ---------------------------------------------------------------------- #


def _r2(p2d: Tensor) -> Tensor:
    return torch.sum(p2d**2, dim=-1, keepdim=True)


def _outer(a: Tensor, b: Tensor) -> Tensor:
    return a[..., :, None] * b[..., None, :]


class _Pinhole:
    num_k = 0

    @staticmethod
    def scale(k1, k2, r2):
        return torch.ones_like(r2)

    @staticmethod
    def undistort_scale(k1, k2, r2):
        return torch.ones_like(r2)

    @staticmethod
    def phi(k1, k2, r2):
        return torch.zeros_like(r2)

    @staticmethod
    def dphi_dr2(k1, k2, r2):
        return torch.zeros_like(r2)

    @staticmethod
    def dphi_dk(k1, k2, r2):
        return ()

    @staticmethod
    def ds_dk(k1, k2, r2):
        return ()

    @staticmethod
    def dsu_dr2(k1, k2, r2):
        return torch.zeros_like(r2)

    @staticmethod
    def dsu_dk(k1, k2, r2):
        return ()


class _SimpleRadial:
    """s = 1 + k1 r²; inverse ≈ 1 - k1 r²."""

    num_k = 1

    @staticmethod
    def scale(k1, k2, r2):
        return 1.0 + k1 * r2

    @staticmethod
    def undistort_scale(k1, k2, r2):
        return 1.0 - k1 * r2

    @staticmethod
    def phi(k1, k2, r2):
        return torch.broadcast_to(2.0 * k1, torch.broadcast_shapes(k1.shape, r2.shape))

    @staticmethod
    def dphi_dr2(k1, k2, r2):
        return torch.zeros_like(r2)

    @staticmethod
    def dphi_dk(k1, k2, r2):
        return (torch.full_like(r2, 2.0),)

    @staticmethod
    def ds_dk(k1, k2, r2):
        return (r2,)

    @staticmethod
    def dsu_dr2(k1, k2, r2):
        return torch.broadcast_to(-k1, torch.broadcast_shapes(k1.shape, r2.shape))

    @staticmethod
    def dsu_dk(k1, k2, r2):
        return (-r2,)


class _Radial:
    """s = 1 + k1 r² + k2 r⁴; inverse ≈ 1 - k1 r² + (3k1² - k2) r⁴."""

    num_k = 2

    @staticmethod
    def scale(k1, k2, r2):
        return 1.0 + r2 * (k1 + k2 * r2)

    @staticmethod
    def undistort_scale(k1, k2, r2):
        return 1.0 + r2 * (-k1 + (3.0 * k1**2 - k2) * r2)

    @staticmethod
    def phi(k1, k2, r2):
        return 2.0 * k1 + 4.0 * k2 * r2

    @staticmethod
    def dphi_dr2(k1, k2, r2):
        return torch.broadcast_to(4.0 * k2, torch.broadcast_shapes(k2.shape, r2.shape))

    @staticmethod
    def dphi_dk(k1, k2, r2):
        return (torch.full_like(r2, 2.0), 4.0 * r2)

    @staticmethod
    def ds_dk(k1, k2, r2):
        return (r2, r2**2)

    @staticmethod
    def dsu_dr2(k1, k2, r2):
        return -k1 + 2.0 * (3.0 * k1**2 - k2) * r2

    @staticmethod
    def dsu_dk(k1, k2, r2):
        return (6.0 * k1 * r2**2 - r2, -(r2**2))


class _SimpleDivisional:
    """Division model: s = (1-√(1-4 k1 r²))/(2 k1 r²); inverse 1/(1+k1 r²).

    Written via the smooth equivalent σ(t) = 2/(1+√(1-4t)) (t = k1 r²), which
    is finite at t = 0, with closed-form σ', σ''. The square root's argument
    is clipped at 1e-6 and a zero undistort denominator is replaced by 1e6.
    """

    num_k = 1

    @staticmethod
    def _q(k1, r2):
        return torch.sqrt(torch.clamp(1.0 - 4.0 * k1 * r2, min=1e-6))

    @classmethod
    def scale(cls, k1, k2, r2):
        return 2.0 / (1.0 + cls._q(k1, r2))

    @staticmethod
    def undistort_scale(k1, k2, r2):
        denom = 1.0 + k1 * r2
        return 1.0 / torch.where(denom == 0, 1e6, denom)

    @classmethod
    def _sigma1(cls, k1, r2):
        """σ'(t) = 4 / (q (1+q)²)."""
        q = cls._q(k1, r2)
        return 4.0 / (q * (1.0 + q) ** 2)

    @classmethod
    def _sigma2(cls, k1, r2):
        """σ''(t) = 8 (1/(q³(1+q)²) + 2/(q²(1+q)³))."""
        q = cls._q(k1, r2)
        return 8.0 * (1.0 / (q**3 * (1.0 + q) ** 2) + 2.0 / (q**2 * (1.0 + q) ** 3))

    @classmethod
    def phi(cls, k1, k2, r2):
        return 2.0 * k1 * cls._sigma1(k1, r2)

    @classmethod
    def dphi_dr2(cls, k1, k2, r2):
        return 2.0 * k1**2 * cls._sigma2(k1, r2)

    @classmethod
    def dphi_dk(cls, k1, k2, r2):
        return (2.0 * cls._sigma1(k1, r2) + 2.0 * k1 * r2 * cls._sigma2(k1, r2),)

    @classmethod
    def ds_dk(cls, k1, k2, r2):
        return (cls._sigma1(k1, r2) * r2,)

    @staticmethod
    def dsu_dr2(k1, k2, r2):
        denom = (1.0 + k1 * r2) ** 2
        return -k1 / torch.where(denom == 0, 1e6, denom)

    @staticmethod
    def dsu_dk(k1, k2, r2):
        denom = (1.0 + k1 * r2) ** 2
        return (-r2 / torch.where(denom == 0, 1e6, denom),)


_DIST_SPECS = {
    "pinhole": _Pinhole,
    "simple_radial": _SimpleRadial,
    "radial": _Radial,
    "simple_divisional": _SimpleDivisional,
}


def _spec(model: str):
    try:
        return _DIST_SPECS[model]
    except KeyError:
        raise ValueError(f"Unknown camera model: {model!r}, expected one of {CAMERA_MODELS}")
