"""Winograd F(2x2, 3x3) convolution, NHWC with HWIO kernels.

Port of geocalib_tpu/ops/winograd.py (XLA there, torch operations here):
each 2x2 output tile costs 16 multiplies instead of 36, so a 3x3 conv
becomes 16 batched (tiles x C) @ (C x F) matmuls between the 4x4 input
and output transforms (Lavin & Gray, "Fast Algorithms for Convolutional
Neural Networks", 2015):

    Y = A^T [ (G g G^T) .* (B^T d B) ] A

It is off in serving, as in the JAX package: the port's ``GeoCalibNet``
runs its 3x3 convs as ``F.conv2d``.
"""

import functools
from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor

# F(2x2, 3x3) transform matrices
_BT = np.array([[1, 0, -1, 0], [0, 1, 1, 0], [0, -1, 1, 0], [0, 1, 0, -1]], np.float32)
_G = np.array([[1, 0, 0], [0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0, 0, 1]], np.float32)
_AT = np.array([[1, 1, 1, 0], [0, 1, -1, -1]], np.float32)
_MATRICES = {"BT": _BT, "G": _G, "AT": _AT}


@functools.lru_cache(maxsize=None)
def _matrix(name: str, device: torch.device, dtype: torch.dtype) -> Tensor:
    """A transform matrix on the device, made once (so that a call can be captured
    in a CUDA graph after the first)."""
    return torch.as_tensor(_MATRICES[name], device=device).to(dtype)


def transform_kernel(k: Tensor) -> Tensor:
    """g (3, 3, C, F) → U (4, 4, C, F) = G g Gᵀ, in float32."""
    G = _matrix("G", k.device, torch.float32)
    return torch.einsum("ij,jkcf,lk->ilcf", G, k.float(), G)


def winograd_conv3x3(x: Tensor, k: Optional[Tensor], b: Optional[Tensor] = None,
                     u: Optional[Tensor] = None,
                     matmul_dtype: Optional[torch.dtype] = None) -> Tensor:
    """3x3 same-padding stride-1 conv via Winograd F(2x2, 3x3), NHWC.

    x: (B, H, W, C) with H and W even. k: (3, 3, C, F), or None with u, the
    kernel already transformed (``transform_kernel(k)``, hoisted out of a
    serving step). matmul_dtype: the dtype the batched matmuls read (default
    x.dtype); they accumulate in float32. The input transform runs in x.dtype,
    the output transform in float32, and the result is cast to x.dtype.
    """
    B, H, W, C = x.shape
    assert H % 2 == 0 and W % 2 == 0, (H, W)
    if u is None:
        u = transform_kernel(k)
    F = u.shape[-1]
    md = matmul_dtype or x.dtype

    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    # overlapping 4x4 patches at stride 2: patch row r of the tiles is rows r, r+2, ...
    TH, TW = H // 2, W // 2
    rows = torch.stack([xp[:, r:H - 1 + r:2] for r in range(4)], dim=1)  # (B, 4, TH, W+2, C)
    patches = torch.stack([rows[:, :, :, c:W - 1 + c:2] for c in range(4)], dim=3)
    d = patches.permute(0, 2, 4, 1, 3, 5)  # (B, TH, TW, 4, 4, C)

    # V = Bᵀ d B
    bt = _matrix("BT", x.device, x.dtype)
    v = torch.einsum("ij,bhwjkc->bhwikc", bt, d)
    v = torch.einsum("bhwikc,lk->bhwilc", v, bt)

    # 16 batched (P, C) @ (C, F) matmuls: md inputs, float32 sums
    P = B * TH * TW
    v = v.reshape(P, 16, C).transpose(0, 1).to(md).float()
    m = torch.bmm(v, u.reshape(16, C, F).to(md).float())

    # Y = Aᵀ m A
    at = _matrix("AT", x.device, torch.float32)
    m = m.transpose(0, 1).reshape(B, TH, TW, 4, 4, F)
    y = torch.einsum("ij,bhwjkf->bhwikf", at, m)
    y = torch.einsum("bhwikf,lk->bhwilf", y, at)  # (B, TH, TW, 2, 2, F)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, F).to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y
