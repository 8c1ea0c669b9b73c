"""JAX's threefry2x32 keys and random bits, and ``uniform``, in PyTorch.

The NMF draws its bases from ``jax.random.uniform(key, shape, dtype)``: the
evaluation path from ``PRNGKey(0)`` (geocalib_tpu/models/hamburger.py,
models/fused_heads.py), the training step from a key split off the step's
key (training/train_step.py). Without the same bases the decoder heads
cannot match the reference, so this module reproduces those draws bit for
bit for float32 and bfloat16, following JAX 0.9's partitionable threefry
(``jax_threefry_partitionable=True``): the counter of each element is its
flat row-major index as a 64-bit integer split into two uint32 words, and
``split`` hashes the counters of its output shape the same way.

A key is a pair of Python ints (the two uint32 words of a raw JAX key). The
hash runs on int64 tensors masked to 32 bits, on the device of the output.
"""

from typing import Sequence, Tuple, Union

import numpy as np
import torch

Tensor = torch.Tensor
Key = Tuple[int, int]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_MASK = 0xFFFFFFFF


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2): int64
    tensors holding uint32 values, or Python ints. The key's two words are ints,
    or int64 tensors that broadcast against the counters (one key a row)."""
    k1, k2 = key
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a, b = (x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _MASK
            b = a ^ _rotl(b, r)
        a = (a + ks[(i + 1) % 3]) & _MASK
        b = (b + ks[(i + 2) % 3] + i + 1) & _MASK
    return a, b


def prng_key(seed: int) -> Key:
    """The key of ``jax.random.PRNGKey(seed)`` for a non-negative seed."""
    return (seed >> 32) & _MASK, seed & _MASK


def _counters(n: int, device) -> Tuple[Tensor, Tensor]:
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & _MASK


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(key, num)``: the hash of the counters 0..num-1, in Python
    ints (no tensor, no device)."""
    return tuple(threefry2x32(key, i >> 32, i & _MASK) for i in range(num))


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``: the hash of the
    seed key (0, data), in Python ints."""
    return threefry2x32(key, 0, data & _MASK)


def random_bits(key: Key, bit_width: int, shape: Sequence[int], device="cpu") -> Tensor:
    """``jax.random.bits``'s words under the partitionable threefry, as int64
    holding the low ``bit_width`` bits of the 32-bit hash."""
    a, b = threefry2x32(key, *_counters(int(np.prod(shape)), device))
    return ((a ^ b) & ((1 << bit_width) - 1)).reshape(tuple(shape))


def uniform_tensor(key: Union[int, Key], shape: Sequence[int], dtype: torch.dtype,
                   device="cpu") -> Tensor:
    """``jax.random.uniform(key, shape, dtype)`` in [0, 1), as a tensor of ``dtype``.

    ``key`` is a key pair or, as ``PRNGKey(seed)``, a seed. float32 takes the
    top 23 of 32 random bits as its mantissa; bfloat16 (7 mantissa bits, fewer
    than 8) takes 8-bit random words, the low byte of the hash, and keeps their
    top 7 bits, as JAX's ``_uniform`` does.
    """
    key = prng_key(key) if isinstance(key, int) else key
    if dtype == torch.float32:
        bits = (random_bits(key, 32, shape, device) >> 9) | 0x3F800000
        return bits.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.bfloat16:
        bits = (random_bits(key, 8, shape, device) >> 1) | 0x3F80
        return bits.to(torch.int16).view(torch.bfloat16) - 1.0
    raise ValueError(f"unsupported dtype {dtype}")


def uniform(key: Union[int, Key], shape: Sequence[int], dtype: str = "float32") -> np.ndarray:
    """``uniform_tensor`` on the host as a float32 array; for ``dtype="bfloat16"``
    every value is exactly representable in bfloat16, so converting it loses nothing."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(dtype)
    if dt is None:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return uniform_tensor(key, shape, dt).float().numpy()


def scale_unit(u: Tensor, minval: float, maxval: float) -> Tensor:
    """A float32 [0, 1) draw moved to [minval, maxval) as ``jax.random.uniform``
    moves it: times (maxval - minval), both rounded to float32, plus minval, and at
    least minval. The constants go to the kernels as scalars: no host-to-device
    copy, so no wait for the device."""
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp(u * float(hi - lo) + float(lo), min=float(lo))


def uniform_range(key: Key, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0,
                  device="cpu") -> Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return scale_unit(uniform_tensor(key, shape, torch.float32, device), minval, maxval)


def uniform_rows(keys: Sequence[Key], n: int, device="cpu") -> Tensor:
    """(len(keys), n) float32: row i is ``uniform_tensor(keys[i], (n,), float32)``, all
    rows hashed in one pass (a few hundred launches for any number of keys)."""
    k = torch.tensor(keys, dtype=torch.int64).to(device, non_blocking=True)
    a, b = threefry2x32((k[:, :1], k[:, 1:]), *_counters(n, device))
    return (((a ^ b) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


# XLA's float32 erf_inv (M. Giles, "Approximating the erfinv function"): one
# polynomial in w - 2.5 where w = -log1p(-x²) < 5, another in sqrt(w) - 3.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: Tensor) -> Tensor:
    """float32 inverse error function with XLA's polynomial (``lax.erf_inv``).

    Each Horner step c + p·w is rounded once, as XLA's fused multiply-add rounds
    it (the float32 product is exact in float64). log1p is torch's, within 2
    ulps of XLA's, so the result can differ from XLA's in the last bits.
    """
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    # float32 coefficients, widened exactly
    coef = lambda i: torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i]).to(torch.float32).double()
    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = (coef(i) + p * w).float().double()
    return torch.where(x.abs() == 1.0, x * torch.finfo(x.dtype).max, p.float() * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal_from_unit(u: Tensor) -> Tensor:
    """``jax.random.normal``'s transform of its float32 [0, 1) draw: moved to
    (nextafter(-1, 0), 1), then sqrt(2) · erfinv."""
    return np.float32(np.sqrt(2)).item() * erfinv(scale_unit(u, _NORMAL_LO, 1.0))


def normal(key: Key, shape: Sequence[int], device="cpu") -> Tensor:
    """``jax.random.normal(key, shape)`` in float32."""
    return normal_from_unit(uniform_tensor(key, shape, torch.float32, device))


def randint(key: Key, shape: Sequence[int], minval: int, maxval: int, device="cpu") -> Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) as int64 values: two
    32-bit draws from ``split(key)``, combined modulo the span as uint32 arithmetic."""
    span = max(int(maxval) - int(minval), 1)
    if span >= 1 << 31:
        raise ValueError(f"randint: span {span} is too large")
    k1, k2 = split(key)
    hi, lo = random_bits(k1, 32, shape, device), random_bits(k2, 32, shape, device)
    mult = (2**16 % span) ** 2 % span
    offset = (((hi % span) * mult) & _MASK) + lo % span
    return int(minval) + (offset & _MASK) % span
