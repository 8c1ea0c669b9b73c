"""JAX's threefry2x32 random bits and ``uniform``, in numpy.

The evaluation NMF draws its bases from
``jax.random.uniform(jax.random.PRNGKey(seed), shape, dtype)``
(geocalib_tpu/models/hamburger.py, models/fused_heads.py). Without the same
bases the decoder heads cannot match the reference, so this module
reproduces that draw bit for bit for float32 and bfloat16, following JAX
0.9's partitionable threefry (``jax_threefry_partitionable=True``): the
counter of each element is its flat row-major index as a 64-bit integer
split into two uint32 words.
"""

from typing import Sequence, Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1: int, k2: int, x1: np.ndarray, x2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)."""
    ks = [np.uint32(k1), np.uint32(k2), np.uint32(k1) ^ np.uint32(k2) ^ np.uint32(0x1BD11BDA)]
    x = [x1.astype(np.uint32) + ks[0], x2.astype(np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r)
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> Tuple[int, int]:
    """The key of ``jax.random.PRNGKey(seed)`` for a non-negative seed."""
    return (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF


def random_bits(key: Tuple[int, int], bit_width: int, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits`` under the partitionable threefry, as uint8/16/32."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    dtype = {8: np.uint8, 16: np.uint16, 32: np.uint32}[bit_width]
    return (b1 ^ b2).astype(dtype).reshape(tuple(shape))


def uniform(seed: int, shape: Sequence[int], dtype: str = "float32") -> np.ndarray:
    """``jax.random.uniform(PRNGKey(seed), shape, dtype)`` in [0, 1).

    Returned as float32; for ``dtype="bfloat16"`` every value is exactly
    representable in bfloat16, so converting it loses nothing.
    """
    key = prng_key(seed)
    if dtype == "float32":  # 23 mantissa bits from 32 random bits
        bits = random_bits(key, 32, shape)
        return ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    if dtype == "bfloat16":  # 7 mantissa bits from 8 random bits
        bits = random_bits(key, 8, shape).astype(np.uint16)
        return (bits >> np.uint16(1)).astype(np.float32) / np.float32(128.0)
    raise ValueError(f"unsupported dtype {dtype!r}")
