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


def threefry2x32(key: Key, x1: Tensor, x2: Tensor) -> Tuple[Tensor, Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2), int64
    tensors holding uint32 values."""
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
    """``jax.random.split(key, num)``: the hash of the counters 0..num-1."""
    a, b = threefry2x32(key, *_counters(num, "cpu"))
    return tuple((int(x), int(y)) for x, y in zip(a, b))


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``: the hash of the
    seed key (0, data)."""
    a, b = threefry2x32(key, torch.zeros(1, dtype=torch.int64),
                        torch.tensor([data & _MASK], dtype=torch.int64))
    return int(a[0]), int(b[0])


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
