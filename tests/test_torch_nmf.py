"""NMF bases generator and the NMF kernel's plain version against the JAX package.

threefry: bit for bit. NMF in float32: the plain version matches NMF2D and
the Pallas kernel (interpret mode) to rtol 1e-4 / atol 1e-5 — float32 sums
in other orders, amplified a little by the multiplicative updates. In bf16
every product and elementwise step rounds to 8 bits of mantissa in both
frameworks, at slightly different places, so the comparison is on the
reconstruction's relative Frobenius error, bound 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geocalib_tpu.models.hamburger import NMF2D
from geocalib_tpu.ops.nmf_kernel import nmf_pallas
from geocalib_tpu_torch.models.hamburger import eval_bases
from geocalib_tpu_torch.ops.nmf import nmf, nmf_plain, nmf_reconstruct
from geocalib_tpu_torch.utils.threefry import uniform


def _inputs(B=2, N=256, D=64, R=16, seed=1):
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(size=(B, N, D)), 0).astype(np.float32)
    bases = rng.uniform(size=(B, D, R)).astype(np.float32)
    return x, bases


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("B", [1, 2, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_threefry_bit_exact(B, dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    ref = jax.random.uniform(jax.random.PRNGKey(0), (B, 512, 64), dtype=jdt)
    ours = eval_bases(B, 512, "cpu", getattr(torch, dtype))
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref).astype(np.float32))
    np.testing.assert_array_equal(uniform(0, (B, 512, 64), dtype), np.asarray(ref).astype(np.float32))


@pytest.mark.parametrize("steps", [1, 7])
def test_plain_nmf_matches_jax_f32(steps):
    x, bases = _inputs()
    ref_module = NMF2D(rank=16, eval_steps=steps).apply({}, jnp.asarray(x), bases=jnp.asarray(bases))
    ref_kernel = nmf_pallas(jnp.asarray(x), jnp.asarray(bases), steps=steps, interpret=True)
    out = nmf_reconstruct(torch.from_numpy(x), torch.from_numpy(bases), steps)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_module), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_kernel), rtol=1e-4, atol=1e-5)


def test_plain_nmf_matches_jax_bf16():
    x, bases = _inputs(B=2, N=384, D=120, R=64, seed=2)
    xb, bb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(bases, jnp.bfloat16)
    ref = nmf_pallas(xb, bb, steps=7, interpret=True)
    out = nmf_reconstruct(torch.from_numpy(x).bfloat16(), torch.from_numpy(bases).bfloat16(), 7)
    assert out.dtype == torch.bfloat16
    assert _rel(out.float().numpy(), np.asarray(ref).astype(np.float32)) < 2e-2


def test_plain_nmf_is_per_sample():
    x, bases = _inputs(B=3, N=128, D=32, R=8, seed=3)
    coef, bt = nmf_plain(torch.from_numpy(x), torch.from_numpy(bases), 3)
    for i in range(3):
        c1, b1 = nmf_plain(torch.from_numpy(x[i : i + 1]), torch.from_numpy(bases[i : i + 1]), 3)
        torch.testing.assert_close(c1[0], coef[i], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(b1[0], bt[i], rtol=1e-5, atol=1e-6)


def test_wrapper_uses_plain_on_cpu():
    x, bases = _inputs(B=1, N=64, D=16, R=8)
    before = nmf.launches
    a = nmf(torch.from_numpy(x), torch.from_numpy(bases), 2)
    b = nmf_plain(torch.from_numpy(x), torch.from_numpy(bases), 2)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
    assert nmf.launches == before

