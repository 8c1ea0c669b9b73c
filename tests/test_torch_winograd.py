"""The port's Winograd F(2x2, 3x3) convolution against the JAX package's, on
the shapes of tests/test_winograd.py.

Same inputs from numpy. float32: within tests/test_winograd.py's 2e-4
(rtol and atol) of JAX's ``winograd_conv3x3`` and of ``F.conv2d``; the
pretransformed kernel gives the same result as transforming inside. bf16
inputs with float32 sums: the matmuls read the same bf16 values in both
packages and differ only in the order of their float32 sums, so the results
agree to one bf16 rounding (2⁻⁸ of the output's largest value), and the bf16
error against the float32 conv stays within test_winograd.py's bound (three
times a bf16 direct conv's, plus 1e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from geocalib_tpu.ops import winograd as jw
from geocalib_tpu_torch.ops import winograd as tw

SHAPES = [(2, 8, 8, 4, 6), (1, 16, 12, 8, 8), (2, 32, 32, 16, 16), (2, 32, 32, 32, 32)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(shape, seed=0):
    B, H, W, C, Fo = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    k = (rng.normal(size=(3, 3, C, Fo)) / 3.0).astype(np.float32)
    b = rng.normal(size=(Fo,)).astype(np.float32)
    return x, k, b


def _conv(x, k, b=None):
    """F.conv2d in NHWC/HWIO, float32."""
    y = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(k).permute(3, 2, 0, 1),
                 None if b is None else torch.from_numpy(b), padding=1)
    return y.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_winograd_f32_matches_jax(shape):
    x, k, b = _inputs(shape)
    got = tw.winograd_conv3x3(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == shape[:3] + shape[4:]
    want = np.asarray(jw.winograd_conv3x3(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), _conv(x, k, b), rtol=2e-4, atol=2e-4)


def test_transform_kernel_and_pretransformed_path():
    x, k, _ = _inputs((2, 32, 32, 16, 16), seed=1)
    u = tw.transform_kernel(torch.from_numpy(k))
    np.testing.assert_allclose(u.numpy(), np.asarray(jw.transform_kernel(jnp.asarray(k))),
                               rtol=1e-6, atol=1e-6)
    pre = tw.winograd_conv3x3(torch.from_numpy(x), None, u=u)
    torch.testing.assert_close(pre, tw.winograd_conv3x3(torch.from_numpy(x), torch.from_numpy(k)),
                               rtol=0, atol=0)
    np.testing.assert_allclose(pre.numpy(), _conv(x, k), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_winograd_bf16_matches_jax(shape):
    x, k, b = _inputs(shape, seed=2)
    got = tw.winograd_conv3x3(torch.from_numpy(x).bfloat16(), torch.from_numpy(k),
                              torch.from_numpy(b), matmul_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = np.asarray(jw.winograd_conv3x3(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(k),
                                          jnp.asarray(b), matmul_dtype=jnp.bfloat16),
                      np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-8 * np.abs(want).max())
    exact = _conv(x, k, b)
    direct = _conv(x.astype(jnp.bfloat16).astype(np.float32),
                   k.astype(jnp.bfloat16).astype(np.float32), b)
    direct = direct.astype(jnp.bfloat16).astype(np.float32)
    scale = np.abs(exact).max()
    err_w, err_d = np.abs(got - exact).max() / scale, np.abs(direct - exact).max() / scale
    assert err_w < 3.0 * err_d + 1e-3, (err_w, err_d)
