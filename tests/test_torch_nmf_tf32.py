"""The float32 NMF kernel's three-product TF32 split, emulated on the CPU.

The kernel's float32 instance (geocalib_tpu_torch/csrc/nmf.cu) takes each
product a b on TF32 tensor cores as lo_a hi_b + hi_a lo_b + hi_a hi_b, with
hi = tf32(a) and lo = tf32(a - hi), tf32 rounding as ``cvt.rna.tf32.f32`` does
it (round to nearest on the float32 bits, ties away from zero, 13 low bits
cleared). Here those products run in plain float32 ``matmul``s inside
``nmf_plain``'s algorithm (``torch.matmul`` patched for the call), and the
result is held against ``nmf_plain`` in float32 within NMF_F32_TOL, the bound
chip_smoke.py holds the kernel to on the card. The emulation splits every product, the kernel all but the norms and
(coef^T coef) bt, so it errs on the side of more error. One TF32 product
alone (hi_a hi_b) must deviate more than the split.
"""

import numpy as np
import pytest
import torch

from geocalib_tpu_torch.ops.nmf import nmf_plain

NMF_F32_TOL = 1e-4  # relative Frobenius error of the float32 reconstruction (chip_smoke.py)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work, as the other CPU test files
    under the parallel test run keep it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tf32(a: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, ties away from zero."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


MATMUL = torch.matmul  # float32 products, as nmf_plain takes them


def split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return MATMUL(a_lo, b_hi) + MATMUL(a_hi, b_lo) + MATMUL(a_hi, b_hi)


def single_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return MATMUL(tf32(a), tf32(b))


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # a tf32 value: 10 mantissa bits
    vals = torch.tensor([1.0 + 2.0 ** -11, one + 2.0 ** -11, 1.0 + 2.0 ** -11 - 2.0 ** -23,
                         -(1.0 + 2.0 ** -11), 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one, one + 2.0 ** -10, 1.0, -one, 3.0, 0.0], dtype=torch.float32)
    assert torch.equal(tf32(vals), want)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=1000).astype(np.float32))
    hi = tf32(x)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF, torch.zeros(1000, dtype=torch.int32))
    assert float(((x - hi).abs() / x.abs()).max()) <= 2.0 ** -11
    lo = tf32(x - hi)
    assert float(((x - hi - lo).abs() / x.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("shape", [(2, 700, 512, 64),  # the per-sample widths of the heads
                                   (2, 300, 121, 15)])  # D, R odd
def test_split_keeps_float32_accuracy(shape, monkeypatch):
    B, N, D, R = shape
    rng = np.random.default_rng(4)
    x = torch.from_numpy(np.maximum(rng.normal(size=(B, N, D)), 0).astype(np.float32))
    bases = torch.from_numpy(rng.uniform(size=(B, D, R)).astype(np.float32))
    ref = torch.matmul(*nmf_plain(x, bases, 7))

    def rel(matmul) -> float:
        with monkeypatch.context() as patch:  # nmf_plain's products taken by `matmul`
            patch.setattr(torch, "matmul", matmul)
            coef, bt = nmf_plain(x, bases, 7)
        out = torch.matmul(coef, bt)
        return float(torch.linalg.norm((out - ref).flatten()) / torch.linalg.norm(ref.flatten()))

    split, single = rel(split_matmul), rel(single_matmul)
    print(f"{shape}: relative Frobenius error against nmf_plain, three-product split "
          f"{split:.3e}, one TF32 product {single:.3e}")
    assert split < NMF_F32_TOL
    assert single > split
