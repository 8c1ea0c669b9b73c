"""Hamburger NMF: multiplicative-update factorization of the head tokens.

Port of geocalib_tpu/ops/nmf_kernel.py (``nmf_pallas``). ``nmf`` launches the
CUDA kernels of ``csrc/nmf.cu`` for CUDA tensors and calls ``nmf_plain``, the
same math in plain PyTorch, for CPU tensors. Both return (coef, bt); the
rank-R reconstruction is one batched product (``nmf_reconstruct``). The
kernels have no backward, so on CUDA tensors ``nmf`` refuses inputs that
require grad while grad is enabled.

Two instances, chosen by x's dtype. bf16 (the serving path) runs its products
on bf16 tensor cores (``mma.sync`` m16n8k16) and is bound by the staged
design's 16 reads of x a call. float32 (``GeoCalib(compute_dtype="float32")``,
float32 evaluation and validation) runs the same products on TF32 tensor
cores (``mma.sync`` m16n8k8) at float32 accuracy: each operand a is split
into hi = tf32(a) and lo = tf32(a - hi), and a b is taken as lo_a hi_b +
hi_a lo_b + hi_a hi_b in float32, which keeps ~21 bits of each product (one
TF32 product keeps 11). Its products, three times the operations, and its
stages' copies, splits and barriers bound it more than its bytes do
(csrc/nmf.cu's header; the card's times are in PERF.md).
"""

import math
from typing import Tuple

import torch

from geocalib_tpu_torch.ops import build, refuse_autograd

Tensor = torch.Tensor

DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
MAX_RANK = 64
# Tokens per chunk of the stats stage's partials (B, chunks, R, D + R) float32.
# At request a's N = 8320 (32 samples, D = 512), 1024 gives 9 chunks: 42.5 MB
# of partials a step (80 MB at 512) and 1152 bf16 stats blocks. The chunk
# also sets the order of the coef^T x sums, and the bf16 roundings carry that
# order to calibrate's answers. 1536 and 2048 time a few percent faster
# (tools/nmf_stage_times.py). Under a flat 0.05 degrees they moved one lane of
# request e past chip_smoke.py's serving comparison, as a plain NMF summed in
# float64 did; that comparison now holds each lane to the spread of no-kernel
# controls (chip_smoke.serving_rule), and both chunk sizes must pass it there.
# 1024 is not shown to be more accurate; choose the chunk by timing.
TOKENS_PER_CHUNK = 1024


def nmf_plain(x: Tensor, bases: Tensor, steps: int = 7, inv_t: float = 1.0,
              eps: float = 1e-6) -> Tuple[Tensor, Tensor]:
    """x (B, N, D), raw bases (B, D, R) → coef (B, N, R), bt (B, R, D).

    Every product accumulates in float32 and is rounded to x's dtype; each
    elementwise operation rounds in x's dtype, as nmf_kernel.py does.
    """
    dt = x.dtype

    def dot(a: Tensor, b: Tensor) -> Tensor:
        return torch.matmul(a.float(), b.float()).to(dt)

    bt = bases.transpose(1, 2).to(dt)
    norm = torch.sqrt(torch.sum(bt.float() ** 2, dim=-1, keepdim=True))
    bt = bt / (norm.to(dt) + eps)
    coef = torch.softmax((inv_t * dot(x, bt.transpose(1, 2))).float(), dim=-1).to(dt)

    def update_coef(coef: Tensor, bt: Tensor) -> Tensor:
        numer = dot(x, bt.transpose(1, 2))
        denom = dot(coef, dot(bt, bt.transpose(1, 2)))
        return coef * numer / (denom + eps)

    for _ in range(steps):
        coef = update_coef(coef, bt)
        numer = dot(coef.transpose(1, 2), x)
        denom = dot(dot(coef.transpose(1, 2), coef), bt)
        bt = bt * numer / (denom + eps)
    return update_coef(coef, bt), bt


def nmf(x: Tensor, bases: Tensor, steps: int = 7, inv_t: float = 1.0,
        eps: float = 1e-6) -> Tuple[Tensor, Tensor]:
    """(coef, bt) of the NMF of x (B, N, D) from raw bases (B, D, R).

    CPU tensors go to ``nmf_plain``; CUDA tensors launch the kernels or raise.
    """
    if x.device.type == "cpu":
        return nmf_plain(x, bases, steps, inv_t, eps)
    if x.device.type != "cuda":
        raise ValueError(f"nmf runs on CPU or CUDA tensors, not {x.device}")
    if x.dtype not in DTYPE_IDS:
        raise ValueError(f"nmf takes float32 or bfloat16, not {x.dtype}")
    if x.ndim != 3 or bases.ndim != 3:
        raise ValueError("x must be (B, N, D) and bases (B, D, R)")
    B, N, D = x.shape
    R = bases.shape[2]
    if bases.shape[:2] != (B, D) or bases.dtype != x.dtype or bases.device != x.device:
        raise ValueError(f"bases must be {x.dtype} (B={B}, D={D}, R) on {x.device}, got "
                         f"{bases.dtype} {tuple(bases.shape)} on {bases.device}")
    if R > MAX_RANK:
        raise ValueError(f"rank {R} above the kernel's {MAX_RANK}")
    if not (x.is_contiguous() and bases.is_contiguous()):
        raise ValueError("x and bases must be contiguous")
    refuse_autograd("nmf", x, bases)

    chunks = math.ceil(N / TOKENS_PER_CHUNK)
    coef = torch.empty((B, N, R), dtype=x.dtype, device=x.device)
    bt = torch.empty((B, R, D), dtype=x.dtype, device=x.device)
    # the float32 instance keeps bt and bt bt^T there, split into (hi, lo) pairs
    gram = torch.empty(B * R * (R if x.dtype == torch.bfloat16 else 2 * (D + R)),
                       dtype=torch.float32, device=x.device)
    partial = torch.empty((B, chunks, R, D + R), dtype=torch.float32, device=x.device)
    code = build.lib().gc_nmf(
        DTYPE_IDS[x.dtype], x.data_ptr(), bases.data_ptr(), coef.data_ptr(), bt.data_ptr(),
        gram.data_ptr(), partial.data_ptr(), B, N, D, R, steps, inv_t, eps, TOKENS_PER_CHUNK,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "gc_nmf")
    nmf.launches += 1
    nmf.launches_by_dtype[str(x.dtype).removeprefix("torch.")] += 1
    return coef, bt


nmf.launches = 0
nmf.launches_by_dtype = {"float32": 0, "bfloat16": 0}


def nmf_reconstruct(x: Tensor, bases: Tensor, steps: int = 7, inv_t: float = 1.0,
                    eps: float = 1e-6) -> Tensor:
    """Rank-R reconstruction coef @ bt of x (B, N, D), as ``nmf_pallas`` returns it."""
    coef, bt = nmf(x, bases, steps, inv_t, eps)
    return torch.matmul(coef, bt)
