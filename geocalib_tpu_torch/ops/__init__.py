"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch twins.

Each wrapper launches its kernel for CUDA tensors and calls the plain
version, in the same module, for CPU tensors. The kernels are compiled from
``geocalib_tpu_torch/csrc`` at first use (ops/build.py).
"""

import torch


def refuse_autograd(what: str, *inputs) -> None:
    """Raise when grad is enabled and an input requires grad: the kernels have
    no backward, and their outputs would silently carry no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward yet, so it cannot run on inputs that "
            f"require grad; call it under torch.no_grad() or torch.inference_mode(), or on "
            f"CPU tensors, where the plain version is differentiable")
