"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch twins.

Each wrapper launches its kernel for CUDA tensors and calls the plain
version, in the same module, for CPU tensors. The kernels are compiled from
``geocalib_tpu_torch/csrc`` at first use (ops/build.py).
"""
