"""GeoCalib in PyTorch for NVIDIA Hopper, ported from the JAX package geocalib_tpu.

The JAX package is the reference; every module here is held against it in
tests/test_torch_*.py. The two TPU kernels of the serving path are CUDA
kernels for sm_90a in csrc/, built at first use (ops/build.py).
"""

from geocalib_tpu_torch.extractor import GeoCalib

__all__ = ["GeoCalib"]
