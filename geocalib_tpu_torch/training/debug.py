"""Training debug tools: anomaly detection and the missing-gradient audit.

Port of geocalib_tpu/training/debug.py:

- ``detect_anomaly()`` turns on ``torch.autograd.set_detect_anomaly`` (a
  backward that produces NaN raises with the forward's traceback), and while
  it is on ``check_finite`` raises on the first non-finite loss or gradient:
  the counterpart of JAX's ``jax_debug_nans``/``jax_debug_infs``;
- ``audit_gradients(grads)`` names, as JAX key paths, the parameters whose
  gradient is exactly zero (a disconnected parameter).
"""

import contextlib
from typing import Dict, List

import torch

from geocalib_tpu_torch.models.weights import _entries


@contextlib.contextmanager
def detect_anomaly(check_nan: bool = True):
    """Raise on the first non-finite value of the backward, loss or gradients."""
    with torch.autograd.set_detect_anomaly(True, check_nan=check_nan):
        yield


def check_finite(loss: torch.Tensor, grads: Dict[str, torch.Tensor]) -> None:
    """Under ``detect_anomaly``: raise when the loss or any gradient is not finite."""
    if not torch.is_anomaly_enabled():
        return
    if not bool(torch.isfinite(loss).all()):
        raise FloatingPointError(f"non-finite loss {float(loss)}")
    for k, g in grads.items():
        if not bool(torch.isfinite(g).all()):
            raise FloatingPointError(f"non-finite gradient in {k}")


def audit_gradients(grads: Dict[str, torch.Tensor], variant: str = "b") -> List[str]:
    """``jax.tree_util.keystr`` paths (``['MSCAN_0']['StemConv_0']...``) of the
    gradient leaves, given by GeoCalibNet name, that are identically zero, in
    the order in which JAX flattens the parameter tree."""
    dead = []
    for name, _, path, _ in sorted(_entries(variant), key=lambda e: e[2]):
        g = grads.get(name)
        if g is not None and g.numel() and float(g.abs().max()) == 0.0:
            dead.append("".join(f"[{p!r}]" for p in path))
    return dead
