"""Robust cost functions returning (value, first, second) derivatives.

Port of geocalib_tpu/optim/losses.py. Every function takes the squared
residual magnitude x = ||r||².
"""

from typing import Callable, Tuple

import torch

Tensor = torch.Tensor
LossFn = Callable[[Tensor], Tuple[Tensor, Tensor, Tensor]]

_F32_EPS = float(torch.finfo(torch.float32).eps)


def scaled_loss(x: Tensor, fn: LossFn, a: float) -> Tuple[Tensor, Tensor, Tensor]:
    """Apply fn to x pre-scaled by a²: value post-scaled, d2 post-divided."""
    a2 = a**2
    loss, d1, d2 = fn(x / a2)
    return loss * a2, d1, d2 / a2


def squared_loss(x: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    return x, torch.ones_like(x), torch.zeros_like(x)


def huber_loss(x: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    mask = x <= 1.0
    sx = torch.sqrt(x + 1e-8)
    isx = torch.clamp(1.0 / sx, min=_F32_EPS)
    loss = torch.where(mask, x, 2.0 * sx - 1.0)
    d1 = torch.where(mask, torch.ones_like(x), isx)
    d2 = torch.where(mask, torch.zeros_like(x), -isx / (2.0 * torch.clamp(x, min=1e-8)))
    return loss, d1, d2


def barron_loss(x: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Barron's robust loss (CVPR 2019) on x = r² at the solver's alpha = 1, c = 1:
    sqrt(x + 1) - 1 (the only Barron loss ``get_loss_fn`` and the LM kernel use)."""
    base = x + 1.0
    return torch.sqrt(base) - 1.0, 0.5 * base**-0.5, -0.25 * base**-1.5


LOSS_FNS = {
    "squared": squared_loss,
    "huber": huber_loss,
    "barron": barron_loss,
}


def get_loss_fn(name: str) -> LossFn:
    try:
        return LOSS_FNS[name]
    except KeyError:
        raise ValueError(f"Unknown loss {name!r}; expected one of {sorted(LOSS_FNS)}")
