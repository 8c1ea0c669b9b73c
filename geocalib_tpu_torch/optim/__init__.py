"""On-device optimization: the LM solver, RANSAC and the gradient baseline."""

from geocalib_tpu_torch.optim.gradient import GDConfig, GDResult, run_gradient_descent
from geocalib_tpu_torch.optim.lm import LMConfig, LMResult, run_lm
from geocalib_tpu_torch.optim.ransac import RansacConfig, RansacResult, run_ransac

__all__ = [
    "GDConfig",
    "GDResult",
    "run_gradient_descent",
    "LMConfig",
    "LMResult",
    "run_lm",
    "RansacConfig",
    "RansacResult",
    "run_ransac",
]
