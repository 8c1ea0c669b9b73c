"""LM solver: losses, small linear algebra, the optimization loop."""

from geocalib_tpu_torch.optim.lm import LMConfig, LMResult, run_lm

__all__ = ["LMConfig", "LMResult", "run_lm"]
