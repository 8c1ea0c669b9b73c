"""Training data: the ground-truth cameras and fields of a batch."""

from geocalib_tpu_torch.data.dataset import batch_gt, synthesize_gt_fields

__all__ = ["batch_gt", "synthesize_gt_fields"]
