"""Data: the CSV dataset, the variable-size benchmark dataset, and the
ground-truth cameras and fields of a batch."""

from geocalib_tpu_torch.data.dataset import (DatasetConf, SimpleDataset, batch_gt,
                                             synthesize_gt_fields)

__all__ = ["DatasetConf", "SimpleDataset", "batch_gt", "synthesize_gt_fields"]
