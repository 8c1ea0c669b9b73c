"""Data: the CSV dataset and its threaded loader, the variable-size benchmark
dataset, the host and on-device augmentations, and the ground-truth cameras
and fields of a batch."""

from geocalib_tpu_torch.data.dataset import (DatasetConf, PrefetchLoader, SimpleDataset,
                                             batch_gt, synthesize_gt_fields)

__all__ = ["DatasetConf", "PrefetchLoader", "SimpleDataset", "batch_gt", "synthesize_gt_fields"]
