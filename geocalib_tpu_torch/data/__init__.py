"""Data: the CSV dataset and its threaded loader, the variable-size benchmark
dataset, the host and on-device augmentations, the ground-truth cameras and
fields of a batch, and the panorama renderer and dataset generator."""

from geocalib_tpu_torch.data.augmentations import AUGMENTATIONS, get_augmentation
from geocalib_tpu_torch.data.dataset import (DatasetConf, PrefetchLoader, SimpleDataset,
                                             batch_gt, synthesize_gt_fields)
from geocalib_tpu_torch.data.generate import generate_dataset
from geocalib_tpu_torch.data.pano import render_from_pano, synthetic_pano

__all__ = ["AUGMENTATIONS", "get_augmentation", "DatasetConf", "PrefetchLoader", "SimpleDataset",
           "batch_gt", "synthesize_gt_fields", "generate_dataset", "render_from_pano",
           "synthetic_pano"]
