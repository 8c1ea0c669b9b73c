"""Metric accumulators, the AUC of an error-recall curve and the summaries of
an evaluation, in numpy on the host.

Port of geocalib_tpu/utils/tools.py, kept as its own copy (the port imports
nothing of the JAX package), with the same rounding. ``np.trapezoid`` needs
numpy 2.0 or later.
"""

from typing import Dict, List, Optional, Sequence

import numpy as np


class AverageMetric:
    def __init__(self):
        self._sum = 0.0
        self._num = 0

    def update(self, values) -> None:
        arr = np.asarray(values, np.float64).ravel()
        arr = arr[~np.isnan(arr)]
        self._sum += float(arr.sum())
        self._num += arr.size

    def compute(self) -> float:
        return self._sum / self._num if self._num else float("nan")


class MedianMetric:
    def __init__(self):
        self._elements: List[float] = []

    def update(self, values) -> None:
        self._elements += np.asarray(values, np.float64).ravel().tolist()

    def compute(self) -> float:
        if not self._elements:
            return float("nan")
        return float(np.nanmedian(self._elements))


class QuantileMetric:
    def __init__(self, q: float = 0.05):
        self.q = q
        self._elements: List[float] = []

    def update(self, values) -> None:
        self._elements += np.asarray(values, np.float64).ravel().tolist()

    def compute(self) -> float:
        if not self._elements:
            return float("nan")
        return float(np.nanquantile(self._elements, self.q))


class RecallMetric:
    def __init__(self, ths: Sequence[float]):
        self.ths = list(ths)
        self._elements: List[float] = []

    def update(self, values) -> None:
        self._elements += np.asarray(values, np.float64).ravel().tolist()

    def compute(self) -> List[float]:
        arr = np.asarray(self._elements)
        if arr.size == 0:
            return [float("nan")] * len(self.ths)
        return [float((arr <= th).mean()) for th in self.ths]


def compute_auc(
    errors, thresholds: Sequence[float], min_error: Optional[float] = None
) -> List[float]:
    """AUC of the error-recall curve at the given thresholds, rounded to 4 digits.

    With min_error, errors up to it count as 0 (the headline numbers use 1).
    """
    errors = np.sort(np.asarray(errors, np.float64))
    recall = (np.arange(len(errors)) + 1) / len(errors)

    if min_error is not None:
        min_index = int(np.searchsorted(errors, min_error, side="right"))
        min_score = min_index / len(errors)
        recall = np.r_[min_score, min_score, recall[min_index:]]
        errors = np.r_[0, min_error, errors[min_index:]]
    else:
        recall = np.r_[0, recall]
        errors = np.r_[0, errors]

    aucs = []
    for t in thresholds:
        last_index = int(np.searchsorted(errors, t, side="right"))
        r = np.r_[recall[:last_index], recall[last_index - 1]]
        e = np.r_[errors[:last_index], t]
        aucs.append(float(np.round(np.trapezoid(r, x=e) / t, 4)))
    return aucs


class AUCMetric:
    def __init__(
        self,
        thresholds: Sequence[float],
        elements=None,
        min_error: Optional[float] = None,
    ):
        self.thresholds = list(thresholds)
        self.min_error = min_error
        self._elements: List[float] = (
            list(np.asarray(elements).ravel()) if elements is not None else []
        )

    def update(self, values) -> None:
        self._elements += np.asarray(values, np.float64).ravel().tolist()

    def compute(self) -> List[float]:
        if not self._elements:
            return [float("nan")] * len(self.thresholds)
        arr = np.asarray(self._elements)
        arr[np.isnan(arr)] = np.inf
        return compute_auc(arr, self.thresholds, self.min_error)


def summarize_results(
    results: Dict[str, np.ndarray],
    thresholds: Sequence[float] = (1.0, 5.0, 10.0),
) -> Dict[str, float]:
    """mean/median (3 digits) of the *_error, recall and pixel keys, and
    AUC@thresholds with min_error=1 for the roll, pitch, vfov and gravity ones."""
    summaries: Dict[str, float] = {}
    for k, v in results.items():
        arr = np.asarray(v)
        if not np.issubdtype(arr.dtype, np.number):
            continue
        if k.endswith("_error") or "recall" in k or "pixel" in k:
            summaries[f"mean_{k}"] = round(float(np.nanmean(arr)), 3)
            summaries[f"median_{k}"] = round(float(np.nanmedian(arr)), 3)
            if any(key in k for key in ("roll", "pitch", "vfov", "gravity")):
                auc = AUCMetric(thresholds, elements=arr, min_error=1).compute()
                for i, t in enumerate(thresholds):
                    summaries[f"auc_{k}@{t:g}"] = round(auc[i], 3)
    return summaries
