"""CacheLoader: replay cached h5 predictions as model outputs.

Port of geocalib_tpu/models/cache_loader.py: reads the per-image groups that
``export_predictions`` (and the eval pipeline's ``cache_fields``) write, to
re-run metrics without inference. h5py is imported inside the functions:
the machine with the card has none.
"""

from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np


class CacheLoader:
    """Read per-image prediction groups from an h5 export."""

    def __init__(self, path: Union[str, Path], keys: Optional[List[str]] = None):
        import h5py

        self.path = Path(path)
        self._file = h5py.File(self.path, "r")
        self.keys = keys

    def names(self) -> List[str]:
        """All prediction-group names, nested ones included: an image name with a
        "/" becomes a nested h5 group, which a plain keys() would not list."""
        import h5py

        found: List[str] = []

        def visit(name, obj):
            if isinstance(obj, h5py.Group) and any(
                    isinstance(child, h5py.Dataset) for child in obj.values()):
                found.append(name)

        self._file.visititems(visit)
        return found

    def __call__(self, name: str) -> Dict[str, np.ndarray]:
        group = self._file[name]
        keys = self.keys or list(group.keys())
        return {k: np.asarray(group[k]) for k in keys}

    def close(self) -> None:
        self._file.close()


def export_predictions(path: Union[str, Path],
                       predictions: Dict[str, Dict[str, np.ndarray]]) -> None:
    """Write {image_name: {key: array}} as per-image h5 groups."""
    import h5py

    with h5py.File(path, "w") as fh:
        for name, pred in predictions.items():
            group = fh.create_group(name)
            for k, v in pred.items():
                group.create_dataset(k, data=np.asarray(v))
