"""One-line model loading from the released GeoCalib checkpoints.

Port of geocalib_tpu/hub.py: a release name (``pinhole``, ``distorted``)
or a local original ``.tar`` checkpoint is converted once to the JAX
package's Flax msgpack (``models/convert_torch.py``), cached under
``GEOCALIB_TPU_CACHE`` (default ``~/.cache/geocalib_tpu``) with the JAX
hub's file names, so both packages share one cache, and loaded into the
port's ``GeoCalib``.

    from geocalib_tpu_torch.hub import load
    calib = load("pinhole")          # or "distorted", or a local .tar/.msgpack
    result = calib.calibrate(image)

A release name is downloaded only when neither its ``.tar`` nor its
converted ``.msgpack`` is in the cache; without network access, put the
tar there (or pass its path).
"""

import os
from pathlib import Path
from typing import Any

RELEASE_URL = "https://github.com/cvg/GeoCalib/releases/download/v1.0/geocalib-{name}.tar"
RELEASED = ("pinhole", "distorted")

__all__ = ["load", "cached_params_path"]


def _cache_dir() -> Path:
    root = Path(os.environ.get("GEOCALIB_TPU_CACHE", Path.home() / ".cache" / "geocalib_tpu"))
    root.mkdir(parents=True, exist_ok=True)
    return root


def _download(url: str, dest: Path) -> Path:
    import shutil
    import urllib.request

    print(f"downloading {url} ...")
    try:
        with urllib.request.urlopen(url, timeout=120) as resp, open(dest, "wb") as fh:
            shutil.copyfileobj(resp, fh)
    except Exception as e:
        dest.unlink(missing_ok=True)
        raise RuntimeError(
            f"could not download {url} ({e}); fetch the tar manually and pass its path"
        ) from e
    return dest


def cached_params_path(weights: str = "pinhole") -> Path:
    """The converted params of a release name or a local tar, converting (and,
    for a release name with nothing cached, downloading) on first use."""
    if weights in RELEASED:
        tar = _cache_dir() / f"geocalib-{weights}.tar"
        out = _cache_dir() / f"geocalib-{weights}.msgpack"
        if not tar.exists() and not out.exists():
            _download(RELEASE_URL.format(name=weights), tar)
    else:
        tar = Path(weights)
        if not tar.exists():
            raise FileNotFoundError(f"weights {weights!r} is neither a release name nor a file")
        out = _cache_dir() / (tar.stem + ".msgpack")

    if not out.exists():
        from geocalib_tpu_torch.models import convert_torch
        from geocalib_tpu_torch.models.weights import write_flax_msgpack

        sd = convert_torch.load_torch_checkpoint(str(tar))
        write_flax_msgpack(convert_torch.convert_state_dict(sd), out)
        print(f"converted {tar.name} → {out}")
    return out


def load(weights: str = "pinhole", **kw: Any):
    """A ready ``GeoCalib`` (on the card unless ``device="cpu"``).

    weights: "pinhole" | "distorted" | the path of an original .tar or of a
    converted .msgpack. Other keywords go to ``geocalib_tpu_torch.GeoCalib``.
    """
    from geocalib_tpu_torch.extractor import GeoCalib

    path = Path(weights)
    if path.suffix == ".msgpack" and path.exists():
        return GeoCalib(weights=path, **kw)
    return GeoCalib(weights=cached_params_path(weights), **kw)
