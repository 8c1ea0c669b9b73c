"""OpenPano panorama download and merge.

Port of geocalib_tpu/data/download.py: fetch the PolyHaven/HDRMaps pano zip,
then merge the per-split pano lists into one flat `panos/` directory, the
input of `geocalib_tpu_torch.data.generate --pano_dir`. Laval HDR panoramas
(license-gated, downloaded by hand) are merged from a local directory after
tonemapping (`geocalib_tpu_torch.data.tonemapping`).

The network is optional: where there is none, pass `--pano_zip` with an
archive fetched by hand; a failed download raises and says so.

CLI:
    python -m geocalib_tpu_torch.data.download --out_dir data/openpano \
        [--pano_zip openpano.zip] [--laval_dir tonemapped_laval/]
"""

import argparse
import shutil
import zipfile
from pathlib import Path
from typing import Optional

OPENPANO_URL = "https://cvg-data.inf.ethz.ch/GeoCalib_ECCV2024/openpano.zip"

__all__ = ["download_openpano", "merge_split_panos", "main"]


def _fetch(url: str, dest: Path) -> Path:
    import urllib.request

    dest.parent.mkdir(parents=True, exist_ok=True)
    print(f"downloading {url} ...")
    try:
        with urllib.request.urlopen(url, timeout=120) as resp, open(dest, "wb") as fh:
            shutil.copyfileobj(resp, fh)
    except Exception as e:  # no network
        raise RuntimeError(
            f"could not download {url} ({e}); fetch it manually and pass --pano_zip"
        ) from e
    return dest


def merge_split_panos(root: Path, laval_dir: Optional[Path] = None) -> int:
    """Flatten per-split pano name lists into {root}/panos; returns count."""
    pano_dir = root / "panos"
    pano_dir.mkdir(parents=True, exist_ok=True)
    sources = [p for p in root.rglob("*") if p.suffix.lower() in (".jpg", ".jpeg", ".png")]
    if laval_dir is not None:
        sources += [
            p
            for p in Path(laval_dir).iterdir()
            if p.suffix.lower() in (".jpg", ".jpeg", ".png")
        ]
    n = 0
    for src in sources:
        dst = pano_dir / src.name
        if dst.exists() or src.parent == pano_dir:
            continue
        shutil.copy2(src, dst)
        n += 1
    return n


def download_openpano(
    out_dir: str,
    pano_zip: Optional[str] = None,
    laval_dir: Optional[str] = None,
    url: str = OPENPANO_URL,
) -> Path:
    """Ensure {out_dir}/panos exists and is populated; returns that path."""
    root = Path(out_dir)
    pano_dir = root / "panos"
    if pano_dir.exists() and any(pano_dir.iterdir()):
        return pano_dir

    archive = Path(pano_zip) if pano_zip else _fetch(url, root / "openpano.zip")
    with zipfile.ZipFile(archive) as zf:
        zf.extractall(root)
    n = merge_split_panos(root, Path(laval_dir) if laval_dir else None)
    print(f"merged {n} panoramas → {pano_dir}")
    return pano_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out_dir", default="data/openpano")
    ap.add_argument("--pano_zip", default=None, help="pre-fetched openpano.zip")
    ap.add_argument("--laval_dir", default=None, help="tonemapped Laval panos to merge")
    args = ap.parse_args(argv)
    download_openpano(args.out_dir, args.pano_zip, args.laval_dir)


if __name__ == "__main__":
    main()
