"""Gravity-align MegaDepth COLMAP reconstructions (benchmark ground truth).

Port of geocalib_tpu/data/align_megadepth.py: runs `colmap
model_orientation_aligner` over each scene's sparse model so that the world
axes follow gravity, the step that gives MegaDepth2k its ground-truth roll
and pitch. Needs a `colmap` binary on PATH, and raises with a clear message
without one.

CLI:
    python -m geocalib_tpu_torch.data.align_megadepth \
        --base_dir Undistorted_SfM --out_dir megadepth_aligned
"""

import argparse
import shutil
import subprocess
from pathlib import Path

__all__ = ["align_scene", "main"]


def align_scene(image_dir: Path, sparse_dir: Path, out_dir: Path, max_image_size: int = 1024) -> None:
    colmap = shutil.which("colmap")
    if colmap is None:
        raise RuntimeError(
            "colmap not found on PATH; install COLMAP to align MegaDepth scenes "
            "(https://colmap.github.io)"
        )
    out_dir.mkdir(parents=True, exist_ok=True)
    subprocess.run(
        [
            colmap,
            "model_orientation_aligner",
            "--image_path", str(image_dir),
            "--input_path", str(sparse_dir),
            "--output_path", str(out_dir),
            "--max_image_size", str(max_image_size),
        ],
        check=True,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--base_dir", required=True, help="MegaDepth Undistorted_SfM root")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--max_image_size", type=int, default=1024)
    args = ap.parse_args(argv)

    base, out = Path(args.base_dir), Path(args.out_dir)
    scenes = sorted(p.name for p in base.iterdir() if p.is_dir())
    print(f"aligning {len(scenes)} scenes")
    for scene in scenes:
        image_dir = base / scene / "images"
        sparse_dir = base / scene / "sparse"
        if not sparse_dir.exists():
            print(f"skipping {scene} (no sparse model)")
            continue
        align_scene(image_dir, sparse_dir, out / scene / "sparse", args.max_image_size)
        print(f"aligned {scene}")


if __name__ == "__main__":
    main()
