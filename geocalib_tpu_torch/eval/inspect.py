"""Eval inspector: a scatter of per-image metrics, with click-through.

Port of geocalib_tpu/eval/inspect.py: one matplotlib window with a scatter
of two per-image metrics across one or more experiments (the
``results.h5`` that ``eval/pipeline.py run()`` writes); clicking a point
opens a per-image frame with the image, the predicted up and latitude
fields from the prediction cache (``predictions.h5``, written with
``cache_fields``) and the metrics. ``--save out.png`` renders the scatter
headless. h5py and matplotlib are imported inside the functions that use
them.

CLI:
    python -m geocalib_tpu_torch.eval.inspect outputs/results/lamar2k \
        [outputs/results/other_exp ...] \
        --x roll_error --y pitch_error [--images data/lamar2k/images]
"""

import argparse
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

__all__ = ["ExperimentResults", "GlobalFrame", "ImageFrame", "main"]


class ExperimentResults:
    """Per-image metric arrays + optional prediction cache of one eval run."""

    def __init__(self, experiment_dir: str):
        import h5py

        self.dir = Path(experiment_dir)
        self.name = self.dir.name
        self.metrics: Dict[str, np.ndarray] = {}
        with h5py.File(self.dir / "results.h5", "r") as fh:
            for k in fh.keys():
                v = np.asarray(fh[k])
                if k == "names":
                    self.names = [n.decode() for n in v]
                elif v.ndim == 1:
                    self.metrics[k] = v.astype(np.float64)
        if not hasattr(self, "names"):
            n = len(next(iter(self.metrics.values())))
            self.names = [f"image_{i}" for i in range(n)]
        self._cache = None
        if (self.dir / "predictions.h5").exists():
            from geocalib_tpu_torch.models.cache_loader import CacheLoader

            self._cache = CacheLoader(self.dir / "predictions.h5")

    def metric_keys(self) -> List[str]:
        return sorted(self.metrics)

    def prediction(self, name: str) -> Optional[Dict[str, np.ndarray]]:
        if self._cache is None or name not in self._cache.names():
            return None
        return self._cache(name)


class ImageFrame:
    """Per-image detail view: image + cached fields + metric readout."""

    def __init__(self, results: ExperimentResults, index: int, image_dir: Optional[str]):
        self.results = results
        self.index = index
        self.image_dir = Path(image_dir) if image_dir else None

    def show(self):
        import matplotlib.pyplot as plt

        name = self.results.names[self.index]
        pred = self.results.prediction(name)
        img = None
        if self.image_dir is not None and (self.image_dir / name).exists():
            from geocalib_tpu_torch.utils.image import load_image

            img = load_image(self.image_dir / name).numpy()

        n_panels = 1 + (2 if pred is not None else 0)
        fig, axs = plt.subplots(1, n_panels, figsize=(4 * n_panels, 4), squeeze=False)
        axs = axs[0]
        ax = axs[0]
        if img is not None:
            ax.imshow(img)
        ax.set_title(name, fontsize=8)
        ax.axis("off")

        if pred is not None:
            from geocalib_tpu_torch.visualization.viz2d import plot_latitudes, plot_vector_fields

            up = pred["up_field"]
            lat = pred["latitude_field"]
            for a in axs[1:]:
                if img is not None:
                    a.imshow(img)
                a.axis("off")
            plot_vector_fields([axs[1]], [up])
            axs[1].set_title("up field", fontsize=8)
            plot_latitudes([axs[2]], [lat[..., 0] if lat.ndim == 3 else lat])
            axs[2].set_title("latitude", fontsize=8)

        lines = [
            f"{k}: {self.results.metrics[k][self.index]:.3f}"
            for k in self.results.metric_keys()
        ]
        fig.suptitle(" | ".join(lines[:6]), fontsize=7)
        fig.tight_layout()
        return fig


class GlobalFrame:
    """Scatter of metric x vs metric y across experiments; click opens detail."""

    def __init__(
        self,
        experiments: List[ExperimentResults],
        x: str,
        y: str,
        image_dir: Optional[str] = None,
    ):
        self.experiments = experiments
        self.x, self.y = x, y
        self.image_dir = image_dir
        self._artists = {}

    def draw(self):
        import matplotlib.pyplot as plt

        self.fig, self.ax = plt.subplots(figsize=(7, 6))
        for exp in self.experiments:
            if self.x not in exp.metrics or self.y not in exp.metrics:
                continue
            sc = self.ax.scatter(
                exp.metrics[self.x], exp.metrics[self.y], s=12, alpha=0.6,
                label=exp.name, picker=5,
            )
            self._artists[sc] = exp
        self.ax.set_xlabel(self.x)
        self.ax.set_ylabel(self.y)
        self.ax.legend(fontsize=8)
        self.ax.set_title("click a point for the per-image view", fontsize=9)
        self.fig.canvas.mpl_connect("pick_event", self._on_pick)
        return self.fig

    def _on_pick(self, event):
        import matplotlib.pyplot as plt

        exp = self._artists.get(event.artist)
        if exp is None or len(event.ind) == 0:
            return
        ImageFrame(exp, int(event.ind[0]), self.image_dir).show()
        plt.show(block=False)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("experiments", nargs="+", help="experiment result dirs (results.h5)")
    ap.add_argument("--x", default="roll_error")
    ap.add_argument("--y", default="pitch_error")
    ap.add_argument("--images", default=None, help="benchmark images/ dir for detail views")
    ap.add_argument("--save", default=None, help="render scatter to a file (headless)")
    args = ap.parse_args(argv)

    if args.save:
        import matplotlib

        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    exps = [ExperimentResults(d) for d in args.experiments]
    keys = exps[0].metric_keys()
    for axis in (args.x, args.y):
        if axis not in keys:
            raise SystemExit(f"metric {axis!r} not in results; available: {keys}")
    frame = GlobalFrame(exps, args.x, args.y, image_dir=args.images)
    fig = frame.draw()
    if args.save:
        fig.savefig(args.save, dpi=120, bbox_inches="tight")
        print(f"saved {args.save}")
    else:
        plt.show()


if __name__ == "__main__":
    main()
