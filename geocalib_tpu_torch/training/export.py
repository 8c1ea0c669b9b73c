"""Export a training checkpoint as evaluation weights: a Flax msgpack.

Port of geocalib_tpu/training/export.py: the checkpoint's parameters and
running statistics are written as the JAX package's {"params",
"batch_stats"} msgpack (models/weights.py), which ``GeoCalib(weights=...)``,
the port's eval pipelines and the JAX package's ``load_params`` all read. The
template state is built on the CPU: exporting needs no card.

    python -m geocalib_tpu_torch.training.export outputs/training/exp \\
        weights/geocalib_synth.msgpack [--step N | --best]
"""

import argparse
from pathlib import Path

from geocalib_tpu_torch.extractor import save_params
from geocalib_tpu_torch.training.checkpoint import ExperimentManager
from geocalib_tpu_torch.training.train import make_train_config
from geocalib_tpu_torch.training.train_step import create_train_state
from geocalib_tpu_torch.utils.config import load_yaml


def export_checkpoint(experiment_dir, out_path, step=None, best: bool = False) -> int:
    """Write checkpoint `step` (default: the last; ``best``: checkpoint_best) of the
    experiment as a msgpack; returns its step."""
    exp = Path(experiment_dir)
    cfg = make_train_config(load_yaml(exp / "config.yaml"))
    _, template = create_train_state(cfg, device="cpu")
    which = "best" if best else ("last" if step is None else step)
    state, got = ExperimentManager(exp).restore(template, which=which)
    save_params({**state.params, **state.batch_stats}, out_path, cfg.variant)
    return got


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("experiment_dir")
    ap.add_argument("out", help="output .msgpack path")
    ap.add_argument("--step", type=int, default=None, help="checkpoint step (default: latest)")
    ap.add_argument("--best", action="store_true", help="use checkpoint_best")
    args = ap.parse_args(argv)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    step = export_checkpoint(args.experiment_dir, args.out, args.step, args.best)
    print(f"exported step {step} -> {args.out}")


if __name__ == "__main__":
    main()
