"""Training-metrics writer: a JSONL log of scalars, with TensorBoard and wandb
as optional backends.

Port of geocalib_tpu/utils/summary_writer.py: every ``add_scalars`` call
appends one record {"step", "time", name: value, ...} to
``log_dir/metrics.jsonl``; TensorBoard (``backend="auto"`` or
``"tensorboard"``) and wandb (``backend="wandb"`` or a project name) are used
where they start, as in the JAX writer, and an explicitly asked backend that
does not start raises. ``add_figure`` writes a matplotlib figure to
TensorBoard, or without it a PNG ``log_dir/figures/{tag with / as _}_{step}.png``,
the JAX writer's names; ``add_histogram`` and ``add_text`` go to the backends.
"""

import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch


class SummaryWriter:
    def __init__(self, log_dir, backend: str = "auto", wandb_project: Optional[str] = None):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._tb = None
        self._wandb = None
        if backend in ("auto", "tensorboard"):
            try:
                from torch.utils.tensorboard import SummaryWriter as TB

                self._tb = TB(str(self.log_dir))
            except Exception as e:  # an optional backend must not stop training
                if backend == "tensorboard":
                    raise
                print(f"SummaryWriter: no TensorBoard ({type(e).__name__}: {e})")
        if backend == "wandb" or wandb_project:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=wandb_project or "geocalib_tpu", dir=str(self.log_dir))
            except Exception as e:
                if backend == "wandb":
                    raise
                self._wandb = None
                print(f"SummaryWriter: no wandb ({type(e).__name__}: {e})")
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")

    def add_scalars(self, scalars: Dict[str, float], step: int, prefix: str = "") -> None:
        record = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            name = f"{prefix}{k}"
            value = float(v)
            record[name] = value
            if self._tb is not None:
                self._tb.add_scalar(name, value, step)
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in record.items() if k != "time"}, step=step)
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def add_figure(self, tag: str, fig, step: int) -> None:
        """A matplotlib figure to TensorBoard, or a PNG under log_dir/figures."""
        if self._tb is not None:
            self._tb.add_figure(tag, fig, step)
        else:
            fig_dir = self.log_dir / "figures"
            fig_dir.mkdir(exist_ok=True)
            fig.savefig(fig_dir / f"{tag.replace('/', '_')}_{step}.png", dpi=100)
        if self._wandb is not None:
            self._wandb.log({tag: self._wandb.Image(fig)}, step=step)

    def add_histogram(self, tag: str, values, step: int) -> None:
        arr = values.detach().float().cpu().numpy() if torch.is_tensor(values) else values
        arr = np.asarray(arr).ravel()
        if self._tb is not None:
            self._tb.add_histogram(tag, arr, step)
        if self._wandb is not None:
            self._wandb.log({tag: self._wandb.Histogram(arr)}, step=step)

    def add_text(self, tag: str, text: str, step: int = 0) -> None:
        if self._tb is not None:
            self._tb.add_text(tag, text, step)
        if self._wandb is not None:
            self._wandb.log({tag: text}, step=step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
        self._jsonl.close()
