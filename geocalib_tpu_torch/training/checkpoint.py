"""Experiment checkpoints: save and restore the training state and its conf,
with best tracking and retention.

Port of geocalib_tpu/training/checkpoint.py with the same directory layout
(``checkpoint_{step}/`` holding the state, ``meta.json`` and ``config.yaml``;
``checkpoint_best`` a copy of the best; the newest ``keep_last`` numbered
checkpoints kept) and the port's own state format in place of orbax:
``state.pt``, a ``torch.save`` of a dict of CPU tensors (the step, the
parameters, the BatchNorm running statistics and the AdamState), read back
with ``weights_only=True``.
"""

import json
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import torch

from geocalib_tpu_torch.training.train_step import AdamState, TrainState
from geocalib_tpu_torch.utils.config import save_yaml

STATE_FILE = "state.pt"


def _ckpt_dirs(experiment_dir: Path):
    """Numbered checkpoints only (checkpoint_best is not retained or counted as last)."""
    return sorted((d for d in experiment_dir.glob("checkpoint_*")
                   if d.is_dir() and d.name.split("_")[-1].isdigit()),
                  key=lambda d: int(d.name.split("_")[-1]))


def _cpu(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


def state_dict(state: TrainState) -> Dict[str, Any]:
    """The training state as a dict of CPU tensors."""
    opt = state.opt_state
    return {"step": torch.tensor(int(state.step), dtype=torch.int64),
            "params": _cpu(state.params), "batch_stats": _cpu(state.batch_stats),
            "opt_count": opt.count.detach().cpu().clone(), "mu": _cpu(opt.mu), "nu": _cpu(opt.nu)}


def _placed(saved: Dict[str, torch.Tensor], template: Dict[str, torch.Tensor], what: str
            ) -> Dict[str, torch.Tensor]:
    if set(saved) != set(template):
        raise ValueError(f"checkpoint {what} do not match the template: "
                         f"{sorted(set(saved) ^ set(template))[:4]}")
    out = {}
    for k, t in template.items():
        if saved[k].shape != t.shape or saved[k].dtype != t.dtype:
            raise ValueError(f"checkpoint {what} {k}: {saved[k].dtype}{tuple(saved[k].shape)} "
                             f"against the template's {t.dtype}{tuple(t.shape)}")
        out[k] = saved[k].to(t.device)
    return out


def load_state(saved: Dict[str, Any], template: TrainState) -> TrainState:
    """A TrainState from ``state_dict``'s output, on the template's device."""
    dev = template.opt_state.count.device
    return TrainState(
        step=int(saved["step"]),
        params=_placed(saved["params"], template.params, "parameters"),
        batch_stats=_placed(saved["batch_stats"], template.batch_stats, "statistics"),
        opt_state=AdamState(saved["opt_count"].to(dev),
                            _placed(saved["mu"], template.opt_state.mu, "first moments"),
                            _placed(saved["nu"], template.opt_state.nu, "second moments")))


class ExperimentManager:
    """Owns an experiment directory: checkpoints, config, best tracking."""

    def __init__(self, experiment_dir, keep_last: int = 3):
        self.dir = Path(experiment_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last

    def save(self, state: TrainState, step: int, conf: Optional[Dict[str, Any]] = None,
             eval_results: Optional[Dict[str, float]] = None, is_best: bool = False) -> Path:
        path = self.dir / f"checkpoint_{step}"
        path.mkdir(parents=True, exist_ok=True)
        torch.save(state_dict(state), path / STATE_FILE)
        meta = {"step": int(step), "eval": eval_results or {}}
        (path / "meta.json").write_text(json.dumps(meta, indent=2))
        if conf is not None:
            save_yaml(conf, path / "config.yaml")
        if is_best:
            best = self.dir / "checkpoint_best"
            if best.exists():
                shutil.rmtree(best)
            shutil.copytree(path, best)
        self._retention()
        return path

    def _retention(self) -> None:
        """Delete all but the newest keep_last numbered checkpoints."""
        for d in _ckpt_dirs(self.dir)[: -self.keep_last]:
            shutil.rmtree(d)

    def latest_step(self) -> Optional[int]:
        dirs = _ckpt_dirs(self.dir)
        return int(dirs[-1].name.split("_")[-1]) if dirs else None

    def path(self, which: Union[str, int] = "last") -> Path:
        """The directory of checkpoint "last", "best" or a step number."""
        if which == "last":
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
            return self.dir / f"checkpoint_{step}"
        path = self.dir / ("checkpoint_best" if which == "best" else f"checkpoint_{int(which)}")
        if not path.exists():
            raise FileNotFoundError(f"no checkpoint {which!r} in {self.dir}")
        return path

    def restore(self, template: TrainState, which: Union[str, int] = "last"
                ) -> Tuple[TrainState, int]:
        """(state, step) of checkpoint "last", "best" or a step number, shaped and
        placed as `template`."""
        path = self.path(which)
        saved = torch.load(path / STATE_FILE, map_location="cpu", weights_only=True)
        meta = json.loads((path / "meta.json").read_text())
        return load_state(saved, template), int(meta["step"])
