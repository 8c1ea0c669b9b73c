"""Profiling and timing helpers.

Port of geocalib_tpu/utils/profiling.py: ``trace`` records the enclosed block
with torch.profiler (host and, on a card, device activity) and writes a Chrome
trace (open it in ui.perfetto.dev or chrome://tracing); ``benchmark_fn`` and
``Timer`` are wall timers that wait for the card (``torch.cuda.synchronize``)
where the JAX package fetches a result to the host.
"""

import contextlib
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str = "outputs/torch_trace", name: str = "trace.json"):
    """Profile the enclosed block; yields the path of the Chrome trace written at its end."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path = Path(log_dir) / name
    path.parent.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield path
        _sync()
    prof.export_chrome_trace(str(path))


def _sync() -> None:
    """Wait for the card's queued work, where there is a card in use."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def benchmark_fn(fn: Callable, *args, iters: int = 10, warmup: int = 1,
                 label: str = "fn") -> Dict[str, float]:
    """Wall time of fn(*args), each call waited for: {label, mean_ms, p50_ms, min_ms, iters}."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append((time.perf_counter() - t0) * 1000.0)
    times = np.asarray(times)
    return {"label": label, "mean_ms": float(times.mean()), "p50_ms": float(np.median(times)),
            "min_ms": float(times.min()), "iters": iters}


class Timer:
    """``with Timer("step") as t: ...``: the block's wall seconds in ``t.duration``, the
    card's queued work waited for at both ends; printed when named."""

    def __init__(self, name: Optional[str] = None):
        self.name = name

    def __enter__(self):
        _sync()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.duration = time.perf_counter() - self.start
        if self.name:
            print(f"[{self.name}] {self.duration:.3f} s")
