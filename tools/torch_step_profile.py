#!/usr/bin/env python3
"""Where a training step's time goes on one card, by part and by operation.

Builds the training state of chip_smoke.py's loop phase (MSCAN-B, bf16,
IFT, the r05 weights) and a batch of 24 rendered 320x320 views, then for
each part of a step - the device augmentation (``augment_batch``), the
forward, LM and backward (``compute_grads``), the optimizer
(``optimizer_update``) and the whole step (``make_train_step`` with the
device augmentation) - prints its wall time (host clock around the call and
a synchronize), its device-kernel time (torch.profiler), the number of
kernels it launched, and its ten operations with the most device time and
the ten with the most calls.

Run from the repository root, on a machine with one card:

    python3 tools/torch_step_profile.py

The last line is one JSON object with the numbers printed above.
"""

import faulthandler
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
from geocalib_tpu_torch.models.weights import params_from_jax, read_flax_msgpack  # noqa: E402
from geocalib_tpu_torch.training import train_step as T  # noqa: E402

WATCHDOG_S = 600  # the run takes about a minute on one H100; a hang ends here
TOP = 10


def profile(label: str, fn) -> dict:
    """Wall ms of one fn() after a warm call, and its kernels under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    ops = [e for e in prof.key_averages() if e.self_device_time_total > 0 or e.count > 0]
    by_time = sorted(ops, key=lambda e: -e.self_device_time_total)[:TOP]
    by_count = sorted(ops, key=lambda e: -e.count)[:TOP]
    row = lambda e: {"op": e.key, "device_ms": e.self_device_time_total / 1e3, "calls": e.count}
    out = {"wall_ms": wall, "device_ms": device, "kernels": len(kernels),
           "top_by_device_time": [row(e) for e in by_time],
           "top_by_calls": [row(e) for e in by_count]}
    smoke.log(f"{label}: {wall:.2f} ms wall, {device:.2f} ms of device kernels in {len(kernels)} "
              f"launches")
    for e in by_time:
        smoke.log(f"  {label}, by device time: {e.key[:60]:60s} {e.self_device_time_total / 1e3:9.3f} "
                  f"ms, {e.count} calls")
    for e in by_count:
        smoke.log(f"  {label}, by calls: {e.key[:60]:60s} {e.count} calls, "
                  f"{e.self_device_time_total / 1e3:.3f} ms")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA card", file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    card = smoke.card_name()
    smoke.log(f"card: {card}")
    weights = params_from_jax(read_flax_msgpack(smoke.WEIGHTS), "b")
    cfg = T.TrainConfig()
    net, state = T.create_train_state(cfg, weights, device="cuda")
    batch = smoke.train_batch(np.random.default_rng(3))
    step = T.make_train_step(net, cfg, augment_on_device=True)
    state, _ = step(state, batch, (0, 1))  # warm: cuDNN, the allocator
    grads = T.compute_grads(net, cfg, state, batch, (0, 2))[1]
    parts = {
        "augment_batch": lambda: T.augment_batch(batch, (0, 3)),
        "compute_grads": lambda: T.compute_grads(net, cfg, state, batch, (0, 4)),
        "optimizer_update": lambda: T.optimizer_update(grads, state.opt_state, state.params, cfg),
        "train_step": lambda: step(state, batch, (0, 5)),
    }
    result = {name: profile(name, fn) for name, fn in parts.items()}
    smoke.log(card)
    print(json.dumps({"card": card, "parts": result}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
