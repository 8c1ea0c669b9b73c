#!/usr/bin/env python3
"""Where the NMF kernel's time goes, stage by stage, on one card.

Runs geocalib_tpu_torch's ``nmf`` at request a's shape of chip_smoke.py
(32 samples = 16 images x 2 heads, N = 8320 tokens, D = 512, R = 64, 7
steps, bf16; non-negative tokens and uniform bases drawn on the card from
a torch.Generator seeded with 0) under torch.profiler, and prints each stage
kernel's device time per ``nmf`` call, its launches per call, and the bytes
of x it reads per call divided by its time. Then it times the whole call
with CUDA events around CUDA-graph replays for each chunk size of the stats
stage given by --chunks (tokens per partials chunk), a plain read of x
(torch.sum, the memory rate the stages can be held to), and the float32
instance at the default chunk.

Run from the repository root, on a machine with one card:

    python3 tools/nmf_stage_times.py [--chunks 1024,1536,2048]

The last line is one JSON object with the numbers printed above.
"""

import argparse
import faulthandler
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
from geocalib_tpu_torch.ops import build, nmf as nmf_ops  # noqa: E402

SHAPE = (32, 8320, 512, 64)  # request a: 2B samples, N, D, R
STEPS = 7
WATCHDOG_S = 600  # the run takes under a minute on one H100; a hang ends here


def device_us(evt) -> float:
    """Device microseconds of a profiler event average, across torch versions."""
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def stage_times(fn, calls: int = 3) -> dict:
    """Device ms and launches per fn() call of each NMF stage kernel, from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    stages = {}
    for evt in prof.key_averages():
        found = re.search(r"nmf_\w+(?:<[^>]*>)?", evt.key)
        if not found or device_us(evt) <= 0:
            continue
        st = stages.setdefault(found.group(0), {"ms": 0.0, "launches": 0.0})
        st["ms"] += device_us(evt) / 1e3 / calls
        st["launches"] += evt.count / calls
    return stages


def main() -> int:
    if not torch.cuda.is_available():
        print("nmf_stage_times: no CUDA card", file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    parser = argparse.ArgumentParser()
    parser.add_argument("--chunks", default="1024,1536,2048")
    args = parser.parse_args()
    card = smoke.card_name()
    print(f"card: {card}", flush=True)
    build.lib()
    B, N, D, R = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((B, N, D), device="cuda", generator=gen).clamp_min(0).bfloat16()
    bases = torch.rand((B, D, R), device="cuda", generator=gen).bfloat16()
    x_bytes = x.numel() * x.element_size()

    with torch.inference_mode():
        stages = stage_times(lambda: nmf_ops.nmf(x, bases, STEPS))
        for name, st in sorted(stages.items(), key=lambda kv: -kv[1]["ms"]):
            reads_x = "coef_tc" in name or "stats_tc" in name
            rate = (f", x at {x_bytes * st['launches'] / (st['ms'] * 1e-3) / 1e12:.3f} TB/s"
                    if reads_x else "")
            print(f"stage {name}: {st['ms']:.4f} ms per call, {st['launches']:.0f} launches"
                  f"{rate}", flush=True)
        print(f"stages total: {sum(st['ms'] for st in stages.values()):.4f} ms per call",
              flush=True)

        default = nmf_ops.TOKENS_PER_CHUNK
        whole = {}
        try:
            for chunk in (int(c) for c in args.chunks.split(",")):
                nmf_ops.TOKENS_PER_CHUNK = chunk
                whole[chunk] = smoke.cuda_ms(lambda: nmf_ops.nmf(x, bases, STEPS), reps=3,
                                             per_graph=2)
                print(f"whole call, {chunk} tokens per chunk: {whole[chunk]:.4f} ms", flush=True)
        finally:
            nmf_ops.TOKENS_PER_CHUNK = default
        read_ms = smoke.cuda_ms(lambda: x.sum(dtype=torch.float32), reps=5, per_graph=5)
        print(f"a plain read of x (torch.sum): {read_ms:.4f} ms, "
              f"{x_bytes / (read_ms * 1e-3) / 1e12:.3f} TB/s", flush=True)
        xf, bf = x.float(), bases.float()
        f32_ms = smoke.cuda_ms(lambda: nmf_ops.nmf(xf, bf, STEPS), reps=3, per_graph=2)
        print(f"float32 instance, {default} tokens per chunk: {f32_ms:.4f} ms", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"after the runs: {smi}", flush=True)
    print(json.dumps({"card": card, "shape": SHAPE, "stages": stages, "whole_ms_by_chunk": whole,
                      "read_x_ms": read_ms, "f32_ms": f32_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
