#!/usr/bin/env python3
"""Where the NMF kernel's time goes, stage by stage, on one card.

Runs geocalib_tpu_torch's ``nmf`` at request a's shape of chip_smoke.py
(32 samples = 16 images x 2 heads, N = 8320 tokens, D = 512, R = 64, 7
steps; non-negative tokens and uniform bases drawn on the card from a
torch.Generator seeded with 0), in bf16 and in float32, under
torch.profiler, and prints each stage kernel's device time per ``nmf`` call,
its launches per call, and the bytes of x it reads per call divided by its
time. Then it times the whole bf16 call with CUDA events around CUDA-graph
replays for each chunk size of the stats stage given by --chunks (tokens per
partials chunk), and a plain read of x in each type (torch.sum, the memory
rate the stages can be held to). Last, the float32 instance at request a's
shape and at the float32 eval window's (24 x 6400 tokens), as one call and
in sample groups (--groups: each group of that many samples one ``nmf``
call of its own, its launches in a row, so that the group's x, 13 to 17 MB a
sample, can stay in the 50 MB L2 across the passes; 0 means one call),
with the registers and spills of the NMF stage kernels when the library was
built in this process, and each stage kernel's SASS instructions by opcode
(cuobjdump -sass of the built library: static counts over the whole
function, whose inner loops are unrolled over a pipeline stage). Then the
rate of the tensor-core instructions the instances are built from, alone: a
kernel of its own (built here into build/mma_rate/) in which every warp of
264 blocks of 256 threads issues mma.sync m16n8k8 TF32 (or m16n8k16 bf16)
from registers into 8 independent accumulators, one each or (TF32) three in
a row on each as the float32 instance does, timed by CUDA events.

Run from the repository root, on a machine with one card:

    python3 tools/nmf_stage_times.py [--chunks 1024,1536,2048] [--groups 0,1,2,3,4]

The last line is one JSON object with the numbers printed above.
"""

import argparse
import collections
import ctypes
import faulthandler
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
from geocalib_tpu_torch.ops import build, nmf as nmf_ops  # noqa: E402

SHAPE = (32, 8320, 512, 64)  # request a: 2B samples, N, D, R
EVAL_WINDOW_SHAPE = (24, 6400, 512, 64)  # a float32 eval window of 12 images at 320x320
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


def sass_opcodes(so: Path) -> dict:
    """Static SASS instruction counts by opcode (without modifiers) of each NMF stage
    kernel in the library, from cuobjdump."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = re.search(r"nmf_\w+?_kernel(?:I[^E]*E)?", func.split("\n", 1)[0])
        if not name:
            continue
        ops = collections.Counter(m.group(1) for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", func))
        out[name.group(0)] = dict(ops.most_common())
    return out


MMA_RATE_SOURCE = r"""
#include <cuda_runtime.h>
// Each warp: iters x 8 accumulators, each taking one tensor-core instruction from
// registers, or three in a row. variant 0: TF32 m16n8k8, one each; 1: TF32, three
// in a row (the float32 NMF's pattern); 2: bf16 m16n8k16, one each.
template <int V>
__global__ void mma_rate_kernel(float* out, int iters) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + threadIdx.x * 8192u + i;
  for (int i = 0; i < 2; ++i) b[i] = 0x3f000000u + threadIdx.x * 8192u + i;
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (V == 2) {
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      } else {
#pragma unroll
        for (int r = 0; r < (V == 1 ? 3 : 1); ++r)
          asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                       "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                       : "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])
                       : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      }
    }
  }
  float s = 0.f;
  for (int n = 0; n < 8; ++n) s += d[n][0] + d[n][1] + d[n][2] + d[n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate(int variant, int blocks, int threads, float* out, int iters,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 0) mma_rate_kernel<0><<<blocks, threads, 0, st>>>(out, iters);
  if (variant == 1) mma_rate_kernel<1><<<blocks, threads, 0, st>>>(out, iters);
  if (variant == 2) mma_rate_kernel<2><<<blocks, threads, 0, st>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""
# variant: (label, instructions an iteration a warp, FLOP an instruction)
MMA_VARIANTS = {0: ("TF32 m16n8k8, 8 independent", 8, 2 * 16 * 8 * 8),
                1: ("TF32 m16n8k8, 3 in a row on each of 8 accumulators", 24, 2 * 16 * 8 * 8),
                2: ("bf16 m16n8k16, 8 independent", 8, 2 * 16 * 8 * 16)}


def mma_rates(blocks: int = 264, threads: int = 256, iters: int = 2048) -> dict:
    """TFLOP/s of each MMA_VARIANTS kernel on the card (median of 5 timed launches)."""
    out_dir = build.BUILD_DIR.parent / "mma_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, so = out_dir / "mma_rate.cu", out_dir / "libmma_rate.so"
    src.write_text(MMA_RATE_SOURCE)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(so), str(src)], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(str(so)).mma_rate
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(blocks * threads, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for v, (label, per_iter, flop) in MMA_VARIANTS.items():
        times = []
        for _ in range(6):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            build.check(fn(v, blocks, threads, out.data_ptr(), iters, stream), "mma_rate")
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        ms = sorted(times[1:])[2]
        total = blocks * threads // 32 * iters * per_iter * flop
        rates[label] = total / (ms * 1e-3) / 1e12
        print(f"mma rate, {label}: {rates[label]:.1f} TFLOP/s ({ms:.4f} ms, {blocks} blocks of "
              f"{threads} threads)", flush=True)
    return rates


def grouped(x: torch.Tensor, bases: torch.Tensor, group: int):
    """The NMF of x in calls of `group` samples each (0: one call)."""
    if group <= 0:
        return nmf_ops.nmf(x, bases, STEPS)
    for b0 in range(0, x.shape[0], group):
        nmf_ops.nmf(x[b0:b0 + group], bases[b0:b0 + group], STEPS)


def print_stages(stages: dict, x_bytes: int, label: str) -> None:
    for name, st in sorted(stages.items(), key=lambda kv: -kv[1]["ms"]):
        reads_x = any(k in name for k in ("coef_tc", "stats_tc", "coef_tf32", "stats_tf32"))
        rate = (f", x at {x_bytes * st['launches'] / (st['ms'] * 1e-3) / 1e12:.3f} TB/s"
                if reads_x else "")
        print(f"{label} stage {name}: {st['ms']:.4f} ms per call, {st['launches']:.0f} launches"
              f"{rate}", flush=True)
    print(f"{label} stages total: {sum(st['ms'] for st in stages.values()):.4f} ms per call",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("nmf_stage_times: no CUDA card", file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    parser = argparse.ArgumentParser()
    parser.add_argument("--chunks", default="1024,1536,2048")
    parser.add_argument("--groups", default="0,1,2,3,4")
    args = parser.parse_args()
    card = smoke.card_name()
    print(f"card: {card}", flush=True)
    build.lib()
    for stage, report in smoke.nmf_ptxas().items():
        print(f"ptxas, nmf stage {stage}: {report}", flush=True)
    sass = sass_opcodes(build.BUILD_DIR / build.LIB_NAME)
    for name, ops in sass.items():
        print(f"sass {name}: {sum(ops.values())} instructions, {json.dumps(ops)}", flush=True)
    rates = mma_rates()
    B, N, D, R = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((B, N, D), device="cuda", generator=gen).clamp_min(0).bfloat16()
    bases = torch.rand((B, D, R), device="cuda", generator=gen).bfloat16()
    x_bytes = x.numel() * x.element_size()
    xf, bf = x.float(), bases.float()

    with torch.inference_mode():
        stages = stage_times(lambda: nmf_ops.nmf(x, bases, STEPS))
        print_stages(stages, x_bytes, "bf16")
        stages_f32 = stage_times(lambda: nmf_ops.nmf(xf, bf, STEPS))
        print_stages(stages_f32, 2 * x_bytes, "float32")

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
        read_f32_ms = smoke.cuda_ms(lambda: xf.sum(), reps=5, per_graph=5)
        print(f"a plain read of x in float32 (torch.sum): {read_f32_ms:.4f} ms, "
              f"{2 * x_bytes / (read_f32_ms * 1e-3) / 1e12:.3f} TB/s", flush=True)
        f32_by_group = {}
        for label, (b, n) in (("request a", SHAPE[:2]), ("eval window", EVAL_WINDOW_SHAPE[:2])):
            xs, bs = xf[:b, :n].contiguous(), bf[:b].contiguous()
            for group in (int(g) for g in args.groups.split(",")):
                ms = smoke.cuda_ms(lambda: grouped(xs, bs, group), reps=3, per_graph=2)
                f32_by_group[f"{label}, group {group}"] = ms
                print(f"float32 instance, {label} {tuple(xs.shape)}, samples per call "
                      f"{group or b}: {ms:.4f} ms", flush=True)
            del xs, bs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"after the runs: {smi}", flush=True)
    print(json.dumps({"card": card, "shape": SHAPE, "stages": stages, "stages_f32": stages_f32,
                      "whole_ms_by_chunk": whole, "read_x_ms": read_ms,
                      "read_x_f32_ms": read_f32_ms, "f32_ms_by_group": f32_by_group,
                      "sass": sass, "mma_tflops": rates}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
