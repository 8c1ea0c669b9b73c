#!/usr/bin/env python3
"""The LM kernel's launch geometry swept, and its instructions per pixel counted.

Builds geocalib_tpu_torch/csrc/lm_system.cu once per variant given by
--variants (threads per block x blocks per lane, one cluster x the launch
bound's blocks per SM: the source's constants kThreads, kCluster and
kMinBlocks, set in a patched copy under build/lm_sweep/), each by an nvcc
process of its own, all started together, into build/lm_sweep/. Then, on one card, times each variant's four model
instances (all five planes, the huber loss) at request a's shape of
chip_smoke.py (N = 320 x 416) at the batch sizes of --batches (B = 16 is
request a's), by CUDA events
around CUDA-graph replays (chip_smoke.cuda_ms), beside the bound that
chip_smoke.py computes. Last, it reads each variant's SASS (cuobjdump -sass)
and counts the instructions of each instance's pixel loop,
the longest backward branch of the kernel, per pixel (4 pixels an iteration),
with its MUFU (reciprocal and square-root) and FFMA instructions apart, and
the time they take to issue at B = 16 at the card's top SM clock. The
divisions' and square roots' slow paths sit outside the loop and are not
counted; their fast paths are, and so are branches the loop rarely takes.

Run from the repository root, on a machine with one card:

    python3 tools/lm_kernel_sweep.py [--variants 512x8x1,256x8x1,256x16x2] [--batches 16,8,1]
        [--baseline DIR]

A variant may name another source with the same C entry (512x8x1@path.cu,
patched the same way), or take a source as it is (@path.cu); --baseline DIR times the LM kernel of another checkout (for example the
parent commit, unpacked with git archive) in a process of its own, first.

The last line is one JSON object with the numbers printed above.
"""

import argparse
import ctypes
import faulthandler
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

# --baseline runs this file again with the root of another checkout here
sys.path.insert(0, os.environ.get("GC_SWEEP_ROOT") or str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
from geocalib_tpu_torch.geometry.camera import Camera  # noqa: E402
from geocalib_tpu_torch.geometry.gravity import Gravity  # noqa: E402
from geocalib_tpu_torch.ops import build, lm_system as lm_ops  # noqa: E402

WATCHDOG_S = 900  # the builds take about a minute and the timings seconds on one H100
SWEEP_DIR = build.BUILD_DIR.parent / "lm_sweep"
SOURCE = build.CSRC / "lm_system.cu"
H, W = 320, 416  # request a's planes
VEC = 4  # pixels a thread takes per loop iteration (kVec in the source)


def patched(source: str, geometry: str) -> str:
    """The source with kThreads, kCluster and kMinBlocks set to THREADSxCLUSTERxMIN_BLOCKS."""
    for name, value in zip(("kThreads", "kCluster", "kMinBlocks"), geometry.split("x")):
        source, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{int(value)};", source)
        if n != 1:
            raise ValueError(f"the source defines {name} {n} times, not once")
    return source


def build_variants(variants):
    """One shared library per variant, nvcc processes started together. A variant is
    THREADSxCLUSTERxMIN_BLOCKS, optionally @ another source file of the same C entry,
    or @ a source alone, built as it is."""
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for i, v in enumerate(variants):
        geometry, _, source = v.partition("@")
        source = Path(source or SOURCE)
        so = SWEEP_DIR / f"lm_{i}_{geometry or source.stem}.so"
        if geometry:
            copy = so.with_suffix(".cu")
            copy.write_text(patched(source.read_text(), geometry))
            source = copy
        cmd = [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(so), str(source)]
        procs[v] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                         text=True))
    libs = {}
    for v, (so, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {v}:\n{out}\n{err}")
        saved, build.build_log["ptxas"] = build.build_log["ptxas"], out + err
        for model, report in smoke.lm_ptxas().items():
            smoke.log(f"variant {v}, {model}, all five planes: {report}")
        build.build_log["ptxas"] = saved
        handle = ctypes.CDLL(str(so))
        for name in ("gc_lm_system", "gc_lm_config"):
            getattr(handle, name).argtypes = build._SIGNATURES[name]
            getattr(handle, name).restype = ctypes.c_int
        libs[v] = (so, handle)
    return libs


def inputs(batch: int):
    """Request a's plane shapes, drawn from a seed, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    obs = {k: torch.rand((batch, H * W), generator=gen, device="cuda") for k in lm_ops.OBS_KEYS}
    vfov = torch.full((batch,), 0.9, device="cuda")
    f = H / 2 / torch.tan(vfov / 2)
    camera = Camera.from_data(torch.stack([torch.full_like(f, W), torch.full_like(f, H), f, f,
                                           torch.full_like(f, W / 2), torch.full_like(f, H / 2),
                                           torch.zeros_like(f), torch.zeros_like(f)], -1))
    gravity = Gravity.from_rp(torch.full((batch,), 0.1, device="cuda"),
                              torch.full((batch,), -0.2, device="cuda"))
    return obs, camera, gravity


def time_variant(handle, batches) -> dict:
    """ms of each model instance at each batch size with this library loaded (None: the
    package's own build, as in a baseline checkout)."""
    saved = build._lib
    build._lib = handle or build.lib()
    try:
        rows = {}
        if hasattr(lm_ops, "kernel_config"):
            rows["config"] = lm_ops.kernel_config(W)
            smoke.log(f"config {rows['config']}")
        for batch in batches:
            obs, camera, gravity = inputs(batch)
            for model in lm_ops.MODEL_IDS:
                rows.setdefault(model, {})[f"b{batch}"] = smoke.lm_timing(obs, camera, gravity,
                                                                          W, model)
        return rows
    finally:
        build._lib = saved


def sass_loop_counts(so: Path) -> dict:
    """Instructions per pixel in each all-planes instance's pixel loop, from its SASS."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    so.with_suffix(".sass").write_text(sass)
    counts = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        found = re.match(r"\S*lm_system_kernelILi(\d)ELi15E", func)
        if not found:
            continue
        lines = func.splitlines()
        instr = [(int(m.group(1), 16), ln) for ln in lines
                 for m in [re.search(r"/\*([0-9a-f]{4,})\*/", ln)] if m]
        # a label line names the next instruction's offset
        labels, pending = {}, []
        for ln in lines:
            lab = re.match(r"\s*(\.L_x_\d+):", ln)
            off = re.search(r"/\*([0-9a-f]{4,})\*/", ln)
            if lab:
                pending.append(lab.group(1))
            elif off:
                labels.update({name: int(off.group(1), 16) for name in pending})
                pending = []
        best = None
        for off, ln in instr:
            target = re.search(r"BRA\S*\s+(?:\S+\s+)?`?\(?(\.L_x_\d+|0x[0-9a-f]+)", ln)
            if not target:
                continue
            name = target.group(1)
            dest = int(name, 16) if name.startswith("0x") else labels.get(name)
            if dest is not None and dest < off:
                body = [t for o, t in instr if dest <= o <= off]
                if best is None or len(body) > len(best):
                    best = body
        if best is None:
            continue
        model = [m for m, k in lm_ops.MODEL_IDS.items() if k == int(found.group(1))][0]
        counts[model] = {"per_pixel": len(best) / VEC,
                         "mufu_per_pixel": sum("MUFU" in t for t in best) / VEC,
                         "ffma_per_pixel": sum(" FFMA" in t for t in best) / VEC}
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_kernel_sweep: no CUDA card", file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    parser = argparse.ArgumentParser()
    parser.add_argument("--variants", default="512x8x1,256x8x1,256x16x2")
    parser.add_argument("--batches", default="16,8,1")
    parser.add_argument("--baseline", default="",
                        help="a checkout of another commit whose LM kernel is timed too")
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    variants = args.variants.split(",")
    batches = [int(b) for b in args.batches.split(",")]
    if args.worker:  # time the package found on sys.path, print one JSON line
        print(json.dumps(time_variant(None, batches)), flush=True)
        return 0
    smoke.log(f"card: {smoke.card_name()}")
    libs = build_variants(variants)
    result = {"times": {}, "sass": {}}
    if args.baseline:
        root = str(Path(args.baseline).resolve())
        smoke.log(f"== baseline {root}")
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker",
                               "--batches", args.batches], cwd=root, capture_output=True,
                              text=True, env={**os.environ, "GC_SWEEP_ROOT": root})
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            raise RuntimeError(f"baseline failed:\n{proc.stderr[-4000:]}")
        result["times"]["baseline"] = json.loads(proc.stdout.strip().splitlines()[-1])
    for v in variants + variants[::-1]:  # each variant twice, in turns
        smoke.log(f"== variant {v}")
        rows = time_variant(libs[v][1], batches)
        result["times"].setdefault(v, []).append(rows)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, timeout=60).stdout.split()[0])
    for v in variants:
        result["sass"][v] = sass_loop_counts(libs[v][0])
        for model, c in result["sass"][v].items():
            # every instruction of the loop issued once a pixel, one warp instruction per
            # clock on each of an SM's 4 schedulers (128 lanes), at the card's top SM clock
            c["issue_floor_ms_b16"] = (c["per_pixel"] * 16 * H * W / (sms * 128 * mhz * 1e6)
                                       * 1e3)
            ms = result["times"][v][0][model]["b16"]["ms"]
            smoke.log(f"variant {v}, {model}: pixel loop {c['per_pixel']} SASS instructions "
                      f"per pixel, {c['mufu_per_pixel']} MUFU, {c['ffma_per_pixel']} FFMA; at "
                      f"{sms} SMs x 128 lanes x {mhz:.0f} MHz they issue in "
                      f"{c['issue_floor_ms_b16']:.4f} ms at B = 16, "
                      f"{c['issue_floor_ms_b16'] / ms:.2f} of the measured {ms:.4f} ms")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
