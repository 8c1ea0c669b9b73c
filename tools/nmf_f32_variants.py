#!/usr/bin/env python3
"""What holds the float32 NMF instance back: its stages timed with parts taken out.

Builds patched copies of geocalib_tpu_torch/csrc/nmf.cu (each by an nvcc of its
own, all started together, into build/nmf_variants/) in which one part of the
float32 instance's TF32 stages is removed, and times each copy's float32 call
and its stage kernels (torch.profiler) at request a's shape of chip_smoke.py
(32 x 8320 x 512, R = 64, 7 steps; tokens and bases drawn on the card from a
torch.Generator seeded with 0), between two timings of the unchanged source.
The variants compute wrong numbers on purpose; only their times are read:

  no_split     operands passed to the tensor cores unsplit (hi = a, lo = 0)
  one_product  one TF32 product a product (hi hi) instead of three
  no_mma       each tensor-core instruction replaced by one float add of its
               operands' bits, which keeps the loads that feed it
  no_x_loads   the coef and stats stages' copies of x tiles left out, so x
               never leaves device memory (the stages read stale tiles)
  no_bt_loads  the coef stage's copies of the (hi, lo) pairs of bt left out
  no_convert   the stats stage's split of each x tile into (hi, lo) pairs left
               out (its products read stale pairs)
  no_sync      the block-wide barriers around each pipeline stage left out
               (warps read tiles that others are still writing)

and other forms of the same arithmetic:

  coef_mt2     two m16 tiles of tokens a warp (256 tokens a block, 2 blocks an SM)
  coef_3stages a ring of 3 stages, 2 blocks an SM
  coef_3blocks 3 blocks an SM (registers capped at 80)
  coef_1block  1 block an SM (registers up to 255)
  cvt_rna      the rounding to TF32 by the cvt.rna.tf32.f32 instruction, in
               place of the integer form of the same rounding

Each of the last four must give the unchanged source's bits, which is checked.
Variants join with "+" (no_mma+no_x_loads takes both parts out).

with each copy's registers and spills of its float32 stage kernels.

With --baseline FILE (another checkout's nmf.cu, for example the parent
commit's unpacked by git archive under .smoke/), that source is built too; its
bf16 instance must give the current source's bits at request a's shape, and
both sources' bf16 and float32 calls are timed in turns (baseline, current,
current, baseline).

Run from the repository root, on a machine with one card:

    python3 tools/nmf_f32_variants.py [--variants no_split,one_product,no_mma,no_x_loads]
        [--baseline .smoke/parent/geocalib_tpu_torch/csrc/nmf.cu]

The last line is one JSON object with the numbers printed above.
"""

import argparse
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
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as smoke  # noqa: E402
import nmf_stage_times as stage_tool  # noqa: E402
from geocalib_tpu_torch.ops import build, nmf as nmf_ops  # noqa: E402

SOURCE = build.CSRC / "nmf.cu"
OUT_DIR = build.BUILD_DIR.parent / "nmf_variants"
WATCHDOG_S = 600
# name -> [(pattern, replacement)], each pattern must match at least once
PATCHES = {
    "no_split": [(r"hi = tf32\(a\);\s*lo = tf32\(a - __uint_as_float\(hi\)\);",
                  "hi = __float_as_uint(a);\n  lo = 0u;")],
    "one_product": [(r"mma_tf32\(d, a\.lo, b\.hi\);\s*mma_tf32\(d, a\.hi, b\.lo\);", "")],
    "no_mma": [(r"(?s)(void mma_tf32\([^{]*\{).*?(\n\})",
                r"\1\n  d[0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[0] ^ b[1]);\2")],
    "no_x_loads": [(r"load_tile<kFTok, kFDK, kFLd>\([^;]*;", "(void)xb;"),
                   (r"load_tile<kSTok, kSCol, kSCol>\([^;]*;", "(void)xb;")],
    "no_sync": [(r"cp_async_wait<STAGES - 1>\(\);\s*__syncthreads\(\);\s*compute\(s\);\s*"
                 r"__syncthreads\(\);", "cp_async_wait<STAGES - 1>();\n    compute(s);")],
    # other geometries of the coef stage: two m16 tiles a warp (256 tokens a block,
    # 2 blocks an SM), and a ring of 3 stages at 2 blocks an SM
    "coef_mt2": [(r"constexpr int kFMT = \d+;", "constexpr int kFMT = 2;")],
    "coef_3stages": [(r"constexpr int kFCoefBlocks = [^;]*;", "constexpr int kFCoefBlocks = 2;"),
                     (r"kFCoefStages = \d+,", "kFCoefStages = 3,")],
    "coef_3blocks": [(r"constexpr int kFCoefBlocks = [^;]*;", "constexpr int kFCoefBlocks = 3;")],
    "coef_1block": [(r"constexpr int kFCoefBlocks = [^;]*;", "constexpr int kFCoefBlocks = 1;")],
    "cvt_rna": [(r"return \(__float_as_uint\(a\) \+ 0x1000u\) & 0xffffe000u;",
                 'unsigned r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\\\n" : "=r"(r) : "f"(a));\n'
                 "  return r;")],
    "no_bt_loads": [(r"load_tile<kRk, kFDK, kF2Ld>\([^;]*;", "(void)bb;")],
    "no_convert": [(r"(?s)for \(int e = threadIdx\.x; e < kSTok \* kSCol / 4;.*?\n        \}\n",
                    "")],
}


EXACT = ("coef_mt2", "coef_3stages", "coef_3blocks", "coef_1block", "coef_mt2+coef_1block",
         "cvt_rna")  # the source's arithmetic


def build_variants(names, baseline: Path = None):
    """name -> ctypes library; "base" is the source unchanged, "baseline" the
    baseline source as it is."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name in ["base", *names] + (["baseline"] if baseline else []):
        text = (baseline if name == "baseline" else SOURCE).read_text()
        patches = [pr for part in name.split("+") for pr in PATCHES.get(part, [])]
        for pattern, repl in patches:
            text, n = re.subn(pattern, repl, text)
            if n == 0:
                raise ValueError(f"variant {name}: no match for {pattern}")
        src, so = OUT_DIR / f"nmf_{name}.cu", OUT_DIR / f"libnmf_{name}.so"
        src.write_text(text)
        cmd = [nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(so), str(src)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}\n{err}")
        saved, build.build_log["ptxas"] = build.build_log["ptxas"], out + err
        for stage, report in smoke.nmf_ptxas().items():
            if stage.startswith("float32"):
                print(f"variant {name}, nmf stage {stage}: {report}", flush=True)
        build.build_log["ptxas"] = saved
        handle = ctypes.CDLL(str(so))
        handle.gc_nmf.argtypes = build._SIGNATURES["gc_nmf"]
        handle.gc_nmf.restype = ctypes.c_int
        libs[name] = handle
    return libs


def against_baseline(libs: dict, x: torch.Tensor, bases: torch.Tensor, steps: int) -> dict:
    """The baseline source against the current one: bf16 bits at these inputs, and
    both sources' bf16 and float32 calls timed in turns."""
    xb, bb = x.bfloat16(), bases.bfloat16()
    outs = {}
    for name in ("baseline", "base"):
        build._lib = libs[name]
        outs[name] = nmf_ops.nmf(xb, bb, steps)
    same = all(torch.equal(a, b) for a, b in zip(outs["baseline"], outs["base"]))
    print(f"bf16 instance: coef and bt bitwise equal to the baseline's: {same}", flush=True)
    times = {}
    for name in ("baseline", "base", "base", "baseline"):
        build._lib = libs[name]
        for dtype, (xs, bs) in (("bfloat16", (xb, bb)), ("float32", (x, bases))):
            ms = smoke.cuda_ms(lambda: nmf_ops.nmf(xs, bs, steps), reps=3, per_graph=2)
            times.setdefault(f"{name} {dtype}", []).append(ms)
            print(f"{'current' if name == 'base' else name} source, {dtype} instance: {ms:.4f} ms",
                  flush=True)
    return {"bf16_bitwise_equal": same, "ms": times}


def main() -> int:
    if not torch.cuda.is_available():
        print("nmf_f32_variants: no CUDA card", file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    parser = argparse.ArgumentParser()
    parser.add_argument("--variants", default=",".join(PATCHES))  # any of PATCHES
    parser.add_argument("--baseline", type=Path, default=None)
    args = parser.parse_args()
    names = [n for n in args.variants.split(",") if n]
    card = smoke.card_name()
    print(f"card: {card}", flush=True)
    libs = build_variants(names, args.baseline)
    B, N, D, R = stage_tool.SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((B, N, D), device="cuda", generator=gen).clamp_min(0)
    bases = torch.rand((B, D, R), device="cuda", generator=gen)
    steps = stage_tool.STEPS
    result = {}
    with torch.inference_mode():
        build._lib = libs["base"]
        ref = nmf_ops.nmf(x, bases, steps)
        for label in ["base", *names, "base again"]:
            build._lib = libs[label.split()[0]]
            if label in EXACT:
                same = all(torch.equal(a, b) for a, b in zip(nmf_ops.nmf(x, bases, steps), ref))
                print(f"variant {label}: coef and bt bitwise equal to the source's: {same}",
                      flush=True)
                if not same:
                    raise RuntimeError(f"variant {label} changed the float32 NMF's numbers")
            ms = smoke.cuda_ms(lambda: nmf_ops.nmf(x, bases, steps), reps=3, per_graph=2)
            stages = stage_tool.stage_times(lambda: nmf_ops.nmf(x, bases, steps))
            result[label] = {"ms": ms, "stages": {k: v["ms"] for k, v in stages.items()}}
            print(f"variant {label}: {ms:.4f} ms a call; stages "
                  f"{json.dumps({k: round(v, 4) for k, v in result[label]['stages'].items()})}",
                  flush=True)
        if args.baseline:
            result["baseline"] = against_baseline(libs, x, bases, steps)
    build._lib = None
    print(json.dumps({"card": card, "shape": stage_tool.SHAPE, "variants": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
