#!/usr/bin/env python3
"""How far calibrate's answers move when only the NMF's order of summation changes.

Serves requests a, c, d and e of chip_smoke.py (its weights and its
``smoke_requests``) on one card through geocalib_tpu_torch, first with the plain PyTorch
versions of both kernels (the reference of chip_smoke.py's whole-path gate),
then by other routes, each with the solver's early stop off (converged) and
on (serving), and judges each route by chip_smoke.gate_verdict, the converged
comparison (the gate proper) and the serving one apart:

- a control with no kernel: the plain NMF with its products summed in float64
  (rounded to bf16 at the same points as nmf_plain), the LM plain;
- the kernels, and the NMF kernel alone (LM plain), for each chunk size of the
  NMF's stats stage given by --chunks: the chunk sets the order in which
  coef^T x is summed.

The control shows how much of the gate's bound any other order of summation
takes by itself: a gate that the control fails cannot judge a kernel.

Run from the repository root, on a machine with one card:

    python3 tools/nmf_order_sensitivity.py [--chunks 1024,1536,2048]

The last line is one JSON object with the verdicts printed above.
"""

import argparse
import contextlib
import faulthandler
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
import geocalib_tpu_torch  # noqa: E402
from geocalib_tpu_torch.models import hamburger  # noqa: E402
from geocalib_tpu_torch.models.weights import params_from_jax, read_flax_msgpack  # noqa: E402
from geocalib_tpu_torch.ops import nmf as nmf_ops  # noqa: E402


WATCHDOG_S = 1200  # the whole run takes about a minute on one H100; a hang ends here


def nmf_float64(x, bases, steps=7, inv_t=1.0, eps=1e-6):
    """nmf_plain with every product summed in float64, rounded where nmf_plain rounds."""
    dt = x.dtype

    def dot(a, b):
        return torch.matmul(a.double(), b.double()).to(dt)

    bt = bases.transpose(1, 2).to(dt)
    norm = torch.sqrt(torch.sum(bt.double() ** 2, dim=-1, keepdim=True))
    bt = bt / (norm.to(dt) + eps)
    coef = torch.softmax((inv_t * dot(x, bt.transpose(1, 2))).double(), dim=-1).to(dt)

    def update_coef(coef, bt):
        return coef * dot(x, bt.transpose(1, 2)) / (dot(coef, dot(bt, bt.transpose(1, 2))) + eps)

    for _ in range(steps):
        coef = update_coef(coef, bt)
        bt = bt * dot(coef.transpose(1, 2), x) / (dot(dot(coef.transpose(1, 2), coef), bt) + eps)
    return update_coef(coef, bt), bt


@contextlib.contextmanager
def nmf_in_float64():
    fn = hamburger.nmf_reconstruct
    hamburger.nmf_reconstruct = lambda x, b, *a: torch.matmul(*nmf_float64(x, b, *a))
    try:
        yield
    finally:
        hamburger.nmf_reconstruct = fn


def main() -> int:
    if not torch.cuda.is_available():
        print("nmf_order_sensitivity: no CUDA card", file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    parser = argparse.ArgumentParser()
    parser.add_argument("--chunks", default="1024,1536,2048")
    args = parser.parse_args()
    smoke.log(f"card: {smoke.card_name()}")
    weights = params_from_jax(read_flax_msgpack(smoke.WEIGHTS), "b")
    calib = geocalib_tpu_torch.GeoCalib(weights=weights, compute_dtype="bfloat16")
    calib_h = geocalib_tpu_torch.GeoCalib(weights=weights, compute_dtype="bfloat16",
                                          init_mode="heuristic")
    requests = smoke.smoke_requests(calib, calib_h)[0]

    smoke.gate_serve(requests)  # warm up
    with smoke.plain_versions():
        ref = smoke.gate_serve(requests)
    result = {}

    def judge(route: str) -> None:
        outs = smoke.gate_serve(requests)
        result[route] = smoke.gate_verdict(route, outs, ref)

    with smoke.plain_versions(nmf=False), nmf_in_float64():
        judge("plain, NMF sums in float64")
    default = nmf_ops.TOKENS_PER_CHUNK
    try:
        for chunk in (int(c) for c in args.chunks.split(",")):
            nmf_ops.TOKENS_PER_CHUNK = chunk
            judge(f"kernels, chunk {chunk}")
            with smoke.plain_versions(lm=True, nmf=False):
                judge(f"NMF kernel only, chunk {chunk}")
    finally:
        nmf_ops.TOKENS_PER_CHUNK = default
    verdict = lambda ok: "passed" if ok else "FAILED"
    for route, v in result.items():
        smoke.log(f"{route}: converged {verdict(v['ok_converged'])}, serving "
                  f"{verdict(v['ok_serving'])}; max roll/pitch/vfov "
                  + "; ".join(f"{mode} " + ", ".join(f"{k} {np.round(d, 5).tolist()}"
                                                      for k, d in v["max_dev_deg"][mode].items())
                              for mode in ("converged", "serving"))
                  + f"; serving lanes stopping apart: {len(v['stop_apart'])}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
