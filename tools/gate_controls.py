#!/usr/bin/env python3
"""Where the serving comparison's spread comes from, lane by lane, on one card.

Serves chip_smoke.py's gate requests (a, c, d, e, f) with the solver's early stop
on, first by the plain PyTorch versions of both kernels (the reference), then by
each no-kernel control of chip_smoke.GATE_CONTROLS and by extra controls of the
same kind (the plain NMF's token sums in 3, 5, 8 and 16 chunks), and by three
routes: the kernels, the NMF kernel alone (LM plain) and the LM kernel alone
(NMF plain). For every lane it prints each route's and each
control's |roll|, |pitch|, |vFoV| deviation from the reference in degrees (0
where it stops at another iteration, with the lane named), and each route's
deviation over the spread of chip_smoke.gate_spread. First, what the control with
the NMF's products on cuBLAS shares with the NMF kernel: on request a's tokens and
bases, after 1 and after 7 steps, the share of bf16 values of coef and bt that
differ from those of the NMF summed in float64, and the reconstruction's relative
deviation from it, for the kernel and for each NMF control. Last, per request, each
gate control left out in turn: how far it moves a lane against the largest of the
others, and which lanes of the kernels would fail the serving rule without it.

Run from the repository root, on a machine with one card:

    python3 tools/gate_controls.py [--out chiprun_out/gate_controls.json]

The last line is one JSON object: the accumulation readings, the card, and request
-> route or control -> per lane [roll, pitch, vFoV] deviations, stop_at and the
plain path's vFoV sigma.
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
from geocalib_tpu_torch.ops import build, nmf as nmf_ops  # noqa: E402

WATCHDOG_S = 1200  # about two minutes on one H100; a hang ends here


@contextlib.contextmanager
def extra_control(name: str):
    """The plain path with the NMF's token sums in another number of chunks."""
    chunks = int(name.split()[-2])
    with smoke.plain_versions(), smoke.seam(hamburger, "nmf_reconstruct", lambda x, b, *a: (
            torch.matmul(*smoke.nmf_control(x, b, *a, chunks=chunks)))):
        yield


EXTRA = ("plain NMF, token sums in 3 chunks", "plain NMF, token sums in 5 chunks",
         "plain NMF, token sums in 8 chunks", "plain NMF, token sums in 16 chunks")


def accumulation(cal, images, kw) -> dict:
    """The NMF kernel and the NMF controls against the NMF summed in float64, on the
    tokens and bases of the first NMF of one request (see the module docstring)."""
    calls = []
    with smoke.patched_nmf(calls):
        cal.calibrate(images, **kw)
    x, bases, steps, *rest = calls[0]
    out = {}
    for n in (1, steps):
        routes = {"NMF kernel": lambda: nmf_ops.nmf(x, bases, n, *rest),
                  "plain NMF (float32 sums)": lambda: smoke.nmf_control(x, bases, n, *rest)}
        for name, kw_c in (("products on cuBLAS", {"native": True}),
                           ("token sums in 2 chunks", {"chunks": 2}),
                           ("token sums in 4 chunks", {"chunks": 4})):
            routes[f"plain NMF, {name}"] = lambda kw_c=kw_c: smoke.nmf_control(
                x, bases, n, *rest, **kw_c)
        coef64, bt64 = smoke.nmf_control(x, bases, n, *rest, wide=True)
        rec64 = torch.matmul(coef64.double(), bt64.double())
        for name, fn in routes.items():
            coef, bt = fn()
            rec = torch.matmul(coef.double(), bt.double())
            res = {"coef_differ": float((coef != coef64).double().mean()),
                   "bt_differ": float((bt != bt64).double().mean()),
                   "rec_rel": float(torch.linalg.norm(rec - rec64) / torch.linalg.norm(rec64))}
            out[f"{n} steps, {name}"] = res
            smoke.log(f"accumulation, x {tuple(x.shape)} {x.dtype}, {n} steps, {name} against "
                      f"the NMF summed in float64: coef {res['coef_differ']:.4%} and bt "
                      f"{res['bt_differ']:.4%} of bf16 values differ, reconstruction "
                      f"{res['rec_rel']:.3e} relative")
    return out


def leave_one_out(k: str, res: dict) -> None:
    """Each gate control against the largest of the others, s', lane by lane and angle
    by angle (the median and largest of control / s' where s' > 0), and the kernels'
    lanes that chip_smoke.serving_rule fails with that control left out."""
    kern = np.asarray(res["kernels"]["dev"])
    judged = ~np.isin(np.arange(len(kern)), res["kernels"]["apart"])
    for name in smoke.GATE_CONTROLS:
        rest = np.max([res[n]["dev"] for n in smoke.GATE_CONTROLS if n != name], 0)
        mine, moved = np.asarray(res[name]["dev"]), rest > 0
        ratio = mine[moved] / rest[moved] if moved.any() else np.zeros(1)
        fails = np.flatnonzero(smoke.serving_rule(kern, rest, judged)["fail"]).tolist()
        smoke.log(f"leave one out, request {k}, {name}: over the others' largest, median "
                  f"{np.median(ratio):.3f}, largest {ratio.max():.3f}; the kernels over the "
                  f"others' largest, median {np.median(kern[moved] / rest[moved]):.3f}; "
                  f"without it the kernels fail lanes {fails}")


def main() -> int:
    if not torch.cuda.is_available():
        print("gate_controls: no CUDA card", file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    smoke.log(f"card: {smoke.card_name()}")
    build.lib()
    weights = params_from_jax(read_flax_msgpack(smoke.WEIGHTS), "b")
    calib = geocalib_tpu_torch.GeoCalib(weights=weights, compute_dtype="bfloat16")
    calib_h = geocalib_tpu_torch.GeoCalib(weights=weights, compute_dtype="bfloat16",
                                          init_mode="heuristic")
    calib_f = geocalib_tpu_torch.GeoCalib(weights=weights, compute_dtype="float32")
    requests = smoke.smoke_requests(calib, calib_h, calib_f)[0]
    serve = lambda: smoke.gate_serve(requests, ("serving",))["serving"]  # noqa: E731

    serve()  # warm up
    smoke.exact_matmul()
    acc = accumulation(*requests["a"])
    with smoke.plain_versions():
        ref = serve()
    routes = {"kernels": serve()}
    with smoke.plain_versions(lm=True, nmf=False):
        routes["NMF kernel only"] = serve()
    with smoke.plain_versions(lm=False, nmf=True):
        routes["LM kernel only"] = serve()
    for name in smoke.GATE_CONTROLS:
        with smoke.gate_control(name):
            routes[name] = serve()
    for name in EXTRA:
        with extra_control(name):
            routes[name] = serve()

    result = {}
    for k, r in ref.items():
        sigma = torch.rad2deg(r["vfov_uncertainty"]).reshape(-1).cpu().numpy()
        res = {"stop_at": smoke.stops(r).tolist(), "vfov_sigma_deg": sigma.tolist()}
        for name, outs in routes.items():
            same = smoke.stops(outs[k]) == smoke.stops(r)
            dev = np.where(same[:, None], smoke.angle_devs(outs[k], r), 0.0)
            res[name] = {"dev": dev.tolist(), "apart": np.flatnonzero(~same).tolist()}
        gate = np.max([res[n]["dev"] for n in smoke.GATE_CONTROLS], 0)
        every = np.max([res[n]["dev"] for n in (*smoke.GATE_CONTROLS, *EXTRA)], 0)
        for lane in range(len(sigma)):
            smoke.log(f"request {k}[{lane}] (plain vFoV sigma {sigma[lane]:.2f} deg, stop_at "
                      f"{res['stop_at'][lane]}): roll/pitch/vFoV deviation, degrees")
            for name in routes:
                d = np.asarray(res[name]["dev"][lane])
                note = " (stops apart)" if lane in res[name]["apart"] else ""
                over = "" if name in (*smoke.GATE_CONTROLS, *EXTRA) else (
                    f"; over the gate's spread {np.round(d / np.maximum(gate[lane], 1e-12), 2).tolist()}"
                    f", over every control's {np.round(d / np.maximum(every[lane], 1e-12), 2).tolist()}")
                smoke.log(f"  {name}: {np.array2string(d, precision=6, separator=',')}{note}{over}")
        result[k] = res
        leave_one_out(k, res)
    text = json.dumps({"accumulation": acc, "card": smoke.card_name(), **result})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
