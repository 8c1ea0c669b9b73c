#!/usr/bin/env python3
"""Where a bf16 training step by the LM kernel parts from the plain LM's, per route.

One IFT compute_grads of chip_smoke.py's train setup (MSCAN-B, bf16 network, the
r05 weights, rendered 320x320 views), cuDNN deterministic, in three setups: the
distributed phase's rank 0 without the mesh (rows 0-11, drop path 0.1, key
(0, 0)), the train phase's (24 rows, no drop path, key (0, 5)), and the
distributed phase's own bf16 step on each of its two gloo ranks on the one card
(12 rows a rank, BatchNorm statistics and the gradient averaged over the ranks,
chip_smoke.distributed_rank_run's setup). Each route runs once against the plain
route (the plain LM): the kernels, the four LM controls of the gate, and two
hybrids that put the kernel in the solver's loop alone or in its final system
alone. For each it prints, beside the plain route's:

- per lane, whether the loop's final state (gravity, camera, stop_at) holds the
  same bits (lm_state_reading), and READ_LEAF's relative L2;
- whether the solve wrote into any observation plane;
- the gradient at the LM's input for each field (float32, before the cast back
  to the network's bf16): elements apart, largest and relative L2 difference;
- the gradient leaves moved, and for each confidence head's last conv (weight and
  bias) the relative L2, the elements apart and the largest difference in bf16
  ulps.

Run from the repository root, on a machine with one card:

    python3 tools/lm_state_trace.py
"""

import contextlib
import faulthandler
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
from geocalib_tpu_torch.models.weights import params_from_jax, read_flax_msgpack  # noqa: E402
from geocalib_tpu_torch.ops import build, lm_system as lm_ops  # noqa: E402
from geocalib_tpu_torch.optim import lm as lm_solver  # noqa: E402
from geocalib_tpu_torch.training import train_step as train_lib  # noqa: E402

WATCHDOG_S = 1200  # a few minutes on one H100; a hang ends here
FIELDS = ("up_field", "latitude_field", "up_confidence", "latitude_confidence")
LEAVES = ("up_head.conf.weight", "up_head.conf.bias", "lat_head.conf.weight",
          "lat_head.conf.bias")
# The gradient leaf that the distributed phase's bf16 IFT comparison moved by the
# kernels and by no LM control; its relative L2 stands in each lm_state_reading.
READ_LEAF = "up_head.conf.weight"


@contextlib.contextmanager
def recorded_lm_states(states: list):
    """While active, each LM loop's final state, before the IFT step and the backward
    (optim/lm.py _optimize_loop's output): the camera's parameters, the gravity and
    stop_at, copied and appended to `states`."""
    fn = lm_solver._optimize_loop

    def loop(*args, **kw):
        camera, gravity, info = fn(*args, **kw)
        states.append({"camera": camera.data.detach().clone(),
                       "gravity": gravity.vec3d.detach().clone(),
                       "stop_at": info["stop_at"].detach().clone()})
        return camera, gravity, info

    with smoke.seam(lm_solver, "_optimize_loop", loop):
        yield states


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    """Per lane (the first axis) of two float32 tensors, whether they hold the same bits."""
    a, b = a.reshape(len(a), -1).view(torch.int32), b.reshape(len(b), -1).view(torch.int32)
    return (a == b).all(-1).cpu().numpy()


def lm_state_reading(label: str, state: dict, ref_state: dict, out: tuple, ref: tuple) -> dict:
    """Per lane, whether a route's final LM state (recorded_lm_states: gravity, camera
    parameters, stop_at) equals the plain route's bit for bit, beside how far the
    route moved the state and the step's gradients (compute_grads' outputs): the
    leaves whose bits differ from the plain route's, and READ_LEAF's relative L2."""
    per = {k: bits_equal(state[k], ref_state[k]) for k in ("gravity", "camera", "stop_at")}
    equal = per["gravity"] & per["camera"] & per["stop_at"]
    f, f_ref = state["camera"][:, 3], ref_state["camera"][:, 3]
    grads, rgrads = out[1], ref[1]
    moved = sum(not torch.equal(grads[k], v) for k, v in rgrads.items())
    leaf = float(torch.linalg.norm((grads[READ_LEAF] - rgrads[READ_LEAF]).double())
                 / torch.linalg.norm(rgrads[READ_LEAF].double()))
    reading = {"equal": equal.tolist(), "lanes_equal": int(equal.sum()),
               "apart": {k: np.flatnonzero(~v).tolist() for k, v in per.items()},
               "gravity_max_abs": float((state["gravity"] - ref_state["gravity"]).abs().max()),
               "focal_max_rel": float(((f - f_ref).abs() / f_ref).max()),
               "leaves_moved": moved, "leaves": len(rgrads), "read_leaf_rel": leaf}
    smoke.log(f"lm state, {label} vs plain: the final LM state bit for bit the plain route's "
              f"in {reading['lanes_equal']} of {len(equal)} lanes (per lane "
              f"{equal.astype(int).tolist()}; lanes apart in gravity {reading['apart']['gravity']}, "
              f"camera {reading['apart']['camera']}, stop_at {reading['apart']['stop_at']}; "
              f"gravity {reading['gravity_max_abs']:.3e}, focal {reading['focal_max_rel']:.3e} "
              f"relative); gradient leaves moved {moved} of {len(rgrads)}, {READ_LEAF} "
              f"{leaf:.3e} relative L2")
    return reading


@contextlib.contextmanager
def traced(store: dict):
    """While active: the float32 fields' gradients at the LM's input (hooks set where
    the training step hands them to run_lm), and whether the solve wrote into any
    observation plane."""
    run_lm, optimize = train_lib.run_lm, lm_solver.optimize

    def hooked(data, cfg):
        for k in FIELDS:
            if k in data and data[k].requires_grad:
                data[k].register_hook(lambda g, k=k: store.__setitem__(k, g.detach().clone()))
        return run_lm(data, cfg)

    def watched(obs, *args, **kw):
        before = {k: v.detach().clone() for k, v in obs.items()}
        out = optimize(obs, *args, **kw)
        store["planes_written"] = [k for k, v in obs.items() if not torch.equal(v, before[k])]
        return out

    with smoke.seam(train_lib, "run_lm", hooked), smoke.seam(lm_solver, "optimize", watched):
        yield store


@contextlib.contextmanager
def hybrid(loop_kernel: bool):
    """The kernel in the solver's loop alone (the final system plain), or in its final
    system alone (spherical=False, the loop plain)."""
    def system(obs, camera, gravity, h, w, cfg, spherical=None, log_focal=None, **kw):
        final = spherical is not None
        fn = lm_ops.lm_system if final != loop_kernel else lm_ops.lm_system_plain
        return fn(obs, camera, gravity, h, w, cfg, spherical, log_focal, **kw)

    with smoke.seam(lm_solver, "lm_system", system):
        yield


def leaf_reading(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """A gradient leaf against the plain route's: its relative L2, the elements apart,
    and the largest difference in bf16 ulps of the plain element (2^(e - 7) for a
    plain value in [2^e, 2^(e+1)))."""
    d, r = (got - ref).double(), ref.double()
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(1e-38))) - 7)
    return {"rel": float(torch.linalg.norm(d) / torch.linalg.norm(r)),
            "apart": int((d != 0).sum()), "size": d.numel(),
            "ulps": float((d.abs() / ulp).max())}


@contextlib.contextmanager
def plain_lm_route(name: str):
    """The training path through the plain LM under one of chip_smoke.LM_CONTROL_KINDS."""
    with smoke.plain_versions(lm=True, nmf=False), smoke.plain_lm_control(
            smoke.LM_CONTROL_KINDS[name]):
        yield


def routes() -> dict:
    """The routes read against the plain one, by name: each a context manager's maker."""
    out = {"kernels": contextlib.nullcontext}
    out |= {name: (lambda name=name: plain_lm_route(name)) for name in smoke.LM_CONTROL_KINDS}
    out["kernel in the loop alone"] = lambda: hybrid(True)
    out["kernel in the final system alone"] = lambda: hybrid(False)
    return out


def run(setup: str, step) -> dict:
    """The readings of `step` (one compute_grads) by each of routes() against the plain
    route, logged; returns them by route."""
    states, ref_store = [], {}
    with smoke.plain_versions(lm=True, nmf=False), recorded_lm_states(states), \
            traced(ref_store):
        ref = step()
    conf = ref_store["up_confidence"]
    smoke.log(f"{setup}, plain: planes written by the solve {ref_store['planes_written']}; "
              f"up_confidence's gradient nonzero in {float((conf != 0).float().mean()):.4%} "
              f"of pixels, largest {float(conf.abs().max()):.3e}")
    out = {}
    for name, ctx in routes().items():
        got_states, store = [], {}
        with ctx(), recorded_lm_states(got_states), traced(store):
            got = step()
        reading = lm_state_reading(f"{setup}, {name}", got_states[-1], states[0], got, ref)
        fields = {}
        for k in FIELDS:
            a, b = store[k].double(), ref_store[k].double()
            fields[k] = {"apart": int((a != b).sum()), "max_abs": float((a - b).abs().max()),
                         "rel": float(torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp_min(
                             1e-300))}
        leaves = {k: leaf_reading(got[1][k], ref[1][k]) for k in LEAVES}
        smoke.log(f"{setup}, {name}: planes written by the solve {store['planes_written']}; "
                  + "; ".join(f"d loss / d {k} at the LM: {v['apart']} apart, largest "
                              f"{v['max_abs']:.3e}, {v['rel']:.3e} relative" for k, v in
                              fields.items())
                  + "; " + ", ".join(f"{k} {v['rel']:.3e} ({v['apart']} of {v['size']} "
                                     f"elements apart, the largest {v['ulps']:.3g} bf16 ulps of "
                                     f"its plain value)" for k, v in leaves.items()))
        out[name] = {"state": reading, "fields": fields, "leaves": leaves,
                     "planes_written": store["planes_written"]}
        del got
    return out


def rank_readings(mesh, work: Path) -> dict:
    """A rank's readings of the distributed phase's bf16 IFT step (run by
    chip_smoke.run_ranks): the network built as distributed_rank_run builds it (a
    float32 config, the mesh), the step with the bf16 network on this rank's 12 rows
    of the train batch, key (0, 0), its gradients averaged over the ranks."""
    rank, per = mesh.rank, smoke.TRAIN_B // mesh.size
    weights = params_from_jax(read_flax_msgpack(smoke.WEIGHTS), "b")
    batch = smoke.train_batch(np.random.default_rng(3))
    local = {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}
    cfg = train_lib.TrainConfig(compute_dtype="float32")
    net, state = train_lib.create_train_state(cfg, weights, mesh=mesh)
    c16 = smoke.replace_cfg(cfg, compute_dtype="bfloat16")
    return run(f"rank {rank} of {mesh.size}, the distributed phase's bf16 step", lambda: (
        smoke.mean_grads(train_lib.compute_grads(net, c16, state, local, (0, 0)), mesh)))


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_state_trace: no CUDA card", file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    build.lib()
    card = smoke.card_name()
    weights = params_from_jax(read_flax_msgpack(smoke.WEIGHTS), "b")
    batch = smoke.train_batch(np.random.default_rng(3))
    cfg = train_lib.TrainConfig()  # bf16, drop path 0.1, IFT
    setups = {"rank 0's 12 rows, the distributed step's setup, no mesh": (
        cfg, {k: v[:smoke.TRAIN_B // 2] for k, v in batch.items()}, (0, 0)),
        "24 rows, the train phase's setup": (smoke.replace_cfg(cfg, drop_path_rate=0.0), batch,
                                             (0, 5))}
    with smoke.deterministic():
        for setup, (c, rows, key) in setups.items():
            net, state = train_lib.create_train_state(c, weights, device="cuda")
            run(setup, lambda: train_lib.compute_grads(net, c, state, rows, key))
            del net, state
            torch.cuda.empty_cache()
    del weights
    with tempfile.TemporaryDirectory() as work:
        smoke.run_ranks(Path(work), rank_readings)
        for r in range(smoke.DIST_RANKS):
            print((Path(work) / f"rank{r}.log").read_text(), end="", flush=True)
    smoke.log(f"card {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
