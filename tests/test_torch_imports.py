"""The port stands alone: no JAX, Flax, msgpack or geocalib_tpu, and PIL, h5py,
PyYAML, wandb, matplotlib, gradio and OpenCV only inside the functions that use
them.

Every module of geocalib_tpu_torch/, chip_smoke.py, bench_torch.py and the
card tools (tools/torch_path_witness.py, tools/nmf_stage_times.py,
tools/gate_controls.py, tools/lm_kernel_sweep.py,
tools/torch_step_profile.py, tools/lm_state_trace.py) is parsed with ast;
each import must name the standard library, torch, numpy, the package itself
or chip_smoke, except that a function may import PIL, h5py or yaml (image
files, h5 results and a user's YAML conf, as the JAX package does), wandb
(an optional backend of the metrics writer), matplotlib (figures), gradio
(the web demo), cv2 (HDR files, the webcam loop and UVP's line detector),
selenium (the perceptual baseline's web driver) or the external libraries
that the import-gated baselines wrap (vp_estimation_with_prior_gravity,
pytlsd, deeplsd, dust3r). The machine with the
card has none of the others. Every module of the package is then imported in
a fresh interpreter, which must not have loaded jax, geocalib_tpu, PIL, h5py,
yaml, wandb, tensorboard, matplotlib, gradio or cv2. The msgpack reader that replaces flax.serialization is
held against it here.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from geocalib_tpu_torch.models.weights import read_flax_msgpack

ROOT = Path(__file__).resolve().parents[1]
ALLOWED = {"torch", "numpy", "geocalib_tpu_torch", "chip_smoke"}
# optional on the card: imported where a file is read or written, or a backend started;
# and the external libraries of the import-gated baselines (models/baselines.py)
IN_FUNCTIONS = {"PIL", "h5py", "yaml", "wandb", "matplotlib", "gradio", "cv2", "selenium",
                "vp_estimation_with_prior_gravity", "pytlsd", "deeplsd", "dust3r"}
FORBIDDEN = {"jax", "jaxlib", "flax", "msgpack", "geocalib_tpu", "triton"}
FILES = sorted((ROOT / "geocalib_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "bench_torch.py", ROOT / "tools" / "torch_path_witness.py",
    ROOT / "tools" / "nmf_stage_times.py", ROOT / "tools" / "gate_controls.py",
    ROOT / "tools" / "lm_kernel_sweep.py", ROOT / "tools" / "torch_step_profile.py",
    ROOT / "tools" / "lm_state_trace.py"]


def _imports(path: Path):
    """(top-level module name, inside a function) of every absolute import."""
    def walk(node, in_function):
        for child in ast.iter_child_nodes(node):
            inner = in_function or isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                                      ast.Lambda))
            if isinstance(child, ast.Import):
                yield from ((a.name.split(".")[0], inner) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module.split(".")[0], inner
            yield from walk(child, inner)

    yield from walk(ast.parse(path.read_text(), filename=str(path)), False)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_stand_alone(path):
    assert path.exists(), path
    for name, in_function in _imports(path):
        assert name not in FORBIDDEN, f"{path.name} imports {name}"
        assert (name in ALLOWED or name in sys.stdlib_module_names
                or (in_function and name in IN_FUNCTIONS)), f"{path.name} imports {name}"


def test_importing_the_package_loads_no_optional_module():
    modules = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts).replace(".__init__", "")
                     for p in (ROOT / "geocalib_tpu_torch").rglob("*.py"))
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules)
            + "print(sorted(m for m in ('jax', 'geocalib_tpu', 'PIL', 'h5py', 'yaml', 'wandb', "
            "'tensorboard', 'matplotlib', 'gradio', 'cv2') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_distributed_and_profiling_modules_are_guarded():
    """The data-parallel package and the two small utilities are among the files whose
    imports are held above, and importing them starts no process group, even with
    torchrun's environment set (the group is initialised only when asked for)."""
    guarded = {str(p.relative_to(ROOT)) for p in FILES}
    for name in ("parallel/__init__.py", "parallel/mesh.py", "utils/profiling.py",
                 "utils/stdout_capturing.py"):
        assert f"geocalib_tpu_torch/{name}" in guarded, name
    env = dict(os.environ, WORLD_SIZE="2", RANK="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT="1")
    code = ("import torch.distributed as dist\n"
            "import geocalib_tpu_torch.parallel\n"
            "from geocalib_tpu_torch.parallel import mesh\n"
            "import geocalib_tpu_torch.utils.profiling, geocalib_tpu_torch.utils.stdout_capturing\n"
            "print(dist.is_initialized(), mesh.process_index(), mesh.process_count(), "
            "mesh.make_mesh())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "0", "1", "None"], out.stdout


BASELINE_MODULES = ["optim/ransac.py", "optim/gradient.py", "models/uvp.py",
                    "models/deepcalib.py", "models/encoders.py", "models/fpn.py",
                    "models/perspective_encoding.py", "models/registry.py",
                    "models/baselines.py", "eval/baselines_cli.py",
                    "training/train_deepcalib.py"]


@pytest.mark.parametrize("name", BASELINE_MODULES)
def test_baseline_modules_are_guarded(name):
    """The baselines' eleven modules are among the files whose imports are held above, and
    import optional packages only inside functions."""
    path = ROOT / "geocalib_tpu_torch" / name
    assert path in FILES, name
    assert all(in_function for top, in_function in _imports(path)
               if top in IN_FUNCTIONS), name


def test_importing_the_baselines_loads_no_optional_module():
    """cv2 only inside UVP's detector; the gated wrappers' packages only when constructed."""
    modules = ["geocalib_tpu_torch." + n[:-3].replace("/", ".") for n in BASELINE_MODULES]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules)
            + "print(sorted(m for m in ('jax', 'geocalib_tpu', 'cv2', 'PIL', 'h5py', 'yaml', "
            "'vp_estimation_with_prior_gravity', 'pytlsd', 'deeplsd', 'dust3r') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


LAST_SLICE_MODULES = ["models/convert_torch.py", "hub.py", "pose_estimation.py",
                      "eval/inspect.py", "eval/run_perceptual.py", "ops/winograd.py"]


@pytest.mark.parametrize("name", LAST_SLICE_MODULES)
def test_last_slice_modules_are_guarded(name):
    """The converter, the hub, pose estimation, the inspector, the perceptual driver and
    Winograd are among the files whose imports are held above (no jax, flax or
    geocalib_tpu), and import h5py, matplotlib and selenium only inside functions."""
    path = ROOT / "geocalib_tpu_torch" / name
    assert path in FILES, name
    tops = list(_imports(path))
    assert all(in_function for top, in_function in tops if top in IN_FUNCTIONS), name
    assert not {top for top, _ in tops} & FORBIDDEN, name


def test_importing_the_last_slice_loads_no_optional_module():
    modules = ["geocalib_tpu_torch." + n[:-3].replace("/", ".") for n in LAST_SLICE_MODULES]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules)
            + "print(sorted(m for m in ('jax', 'flax', 'msgpack', 'geocalib_tpu', 'h5py', "
            "'matplotlib', 'selenium', 'PIL') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_read_flax_msgpack_matches_flax(tmp_path):
    rng = np.random.default_rng(0)
    tree = {
        "params": {"Conv_0": {"kernel": rng.normal(size=(3, 3, 4, 8)).astype(np.float32),
                              "bias": np.zeros(8, np.float32)},
                   "ints": np.arange(300, dtype=np.int32).reshape(3, 100),
                   "half": np.asarray(jnp.asarray(rng.normal(size=(5,)), jnp.bfloat16))},
        "batch_stats": {"mean": rng.normal(size=(70000,)).astype(np.float32)},
        "scalar": np.float32(2.5),
        "step": 123456,
        "neg": -3,
        "rate": 0.125,
        "name": "geocalib",
        "empty": {},
    }
    path = tmp_path / "tree.msgpack"
    path.write_bytes(serialization.msgpack_serialize(tree))
    ref = serialization.msgpack_restore(path.read_bytes())
    out = read_flax_msgpack(path)

    def check(a, b):
        if isinstance(b, dict):
            assert isinstance(a, dict) and set(a) == set(b)
            for k in b:
                check(a[k], b[k])
        elif isinstance(b, np.ndarray):
            assert a.shape == b.shape
            np.testing.assert_array_equal(np.asarray(a, np.float64), np.asarray(b, np.float64))
        else:
            assert a == b and type(a) is type(b) or float(a) == float(b)

    check(out, ref)
