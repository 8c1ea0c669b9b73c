"""The port stands alone: no JAX, Flax, msgpack, cv2 or geocalib_tpu, and PIL,
h5py, PyYAML and wandb only inside the functions that use them.

Every module of geocalib_tpu_torch/, chip_smoke.py, bench_torch.py and the
card tools (tools/torch_path_witness.py, tools/nmf_stage_times.py,
tools/nmf_order_sensitivity.py, tools/lm_kernel_sweep.py,
tools/torch_step_profile.py) is parsed with ast;
each import must name the standard library, torch, numpy, the package itself
or chip_smoke, except that a function may import PIL, h5py or yaml (image
files, h5 results and a user's YAML conf, as the JAX package does) or wandb
(an optional backend of the metrics writer). The machine with the card has
none of the others. Every module of the package is then imported in a fresh
interpreter, which must not have loaded jax, geocalib_tpu, PIL, h5py, yaml,
wandb or tensorboard. The msgpack reader that replaces flax.serialization is
held against it here.
"""

import ast
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
# optional on the card: imported where a file is read or written, or a backend started
IN_FUNCTIONS = {"PIL", "h5py", "yaml", "wandb"}
FORBIDDEN = {"jax", "jaxlib", "flax", "msgpack", "cv2", "geocalib_tpu", "triton"}
FILES = sorted((ROOT / "geocalib_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "bench_torch.py", ROOT / "tools" / "torch_path_witness.py",
    ROOT / "tools" / "nmf_stage_times.py", ROOT / "tools" / "nmf_order_sensitivity.py",
    ROOT / "tools" / "lm_kernel_sweep.py", ROOT / "tools" / "torch_step_profile.py"]


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
            "'tensorboard') if m in sys.modules))")
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
