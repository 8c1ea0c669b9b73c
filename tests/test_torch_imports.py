"""The port stands alone: no JAX, Flax, msgpack, PIL, cv2 or geocalib_tpu.

Every module of geocalib_tpu_torch/, chip_smoke.py and the card tools
(tools/torch_path_witness.py, tools/nmf_stage_times.py,
tools/nmf_order_sensitivity.py, tools/lm_kernel_sweep.py) is parsed with ast; each import must name the
standard library, torch, numpy, the package itself or chip_smoke. The machine with the card has none of the others. The msgpack
reader that replaces flax.serialization is held against it here.
"""

import ast
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from geocalib_tpu_torch.models.weights import read_flax_msgpack

ROOT = Path(__file__).resolve().parents[1]
ALLOWED = {"torch", "numpy", "geocalib_tpu_torch", "chip_smoke"}
FORBIDDEN = {"jax", "jaxlib", "flax", "msgpack", "PIL", "cv2", "geocalib_tpu", "triton"}
FILES = sorted((ROOT / "geocalib_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "torch_path_witness.py",
    ROOT / "tools" / "nmf_stage_times.py", ROOT / "tools" / "nmf_order_sensitivity.py",
    ROOT / "tools" / "lm_kernel_sweep.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_stand_alone(path):
    assert path.exists(), path
    for name in _imports(path):
        assert name not in FORBIDDEN, f"{path.name} imports {name}"
        assert name in ALLOWED or name in sys.stdlib_module_names, f"{path.name} imports {name}"


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
