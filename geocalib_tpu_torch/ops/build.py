"""Builds the CUDA sources into one shared library and loads it with ctypes.

Every ``csrc/*.cu`` file is compiled for sm_90a by an ``nvcc`` process of its
own, all started together, and one more ``nvcc`` call links the objects into
``build/geocalib_tpu_torch/libgctorch.so`` under the repository root. The build
runs at first use, and again whenever a hash of the sources and flags
changes. The library has a plain C interface, so no PyTorch header is
compiled. ``-Xptxas -v`` makes the compiler report each kernel's registers and
spills; the report is kept in ``build_log["ptxas"]``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "geocalib_tpu_torch"
LIB_NAME = "libgctorch.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # up_x, up_y, lat_sin, up_conf, lat_conf, cam, grav, M, G, H, cost,
    # B, N, w, model, P, loss_id, up_scale, lat_scale, mask_bits, log_focal, stream
    "gc_lm_system": [_P] * 11 + [_I] * 6 + [_F, _F, _I, _I, _P],
    # up_x, up_y, lat_sin, up_conf, lat_conf, cam, grav, cost,
    # B, N, w, model, loss_id, up_scale, lat_scale, stream
    "gc_lm_cost": [_P] * 8 + [_I] * 5 + [_F, _F, _P],
    # threads, cluster, active clusters (out), w
    "gc_lm_config": [_P, _P, _P, _I],
    # dtype, x, bases, coef, bt, gram, partial, B, N, D, R, steps, inv_t, eps, chunk, stream
    "gc_nmf": [_I] + [_P] * 6 + [_I] * 5 + [_F, _F, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_log = {"built": False, "ptxas": ""}  # whether nvcc ran in this process, its report


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built where the CUDA "
                       "toolkit is installed")


def sources() -> Sequence[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for flag in NVCC_FLAGS:
        h.update(flag.encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless an up-to-date one exists."""
    so = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    if so.exists() and stamp.exists() and stamp.read_text().strip() == digest:
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                         for src, obj in zip(sources(), objs))]
    done = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        done.append((cmd, proc.returncode, out, err))
    for result in done:
        _raise_on_failure(*result)
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}.tmp"
    cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _raise_on_failure(cmd, proc.returncode, proc.stdout, proc.stderr)
    for obj in objs:
        obj.unlink()
    os.replace(tmp, so)
    stamp.write_text(digest)
    build_log.update(built=True, ptxas="".join(out + err for _, _, out, err in done))
    return so


def _raise_on_failure(cmd: Sequence[str], code: int, out: str, err: str) -> None:
    if code != 0:
        raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{out}\n{err}")


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(code: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def ptr(t) -> Optional[int]:
    """Device pointer of a tensor (None for an absent optional input)."""
    return None if t is None else t.data_ptr()
