"""Flax msgpack weights → the port's state_dict, with no JAX, Flax or msgpack.

``read_flax_msgpack`` decodes the msgpack subset that
``flax.serialization.msgpack_serialize`` writes (maps, strings, numbers,
binaries, and arrays as ext type 1 holding a msgpack ``(shape, dtype,
bytes)`` triple) with the standard library and numpy. ``params_from_jax``
maps the Flax tree ``{"params", "batch_stats"}`` onto ``GeoCalibNet``'s
parameter names, turning HWIO kernels into OIHW; ``params_to_jax`` maps
back. Both walk one table of the leaves (``_entries``).
"""

import functools
import struct
from pathlib import Path
from typing import Any, Dict, Iterator, Tuple, Union

import numpy as np
import torch

from geocalib_tpu_torch.models.mscan import MSCAN_VARIANTS

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> memoryview:
        out = self.buf[self.pos : self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.mapping(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.value() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return str(self.take(t & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        if t in (0xC4, 0xC5, 0xC6):
            return self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[t]))
        if t in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[t])
            return self.ext(self.unpack(">b"), self.take(n))
        if 0xD4 <= t <= 0xD8:
            code = self.unpack(">b")
            return self.ext(code, self.take(1 << (t - 0xD4)))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in numbers:
            return self.unpack(numbers[t])
        if t in (0xD9, 0xDA, 0xDB):
            return str(self.take(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[t])), "utf-8")
        if t in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack(">H" if t == 0xDC else ">I"))]
        if t in (0xDE, 0xDF):
            return self.mapping(self.unpack(">H" if t == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def mapping(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[bytes(key).decode() if isinstance(key, memoryview) else key] = self.value()
        return out

    @staticmethod
    def ext(code: int, payload: memoryview) -> Any:
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype, data = _Reader(payload).value()
            dtype = bytes(dtype).decode() if isinstance(dtype, memoryview) else dtype
            arr = _frombuffer(data, dtype).reshape(tuple(shape))
            return arr[()] if code == _EXT_NPSCALAR else arr
        raise ValueError(f"unsupported msgpack ext type {code}")


def _frombuffer(data: memoryview, dtype: str) -> np.ndarray:
    if dtype == "bfloat16":  # numpy has no bfloat16: widen the bits to float32
        bits = np.frombuffer(data, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32)
    return np.frombuffer(data, dtype=np.dtype(dtype))


def read_flax_msgpack(path: Union[str, Path]) -> Dict[str, Any]:
    """The nested dict of numpy arrays that flax.serialization.msgpack_restore returns."""
    data = Path(path).read_bytes()
    reader = _Reader(memoryview(data))
    tree = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"{path}: {len(data) - reader.pos} trailing bytes")
    return tree


# ---------------------------------------------------------------------- #
# Flax parameter tree <-> GeoCalibNet parameters
# ---------------------------------------------------------------------- #

# The Flax modules that wrap an nn.Conv, by the path below them to its leaves.
_CONV2D = ("Conv_0",)                 # models/modules.Conv2d
_CONV_MODULE = ("Conv2d_0", "Conv_0")  # ConvModule, DWConv
_BN = ("BatchNorm_0",)                # models/modules.BatchNorm around nn.BatchNorm


def _entries(variant: str) -> Iterator[Tuple[str, str, Tuple[str, ...], str]]:
    """(port name, Flax collection, path in that collection, kind) of every leaf;
    kind "kernel" is an HWIO/OIHW convolution kernel, "leaf" anything else."""

    def conv(name, path, wrap, bias=True):
        yield f"{name}.weight", "params", path + wrap + ("kernel",), "kernel"
        if bias:
            yield f"{name}.bias", "params", path + wrap + ("bias",), "leaf"

    def bn(name, path):
        yield f"{name}.weight", "params", path + _BN + ("scale",), "leaf"
        yield f"{name}.bias", "params", path + _BN + ("bias",), "leaf"
        yield f"{name}.running_mean", "batch_stats", path + _BN + ("mean",), "leaf"
        yield f"{name}.running_var", "batch_stats", path + _BN + ("var",), "leaf"

    def head(name, path):
        yield from conv(f"{name}.squeeze.conv", path + ("ConvModule_0",), _CONV_MODULE)
        ham = path + ("Hamburger_0",)
        yield from conv(f"{name}.ham_in.conv", ham + ("ConvModule_0",), _CONV_MODULE)
        yield from conv(f"{name}.ham_out.conv", ham + ("ConvModule_1",), _CONV_MODULE)
        yield from conv(f"{name}.align.conv", path + ("ConvModule_1",), _CONV_MODULE)
        yield from conv(f"{name}.conv_up.conv", path + ("ConvModule_2",), _CONV_MODULE, False)
        for i in range(2):
            rcu = path + ("FeatureFusionBlock_0", f"ResidualConvUnit_{i}")
            yield from conv(f"{name}.fusion.rcu{i + 1}.conv1", rcu + ("Conv2d_0",), _CONV2D)
            yield from conv(f"{name}.fusion.rcu{i + 1}.conv2", rcu + ("Conv2d_1",), _CONV2D)
        yield from conv(f"{name}.conv_unc.conv", path + ("ConvModule_3",), _CONV_MODULE, False)
        yield from conv(f"{name}.conf", path + ("Conv2d_0",), _CONV2D)

    m = ("MSCAN_0",)
    yield from conv("backbone.embeds.0.conv1", m + ("StemConv_0", "Conv2d_0"), _CONV2D)
    yield from bn("backbone.embeds.0.bn1", m + ("StemConv_0", "BatchNorm_0"))
    yield from conv("backbone.embeds.0.conv2", m + ("StemConv_0", "Conv2d_1"), _CONV2D)
    yield from bn("backbone.embeds.0.bn2", m + ("StemConv_0", "BatchNorm_1"))
    dims, _, depths = MSCAN_VARIANTS[variant]
    j = 0
    for i in range(len(dims)):
        if i > 0:
            pe = m + (f"OverlapPatchEmbed_{i - 1}",)
            yield from conv(f"backbone.embeds.{i}.proj", pe + ("Conv2d_0",), _CONV2D)
            yield from bn(f"backbone.embeds.{i}.norm", pe + ("BatchNorm_0",))
        for k in range(depths[i]):
            blk, name = m + (f"MSCANBlock_{j}",), f"backbone.stages.{i}.{k}"
            yield from bn(f"{name}.norm1", blk + ("BatchNorm_0",))
            yield from bn(f"{name}.norm2", blk + ("BatchNorm_1",))
            sa = blk + ("SpatialAttention_0",)
            yield from conv(f"{name}.attn.proj1", sa + ("Conv2d_0",), _CONV2D)
            yield from conv(f"{name}.attn.proj2", sa + ("Conv2d_1",), _CONV2D)
            am = sa + ("AttentionModule_0",)
            yield from conv(f"{name}.attn.gate.conv0", am + ("Conv2d_0",), _CONV2D)
            for s in range(6):
                yield from conv(f"{name}.attn.gate.strips.{s}", am + (f"Conv2d_{s + 1}",), _CONV2D)
            yield from conv(f"{name}.attn.gate.conv3", am + ("Conv2d_7",), _CONV2D)
            mlp = blk + ("Mlp_0",)
            yield from conv(f"{name}.mlp.fc1", mlp + ("Conv2d_0",), _CONV2D)
            yield from conv(f"{name}.mlp.dwconv", mlp + ("DWConv_0",), _CONV_MODULE)
            yield from conv(f"{name}.mlp.fc2", mlp + ("Conv2d_1",), _CONV2D)
            for ls in ("layer_scale_1", "layer_scale_2"):
                yield f"{name}.{ls}", "params", blk + (ls,), "leaf"
            j += 1
        yield f"backbone.norms.{i}.weight", "params", m + (f"LayerNorm_{i}", "scale"), "leaf"
        yield f"backbone.norms.{i}.bias", "params", m + (f"LayerNorm_{i}", "bias"), "leaf"

    lle = ("LowLevelEncoder_0",)
    yield from conv("low_level.conv1.conv", lle + ("ConvModule_0",), _CONV_MODULE)
    yield from conv("low_level.conv2.conv", lle + ("ConvModule_1",), _CONV_MODULE)
    yield from head("up_head", ("UpDecoder_0", "LightHamHead_0"))
    yield from conv("up_proj", ("UpDecoder_0", "Conv_0"), ())
    yield from head("lat_head", ("LatitudeDecoder_0", "LightHamHead_0"))
    yield from conv("lat_proj", ("LatitudeDecoder_0", "Conv_0"), ())


def params_from_jax(tree: Dict[str, Any], variant: str = "b") -> Dict[str, torch.Tensor]:
    """GeoCalibNet(variant) state_dict from a Flax tree {"params", "batch_stats"}:
    float32 copies, HWIO kernels turned into OIHW."""
    sd: Dict[str, torch.Tensor] = {}
    for name, coll, path, kind in _entries(variant):
        a = np.asarray(functools.reduce(lambda node, k: node[k], path, tree[coll]))
        sd[name] = torch.from_numpy(np.array(a.transpose(3, 2, 0, 1) if kind == "kernel" else a,
                                             np.float32, order="C"))
        if name.endswith(".running_var"):
            sd[name[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def params_to_jax(named: Dict[str, torch.Tensor], variant: str = "b") -> Dict[str, Any]:
    """The inverse of ``params_from_jax``: the Flax-named numpy tree
    {"params", "batch_stats"} of the entries of ``named`` (parameters, their
    gradients or the running statistics, by GeoCalibNet name), OIHW kernels
    turned into HWIO. Names it does not hold are left out of the tree."""
    tree: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for name, coll, path, kind in _entries(variant):
        if name not in named:
            continue
        a = named[name].detach().float().cpu().numpy()
        node = tree[coll]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(a.transpose(2, 3, 1, 0) if kind == "kernel" else a)
    return tree
