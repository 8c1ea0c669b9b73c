"""Flax msgpack weights → the port's state_dict, with no JAX, Flax or msgpack.

``read_flax_msgpack`` decodes the msgpack subset that
``flax.serialization.msgpack_serialize`` writes (maps, strings, numbers,
binaries, and arrays as ext type 1 holding a msgpack ``(shape, dtype,
bytes)`` triple) with the standard library and numpy. ``params_from_jax``
maps the Flax tree ``{"params", "batch_stats"}`` onto ``GeoCalibNet``'s
parameter names, turning HWIO kernels into OIHW.
"""

import struct
from pathlib import Path
from typing import Any, Dict, Union

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
# Flax parameter tree → GeoCalibNet state_dict
# ---------------------------------------------------------------------- #


def _tensor(a) -> torch.Tensor:
    """A writable float32 copy."""
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _conv(sd: Dict[str, torch.Tensor], name: str, node: Dict[str, Any]) -> None:
    """A Flax Conv (possibly wrapped in Conv2d_0/ConvModule) → name.weight/.bias."""
    while "kernel" not in node:
        (node,) = [v for k, v in node.items() if k.startswith(("Conv2d_", "Conv_"))]
    sd[f"{name}.weight"] = _tensor(np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in node:
        sd[f"{name}.bias"] = _tensor(node["bias"])


def _bn(sd, name: str, params: Dict[str, Any], stats: Dict[str, Any]) -> None:
    p, s = params["BatchNorm_0"], stats["BatchNorm_0"]
    sd[f"{name}.weight"] = _tensor(p["scale"])
    sd[f"{name}.bias"] = _tensor(p["bias"])
    sd[f"{name}.running_mean"] = _tensor(s["mean"])
    sd[f"{name}.running_var"] = _tensor(s["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0)


def _head(sd, name: str, p: Dict[str, Any]) -> None:
    _conv(sd, f"{name}.squeeze.conv", p["ConvModule_0"])
    _conv(sd, f"{name}.ham_in.conv", p["Hamburger_0"]["ConvModule_0"])
    _conv(sd, f"{name}.ham_out.conv", p["Hamburger_0"]["ConvModule_1"])
    _conv(sd, f"{name}.align.conv", p["ConvModule_1"])
    _conv(sd, f"{name}.conv_up.conv", p["ConvModule_2"])
    fusion = p["FeatureFusionBlock_0"]
    for i in range(2):
        rcu = fusion[f"ResidualConvUnit_{i}"]
        _conv(sd, f"{name}.fusion.rcu{i + 1}.conv1", rcu["Conv2d_0"])
        _conv(sd, f"{name}.fusion.rcu{i + 1}.conv2", rcu["Conv2d_1"])
    _conv(sd, f"{name}.conv_unc.conv", p["ConvModule_3"])
    _conv(sd, f"{name}.conf", p["Conv2d_0"])


def params_from_jax(tree: Dict[str, Any], variant: str = "b") -> Dict[str, torch.Tensor]:
    """GeoCalibNet(variant) state_dict from a Flax tree {"params", "batch_stats"}."""
    p, bs = tree["params"], tree["batch_stats"]
    pm, bm = p["MSCAN_0"], bs["MSCAN_0"]
    sd: Dict[str, torch.Tensor] = {}

    _conv(sd, "backbone.embeds.0.conv1", pm["StemConv_0"]["Conv2d_0"])
    _bn(sd, "backbone.embeds.0.bn1", pm["StemConv_0"]["BatchNorm_0"], bm["StemConv_0"]["BatchNorm_0"])
    _conv(sd, "backbone.embeds.0.conv2", pm["StemConv_0"]["Conv2d_1"])
    _bn(sd, "backbone.embeds.0.bn2", pm["StemConv_0"]["BatchNorm_1"], bm["StemConv_0"]["BatchNorm_1"])
    dims, _, depths = MSCAN_VARIANTS[variant]
    j = 0
    for i in range(len(dims)):
        if i > 0:
            pe, be = pm[f"OverlapPatchEmbed_{i - 1}"], bm[f"OverlapPatchEmbed_{i - 1}"]
            _conv(sd, f"backbone.embeds.{i}.proj", pe["Conv2d_0"])
            _bn(sd, f"backbone.embeds.{i}.norm", pe["BatchNorm_0"], be["BatchNorm_0"])
        for k in range(depths[i]):
            blk, bst = pm[f"MSCANBlock_{j}"], bm[f"MSCANBlock_{j}"]
            name = f"backbone.stages.{i}.{k}"
            _bn(sd, f"{name}.norm1", blk["BatchNorm_0"], bst["BatchNorm_0"])
            _bn(sd, f"{name}.norm2", blk["BatchNorm_1"], bst["BatchNorm_1"])
            sa = blk["SpatialAttention_0"]
            _conv(sd, f"{name}.attn.proj1", sa["Conv2d_0"])
            _conv(sd, f"{name}.attn.proj2", sa["Conv2d_1"])
            am = sa["AttentionModule_0"]
            _conv(sd, f"{name}.attn.gate.conv0", am["Conv2d_0"])
            for s in range(6):
                _conv(sd, f"{name}.attn.gate.strips.{s}", am[f"Conv2d_{s + 1}"])
            _conv(sd, f"{name}.attn.gate.conv3", am["Conv2d_7"])
            _conv(sd, f"{name}.mlp.fc1", blk["Mlp_0"]["Conv2d_0"])
            _conv(sd, f"{name}.mlp.dwconv", blk["Mlp_0"]["DWConv_0"])
            _conv(sd, f"{name}.mlp.fc2", blk["Mlp_0"]["Conv2d_1"])
            for ls in ("layer_scale_1", "layer_scale_2"):
                sd[f"{name}.{ls}"] = _tensor(blk[ls])
            j += 1
        ln = pm[f"LayerNorm_{i}"]
        sd[f"backbone.norms.{i}.weight"] = _tensor(ln["scale"])
        sd[f"backbone.norms.{i}.bias"] = _tensor(ln["bias"])

    _conv(sd, "low_level.conv1.conv", p["LowLevelEncoder_0"]["ConvModule_0"])
    _conv(sd, "low_level.conv2.conv", p["LowLevelEncoder_0"]["ConvModule_1"])
    _head(sd, "up_head", p["UpDecoder_0"]["LightHamHead_0"])
    _conv(sd, "up_proj", p["UpDecoder_0"]["Conv_0"])
    _head(sd, "lat_head", p["LatitudeDecoder_0"]["LightHamHead_0"])
    _conv(sd, "lat_proj", p["LatitudeDecoder_0"]["Conv_0"])
    return sd
