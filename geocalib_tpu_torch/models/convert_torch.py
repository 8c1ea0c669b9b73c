"""Convert the original GeoCalib's PyTorch checkpoints for the port.

Port of geocalib_tpu/models/convert_torch.py. The released checkpoints
(``geocalib-{pinhole,distorted}.tar``) hold the state_dict of the original
torch model, whose parameter names differ from the port's ``GeoCalibNet``.
``convert_state_dict`` maps each key onto the JAX package's Flax variable
tree (an explicit table, every key family listed; OIHW conv weights become
HWIO; BatchNorm running statistics go to the ``batch_stats`` collection),
so the converted file is the JAX package's own format and loads in both
packages. ``state_dict_from_torch`` goes on to the port's state_dict through
``params_from_jax``.

CLI::

    python -m geocalib_tpu_torch.models.convert_torch checkpoint.tar params.msgpack

The table is numpy only; torch reads the ``.tar`` (``weights_only=True``).
"""

from typing import Any, Dict, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]

# depths per stage of the released "b" architecture
_DEPTHS = (3, 3, 12, 3)


def _conv(w: np.ndarray) -> np.ndarray:
    """torch conv weight OIHW → Flax HWIO (also right for depthwise convs)."""
    return np.transpose(w, (2, 3, 1, 0))


class _Mapping:
    def __init__(self):
        self.table: Dict[str, Tuple[Path, str]] = {}

    def conv(self, ref: str, flax_path: str, bias: bool = True) -> None:
        base = tuple(flax_path.split("/"))
        self.table[f"{ref}.weight"] = (("params",) + base + ("kernel",), "conv")
        if bias:
            self.table[f"{ref}.bias"] = (("params",) + base + ("bias",), "copy")

    def bn(self, ref: str, flax_path: str) -> None:
        base = tuple(flax_path.split("/")) + ("BatchNorm_0",)
        self.table[f"{ref}.weight"] = (("params",) + base + ("scale",), "copy")
        self.table[f"{ref}.bias"] = (("params",) + base + ("bias",), "copy")
        self.table[f"{ref}.running_mean"] = (("batch_stats",) + base + ("mean",), "copy")
        self.table[f"{ref}.running_var"] = (("batch_stats",) + base + ("var",), "copy")

    def ln(self, ref: str, flax_path: str) -> None:
        base = tuple(flax_path.split("/"))
        self.table[f"{ref}.weight"] = (("params",) + base + ("scale",), "copy")
        self.table[f"{ref}.bias"] = (("params",) + base + ("bias",), "copy")

    def direct(self, ref: str, flax_path: str) -> None:
        self.table[ref] = (("params",) + tuple(flax_path.split("/")), "copy")


def _build_mapping() -> Dict[str, Tuple[Path, str]]:
    """Original torch key → (path in the Flax variable tree, "conv" or "copy")."""
    m = _Mapping()

    # MSCAN backbone → MSCAN_0
    bb = "MSCAN_0"
    # stage 1 stem: convs at torch Sequential index 0 and 3, BatchNorms at 1 and 4
    m.conv("backbone.patch_embed1.proj.0", f"{bb}/StemConv_0/Conv2d_0/Conv_0")
    m.bn("backbone.patch_embed1.proj.1", f"{bb}/StemConv_0/BatchNorm_0")
    m.conv("backbone.patch_embed1.proj.3", f"{bb}/StemConv_0/Conv2d_1/Conv_0")
    m.bn("backbone.patch_embed1.proj.4", f"{bb}/StemConv_0/BatchNorm_1")
    for s in (2, 3, 4):
        pe = f"{bb}/OverlapPatchEmbed_{s - 2}"
        m.conv(f"backbone.patch_embed{s}.proj", f"{pe}/Conv2d_0/Conv_0")
        m.bn(f"backbone.patch_embed{s}.norm", f"{pe}/BatchNorm_0")
    for s in range(4):
        m.ln(f"backbone.norm{s + 1}", f"{bb}/LayerNorm_{s}")

    block_idx = 0
    for s, depth in enumerate(_DEPTHS):
        for j in range(depth):
            r = f"backbone.block{s + 1}.{j}"
            f = f"{bb}/MSCANBlock_{block_idx}"
            block_idx += 1
            m.direct(f"{r}.layer_scale_1", f"{f}/layer_scale_1")
            m.direct(f"{r}.layer_scale_2", f"{f}/layer_scale_2")
            m.bn(f"{r}.norm1", f"{f}/BatchNorm_0")
            m.bn(f"{r}.norm2", f"{f}/BatchNorm_1")
            att = f"{f}/SpatialAttention_0"
            m.conv(f"{r}.attn.proj_1", f"{att}/Conv2d_0/Conv_0")
            m.conv(f"{r}.attn.proj_2", f"{att}/Conv2d_1/Conv_0")
            sgu = f"{att}/AttentionModule_0"
            # 5x5 depthwise, then the strip pairs (1,7)(7,1) (1,11)(11,1) (1,21)(21,1), 1x1 mix
            m.conv(f"{r}.attn.spatial_gating_unit.conv0", f"{sgu}/Conv2d_0/Conv_0")
            for p, (a, b) in enumerate(((0, 1), (0, 2), (1, 1), (1, 2), (2, 1), (2, 2))):
                m.conv(f"{r}.attn.spatial_gating_unit.conv{a}_{b}", f"{sgu}/Conv2d_{p + 1}/Conv_0")
            m.conv(f"{r}.attn.spatial_gating_unit.conv3", f"{sgu}/Conv2d_7/Conv_0")
            mlp = f"{f}/Mlp_0"
            m.conv(f"{r}.mlp.fc1", f"{mlp}/Conv2d_0/Conv_0")
            m.conv(f"{r}.mlp.dwconv.dwconv", f"{mlp}/DWConv_0/Conv2d_0/Conv_0")
            m.conv(f"{r}.mlp.fc2", f"{mlp}/Conv2d_1/Conv_0")

    # low-level encoder
    m.conv("ll_enc.conv1.conv", "LowLevelEncoder_0/ConvModule_0/Conv2d_0/Conv_0")
    m.conv("ll_enc.conv2.conv", "LowLevelEncoder_0/ConvModule_1/Conv2d_0/Conv_0")

    # perspective decoder heads
    heads = (("up_head", "UpDecoder_0", "linear_pred_up"),
             ("latitude_head", "LatitudeDecoder_0", "linear_pred_latitude"))
    for ref_head, flax_head, pred in heads:
        r = f"perspective_decoder.{ref_head}.decoder"
        f = f"{flax_head}/LightHamHead_0"
        m.conv(f"{r}.squeeze.conv", f"{f}/ConvModule_0/Conv2d_0/Conv_0")
        m.conv(f"{r}.hamburger.ham_in.conv", f"{f}/Hamburger_0/ConvModule_0/Conv2d_0/Conv_0")
        m.conv(f"{r}.hamburger.ham_out.conv", f"{f}/Hamburger_0/ConvModule_1/Conv2d_0/Conv_0")
        m.conv(f"{r}.align.conv", f"{f}/ConvModule_1/Conv2d_0/Conv_0")
        m.conv(f"{r}.out_conv.conv", f"{f}/ConvModule_2/Conv2d_0/Conv_0", bias=False)
        for unit in (1, 2):
            ffb = f"{f}/FeatureFusionBlock_0/ResidualConvUnit_{unit - 1}"
            m.conv(f"{r}.ll_fusion.resConfUnit{unit}.conv1", f"{ffb}/Conv2d_0/Conv_0")
            m.conv(f"{r}.ll_fusion.resConfUnit{unit}.conv2", f"{ffb}/Conv2d_1/Conv_0")
        m.conv(f"{r}.linear_pred_uncertainty.0.conv", f"{f}/ConvModule_3/Conv2d_0/Conv_0",
               bias=False)
        m.conv(f"{r}.linear_pred_uncertainty.1", f"{f}/Conv2d_0/Conv_0")
        m.conv(f"perspective_decoder.{ref_head}.{pred}", f"{flax_head}/Conv_0")

    return m.table


_SENTINEL = "backbone.patch_embed1.proj.0.weight"


def unflatten(flat: Dict[Path, Any]) -> Dict[str, Any]:
    """Nested dicts from {path tuple: leaf}, keys in the order the paths come
    (``flax.traverse_util.unflatten_dict``)."""
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def convert_state_dict(state_dict: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Map an original torch state_dict (numpy values) onto the Flax variable
    tree {"params", "batch_stats"} of the JAX package's GeoCalibNet ("b")."""
    if _SENTINEL not in state_dict:
        # siclib training checkpoints nest one extra segment after the first
        strip = lambda k: ".".join(k.split(".")[:1] + k.split(".")[2:])  # noqa: E731
        state_dict = {strip(k): v for k, v in state_dict.items()}
    # the released training code renamed gravity heads to up heads
    state_dict = {k.replace("gravity_head", "up_head"): v for k, v in state_dict.items()}

    mapping = _build_mapping()
    flat: Dict[Path, np.ndarray] = {}
    unused = []
    for key, value in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key not in mapping:
            unused.append(key)
            continue
        path, kind = mapping[key]
        v = np.asarray(value, dtype=np.float32)
        flat[path] = _conv(v) if kind == "conv" else v
    missing = set(mapping) - {k for k in state_dict if not k.endswith("num_batches_tracked")}
    if unused:
        raise ValueError(f"unmapped reference keys: {sorted(unused)[:10]} ...")
    if missing:
        raise ValueError(f"reference keys absent from checkpoint: {sorted(missing)[:10]} ...")
    return unflatten(flat)


def state_dict_from_torch(state_dict: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The port's GeoCalibNet ("b") state_dict from an original torch state_dict."""
    from geocalib_tpu_torch.models.weights import params_from_jax

    return params_from_jax(convert_state_dict(state_dict), "b")


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Read an original ``.tar`` checkpoint (or a bare state_dict) as numpy."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v.numpy() for k, v in sd.items()}


def main(argv=None) -> None:
    import argparse

    from geocalib_tpu_torch.models.weights import write_flax_msgpack

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("checkpoint", help="original .tar checkpoint")
    ap.add_argument("out", help="output params .msgpack")
    args = ap.parse_args(argv)

    write_flax_msgpack(convert_state_dict(load_torch_checkpoint(args.checkpoint)), args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
