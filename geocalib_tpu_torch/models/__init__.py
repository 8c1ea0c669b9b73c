"""Networks: MSCAN backbone, LightHamHead decoders, GeoCalibNet, weight loading."""

from geocalib_tpu_torch.models.geocalib_net import (GeoCalibNet, LatitudeDecoder,
                                                   LowLevelEncoder, UpDecoder)
from geocalib_tpu_torch.models.hamburger import LightHamHead
from geocalib_tpu_torch.models.mscan import MSCAN, MSCAN_VARIANTS
from geocalib_tpu_torch.models.weights import params_from_jax, read_flax_msgpack

__all__ = [
    "GeoCalibNet",
    "LatitudeDecoder",
    "LowLevelEncoder",
    "UpDecoder",
    "LightHamHead",
    "MSCAN",
    "MSCAN_VARIANTS",
    "params_from_jax",
    "read_flax_msgpack",
]
