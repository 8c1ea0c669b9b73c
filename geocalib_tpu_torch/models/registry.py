"""Model registry: name → the port's module class, plus conf-driven construction.

Port of geocalib_tpu/models/registry.py. A torch module's constructor
defaults stand in for the Flax dataclass fields: ``default_conf`` reads them
from the signature, and ``build_model`` merges a user conf onto them, refusing
unknown keys, and can autoload pretrained weights named by the conf.
"""

import importlib
import inspect
from pathlib import Path
from typing import Any, Dict, Optional, Set, Tuple

# name → "module:attribute"
_REGISTRY: Dict[str, str] = {
    "networks.geocalib": "geocalib_tpu_torch.models.geocalib_net:GeoCalibNet",
    "networks.deepcalib": "geocalib_tpu_torch.models.deepcalib:DeepCalib",
    "encoders.mscan": "geocalib_tpu_torch.models.mscan:MSCAN",
    "encoders.low_level_encoder": "geocalib_tpu_torch.models.geocalib_net:LowLevelEncoder",
    "encoders.vgg": "geocalib_tpu_torch.models.encoders:VGG",
    "encoders.resnet": "geocalib_tpu_torch.models.encoders:ResNet",
    "decoders.up_decoder": "geocalib_tpu_torch.models.geocalib_net:UpDecoder",
    "decoders.latitude_decoder": "geocalib_tpu_torch.models.geocalib_net:LatitudeDecoder",
    "decoders.light_hamburger": "geocalib_tpu_torch.models.hamburger:LightHamHead",
    "decoders.fpn": "geocalib_tpu_torch.models.fpn:FPN",
    "cache_loader": "geocalib_tpu_torch.models.cache_loader:CacheLoader",
    # external-dependency comparison baselines (import-gated)
    "optimization.vp_from_prior": "geocalib_tpu_torch.models.baselines:VPEstimator",
    "networks.dust3r": "geocalib_tpu_torch.models.baselines:Dust3R",
}


def register_model(name: str, target: str) -> None:
    _REGISTRY[name] = target


def get_model(name: str) -> Any:
    """Resolve a registered (or "module:attribute") model class."""
    if name in _REGISTRY:
        module_name, attr = _REGISTRY[name].split(":")
    elif ":" in name:
        module_name, attr = name.split(":")
    else:
        raise ValueError(f"unknown model {name!r}; registered: {sorted(_REGISTRY)}")
    return getattr(importlib.import_module(module_name), attr)


def _arguments(cls: Any):
    return [p for p in inspect.signature(cls.__init__).parameters.values()
            if p.name != "self" and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def default_conf(cls: Any) -> Dict[str, Any]:
    """Argument name → default of a module class's constructor (the arguments
    without a default are left out)."""
    return {p.name: p.default for p in _arguments(cls) if p.default is not p.empty}


def _required(cls: Any) -> Set[str]:
    return {p.name for p in _arguments(cls) if p.default is p.empty}


def build_model(name: str, conf: Optional[Dict[str, Any]] = None) -> Tuple[Any, Optional[Any]]:
    """Construct a registered model from a conf dict; autoload weights.

    conf keys are checked against the constructor's arguments (ValueError on
    unknown keys). The reserved key ``weights`` names pretrained weights, which
    only ``networks.geocalib`` loads, from a local ``.msgpack`` of the JAX
    package (read with ``read_flax_msgpack``, mapped with ``params_from_jax``
    and loaded into the module). Returns ``(module, state_dict-or-None)``.
    """
    conf = dict(conf or {})
    weights = conf.pop("weights", None)
    cls = get_model(name)
    known = default_conf(cls)
    unknown = set(conf) - set(known) - _required(cls)
    if unknown:
        raise ValueError(f"unknown conf keys {sorted(unknown)} for model {name!r}; "
                         f"known: {sorted(set(known) | _required(cls))}")
    module = cls(**{**known, **conf})

    params = None
    if weights is not None:
        if name != "networks.geocalib":
            raise ValueError(f"weight autoload is only supported for 'networks.geocalib' "
                             f"(got {name!r}); construct the model and load its params "
                             f"explicitly instead")
        path = Path(str(weights))
        if path.suffix != ".msgpack":
            raise NotImplementedError(
                f"weights {str(weights)!r}: release names and reference .tar checkpoints need "
                f"the hub and the torch-checkpoint conversion, not yet in the port (ROADMAP "
                f"Queue 1 item 2); pass a local .msgpack of the JAX package")
        from geocalib_tpu_torch.models.weights import params_from_jax, read_flax_msgpack

        params = params_from_jax(read_flax_msgpack(path), conf.get("variant", "b"))
        module.load_state_dict(params)
    return module, params
