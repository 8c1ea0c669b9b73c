"""Hierarchical configuration: dict merge, YAML files and CLI dot-overrides.

Port of geocalib_tpu/utils/config.py with the standard library only, since
the card's machine has no PyYAML:

- ``save_yaml`` writes the conf as JSON-flow YAML (a JSON document whose
  floats always carry a dot and a signed exponent, ``1.0e-05``, so that
  YAML 1.1 resolvers read them as floats and not as strings);
- ``load_yaml`` reads such a file with ``json``, and any other YAML file
  with PyYAML, imported there, which raises where PyYAML is absent;
- ``_parse_value`` resolves a dotlist value as ``yaml.safe_load`` resolves
  a plain scalar or a flow list: null, bool, int, float, else the string.
  Timestamps and flow mappings stay strings.
"""

import copy
import json
import math
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

# YAML 1.1's implicit resolvers, as PyYAML's SafeLoader has them
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def merge(*confs: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Recursive dict merge; later arguments win."""
    out: Dict[str, Any] = {}
    for conf in confs:
        if conf is None:
            continue
        for k, v in conf.items():
            if isinstance(v, dict) and isinstance(out.get(k), dict):
                out[k] = merge(out[k], v)
            else:
                out[k] = copy.deepcopy(v)
    return out


def _float(v: float) -> str:
    if math.isnan(v) or math.isinf(v):
        raise ValueError(f"a non-finite float ({v}) has no JSON-flow YAML form")
    text = repr(v)
    mantissa, _, exponent = text.partition("e")
    if "." not in mantissa:
        mantissa += ".0"
    if exponent and exponent[0] not in "+-":
        exponent = "+" + exponent
    return mantissa + ("e" + exponent if exponent else "")


def _emit(v: Any, indent: int) -> str:
    pad, inner = " " * indent, " " * (indent + 2)
    if isinstance(v, dict):
        if not v:
            return "{}"
        items = [f"{inner}{json.dumps(str(k))}: {_emit(x, indent + 2)}" for k, x in v.items()]
        return "{\n" + ",\n".join(items) + f"\n{pad}}}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_emit(x, indent) for x in v) + "]"
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(int(v))
    if isinstance(v, float):
        return _float(v)
    if isinstance(v, str):
        return json.dumps(v)
    raise TypeError(f"cannot write a {type(v).__name__} to the conf")


def save_yaml(conf: Dict[str, Any], path: Union[str, Path]) -> None:
    """Write `conf` as JSON-flow YAML, which both JSON and YAML 1.1 readers read."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(_emit(conf, 0) + "\n")


def load_yaml(path: Union[str, Path]) -> Dict[str, Any]:
    """A conf written by ``save_yaml`` (read with json), or any YAML file (PyYAML)."""
    text = Path(path).read_text()
    try:
        return json.loads(text) or {}
    except json.JSONDecodeError:
        pass
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError(f"{path} is not JSON-flow YAML, and reading other YAML needs "
                           "PyYAML, which is not installed") from e
    with open(path) as fh:
        return yaml.safe_load(fh) or {}


def _int(s: str) -> int:
    s = s.replace("_", "")
    sign = -1 if s[0] == "-" else 1
    s = s.lstrip("+-")
    if s == "0":
        return 0
    if s.startswith("0b"):
        return sign * int(s[2:], 2)
    if s.startswith("0x"):
        return sign * int(s[2:], 16)
    if s[0] == "0":
        return sign * int(s, 8)
    if ":" in s:
        return sign * sum(int(d) * 60 ** i for i, d in enumerate(reversed(s.split(":"))))
    return sign * int(s)


def _yaml_float(s: str) -> float:
    s = s.replace("_", "").lower()
    sign = -1.0 if s[0] == "-" else 1.0
    s = s.lstrip("+-")
    if s == ".inf":
        return sign * math.inf
    if s == ".nan":
        return math.nan
    if ":" in s:
        return sign * sum(float(d) * 60 ** i for i, d in enumerate(reversed(s.split(":"))))
    return sign * float(s)


def _split_flow(body: str) -> List[str]:
    """Items of a flow sequence's body at nesting depth 0, outside quotes."""
    items, depth, quote, cur = [], 0, "", ""
    for ch in body:
        if quote:
            quote = "" if ch == quote else quote
        elif ch in "\"'":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(cur)
            cur = ""
            continue
        cur += ch
    if cur.strip():
        items.append(cur)
    return items


def _parse_value(raw: str) -> Any:
    s = raw.strip()
    if s.startswith("[") and s.endswith("]"):
        return [_parse_value(item) for item in _split_flow(s[1:-1])]
    if len(s) >= 2 and s[0] == s[-1] == '"':
        return json.loads(s)
    if len(s) >= 2 and s[0] == s[-1] == "'":
        return s[1:-1].replace("''", "'")
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _INT.match(s):
        return _int(s)
    if _FLOAT.match(s):
        return _yaml_float(s)
    return s


def apply_dotlist(conf: Dict[str, Any], dotlist: List[str]) -> Dict[str, Any]:
    """Apply ["a.b=3", "name=foo"]-style overrides (OmegaConf dotlist parity)."""
    out = copy.deepcopy(conf)
    for item in dotlist:
        key, _, raw = item.partition("=")
        node = out
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(raw)
    return out


def get_path(conf: Dict[str, Any], dotted: str, default: Any = None) -> Any:
    node: Any = conf
    for p in dotted.split("."):
        if not isinstance(node, dict) or p not in node:
            return default
        node = node[p]
    return node
