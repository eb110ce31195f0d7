"""Schema'd plan/IR codec for the worker control plane (a copy of
``trino_tpu.runtime.plancodec``, over this package's plan classes).

Reference blueprint: Trino ships plan fragments between coordinator and
workers as JSON (PlanFragment and every PlanNode/Expression are
Jackson-annotated, server/remotetask/HttpRemoteTask.java:743) — NEVER as
executable serialization. This codec does the same for this engine:
frozen-dataclass plan nodes, IR expressions, types, and predicate domains
encode to tagged JSON; decoding instantiates only classes from the fixed
registry below, so a hostile payload cannot execute code (the pickle codec it
replaces was remote code execution for anyone who could reach a worker port).
"""

from __future__ import annotations

import dataclasses
import datetime
import enum
import json
from typing import Any, Dict

import numpy as np


def _registry() -> Dict[str, type]:
    from ..planner import fragmenter as frag_mod
    from ..planner import plan as plan_mod
    from ..spi import connector as conn_mod
    from ..spi import predicate as pred_mod
    from ..spi import types as types_mod
    from ..sql import ir as ir_mod

    reg: Dict[str, type] = {}
    for mod in (plan_mod, frag_mod, ir_mod, types_mod, pred_mod, conn_mod):
        for name in dir(mod):
            obj = getattr(mod, name)
            if isinstance(obj, type) and (
                dataclasses.is_dataclass(obj) or issubclass(obj, enum.Enum)
            ):
                key = f"{obj.__module__.rsplit('.', 1)[-1]}.{obj.__name__}"
                reg[key] = obj
    return reg


_REG: Dict[str, type] = {}


def _reg() -> Dict[str, type]:
    global _REG
    if not _REG:
        _REG = _registry()
    return _REG


def _key_of(cls: type) -> str:
    return f"{cls.__module__.rsplit('.', 1)[-1]}.{cls.__name__}"


def encode(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return obj
    if isinstance(obj, enum.Enum):
        return {"@e": _key_of(type(obj)), "v": obj.name}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        key = _key_of(type(obj))
        if key not in _reg():
            raise TypeError(f"unregistered dataclass {key}")
        fields = {
            f.name: encode(getattr(obj, f.name)) for f in dataclasses.fields(obj)
        }
        return {"@t": key, "f": fields}
    if isinstance(obj, tuple):
        return {"@u": [encode(x) for x in obj]}
    if isinstance(obj, list):
        return [encode(x) for x in obj]
    if isinstance(obj, dict):
        return {"@m": [[encode(k), encode(v)] for k, v in obj.items()]}
    if isinstance(obj, np.ndarray):
        return {"@np": obj.dtype.str, "v": obj.tolist()}
    if isinstance(obj, np.generic):
        return encode(obj.item())
    if isinstance(obj, datetime.datetime):
        return {"@ts": obj.isoformat()}
    if isinstance(obj, datetime.date):
        return {"@dt": obj.isoformat()}
    raise TypeError(f"cannot encode {type(obj).__name__}")


def decode(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, list):
        return [decode(x) for x in obj]
    if isinstance(obj, dict):
        if "@t" in obj:
            cls = _reg().get(obj["@t"])
            if cls is None:
                raise ValueError(f"unknown plan class {obj['@t']!r}")
            return cls(**{k: decode(v) for k, v in obj["f"].items()})
        if "@e" in obj:
            cls = _reg().get(obj["@e"])
            if cls is None:
                raise ValueError(f"unknown enum {obj['@e']!r}")
            return cls[obj["v"]]
        if "@u" in obj:
            return tuple(decode(x) for x in obj["@u"])
        if "@m" in obj:
            return {decode(k): decode(v) for k, v in obj["@m"]}
        if "@np" in obj:
            return np.asarray(obj["v"], dtype=np.dtype(obj["@np"]))
        if "@ts" in obj:
            return datetime.datetime.fromisoformat(obj["@ts"])
        if "@dt" in obj:
            return datetime.date.fromisoformat(obj["@dt"])
        raise ValueError(f"untagged object {list(obj)[:3]}")
    raise ValueError(f"cannot decode {type(obj).__name__}")


def dumps(obj: Any) -> bytes:
    return json.dumps(encode(obj), separators=(",", ":")).encode()


def fingerprint(obj: Any) -> str:
    """Structural content hash of anything the codec can encode (plan
    subtrees, fragments). THE fingerprint function of the engine: capstore
    keys capacity vectors on it and the statistics feedback plane
    (runtime/statstore.py) keys estimate-vs-actual history on it, so both
    stores agree on what "the same plan shape" means. Empty string when the
    object holds types outside the registry — no key, no persistence."""
    import hashlib

    try:
        blob = dumps(obj)
    except Exception:  # noqa: BLE001 — a fingerprint failure must only ever
        # mean "no persistence": encode recurses through arbitrary node
        # fields (RecursionError on 1000-conjunct chains, AttributeError
        # from a property), and both capstore and statstore callers sit on
        # query paths that must not fail for a missing cache key
        return ""
    return hashlib.sha256(blob).hexdigest()


def loads(data: bytes) -> Any:
    return decode(json.loads(data))
