"""Reflect: runtime field enumeration, paths, and setters.

Equivalent of fyrox-core/src/reflect/mod.rs (the trait powering the
editor Inspector and reflect-path property animation). Python classes
carry their own introspection; this module adds what the reference's
derive macro generates: a uniform field model over dataclasses,
NamedTuples, dicts, lists and numpy arrays, dotted/indexed field PATHS
("transform.position[1]"), and functional setters that work on frozen
containers (NamedTuple._replace / dataclasses.replace / a set on a copy
of an array or tensor).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, List, Tuple

import numpy as np
import torch

__all__ = ["fields", "get_path", "set_path", "enumerate_paths"]

_TOKEN = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)|\[(\d+)\]")


def _is_namedtuple(obj):
    return isinstance(obj, tuple) and hasattr(obj, "_fields")


def fields(obj) -> List[Tuple[str, Any]]:
    """(name, value) pairs of an object's reflectable fields."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [(f.name, getattr(obj, f.name))
                for f in dataclasses.fields(obj)]
    if _is_namedtuple(obj):
        return list(zip(obj._fields, obj))
    if isinstance(obj, dict):
        return [(str(k), v) for k, v in obj.items()]
    if isinstance(obj, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(obj)]
    return []


def _parse(path: str):
    out = []
    pos = 0
    while pos < len(path):
        if path[pos] == ".":
            pos += 1
            continue
        m = _TOKEN.match(path, pos)
        if not m:
            raise ValueError(f"bad reflect path {path!r} at {pos}")
        out.append(m.group(1) if m.group(1) is not None else int(m.group(2)))
        pos = m.end()
    return out


def _get_one(obj, key):
    if isinstance(key, int):
        return obj[key]
    if isinstance(obj, dict):
        return obj[key]
    return getattr(obj, key)


def get_path(obj, path: str):
    """Resolve "a.b[2].c" against nested containers (Reflect::resolve_path)."""
    for key in _parse(path):
        obj = _get_one(obj, key)
    return obj


def _set_one(obj, key, value):
    """Functional single-level set; returns the updated container."""
    if isinstance(obj, np.ndarray):
        out = obj.copy()
        out[key] = value
        return out
    if isinstance(obj, torch.Tensor):
        out = obj.clone()                   # same device and dtype
        out[key] = value
        return out
    if isinstance(key, int):
        if isinstance(obj, list):
            out = list(obj)
            out[key] = value
            return out
        if _is_namedtuple(obj):
            return type(obj)(*[value if i == key else v
                               for i, v in enumerate(obj)])
        if isinstance(obj, tuple):
            return tuple(value if i == key else v for i, v in enumerate(obj))
        raise TypeError(f"cannot index-set {type(obj)}")
    if isinstance(obj, dict):
        out = dict(obj)
        out[key] = value
        return out
    if _is_namedtuple(obj):
        return obj._replace(**{key: value})
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{key: value})
    raise TypeError(f"cannot set field {key!r} on {type(obj)}")


def set_path(obj, path: str, value):
    """Functional deep set: returns a new object with `path` replaced
    (Reflect::set_field_by_path; functional because engine state lives in
    immutable PyTrees)."""
    keys = _parse(path)

    def rec(cur, i):
        if i == len(keys):
            return value
        child = _get_one(cur, keys[i])
        return _set_one(cur, keys[i], rec(child, i + 1))

    return rec(obj, 0)


def enumerate_paths(obj, prefix="", max_depth=4) -> List[str]:
    """All reflectable leaf paths (Inspector-style enumeration)."""
    out = []
    if max_depth == 0:
        return out
    fs = fields(obj)
    if not fs:
        return [prefix] if prefix else []
    for name, val in fs:
        p = (f"{prefix}{name}" if name.startswith("[")
             else (f"{prefix}.{name}" if prefix else name))
        sub = enumerate_paths(val, p, max_depth - 1)
        out.extend(sub if sub else [p])
    return out
