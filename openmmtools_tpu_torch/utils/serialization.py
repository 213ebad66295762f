"""Structural (de)serialization of the port's objects (its own copy of
``utils/serialization.py``).

Round-trips an object through a plain dict holding its module and class
name and its state. Tensor dataclasses serialize their fields, tensors as
numpy arrays (tagged, so they come back as CPU tensors, while numpy arrays
come back as numpy); any other object goes through its
``__getstate__``/``__setstate__``, as the MCMC moves do.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict

import numpy as np
import torch


def _array(kind, arr):
    # an explicit shape: tolist() of a zero-size (0, k) array is [] and
    # would come back as shape (0,)
    return {"_type": kind, "data": arr.tolist(), "dtype": str(arr.dtype),
            "shape": list(arr.shape)}


def _encode(value: Any) -> Any:
    """A value as plain dicts, lists and scalars: scalars as they are,
    arrays and tensors tagged with their dtype and shape, containers
    tagged with their type, objects through :func:`serialize`."""
    if isinstance(value, (int, float, str, bool, type(None))):
        return value
    if isinstance(value, np.ndarray):
        return _array("ndarray", value)
    if isinstance(value, torch.Tensor):
        return _array("tensor", value.detach().cpu().numpy())
    if isinstance(value, dict):
        return {"_type": "dict",
                "items": {k: _encode(v) for k, v in value.items()}}
    if isinstance(value, (list, tuple)):
        return {"_type": "tuple" if isinstance(value, tuple) else "list",
                "items": [_encode(v) for v in value]}
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return serialize(value)
    if hasattr(value, "__getstate__") and not isinstance(value, type):
        # the MCMC moves and other objects of the port
        return serialize(value)
    raise TypeError(f"cannot serialize {type(value)!r}")


def _decode(value: Any) -> Any:
    """Inverse of :func:`_encode`."""
    if isinstance(value, dict):
        t = value.get("_type")
        if t in ("ndarray", "tensor"):
            arr = np.asarray(value["data"], dtype=value["dtype"])
            arr = arr.reshape(value["shape"])
            return torch.as_tensor(arr) if t == "tensor" else arr
        if t == "dict":
            return {k: _decode(v) for k, v in value["items"].items()}
        if t == "list":
            return [_decode(v) for v in value["items"]]
        if t == "tuple":
            return tuple(_decode(v) for v in value["items"])
        if "_serialized__module_name" in value:
            return deserialize(value)
    return value


def serialize(instance: Any) -> Dict[str, Any]:
    """A dataclass, or any object with ``__getstate__``, as a dict."""
    serialization: Dict[str, Any] = {
        "_serialized__module_name": type(instance).__module__,
        "_serialized__class_name": type(instance).__qualname__,
    }
    if dataclasses.is_dataclass(instance):
        for f in dataclasses.fields(instance):
            serialization[f.name] = _encode(getattr(instance, f.name))
    elif hasattr(instance, "__getstate__"):
        serialization["_state"] = _encode(instance.__getstate__())
    else:
        raise TypeError(f"cannot serialize {type(instance)!r}")
    return serialization


def deserialize(serialization: Dict[str, Any]) -> Any:
    """Inverse of :func:`serialize`."""
    data = dict(serialization)
    module = importlib.import_module(data.pop("_serialized__module_name"))
    cls = module
    for part in data.pop("_serialized__class_name").split("."):
        cls = getattr(cls, part)
    if "_state" in data:
        instance = cls.__new__(cls)
        state = _decode(data["_state"])
        if hasattr(instance, "__setstate__"):
            instance.__setstate__(state)
        else:   # plain objects: object.__getstate__ gave their __dict__
            instance.__dict__.update(state)
        return instance
    return cls(**{k: _decode(v) for k, v in data.items()})
