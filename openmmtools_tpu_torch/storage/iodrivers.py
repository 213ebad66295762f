"""Typed storage IO drivers, HDF5 (counterpart of ``storage/iodrivers.py``).

An abstract :class:`StorageIODriver` and an HDF5 driver with a codec a type
(int, float, str, bool, list, tuple, dict, numpy arrays, torch tensors and
unit-tagged :class:`Quantity` values), for variables written once
(``write``) and for variables with an unlimited leading iteration dimension
(``append``). Each dataset carries its type in its attributes, so a read
gives back the Python type written. The layout is the JAX package's: what
one package writes, the other reads (a tensor reads back as a numpy array,
as a JAX array does). h5py is imported when a file opens, so the package
imports where h5py is missing.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch


class Quantity:
    """A value tagged with its unit string, for storage round trips (the
    reference's NCQuantity codec). The port computes in plain floats
    (kJ/mol, nm, ps), so this carries the unit string, not a unit algebra;
    openmm-style quantities (``.unit`` and ``._value``) are taken on write
    by those attributes."""

    __slots__ = ("value", "unit")

    def __init__(self, value, unit: str):
        self.value = value
        self.unit = str(unit)

    def __repr__(self):
        return f"Quantity({self.value!r}, {self.unit!r})"

    def __eq__(self, other):
        if not isinstance(other, Quantity):
            return NotImplemented
        a, b = np.asarray(self.value), np.asarray(other.value)
        return (self.unit == other.unit and a.shape == b.shape
                and bool(np.all(a == b)))


class StorageIODriver:
    """Abstract driver."""

    def __init__(self, file_name: str, access_mode: Optional[str] = None):
        self._file_name = file_name
        self._access_mode = access_mode

    @property
    def file_name(self):
        return self._file_name

    def check_scalar_units(self):  # unit layer is plain floats here
        return None

    # interface
    def create_storage_variable(self, path, type_key):
        raise NotImplementedError

    def get_directory(self, path):
        raise NotImplementedError

    def close(self):
        raise NotImplementedError


def _encode(value):
    """(payload ndarray, type_string, json_meta) for a python value."""
    if isinstance(value, Quantity) or (
            hasattr(value, "unit") and hasattr(value, "_value")):
        # our Quantity, or an openmm.unit.Quantity-shaped object
        inner = value.value if isinstance(value, Quantity) else value._value
        if isinstance(inner, Quantity) or (
                hasattr(inner, "unit") and hasattr(inner, "_value")):
            raise TypeError(
                "nested Quantity payloads are not supported (the inner "
                "unit string would be lost on decode)")
        arr, inner_ts, _ = _encode(inner)
        return arr, "quantity", json.dumps(
            {"unit": str(value.unit), "value_type": inner_ts})
    if isinstance(value, bool):
        return np.asarray([int(value)]), "bool", None
    if isinstance(value, (int, np.integer)):
        return np.asarray([int(value)], dtype=np.int64), "int", None
    if isinstance(value, (float, np.floating)):
        return np.asarray([float(value)], dtype=np.float64), "float", None
    if isinstance(value, str):
        return np.frombuffer(value.encode(), dtype=np.uint8), "str", None
    if isinstance(value, (list, tuple)):
        arr = np.asarray(value)
        kind = "list" if isinstance(value, list) else "tuple"
        if arr.dtype.kind in "ifb":
            return arr, kind, None
        # heterogeneous: JSON
        payload = json.dumps(list(value)).encode()
        return np.frombuffer(payload, dtype=np.uint8), kind + "_json", None
    if isinstance(value, dict):
        payload = json.dumps(value).encode()
        return np.frombuffer(payload, dtype=np.uint8), "dict", None
    if isinstance(value, np.ndarray):
        return value, "ndarray", None
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy(), "ndarray", None
    raise TypeError(f"unsupported storage type {type(value)!r}")


def _decode(arr: np.ndarray, type_string: str, meta: Optional[str] = None):
    if type_string == "quantity":
        info = json.loads(meta) if meta else {"unit": "dimensionless",
                                              "value_type": "ndarray"}
        return Quantity(_decode(arr, info["value_type"]), info["unit"])
    if type_string == "bool":
        return bool(arr[0])
    if type_string == "int":
        return int(arr[0])
    if type_string == "float":
        return float(arr[0])
    if type_string == "str":
        return arr.tobytes().decode()
    if type_string == "list":
        return list(arr.tolist()) if arr.ndim == 1 else list(arr)
    if type_string == "tuple":
        return tuple(arr.tolist()) if arr.ndim == 1 else tuple(arr)
    if type_string == "list_json":
        return list(json.loads(arr.tobytes().decode()))
    if type_string == "tuple_json":
        return tuple(json.loads(arr.tobytes().decode()))
    if type_string == "dict":
        return json.loads(arr.tobytes().decode())
    return arr  # ndarray


class HDF5IODriver(StorageIODriver):
    """The HDF5 driver (openmmtools' NetCDFIODriver: NetCDF4 files are HDF5
    files)."""

    def __init__(self, file_name: str, access_mode: Optional[str] = None):
        super().__init__(file_name, access_mode)
        import h5py

        if access_mode is None:
            access_mode = "a" if os.path.exists(file_name) else "w"
        os.makedirs(os.path.dirname(os.path.abspath(file_name)), exist_ok=True)
        self._h5 = h5py.File(file_name, access_mode)

    @property
    def ncfile(self):  # parity name
        return self._h5

    # -- static write/read ---------------------------------------------------
    def write(self, path: str, value: Any, at_index: Optional[int] = None):
        """Write a variable once; with ``at_index``, overwrite one row of an
        appended variable instead, which must exist and hold that row."""
        if at_index is not None:
            if path not in self._h5 or not self._h5[path].attrs.get(
                    "appendable", False):
                raise KeyError(
                    f"write(at_index=): {path!r} is not a bound appendable "
                    "variable; append to it first")
            ds = self._h5[path]
            if not -ds.shape[0] <= at_index < ds.shape[0]:
                raise IndexError(
                    f"write(at_index={at_index}): {path!r} has "
                    f"{ds.shape[0]} rows")
            arr, ts, meta = _encode(value)
            expected_meta = ds.attrs.get("type_meta")
            if meta is not None and expected_meta != meta:
                raise ValueError(
                    f"write({path!r}, at_index=): metadata mismatch: "
                    f"variable was created with {expected_meta!r}, got "
                    f"{meta!r}")
            ds[at_index] = arr
            self._h5.flush()
            return
        arr, ts, meta = _encode(value)
        if path in self._h5:
            del self._h5[path]
        ds = self._h5.create_dataset(path, data=arr)
        ds.attrs["type"] = ts
        if meta is not None:
            ds.attrs["type_meta"] = meta
        self._h5.flush()

    def read(self, path: str) -> Any:
        ds = self._h5[path]
        return _decode(ds[...], ds.attrs.get("type", "ndarray"),
                       ds.attrs.get("type_meta"))

    # -- appendable (iteration-dimension) variables ---------------------------
    def append(self, path: str, value: Any):
        arr, ts, meta = _encode(value)
        if path not in self._h5:
            ds = self._h5.create_dataset(
                path, shape=(0,) + arr.shape, maxshape=(None,) + arr.shape,
                dtype=arr.dtype, chunks=(1,) + arr.shape)
            ds.attrs["type"] = ts
            ds.attrs["appendable"] = True
            if meta is not None:
                ds.attrs["type_meta"] = meta
        elif meta is not None and self._h5[path].attrs.get(
                "type_meta") != meta:
            # rows recorded under the first row's unit would be wrong
            # without a word: the unit codec exists to prevent that
            raise ValueError(
                f"append({path!r}): metadata mismatch: variable was "
                f"created with {self._h5[path].attrs.get('type_meta')!r}, "
                f"got {meta!r}")
        ds = self._h5[path]
        n = ds.shape[0]
        ds.resize(n + 1, axis=0)
        ds[n] = arr
        self._h5.flush()

    def read_appended(self, path: str, index: Optional[int] = None):
        ds = self._h5[path]
        ts = ds.attrs.get("type", "ndarray")
        meta = ds.attrs.get("type_meta")
        if index is None:
            return [_decode(ds[i], ts, meta) for i in range(ds.shape[0])]
        return _decode(ds[index], ts, meta)

    def length(self, path: str) -> int:
        ds = self._h5.get(path)
        return 0 if ds is None else ds.shape[0]

    def groups(self, path: str = "/"):
        import h5py

        node = self._h5[path]
        return [k for k in node if isinstance(node[k], h5py.Group)]

    def variables(self, path: str = "/"):
        import h5py

        node = self._h5[path]
        return [k for k in node if isinstance(node[k], h5py.Dataset)]

    def __contains__(self, path: str):
        return path in self._h5

    def set_metadata(self, path: str, name: str, value):
        """Attach metadata (an HDF5 attribute) to a variable or group."""
        node = self._h5[path] if path in self._h5 else \
            self._h5.require_group(path)
        node.attrs[name] = value

    def get_metadata(self, path: str, name: Optional[str] = None):
        node = self._h5[path]
        if name is None:
            return dict(node.attrs)
        return node.attrs[name]

    def sync(self):
        self._h5.flush()

    def close(self):
        self._h5.close()
