"""The dotted-path storage interface (counterpart of
``storage/storageinterface.py``).

Attribute access builds a directory or variable path that binds to the file
only at its first ``write``, ``append`` or ``read``:

>>> si = StorageInterface('file.h5')      # doctest: +SKIP
>>> si.mydir.myvar.write(4)               # doctest: +SKIP
>>> si.mydir.myvar.read()                 # doctest: +SKIP
"""
from __future__ import annotations

from typing import Any, Optional

from openmmtools_tpu_torch.storage.iodrivers import HDF5IODriver, StorageIODriver


class _StorageNode:
    """A not-yet-bound directory or variable in the dotted path."""

    def __init__(self, interface: "StorageInterface", path: str):
        self.__dict__["_interface"] = interface
        self.__dict__["_path"] = path

    def __getattr__(self, name: str) -> "_StorageNode":
        if name.startswith("_"):
            raise AttributeError(name)
        return _StorageNode(self._interface, f"{self._path}/{name}")

    @property
    def path(self) -> str:
        return self._path

    # -- variable operations (bind on first use) ----------------------------
    def write(self, value: Any, at_index: Optional[int] = None):
        self._interface.storage_driver.write(self._path, value,
                                             at_index=at_index)

    def append(self, value: Any):
        self._interface.storage_driver.append(self._path, value)

    def read(self):
        return self._interface.storage_driver.read(self._path)

    def add_metadata(self, name: str, value):
        self._interface.storage_driver.set_metadata(self._path, name, value)

    def get_metadata(self, name: Optional[str] = None):
        return self._interface.storage_driver.get_metadata(self._path, name)

    def read_appended(self, index: Optional[int] = None):
        return self._interface.storage_driver.read_appended(self._path, index)

    def __repr__(self):
        return f"StorageNode({self._path!r})"


class StorageInterface:
    """The top of a dotted path: ``StorageInterface(file).a.b.write(v)``
    writes variable ``a/b`` of ``file``."""

    def __init__(self, file_name: str, driver: Optional[StorageIODriver] = None):
        self.__dict__["_driver"] = driver or HDF5IODriver(file_name)
        self.__dict__["_file_name"] = file_name

    @property
    def storage_driver(self) -> StorageIODriver:
        return self._driver

    @property
    def file_name(self) -> str:
        return self._file_name

    def __getattr__(self, name: str) -> _StorageNode:
        if name.startswith("_"):
            raise AttributeError(name)
        return _StorageNode(self, name)

    def sync(self):
        self._driver.sync()

    def close(self):
        self._driver.close()
