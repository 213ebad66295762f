"""Storage: typed IO drivers and the dotted-path interface (counterpart of
``storage/``).

A :class:`StorageIODriver` with a codec a type and an appendable iteration
dimension, over HDF5 (:class:`HDF5IODriver`; openmmtools' NetCDFIODriver,
whose NetCDF4 files are HDF5 files), and the lazy dotted-path
:class:`StorageInterface`:

>>> si = StorageInterface('analysis.h5')        # doctest: +SKIP
>>> si.energies.potential.write(123.4)          # doctest: +SKIP
>>> si.trajectory.positions.append(frame)       # doctest: +SKIP

h5py is imported when a driver opens a file, so the package imports on a
machine without it (the card machine has none).
"""

from openmmtools_tpu_torch.storage.iodrivers import (
    HDF5IODriver,
    Quantity,
    StorageIODriver,
)
from openmmtools_tpu_torch.storage.storageinterface import StorageInterface

NetCDFIODriver = HDF5IODriver  # openmmtools' name

__all__ = ["StorageIODriver", "HDF5IODriver", "NetCDFIODriver",
           "StorageInterface", "Quantity"]
