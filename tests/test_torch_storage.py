"""The port's storage layer against the JAX package's, on the CPU (skipped
without h5py).

Files cross between the packages: what one package's ``HDF5IODriver`` or
``StorageInterface`` writes, the other reads back to the same value and
type (every codec; unit-tagged quantities; appended series; metadata), in
both directions. A torch tensor is written as the numpy array a JAX array
is written as. And the port's own semantics, as ``tests/test_storage.py``
holds the JAX package's: overwrite, ``write(at_index=)``, the read trap.
"""
import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from openmmtools_tpu import storage as jstorage  # noqa: E402
from openmmtools_tpu_torch import storage as tstorage  # noqa: E402

PACKAGES = {"jax": jstorage, "port": tstorage}
DIRECTIONS = [("jax", "port"), ("port", "jax")]
VALUES = [
    42, 3.14, True, "hello world", [1, 2, 3], (4.0, 5.0), ["a", "b"],
    {"key": 1, "other": [1, 2]},
    np.arange(12, dtype=np.float32).reshape(3, 4),
]


def _same(out, value):
    if isinstance(value, np.ndarray):
        assert isinstance(out, np.ndarray) and out.dtype == value.dtype
        np.testing.assert_array_equal(out, value)
    else:
        assert type(out) is type(value) and out == value


@pytest.mark.parametrize("value", VALUES, ids=lambda v: type(v).__name__)
@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_values_cross_packages(tmp_path, writer, reader, value):
    path = str(tmp_path / "v.h5")
    d = PACKAGES[writer].HDF5IODriver(path)
    d.write("x", value)
    d.close()
    d = PACKAGES[reader].HDF5IODriver(path)
    _same(d.read("x"), value)
    d.close()


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_appended_series_and_quantities_cross(tmp_path, writer, reader):
    path = str(tmp_path / "a.h5")
    w = PACKAGES[writer]
    d = w.HDF5IODriver(path)
    for i in range(4):
        d.append("traj/energy", float(i) * 1.5)
        d.append("traj/x", w.Quantity(np.full((2, 3), float(i)), "nanometer"))
    d.write("temperature", w.Quantity(300.0, "kelvin"))
    d.set_metadata("traj/energy", "units", "kJ/mol")
    d.close()
    r = PACKAGES[reader]
    d = r.HDF5IODriver(path)
    assert d.length("traj/energy") == 4
    assert d.read_appended("traj/energy") == [0.0, 1.5, 3.0, 4.5]
    q = d.read_appended("traj/x", 2)
    assert isinstance(q, r.Quantity) and q.unit == "nanometer"
    np.testing.assert_array_equal(q.value, np.full((2, 3), 2.0))
    assert d.read("temperature") == r.Quantity(300.0, "kelvin")
    assert d.get_metadata("traj/energy", "units") == "kJ/mol"
    assert sorted(d.groups()) == ["traj"]
    assert sorted(d.variables("traj")) == ["energy", "x"]
    d.close()


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_storage_interface_crosses(tmp_path, writer, reader):
    path = str(tmp_path / "si.h5")
    si = PACKAGES[writer].StorageInterface(path)
    si.mydir.myvar.write(4)
    for v in (1.0, 2.0, 3.0):
        si.traj.energy.append(v)
    si.traj.energy.write(99.0, at_index=1)
    si.data.myvar.write(7.5)
    si.data.myvar.add_metadata("units", "kJ/mol")
    si.close()
    si = PACKAGES[reader].StorageInterface(path)
    assert si.mydir.myvar.read() == 4
    assert si.traj.energy.read_appended() == [1.0, 99.0, 3.0]
    assert si.data.myvar.read() == 7.5
    assert si.data.myvar.get_metadata("units") == "kJ/mol"
    si.close()


def test_tensor_is_stored_as_an_array(tmp_path):
    """A torch tensor (and a unit-tagged one) is written as its numpy
    array; the JAX package reads it back as one."""
    path = str(tmp_path / "t.h5")
    x = torch.arange(6, dtype=torch.float64).reshape(2, 3)
    d = tstorage.HDF5IODriver(path)
    d.write("x", x)
    d.append("frames", x)
    d.write("box", tstorage.Quantity(x, "nanometer"))
    d.close()
    d = jstorage.HDF5IODriver(path)
    np.testing.assert_array_equal(d.read("x"), x.numpy())
    np.testing.assert_array_equal(d.read_appended("frames", 0), x.numpy())
    box = d.read("box")
    assert box.unit == "nanometer"
    np.testing.assert_array_equal(box.value, x.numpy())
    d.close()


def test_overwrite_and_unit_mismatch(tmp_path):
    d = tstorage.HDF5IODriver(str(tmp_path / "o.h5"))
    d.write("x", 1)
    d.write("x", "two")
    assert d.read("x") == "two"
    d.append("t", tstorage.Quantity(1.0, "kelvin"))
    with pytest.raises(ValueError, match="metadata mismatch"):
        d.append("t", tstorage.Quantity(1.0, "bar"))
    with pytest.raises(TypeError):
        d.write("n", tstorage.Quantity(tstorage.Quantity(1.0, "a"), "b"))
    with pytest.raises(TypeError):
        d.write("s", {1, 2})
    d.close()


def test_write_at_index_and_read_trap(tmp_path):
    si = tstorage.StorageInterface(str(tmp_path / "ai.h5"))
    with pytest.raises(KeyError):
        si.traj.energy.write(1.0, at_index=0)
    for v in (1.0, 2.0, 3.0):
        si.traj.energy.append(v)
    si.traj.energy.write(7.0, at_index=-1)
    assert si.traj.energy.read_appended(index=2) == 7.0
    with pytest.raises(IndexError):
        si.traj.energy.write(0.0, at_index=3)
    si.meta.title.write("hello")
    with pytest.raises(KeyError):
        si.meta.title.write("x", at_index=0)
    with pytest.raises(KeyError):
        si.some.nested.thing.read()
    assert si.traj.energy.path == "traj/energy"
    si.close()


def test_netcdf_alias_and_exports():
    assert tstorage.NetCDFIODriver is tstorage.HDF5IODriver
    assert set(tstorage.__all__) == set(jstorage.__all__)
