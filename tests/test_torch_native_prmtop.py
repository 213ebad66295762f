"""The port's native prmtop parser (``native/prmtop_parser.cpp``, built by
the host C++ compiler at first use) against the port's pure-Python parse
and the JAX package's ``parse_prmtop``, on prmtops that ``chip_smoke.py``'s
writer makes: every section bit for bit, in the order of the file. A file
cut short or with a garbled field raises, and so does a failed build.
"""
import numpy as np
import pytest

import chip_smoke
from openmmtools_tpu.models import amber as jamber
from openmmtools_tpu_torch.models import amber
from openmmtools_tpu_torch.ops import _build


@pytest.fixture(scope="module")
def prmtops(tmp_path_factory):
    """A vacuum hexane, two hexanes in PMEWaterBox(2.0)'s waters (with the
    box record) and the water-only prmtop of PMEWaterBox(2.5)."""
    root = tmp_path_factory.mktemp("native")
    out = {}
    for name, top in (("vacuum", chip_smoke.vacuum_chain()),
                      ("explicit", chip_smoke.solvated_chains(2, 6, 2.0)),
                      ("water", chip_smoke.water_box_topology(2.5)[0])):
        out[name] = root / f"{name}.prmtop"
        chip_smoke.write_prmtop(out[name], top)
    return out


def _same(got, want):
    assert list(got) == list(want)
    for flag, values in got.items():
        theirs = np.asarray(want[flag])
        assert values.dtype == theirs.dtype, flag
        np.testing.assert_array_equal(values, theirs, err_msg=flag)


@pytest.mark.parametrize("name", ["vacuum", "explicit", "water"])
def test_native_parse_equals_python_and_jax(prmtops, name):
    path = str(prmtops[name])
    native = amber.parse_prmtop(path)
    _same(native, amber.parse_prmtop_python(path))
    theirs = jamber.parse_prmtop(path)
    assert sorted(native) == sorted(theirs)
    for flag, values in native.items():
        assert values.dtype.kind == np.asarray(theirs[flag]).dtype.kind
        np.testing.assert_array_equal(values, theirs[flag], err_msg=flag)
    assert len(native["CHARGE"]) == int(native["POINTERS"][0])


def test_the_library_is_built_into_build_kernels(prmtops):
    amber.parse_prmtop(str(prmtops["vacuum"]))
    lib = _build.host_library("prmtop_parser")
    assert lib.parent == _build.BUILD_DIR
    assert lib.name.startswith("libprmtop_parser_") and lib.exists()


@pytest.mark.parametrize("cut", ["half", "mid_line", "last_line"])
def test_a_truncated_file_raises(prmtops, tmp_path, cut):
    text = prmtops["explicit"].read_text()
    lines = text.splitlines(keepends=True)
    if cut == "half":               # at a line boundary: sections missing
        short = "".join(lines[:len(lines) // 2])
    elif cut == "mid_line":         # inside a line of numbers
        short = text[:len(text) // 3]
        short = short[:short.rstrip().rfind("\n") + 30]
    else:                           # the last data line dropped
        short = "".join(lines[:-1])
    path = tmp_path / "short.prmtop"
    path.write_text(short)
    with pytest.raises(amber.PrmtopError):
        amber.parse_prmtop(str(path))


def test_a_garbled_number_raises(prmtops, tmp_path):
    text = prmtops["vacuum"].read_text()
    at = text.index("%FLAG MASS")
    at = text.index("\n", text.index("%FORMAT", at)) + 1
    path = tmp_path / "garbled.prmtop"
    path.write_text(text[:at] + "  x2.0" + text[at + 6:])
    with pytest.raises(amber.PrmtopError, match="does not parse"):
        amber.parse_prmtop(str(path))


def test_a_failed_build_raises(prmtops, tmp_path, monkeypatch):
    """The compiler replaced by one that fails: the parse raises with its
    command, and nothing is left in the build directory."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "find_cxx", lambda: "false")
    amber._native_parser.cache_clear()
    try:
        with pytest.raises(_build.KernelBuildError, match="build failed"):
            amber.parse_prmtop(str(prmtops["vacuum"]))
        assert list((tmp_path / "kernels").iterdir()) == []
    finally:
        amber._native_parser.cache_clear()
