"""Unit strings over the storage :class:`Quantity` (counterpart of
``utils/units.py``).

openmmtools' ``is_quantity_close`` and ``quantity_from_string``. The port
computes in fixed MD units (kJ/mol, nm, ps, K), so a quantity is a value
tagged with its unit string (``storage.iodrivers.Quantity``), with no unit
algebra: enough to carry settings such as ``"300.0*kelvin"`` through YAML
or storage and compare them.
"""
from __future__ import annotations

import re
from contextlib import contextmanager

import numpy as np

from openmmtools_tpu_torch.storage.iodrivers import Quantity

__all__ = ["quantity_from_string", "is_quantity_close", "typename",
           "temporary_directory", "Quantity"]

_NUMBER = r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?"


def quantity_from_string(expression: str) -> Quantity:
    """``"<number> * <unit expression>"`` as a :class:`Quantity`: a bare
    number is dimensionless, ``"300*kelvin"`` has the unit after the
    ``*``, ``"2.0/picosecond"`` the unit ``"/picosecond"``; the unit
    expression is kept verbatim (``"kilojoule/(mole*nanometer**2)"``)."""
    s = expression.strip()
    try:
        return Quantity(float(s), "dimensionless")
    except ValueError:
        pass
    m = re.match(rf"^({_NUMBER})\s*([*/])\s*(.+)$", s)
    if m is None:
        raise ValueError(
            f"cannot parse quantity expression {expression!r}: expected "
            "'<number>', '<number>*<unit>' or '<number>/<unit>'")
    value, op, unit = float(m.group(1)), m.group(2), m.group(3).strip()
    if not unit:
        raise ValueError(f"empty unit in {expression!r}")
    return Quantity(value, unit if op == "*" else "/" + unit)


def is_quantity_close(quantity1, quantity2, rtol=1e-10, atol=0.0) -> bool:
    """Whether two quantities agree within the tolerances. Their unit
    strings must match (there is no conversion); else ``TypeError``, as
    openmmtools raises on incompatible units."""
    q1 = quantity1 if isinstance(quantity1, Quantity) \
        else Quantity(quantity1, "dimensionless")
    q2 = quantity2 if isinstance(quantity2, Quantity) \
        else Quantity(quantity2, "dimensionless")
    if q1.unit != q2.unit:
        raise TypeError(
            f"cannot compare incompatible quantities {q1!r} and {q2!r}")
    return bool(np.allclose(np.asarray(q1.value), np.asarray(q2.value),
                            rtol=rtol, atol=atol))


def typename(atype) -> str:
    """The qualified name of a type, or of an instance's type."""
    if not isinstance(atype, type):
        atype = type(atype)
    mod = atype.__module__
    if mod in (None, "builtins"):
        return atype.__qualname__
    return f"{mod}.{atype.__qualname__}"


@contextmanager
def temporary_directory():
    """A directory that is deleted when the block ends."""
    import tempfile

    with tempfile.TemporaryDirectory(ignore_cleanup_errors=True) as path:
        yield path
