"""Build the port's objects from the JAX package's parameters as numpy.

The JAX package's ``System`` is a tree of frozen dataclasses whose leaves are
arrays. Its numpy form, which this module reads, is plain Python:

* a dataclass becomes ``{"type": <class name>, <field>: <value>, ...}``;
* an array becomes a ``numpy.ndarray``;
* tuples, lists, dicts, strings, numbers, bools and None stay as they are.

The test systems' own terms (``HarmonicWellArrayTerm``, ``WCATerm``) and
the restraints of ``forces.py`` come across like the System's. The alchemical terms come across with their
region metadata (lambda names, annihilate flags, region interactions) and
the reciprocal term with its ``alch_mask``/``lambda_name``, as every other
field: by name.

:func:`system_from_numpy` builds a port ``System`` from that form (the terms
by class name, among the terms this port has), and
:func:`sampler_state_from_numpy` / :func:`integrator_state_from_numpy` carry
(positions, velocities, box, kT) across. The port never sees a JAX object:
whoever holds one makes the numpy form first. Like every entry point of the
port, they put their tensors on the card unless the caller names another
device. :func:`grid_spec` carries a cell-grid spec (``pallas_md.LJGridSpec``)
across as plain numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from openmmtools_tpu_torch import forces
from openmmtools_tpu_torch.alchemy import (
    AlchemicalHarmonicAngleTerm,
    AlchemicalHarmonicBondTerm,
    AlchemicalNonbondedTerm,
    AlchemicalPeriodicTorsionTerm,
)
from openmmtools_tpu_torch.models.testsystems import (
    HarmonicWellArrayTerm,
    WCATerm,
)
from openmmtools_tpu_torch.ops.fused_md import LJGridSpec
from openmmtools_tpu_torch.ops.pme import EwaldReciprocalTerm
from openmmtools_tpu_torch.states import SamplerState
from openmmtools_tpu_torch.system import (
    Constraints,
    CustomExternalTerm,
    HarmonicAngleTerm,
    HarmonicBondTerm,
    NonbondedTerm,
    PeriodicTorsionTerm,
    System,
    VirtualSites,
)

_CLASSES = {cls.__name__: cls for cls in (
    System, NonbondedTerm, CustomExternalTerm, Constraints, VirtualSites,
    HarmonicBondTerm, HarmonicAngleTerm, PeriodicTorsionTerm,
    EwaldReciprocalTerm, AlchemicalNonbondedTerm, AlchemicalHarmonicBondTerm,
    AlchemicalHarmonicAngleTerm, AlchemicalPeriodicTorsionTerm,
    HarmonicWellArrayTerm, WCATerm, forces.HarmonicRestraintForce,
    forces.HarmonicRestraintBondForce, forces.FlatBottomRestraintForce,
    forces.FlatBottomRestraintBondForce, forces.PositionalRestraintTerm)}


def _tensor(value, device, dtype):
    t = torch.as_tensor(np.array(value), device=device)  # a copy: JAX arrays are read-only
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def from_numpy(value, device="cuda", dtype=None):
    """Rebuild a numpy form (see module docstring) as port objects; floating
    arrays are cast to ``dtype`` when it is given."""
    if isinstance(value, np.ndarray):
        return _tensor(value, device, dtype)
    if isinstance(value, dict) and "type" in value:
        cls = _CLASSES.get(value["type"])
        if cls is None:
            raise NotImplementedError(
                f"{value['type']} has no counterpart in the port yet")
        fields = {k: from_numpy(v, device, dtype)
                  for k, v in value.items() if k != "type"}
        return cls(**fields)
    if isinstance(value, dict):
        return {k: from_numpy(v, device, dtype) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return type(value)(from_numpy(v, device, dtype) for v in value)
    return value


def system_from_numpy(tree: dict, device="cuda", dtype=None) -> System:
    """A port ``System`` from the numpy form of a JAX ``System``."""
    if tree.get("type") != "System":
        raise ValueError("expected the numpy form of a System")
    system = from_numpy(tree, device, dtype)
    if not isinstance(system.terms, tuple):
        system = system.replace(terms=tuple(system.terms))
    return system


def sampler_state_from_numpy(positions, velocities=None, box=None,
                             device="cuda", dtype=None) -> SamplerState:
    """A port ``SamplerState`` from numpy positions (N, 3), velocities and
    box (3, 3)."""
    def opt(a):
        return None if a is None else _tensor(a, device, dtype)

    return SamplerState(positions=_tensor(positions, device, dtype),
                        velocities=opt(velocities), box_vectors=opt(box))


def integrator_state_from_numpy(positions, velocities, box, kT,
                                generator=None, device="cuda", dtype=None):
    """A port ``IntegratorState`` from numpy (positions, velocities, box,
    kT); its force cache is empty, so the first step computes forces."""
    from openmmtools_tpu_torch.integrators.langevin import IntegratorState

    x = _tensor(positions, device, dtype)
    zero = torch.zeros((), dtype=x.dtype, device=device)
    izero = torch.zeros((), dtype=torch.int64, device=device)
    return IntegratorState(
        positions=x, velocities=_tensor(velocities, device, dtype),
        kT=_tensor(np.asarray(kT, dtype=np.float64), device, x.dtype),
        box=None if box is None else _tensor(box, device, dtype),
        global_params={}, heat=zero, shadow_work=zero, protocol_work=zero,
        n_accepted=izero, n_proposed=izero, lambda_=zero, lambda_step=0,
        step_count=0, generator=generator)


def grid_spec(spec) -> LJGridSpec:
    """The port's ``LJGridSpec`` from any object with the JAX spec's fields
    as attributes, read as plain numbers."""
    ints = ("n_side", "capacity")
    values = {name: getattr(spec, name) for name in LJGridSpec._fields}
    return LJGridSpec(**{
        name: (None if value is None else int(value) if name in ints
               else float(value))
        for name, value in values.items()})
