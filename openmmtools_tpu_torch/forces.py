"""Restraint forces and force utilities (counterpart of ``forces.py``).

Radially symmetric receptor-ligand restraints with their restraint volumes
and standard-state corrections, flat-bottom restraints, positional
restraints and the ``find_forces`` search, as energy terms: frozen
dataclasses with ``energy(x, box, params)`` and a ``force_group``. A
restraint's controlling global parameter is a name in the ``params`` dict
(default 'lambda_restraints'), as openmmtools' CustomCentroidBondForce
global parameter; a missing name means 1.

These terms have no analytic forces: the generic program and sweep mode
take their forces by autograd (sweep mode sums them with the rest of the
remainder around the sweep kernel). A positional restraint's reference
positions are fixed coordinates: the barostat does not scale them with the
box, as in the JAX package.
"""
from __future__ import annotations

import math
import re
from typing import Optional

import torch

from openmmtools_tpu_torch.constants import STANDARD_STATE_VOLUME, kB
from openmmtools_tpu_torch.ops.geometry import safe_norm
from openmmtools_tpu_torch.system import NonbondedTerm, System
from openmmtools_tpu_torch.utils.pytree import static_field, tensor_dataclass


class NoForceFoundError(Exception):
    """``find_forces(..., only_one=True)`` found no match."""


class MultipleForcesError(Exception):
    """``find_forces(..., only_one=True)`` found more than one match."""


def find_forces(system: System, force_type, only_one: bool = False,
                include_subclasses: bool = True):
    """The system's terms of a type: {index: term}, or one (index, term)
    with ``only_one``. ``force_type`` may be a class, or a regular
    expression matched against the terms' class names."""
    matches = {}
    for i, term in enumerate(system.terms):
        if isinstance(force_type, str):
            if re.match(force_type, type(term).__name__):
                matches[i] = term
        elif include_subclasses and isinstance(term, force_type):
            matches[i] = term
        elif not include_subclasses and type(term) is force_type:
            matches[i] = term
    if only_one:
        if not matches:
            raise NoForceFoundError(f"no force matching {force_type!r}")
        if len(matches) > 1:
            raise MultipleForcesError(f"multiple forces match {force_type!r}")
        [(i, t)] = matches.items()
        return i, t
    return matches


def _controlled(params, name: Optional[str]):
    if name is None or params is None or name not in params:
        return 1.0
    return params[name]


# -- restraint volumes --------------------------------------------------------


def _sphere_volume(radius: float) -> float:
    return 4.0 / 3.0 * math.pi * float(radius) ** 3


def _harmonic_volume(radius: float, spring_constant: float,
                     beta: float) -> float:
    """Closed form of the integral of 4 pi r^2 exp(-beta K r^2 / 2) from 0
    to R."""
    bk = beta * spring_constant
    bkr2_2 = 0.5 * bk * radius * radius
    volume = (math.sqrt(math.pi / 2.0) * math.erf(math.sqrt(bkr2_2))
              / bk ** 1.5)
    volume -= math.exp(-bkr2_2) * radius / bk
    return 4.0 * math.pi * volume


def _harmonic_radius(spring_constant: float, potential_energy: float) -> float:
    """r where (K/2) r^2 equals ``potential_energy``."""
    return math.sqrt(2.0 * potential_energy / spring_constant)


def integrate_restraint_volume(radial_potential, temperature,
                               square_well=False, radius_cutoff=None,
                               energy_cutoff=None, r_min=0.0, r_max=None,
                               analytical_volume=0.0) -> float:
    """The restraint volume, the integral of 4 pi r^2 exp(-beta u(r)) dr
    between hard walls, by scipy's ``quad``.

    ``radial_potential(r)`` is the restraint energy (kJ/mol) at separation
    r (nm); ``energy_cutoff`` (in kT) zeroes the integrand past it;
    ``square_well`` takes the accessible region at zero energy. The
    classes' ``compute_restraint_volume`` choose tighter limits and
    analytic shortcuts; this function is also their shortcut-free oracle.
    """
    from scipy.integrate import quad

    beta = 1.0 / (kB * float(temperature))
    if r_max is None:
        r_max = 100.0   # a bound for non-periodic states
    if radius_cutoff is not None:
        r_max = min(r_max, float(radius_cutoff))

    def integrand(r):
        u = float(radial_potential(r))
        if energy_cutoff is not None and beta * u > energy_cutoff:
            return 0.0
        if square_well:
            u = 0.0
        return 4.0 * math.pi * r * r * math.exp(-beta * u)

    value, _ = quad(integrand, float(r_min), float(r_max), limit=200)
    return value + float(analytical_volume)


def _standard_state_correction(restraint, temperature, square_well,
                               radius_cutoff, energy_cutoff,
                               max_volume) -> float:
    """-ln(V_standard / V_restraint): a pure square well (no cutoffs) needs
    an explicit ``max_volume`` (the reference takes the periodic box's);
    a square well with a radius cutoff is the cutoff sphere; everything
    else goes through ``compute_restraint_volume``; ``max_volume`` bounds
    the volume."""
    if square_well and energy_cutoff is None and radius_cutoff is None:
        if max_volume is None:
            raise ValueError("square_well with no cutoffs needs max_volume "
                             "(the reference uses the periodic box volume)")
        v_restraint = float(max_volume)
    elif square_well and radius_cutoff is not None and energy_cutoff is None:
        v_restraint = _sphere_volume(radius_cutoff)
    else:
        v_restraint = restraint.compute_restraint_volume(
            temperature, square_well, radius_cutoff, energy_cutoff)
    if max_volume is not None and v_restraint > float(max_volume):
        v_restraint = float(max_volume)
    return -math.log(STANDARD_STATE_VOLUME / v_restraint)


class _HarmonicRadial:
    """Radial potential, its inverse and volume of a harmonic restraint."""

    def distance_at_energy(self, potential_energy):
        """r(U), the inverse of the radial potential."""
        return _harmonic_radius(float(self.spring_constant),
                                float(potential_energy))

    def radial_potential(self, r: float) -> float:
        """Restraint energy (kJ/mol) at separation r (nm)."""
        return 0.5 * float(self.spring_constant) * float(r) ** 2

    def compute_restraint_volume(self, temperature, square_well=False,
                                 radius_cutoff=None,
                                 energy_cutoff=None) -> float:
        """The analytic restraint volume. ``energy_cutoff`` is in kT (a
        hard wall where u(r) reaches it; default 100 kT, no wall in
        effect); ``radius_cutoff`` in nm; ``square_well`` takes the
        accessible region at zero energy (the sphere's volume)."""
        kT = kB * float(temperature)
        if energy_cutoff is None:
            energy_cutoff = 100.0
        radius = self.distance_at_energy(energy_cutoff * kT)
        if radius_cutoff is not None:
            radius = min(radius, float(radius_cutoff))
        if square_well:
            return _sphere_volume(radius)
        return _harmonic_volume(radius, float(self.spring_constant),
                                1.0 / kT)

    def compute_standard_state_correction(self, temperature,
                                          square_well=False,
                                          radius_cutoff=None,
                                          energy_cutoff=None,
                                          max_volume=None) -> float:
        return _standard_state_correction(self, temperature, square_well,
                                          radius_cutoff, energy_cutoff,
                                          max_volume)


class _FlatBottomRadial:
    """Radial potential, its inverse and volume of a flat-bottom
    restraint: the flat well's sphere analytically, the harmonic wall by
    quadrature."""

    def distance_at_energy(self, potential_energy):
        """r0 + the harmonic radius; undefined at zero energy, where the
        whole well lies."""
        if float(potential_energy) == 0.0:
            raise ValueError("cannot compute the distance at zero potential "
                             "energy for a flat-bottom restraint")
        return float(self.well_radius) + _harmonic_radius(
            float(self.spring_constant), float(potential_energy))

    def radial_potential(self, r: float) -> float:
        dr = max(float(r) - float(self.well_radius), 0.0)
        return 0.5 * float(self.spring_constant) * dr * dr

    def _integral_limits(self, temperature, radius_cutoff, energy_cutoff):
        """(r_min, r_max, the well's analytic volume). The wall's radius is
        computed directly, not by ``distance_at_energy``: a zero energy
        cutoff pins the wall to the well's edge."""
        kT = kB * float(temperature)
        if energy_cutoff is None:
            energy_cutoff = 100.0
        r_max = float(self.well_radius) + _harmonic_radius(
            float(self.spring_constant), energy_cutoff * kT)
        if radius_cutoff is not None:
            r_max = min(r_max, float(radius_cutoff))
        r_min = min(r_max, float(self.well_radius))
        return r_min, r_max, _sphere_volume(r_min)

    def compute_restraint_volume(self, temperature, square_well=False,
                                 radius_cutoff=None,
                                 energy_cutoff=None) -> float:
        """The sphere's volume for the square well; the flat sphere plus
        the wall's integral otherwise."""
        r_min, r_max, v_inner = self._integral_limits(
            temperature, radius_cutoff, energy_cutoff)
        if square_well:
            return _sphere_volume(r_max)
        return integrate_restraint_volume(
            self.radial_potential, temperature, square_well=False,
            radius_cutoff=radius_cutoff, energy_cutoff=energy_cutoff,
            r_min=r_min, r_max=r_max, analytical_volume=v_inner)

    def compute_standard_state_correction(self, temperature,
                                          square_well=False,
                                          radius_cutoff=None,
                                          energy_cutoff=None,
                                          max_volume=None) -> float:
        return _standard_state_correction(self, temperature, square_well,
                                          radius_cutoff, energy_cutoff,
                                          max_volume)


# -- radially symmetric restraints ------------------------------------------


def _centroid_distance(x, group1, group2):
    c1 = torch.mean(x[group1.long()], dim=0)
    c2 = torch.mean(x[group2.long()], dim=0)
    return safe_norm(c1 - c2)


@tensor_dataclass
class HarmonicRestraintForce(_HarmonicRadial):
    """Harmonic restraint between two groups' centroids,
    U = control (K/2) r^2."""

    spring_constant: torch.Tensor        # kJ/mol/nm^2
    group1: torch.Tensor                 # (G1,) int atom indices
    group2: torch.Tensor                 # (G2,)
    controlling_parameter_name: str = static_field(default="lambda_restraints")
    force_group: int = static_field(default=0)

    def _distance(self, x):
        return _centroid_distance(x, self.group1, self.group2)

    def energy(self, x, box, params=None):
        lam = _controlled(params, self.controlling_parameter_name)
        r = self._distance(x)
        return lam * 0.5 * self.spring_constant * r * r


@tensor_dataclass
class HarmonicRestraintBondForce(_HarmonicRadial):
    """Harmonic restraint between two atoms."""

    spring_constant: torch.Tensor
    atom1: int = static_field(default=0)
    atom2: int = static_field(default=1)
    controlling_parameter_name: str = static_field(default="lambda_restraints")
    force_group: int = static_field(default=0)

    def energy(self, x, box, params=None):
        lam = _controlled(params, self.controlling_parameter_name)
        r = safe_norm(x[self.atom1] - x[self.atom2])
        return lam * 0.5 * self.spring_constant * r * r


@tensor_dataclass
class FlatBottomRestraintForce(_FlatBottomRadial):
    """Flat-bottom restraint between two groups' centroids,
    U = control step(r - r0) (K/2) (r - r0)^2."""

    spring_constant: torch.Tensor
    well_radius: torch.Tensor            # nm
    group1: torch.Tensor
    group2: torch.Tensor
    controlling_parameter_name: str = static_field(default="lambda_restraints")
    force_group: int = static_field(default=0)

    def _distance(self, x):
        return _centroid_distance(x, self.group1, self.group2)

    def energy(self, x, box, params=None):
        lam = _controlled(params, self.controlling_parameter_name)
        dr = torch.clamp(self._distance(x) - self.well_radius, min=0.0)
        return lam * 0.5 * self.spring_constant * dr * dr


@tensor_dataclass
class FlatBottomRestraintBondForce(_FlatBottomRadial):
    """Flat-bottom restraint between two atoms."""

    spring_constant: torch.Tensor
    well_radius: torch.Tensor
    atom1: int = static_field(default=0)
    atom2: int = static_field(default=1)
    controlling_parameter_name: str = static_field(default="lambda_restraints")
    force_group: int = static_field(default=0)

    def energy(self, x, box, params=None):
        lam = _controlled(params, self.controlling_parameter_name)
        r = safe_norm(x[self.atom1] - x[self.atom2])
        dr = torch.clamp(r - self.well_radius, min=0.0)
        return lam * 0.5 * self.spring_constant * dr * dr


# -- positional restraints ------------------------------------------------------


@tensor_dataclass
class PositionalRestraintTerm:
    """Harmonic positional restraints, U = (k/2) |x - x0|^2 summed over the
    restrained atoms, k in kJ/mol/nm^2."""

    particles: torch.Tensor               # (P,) int atom indices
    reference_positions: torch.Tensor     # (P, 3) nm
    k: torch.Tensor                       # () kJ/mol/nm^2
    force_group: int = static_field(default=0)

    def energy(self, x, box, params=None):
        d = x[self.particles.long()] - self.reference_positions
        return 0.5 * self.k * torch.sum(d * d)


def restrain_atoms(system: System, positions, atom_indices,
                   sigma: float = 0.3) -> System:
    """The system with harmonic positional restraints on ``atom_indices``
    about their ``positions``, k = kT(298 K) / sigma^2. The spring constant
    is float32, as the JAX package stores it; the reference positions keep
    the positions' type and device."""
    k = kB * 298.0 / sigma ** 2
    positions = torch.as_tensor(positions)
    index = torch.as_tensor(atom_indices, dtype=torch.int32,
                            device=positions.device)
    term = PositionalRestraintTerm(
        particles=index,
        reference_positions=positions.detach()[index.long()].clone(),
        k=torch.as_tensor(k, dtype=torch.float32, device=positions.device))
    return system.replace(terms=system.terms + (term,))


def restrain_atoms_by_dsl(system: System, positions, topology, atoms_dsl,
                          sigma: float = 0.3) -> System:
    """Restrain the atoms that ``topology.select(atoms_dsl)`` picks (an
    mdtraj-style selection such as ``'protein and name CA'``); any
    topology with ``select`` serves."""
    atom_indices = topology.select(atoms_dsl)
    if len(atom_indices) == 0:
        raise ValueError(f"selection {atoms_dsl!r} matched no atoms")
    return restrain_atoms(system, positions, atom_indices, sigma=sigma)


def replace_reaction_field(system: System, switch_width=None,
                           return_copy=True) -> System:
    """Every cutoff_periodic ``NonbondedTerm`` switched to the unshifted
    (c_rf = 0) reaction field with the energy switch applied to the whole
    pair energy (openmmtools' UnshiftedReactionFieldForce), switch width
    ``switch_width`` (default: the term's own, else 0.1 nm). The sweep
    kernel carries both settings (``shift_rf``, ``switch_coulomb``)."""
    terms = []
    for term in system.terms:
        if isinstance(term, NonbondedTerm) and term.method == "cutoff_periodic":
            sw = switch_width if switch_width is not None else term.switch_width
            if sw is None:
                sw = 0.1
            terms.append(term.replace(switch_width=sw, shift_rf=False,
                                      switch_coulomb=True))
        else:
            terms.append(term)
    return system.replace(terms=tuple(terms))
