"""The immutable ``System`` and its energy-term algebra.

Counterpart of ``openmmtools_tpu.system``. A ``System`` is a frozen dataclass
of parameter tensors plus a tuple of energy terms; each term exposes

    term.energy(x, box, params) -> scalar tensor

where ``params`` is a dict of global (context) parameters. Forces are the
analytic ``energy_forces`` where a term has one and ``-grad`` by autograd
otherwise. Force groups (MTS splittings) are static integer tags on terms.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Any, Dict, Optional, Tuple

import torch

from openmmtools_tpu_torch.constants import kB
from openmmtools_tpu_torch.ops import bonded, nonbonded, pair_forces
from openmmtools_tpu_torch.utils.math_eval import math_eval
from openmmtools_tpu_torch.utils.pytree import static_field, tensor_dataclass

GlobalParams = Dict[str, Any]


def _param(params: Optional[GlobalParams], name: Optional[str], default):
    """Resolve a possibly-globally-controlled parameter."""
    if name is None or params is None or name not in params:
        return default
    return params[name]


def value_and_grad(fn, x):
    """``(fn(x), d fn / dx)`` by autograd, detached from the caller's graph;
    a zero gradient where ``fn`` does not depend on ``x`` (as ``jax.grad``
    gives), e.g. the remainder around the sweep kernel of a bare LJ fluid."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        u = fn(xx)
        if not u.requires_grad:
            return u.detach(), torch.zeros_like(x)
        (g,) = torch.autograd.grad(u, xx)
    return u.detach(), g


# ---------------------------------------------------------------------------
# energy terms
# ---------------------------------------------------------------------------


@tensor_dataclass
class HarmonicBondTerm:
    """U = sum (k/2)(r - r0)^2. OpenMM HarmonicBondForce analog."""

    index: torch.Tensor       # (B, 2) int
    length: torch.Tensor      # (B,)
    k: torch.Tensor           # (B,)
    force_group: int = static_field(default=0)

    def energy(self, x, box, params=None):
        return bonded.harmonic_bond_energy(x, self.index, self.length, self.k)


@tensor_dataclass
class HarmonicAngleTerm:
    """U = sum (k/2)(theta - theta0)^2. OpenMM HarmonicAngleForce analog."""

    index: torch.Tensor       # (A, 3) int
    angle: torch.Tensor       # (A,)
    k: torch.Tensor           # (A,)
    force_group: int = static_field(default=0)

    def energy(self, x, box, params=None):
        return bonded.harmonic_angle_energy(x, self.index, self.angle, self.k)


@tensor_dataclass
class PeriodicTorsionTerm:
    """U = sum k(1 + cos(n phi - phase)). OpenMM PeriodicTorsionForce
    analog."""

    index: torch.Tensor       # (T, 4) int
    periodicity: torch.Tensor  # (T,)
    phase: torch.Tensor       # (T,)
    k: torch.Tensor           # (T,)
    force_group: int = static_field(default=0)

    def energy(self, x, box, params=None):
        return bonded.periodic_torsion_energy(
            x, self.index, self.periodicity, self.phase, self.k)


@tensor_dataclass
class NonbondedTerm:
    """LJ + Coulomb with OpenMM NonbondedForce semantics.

    ``exceptions`` *replace* the combination-rule interaction for their pairs
    (chargeprod/sigma/epsilon per pair); excluded pairs are exceptions with
    zero parameters. Exception pairs are MASKED OUT of the dense sum and
    their own interaction is added: an f32 subtract-back of a 1-2 Coulomb
    pair at r ~ 0.1 nm (~1e3 kJ/mol) loses ~1e-4 of it.

    ``method`` in {"no_cutoff", "cutoff_periodic", "cutoff_nonperiodic",
    "pme", "ewald"}; for pme/ewald this term is the direct (erfc) space only.
    """

    charge: torch.Tensor               # (N,)
    sigma: torch.Tensor                # (N,)
    epsilon: torch.Tensor              # (N,)
    exception_index: torch.Tensor      # (E, 2) int
    exception_chargeprod: torch.Tensor  # (E,)
    exception_sigma: torch.Tensor      # (E,)
    exception_epsilon: torch.Tensor    # (E,)
    method: str = static_field(default="no_cutoff")
    cutoff: Optional[float] = static_field(default=None)
    switch_width: Optional[float] = static_field(default=None)  # None = no switch
    dielectric: float = static_field(default=78.3)
    ewald_alpha: Optional[float] = static_field(default=None)
    use_dispersion_correction: bool = static_field(default=False)
    force_group: int = static_field(default=0)
    charge_scale_param: Optional[str] = static_field(default=None)
    lj_scale_param: Optional[str] = static_field(default=None)
    shift_rf: bool = static_field(default=True)
    switch_coulomb: bool = static_field(default=False)

    @property
    def periodic(self) -> bool:
        return self.method in ("cutoff_periodic", "pme", "ewald")

    @functools.cached_property
    def uncharged(self) -> bool:
        """True when every charge is zero (read once: one host sync)."""
        return not bool(torch.any(self.charge != 0))

    def energy(self, x, box, params=None):
        charge_scale = _param(params, self.charge_scale_param, None)
        lj_scale = _param(params, self.lj_scale_param, None)
        e = nonbonded.all_pairs_energy(
            x, box, self.charge, self.sigma, self.epsilon,
            method=self.method, cutoff=self.cutoff,
            switch_width=self.switch_width, dielectric=self.dielectric,
            alpha=self.ewald_alpha, periodic=self.periodic,
            charge_scale=charge_scale, lj_scale=lj_scale,
            shift_rf=self.shift_rf, switch_coulomb=self.switch_coulomb,
            exclude_index=self.exception_index,
        )
        # exceptions: plain LJ+Coulomb, no cutoff/RF/erfc (OpenMM semantics)
        if self.exception_index.shape[0] > 0:
            e = e + nonbonded.pair_list_energy(
                x, box, self.exception_index,
                self.exception_chargeprod, self.exception_sigma,
                self.exception_epsilon,
                method="no_cutoff", periodic=self.periodic,
            )
        if self.use_dispersion_correction and self.periodic:
            e = e + nonbonded.dispersion_correction_energy(
                box, self.sigma, self.epsilon, self.cutoff, lj_scale=lj_scale)
        return e

    def energy_forces(self, x, box, params=None):
        """Joint (U, F) via the hand-differentiated dense pair sum;
        mathematically ``(energy, -grad energy)``."""
        charge_scale = _param(params, self.charge_scale_param, None)
        lj_scale = _param(params, self.lj_scale_param, None)
        # drop all Coulomb math for uncharged systems (LJ fluid)
        charges = self.charge
        if charge_scale is None and self.uncharged:
            charges = None
        u, f = pair_forces.dense_pair_energy_forces(
            x, box, charges, self.sigma, self.epsilon,
            method=self.method, cutoff=self.cutoff,
            switch_width=self.switch_width, dielectric=self.dielectric,
            alpha=self.ewald_alpha, periodic=self.periodic,
            charge_scale=charge_scale, lj_scale=lj_scale,
            shift_rf=self.shift_rf, switch_coulomb=self.switch_coulomb,
            exclude_index=self.exception_index)
        if self.exception_index.shape[0] > 0:
            u_exc, f_exc = pair_forces.pair_list_energy_forces(
                x, box, self.exception_index, self.exception_chargeprod,
                self.exception_sigma, self.exception_epsilon,
                method="no_cutoff", periodic=self.periodic)
            u = u + u_exc
            f = f + f_exc
        if self.use_dispersion_correction and self.periodic:
            # constant-volume tail correction: energy shift, zero force
            u = u + nonbonded.dispersion_correction_energy(
                box, self.sigma, self.epsilon, self.cutoff,
                lj_scale=lj_scale)
        return u, f

    def energy_neighbors(self, x, box, params, nbr):
        """Energy over a fixed-capacity neighbour list (neighbour mode's
        force path); ``nbr`` is an :class:`~openmmtools_tpu_torch.ops.
        neighborlist.NeighborList` built with ``r_list >= cutoff``. The list
        carries no exclusions, so exception pairs are subtracted at their
        combined-rule interaction and their own added back: in float32 this
        costs ~1e-4 of the excepted pairs' magnitude, where :meth:`energy`
        masks them out of the dense sum exactly."""
        from openmmtools_tpu_torch.ops.neighborlist import neighbor_energy

        charge_scale = _param(params, self.charge_scale_param, None)
        lj_scale = _param(params, self.lj_scale_param, None)
        q = self.charge if charge_scale is None else self.charge * charge_scale
        eps = self.epsilon if lj_scale is None else self.epsilon * lj_scale
        sigma = self.sigma
        cutoff, sw = self.cutoff, self.switch_width

        def pair_fn(r2, i, j):
            sig_ij = 0.5 * (sigma[i] + sigma[j])
            eps_ij = torch.sqrt(eps[i] * eps[j])
            r = torch.sqrt(r2)
            e_lj = nonbonded.lj_pair(r2, sig_ij, eps_ij)
            if sw is not None and cutoff is not None:
                e_lj = e_lj * nonbonded.switch_factor(r, cutoff - sw, cutoff)
            e_c = nonbonded.coulomb_pair(
                r, q[i] * q[j], self.method, cutoff=cutoff,
                dielectric=self.dielectric, alpha=self.ewald_alpha,
                shift_rf=self.shift_rf)
            if self.switch_coulomb and sw is not None and cutoff is not None:
                e_c = e_c * nonbonded.switch_factor(r, cutoff - sw, cutoff)
            e = e_lj + e_c
            if cutoff is not None and self.method != "no_cutoff":
                e = torch.where(r2 < cutoff * cutoff, e, 0.0)
            return e

        e = neighbor_energy(x, box, nbr, pair_fn, periodic=self.periodic)
        if self.exception_index.shape[0] > 0:
            i = self.exception_index[:, 0].long()
            j = self.exception_index[:, 1].long()
            e = e - nonbonded.pair_list_energy(
                x, box, self.exception_index, q[i] * q[j],
                0.5 * (sigma[i] + sigma[j]), torch.sqrt(eps[i] * eps[j]),
                method=self.method, cutoff=cutoff, switch_width=sw,
                dielectric=self.dielectric, alpha=self.ewald_alpha,
                periodic=self.periodic, shift_rf=self.shift_rf,
                switch_coulomb=self.switch_coulomb)
            e = e + nonbonded.pair_list_energy(
                x, box, self.exception_index, self.exception_chargeprod,
                self.exception_sigma, self.exception_epsilon,
                method="no_cutoff", periodic=self.periodic)
        if self.use_dispersion_correction and self.periodic:
            e = e + nonbonded.dispersion_correction_energy(
                box, sigma, self.epsilon, cutoff, lj_scale=lj_scale)
        return e


@tensor_dataclass
class CustomExternalTerm:
    """Per-particle external potential from a math expression of (x, y, z)
    (OpenMM CustomExternalForce analog).

    ``global_defaults`` holds default values for the global parameter names
    in the expression; ``params`` overrides them at evaluation time.
    """

    particles: torch.Tensor            # (P,) int
    global_defaults: Dict[str, torch.Tensor]
    expression: str = static_field(default="0.0")
    force_group: int = static_field(default=0)

    def energy(self, x, box, params=None):
        if self.particles.shape[0] == 0:
            return torch.zeros((), dtype=x.dtype, device=x.device)
        xp = x[self.particles.long()]
        variables = dict(self.global_defaults)
        if params is not None:
            for name in self.global_defaults:
                if name in params:
                    variables[name] = params[name]
        variables.update(x=xp[:, 0], y=xp[:, 1], z=xp[:, 2])
        return torch.sum(math_eval(self.expression, variables))


# ---------------------------------------------------------------------------
# constraints & system
# ---------------------------------------------------------------------------


@tensor_dataclass
class VirtualSites:
    """Massless interaction sites reconstructed from parent particles:

        x_site = sum_i w_i x_i  +  w_cross * ((x_2 - x_1) x (x_3 - x_1))

    recomputed inside the energy, so autograd redistributes site forces onto
    the parents.
    """

    site: torch.Tensor      # (V,) int
    parents: torch.Tensor   # (V, 3) int
    weights: torch.Tensor   # (V, 3)
    wcross: torch.Tensor    # (V,)

    @property
    def n_sites(self) -> int:
        return self.site.shape[0]

    def reconstruct(self, x):
        if self.site.shape[0] == 0:
            return x
        parent_pos = x[self.parents.long()]           # (V, 3, 3)
        site_pos = torch.sum(self.weights[:, :, None] * parent_pos, dim=1)
        r12 = parent_pos[:, 1] - parent_pos[:, 0]
        r13 = parent_pos[:, 2] - parent_pos[:, 0]
        site_pos = site_pos + self.wcross[:, None] * torch.linalg.cross(r12, r13)
        return x.index_put((self.site.long(),), site_pos.to(x.dtype))


def no_virtual_sites(device="cuda") -> VirtualSites:
    return VirtualSites(
        site=torch.zeros((0,), dtype=torch.int32, device=device),
        parents=torch.zeros((0, 3), dtype=torch.int32, device=device),
        weights=torch.zeros((0, 3), dtype=torch.float32, device=device),
        wcross=torch.zeros((0,), dtype=torch.float32, device=device))


@tensor_dataclass
class Constraints:
    """Holonomic distance constraints |x_i - x_j| = d (SHAKE/RATTLE targets)."""

    index: torch.Tensor       # (C, 2) int
    distance: torch.Tensor    # (C,)

    @property
    def n_constraints(self) -> int:
        return self.index.shape[0]


def no_constraints(device="cuda") -> Constraints:
    return Constraints(
        index=torch.zeros((0, 2), dtype=torch.int32, device=device),
        distance=torch.zeros((0,), dtype=torch.float32, device=device))


def _hash_into(h, value):
    if isinstance(value, torch.Tensor):
        arr = value.detach().cpu().contiguous()
        h.update(f"{arr.dtype}{tuple(arr.shape)}".encode())
        h.update(arr.numpy().tobytes())
    elif dataclasses.is_dataclass(value):
        h.update(type(value).__name__.encode())
        for f in dataclasses.fields(value):
            h.update(f.name.encode())
            _hash_into(h, getattr(value, f.name))
    elif isinstance(value, (tuple, list)):
        h.update(f"{type(value).__name__}{len(value)}".encode())
        for v in value:
            _hash_into(h, v)
    elif isinstance(value, dict):
        for k in sorted(value):
            h.update(repr(k).encode())
            _hash_into(h, value[k])
    else:
        h.update(repr(value).encode())


@tensor_dataclass
class System:
    """Immutable system: masses + energy terms + constraints (+ default box).

    All mutation builds a new dataclass (``replace``); ``to(device, dtype)``
    moves every tensor.
    """

    masses: torch.Tensor                       # (N,) amu; 0 = immobile
    terms: Tuple[Any, ...]                     # energy terms
    constraints: Constraints
    default_box: Optional[torch.Tensor] = None  # (3, 3) nm
    virtual_sites: Optional[VirtualSites] = None
    periodic: bool = static_field(default=False)

    @property
    def n_particles(self) -> int:
        return self.masses.shape[0]

    @property
    def device(self) -> torch.device:
        return self.masses.device

    @functools.cached_property
    def fingerprint(self) -> str:
        """Content hash of the whole system (structure + tensor bytes): a
        stable identity for caches of bound integrators. Computed once per
        instance; it copies every tensor to the host."""
        h = hashlib.blake2b(digest_size=16)
        _hash_into(h, self)
        return h.hexdigest()

    def energy(self, x, box=None, params=None, groups=None):
        return make_energy_fn(self, groups=groups)(x, box, params)

    def find_terms(self, term_type):
        """All (position, term) pairs of a given type."""
        return [(i, t) for i, t in enumerate(self.terms)
                if isinstance(t, term_type)]

    def replace_term(self, position: int, new_term) -> "System":
        terms = list(self.terms)
        terms[position] = new_term
        return self.replace(terms=tuple(terms))


def _select_terms(system: System, groups):
    if groups is None:
        return system.terms
    if isinstance(groups, int):
        return tuple(t for t in system.terms if (groups >> t.force_group) & 1)
    gs = frozenset(groups)
    return tuple(t for t in system.terms if t.force_group in gs)


# from this many atoms up, a system on the card never takes the dense O(N^2)
# energy: its (N, N) pair tensors are a cliff (576 M entries a tensor at
# 24,000 atoms); the bound integrators' sweep path serves it instead
DENSE_LIMIT = 4096


def refuse_dense(system: System, x, what):
    """Raise where the dense O(N^2) sum would serve a system of
    ``DENSE_LIMIT`` atoms or more on the card."""
    if x.device.type == "cuda" and system.n_particles >= DENSE_LIMIT:
        raise RuntimeError(
            f"{what} would take the dense O(N^2) sum of a "
            f"{system.n_particles}-atom system on the card")


def make_energy_fn(system: System, groups=None):
    """Return ``U(x, box, params) -> scalar`` summing the selected terms.

    ``groups``: None (all terms), an iterable of force groups, or an int
    bitmask of them.
    """
    selected = _select_terms(system, groups)
    vsites = system.virtual_sites

    def energy_fn(x, box=None, params=None):
        if box is None:
            box = system.default_box
        if vsites is not None and vsites.site.shape[0] > 0:
            x = vsites.reconstruct(x)
        total = torch.zeros((), dtype=x.dtype, device=x.device)
        for term in selected:
            total = total + term.energy(x, box, params)
        return total

    return energy_fn


def make_energy_force_fn(system: System, groups=None):
    """Return ``(x, box, params) -> (U, F)`` for the selected force groups.

    Uses each term's analytic ``energy_forces`` where it has one and
    autograd otherwise; systems with virtual sites use whole-system autograd
    so site forces redistribute onto parents.
    """
    selected = _select_terms(system, groups)
    vsites = system.virtual_sites
    if vsites is not None and vsites.site.shape[0] > 0:
        u_fn = make_energy_fn(system, groups=groups)

        def ef_vsites(x, box=None, params=None):
            u, g = value_and_grad(lambda xx: u_fn(xx, box, params), x)
            return u, -g

        return ef_vsites

    def energy_force_fn(x, box=None, params=None):
        if box is None:
            box = system.default_box
        total_u = torch.zeros((), dtype=x.dtype, device=x.device)
        total_f = torch.zeros_like(x)
        for term in selected:
            if hasattr(term, "energy_forces"):
                u, f = term.energy_forces(x, box, params)
            else:
                u, g = value_and_grad(
                    lambda xx, t=term: t.energy(xx, box, params), x)
                f = -g
            total_u = total_u + u
            total_f = total_f + f
        return total_u, total_f

    return energy_force_fn


def make_force_fn(system: System, groups=None):
    """Return ``F(x, box, params) -> (N, 3)`` = -grad U."""
    u = make_energy_fn(system, groups=groups)

    def force_fn(x, box=None, params=None):
        return -value_and_grad(lambda xx: u(xx, box, params), x)[1]

    return force_fn


def kinetic_energy(masses, velocities):
    """KE = 1/2 sum m v^2 (kJ/mol in internal units)."""
    return 0.5 * torch.sum(masses[:, None] * velocities * velocities)


def instantaneous_temperature(masses, velocities, n_constraints=0):
    """Temperature from KE with DOF = 3 N_mobile - n_constraints."""
    n_mobile = torch.sum(masses > 0)
    dof = 3 * n_mobile - n_constraints
    return 2.0 * kinetic_energy(masses, velocities) / (dof * kB)


def volume(box) -> torch.Tensor:
    """Box volume (product of the diagonal)."""
    return torch.prod(torch.diagonal(box))
