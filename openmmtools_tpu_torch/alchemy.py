"""Alchemical factory: lambda-parameterized softcore energy terms
(counterpart of ``alchemy.py``).

openmmtools' factory rewrites an OpenMM System into nn/na/aa force objects
with softcore expressions. Here :class:`AbsoluteAlchemicalFactory` rewrites
the immutable ``System``, replacing the NonbondedTerm with one
:class:`AlchemicalNonbondedTerm` whose per-pair lambda encodes the class of
each pair:

* nn pairs   -> lambda = 1 (softcore reduces exactly to standard LJ/Coulomb)
* na pairs   -> lambda = lambda_region
* aa (same region) -> lambda_region if annihilate else 1 (defaults:
  annihilate_electrostatics=True, annihilate_sterics=False)
* aa (different regions) -> lambda_A * lambda_B if the region pair interacts,
  else 0

The dense ``energy`` holds (N, N) matrices: it is the correctness path for
small systems and the oracle of sweep mode, which evaluates the same term
through the alchemical variant of the sweep kernel
(:mod:`openmmtools_tpu_torch.ops.sweep_nb`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch

from openmmtools_tpu_torch.ops import bonded as bonded_ops
from openmmtools_tpu_torch.ops import nonbonded as nb_ops
from openmmtools_tpu_torch.ops import softcore as sc
from openmmtools_tpu_torch.ops.gbsa import GBSAOBCTerm
from openmmtools_tpu_torch.ops.geometry import minimum_image
from openmmtools_tpu_torch.ops.pme import EwaldReciprocalTerm
from openmmtools_tpu_torch.states import (
    GlobalParameter,
    GlobalParameterFunction,
    GlobalParameterState,
)
from openmmtools_tpu_torch.system import (
    CustomExternalTerm,
    HarmonicAngleTerm,
    HarmonicBondTerm,
    NonbondedTerm,
    PeriodicTorsionTerm,
    System,
    volume,
)
from openmmtools_tpu_torch.utils.pytree import static_field, tensor_dataclass


class AlchemyError(ValueError):
    """Alchemical-factory error (a ValueError, as openmmtools raises)."""


# ---------------------------------------------------------------------------
# AlchemicalRegion / AlchemicalFunction / AlchemicalState
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AlchemicalRegion:
    """An alchemically modified region. ``alchemical_bonds/angles/torsions``
    may be True (every term fully inside the region), an explicit list of
    term indices, or None/False (left unsoftened)."""

    alchemical_atoms: Sequence[int] = ()
    alchemical_bonds: Any = None
    alchemical_angles: Any = None
    alchemical_torsions: Any = None
    annihilate_electrostatics: bool = True
    annihilate_sterics: bool = False
    softcore_alpha: float = 0.5
    softcore_a: float = 1.0
    softcore_b: float = 1.0
    softcore_c: float = 6.0
    softcore_beta: float = 0.0
    softcore_d: float = 1.0
    softcore_e: float = 1.0
    softcore_f: float = 2.0
    name: Optional[str] = None


class AlchemicalFunction(GlobalParameterFunction):
    """A lambda parameter enslaved to an expression of function variables,
    e.g. AlchemicalFunction('lambda**2')."""


def _validate_lambda(self, value):
    if isinstance(value, (int, float)) and not 0.0 <= value <= 1.0:
        raise ValueError(f"lambda must be in [0, 1], got {value}")
    return value


class AlchemicalState(GlobalParameterState):
    """Composable state of the alchemical lambdas: lambda_sterics,
    lambda_electrostatics, lambda_bonds, lambda_angles, lambda_torsions,
    each validated to [0, 1]."""

    lambda_sterics = GlobalParameter("lambda_sterics", 1.0, _validate_lambda)
    lambda_electrostatics = GlobalParameter("lambda_electrostatics", 1.0,
                                            _validate_lambda)
    lambda_bonds = GlobalParameter("lambda_bonds", 1.0, _validate_lambda)
    lambda_angles = GlobalParameter("lambda_angles", 1.0, _validate_lambda)
    lambda_torsions = GlobalParameter("lambda_torsions", 1.0, _validate_lambda)

    def set_alchemical_parameters(self, new_value):
        """Set every defined lambda to ``new_value``."""
        for name, value in self._parameters.items():
            if value is not None:
                self._parameters[name] = _validate_lambda(self, new_value)


# ---------------------------------------------------------------------------
# alchemical energy terms
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _table(values, device):
    """The (nested) tuple ``values`` as a tensor on ``device``, copied from
    the host once: the step program, replayed as a CUDA graph, copies
    nothing from the host."""
    return torch.tensor(values, device=device)


def region_lambdas(params, names, like):
    """The regions' lambdas (R,) in ``like``'s type and device: each read
    from ``params`` (a float or a tensor), 1 where absent. Tensor
    operations only, so device-resident parameters are never read back."""
    vals = []
    for name in names:
        v = params.get(name, 1.0) if params is not None else 1.0
        vals.append(torch.as_tensor(v, dtype=like.dtype, device=like.device))
    if not vals:
        return torch.ones((0,), dtype=like.dtype, device=like.device)
    return torch.stack(vals)


@tensor_dataclass
class AlchemicalNonbondedTerm:
    """Softcore nonbonded term with per-pair lambda classification: one
    term in place of openmmtools' NonbondedForce plus the aa/na
    CustomNonbondedForces and exception CustomBondForces."""

    charge: torch.Tensor              # (N,)
    sigma: torch.Tensor               # (N,)
    epsilon: torch.Tensor             # (N,)
    region_id: torch.Tensor           # (N,) int32; -1 = non-alchemical
    exception_index: torch.Tensor     # (E, 2)
    exception_chargeprod: torch.Tensor
    exception_sigma: torch.Tensor
    exception_epsilon: torch.Tensor
    method: str = static_field(default="no_cutoff")
    cutoff: Optional[float] = static_field(default=None)
    switch_width: Optional[float] = static_field(default=None)
    dielectric: float = static_field(default=78.3)
    ewald_alpha: Optional[float] = static_field(default=None)
    use_dispersion_correction: bool = static_field(default=False)
    force_group: int = static_field(default=0)
    # region metadata (parallel tuples, one entry per region)
    lambda_sterics_names: Tuple[str, ...] = static_field(default=())
    lambda_electrostatics_names: Tuple[str, ...] = static_field(default=())
    annihilate_sterics: Tuple[bool, ...] = static_field(default=())
    annihilate_electrostatics: Tuple[bool, ...] = static_field(default=())
    region_interactions: Tuple[Tuple[int, int], ...] = static_field(default=())
    # exception scaling law: False scales exception chargeprod/epsilon
    # linearly with lambda in the plain kernels; True applies the softcore
    # expressions of regular pairs. The endpoints agree.
    consistent_exceptions: bool = static_field(default=False)
    # 'exact' PME treatment: electrostatics by per-particle linear charge
    # scaling (as in reciprocal space) instead of softcore
    exact_electrostatics: bool = static_field(default=False)
    # 'coulomb' PME treatment: alchemically involved pairs use the plain
    # Coulomb kernel in direct space (reciprocal space sees no alchemical
    # charge)
    coulomb_pme_treatment: bool = static_field(default=False)
    # reaction field: 'switched' is the unshifted (c_rf = 0) field with the
    # quintic switch on the whole pair energy
    shift_rf: bool = static_field(default=True)
    switch_coulomb: bool = static_field(default=False)
    # softcore constants (region 0's, shared by every region)
    softcore_alpha: float = static_field(default=0.5)
    softcore_a: float = static_field(default=1.0)
    softcore_b: float = static_field(default=1.0)
    softcore_c: float = static_field(default=6.0)
    softcore_beta: float = static_field(default=0.0)
    softcore_d: float = static_field(default=1.0)
    softcore_e: float = static_field(default=1.0)
    softcore_f: float = static_field(default=2.0)

    @property
    def periodic(self) -> bool:
        return self.method in ("cutoff_periodic", "pme", "ewald")

    @property
    def n_regions(self) -> int:
        return len(self.annihilate_sterics)

    @property
    def global_defaults(self) -> Dict[str, float]:
        out = {}
        for name in self.lambda_sterics_names:
            out[name] = 1.0
        for name in self.lambda_electrostatics_names:
            out[name] = 1.0
        return out

    # -- lambda classification ---------------------------------------------
    def _pair_lambdas(self, rid_i, rid_j, lam_regions, annihilate):
        """Effective lambda of pairs from their region ids (-1 = env)."""
        ones = torch.ones((1,), dtype=lam_regions.dtype,
                          device=lam_regions.device)
        ext = torch.cat([ones, lam_regions])
        ri = (rid_i + 1).long()
        rj = (rid_j + 1).long()
        lam = ext[ri] * ext[rj]   # nn: 1, na: lambda, cross-aa: lamA lamB
        same = (rid_i == rid_j) & (rid_i >= 0)
        ann_ext = _table((False,) + tuple(annihilate), lam_regions.device)
        lam_same = torch.where(ann_ext[ri], ext[ri], 1.0)
        lam = torch.where(same, lam_same, lam)
        n_regions = len(annihilate)
        if n_regions > 1:
            # cross-region pairs without a declared interaction: none
            pairs = {frozenset(p) for p in self.region_interactions}
            allowed = _table(tuple(tuple(frozenset((a, b)) in pairs
                                         for b in range(n_regions))
                                   for a in range(n_regions)),
                             lam_regions.device)
            cross = (rid_i >= 0) & (rid_j >= 0) & (rid_i != rid_j)
            ok = allowed[torch.clamp(rid_i, min=0).long(),
                         torch.clamp(rid_j, min=0).long()]
            lam = torch.where(cross & ~ok, 0.0, lam)
        return lam

    def _lambdas(self, params, like):
        return (region_lambdas(params, self.lambda_sterics_names, like),
                region_lambdas(params, self.lambda_electrostatics_names, like))

    def sweep_lambdas(self, params, like):
        """The alchemical sweep kernel's class scalars from the global
        parameters, by tensor operations only (no host read of a lambda).

        Each region-pair class (a, b) of the kernel (``alch_classes``) takes
        the effective pair lambda this term's ``_pair_lambdas`` gives it (na:
        lam_r; same region: lam_r if annihilating, else 1; cross: lam_a
        lam_b, or 0 outside ``region_interactions``). Returns (lam (3 C,)
        [lam_s^a | alpha (1 - lam_s)^b | lam_e^d], lam_s^a per class (C,),
        and for the 'exact' treatment the charge scale by region code
        (R+1,), else None; with 'exact' the kernel's lam_e is 1)."""
        lam_s_reg, lam_e_reg = self._lambdas(params, like)
        R = self.n_regions
        allowed = np.zeros((R, R), dtype=bool)
        for a, b in self.region_interactions:
            allowed[a, b] = allowed[b, a] = True
        classes = [(a, b) for a in range(R + 1) for b in range(a, R + 1)][1:]
        one = torch.ones((), dtype=like.dtype, device=like.device)
        zero = torch.zeros((), dtype=like.dtype, device=like.device)

        def class_eff(reg, ann):
            vals = []
            for a, b in classes:
                if a == 0:
                    vals.append(reg[b - 1])
                elif a == b:
                    vals.append(reg[a - 1] if ann[a - 1] else one)
                else:
                    vals.append(reg[a - 1] * reg[b - 1]
                                if allowed[a - 1, b - 1] else zero)
            return torch.stack(vals)

        ls_eff = class_eff(lam_s_reg, self.annihilate_sterics)
        lam_s_cls = sc._pow(ls_eff, self.softcore_a)
        asc_cls = self.softcore_alpha * sc._pow(1.0 - ls_eff, self.softcore_b)
        charge_scale = None
        if self.exact_electrostatics:
            # per-particle linear charge scaling; the kernel's Coulomb runs
            # unscaled
            charge_scale = torch.cat([one[None], lam_e_reg])
            lam_e_cls = torch.ones_like(lam_s_cls)
        else:
            le_eff = class_eff(lam_e_reg, self.annihilate_electrostatics)
            lam_e_cls = sc._pow(le_eff, self.softcore_d)
        return (torch.cat([lam_s_cls, asc_cls, lam_e_cls]), lam_s_cls,
                charge_scale)

    # -- energy -------------------------------------------------------------
    def energy(self, x, box, params=None):
        n = x.shape[0]
        lam_s_regions, lam_e_regions = self._lambdas(params, x)
        rid = self.region_id
        rid_i = rid[:, None]
        rid_j = rid[None, :]
        lam_s = self._pair_lambdas(rid_i, rid_j, lam_s_regions,
                                   self.annihilate_sterics)
        lam_e = self._pair_lambdas(rid_i, rid_j, lam_e_regions,
                                   self.annihilate_electrostatics)

        d = x[:, None, :] - x[None, :, :]
        if self.periodic:
            d = minimum_image(d, box)
        r2_raw = torch.sum(d * d, dim=-1)
        mask = torch.ones((n, n), dtype=torch.bool, device=x.device).triu(1)
        if self.cutoff is not None and self.method != "no_cutoff":
            mask = mask & (r2_raw < self.cutoff * self.cutoff)
        if self.exception_index.shape[0] > 0:
            # exceptions REPLACE the combination-rule interaction: masked
            # out of the dense sum, not subtracted back (an f32 subtract of
            # a 1-2 Coulomb pair loses ~1e-4 of it)
            mask = mask & nb_ops._exclusion_keep(self.exception_index, n,
                                                 x.device)
        r2 = torch.where(mask, torch.clamp(r2_raw, min=1e-12), 1.0)
        r = torch.sqrt(r2)

        sig_safe = torch.clamp(self.sigma, min=1e-6)  # sigma = 0 particles
        sig_ij = 0.5 * (sig_safe[:, None] + sig_safe[None, :])
        eps_ij = torch.sqrt(self.epsilon[:, None] * self.epsilon[None, :])
        qq_ij = self.charge[:, None] * self.charge[None, :]

        involved = (rid_i >= 0) | (rid_j >= 0)
        e_lj = self._sterics(r2, sig_ij, eps_ij, lam_s)
        if self.switch_width is not None and self.cutoff is not None:
            e_lj = e_lj * nb_ops.switch_factor(
                r, self.cutoff - self.switch_width, self.cutoff)
        if self.exact_electrostatics:
            # q_i q_j scaled by the per-particle lambdas; the method's plain
            # kernel, no softcore (charge-scaled PME)
            lam_p = torch.cat([torch.ones((1,), dtype=x.dtype,
                                          device=x.device),
                               lam_e_regions])[(rid + 1).long()]
            qq_scaled = qq_ij * lam_p[:, None] * lam_p[None, :]
            e_coul = nb_ops.coulomb_pair(
                r, qq_scaled, self.method, cutoff=self.cutoff,
                dielectric=self.dielectric, alpha=self.ewald_alpha)
        else:
            e_coul = self._electrostatics(r, qq_ij, sig_ij, lam_e,
                                          involved=involved)
        if (self.switch_coulomb and self.switch_width is not None
                and self.cutoff is not None):
            e_coul = e_coul * nb_ops.switch_factor(
                r, self.cutoff - self.switch_width, self.cutoff)
        e = torch.sum(torch.where(mask, e_lj + e_coul, 0.0))
        e = e + self.exception_add_energy(x, box, params)
        if self.use_dispersion_correction and self.periodic:
            e = e + self._dispersion_correction(box, lam_s)
        return e

    def _sterics(self, r2, sig, eps, lam):
        return sc.softcore_lj(r2, sig, eps, lam, alpha=self.softcore_alpha,
                              a=self.softcore_a, b=self.softcore_b,
                              c=self.softcore_c)

    def _exception_add(self, r2e, re, lam_s_exc, lam_e_exc):
        """Exception pairs' own (no cutoff) energies, scaled by lambda as
        the consistent_exceptions law says."""
        sig_exc = torch.clamp(self.exception_sigma, min=1e-6)
        if self.consistent_exceptions:
            add = sc.softcore_lj(
                r2e, sig_exc, self.exception_epsilon, lam_s_exc,
                alpha=self.softcore_alpha, a=self.softcore_a,
                b=self.softcore_b, c=self.softcore_c)
            return add + sc.softcore_coulomb(
                re, self.exception_chargeprod, sig_exc, lam_e_exc,
                method="no_cutoff", beta=self.softcore_beta,
                d=self.softcore_d, e=self.softcore_e, f=self.softcore_f)
        # openmmtools' default (consistent_exceptions=False): exception
        # chargeprod and epsilon scale linearly with lambda in the plain
        # kernels
        add = nb_ops.lj_pair(r2e, sig_exc, self.exception_epsilon * lam_s_exc)
        return add + nb_ops.coulomb_pair(
            re, self.exception_chargeprod * lam_e_exc, "no_cutoff",
            dielectric=self.dielectric)

    def exception_add_energy(self, x, box, params=None):
        """The exception pairs' own energy alone: the part of
        :meth:`energy` that sweep mode adds around the kernel, which masks
        the exception pairs out of its pair sum."""
        if self.exception_index.shape[0] == 0:
            return torch.zeros((), dtype=x.dtype, device=x.device)
        lam_s_regions, lam_e_regions = self._lambdas(params, x)
        rid = self.region_id
        i = self.exception_index[:, 0].long()
        j = self.exception_index[:, 1].long()
        de = x[i] - x[j]
        if self.periodic:
            de = minimum_image(de, box)
        r2e = torch.clamp(torch.sum(de * de, dim=-1), min=1e-12)
        re = torch.sqrt(r2e)
        lam_s_exc = self._pair_lambdas(rid[i], rid[j], lam_s_regions,
                                       self.annihilate_sterics)
        lam_e_exc = self._pair_lambdas(rid[i], rid[j], lam_e_regions,
                                       self.annihilate_electrostatics)
        return torch.sum(self._exception_add(r2e, re, lam_s_exc, lam_e_exc))

    def _electrostatics(self, r, qq, sig, lam, involved=None):
        e = sc.softcore_coulomb(
            r, qq, sig, lam, method=self.method, cutoff=self.cutoff,
            dielectric=self.dielectric, ewald_alpha=self.ewald_alpha,
            beta=self.softcore_beta, d=self.softcore_d, e=self.softcore_e,
            f=self.softcore_f, shift_rf=self.shift_rf)
        if self.coulomb_pme_treatment and involved is not None:
            # 'coulomb' treatment: alchemically involved pairs use the plain
            # Coulomb kernel in place of erfc direct space
            e_plain = sc.softcore_coulomb(
                r, qq, sig, lam, method="no_cutoff",
                beta=self.softcore_beta, d=self.softcore_d,
                e=self.softcore_e, f=self.softcore_f)
            e = torch.where(involved, e_plain, e)
        return e

    def _dispersion_correction(self, box, lam_s):
        """The lambda-weighted analytic tail: the softcore tail is lam^a
        times the standard tail at r >> sigma, averaged over the (N, N) pair
        matrix."""
        sig_safe = torch.clamp(self.sigma, min=1e-6)
        sig_ij = 0.5 * (sig_safe[:, None] + sig_safe[None, :])
        eps_ij = torch.sqrt(self.epsilon[:, None] * self.epsilon[None, :])
        s3 = sig_ij ** 3
        s6 = s3 * s3
        s12 = s6 * s6
        rc3 = self.cutoff ** 3
        rc9 = rc3 ** 3
        integral = 4.0 * eps_ij * (s12 / (9.0 * rc9) - s6 / (3.0 * rc3))
        weighted = sc._pow(lam_s, self.softcore_a) * integral
        n = self.sigma.shape[0]
        return 2.0 * math.pi * n * n / volume(box) * torch.mean(weighted)


@tensor_dataclass
class AlchemicalHarmonicBondTerm:
    """Harmonic bonds with lambda_bonds-scaled spring constants on the
    alchemical subset."""

    index: torch.Tensor
    length: torch.Tensor
    k: torch.Tensor
    alchemical: torch.Tensor          # (B,) 0/1 mask
    lambda_name: str = static_field(default="lambda_bonds")
    force_group: int = static_field(default=0)

    @property
    def global_defaults(self):
        return {self.lambda_name: 1.0}

    def energy(self, x, box, params=None):
        lam = params.get(self.lambda_name, 1.0) if params else 1.0
        scale = torch.where(self.alchemical > 0, lam, 1.0)
        return bonded_ops.harmonic_bond_energy(x, self.index, self.length,
                                               self.k, scale=scale)


@tensor_dataclass
class AlchemicalHarmonicAngleTerm:
    """lambda_angles-scaled harmonic angles."""

    index: torch.Tensor
    angle: torch.Tensor
    k: torch.Tensor
    alchemical: torch.Tensor
    lambda_name: str = static_field(default="lambda_angles")
    force_group: int = static_field(default=0)

    @property
    def global_defaults(self):
        return {self.lambda_name: 1.0}

    def energy(self, x, box, params=None):
        lam = params.get(self.lambda_name, 1.0) if params else 1.0
        scale = torch.where(self.alchemical > 0, lam, 1.0)
        return bonded_ops.harmonic_angle_energy(x, self.index, self.angle,
                                                self.k, scale=scale)


@tensor_dataclass
class AlchemicalPeriodicTorsionTerm:
    """lambda_torsions-scaled periodic torsions."""

    index: torch.Tensor
    periodicity: torch.Tensor
    phase: torch.Tensor
    k: torch.Tensor
    alchemical: torch.Tensor
    lambda_name: str = static_field(default="lambda_torsions")
    force_group: int = static_field(default=0)

    @property
    def global_defaults(self):
        return {self.lambda_name: 1.0}

    def energy(self, x, box, params=None):
        lam = params.get(self.lambda_name, 1.0) if params else 1.0
        scale = torch.where(self.alchemical > 0, lam, 1.0)
        return bonded_ops.periodic_torsion_energy(
            x, self.index, self.periodicity, self.phase, self.k, scale=scale)


# ---------------------------------------------------------------------------
# the factory
# ---------------------------------------------------------------------------


class AbsoluteAlchemicalFactory:
    """Rewrite a System into its alchemically modified counterpart.

    ``alchemical_pme_treatment`` in {'direct-space', 'exact', 'coulomb'}
    (exact: linear per-particle charge scaling through reciprocal space;
    coulomb: plain-Coulomb direct space for alchemical pairs, no alchemical
    charge in reciprocal space); ``alchemical_rf_treatment`` in {'switched',
    'shifted'} (switched: c_rf = 0 reaction field with the quintic switch on
    the whole pair energy); ``disable_alchemical_dispersion_correction``;
    ``switch_width`` override; ``split_alchemical_forces`` (the alchemical
    term in force group 1).
    """

    def __init__(self, consistent_exceptions=False,
                 alchemical_pme_treatment="direct-space",
                 alchemical_rf_treatment="switched",
                 disable_alchemical_dispersion_correction=False,
                 split_alchemical_forces=True, switch_width=None):
        if alchemical_pme_treatment not in ("direct-space", "exact",
                                            "coulomb"):
            raise AlchemyError(
                f"unknown alchemical_pme_treatment "
                f"{alchemical_pme_treatment!r}")
        if alchemical_rf_treatment not in ("switched", "shifted"):
            raise AlchemyError(
                f"unknown alchemical_rf_treatment "
                f"{alchemical_rf_treatment!r}")
        self.consistent_exceptions = consistent_exceptions
        self.alchemical_pme_treatment = alchemical_pme_treatment
        self.alchemical_rf_treatment = alchemical_rf_treatment
        self.disable_alchemical_dispersion_correction = (
            disable_alchemical_dispersion_correction)
        self.split_alchemical_forces = split_alchemical_forces
        self.switch_width = switch_width

    def create_alchemical_system(
            self, reference_system: System, alchemical_regions,
            alchemical_region_interactions: FrozenSet = frozenset()) -> System:
        if isinstance(alchemical_regions, AlchemicalRegion):
            alchemical_regions = [alchemical_regions]
        regions: List[AlchemicalRegion] = list(alchemical_regions)
        if len(regions) > 1 and any(r.name is None for r in regions):
            raise AlchemyError("multiple regions require names")
        names = {r.name for r in regions}
        if len(names) != len(regions):
            raise AlchemyError("alchemical region names must be unique")

        n = reference_system.n_particles
        region_id = np.full(n, -1, dtype=np.int32)
        for ridx, reg in enumerate(regions):
            atoms = np.asarray(list(reg.alchemical_atoms), dtype=np.int64)
            if atoms.size == 0 and not any(
                    (reg.alchemical_bonds, reg.alchemical_angles,
                     reg.alchemical_torsions)):
                raise AlchemyError(
                    "alchemical region defines no atoms, bonds, angles or "
                    "torsions")
            if atoms.size and (atoms.min() < 0 or atoms.max() >= n):
                raise AlchemyError(
                    f"alchemical atom indices out of range for a "
                    f"{n}-particle system: "
                    f"[{atoms.min()}, {atoms.max()}]")
            if np.any(region_id[atoms] >= 0):
                raise AlchemyError("alchemical regions overlap")
            region_id[atoms] = ridx

        def suffix(reg):
            return "" if reg.name is None else f"_{reg.name}"

        region_name_to_idx = {r.name: i for i, r in enumerate(regions)}
        interactions = tuple(sorted(
            tuple(sorted((region_name_to_idx[a], region_name_to_idx[b])))
            for a, b in alchemical_region_interactions))

        terms = []
        for term in reference_system.terms:
            if isinstance(term, NonbondedTerm):
                terms.append(self._alchemical_nonbonded(
                    term, region_id, regions, suffix, interactions))
            elif (isinstance(term, EwaldReciprocalTerm)
                    and self.alchemical_pme_treatment == "coulomb"):
                # 'coulomb': the plain-Coulomb direct-space expression
                # carries all alchemical electrostatics; reciprocal space
                # sees zero alchemical charge at every lambda
                mask = _mask_like(region_id >= 0, term.charge)
                terms.append(term.replace(charge=term.charge * (1.0 - mask)))
            elif (isinstance(term, EwaldReciprocalTerm)
                    and self.alchemical_pme_treatment == "exact"):
                # exact PME: lambda_electrostatics scales the alchemical
                # charges in reciprocal space too (one region only)
                if len(regions) > 1:
                    raise AlchemyError(
                        "exact PME treatment supports one alchemical region")
                terms.append(term.replace(
                    alch_mask=_mask_like(region_id >= 0, term.charge),
                    lambda_name=f"lambda_electrostatics{suffix(regions[0])}"))
            elif isinstance(term, GBSAOBCTerm):
                # alchemically modified GB: lambda_electrostatics scales the
                # alchemical atoms' charges, descreening and surface term
                if len(regions) > 1:
                    raise AlchemyError(
                        "multiple alchemical regions are not supported for "
                        "GBSAOBCForce")
                terms.append(term.replace(
                    alchemical=_mask_like(region_id >= 0, term.charge),
                    lambda_name=f"lambda_electrostatics{suffix(regions[0])}"))
            elif isinstance(term, HarmonicBondTerm) and any(
                    r.alchemical_bonds for r in regions):
                terms.append(self._alchemical_bonds(term, region_id, regions,
                                                    suffix))
            elif isinstance(term, HarmonicAngleTerm) and any(
                    r.alchemical_angles for r in regions):
                terms.append(self._alchemical_angles(term, region_id, regions,
                                                     suffix))
            elif isinstance(term, PeriodicTorsionTerm) and any(
                    r.alchemical_torsions for r in regions):
                terms.append(self._alchemical_torsions(term, region_id,
                                                       regions, suffix))
            else:
                self._check_unhandled_term(term, region_id)
                terms.append(term)
        return reference_system.replace(terms=tuple(terms))

    @staticmethod
    def _check_unhandled_term(term, region_id):
        """Refuse to pass an unknown interacting term that touches
        alchemical atoms through unsoftened. Known bonded terms pass (their
        softening is opt-in), and so do external one-particle fields and the
        Ewald reciprocal term (direct-space treatment)."""
        if isinstance(term, (HarmonicBondTerm, HarmonicAngleTerm,
                             PeriodicTorsionTerm, CustomExternalTerm,
                             EwaldReciprocalTerm)):
            return
        idx_arrays = []
        for attr in ("index", "particles"):
            a = getattr(term, attr, None)
            if a is not None:
                idx_arrays.append(
                    np.asarray(a.cpu()).reshape(-1).astype(np.int64))
        if idx_arrays:
            touched = np.concatenate(idx_arrays)
            touches = bool(np.any(region_id[touched] >= 0))
        else:
            # no index structure: an all-particle interaction, which
            # necessarily touches the region
            touches = True
        if touches:
            raise AlchemyError(
                f"cannot alchemically modify term type "
                f"{type(term).__name__}: it interacts with atoms of an "
                "alchemical region but no alchemical rewrite is registered "
                "for it (a silent passthrough would leave those interactions "
                "unsoftened at every lambda)")

    # -- per-term rewrites --------------------------------------------------
    def _alchemical_nonbonded(self, term: NonbondedTerm, region_id, regions,
                              suffix, interactions) -> AlchemicalNonbondedTerm:
        reg0 = regions[0]
        switch_width = term.switch_width
        if self.switch_width is not None:
            switch_width = self.switch_width
        exact = (self.alchemical_pme_treatment == "exact"
                 and term.method in ("pme", "ewald"))
        coulomb = (self.alchemical_pme_treatment == "coulomb"
                   and term.method in ("pme", "ewald"))
        # 'switched' reaction field: unshifted (c_rf = 0) with the quintic
        # switch on the pair energy, applied to the whole term
        switched_rf = (self.alchemical_rf_treatment == "switched"
                       and term.method in ("cutoff_periodic",
                                           "cutoff_nonperiodic"))
        if switched_rf and switch_width is None:
            switch_width = 0.1   # openmmtools' default switch width: 1 A
        return AlchemicalNonbondedTerm(
            consistent_exceptions=self.consistent_exceptions,
            exact_electrostatics=exact,
            coulomb_pme_treatment=coulomb,
            shift_rf=not switched_rf,
            switch_coulomb=switched_rf,
            charge=term.charge, sigma=term.sigma, epsilon=term.epsilon,
            region_id=torch.as_tensor(region_id, device=term.charge.device),
            exception_index=term.exception_index,
            exception_chargeprod=term.exception_chargeprod,
            exception_sigma=term.exception_sigma,
            exception_epsilon=term.exception_epsilon,
            method=term.method, cutoff=term.cutoff, switch_width=switch_width,
            dielectric=term.dielectric, ewald_alpha=term.ewald_alpha,
            use_dispersion_correction=(
                term.use_dispersion_correction
                and not self.disable_alchemical_dispersion_correction),
            force_group=(1 if self.split_alchemical_forces else
                         term.force_group),
            lambda_sterics_names=tuple(
                f"lambda_sterics{suffix(r)}" for r in regions),
            lambda_electrostatics_names=tuple(
                f"lambda_electrostatics{suffix(r)}" for r in regions),
            annihilate_sterics=tuple(r.annihilate_sterics for r in regions),
            annihilate_electrostatics=tuple(
                r.annihilate_electrostatics for r in regions),
            region_interactions=interactions,
            softcore_alpha=reg0.softcore_alpha, softcore_a=reg0.softcore_a,
            softcore_b=reg0.softcore_b, softcore_c=reg0.softcore_c,
            softcore_beta=reg0.softcore_beta, softcore_d=reg0.softcore_d,
            softcore_e=reg0.softcore_e, softcore_f=reg0.softcore_f,
        )

    @staticmethod
    def _term_mask(index, region_id, regions, selector, like):
        """1.0 where a bonded term is alchemical (all its atoms in one
        region that asks for softening), in ``like``'s type and device."""
        idx = np.asarray(index.cpu())
        mask = np.zeros(idx.shape[0], dtype=np.float64)
        for ridx, reg in enumerate(regions):
            requested = selector(reg)
            if not requested:
                continue
            in_region = np.all(region_id[idx] == ridx, axis=1)
            if requested is True:
                mask[in_region] = 1.0
            else:  # an explicit list of term indices
                explicit = np.zeros(mask.shape, dtype=bool)
                explicit[np.asarray(list(requested), dtype=np.int64)] = True
                mask[explicit] = 1.0
        return _mask_like(mask, like)

    def _alchemical_bonds(self, term, region_id, regions, suffix):
        mask = self._term_mask(term.index, region_id, regions,
                               lambda r: r.alchemical_bonds, term.k)
        return AlchemicalHarmonicBondTerm(
            index=term.index, length=term.length, k=term.k, alchemical=mask,
            lambda_name=f"lambda_bonds{suffix(regions[0])}",
            force_group=term.force_group)

    def _alchemical_angles(self, term, region_id, regions, suffix):
        mask = self._term_mask(term.index, region_id, regions,
                               lambda r: r.alchemical_angles, term.k)
        return AlchemicalHarmonicAngleTerm(
            index=term.index, angle=term.angle, k=term.k, alchemical=mask,
            lambda_name=f"lambda_angles{suffix(regions[0])}",
            force_group=term.force_group)

    def _alchemical_torsions(self, term, region_id, regions, suffix):
        mask = self._term_mask(term.index, region_id, regions,
                               lambda r: r.alchemical_torsions, term.k)
        return AlchemicalPeriodicTorsionTerm(
            index=term.index, periodicity=term.periodicity, phase=term.phase,
            k=term.k, alchemical=mask,
            lambda_name=f"lambda_torsions{suffix(regions[0])}",
            force_group=term.force_group)

    # -- diagnostics --------------------------------------------------------
    @staticmethod
    def get_energy_components(system: System, x, box=None, params=None
                              ) -> Dict[str, Any]:
        """Per-term energy decomposition, keyed "<position>:<term type>"."""
        out = {}
        if box is None:
            box = system.default_box
        for i, term in enumerate(system.terms):
            out[f"{i}:{type(term).__name__}"] = term.energy(x, box, params)
        return out


def _mask_like(mask, like):
    """A 0/1 numpy mask as a tensor of ``like``'s type and device."""
    return torch.as_tensor(np.asarray(mask, dtype=np.float64),
                           dtype=like.dtype, device=like.device)
