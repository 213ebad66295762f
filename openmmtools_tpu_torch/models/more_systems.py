"""Test systems, batch 2 (counterpart of ``models/more_systems.py``): the
NaCl crystal, the diatomic and dipolar fluids, the constraint-coupled
oscillators, the LJ grid and mixture, the double-well dimer and chain in a
WCA bath, and the GB system.

Same parameters and the same host-side numpy construction as the JAX
package (positions match bit for bit), ending in float32 tensors on the
``device`` the caller names: the card unless the caller asks for the CPU.
The systems that read Amber files (``_PrmtopSystem`` and its subclasses,
``MolecularIdealGas``, ``AlanineDipeptideExplicit``, ``DHFRExplicit``,
``MethanolBox``, ``DNADodecamerExplicit``) come with the port of
``models/amber.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from openmmtools_tpu_torch.constants import kB
from openmmtools_tpu_torch.models.testsystems import (
    KCAL,
    A,
    LennardJonesFluid,
    TestSystem,
    WCAFluid,
    _f32,
    _tensor,
    subrandom_particle_positions,
)
from openmmtools_tpu_torch.ops.geometry import safe_norm
from openmmtools_tpu_torch.ops.gbsa import GBSAOBCTerm
from openmmtools_tpu_torch.ops.pme import ewald_alpha, make_ewald_reciprocal_term
from openmmtools_tpu_torch.system import (
    Constraints,
    CustomExternalTerm,
    HarmonicBondTerm,
    NonbondedTerm,
    System,
    no_constraints,
)
from openmmtools_tpu_torch.utils.pytree import static_field, tensor_dataclass


def _no_exceptions(device):
    return dict(
        exception_index=_tensor(np.zeros((0, 2), np.int32), device),
        exception_chargeprod=_tensor(_f32([]), device),
        exception_sigma=_tensor(_f32([]), device),
        exception_epsilon=_tensor(_f32([]), device))


class SodiumChlorideCrystal(TestSystem):
    """One NaCl pair in a periodic Ewald lattice: sigma_Na = 3.330445 Å,
    sigma_Cl = 4.41724 Å, eps_Na = 0.002772, eps_Cl = 0.118 kcal/mol, box
    5.628 Å, Cl at (a/2, a/2, a/2)."""

    def __init__(self, switch_width=0.2 * A, dispersion_correction=True,
                 device="cuda"):
        super().__init__(device)
        box_edge = 5.628 * A
        cutoff = box_edge / 2.0 * 0.99
        charges = np.asarray([1.0, -1.0])
        nb = NonbondedTerm(
            charge=_tensor(_f32(charges), device),
            sigma=_tensor(_f32([3.330445 * A, 4.41724 * A]), device),
            epsilon=_tensor(_f32([0.002772 * KCAL, 0.118 * KCAL]), device),
            **_no_exceptions(device),
            method="ewald", cutoff=cutoff, switch_width=switch_width,
            use_dispersion_correction=dispersion_correction,
            ewald_alpha=float(ewald_alpha(cutoff)))
        rec = make_ewald_reciprocal_term(charges, box_edge, cutoff,
                                         np.zeros((0, 2), np.int64),
                                         device=device)
        self.system = System(
            masses=_tensor(_f32([22.990, 35.453]), device), terms=(nb, rec),
            constraints=no_constraints(device),
            default_box=_tensor(np.diag(_f32([box_edge] * 3)), device),
            periodic=True)
        positions = np.zeros((2, 3), dtype=np.float32)
        positions[1] = 2.814 * A
        self.positions = _tensor(positions, device)


class DiatomicFluid(TestSystem):
    """Periodic fluid of diatomic molecules. Defaults: 250 molecules,
    K = 424 kcal/mol/Å^2, r0 = 1.383 Å, eps = 0.17 kcal/mol, sigma =
    1.824 Å, charge 0 (the dipolar fluids set +-q); ``constraint=True``
    replaces the bond with a distance constraint."""

    def __init__(self, nmolecules=250, K=424.0 * KCAL / A**2, r0=1.383 * A,
                 mass=14.0, epsilon=0.1700 * KCAL, sigma=1.8240 * A,
                 charge=0.0, cutoff=None, constraint=False,
                 dispersion_correction=True, device="cuda"):
        super().__init__(device)
        n = 2 * nmolecules
        number_density = 0.25 / (sigma**3)
        length = (n / number_density) ** (1.0 / 3.0)
        if cutoff is None:
            cutoff = min(3.0 * sigma, 0.49 * length)
        box = np.diag(_f32([length] * 3))

        pair_idx = np.asarray(np.arange(nmolecules)[:, None] * 2
                              + np.array([0, 1]), np.int32)
        nb = NonbondedTerm(
            charge=_tensor(_f32(np.tile([charge, -charge], nmolecules)),
                           device),
            sigma=_tensor(_f32(np.full(n, sigma)), device),
            epsilon=_tensor(_f32(np.full(n, epsilon)), device),
            exception_index=_tensor(pair_idx, device),
            exception_chargeprod=_tensor(_f32(np.zeros(nmolecules)), device),
            exception_sigma=_tensor(_f32(np.full(nmolecules, sigma)), device),
            exception_epsilon=_tensor(_f32(np.zeros(nmolecules)), device),
            method="cutoff_periodic", cutoff=cutoff,
            use_dispersion_correction=dispersion_correction)
        terms = [nb]
        if constraint:
            constraints = Constraints(
                index=_tensor(pair_idx, device),
                distance=_tensor(_f32(np.full(nmolecules, r0)), device))
        else:
            constraints = no_constraints(device)
            terms.append(HarmonicBondTerm(
                index=_tensor(pair_idx, device),
                length=_tensor(_f32(np.full(nmolecules, r0)), device),
                k=_tensor(_f32(np.full(nmolecules, K)), device)))

        # molecule centres subrandom, orientations random
        centers = subrandom_particle_positions(nmolecules, box)
        axes = np.random.default_rng(0).normal(size=(nmolecules, 3))
        axes /= np.linalg.norm(axes, axis=1, keepdims=True)
        positions = np.zeros((n, 3))
        positions[0::2] = centers + 0.5 * r0 * axes
        positions[1::2] = centers - 0.5 * r0 * axes
        self.system = System(
            masses=_tensor(_f32(np.full(n, mass)), device),
            terms=tuple(terms), constraints=constraints,
            default_box=_tensor(box, device), periodic=True)
        self.positions = _tensor(_f32(positions), device)
        self.nmolecules = nmolecules


class UnconstrainedDiatomicFluid(DiatomicFluid):
    """The diatomic fluid with harmonic bonds."""

    def __init__(self, *args, **kwargs):
        kwargs["constraint"] = False
        super().__init__(*args, **kwargs)


class ConstrainedDiatomicFluid(DiatomicFluid):
    """The diatomic fluid with rigid bonds."""

    def __init__(self, *args, **kwargs):
        kwargs["constraint"] = True
        super().__init__(*args, **kwargs)


class DipolarFluid(DiatomicFluid):
    """The diatomic fluid with +-q partial charges (q = 0.25 e)."""

    def __init__(self, charge=0.25, **kwargs):
        super().__init__(charge=charge, **kwargs)


class UnconstrainedDipolarFluid(DipolarFluid):
    def __init__(self, *args, **kwargs):
        kwargs["constraint"] = False
        super().__init__(*args, **kwargs)


class ConstrainedDipolarFluid(DipolarFluid):
    def __init__(self, *args, **kwargs):
        kwargs["constraint"] = True
        super().__init__(*args, **kwargs)


class ConstraintCoupledHarmonicOscillator(TestSystem):
    """Two particles in harmonic wells, rigidly constrained together.
    Defaults K = 1 kJ/mol/nm^2, d = 1 nm, mass = 39.948 amu."""

    def __init__(self, K=1.0, d=1.0, mass=39.948, device="cuda"):
        super().__init__(device)
        self.K, self.d, self.mass = K, d, mass
        well = CustomExternalTerm(
            particles=_tensor(np.asarray([0], np.int32), device),
            global_defaults={"K_ccho": _tensor(_f32(K), device)},
            expression="(K_ccho/2.0)*(x**2+y**2+z**2)")
        well2 = CustomExternalTerm(
            particles=_tensor(np.asarray([1], np.int32), device),
            global_defaults={"K_ccho2": _tensor(_f32(K), device),
                             "d_ccho": _tensor(_f32(d), device)},
            expression="(K_ccho2/2.0)*((x-d_ccho)**2+y**2+z**2)")
        constraints = Constraints(
            index=_tensor(np.asarray([[0, 1]], np.int32), device),
            distance=_tensor(_f32([d]), device))
        self.system = System(
            masses=_tensor(_f32([mass, mass]), device), terms=(well, well2),
            constraints=constraints, default_box=None, periodic=False)
        positions = np.zeros((2, 3), dtype=np.float32)
        positions[1, 0] = d
        self.positions = _tensor(positions, device)
        self.ndof = 6 - 1


class LennardJonesGrid(LennardJonesFluid):
    """LJ fluid started on an (nx, ny, nz) grid at reduced density 0.86."""

    def __init__(self, nx=8, ny=8, nz=8, reduced_density=0.86, **kwargs):
        super().__init__(nparticles=nx * ny * nz,
                         reduced_density=reduced_density, **kwargs)
        grid = np.stack(np.meshgrid(np.arange(nx), np.arange(ny),
                                    np.arange(nz), indexing="ij"),
                        axis=-1).reshape(-1, 3).astype(np.float64)
        scale = self.box_edge / np.array([nx, ny, nz])
        self.positions = _tensor(_f32((grid + 0.5) * scale), self.device)


class CustomLennardJonesFluidMixture(LennardJonesFluid):
    """Two-component LJ fluid: the first ``fraction`` of the particles take
    ``epsilon_scale`` times the epsilon."""

    def __init__(self, nparticles=1000, fraction=0.5, epsilon_scale=1.0,
                 **kwargs):
        super().__init__(nparticles=nparticles, **kwargs)
        n_b = int(nparticles * fraction)
        nb = self.system.terms[0]
        eps = nb.epsilon.cpu().numpy().copy()
        eps[:n_b] *= epsilon_scale
        self.system = self.system.replace_term(
            0, nb.replace(epsilon=_tensor(_f32(eps), self.device)))


@tensor_dataclass
class DoubleWellBondTerm:
    """U = h (1 - ((r - r0 - w)/w)^2)^2 per bond."""

    index: torch.Tensor       # (B, 2)
    h: torch.Tensor
    r0: torch.Tensor
    w: torch.Tensor
    force_group: int = static_field(default=0)

    def energy(self, x, box, params=None):
        if self.index.shape[0] == 0:
            return torch.zeros((), dtype=x.dtype, device=x.device)
        idx = self.index.long()
        r = safe_norm(x[idx[:, 0]] - x[idx[:, 1]])
        t = (r - self.r0 - self.w) / self.w
        return torch.sum(self.h * (1.0 - t * t) ** 2)


class DoubleWellDimer_WCAFluid(WCAFluid):
    """``ndimers`` double-well bonded pairs in a WCA bath. Defaults:
    h = 6 * 0.824 * 120 K * kB, r0 = 2^(1/6) sigma, w = 0.3 sigma."""

    def __init__(self, ndimers=1, nparticles=216, density=0.96, mass=39.9,
                 epsilon=120.0 * kB, sigma=3.4 * A, h=None, r0=None, w=None,
                 device="cuda"):
        super().__init__(nparticles=nparticles, density=density, mass=mass,
                         epsilon=epsilon, sigma=sigma, device=device)
        if not 0 <= ndimers <= self._max_bonds(nparticles):
            raise ValueError(f"cannot create {ndimers} bonds with "
                             f"{nparticles} particles")
        h = 6.0 * 0.824 * 120.0 * kB if h is None else h
        r0 = 2.0 ** (1.0 / 6.0) * sigma if r0 is None else r0
        w = 0.3 * sigma if w is None else w
        self.ndimers = ndimers
        idx = self._bond_indices(ndimers)
        if ndimers:
            m = len(idx)
            term = DoubleWellBondTerm(
                index=_tensor(np.asarray(idx, np.int32), device),
                h=_tensor(_f32(np.full(m, h)), device),
                r0=_tensor(_f32(np.full(m, r0)), device),
                w=_tensor(_f32(np.full(m, w)), device))
            self.system = self.system.replace(
                terms=self.system.terms + (term,))
            # bonded partners start next to each other
            x = self.positions.cpu().numpy().copy()
            for a, b in idx:
                x[b] = x[a] + np.array([r0, 0.0, 0.0])
            self.positions = _tensor(x, device)

    @staticmethod
    def _bond_indices(ndimers):
        return [(2 * i, 2 * i + 1) for i in range(ndimers)]

    @staticmethod
    def _max_bonds(nparticles):
        return nparticles // 2


class DoubleWellChain_WCAFluid(DoubleWellDimer_WCAFluid):
    """A chain of ``nchained`` particles bonded consecutively by double
    wells, in a WCA bath. ``nchained = 0`` means the same as 1 (a bare WCA
    fluid); a chain may span all ``nparticles`` (up to nparticles - 1
    bonds, where the dimer fluid allows nparticles // 2); a negative
    ``nchained`` raises ValueError."""

    def __init__(self, nchained=3, nparticles=216, **kwargs):
        self.nchained = nchained
        nchained = 1 if nchained == 0 else nchained
        super().__init__(ndimers=nchained - 1, nparticles=nparticles,
                         **kwargs)

    @staticmethod
    def _bond_indices(nbonds):
        return [(i, i + 1) for i in range(nbonds)]

    @staticmethod
    def _max_bonds(nparticles):
        return nparticles - 1


class CustomGBForceSystem(TestSystem):
    """140 charged LJ particles with an OBC-II generalized Born term
    (:class:`~openmmtools_tpu_torch.ops.gbsa.GBSAOBCTerm`). Radii 0.2/0.1
    nm, screening 0.5 (first half of the molecules) / 0.8 (second half),
    solvent dielectric 80, a periodic 10 nm box and a 2 nm cutoff for the
    nonbonded term; the GB term sees raw displacements (no minimum image,
    no cutoff), as in the JAX package."""

    def __init__(self, n_molecules=70, box_size=10.0, cutoff=2.0,
                 device="cuda"):
        super().__init__(device)
        n = 2 * n_molecules
        charges = np.tile([1.0, -1.0], n_molecules)
        radii = np.tile([0.2, 0.1], n_molecules)
        half = n_molecules // 2
        scales = np.repeat(np.where(np.arange(n_molecules) < half, 0.5, 0.8),
                           2)
        sigma, epsilon, mass = 0.335, 0.001603, 39.9
        nb = NonbondedTerm(
            charge=_tensor(_f32(charges), device),
            sigma=_tensor(_f32(np.full(n, sigma)), device),
            epsilon=_tensor(_f32(np.full(n, epsilon)), device),
            **_no_exceptions(device),
            method="cutoff_periodic", cutoff=cutoff)
        gb = GBSAOBCTerm(charge=_tensor(_f32(charges), device),
                         radius=_tensor(_f32(radii), device),
                         scale=_tensor(_f32(scales), device),
                         solvent_dielectric=80.0)
        box = np.diag(_f32([box_size] * 3))
        self.system = System(
            masses=_tensor(_f32(np.full(n, mass)), device), terms=(nb, gb),
            constraints=no_constraints(device),
            default_box=_tensor(box, device), periodic=True)
        self.positions = _tensor(
            _f32(subrandom_particle_positions(n, box)), device)
