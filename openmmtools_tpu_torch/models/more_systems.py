"""Test systems, batch 2 (counterpart of ``models/more_systems.py``): the
NaCl crystal, the diatomic and dipolar fluids, the constraint-coupled
oscillators, the LJ grid and mixture, the double-well dimer and chain in a
WCA bath, the GB system, and the molecular systems read from the
reference's Amber files (``models/amber.py``): host-guest, toluene,
lysozyme, alanine dipeptide in water, DHFR (JAC), the DNA dodecamer and
the methanol box.

Same parameters and the same host-side numpy construction as the JAX
package (positions match bit for bit), ending in float32 tensors on the
``device`` the caller names: the card unless the caller asks for the CPU.
A system whose data files are absent raises ``FileNotFoundError``.
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


# ---------------------------------------------------------------------------
# molecular systems from the reference's Amber data files (models/amber.py)
# ---------------------------------------------------------------------------


class _PrmtopSystem(TestSystem):
    """A system read from a prmtop and its inpcrd under ``_subdir`` of the
    data directory (``data_dir``, default ``amber.DEFAULT_DATA_DIR``):
    ``_nonbonded_method`` 'no_cutoff' (vacuum or GB implicit solvent) or a
    periodic one with ``cutoff``."""

    _subdir = None
    _prmtop = None
    _crd = None
    _implicit = False
    _gb_model = "OBC2"
    _nonbonded_method = "no_cutoff"

    def __init__(self, constraints="h-bonds", data_dir=None, device="cuda",
                 **options):
        super().__init__(device)
        from openmmtools_tpu_torch.models import amber

        prmtop = amber.data_file(data_dir, self._subdir, self._prmtop)
        crd = amber.data_file(data_dir, self._subdir, self._crd)
        if self._nonbonded_method != "no_cutoff":
            options["nonbonded_method"] = self._nonbonded_method
        amber.load_prmtop_system(
            self, prmtop, self._positions(crd), constraints=constraints,
            implicit_solvent=self._implicit, gb_model=self._gb_model,
            **options)

    @staticmethod
    def _positions(path):
        from openmmtools_tpu_torch.models.amber import parse_inpcrd

        return parse_inpcrd(path)


class _ExplicitPrmtopSystem(_PrmtopSystem):
    """A periodic prmtop system with PME at ``cutoff`` (nm)."""

    _nonbonded_method = "pme"

    def __init__(self, constraints="h-bonds", cutoff=0.9, data_dir=None,
                 device="cuda"):
        super().__init__(constraints=constraints, data_dir=data_dir,
                         device=device, cutoff=cutoff)


class HostGuestVacuum(_PrmtopSystem):
    """CB7:B2 host-guest complex in vacuum (``cb7-b2/complex-vacuum.*``)."""

    _subdir = "cb7-b2"
    _prmtop = "complex-vacuum.prmtop"
    _crd = "complex-vacuum.inpcrd"


class HostGuestImplicit(_PrmtopSystem):
    """CB7:B2 with GB implicit solvent; ``gb_model`` 'HCT', 'OBC1' or
    'OBC2'. The default stays OBC2, as in the JAX package (the reference's
    own default is OBC1: HostGuestImplicitOBC1)."""

    _subdir = HostGuestVacuum._subdir
    _prmtop = HostGuestVacuum._prmtop
    _crd = HostGuestVacuum._crd
    _implicit = True

    def __init__(self, gb_model="OBC2", **kwargs):
        self._gb_model = gb_model
        super().__init__(**kwargs)


class HostGuestImplicitHCT(HostGuestImplicit):
    def __init__(self, **kwargs):
        super().__init__(gb_model="HCT", **kwargs)


class HostGuestImplicitOBC1(HostGuestImplicit):
    def __init__(self, **kwargs):
        super().__init__(gb_model="OBC1", **kwargs)


class HostGuestImplicitOBC2(HostGuestImplicit):
    def __init__(self, **kwargs):
        super().__init__(gb_model="OBC2", **kwargs)


class LysozymeImplicit(_PrmtopSystem):
    """T4 lysozyme L99A + p-xylene, GBSA implicit solvent, 2,603 atoms
    (``T4-lysozyme-L99A-implicit/complex.*``)."""

    _subdir = "T4-lysozyme-L99A-implicit"
    _prmtop = "complex.prmtop"
    _crd = "complex.crd"
    _implicit = True


class BenzeneTolueneImplicit(_PrmtopSystem):
    """Benzene + toluene in GBSA implicit solvent
    (``benzene-toluene-implicit/complex.*``)."""

    _subdir = "benzene-toluene-implicit"
    _prmtop = "complex.prmtop"
    _crd = "complex.inpcrd"
    _implicit = True


class MolecularIdealGas(TestSystem):
    """Alanine dipeptide with every interaction removed but its harmonic
    bonds and angles, and no constraints: a molecular ideal gas."""

    def __init__(self, data_dir=None, device="cuda"):
        super().__init__(device)
        from openmmtools_tpu_torch.models.testsystems import (
            AlanineDipeptideVacuum,
        )

        base = AlanineDipeptideVacuum(constraints=None, data_dir=data_dir,
                                      device=device)
        kept = tuple(t for t in base.system.terms
                     if type(t).__name__ in ("HarmonicBondTerm",
                                             "HarmonicAngleTerm"))
        self.system = base.system.replace(terms=kept)
        self.positions = base.positions
        self.ndof = 3 * self.system.n_particles


class AlanineDipeptideExplicit(_ExplicitPrmtopSystem):
    """Alanine dipeptide in explicit TIP3P water, PME, 2,269 atoms
    (``alanine-dipeptide-explicit/*``)."""

    _subdir = "alanine-dipeptide-explicit"
    _prmtop = "alanine-dipeptide.prmtop"
    _crd = "alanine-dipeptide.crd"


class DHFRExplicit(_ExplicitPrmtopSystem):
    """DHFR in explicit TIP3P water, the Joint Amber-CHARMM benchmark
    system, 23,558 atoms (``dhfr/``). Positions come from ``system.pdb``
    (``JAC.inpcrd`` is a binary NetCDF restart).

    The defaults follow the JAC benchmark's convention, as in the JAX
    package: a 0.9 nm hard cutoff and an Ewald tolerance of 5e-4. The
    reference test system's are a 1.0 nm cutoff, a 0.15 nm switch and
    1e-5: pass ``cutoff=1.0, switch_width=0.15,
    ewald_error_tolerance=1e-5`` for them (``benchmark_dhfr
    --reference-defaults``)."""

    _subdir = "dhfr"
    _prmtop = "JAC.prmtop"
    _crd = "system.pdb"

    def __init__(self, constraints="h-bonds", cutoff=0.9, data_dir=None,
                 switch_width=None, ewald_error_tolerance=5e-4,
                 device="cuda"):
        _PrmtopSystem.__init__(
            self, constraints=constraints, data_dir=data_dir, device=device,
            cutoff=cutoff, switch_width=switch_width,
            ewald_error_tolerance=ewald_error_tolerance)

    @staticmethod
    def _positions(path):
        from openmmtools_tpu_torch.models.amber import parse_pdb_positions

        return parse_pdb_positions(path)


class HostGuestExplicit(_ExplicitPrmtopSystem):
    """CB7:B2 complex in explicit water, PME (``cb7-b2/complex-explicit.*``)."""

    _subdir = "cb7-b2"
    _prmtop = "complex-explicit.prmtop"
    _crd = "complex-explicit.inpcrd"


class TolueneVacuum(_PrmtopSystem):
    """Toluene (GAFF/AM1-BCC) in vacuum
    (``benzene-toluene-implicit/solvent.*``)."""

    _subdir = "benzene-toluene-implicit"
    _prmtop = "solvent.prmtop"
    _crd = "solvent.inpcrd"


class TolueneImplicit(_PrmtopSystem):
    """Toluene in GB implicit solvent; ``gb_model`` 'HCT', 'OBC1' or
    'OBC2'."""

    _subdir = TolueneVacuum._subdir
    _prmtop = TolueneVacuum._prmtop
    _crd = TolueneVacuum._crd
    _implicit = True

    def __init__(self, gb_model="OBC2", **kwargs):
        self._gb_model = gb_model
        super().__init__(**kwargs)


class TolueneImplicitHCT(TolueneImplicit):
    def __init__(self, **kwargs):
        super().__init__(gb_model="HCT", **kwargs)


class TolueneImplicitOBC1(TolueneImplicit):
    def __init__(self, **kwargs):
        super().__init__(gb_model="OBC1", **kwargs)


class TolueneImplicitOBC2(TolueneImplicit):
    def __init__(self, **kwargs):
        super().__init__(gb_model="OBC2", **kwargs)


class MethanolBox(TestSystem):
    """A box of methanol molecules with periodic cutoff electrostatics
    (``methanol-box/``); the cutoff is 0.9 nm or 0.49 of the inpcrd box's
    shortest edge, whichever is less (the box is about 1.4 nm)."""

    def __init__(self, constraints="h-bonds",
                 nonbonded_method="cutoff_periodic", data_dir=None,
                 device="cuda"):
        super().__init__(device)
        from openmmtools_tpu_torch.models import amber

        prmtop = amber.data_file(data_dir, "methanol-box",
                                 "methanol-box.prmtop")
        positions, box = amber.parse_inpcrd(
            amber.data_file(data_dir, "methanol-box", "methanol-box.crd"),
            return_box=True)
        amber.load_prmtop_system(
            self, prmtop, positions, constraints=constraints,
            nonbonded_method=nonbonded_method,
            cutoff=min(0.9, 0.49 * float(np.min(box))))


class DNADodecamerExplicit(_ExplicitPrmtopSystem):
    """The Drew-Dickerson B-DNA dodecamer in explicit solvent, PME, 13,646
    atoms (``dna_dodecamer_explicit/``)."""

    _subdir = "dna_dodecamer_explicit"
    _prmtop = "prmtop"
    _crd = "inpcrd"
