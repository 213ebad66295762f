"""Water box test systems (counterpart of ``models/water.py``):
TIP3P/SPC-E/TIP4P-EW/TIP5P, rigid or flexible, PME/Ewald/reaction field.

The box is built directly, as in the JAX package: water molecules on a
cubic lattice at liquid density with random orientations (the same numpy
draws, so positions match bit for bit), parameters of the standard public
models:

  TIP3P: qO = -0.834 e, qH = +0.417 e, sigma_O = 0.31507 nm,
         eps_O = 0.635968 kJ/mol, rOH = 0.09572 nm, HOH = 104.52 deg
  SPC/E: qO = -0.8476, qH = +0.4238, sigma_O = 0.316557, eps_O = 0.650194,
         rOH = 0.1, HOH = 109.47 deg

Rigid water = 3 distance constraints per molecule (OH, OH, HH), which the
integrators hand to SETTLE. Intramolecular nonbonded pairs are excluded.
``AlchemicalWaterBox`` makes the first molecule alchemical with the
factory's defaults.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from openmmtools_tpu_torch.models.testsystems import TestSystem, _f32, _tensor
from openmmtools_tpu_torch.ops.pme import (
    DEFAULT_EWALD_ERROR_TOLERANCE,
    EwaldReciprocalTerm,
    ewald_alpha,
    make_ewald_reciprocal_term,
)
from openmmtools_tpu_torch.system import (
    Constraints,
    HarmonicAngleTerm,
    HarmonicBondTerm,
    NonbondedTerm,
    System,
    VirtualSites,
    no_constraints,
)

DEFAULT_CUTOFF_DISTANCE = 1.0     # nm (openmmtools' default)
DEFAULT_SWITCH_WIDTH = 0.15       # nm

_MODELS = {
    "tip3p": dict(qO=-0.834, qH=0.417, sigma=0.31507, epsilon=0.635968,
                  rOH=0.09572, aHOH=math.radians(104.52)),
    "spce": dict(qO=-0.8476, qH=0.4238, sigma=0.316557, epsilon=0.650194,
                 rOH=0.1, aHOH=math.radians(109.47)),
    # 4-site: charge lives on the virtual M site on the HOH bisector
    "tip4pew": dict(qO=0.0, qH=0.52422, qM=-1.04844, sigma=0.316435,
                    epsilon=0.680946, rOH=0.09572,
                    aHOH=math.radians(104.52), dOM=0.0125),
    # 5-site (Mahoney & Jorgensen 2000): two out-of-plane lone-pair sites
    "tip5p": dict(qO=0.0, qH=0.241, qL=-0.241, sigma=0.312,
                  epsilon=0.66944, rOH=0.09572,
                  aHOH=math.radians(104.52), rOL=0.070,
                  aLOL=math.radians(109.47)),
}

WATER_NUMBER_DENSITY = 33.0  # molecules / nm^3 (~0.987 g/cm^3)


def _water_geometry(rOH, aHOH):
    """O at origin; H positions in the xz plane."""
    h1 = np.array([rOH * math.sin(aHOH / 2), 0.0, rOH * math.cos(aHOH / 2)])
    h2 = np.array([-rOH * math.sin(aHOH / 2), 0.0, rOH * math.cos(aHOH / 2)])
    return np.stack([np.zeros(3), h1, h2])


def _random_rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


class WaterBox(TestSystem):
    """Cubic box of rigid (or flexible) water (openmmtools ``WaterBox``).

    Parameters: box_edge (nm), cutoff, model ('tip3p' | 'spce' | 'tip4pew' |
    'tip5p'), switch_width, constrained, dispersion_correction,
    nonbonded_method ('pme' | 'ewald' | 'cutoff_periodic'),
    ewald_error_tolerance, seed, device.
    """

    def __init__(self, box_edge=2.5, cutoff=DEFAULT_CUTOFF_DISTANCE,
                 model="tip3p", switch_width=DEFAULT_SWITCH_WIDTH,
                 constrained=True, dispersion_correction=True,
                 nonbonded_method="pme",
                 ewald_error_tolerance=DEFAULT_EWALD_ERROR_TOLERANCE,
                 seed=0, device="cuda"):
        super().__init__(device)
        if model not in _MODELS:
            raise ValueError(f"unsupported water model {model!r}; "
                             f"available: {sorted(_MODELS)}")
        if box_edge <= 2 * cutoff:
            raise ValueError("box_edge should exceed 2*cutoff")
        p = _MODELS[model]
        self.model = model
        self.constrained = constrained
        four_site = "qM" in p
        five_site = "qL" in p
        spm = 5 if five_site else (4 if four_site else 3)  # sites/molecule

        # --- lattice placement at liquid density ---------------------------
        n_target = int(WATER_NUMBER_DENSITY * box_edge**3)
        n_side = int(round(n_target ** (1.0 / 3.0)))
        n_waters = n_side**3
        spacing = box_edge / n_side
        rng = np.random.default_rng(seed)
        geom = _water_geometry(p["rOH"], p["aHOH"])
        if four_site:
            # virtual M site on the bisector; VirtualSites.reconstruct
            # recomputes its exact placement at every evaluation
            bis = 0.5 * (geom[1] + geom[2])
            m_site = geom[0] + p["dOM"] * bis / np.linalg.norm(bis)
            geom = np.concatenate([geom, m_site[None]], axis=0)
        elif five_site:
            # lone pairs in the plane perpendicular to HOH, behind the O
            sl = p["rOL"] * math.sin(p["aLOL"] / 2.0)
            cl = p["rOL"] * math.cos(p["aLOL"] / 2.0)
            l_sites = np.array([[0.0, sl, -cl], [0.0, -sl, -cl]])
            geom = np.concatenate([geom, l_sites], axis=0)
        positions = np.zeros((n_waters * spm, 3))
        w = 0
        for ix in range(n_side):
            for iy in range(n_side):
                for iz in range(n_side):
                    center = (np.array([ix, iy, iz]) + 0.5) * spacing
                    R = _random_rotation(rng)
                    positions[spm * w: spm * w + spm] = geom @ R.T + center
                    w += 1
        self.n_waters = n_waters
        n_atoms = spm * n_waters

        # --- parameters ------------------------------------------------------
        if five_site:
            charges = np.tile([p["qO"], p["qH"], p["qH"],
                               p["qL"], p["qL"]], n_waters)
            sigmas = np.tile([p["sigma"], 0.1, 0.1, 0.1, 0.1], n_waters)
            epsilons = np.tile([p["epsilon"], 0.0, 0.0, 0.0, 0.0], n_waters)
            masses = np.tile([15.99943, 1.007947, 1.007947, 0.0, 0.0],
                             n_waters)
        elif four_site:
            charges = np.tile([p["qO"], p["qH"], p["qH"], p["qM"]], n_waters)
            sigmas = np.tile([p["sigma"], 0.1, 0.1, 0.1], n_waters)
            epsilons = np.tile([p["epsilon"], 0.0, 0.0, 0.0], n_waters)
            masses = np.tile([15.99943, 1.007947, 1.007947, 0.0], n_waters)
        else:
            charges = np.tile([p["qO"], p["qH"], p["qH"]], n_waters)
            sigmas = np.tile([p["sigma"], 0.1, 0.1], n_waters)  # H: no LJ
            epsilons = np.tile([p["epsilon"], 0.0, 0.0], n_waters)
            masses = np.tile([15.99943, 1.007947, 1.007947], n_waters)

        # intramolecular exclusions: all site pairs within a molecule
        base = np.arange(n_waters)[:, None] * spm
        pair_offsets = [(i, j) for i in range(spm) for j in range(i + 1, spm)]
        excl = np.concatenate([base + np.array(po) for po in pair_offsets],
                              axis=0)
        e_count = excl.shape[0]

        def t(values, dtype=np.float32):
            return _tensor(np.asarray(values, dtype=dtype), device)

        alpha = None
        if nonbonded_method in ("pme", "ewald"):
            alpha = ewald_alpha(cutoff, ewald_error_tolerance)
        nb = NonbondedTerm(
            charge=t(charges), sigma=t(sigmas), epsilon=t(epsilons),
            exception_index=t(excl, np.int32),
            exception_chargeprod=t(np.zeros(e_count)),
            exception_sigma=t(np.full(e_count, 0.1)),
            exception_epsilon=t(np.zeros(e_count)),
            method=nonbonded_method, cutoff=cutoff,
            switch_width=switch_width,
            use_dispersion_correction=dispersion_correction,
            ewald_alpha=alpha)
        terms = [nb]
        if nonbonded_method in ("pme", "ewald"):
            terms.append(make_ewald_reciprocal_term(
                charges, box_edge, cutoff, excl, tol=ewald_error_tolerance,
                device=device))

        # --- geometry terms ---------------------------------------------------
        rHH = 2.0 * p["rOH"] * math.sin(p["aHOH"] / 2)
        if constrained:
            c_idx = np.concatenate([
                base + np.array([0, 1]),
                base + np.array([0, 2]),
                base + np.array([1, 2]),
            ], axis=0)
            c_dist = np.concatenate([
                np.full(n_waters, p["rOH"]),
                np.full(n_waters, p["rOH"]),
                np.full(n_waters, rHH),
            ])
            constraints = Constraints(index=t(c_idx, np.int32),
                                      distance=t(c_dist))
        else:
            constraints = no_constraints(device)
            bond_idx = np.concatenate(
                [base + np.array([0, 1]), base + np.array([0, 2])], axis=0)
            terms.append(HarmonicBondTerm(
                index=t(bond_idx, np.int32),
                length=t(np.full(2 * n_waters, p["rOH"])),
                k=t(np.full(2 * n_waters, 462750.4))))
            ang_idx = base + np.array([1, 0, 2])
            terms.append(HarmonicAngleTerm(
                index=t(ang_idx, np.int32),
                angle=t(np.full(n_waters, p["aHOH"])),
                k=t(np.full(n_waters, 836.8))))

        vsites = None
        if four_site:
            # M = O + w (H1 - O) + w (H2 - O): 3-particle average with
            # weights (1 - 2w, w, w); w = dOM / (2 rOH cos(HOH/2))
            wgt = p["dOM"] / (2.0 * p["rOH"] * math.cos(p["aHOH"] / 2.0))
            vsites = VirtualSites(
                site=t(base[:, 0] + 3, np.int32),
                parents=t(np.stack([base[:, 0], base[:, 0] + 1,
                                    base[:, 0] + 2], axis=1), np.int32),
                weights=t(np.tile([1.0 - 2.0 * wgt, wgt, wgt],
                                  (n_waters, 1))),
                wcross=t(np.zeros(n_waters)))
        elif five_site:
            # OutOfPlane form x_L = sum w_i x_i + wcross (r12 x r13).
            # With H1 = (s,0,d), H2 = (-s,0,d) in O's frame
            # (s = rOH sin(aHOH/2), d = rOH cos(aHOH/2)) and the L targets
            # (0, +-rOL sin(aLOL/2), -rOL cos(aLOL/2)):
            #   z: 2 w d = -rOL cos(aLOL/2)           -> w
            #   y: wcross (-2 s d) = +-rOL sin(aLOL/2) -> -+wcross
            s = p["rOH"] * math.sin(p["aHOH"] / 2.0)
            d = p["rOH"] * math.cos(p["aHOH"] / 2.0)
            w = -p["rOL"] * math.cos(p["aLOL"] / 2.0) / (2.0 * d)
            wc = p["rOL"] * math.sin(p["aLOL"] / 2.0) / (2.0 * s * d)
            o = base[:, 0]
            parents1 = np.stack([o, o + 1, o + 2], axis=1)
            vsites = VirtualSites(
                site=t(np.concatenate([o + 3, o + 4]), np.int32),
                parents=t(np.concatenate([parents1, parents1], axis=0),
                          np.int32),
                weights=t(np.tile([1.0 - 2.0 * w, w, w], (2 * n_waters, 1))),
                wcross=t(np.concatenate([np.full(n_waters, -wc),
                                         np.full(n_waters, wc)])))
        box = np.diag(_f32([box_edge, box_edge, box_edge]))
        self.system = System(
            masses=t(masses), terms=tuple(terms), constraints=constraints,
            default_box=t(box), virtual_sites=vsites, periodic=True)
        self.positions = t(positions)
        self.ndof = 3 * n_atoms - constraints.n_constraints if constrained \
            else 3 * n_atoms


class FlexibleWaterBox(WaterBox):
    """Flexible (unconstrained) variant."""

    def __init__(self, *args, **kwargs):
        kwargs["constrained"] = False
        super().__init__(*args, **kwargs)


class WaterCluster(TestSystem):
    """Non-periodic cluster of N rigid waters."""

    def __init__(self, n_waters=20, model="tip3p", constrained=True, seed=0,
                 device="cuda"):
        super().__init__(device)
        p = _MODELS[model]
        rng = np.random.default_rng(seed)
        geom = _water_geometry(p["rOH"], p["aHOH"])
        # place on a compact spherical-ish grid
        spacing = 0.31
        n_side = int(math.ceil(n_waters ** (1 / 3)))
        centers = []
        for ix in range(n_side):
            for iy in range(n_side):
                for iz in range(n_side):
                    centers.append(np.array([ix, iy, iz]) * spacing)
        centers = np.asarray(centers[:n_waters])
        positions = np.zeros((n_waters * 3, 3))
        for w in range(n_waters):
            R = _random_rotation(rng)
            positions[3 * w: 3 * w + 3] = geom @ R.T + centers[w]

        def t(values, dtype=np.float32):
            return _tensor(np.asarray(values, dtype=dtype), device)

        charges = np.tile([p["qO"], p["qH"], p["qH"]], n_waters)
        sigmas = np.tile([p["sigma"], 0.1, 0.1], n_waters)
        epsilons = np.tile([p["epsilon"], 0.0, 0.0], n_waters)
        masses = np.tile([15.99943, 1.007947, 1.007947], n_waters)
        base = np.arange(n_waters)[:, None] * 3
        excl = np.concatenate([base + np.array([0, 1]),
                               base + np.array([0, 2]),
                               base + np.array([1, 2])], axis=0)
        nb = NonbondedTerm(
            charge=t(charges), sigma=t(sigmas), epsilon=t(epsilons),
            exception_index=t(excl, np.int32),
            exception_chargeprod=t(np.zeros(excl.shape[0])),
            exception_sigma=t(np.full(excl.shape[0], 0.1)),
            exception_epsilon=t(np.zeros(excl.shape[0])),
            method="no_cutoff")
        rHH = 2.0 * p["rOH"] * math.sin(p["aHOH"] / 2)
        if constrained:
            c_dist = np.concatenate([np.full(n_waters, p["rOH"]),
                                     np.full(n_waters, p["rOH"]),
                                     np.full(n_waters, rHH)])
            constraints = Constraints(index=t(excl, np.int32),
                                      distance=t(c_dist))
        else:
            constraints = no_constraints(device)
        self.system = System(masses=t(masses), terms=(nb,),
                             constraints=constraints, default_box=None,
                             periodic=False)
        self.positions = t(positions)


# ---------------------------------------------------------------------------
# Named water-box variants: thin subclasses configuring WaterBox, plus
# discharged boxes rebuilt with zeroed charges (systems are immutable, so
# "mutation" constructs a new term tuple).
# ---------------------------------------------------------------------------


def _discharged_system(system, h_lj=False):
    """New System with all charges (and exception charge products) zeroed.
    The Ewald reciprocal term is dropped: it is identically zero for zero
    charges. With ``h_lj``, zero-epsilon sites get small LJ parameters
    (eps = 0.0157 kJ/mol, sigma = 0.006 nm, openmmtools'
    DischargedWaterBoxHsites) so hydrogens keep a repulsive core."""
    new_terms = []
    for t in system.terms:
        if isinstance(t, EwaldReciprocalTerm):
            continue
        if isinstance(t, NonbondedTerm):
            sigma, epsilon = t.sigma, t.epsilon
            if h_lj:
                zero_eps = epsilon == 0.0
                epsilon = torch.where(zero_eps, 0.0157, epsilon).to(
                    t.epsilon.dtype)
                sigma = torch.where(zero_eps, 0.006, sigma).to(t.sigma.dtype)
            t = t.replace(
                charge=torch.zeros_like(t.charge),
                sigma=sigma, epsilon=epsilon,
                exception_chargeprod=torch.zeros_like(t.exception_chargeprod))
        new_terms.append(t)
    return system.replace(terms=tuple(new_terms))


class FlexibleReactionFieldWaterBox(WaterBox):
    """Flexible water with reaction-field electrostatics."""

    def __init__(self, *args, **kwargs):
        kwargs["constrained"] = False
        kwargs["nonbonded_method"] = "cutoff_periodic"
        super().__init__(*args, **kwargs)


class FlexiblePMEWaterBox(WaterBox):
    """Flexible water with PME."""

    def __init__(self, *args, **kwargs):
        kwargs["constrained"] = False
        kwargs["nonbonded_method"] = "pme"
        super().__init__(*args, **kwargs)


class PMEWaterBox(WaterBox):
    """Rigid water with PME."""

    def __init__(self, *args, **kwargs):
        kwargs["nonbonded_method"] = "pme"
        super().__init__(*args, **kwargs)


class GiantFlexibleWaterBox(WaterBox):
    """5 nm flexible box, ~4000 waters."""

    def __init__(self, *args, **kwargs):
        kwargs["constrained"] = False
        kwargs.setdefault("box_edge", 5.0)
        super().__init__(*args, **kwargs)


class FourSiteWaterBox(WaterBox):
    """TIP4P-EW box."""

    def __init__(self, *args, **kwargs):
        kwargs["model"] = "tip4pew"
        super().__init__(*args, **kwargs)


class FiveSiteWaterBox(WaterBox):
    """TIP5P box."""

    def __init__(self, *args, **kwargs):
        kwargs["model"] = "tip5p"
        super().__init__(*args, **kwargs)


class DischargedWaterBox(WaterBox):
    """Water box with zeroed charges."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.system = _discharged_system(self.system)


class FlexibleDischargedWaterBox(FlexibleWaterBox):
    """Flexible water box with zeroed charges."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.system = _discharged_system(self.system)


class GiantFlexibleDischargedWaterBox(FlexibleDischargedWaterBox):
    """5 nm flexible discharged box."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("box_edge", 5.0)
        super().__init__(*args, **kwargs)


class DischargedWaterBoxHsites(WaterBox):
    """Zeroed charges + small LJ sites on hydrogens."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.system = _discharged_system(self.system, h_lj=True)


class AlchemicalWaterBox(WaterBox):
    """Water box whose first molecule is alchemically modifiable through
    ``lambda_electrostatics`` / ``lambda_sterics`` (the factory's defaults:
    direct-space PME treatment, annihilated electrostatics, decoupled
    sterics, the alchemical term in force group 1)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        from openmmtools_tpu_torch.alchemy import (
            AbsoluteAlchemicalFactory,
            AlchemicalRegion,
        )

        spm = self.system.n_particles // self.n_waters
        region = AlchemicalRegion(alchemical_atoms=list(range(spm)))
        factory = AbsoluteAlchemicalFactory()
        self.system = factory.create_alchemical_system(self.system, region)
