"""Analytic and LJ test systems (counterpart of ``models/testsystems.py``).

The harmonic and power oscillators, the oscillator array, N particles in
external potentials, the diatom, the ideal gas, the LJ cluster, the LJ
fluid (uncharged, or charged with PME; ``Truncated`` and ``Switched``), the
WCA fluid and the LJ pair, and the alanine dipeptide systems read from the
reference's Amber files (``models/amber.py``). Construction is host-side numpy, as in the JAX
package (the same scipy Sobol draw, so positions match bit for bit), and
ends in float32 tensors on the ``device`` the caller names: the card unless
the caller asks for the CPU. Each system carries its analytic expectations
where it has them (``get_*_expectation``, ``get_*_standard_deviation``).
:func:`get_available_testsystems` names the systems the port has, those of
``models/water.py`` and ``models/more_systems.py`` included.

Units: all constructor arguments are in internal MD units (nm, ps, amu,
kJ/mol, K, bar).
"""
from __future__ import annotations

import math
import sys
from typing import Optional

import numpy as np
import torch

from openmmtools_tpu_torch.constants import (
    BAR_TO_KJ_PER_MOL_NM3,
    STANDARD_STATE_VOLUME,
    kB,
)
from openmmtools_tpu_torch.ops.geometry import minimum_image
from openmmtools_tpu_torch.states import SamplerState, ThermodynamicState
from openmmtools_tpu_torch.system import (
    Constraints,
    CustomExternalTerm,
    HarmonicBondTerm,
    NonbondedTerm,
    System,
    no_constraints,
)
from openmmtools_tpu_torch.utils.pytree import static_field, tensor_dataclass

KCAL = 4.184                 # kJ per kcal
A = 0.1                      # nm per angstrom
ATM = 1.01325                # bar per atmosphere


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def _tensor(x, device):
    return torch.as_tensor(np.asarray(x), device=device)


def subrandom_particle_positions(n_particles: int, box: np.ndarray,
                                 seed: int = 0) -> np.ndarray:
    """Quasi-random (scrambled Sobol) particle placement in a box: the
    low-discrepancy placement keeps the default LJ gas free of clashes."""
    from scipy.stats import qmc

    u = qmc.Sobol(d=3, scramble=True, seed=seed).random(n_particles)
    lengths = np.diagonal(np.asarray(box))
    return u * lengths


class TestSystem:
    """Base class: a System, initial positions, and optional analytic
    expectations."""

    __test__ = False  # not a pytest class

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.system: Optional[System] = None
        self.positions: Optional[torch.Tensor] = None
        self.velocities: Optional[torch.Tensor] = None
        self.topology = None    # an AmberTopology where the files give one

    @property
    def n_particles(self) -> int:
        return self.system.n_particles

    def sampler_state(self) -> SamplerState:
        return SamplerState(positions=self.positions,
                            velocities=self.velocities,
                            box_vectors=self.system.default_box)

    def thermodynamic_state(self, temperature, pressure=None) -> ThermodynamicState:
        return ThermodynamicState(system=self.system,
                                  temperature=float(temperature),
                                  pressure=None if pressure is None
                                  else float(pressure))

    @property
    def analytical_properties(self):
        """Names of the analytically computable properties."""
        prefix = "get_"
        suffixes = ("_expectation", "_standard_deviation", "_free_energy")
        return sorted(name[len(prefix):] for name in dir(self)
                      if name.startswith(prefix)
                      and any(name.endswith(s) for s in suffixes))


def get_available_testsystems():
    """The names of every public TestSystem subclass the port has: those
    of this module, ``models/water.py`` and ``models/more_systems.py``."""
    from openmmtools_tpu_torch.models import more_systems, water

    out = set()
    for module in (sys.modules[__name__], water, more_systems):
        for name in dir(module):
            obj = getattr(module, name)
            if (not name.startswith("_") and isinstance(obj, type)
                    and issubclass(obj, TestSystem)
                    and obj is not TestSystem):
                out.add(name)
    return sorted(out)


class HarmonicOscillator(TestSystem):
    """1-particle 3D harmonic well U = (K/2)((x-x0)^2 + y^2 + z^2) + U0.

    Defaults: K = 100 kcal/mol/Å^2 = 41840 kJ/mol/nm^2, mass = 39.948 amu.
    Global parameters testsystems_HarmonicOscillator_{K,x0,U0}.
    Analytic: <U> = (3/2) kT.
    """

    def __init__(self, K=41840.0, mass=39.948, U0=0.0, device="cuda"):
        super().__init__(device)
        self.K, self.mass, self.U0 = K, mass, U0
        term = CustomExternalTerm(
            particles=_tensor(np.arange(1, dtype=np.int32), device),
            global_defaults={
                "testsystems_HarmonicOscillator_K": _tensor(_f32(K), device),
                "testsystems_HarmonicOscillator_x0": _tensor(_f32(0.0), device),
                "testsystems_HarmonicOscillator_U0": _tensor(_f32(U0), device),
            },
            expression=(
                "(testsystems_HarmonicOscillator_K/2.0)"
                "*((x-testsystems_HarmonicOscillator_x0)**2 + y**2 + z**2)"
                " + testsystems_HarmonicOscillator_U0"
            ),
        )
        self.system = System(
            masses=_tensor(_f32([mass]), device), terms=(term,),
            constraints=no_constraints(device), default_box=None,
            periodic=False)
        self.positions = torch.zeros((1, 3), dtype=torch.float32,
                                     device=device)
        self.ndof = 3

    def get_potential_expectation(self, state: ThermodynamicState):
        return 1.5 * kB * state.temperature

    def get_potential_standard_deviation(self, state: ThermodynamicState):
        return 1.5 * kB * state.temperature

    def configurational_free_energy(self, temperature, K=None):
        """f = -ln Z_config in kT units: -(3/2) ln(2 pi kT / K)."""
        K = self.K if K is None else K
        return -1.5 * math.log(2.0 * math.pi * kB * float(temperature) / K)


class PowerOscillator(TestSystem):
    """1-particle power well U = K (x^b + y^b + z^b); K in kcal/mol/Å^b,
    converted. <U> = 3 kT / b."""

    def __init__(self, K=100.0, b=2, mass=39.948, device="cuda"):
        super().__init__(device)
        self.b = int(b)
        self.K = K * KCAL / (A ** self.b)  # kJ/mol/nm^b
        self.mass = mass
        term = CustomExternalTerm(
            particles=_tensor(np.arange(1, dtype=np.int32), device),
            global_defaults={
                "testsystems_PowerOscillator_K": _tensor(_f32(self.K), device)},
            expression=(f"testsystems_PowerOscillator_K*(x**{self.b} "
                        f"+ y**{self.b} + z**{self.b})"),
        )
        self.system = System(
            masses=_tensor(_f32([mass]), device), terms=(term,),
            constraints=no_constraints(device), default_box=None,
            periodic=False)
        self.positions = torch.zeros((1, 3), dtype=torch.float32,
                                     device=device)
        self.ndof = 3

    def get_potential_expectation(self, state: ThermodynamicState):
        return 3.0 * kB * state.temperature / self.b


@tensor_dataclass
class HarmonicWellArrayTerm:
    """Per-particle harmonic wells with per-particle x0 offsets:
    U = sum_i (K/2)((x_i - x0_i)^2 + y_i^2 + z_i^2), K global
    (``testsystems_HarmonicOscillatorArray_K``)."""

    particles: torch.Tensor   # (P,) int
    x0: torch.Tensor          # (P,)
    global_defaults: dict
    force_group: int = static_field(default=0)

    def energy(self, x, box, params=None):
        name = "testsystems_HarmonicOscillatorArray_K"
        k = self.global_defaults[name]
        if params is not None and name in params:
            k = params[name]
        xp = x[self.particles.long()]
        return torch.sum(0.5 * k * ((xp[:, 0] - self.x0) ** 2
                                    + xp[:, 1] ** 2 + xp[:, 2] ** 2))


class HarmonicOscillatorArray(TestSystem):
    """N independent harmonic oscillators spaced d apart on the x axis.
    Defaults K = 90 kcal/mol/Å^2, d = 1 nm, mass = 39.948 amu, N = 5.
    <U> = sigma_U = (3N/2) kT."""

    def __init__(self, K=90.0 * KCAL / A**2, d=1.0, mass=39.948, N=5,
                 device="cuda"):
        super().__init__(device)
        self.K, self.d, self.mass, self.N = K, d, mass, N
        x0 = np.arange(N) * d
        term = HarmonicWellArrayTerm(
            particles=_tensor(np.arange(N, dtype=np.int32), device),
            x0=_tensor(_f32(x0), device),
            global_defaults={"testsystems_HarmonicOscillatorArray_K":
                             _tensor(_f32(K), device)})
        self.system = System(
            masses=_tensor(_f32(np.full(N, mass)), device), terms=(term,),
            constraints=no_constraints(device), default_box=None,
            periodic=False)
        positions = np.zeros((N, 3), dtype=np.float32)
        positions[:, 0] = x0
        self.positions = _tensor(positions, device)
        self.ndof = 3 * N

    def get_potential_expectation(self, state: ThermodynamicState):
        return (self.ndof / 2.0) * kB * state.temperature

    def get_potential_standard_deviation(self, state: ThermodynamicState):
        return (self.ndof / 2.0) * kB * state.temperature


class CustomExternalForcesTestSystem(TestSystem):
    """N noninteracting particles in identical external potentials, one
    term a math expression of (x, y, z), each in its own force group.
    Default ``("x**2 + y**2 + z**2",)`` on 500 particles of argon mass."""

    def __init__(self, energy_expressions=("x**2 + y**2 + z**2",),
                 mass=39.948, n_particles=500, device="cuda"):
        super().__init__(device)
        terms = tuple(
            CustomExternalTerm(
                particles=_tensor(np.arange(n_particles, dtype=np.int32),
                                  device),
                global_defaults={}, expression=expr, force_group=i)
            for i, expr in enumerate(energy_expressions))
        self.system = System(
            masses=_tensor(_f32(np.full(n_particles, mass)), device),
            terms=terms, constraints=no_constraints(device),
            default_box=None, periodic=False)
        self.positions = torch.zeros((n_particles, 3), dtype=torch.float32,
                                     device=device)
        self.ndof = 3 * n_particles


class Diatom(TestSystem):
    """Two particles joined by a harmonic bond (optionally constrained),
    optionally in a central harmonic field. Defaults K = 290.1
    kcal/mol/Å^2, r0 = 1.55 Å, m1 = m2 = 39.948 amu; ndof = 6 - constraint.
    """

    def __init__(self, K=290.1 * KCAL / A**2, r0=1.550 * A, m1=39.948,
                 m2=39.948, constraint=False, use_central_potential=False,
                 device="cuda"):
        super().__init__(device)
        self.K, self.r0, self.m1, self.m2 = K, r0, m1, m2
        self.constraint = constraint
        self.use_central_potential = use_central_potential
        pair = np.asarray([[0, 1]], dtype=np.int32)
        terms = [HarmonicBondTerm(index=_tensor(pair, device),
                                  length=_tensor(_f32([r0]), device),
                                  k=_tensor(_f32([K]), device))]
        if use_central_potential:
            kcentral = 1.0 * KCAL
            terms.append(CustomExternalTerm(
                particles=_tensor(np.arange(2, dtype=np.int32), device),
                global_defaults={"testsystems_Diatom_Kcentral":
                                 _tensor(_f32(kcentral), device)},
                expression=("(testsystems_Diatom_Kcentral/2.0)"
                            "*(x**2 + y**2 + z**2)")))
        constraints = no_constraints(device)
        if constraint:
            constraints = Constraints(index=_tensor(pair, device),
                                      distance=_tensor(_f32([r0]), device))
        self.system = System(
            masses=_tensor(_f32([m1, m2]), device), terms=tuple(terms),
            constraints=constraints, default_box=None, periodic=False)
        positions = np.zeros((2, 3), dtype=np.float32)
        positions[1, 0] = r0
        self.positions = _tensor(positions, device)
        self.ndof = 6 - (1 if constraint else 0)

    def get_potential_expectation(self, state: ThermodynamicState):
        # the bond's one degree of freedom holds kT/2; a constraint removes it
        return (0.0 if self.constraint else 0.5) * kB * state.temperature


class IdealGas(TestSystem):
    """N noninteracting particles in a periodic box, with a null nonbonded
    term for the NPT machinery to rescale. Defaults: 216 particles of argon
    mass, 298 K, 1 atm, V with pV = N kT. <U> = 0, <KE> = (3/2) N kT, NPT
    <V> = (N+1) kT / p."""

    def __init__(self, nparticles=216, mass=39.9, temperature=298.0,
                 pressure=ATM, volume=None, device="cuda"):
        super().__init__(device)
        self.nparticles = nparticles
        self.temperature0 = temperature
        self.pressure0 = pressure
        if volume is None:
            volume = nparticles * kB * temperature / (
                pressure * BAR_TO_KJ_PER_MOL_NM3)
        self.volume0 = volume
        length = volume ** (1.0 / 3.0)
        box = np.diag(_f32([length, length, length]))
        nb = NonbondedTerm(
            charge=_tensor(_f32(np.zeros(nparticles)), device),
            sigma=_tensor(_f32(np.full(nparticles, 1.0)), device),
            epsilon=_tensor(_f32(np.zeros(nparticles)), device),
            exception_index=_tensor(np.zeros((0, 2), dtype=np.int32), device),
            exception_chargeprod=_tensor(_f32([]), device),
            exception_sigma=_tensor(_f32([]), device),
            exception_epsilon=_tensor(_f32([]), device),
            method="cutoff_periodic", cutoff=min(1.0, length * 0.49),
            use_dispersion_correction=False)
        self.system = System(
            masses=_tensor(_f32(np.full(nparticles, mass)), device),
            terms=(nb,), constraints=no_constraints(device),
            default_box=_tensor(box, device), periodic=True)
        self.positions = _tensor(
            _f32(subrandom_particle_positions(nparticles, box)), device)
        self.ndof = 3 * nparticles

    def get_potential_expectation(self, state):
        return 0.0

    def get_potential_standard_deviation(self, state):
        return 0.0

    def get_kinetic_expectation(self, state):
        return 1.5 * self.nparticles * kB * state.temperature

    def get_volume_expectation(self, state):
        if state.pressure is None:
            return float(torch.prod(torch.diagonal(self.system.default_box)))
        return ((self.nparticles + 1) * kB * state.temperature
                / (state.pressure * BAR_TO_KJ_PER_MOL_NM3))

    def get_volume_standard_deviation(self, state):
        if state.pressure is None:
            return 0.0
        return math.sqrt(self.nparticles + 1) * kB * state.temperature / (
            state.pressure * BAR_TO_KJ_PER_MOL_NM3)


def _lj_nonbonded(n, sigma, epsilon, charge, method, cutoff, switch_width,
                  dispersion_correction, device):
    charges = np.zeros(n)
    if charge is not None and charge != 0.0:
        charges[0::2] = charge
        charges[1::2] = -charge
    return NonbondedTerm(
        charge=_tensor(_f32(charges), device),
        sigma=_tensor(_f32(np.full(n, sigma)), device),
        epsilon=_tensor(_f32(np.full(n, epsilon)), device),
        exception_index=_tensor(np.zeros((0, 2), dtype=np.int32), device),
        exception_chargeprod=_tensor(_f32([]), device),
        exception_sigma=_tensor(_f32([]), device),
        exception_epsilon=_tensor(_f32([]), device),
        method=method, cutoff=cutoff, switch_width=switch_width,
        use_dispersion_correction=dispersion_correction,
    )


class LennardJonesCluster(TestSystem):
    """Non-periodic nx*ny*nz cubic lattice of LJ particles (argon sigma and
    epsilon, spacing 0.9 sigma) in a central harmonic restraint of K
    kJ/mol/nm^2. Defaults: 3x3x3 particles, K = 1."""

    def __init__(self, nx=3, ny=3, nz=3, K=1.0, cutoff=None,
                 switch_width=None, device="cuda"):
        super().__init__(device)
        mass = 39.9
        sigma = 3.4 * A
        epsilon = 0.238 * KCAL
        scale = 0.9  # lattice spacing in units of sigma
        n = nx * ny * nz
        grid = np.stack(np.meshgrid(np.arange(nx), np.arange(ny),
                                    np.arange(nz), indexing="ij"),
                        axis=-1).reshape(-1, 3)
        positions = (grid * sigma * scale).astype(np.float32)
        positions -= positions.mean(axis=0, keepdims=True)
        method = "no_cutoff" if cutoff is None else "cutoff_nonperiodic"
        nb = _lj_nonbonded(n, sigma, epsilon, None, method, cutoff,
                           switch_width, False, device)
        restraint = CustomExternalTerm(
            particles=_tensor(np.arange(n, dtype=np.int32), device),
            global_defaults={"testsystems_LennardJonesCluster_K":
                             _tensor(_f32(K), device)},
            expression=("(testsystems_LennardJonesCluster_K/2.0)"
                        "*(x**2 + y**2 + z**2)"))
        self.system = System(
            masses=_tensor(_f32(np.full(n, mass)), device),
            terms=(nb, restraint), constraints=no_constraints(device),
            default_box=None, periodic=False)
        self.positions = _tensor(positions, device)


class LennardJonesFluid(TestSystem):
    """Periodic LJ fluid (argon defaults), subrandom initial placement.

    Defaults: 1000 particles, reduced density 0.05, sigma = 0.34 nm,
    epsilon = 0.238 kcal/mol, cutoff = 3 sigma, quintic switch over the last
    ``switch_width`` (= sigma) before the cutoff; the analytic dispersion
    correction is on only when there is no switch. With ``charge``, the
    particles carry +q and -q in turn and the fluid takes PME: the erfc
    direct space on the nonbonded term and the Ewald reciprocal term.
    """

    def __init__(self, nparticles=1000, reduced_density=0.05, mass=39.9,
                 sigma=3.4 * A, epsilon=0.238 * KCAL, cutoff=None,
                 switch_width=3.4 * A, shift=False, dispersion_correction=True,
                 lattice=False, charge=None, seed=0, device="cuda"):
        super().__init__(device)
        self.nparticles = nparticles
        self.sigma, self.epsilon, self.mass = sigma, epsilon, mass
        self.reduced_density = reduced_density
        if cutoff is None:
            cutoff = 3.0 * sigma
        self.cutoff = cutoff

        volume = nparticles * sigma**3 / reduced_density
        length = volume ** (1.0 / 3.0)
        self.box_edge = length
        box = np.diag(_f32([length, length, length]))

        if shift:
            switch_width = None
        self.shift = shift
        method = "cutoff_periodic" if charge is None else "pme"
        nb = _lj_nonbonded(nparticles, sigma, epsilon, charge, method,
                           cutoff, switch_width,
                           dispersion_correction and switch_width is None,
                           device)
        terms = (nb,)
        if charge is not None and charge != 0.0:
            from openmmtools_tpu_torch.ops.pme import (
                ewald_alpha,
                make_ewald_reciprocal_term,
            )

            nb = nb.replace(ewald_alpha=ewald_alpha(float(cutoff)))
            terms = (nb, make_ewald_reciprocal_term(
                nb.charge.cpu().numpy(), float(length), float(cutoff),
                np.zeros((0, 2), np.int64), device=device))
        self.system = System(
            masses=_tensor(_f32(np.full(nparticles, mass)), device),
            terms=terms, constraints=no_constraints(device),
            default_box=_tensor(box, device), periodic=True)

        if lattice:
            n_side = int(np.ceil(nparticles ** (1 / 3)))
            grid = np.stack(np.meshgrid(*[np.arange(n_side)] * 3,
                                        indexing="ij"), axis=-1).reshape(-1, 3)
            positions = (grid[:nparticles] + 0.5) * (length / n_side)
        else:
            positions = subrandom_particle_positions(nparticles, box, seed)
        self.positions = _tensor(_f32(positions), device)


class LennardJonesFluidTruncated(LennardJonesFluid):
    """LJ fluid with a truncated (hard-cutoff) potential."""

    def __init__(self, *args, **kwargs):
        kwargs["switch_width"] = None
        super().__init__(*args, **kwargs)


class LennardJonesFluidSwitched(LennardJonesFluid):
    """LJ fluid with an explicitly switched potential (3.4 Å width)."""

    def __init__(self, *args, **kwargs):
        kwargs["switch_width"] = 3.4 * A
        super().__init__(*args, **kwargs)


@tensor_dataclass
class WCATerm:
    """Weeks–Chandler–Andersen pair potential: the repulsive part of LJ,
    shifted by +epsilon and truncated at r_min = 2^(1/6) sigma; a dense
    minimum-image pair sum."""

    sigma: torch.Tensor     # scalar
    epsilon: torch.Tensor   # scalar
    n_particles: int = static_field(default=0)
    force_group: int = static_field(default=0)

    def energy(self, x, box, params=None):
        n = self.n_particles
        d = minimum_image(x[:, None, :] - x[None, :, :], box)
        r2_raw = torch.sum(d * d, dim=-1)
        rmin2 = (2.0 ** (1.0 / 3.0)) * self.sigma * self.sigma
        upper = torch.triu(torch.ones((n, n), dtype=torch.bool,
                                      device=x.device), diagonal=1)
        mask = upper & (r2_raw < rmin2)
        # double where: the masked self-pairs must not poison the gradient
        r2 = torch.where(mask, torch.clamp(r2_raw, min=1e-12), rmin2)
        s2 = self.sigma * self.sigma / r2
        s6 = s2 * s2 * s2
        e = 4.0 * self.epsilon * (s6 * s6 - s6) + self.epsilon
        return torch.sum(torch.where(mask, e, torch.zeros_like(e)))


class WCAFluid(TestSystem):
    """WCA fluid: 216 particles at reduced density 0.96, epsilon = 120 K
    kB, sigma = 3.4 Å."""

    def __init__(self, nparticles=216, density=0.96, mass=39.9,
                 epsilon=120.0 * kB, sigma=3.4 * A, device="cuda"):
        super().__init__(device)
        self.nparticles, self.density = nparticles, density
        self.sigma, self.epsilon = sigma, epsilon
        volume = nparticles * sigma**3 / density
        length = volume ** (1.0 / 3.0)
        box = np.diag(_f32([length, length, length]))
        term = WCATerm(sigma=_tensor(_f32(sigma), device),
                       epsilon=_tensor(_f32(epsilon), device),
                       n_particles=nparticles)
        self.system = System(
            masses=_tensor(_f32(np.full(nparticles, mass)), device),
            terms=(term,), constraints=no_constraints(device),
            default_box=_tensor(box, device), periodic=True)
        self.positions = _tensor(
            _f32(subrandom_particle_positions(nparticles, box)), device)


class LennardJonesPair(TestSystem):
    """Two LJ particles at the potential minimum separation; analytic B2
    virial coefficient and binding free energy by quadrature."""

    def __init__(self, mass=39.9, sigma=3.4 * A, epsilon=1.0 * KCAL,
                 device="cuda"):
        super().__init__(device)
        self.mass, self.sigma, self.epsilon = mass, sigma, epsilon
        nb = _lj_nonbonded(2, sigma, epsilon, None, "no_cutoff", None, None,
                           False, device)
        self.system = System(
            masses=_tensor(_f32([mass, mass]), device), terms=(nb,),
            constraints=no_constraints(device), default_box=None,
            periodic=False)
        positions = np.zeros((2, 3), dtype=np.float32)
        positions[1, 0] = 2.0 ** (1.0 / 6.0) * sigma
        self.positions = _tensor(positions, device)
        self.ligand_indices = [0]
        self.receptor_indices = [1]

    def get_b2_virial(self, temperature, r_max=None, n_points=20000):
        """Second virial coefficient B2 = -2 pi ∫ (e^{-beta u(r)} - 1) r^2 dr."""
        beta = 1.0 / (kB * float(temperature))
        if r_max is None:
            r_max = 10.0 * self.sigma
        r = np.linspace(1e-4, r_max, n_points)
        s6 = (self.sigma / r) ** 6
        u = 4.0 * self.epsilon * (s6 * s6 - s6)
        integrand = (np.exp(-beta * u) - 1.0) * r**2
        return -2.0 * math.pi * np.trapezoid(integrand, r)

    def get_binding_free_energy(self, temperature, r_max=None, n_points=20000):
        """Standard-state binding free energy DeltaG = -kT ln(V_bound/V0),
        V_bound = 4 pi ∫ e^{-beta u} r^2 dr."""
        beta = 1.0 / (kB * float(temperature))
        if r_max is None:
            r_max = 3.0 * self.sigma
        r = np.linspace(1e-4, r_max, n_points)
        s6 = (self.sigma / r) ** 6
        u = 4.0 * self.epsilon * (s6 * s6 - s6)
        v_bound = 4.0 * math.pi * np.trapezoid(np.exp(-beta * u) * r**2, r)
        return -kB * float(temperature) * math.log(
            v_bound / STANDARD_STATE_VOLUME)


class AlanineDipeptideVacuum(TestSystem):
    """Alanine dipeptide (ACE-ALA-NME, 22 atoms) in vacuum from the
    reference's Amber prmtop/crd (``alanine-dipeptide-gbsa/`` under the
    data directory, ``models/amber.py``). ``constraints='h-bonds'`` is the
    reference's default."""

    _implicit = False

    def __init__(self, constraints="h-bonds", data_dir=None, device="cuda"):
        super().__init__(device)
        from openmmtools_tpu_torch.models import amber

        prmtop = amber.data_file(data_dir, "alanine-dipeptide-gbsa",
                                 "alanine-dipeptide.prmtop")
        crd = amber.data_file(data_dir, "alanine-dipeptide-gbsa",
                              "alanine-dipeptide.crd")
        amber.load_prmtop_system(self, prmtop, amber.parse_inpcrd(crd),
                                 constraints=constraints,
                                 implicit_solvent=self._implicit)


class AlanineDipeptideImplicit(AlanineDipeptideVacuum):
    """Alanine dipeptide with GBSA-OBC2 implicit solvent (the prmtop's
    RADII/SCREEN sections)."""

    _implicit = True


class AlchemicalAlanineDipeptide(AlanineDipeptideVacuum):
    """AlanineDipeptideVacuum with all 22 atoms alchemical: the system goes
    through AbsoluteAlchemicalFactory with a whole-molecule region, so
    ``lambda_electrostatics`` / ``lambda_sterics`` scale its
    interactions."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        from openmmtools_tpu_torch.alchemy import (
            AbsoluteAlchemicalFactory,
            AlchemicalRegion,
        )

        region = AlchemicalRegion(
            alchemical_atoms=list(range(self.system.n_particles)))
        self.system = AbsoluteAlchemicalFactory().create_alchemical_system(
            self.system, region)
