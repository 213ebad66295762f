"""Analytic and LJ test systems (counterpart of ``models/testsystems.py``).

This slice ports the systems the main path and its oracles use:
``HarmonicOscillator``, ``LennardJonesFluid`` (with ``Truncated`` and
``Switched``) and ``LennardJonesPair``. Construction is host-side numpy, as
in the JAX package (the same scipy Sobol draw, so positions match bit for
bit), and ends in float32 tensors on the ``device`` the caller names: the
card unless the caller asks for the CPU.

Units: all constructor arguments are in internal MD units (nm, ps, amu,
kJ/mol, K, bar).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from openmmtools_tpu_torch.constants import STANDARD_STATE_VOLUME, kB
from openmmtools_tpu_torch.states import SamplerState, ThermodynamicState
from openmmtools_tpu_torch.system import (
    CustomExternalTerm,
    NonbondedTerm,
    System,
    no_constraints,
)

KCAL = 4.184                 # kJ per kcal
A = 0.1                      # nm per angstrom


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


def _lj_nonbonded(n, sigma, epsilon, method, cutoff, switch_width,
                  dispersion_correction, device):
    return NonbondedTerm(
        charge=_tensor(_f32(np.zeros(n)), device),
        sigma=_tensor(_f32(np.full(n, sigma)), device),
        epsilon=_tensor(_f32(np.full(n, epsilon)), device),
        exception_index=_tensor(np.zeros((0, 2), dtype=np.int32), device),
        exception_chargeprod=_tensor(_f32([]), device),
        exception_sigma=_tensor(_f32([]), device),
        exception_epsilon=_tensor(_f32([]), device),
        method=method, cutoff=cutoff, switch_width=switch_width,
        use_dispersion_correction=dispersion_correction,
    )


class LennardJonesFluid(TestSystem):
    """Periodic LJ fluid (argon defaults), subrandom initial placement.

    Defaults: 1000 particles, reduced density 0.05, sigma = 0.34 nm,
    epsilon = 0.238 kcal/mol, cutoff = 3 sigma, quintic switch over the last
    ``switch_width`` (= sigma) before the cutoff; the analytic dispersion
    correction is on only when there is no switch. The charged fluid (its
    Ewald reciprocal term) is not ported yet.
    """

    def __init__(self, nparticles=1000, reduced_density=0.05, mass=39.9,
                 sigma=3.4 * A, epsilon=0.238 * KCAL, cutoff=None,
                 switch_width=3.4 * A, shift=False, dispersion_correction=True,
                 lattice=False, charge=None, seed=0, device="cuda"):
        super().__init__(device)
        if charge is not None and charge != 0.0:
            raise NotImplementedError(
                "the charged LJ fluid is not ported yet")
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
        nb = _lj_nonbonded(nparticles, sigma, epsilon, "cutoff_periodic",
                           cutoff, switch_width,
                           dispersion_correction and switch_width is None,
                           device)
        self.system = System(
            masses=_tensor(_f32(np.full(nparticles, mass)), device),
            terms=(nb,), constraints=no_constraints(device),
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


class LennardJonesPair(TestSystem):
    """Two LJ particles at the potential minimum separation; analytic B2
    virial coefficient and binding free energy by quadrature."""

    def __init__(self, mass=39.9, sigma=3.4 * A, epsilon=1.0 * KCAL,
                 device="cuda"):
        super().__init__(device)
        self.mass, self.sigma, self.epsilon = mass, sigma, epsilon
        nb = _lj_nonbonded(2, sigma, epsilon, "no_cutoff", None, None, False,
                           device)
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
