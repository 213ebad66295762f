"""Integrators outside the Langevin splitting language (counterpart of
``integrators/extras.py``).

openmmtools' standalone CustomIntegrator programs:

* :class:`NoseHooverChainVelocityVerletIntegrator`: deterministic NVT by a
  Nosé–Hoover chain with Yoshida–Suzuki multi-timestepping of the bath; the
  bath's kinetic and potential energy by ``bath_energy``;
* :class:`AndersenVelocityVerletIntegrator`: velocity Verlet with Andersen
  collisions (a particle's velocity redrawn with probability 1 - e^(-nu dt)
  a step);
* :class:`MetropolisMonteCarloIntegrator`: Gaussian displacements of every
  particle, Metropolis-accepted, with acceptance counts;
* :class:`HMCIntegrator`: fresh velocities, ``nsteps`` of velocity Verlet,
  Metropolis on the total energy;
* :class:`MTSIntegrator`: r-RESPA through the splitting language's numbered
  ``Vn`` tokens;
* :class:`DummyIntegrator`: a no-op.

Each bound class overrides ``BoundIntegrator.step`` (the Nosé–Hoover chain
also ``initial_state``), so it keeps the generic program: never the chunk
kernel nor sweep mode (``ops.fused_langevin.brings_own_step``); its steps
evaluate by the dense force program. Random numbers come from the state's
``torch.Generator``; the Andersen, HMC and Metropolis steps are a draw
followed by a deterministic core that takes the draws as arguments.
"""
from __future__ import annotations

import math

import torch

from openmmtools_tpu_torch.integrators.langevin import (
    BoundIntegrator,
    IntegratorState,
    LangevinIntegrator,
    draw_normal,
    draw_uniform,
    thermalize_velocities,
)

_YS_WEIGHTS = {
    1: (1.0,),
    3: (0.828981543588751, -0.657963087177502, 0.828981543588751),
    5: (0.2967324292201065, 0.2967324292201065, -0.186929716880426,
        0.2967324292201065, 0.2967324292201065),
}


class _DenseStep(BoundIntegrator):
    """A bound integrator whose step evaluates the whole system by the
    dense force program."""

    def _energy_forces(self, x, state: IntegratorState):
        return self.force_path.ef_fns[None](x, state.box, state.global_params)


class _BoundNoseHoover(_DenseStep):
    """Nosé–Hoover chain around velocity Verlet. The chain state rides in
    ``global_params`` under the reserved keys '_nhc_xi_i' and '_nhc_vxi_i',
    so IntegratorState keeps its fields."""

    def _n_degrees_of_freedom(self) -> float:
        n_mobile = float(torch.sum(self.masses > 0))
        return 3.0 * n_mobile - self.system.constraints.n_constraints

    def initial_state(self, sampler_state, generator, **kwargs):
        state = super().initial_state(sampler_state, generator, **kwargs)
        params = dict(state.global_params)
        zero = torch.zeros((), dtype=state.positions.dtype,
                           device=state.positions.device)
        for i in range(self.integrator.chain_length):
            params[f"_nhc_xi_{i}"] = zero
            params[f"_nhc_vxi_{i}"] = zero
        return state.replace(global_params=params)

    def _chain_masses(self, kT):
        """Q_0 = Ndf kT / freq^2, Q_j = kT / freq^2."""
        integ = self.integrator
        freq2 = integ.collision_frequency ** 2
        return ([self._n_degrees_of_freedom() * kT / freq2]
                + [kT / freq2] * (integ.chain_length - 1))

    def _propagate_chain(self, v, xi, vxi, kT):
        """Half-step chain propagation (the Martyna–Tuckerman–Klein scheme
        with Yoshida–Suzuki weights): the velocity scale and the new xi,
        vxi."""
        integ = self.integrator
        m_chain, n_mts = integ.chain_length, integ.n_mts
        dt = integ.timestep
        ndf = self._n_degrees_of_freedom()
        q = self._chain_masses(kT)
        ke2 = torch.sum(self.masses[:, None] * v * v)   # 2 KE
        scale = torch.ones((), dtype=v.dtype, device=v.device)
        xi, vxi = list(xi), list(vxi)

        def g_of(j, ke2_now):
            if j == 0:
                return (ke2_now - ndf * kT) / q[0]
            return (q[j - 1] * vxi[j - 1] ** 2 - kT) / q[j]

        for _ in range(n_mts):
            for w in _YS_WEIGHTS[integ.n_ys]:
                wdt = w * dt / n_mts
                # downward sweep: tail -> head
                vxi[m_chain - 1] = (vxi[m_chain - 1] + 0.25 * wdt
                                    * g_of(m_chain - 1, ke2 * scale**2))
                for j in range(m_chain - 2, -1, -1):
                    ef = torch.exp(-0.125 * wdt * vxi[j + 1])
                    vxi[j] = (vxi[j] * ef
                              + 0.25 * wdt * g_of(j, ke2 * scale**2)) * ef
                scale = scale * torch.exp(-0.5 * wdt * vxi[0])
                for j in range(m_chain):
                    xi[j] = xi[j] + 0.5 * wdt * vxi[j]
                # upward sweep: head -> tail with the scaled KE
                for j in range(m_chain - 1):
                    ef = torch.exp(-0.125 * wdt * vxi[j + 1])
                    vxi[j] = (vxi[j] * ef
                              + 0.25 * wdt * g_of(j, ke2 * scale**2)) * ef
                vxi[m_chain - 1] = (vxi[m_chain - 1] + 0.25 * wdt
                                    * g_of(m_chain - 1, ke2 * scale**2))
        return scale, xi, vxi

    def step(self, state: IntegratorState,
             skip_trailing_vproj=False) -> IntegratorState:
        m_chain = self.integrator.chain_length
        dt = self.integrator.timestep
        params = dict(state.global_params)
        xi = [params[f"_nhc_xi_{i}"] for i in range(m_chain)]
        vxi = [params[f"_nhc_vxi_{i}"] for i in range(m_chain)]
        kT = state.kT
        x, v = state.positions, state.velocities
        f = state.forces[0]
        scale, xi, vxi = self._propagate_chain(v, xi, vxi, kT)
        v = v * scale
        v = v + 0.5 * dt * f * self.inv_mass[:, None]
        x = x + dt * v
        u, f = self.force_path.ef_fns[None](x, state.box, params)
        v = v + 0.5 * dt * f * self.inv_mass[:, None]
        scale, xi, vxi = self._propagate_chain(v, xi, vxi, kT)
        v = v * scale
        for i in range(m_chain):
            params[f"_nhc_xi_{i}"] = xi[i]
            params[f"_nhc_vxi_{i}"] = vxi[i]
        return state.replace(positions=x, velocities=v, forces=(f,),
                             potentials=(u,), global_params=params,
                             step_count=state.step_count + 1)

    def bath_energy(self, state: IntegratorState):
        """The bath's (kinetic, potential) energy."""
        m_chain = self.integrator.chain_length
        kT = state.kT
        gp = state.global_params
        q = self._chain_masses(kT)
        ke = sum(0.5 * q[i] * gp[f"_nhc_vxi_{i}"] ** 2 for i in range(m_chain))
        pe = (self._n_degrees_of_freedom() * kT * gp["_nhc_xi_0"]
              + kT * sum(gp[f"_nhc_xi_{i}"] for i in range(1, m_chain)))
        return ke, pe


class NoseHooverChainVelocityVerletIntegrator(LangevinIntegrator):
    """Deterministic NVT integrator: temperature, collision_frequency (1/ps;
    the thermostat's frequency), chain_length, n_ys (the Yoshida–Suzuki
    order, 1, 3 or 5) and n_mts (the bath's sub-steps)."""

    _bound_class = _BoundNoseHoover
    _default_splitting = "V R V"   # parsed for bookkeeping only

    def __init__(self, temperature=298.0, collision_frequency=50.0,
                 timestep=0.001, chain_length=5, n_ys=5, n_mts=5, **kwargs):
        if n_ys not in _YS_WEIGHTS:
            raise ValueError("n_ys must be 1, 3, or 5")
        super().__init__(temperature=temperature, collision_rate=1.0,
                         timestep=timestep, splitting="V R V", **kwargs)
        self.collision_frequency = collision_frequency
        self.chain_length = chain_length
        self.n_ys = n_ys
        self.n_mts = n_mts


class _BoundAndersen(_DenseStep):
    def step(self, state: IntegratorState,
             skip_trailing_vproj=False) -> IntegratorState:
        gen = state.generator
        fresh = thermalize_velocities(self.masses, state.kT, gen,
                                      dtype=state.velocities.dtype)
        uniforms = draw_uniform(gen, (state.velocities.shape[0], 1),
                            state.velocities)
        return self.andersen_step(state, fresh, uniforms)

    def andersen_step(self, state: IntegratorState, fresh,
                      uniforms) -> IntegratorState:
        """The step given its draws: Maxwell–Boltzmann velocities ``fresh``
        (N, 3) and one uniform a particle (N, 1); a particle whose uniform
        lies below 1 - e^(-nu dt) takes its fresh velocity after the
        velocity Verlet step."""
        dt = self.integrator.timestep
        p_collide = 1.0 - math.exp(-self.integrator.collision_rate * dt)
        x, v = state.positions, state.velocities
        f = state.forces[0]
        v = v + 0.5 * dt * f * self.inv_mass[:, None]
        x = x + dt * v
        u, f = self._energy_forces(x, state)
        v = v + 0.5 * dt * f * self.inv_mass[:, None]
        v = torch.where(uniforms < p_collide, fresh, v)
        return state.replace(positions=x, velocities=v, forces=(f,),
                             potentials=(u,),
                             step_count=state.step_count + 1)


class AndersenVelocityVerletIntegrator(LangevinIntegrator):
    """Velocity Verlet with the Andersen thermostat; ``collision_rate`` is
    nu in 1/ps."""

    _bound_class = _BoundAndersen
    _default_splitting = "V R V"

    def __init__(self, temperature=298.0, collision_rate=91.0,
                 timestep=0.001, **kwargs):
        super().__init__(temperature=temperature,
                         collision_rate=collision_rate, timestep=timestep,
                         splitting="V R V", **kwargs)


class _BoundMetropolisMC(_DenseStep):
    def step(self, state: IntegratorState,
             skip_trailing_vproj=False) -> IntegratorState:
        gen = state.generator
        x = state.positions
        displacement = draw_normal(gen, x.shape, x)
        uniform = draw_uniform(gen, (), x)
        return self.metropolis_step(state, displacement, uniform)

    def metropolis_step(self, state: IntegratorState, displacement,
                        uniform) -> IntegratorState:
        """The step given its draws: standard normal ``displacement`` (N,
        3), scaled by ``displacement_sigma``, and the acceptance
        ``uniform``."""
        x = state.positions
        u_old, f_old = state.potentials[0], state.forces[0]
        x_new = x + self.integrator.displacement_sigma * displacement
        u_new, f_new = self._energy_forces(x_new, state)
        accept = torch.log(uniform) < -(u_new - u_old) / state.kT
        return state.replace(
            positions=torch.where(accept, x_new, x),
            forces=(torch.where(accept, f_new, f_old),),
            potentials=(torch.where(accept, u_new, u_old),),
            n_accepted=state.n_accepted + accept.to(torch.int64),
            n_proposed=state.n_proposed + 1,
            step_count=state.step_count + 1)


class MetropolisMonteCarloIntegrator(LangevinIntegrator):
    """Gaussian-displacement Metropolis 'integrator': ``displacement_sigma``
    in nm; acceptance counts in state.n_accepted / n_proposed."""

    _bound_class = _BoundMetropolisMC
    _default_splitting = "R"

    def __init__(self, temperature=298.0, displacement_sigma=0.01,
                 timestep=0.001, **kwargs):
        super().__init__(temperature=temperature, collision_rate=1.0,
                         timestep=timestep, splitting="R", **kwargs)
        self.displacement_sigma = displacement_sigma


class _BoundHMC(_DenseStep):
    def step(self, state: IntegratorState,
             skip_trailing_vproj=False) -> IntegratorState:
        gen = state.generator
        v = thermalize_velocities(self.masses, state.kT, gen,
                                  dtype=state.positions.dtype)
        uniform = draw_uniform(gen, (), state.positions)
        return self.hmc_step(state, v, uniform)

    def hmc_step(self, state: IntegratorState, v, uniform) -> IntegratorState:
        """The step given its draws: Maxwell–Boltzmann velocities ``v``
        (projected onto the constraints here) and the acceptance
        ``uniform``. A rejection keeps the positions and flips the
        velocities."""
        dt = self.integrator.timestep
        inv_mass = self.inv_mass[:, None]
        constrained = self.system.constraints.n_constraints > 0
        if constrained:
            v = self._constrain_velocities(state.positions, v)
        x0 = state.positions
        u0, f0 = state.potentials[0], state.forces[0]
        ke0 = 0.5 * torch.sum(self.masses[:, None] * v * v)
        x, u, f = x0, u0, f0
        for _ in range(self.integrator.nsteps):
            v = v + 0.5 * dt * f * inv_mass
            x_new = x + dt * v
            if constrained:
                x_proj = self._constrain_positions(x_new, x)
                v = v + (x_proj - x_new) / dt
                x_new = x_proj
            u, f = self._energy_forces(x_new, state)
            v = v + 0.5 * dt * f * inv_mass
            if constrained:
                v = self._constrain_velocities(x_new, v)
            x = x_new
        ke1 = 0.5 * torch.sum(self.masses[:, None] * v * v)
        log_p = -((u + ke1) - (u0 + ke0)) / state.kT
        accept = torch.log(uniform) < log_p
        return state.replace(
            positions=torch.where(accept, x, x0),
            velocities=torch.where(accept, v, -v),
            forces=(torch.where(accept, f, f0),),
            potentials=(torch.where(accept, u, u0),),
            n_accepted=state.n_accepted + accept.to(torch.int64),
            n_proposed=state.n_proposed + 1,
            step_count=state.step_count + 1)


class HMCIntegrator(LangevinIntegrator):
    """Hybrid Monte Carlo: each step draws Maxwell–Boltzmann velocities,
    runs ``nsteps`` of velocity Verlet and Metropolis-accepts on the change
    of the total energy; acceptance counts in state.n_accepted /
    n_proposed."""

    _bound_class = _BoundHMC
    _default_splitting = "V R V"

    def __init__(self, temperature=298.0, nsteps=10, timestep=0.001,
                 **kwargs):
        super().__init__(temperature=temperature, collision_rate=1.0,
                         timestep=timestep, splitting="V R V", **kwargs)
        self.nsteps = nsteps


class MTSIntegrator(LangevinIntegrator):
    """r-RESPA multiple-timestep integrator.

    ``groups``: (force_group, n_substeps) pairs, e.g. [(0, 1), (1, 4)]
    evaluates group 1 four times per group-0 evaluation; written as nested
    ``Vn R Vn`` patterns of the splitting language.
    """

    def __init__(self, timestep=0.002, groups=((0, 1),), temperature=298.0,
                 **kwargs):
        groups = sorted(groups, key=lambda kv: kv[1])

        def build(levels):
            (grp, n_sub), rest = levels[0], levels[1:]
            inner = build(rest) if rest else "R"
            unit = f"V{grp} " + inner + f" V{grp}"
            return " ".join([unit] * n_sub)

        # substep counts are relative: the outermost level runs once
        relative = [(g, 1) for g, _ in groups[:1]] + [
            (g, max(1, groups[i][1] // max(1, groups[i - 1][1])))
            for i, (g, _) in enumerate(groups) if i > 0]
        super().__init__(temperature=temperature, timestep=timestep,
                         splitting=build(relative), **kwargs)
        self.groups = groups


class _BoundDummy(BoundIntegrator):
    def step(self, state: IntegratorState,
             skip_trailing_vproj=False) -> IntegratorState:
        return state.replace(step_count=state.step_count + 1)


class DummyIntegrator(LangevinIntegrator):
    """A no-op integrator, for moves that need only a binding."""

    _bound_class = _BoundDummy
    _default_splitting = "R"

    def __init__(self, **kwargs):
        kwargs.setdefault("temperature", 298.0)
        kwargs.setdefault("timestep", 0.001)
        kwargs.setdefault("collision_rate", 1.0)
        kwargs.setdefault("splitting", "R")
        super().__init__(**kwargs)
