"""The gentle staged equilibration (counterpart of
``utils/equilibration.py``, openmmtools' ``run_gentle_equilibration``).

A sequence of :class:`EquilibrationStage`: minimize, or run dynamics at a
temperature (NVT, or NPT with the Monte Carlo barostat), with positional
restraints of a given strength on selected atoms, lowered stage by stage.

Every energy and force goes through a bound integrator that a context
cache holds (``cache.py``): the minimize stage through :func:`minimize`,
the dynamics stages through a ``BAOABIntegrator`` bound to the stage's
(restrained) system, and the NPT stages' barostat through the same bound
integrator (the cache's context for that system). On a water box on the
card that is sweep mode and the sweep kernel, the restraint summed with the
rest of the remainder around it; no stage takes the dense O(N^2) sum.

Randomness: each stage draws from a ``torch.Generator`` on the positions'
device seeded from (seed, stage index), for its velocities, its dynamics
and its barostat attempts. The JAX package splits one key a stage and seeds
each barostat from seed + stage.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Sequence

import torch

from openmmtools_tpu_torch.forces import restrain_atoms
from openmmtools_tpu_torch.integrators import BAOABIntegrator, minimize
from openmmtools_tpu_torch.mcmc import MonteCarloBarostatMove
from openmmtools_tpu_torch.multistate.sampler import derived_seed
from openmmtools_tpu_torch.states import SamplerState, ThermodynamicState

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class EquilibrationStage:
    """One stage of the protocol (openmmtools' stage dicts)."""

    stage_type: str = "npt"            # 'minimize' | 'nvt' | 'npt'
    temperature: float = 300.0          # K
    pressure: Optional[float] = None    # bar (npt only)
    n_steps: int = 1000
    timestep: float = 0.001             # ps
    collision_rate: float = 10.0        # 1/ps
    restraint_sigma: Optional[float] = None   # nm; None = no restraints
    restrained_atoms: Sequence[int] = ()


def barostat_applies(stage: EquilibrationStage) -> int:
    """The barostat moves an NPT stage applies after its dynamics."""
    return max(1, stage.n_steps // 25)


def run_gentle_equilibration(thermodynamic_state: ThermodynamicState,
                             sampler_state: SamplerState,
                             stages: Sequence[EquilibrationStage],
                             seed: int = 0, context_cache=None,
                             timer=None, callback=None) -> SamplerState:
    """Run the staged protocol and return the final sampler state.

    ``context_cache`` (default: the global one) holds each stage's bound
    integrator; a dynamics stage's ``BAOABIntegrator`` takes the cache's
    integrator keyword arguments (``ContextCache(sweep="force")``) below
    the stage's own settings. ``timer`` (a ``utils.timing.Timer``)
    records each stage's set-up ("stage <i> setup": the restrained system
    and its bound integrator) and run ("stage <i> run"); the caller
    synchronizes the card before reading it. ``callback(i, stage,
    sampler_state)`` sees each stage's final state."""
    if context_cache is None:
        from openmmtools_tpu_torch.cache import global_context_cache

        context_cache = global_context_cache
    device = sampler_state.positions.device
    for i, stage in enumerate(stages):
        if timer is not None:
            timer.start(f"stage {i} setup")
        system = thermodynamic_state.system
        if stage.restraint_sigma is not None and len(stage.restrained_atoms):
            system = restrain_atoms(system, sampler_state.positions,
                                    stage.restrained_atoms,
                                    sigma=stage.restraint_sigma)
        state = ThermodynamicState(
            system=system, temperature=stage.temperature,
            pressure=stage.pressure,
            global_params=thermodynamic_state.global_params)
        if stage.stage_type == "minimize":
            integrator = None
        else:
            if stage.stage_type == "npt" and stage.pressure is None:
                raise ValueError("npt stage requires a pressure")
            settings = dict(context_cache.integrator_kwargs,
                            temperature=stage.temperature,
                            collision_rate=stage.collision_rate,
                            timestep=stage.timestep)
            integrator = BAOABIntegrator(**settings)
        bound, _ = context_cache.get_context(state, integrator)
        if timer is not None:
            timer.stop(f"stage {i} setup")
            timer.start(f"stage {i} run")

        if stage.stage_type == "minimize":
            sampler_state = minimize(state, sampler_state,
                                     max_iterations=stage.n_steps,
                                     context_cache=context_cache)
        else:
            generator = torch.Generator(device=device).manual_seed(
                derived_seed(seed, i))
            istate = bound.initial_state(sampler_state, generator,
                                         temperature=stage.temperature,
                                         global_params=state.global_params)
            istate = bound.run(istate, stage.n_steps)
            sampler_state = bound.sampler_state_from(istate)
            if stage.stage_type == "npt":
                barostat = MonteCarloBarostatMove(seed=seed + i)
                for _ in range(barostat_applies(stage)):
                    sampler_state = barostat.apply(
                        state, sampler_state, generator=generator,
                        context_cache=context_cache)
        if timer is not None:
            timer.stop(f"stage {i} run")
        if callback is not None:
            callback(i, stage, sampler_state)
        logger.info("stage %d (%s): done", i, stage.stage_type)
    return sampler_state
