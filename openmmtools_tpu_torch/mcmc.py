"""MCMC move framework: moves, containers, the sampler (counterpart of
``mcmc.py``).

openmmtools' contract ``MCMCMove.apply(thermodynamic_state, sampler_state)``
returns the new SamplerState instead of mutating it. Each move owns its
randomness: a ``torch.Generator`` seeded from ``seed``, one for each device
it has seen, made on the device of the sampler state's positions (a CPU
generator cannot drive draws on the card). A caller may hand ``apply`` a
generator instead (the multistate sampler gives each replica its own):
then every draw of the move comes from it, and a container passes it down
to each of its moves in order, so that one stream reaches every leaf of
the tree (the JAX package splits the replica's key across the children).
Without one, a container's moves draw from their own generators. The
statistics (``n_accepted``/``n_proposed``) are host integers.

The Metropolized moves split into a draw and a deterministic core that
takes the draws as arguments: the displacement vector, the quaternion's
three uniforms, the barostat's ln V step epsilon, and ln u of the
acceptance test. The core takes both energies of an attempt from a bound
integrator that the context cache holds for the state (``cache.py``; the
``context_cache`` of ``apply``, else the global one): its
``energies_batch``, which on the card is sweep mode and the sweep kernel
for a large periodic system and K1's force kernel for an LJ fluid, never
the dense O(N^2) sum.

Every move applies to many replicas at once (:meth:`MCMCMove.apply_batch`,
the JAX package's vmap of the compiled move program over replicas):
replica b at its own state, drawing from its own generator in the order
``apply`` draws, so that the batch and one ``apply`` a replica give the
same result. ``batches`` says whether a move does this as one batch:

* an integrator move: one bound integrator advances the replicas as one
  batch, each at its state's temperature and global parameters; a replica
  that comes back with NaN is redone by the single-replica move, from its
  next attempt on;
* a Metropolized move (displacement, rotation): the proposals of the batch
  are stacked and both reduced potentials of every replica come from one
  ``energies_batch`` of 2B configurations; the barostat does the same for
  each of its attempts, each replica at its own box and trial box;
* ``SequenceMove``: each move's batch in order; ``WeightedMove``: each
  replica draws its branch, and the replicas of a branch run as one batch.

A bound class that brings its own step and a user's move that implements
only ``_apply`` do not batch: the sampler applies a tree that holds one a
replica at a time. ``moves_equal`` compares two move trees by what they
do.

On NaN an integrator move retries up to ``n_restart_attempts`` times, the
last with fresh velocities, then writes the failing state to
``nan-error-logs/`` and raises :class:`IntegratorMoveError`.

Moves serialize through ``utils.serialization``: their parameters,
statistics and generator states, not their caches of bound integrators.
"""
from __future__ import annotations

import logging
import math
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from openmmtools_tpu_torch.constants import BAR_TO_KJ_PER_MOL_NM3
from openmmtools_tpu_torch.integrators.langevin import (
    BoundIntegrator,
    GHMCIntegrator,
    LangevinIntegrator,
    draw_normal,
    draw_uniform,
)
from openmmtools_tpu_torch.ops.fused_langevin import brings_own_step
from openmmtools_tpu_torch.states import (
    CompoundThermodynamicState,
    SamplerState,
)
from openmmtools_tpu_torch.system import HarmonicBondTerm

logger = logging.getLogger(__name__)


def _resolve(thermodynamic_state):
    """Accept plain or compound thermodynamic states."""
    if isinstance(thermodynamic_state, CompoundThermodynamicState):
        return thermodynamic_state.resolve()
    return thermodynamic_state


def _context(thermodynamic_state, context_cache=None):
    """The bound integrator that ``context_cache`` (default: the global
    cache) holds for the state."""
    if context_cache is None:
        from openmmtools_tpu_torch.cache import global_context_cache

        context_cache = global_context_cache
    return context_cache.get_context(thermodynamic_state)[0]


def _per_config(thermodynamic_states, n):
    """One thermodynamic state a configuration: a sequence as given, else
    the one state ``n`` times."""
    if isinstance(thermodynamic_states, (list, tuple)):
        return list(thermodynamic_states)
    return [thermodynamic_states] * n


def potential_energies(thermodynamic_states, sampler_states,
                       context_cache=None):
    """U (float64) of each sampler state, each at its own box and at its
    own state's global parameters (``thermodynamic_states``: one state for
    all, or one a sampler state, all of one system), as ONE
    ``energies_batch`` of the bound integrator that ``context_cache``
    (default: the global cache) holds for the first state: the path the
    step program takes (sweep mode on a large periodic system on the card,
    one sort of each configuration and one launch of each sweep kernel for
    all of them; K1's force kernel on an LJ fluid there, once a
    configuration). Raises as ``energies_at`` does on an
    exclusion-bitfield overflow."""
    states = _per_config(thermodynamic_states, len(sampler_states))
    bound = _context(states[0], context_cache)
    x = torch.stack([ss.positions for ss in sampler_states])
    default = bound.system.default_box
    boxes = [default if ss.box_vectors is None else ss.box_vectors
             for ss in sampler_states]
    box = None if boxes[0] is None else torch.stack(
        [b.to(x.dtype) for b in boxes])
    names = list(states[0].global_params or {})
    params = {k: torch.stack([torch.as_tensor(
        ts.global_params[k], dtype=x.dtype, device=x.device)
        for ts in states]) for k in names}
    U, overflow = bound.energies_batch(
        x, box, torch.arange(len(states), device=x.device), params)
    bound.check_sweep_overflow(overflow)
    return list(torch.unbind(U))


def reduced_potentials(thermodynamic_states, sampler_states,
                       context_cache=None):
    """beta (U + p V - gamma A) of each sampler state at its state (one
    for all, or one a sampler state), U by :func:`potential_energies`."""
    states = _per_config(thermodynamic_states, len(sampler_states))
    return [ts.reduced_potential(ss, potential_energy=u)
            for ts, ss, u in zip(states, sampler_states, potential_energies(
                states, sampler_states, context_cache))]


class MCMCMoveError(Exception):
    pass


class IntegratorMoveError(MCMCMoveError):
    """Integration gave NaN despite the restarts. ``serialize_error`` writes
    the state (npz) and the move's repr for a post-mortem."""

    def __init__(self, message, move, sampler_state: SamplerState):
        super().__init__(message)
        self.move = move
        self.sampler_state = sampler_state

    def serialize_error(self, path_prefix: str):
        os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
        ss = self.sampler_state
        arrays = {"positions": ss.positions.detach().cpu().numpy()}
        if ss.velocities is not None:
            arrays["velocities"] = ss.velocities.detach().cpu().numpy()
        if ss.box_vectors is not None:
            arrays["box_vectors"] = ss.box_vectors.detach().cpu().numpy()
        np.savez(path_prefix + "-state.npz", **arrays)
        with open(path_prefix + "-move.txt", "w") as f:
            f.write(repr(self.move))


class MCMCMove:
    """Base move. Subclasses implement ``_apply(thermo, sampler_state,
    generator)`` returning the new sampler state (and update their own
    statistics). ``_CACHES`` names the per-instance caches, which
    serialization leaves out and rebuilds empty."""

    _CACHES: Tuple[str, ...] = ()

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._init_caches()

    def _init_caches(self):
        self._generators: Dict[torch.device, torch.Generator] = {}
        for name in self._CACHES:
            setattr(self, name, {})

    def generator(self, device) -> torch.Generator:
        """This move's generator on ``device``, seeded from ``seed`` at
        its first use there."""
        device = torch.device(device)
        gen = self._generators.get(device)
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(int(self.seed))
            self._generators[device] = gen
        return gen

    def apply(self, thermodynamic_state, sampler_state: SamplerState,
              generator: Optional[torch.Generator] = None,
              context_cache=None) -> SamplerState:
        """Apply the move, drawing from ``generator`` (default: the move's
        own on the positions' device). The Metropolized moves evaluate
        their energies in ``context_cache`` (default: the global one); the
        integrator moves keep their bound integrators on the move."""
        if generator is None:
            generator = self.generator(sampler_state.positions.device)
        return self._apply(_resolve(thermodynamic_state), sampler_state,
                           generator, context_cache)

    def _apply(self, thermodynamic_state, sampler_state, generator,
               context_cache):
        raise NotImplementedError

    def batches(self, thermodynamic_state) -> bool:
        """Whether :meth:`apply_batch` advances replicas at states of this
        one's system as one batch (a move that implements only ``_apply``
        does not)."""
        return False

    def apply_batch(self, thermodynamic_states, sampler_states, generators,
                    context_cache=None, owners=None) -> list:
        """Apply the move to B replicas: replica b at
        ``thermodynamic_states[b]`` (all of one system), drawing from
        ``generators[b]`` in the order :meth:`apply` draws; the B new
        sampler states. ``owners[b]`` (default: this move) is a move equal
        to this one (:func:`moves_equal`) whose statistics count replica b,
        as the sampler's per-state moves do. The moves that batch implement
        it."""
        raise NotImplementedError(f"{type(self).__name__} does not batch")

    @property
    def statistics(self) -> Dict[str, Any]:
        return {}

    @statistics.setter
    def statistics(self, value: Dict[str, Any]):
        pass

    def __getstate__(self):
        state = {k: v for k, v in self.__dict__.items()
                 if k != "_generators" and k not in self._CACHES}
        state["_generator_states"] = {
            str(device): gen.get_state()
            for device, gen in self._generators.items()}
        return state

    def __setstate__(self, state):
        state = dict(state)
        saved = state.pop("_generator_states", {})
        self.__dict__.update(state)
        self._init_caches()
        for device, gen_state in saved.items():
            gen = torch.Generator(device=device)
            gen.set_state(torch.as_tensor(gen_state, dtype=torch.uint8))
            self._generators[torch.device(device)] = gen

    def __repr__(self):
        return f"{type(self).__name__}()"


class SequenceMove(MCMCMove):
    """Apply a list of moves in order."""

    def __init__(self, move_list: Sequence[MCMCMove], seed: int = 0):
        super().__init__(seed)
        self.move_list = list(move_list)

    def apply(self, thermodynamic_state, sampler_state: SamplerState,
              generator: Optional[torch.Generator] = None,
              context_cache=None) -> SamplerState:
        """Apply each move in order, each drawing from ``generator`` (the
        replica's stream) where one is given, else from its own."""
        for move in self.move_list:
            sampler_state = move.apply(thermodynamic_state, sampler_state,
                                       generator=generator,
                                       context_cache=context_cache)
        return sampler_state

    def batches(self, thermodynamic_state) -> bool:
        return all(m.batches(thermodynamic_state) for m in self.move_list)

    def apply_batch(self, thermodynamic_states, sampler_states, generators,
                    context_cache=None, owners=None) -> list:
        """Each move's batch in order, the replicas' generators handed
        down."""
        owners = owners or [self] * len(sampler_states)
        for i, move in enumerate(self.move_list):
            sampler_states = move.apply_batch(
                thermodynamic_states, sampler_states, generators,
                context_cache, owners=[o.move_list[i] for o in owners])
        return sampler_states

    @property
    def statistics(self):
        return [m.statistics for m in self.move_list]

    @statistics.setter
    def statistics(self, value):
        for m, s in zip(self.move_list, value):
            m.statistics = s

    def __repr__(self):
        return f"SequenceMove({self.move_list!r})"


class WeightedMove(MCMCMove):
    """Apply one move a time, drawn by weight."""

    def __init__(self, move_set: Sequence[Tuple[MCMCMove, float]],
                 seed: int = 0):
        super().__init__(seed)
        self.move_set = list(move_set)

    def _pick(self, generator) -> int:
        """The branch, drawn by weight from ``generator``."""
        weights = torch.as_tensor([w for _, w in self.move_set],
                                  dtype=torch.float64, device=generator.device)
        return int(torch.multinomial(weights / weights.sum(), 1,
                                     generator=generator))

    def apply(self, thermodynamic_state, sampler_state: SamplerState,
              generator: Optional[torch.Generator] = None,
              context_cache=None) -> SamplerState:
        """Draw the branch from ``generator`` and apply it drawing from the
        same; without one, the branch from this move's generator and the
        branch's draws from its own."""
        own = generator
        if own is None:
            own = self.generator(sampler_state.positions.device)
        move = self.move_set[self._pick(own)][0]
        return move.apply(thermodynamic_state, sampler_state,
                          generator=generator, context_cache=context_cache)

    def batches(self, thermodynamic_state) -> bool:
        return all(m.batches(thermodynamic_state) for m, _ in self.move_set)

    def apply_batch(self, thermodynamic_states, sampler_states, generators,
                    context_cache=None, owners=None) -> list:
        """Each replica draws its branch from its generator; the replicas
        of a branch run as one batch, and the results go back in order."""
        owners = owners or [self] * len(sampler_states)
        picks = [self._pick(gen) for gen in generators]
        out = list(sampler_states)
        for i, (move, _) in enumerate(self.move_set):
            idx = [b for b, p in enumerate(picks) if p == i]
            if not idx:
                continue
            new = move.apply_batch(
                [thermodynamic_states[b] for b in idx],
                [sampler_states[b] for b in idx],
                [generators[b] for b in idx], context_cache,
                owners=[owners[b].move_set[i][0] for b in idx])
            for b, ss in zip(idx, new):
                out[b] = ss
        return out

    @property
    def statistics(self):
        return [m.statistics for m, _ in self.move_set]

    @statistics.setter
    def statistics(self, value):
        for (m, _), s in zip(self.move_set, value):
            m.statistics = s


# ---------------------------------------------------------------------------
# integrator moves
# ---------------------------------------------------------------------------


class BaseIntegratorMove(MCMCMove):
    """``n_steps`` of dynamics as one move: ``reassign_velocities`` draws
    fresh Maxwell–Boltzmann velocities first; on NaN up to
    ``n_restart_attempts`` retries, the last with fresh velocities."""

    def __init__(self, n_steps: int, reassign_velocities: bool = False,
                 n_restart_attempts: int = 4, seed: int = 0):
        super().__init__(seed)
        self.n_steps = n_steps
        self.reassign_velocities = reassign_velocities
        self.n_restart_attempts = n_restart_attempts

    def _get_integrator(self, thermodynamic_state) -> LangevinIntegrator:
        raise NotImplementedError

    def _bound(self, thermodynamic_state) -> BoundIntegrator:
        """The integrator bound to the state's system (cached on the
        integrator by the system's fingerprint)."""
        integ = self._get_integrator(_resolve(thermodynamic_state))
        return integ.bind(_resolve(thermodynamic_state).system)

    def _on_integration_end(self, final_state):
        """Hook: harvest statistics from the final integrator state (one
        replica's, or a batch's)."""

    def batches(self, thermodynamic_state) -> bool:
        """Whether :meth:`apply_batch` advances replicas as one batch: the
        bound integrator runs this module's step program
        (``brings_own_step`` marks a class that replaces it)."""
        bound = self._bound(thermodynamic_state)
        return not brings_own_step(type(bound))

    def apply_batch(self, thermodynamic_states, sampler_states, generators,
                    context_cache=None, owners=None) -> list:
        """Apply the move to B replicas as one batch: replica b at
        ``thermodynamic_states[b]`` (all of one system), drawing from
        ``generators[b]``. One bound integrator (that of the first state)
        serves them all: each replica's kT and global parameters ride in
        the batched state. Returns the B new sampler states. A replica that
        went to NaN is redone alone, by its owner's :meth:`apply` restarts
        from the second attempt on; the others keep the batch's result.
        The integrator moves keep their bound integrators on the move, so
        ``context_cache`` plays no part."""
        owners = owners or [self] * len(sampler_states)
        states = [_resolve(ts) for ts in thermodynamic_states]
        bound = self._bound(states[0])
        sampler_states = [ss.replace(velocities=None)
                          if self.reassign_velocities else ss
                          for ss in sampler_states]
        state = bound.initial_state_batch(sampler_states, generators,
                                          thermodynamic_states=states)
        state = bound.run(state, self.n_steps)
        if state.nbr_overflow is not None and bool(state.nbr_overflow.any()):
            raise MCMCMoveError(
                "neighbor-list capacity exceeded during integration; "
                "increase neighbor_skin/k_max or density changed "
                "drastically")
        out = bound.sampler_states_from(state)
        ok = torch.stack([~ss.has_nan() for ss in out]).cpu()
        kept = torch.nonzero(ok).reshape(-1).tolist()
        # each owner harvests the statistics of its finite replicas
        for owner in {id(o): o for o in owners}.values():
            mine = [b for b in kept if owners[b] is owner]
            if mine:
                keep = torch.as_tensor(mine, device=state.n_accepted.device)
                owner._on_integration_end(state.replace(
                    n_accepted=state.n_accepted[keep],
                    n_proposed=state.n_proposed[keep]))
        for b in torch.nonzero(~ok).reshape(-1).tolist():
            logger.warning("NaN in %s (replica %d of a batch); restarting "
                           "it alone", type(self).__name__, b)
            out[b] = owners[b]._attempts(states[b], sampler_states[b],
                                         generators[b], first=1)
        return out

    def _apply(self, thermodynamic_state, sampler_state, generator,
               context_cache):
        return self._attempts(thermodynamic_state, sampler_state, generator)

    def _attempts(self, thermodynamic_state, sampler_state, generator,
                  first=0):
        """Integrate, restarting on NaN: attempts ``first`` ..
        ``n_restart_attempts``, the last with fresh velocities."""
        bound = self._bound(thermodynamic_state)
        for attempt in range(first, self.n_restart_attempts + 1):
            ss = sampler_state
            if self.reassign_velocities or attempt == self.n_restart_attempts:
                ss = ss.replace(velocities=None)
            state = bound.initial_state(
                ss, generator, thermodynamic_state=thermodynamic_state)
            state = bound.run(state, self.n_steps)
            if state.nbr_overflow is not None and bool(state.nbr_overflow):
                raise MCMCMoveError(
                    "neighbor-list capacity exceeded during integration; "
                    "increase neighbor_skin/k_max or density changed "
                    "drastically")
            new_ss = bound.sampler_state_from(state)
            if not bool(new_ss.has_nan()):
                self._on_integration_end(state)
                return new_ss
            logger.warning("NaN in %s (attempt %d/%d); restarting",
                           type(self).__name__, attempt + 1,
                           self.n_restart_attempts)
        err = IntegratorMoveError(
            f"NaN after {self.n_restart_attempts} restarts", self,
            sampler_state)
        err.serialize_error(os.path.join("nan-error-logs",
                                         type(self).__name__))
        raise err

    def __repr__(self):
        return (f"{type(self).__name__}(n_steps={self.n_steps}, "
                f"reassign_velocities={self.reassign_velocities})")


class IntegratorMove(BaseIntegratorMove):
    """Any integrator as a move; its temperature follows the state's."""

    def __init__(self, integrator: LangevinIntegrator, n_steps: int,
                 **kwargs):
        super().__init__(n_steps, **kwargs)
        self.integrator = integrator

    def _get_integrator(self, thermodynamic_state):
        self.integrator.temperature = float(thermodynamic_state.temperature)
        return self.integrator


class LangevinDynamicsMove(BaseIntegratorMove):
    """Langevin dynamics in the 'V R O R V' splitting (OpenMM's
    LangevinMiddleIntegrator); one integrator a temperature."""

    _CACHES = ("_integrators",)
    splitting = "V R O R V"

    def __init__(self, timestep=0.001, collision_rate=10.0, n_steps=1000,
                 reassign_velocities=False, **kwargs):
        super().__init__(n_steps, reassign_velocities=reassign_velocities,
                         **kwargs)
        self.timestep = timestep
        self.collision_rate = collision_rate

    def _integrator_kwargs(self):
        return dict(collision_rate=self.collision_rate,
                    timestep=self.timestep, splitting=self.splitting)

    def _get_integrator(self, thermodynamic_state):
        t = float(thermodynamic_state.temperature)
        integ = self._integrators.get(t)
        if integ is None:
            integ = LangevinIntegrator(temperature=t,
                                       **self._integrator_kwargs())
            self._integrators[t] = integ
        return integ


class LangevinSplittingDynamicsMove(LangevinDynamicsMove):
    """Langevin dynamics with a splitting of the caller's."""

    def __init__(self, timestep=0.001, collision_rate=10.0, n_steps=1000,
                 splitting="V R O R V", constraint_tolerance=1e-8,
                 measure_shadow_work=False, measure_heat=False, **kwargs):
        super().__init__(timestep=timestep, collision_rate=collision_rate,
                         n_steps=n_steps, **kwargs)
        self.splitting = splitting
        self.constraint_tolerance = constraint_tolerance
        self.measure_shadow_work = measure_shadow_work
        self.measure_heat = measure_heat

    def _integrator_kwargs(self):
        return dict(super()._integrator_kwargs(),
                    constraint_tolerance=self.constraint_tolerance,
                    measure_shadow_work=self.measure_shadow_work,
                    measure_heat=self.measure_heat)


class _MetropolizedIntegratorMove(BaseIntegratorMove):
    """Acceptance statistics of the GHMC and HMC moves, from the final
    integrator state's counters."""

    _CACHES = ("_integrators",)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_accepted = 0
        self.n_proposed = 0

    def _on_integration_end(self, final_state):
        self.n_accepted += int(final_state.n_accepted.sum())
        self.n_proposed += int(final_state.n_proposed.sum())

    @property
    def fraction_accepted(self):
        if self.n_proposed == 0:
            return float("nan")
        return self.n_accepted / self.n_proposed

    @property
    def statistics(self):
        return {"n_accepted": self.n_accepted, "n_proposed": self.n_proposed}

    @statistics.setter
    def statistics(self, value):
        self.n_accepted = value["n_accepted"]
        self.n_proposed = value["n_proposed"]


class GHMCMove(_MetropolizedIntegratorMove):
    """Generalized hybrid Monte Carlo: 'O { V R V } O' with a momentum
    flip on rejection; exact sampling at any timestep."""

    def __init__(self, timestep=0.001, collision_rate=20.0, n_steps=1000,
                 **kwargs):
        super().__init__(n_steps, **kwargs)
        self.timestep = timestep
        self.collision_rate = collision_rate

    def _get_integrator(self, thermodynamic_state):
        t = float(thermodynamic_state.temperature)
        integ = self._integrators.get(t)
        if integ is None:
            integ = GHMCIntegrator(temperature=t,
                                   collision_rate=self.collision_rate,
                                   timestep=self.timestep)
            self._integrators[t] = integ
        return integ


class HMCMove(_MetropolizedIntegratorMove):
    """Hybrid Monte Carlo: fresh velocities each move, then each of
    ``n_steps`` steps is ``n_inner_steps`` of velocity Verlet accepted or
    rejected as one block."""

    def __init__(self, timestep=0.001, n_inner_steps=10, n_steps=1,
                 **kwargs):
        kwargs.setdefault("reassign_velocities", True)
        super().__init__(n_steps, **kwargs)
        self.timestep = timestep
        self.n_inner_steps = n_inner_steps

    def _get_integrator(self, thermodynamic_state):
        t = float(thermodynamic_state.temperature)
        integ = self._integrators.get(t)
        if integ is None:
            inner = " ".join(["V R V"] * self.n_inner_steps)
            integ = LangevinIntegrator(temperature=t, collision_rate=1.0,
                                       timestep=self.timestep,
                                       splitting="{ " + inner + " }")
            self._integrators[t] = integ
        return integ


# ---------------------------------------------------------------------------
# Metropolized configurational moves
# ---------------------------------------------------------------------------


class MetropolizedMove(MCMCMove):
    """Propose, evaluate the reduced potential, accept or reject.

    Subclasses implement ``_draw(generator, like)`` (the proposal's random
    numbers) and ``_propose_positions(draw, sub_positions)`` on the selected
    atom subset, both over any leading batch axes; :meth:`metropolis_batch`
    is the deterministic core, and the single-replica path is its batch of
    one.
    """

    def __init__(self, atom_subset: Optional[Sequence[int]] = None,
                 seed: int = 0):
        super().__init__(seed)
        self.atom_subset = atom_subset
        self.n_accepted = 0
        self.n_proposed = 0

    @property
    def statistics(self):
        return {"n_accepted": self.n_accepted, "n_proposed": self.n_proposed}

    @statistics.setter
    def statistics(self, value):
        self.n_accepted = value["n_accepted"]
        self.n_proposed = value["n_proposed"]

    def _draw(self, generator, like):
        raise NotImplementedError

    def _propose_positions(self, draw, sub_positions):
        raise NotImplementedError

    def _draws(self, generator, like):
        """The proposal's draw, then ln u of the acceptance test."""
        draw = self._draw(generator, like)
        return draw, torch.log(draw_uniform(generator, (), like))

    def metropolis_batch(self, thermodynamic_states, sampler_states, draws,
                         log_u, context_cache=None):
        """B moves given their draws (``draws`` (B, ...) of the proposals,
        ``log_u`` (B,) = ln u of the acceptance tests): the B new sampler
        states and the accept flags, a (B,) tensor. Both reduced potentials
        of every replica, at its own state, come from ONE
        :func:`reduced_potentials` of the 2B configurations."""
        x = torch.stack([ss.positions for ss in sampler_states])
        subset = (torch.arange(x.shape[1], device=x.device)
                  if self.atom_subset is None
                  else torch.as_tensor(self.atom_subset, dtype=torch.int64,
                                       device=x.device))
        x_new = x.clone()
        x_new[:, subset] = self._propose_positions(draws, x[:, subset])
        proposed = [ss.replace(positions=xn)
                    for ss, xn in zip(sampler_states, x_new)]
        b = len(sampler_states)
        u = torch.stack([torch.as_tensor(v) for v in reduced_potentials(
            list(thermodynamic_states) * 2, list(sampler_states) + proposed,
            context_cache)])
        accept = log_u < -(u[b:] - u[:b])
        x_out = torch.where(accept[:, None, None], x_new, x)
        return ([ss.replace(positions=xo)
                 for ss, xo in zip(sampler_states, x_out)], accept)

    def metropolis_step(self, thermodynamic_state, sampler_state, draw,
                        log_u, context_cache=None):
        """One move given its draws (the proposal's ``draw`` and ``log_u``
        = ln u of the acceptance test): the new sampler state and the
        accept flag, a tensor; :meth:`metropolis_batch` of one."""
        out, accept = self.metropolis_batch(
            [thermodynamic_state], [sampler_state], draw[None],
            torch.as_tensor(log_u).reshape(1), context_cache)
        return out[0], accept[0]

    def apply_batch(self, thermodynamic_states, sampler_states, generators,
                    context_cache=None, owners=None) -> list:
        """Each replica draws from its generator, then one
        :meth:`metropolis_batch`; each owner counts its replicas."""
        owners = owners or [self] * len(sampler_states)
        states = [_resolve(ts) for ts in thermodynamic_states]
        draws, log_u = zip(*[self._draws(gen, ss.positions)
                             for gen, ss in zip(generators, sampler_states)])
        out, accept = self.metropolis_batch(
            states, sampler_states, torch.stack(draws), torch.stack(log_u),
            context_cache)
        for owner, a in zip(owners, accept.tolist()):
            owner.n_proposed += 1
            owner.n_accepted += int(a)
        return out

    def batches(self, thermodynamic_state) -> bool:
        return True

    def _apply(self, thermodynamic_state, sampler_state, generator,
               context_cache):
        return self.apply_batch([thermodynamic_state], [sampler_state],
                                [generator], context_cache)[0]


class MCDisplacementMove(MetropolizedMove):
    """Rigid Gaussian translation of the atom subset, ``displacement_sigma``
    nm on each axis; the draw is the displacement vector (3,)."""

    def __init__(self, displacement_sigma=0.1, **kwargs):
        super().__init__(**kwargs)
        self.displacement_sigma = displacement_sigma

    def _draw(self, generator, like):
        return self.displacement_sigma * draw_normal(generator, (3,), like)

    def _propose_positions(self, draw, sub_positions):
        return sub_positions + draw[..., None, :]


class MCRotationMove(MetropolizedMove):
    """Random rigid rotation of the subset about its centroid, uniform over
    SO(3) through a random unit quaternion; the draw is its three
    uniforms."""

    def _draw(self, generator, like):
        return draw_uniform(generator, (3,), like)

    def _propose_positions(self, draw, sub_positions):
        R = self._quat_to_matrix(self._random_quaternion(draw))
        centroid = torch.mean(sub_positions, dim=-2, keepdim=True)
        d = sub_positions - centroid
        # the product written out, so that each row is the same sum of
        # three products whatever the batch
        rotated = torch.stack(
            [d[..., 0] * R[..., None, i, 0] + d[..., 1] * R[..., None, i, 1]
             + d[..., 2] * R[..., None, i, 2] for i in range(3)], dim=-1)
        return rotated + centroid

    @staticmethod
    def _random_quaternion(u):
        a = torch.sqrt(1.0 - u[..., 0])
        b = torch.sqrt(u[..., 0])
        return torch.stack([a * torch.sin(2 * math.pi * u[..., 1]),
                            a * torch.cos(2 * math.pi * u[..., 1]),
                            b * torch.sin(2 * math.pi * u[..., 2]),
                            b * torch.cos(2 * math.pi * u[..., 2])], dim=-1)

    @staticmethod
    def _quat_to_matrix(q):
        x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
        return torch.stack([
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                         2 * (x * z + y * w)], dim=-1),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                         2 * (y * z - x * w)], dim=-1),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                         1 - 2 * (x * x + y * y)], dim=-1),
        ], dim=-2)


class MonteCarloBarostatMove(MetropolizedMove):
    """Isotropic volume-scaling Metropolis move for NPT sampling.

    Each of ``n_attempts`` attempts proposes ln V' = ln V + eps, eps
    uniform in [-volume_scale, volume_scale]: a symmetric walk in ln V.
    Molecule centroids scale with the box and molecules move rigidly, so
    constraints and bond lengths hold (OpenMM's MonteCarloBarostat). The
    acceptance is exp(-beta [dU + p dV] + (N_mol + 1) eps): N_mol ln(V'/V)
    for the centroids' scaling and one more for the ln V measure.

    Molecules are the connected components of the bond, constraint and
    virtual-site graph, found once a system on the host. Both energies of
    an attempt come from the context cache's bound integrator for the state
    (``energies_batch`` of the two configurations), the trial one at the
    scaled box: sweep mode on a water box on the card, with a fresh sort at
    each box. A batch of replicas (:meth:`attempt_batch`) takes each of its
    attempts as one such call of 2B configurations, each replica at its own
    box, trial box and state; the single-replica attempt is its batch of
    one.

    In float32 the translation rounds each atom on its own, and over a run
    of attempts with no dynamics between them that error builds up in the
    rigid geometry. So on a constrained float32 system the trial positions
    are projected onto the constraints by the same bound integrator (SETTLE
    on water), as a step would. In float64 the rounding is negligible and
    the trial is the JAX package's.
    """

    _CACHES = ("_molecules_cache",)

    def __init__(self, volume_scale=0.01, n_attempts=1, **kwargs):
        super().__init__(**kwargs)
        self.volume_scale = volume_scale
        self.n_attempts = int(n_attempts)

    @staticmethod
    def _molecule_ids(system):
        """Connected components of the bonded graph: (ids (N,) int64 on the
        system's device, their count)."""
        n = system.n_particles
        parent = np.arange(n)

        def find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        def union(a, b):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb

        pairs = [term.index for _, term in system.find_terms(HarmonicBondTerm)]
        if system.constraints.n_constraints > 0:
            pairs.append(system.constraints.index)
        for index in pairs:
            for i, j in index.cpu().numpy():
                union(int(i), int(j))
        vs = system.virtual_sites
        if vs is not None and vs.n_sites > 0:
            for s, ps in zip(vs.site.cpu().numpy(), vs.parents.cpu().numpy()):
                for p in ps:
                    union(int(s), int(p))
        roots = np.array([find(i) for i in range(n)])
        _, ids = np.unique(roots, return_inverse=True)
        return (torch.as_tensor(ids, dtype=torch.int64, device=system.device),
                int(ids.max()) + 1 if n else 0)

    def _molecules_for(self, system):
        """The molecule decomposition, cached by the system's content
        hash."""
        key = system.fingerprint
        if key not in self._molecules_cache:
            self._molecules_cache[key] = self._molecule_ids(system)
        return self._molecules_cache[key]

    def attempt_batch(self, thermodynamic_states, sampler_states, eps,
                      log_u, mol_ids, n_molecules, context_cache=None):
        """One volume attempt of B replicas given their draws (``eps`` (B,),
        the ln V steps, and ``log_u`` (B,)): the B new sampler states and
        the accept flags, a (B,) tensor. All 2B energies come from one
        :func:`potential_energies`; a constrained float32 system's trials
        are projected onto the constraints as one batch."""
        states = list(thermodynamic_states)
        b = len(states)
        x = torch.stack([ss.positions for ss in sampler_states])
        box = torch.stack([ss.box_vectors for ss in sampler_states])
        v_old = torch.prod(torch.diagonal(box, dim1=-2, dim2=-1), dim=-1)
        v_new = v_old * torch.exp(eps)
        scale = torch.exp(eps / 3.0)
        box_new = box * scale[:, None, None]
        # rigid molecule translation: x += (scale - 1) centroid[mol]. The
        # sums go through index_put_, which adds a molecule's atoms in
        # index order on the card as on the host, so an attempt gives the
        # same bits every time; index_add_ adds them by atomics there, in
        # an order that varies from run to run
        counts = torch.zeros((n_molecules,), dtype=x.dtype,
                             device=x.device).index_put_(
            (mol_ids,), torch.ones_like(x[0, :, 0]), accumulate=True)
        centers = torch.zeros((n_molecules, b, 3), dtype=x.dtype,
                              device=x.device).index_put_(
            (mol_ids,), x.transpose(0, 1), accumulate=True).transpose(0, 1)
        centers = centers / counts[:, None]
        x_new = x + (scale - 1.0)[:, None, None] * centers[:, mol_ids]
        if (x.dtype == torch.float32
                and states[0].system.constraints.n_constraints):
            x_new = _context(states[0], context_cache)._constrain_positions(
                x_new, x)
        trials = [ss.replace(positions=xn, box_vectors=bn)
                  for ss, xn, bn in zip(sampler_states, x_new, box_new)]
        U = torch.stack(potential_energies(
            states * 2, list(sampler_states) + trials, context_cache))
        beta = torch.as_tensor([ts.beta for ts in states],
                               dtype=torch.float64, device=x.device)
        p = torch.as_tensor([ts.pressure * BAR_TO_KJ_PER_MOL_NM3
                             for ts in states],
                            dtype=torch.float64, device=x.device)
        log_alpha = (-(beta * (U[b:] - U[:b]) + beta * p * (v_new - v_old))
                     + (n_molecules + 1) * eps)
        accept = log_u < log_alpha
        x_out = torch.where(accept[:, None, None], x_new, x)
        box_out = torch.where(accept[:, None, None], box_new, box)
        return [ss.replace(positions=xo, box_vectors=bo)
                for ss, xo, bo in zip(sampler_states, x_out, box_out)], accept

    def attempt(self, thermodynamic_state, sampler_state, eps, log_u,
                mol_ids, n_molecules, context_cache=None):
        """One volume attempt given its draws (``eps``, the ln V step, and
        ``log_u``): the new sampler state and the accept flag, a tensor;
        :meth:`attempt_batch` of one."""
        out, accept = self.attempt_batch(
            [thermodynamic_state], [sampler_state],
            torch.as_tensor(eps).reshape(1), torch.as_tensor(log_u).reshape(1),
            mol_ids, n_molecules, context_cache)
        return out[0], accept[0]

    def _attempt_draws(self, generator, like):
        """An attempt's draws: eps, then ln u."""
        eps = self.volume_scale * (2.0 * draw_uniform(generator, (), like)
                                   - 1.0)
        return eps, torch.log(draw_uniform(generator, (), like))

    def apply_batch(self, thermodynamic_states, sampler_states, generators,
                    context_cache=None, owners=None) -> list:
        """``n_attempts`` attempts, each one :meth:`attempt_batch` of all
        the replicas, each replica drawing from its generator; each owner
        counts its replicas."""
        owners = owners or [self] * len(sampler_states)
        states = [_resolve(ts) for ts in thermodynamic_states]
        if any(ts.pressure is None for ts in states):
            raise MCMCMoveError("MonteCarloBarostatMove requires an NPT state")
        if any(ss.box_vectors is None for ss in sampler_states):
            raise MCMCMoveError("MonteCarloBarostatMove requires periodic "
                                "sampler states (no box vectors present)")
        mol_ids, n_molecules = self._molecules_for(states[0].system)
        n_acc = torch.zeros((len(sampler_states),), dtype=torch.int64,
                            device=sampler_states[0].box_vectors.device)
        for _ in range(self.n_attempts):
            eps, log_u = zip(*[self._attempt_draws(gen, ss.box_vectors)
                               for gen, ss in zip(generators,
                                                  sampler_states)])
            sampler_states, accept = self.attempt_batch(
                states, sampler_states, torch.stack(eps), torch.stack(log_u),
                mol_ids, n_molecules, context_cache)
            n_acc = n_acc + accept.to(torch.int64)
        for owner, a in zip(owners, n_acc.tolist()):
            owner.n_proposed += self.n_attempts
            owner.n_accepted += int(a)
        return sampler_states


# the attributes that say nothing of what a move does: its statistics and
# the seed of its own generator, which a caller's generator replaces
_STATE_ATTRIBUTES = frozenset({"n_accepted", "n_proposed", "seed"})


def _values_equal(a, b) -> bool:
    if isinstance(a, MCMCMove) or isinstance(b, MCMCMove):
        return moves_equal(a, b)
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_values_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, LangevinIntegrator) or isinstance(b, LangevinIntegrator):
        from openmmtools_tpu_torch.cache import _integrator_key

        # the temperature follows the state (IntegratorMove)
        return _integrator_key(a) == _integrator_key(b)
    if isinstance(a, (torch.Tensor, np.ndarray)) or isinstance(
            b, (torch.Tensor, np.ndarray)):
        try:
            return bool(np.array_equal(np.asarray(torch.as_tensor(a).cpu()),
                                       np.asarray(torch.as_tensor(b).cpu())))
        except (TypeError, ValueError, RuntimeError):
            return False
    try:
        return bool(a == b)
    except (TypeError, ValueError, RuntimeError):
        return False


def moves_equal(a: MCMCMove, b: MCMCMove) -> bool:
    """Whether two moves do the same: the same object, or of one class with
    equal parameters, compared all the way down a container's moves (and an
    integrator move's integrator by its settings). Statistics, the move's
    own seed and its caches play no part."""
    if a is b:
        return True
    if type(a) is not type(b):
        return False
    skip = _STATE_ATTRIBUTES | {"_generators"} | set(a._CACHES)
    da = {k: v for k, v in a.__dict__.items() if k not in skip}
    db = {k: v for k, v in b.__dict__.items() if k not in skip}
    return da.keys() == db.keys() and all(
        _values_equal(da[k], db[k]) for k in da)


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------


class MCMCSampler:
    """Single-chain MCMC sampler: holds the current states and applies its
    move."""

    def __init__(self, thermodynamic_state, sampler_state: SamplerState,
                 move: MCMCMove):
        self.thermodynamic_state = thermodynamic_state
        self.sampler_state = sampler_state
        self.move = move

    def run(self, n_iterations: int = 1):
        for _ in range(n_iterations):
            self.sampler_state = self.move.apply(self.thermodynamic_state,
                                                 self.sampler_state)

    def minimize(self, tolerance=1.0, max_iterations=500,
                 context_cache=None):
        from openmmtools_tpu_torch.integrators.minimize import minimize

        self.sampler_state = minimize(
            _resolve(self.thermodynamic_state), self.sampler_state,
            tolerance=tolerance, max_iterations=max_iterations,
            context_cache=context_cache)
