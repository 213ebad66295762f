"""MCMC move framework: moves, containers, the sampler (counterpart of
``mcmc.py``).

openmmtools' contract ``MCMCMove.apply(thermodynamic_state, sampler_state)``
returns the new SamplerState instead of mutating it. Each move owns its
randomness: a ``torch.Generator`` seeded from ``seed``, one for each device
it has seen, made on the device of the sampler state's positions (a CPU
generator cannot drive draws on the card). A move passes its generator to
the integrator state it builds, and a container's moves draw from their
own. The statistics (``n_accepted``/``n_proposed``) are host integers.

The Metropolized moves split into a draw and a deterministic core that
takes the draws as arguments: the displacement vector, the quaternion's
three uniforms, the barostat's ln V step epsilon, and ln u of the
acceptance test. The core takes both energies of an attempt from a bound
integrator that the context cache holds for the state (``cache.py``; the
``context_cache`` of ``apply``, else the global one): its
``energies_at``, which on the card is sweep mode and the sweep kernel for a
large periodic system and K1's force kernel for an LJ fluid, never the
dense O(N^2) sum.

On NaN an integrator move retries up to ``n_restart_attempts`` times, the
last with fresh velocities, then writes the failing state to
``nan-error-logs/`` and raises :class:`IntegratorMoveError`.

An integrator move also applies to many replicas at once
(:meth:`BaseIntegratorMove.apply_batch`): one bound integrator advances
them as one batch, each replica at its own state's temperature and global
parameters and drawing from its own generator (the JAX package's vmap of
the move over replicas). A replica that comes back with NaN is redone by
the single-replica move, from its next attempt on.

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
from openmmtools_tpu_torch.system import volume as box_volume

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


def potential_energies(thermodynamic_state, sampler_states,
                       context_cache=None):
    """U (float64) of each sampler state at the thermodynamic state, each
    at its own box, by the bound integrator that ``context_cache`` (default:
    the global cache) holds for the state: ``energies_at``, the path the
    step program takes (sweep mode and the sweep kernel on a large periodic
    system on the card, K1's force kernel on an LJ fluid there)."""
    bound = _context(thermodynamic_state, context_cache)
    params = thermodynamic_state.global_params
    return [bound.energies_at(ss.positions, ss.box_vectors, [params])[0]
            for ss in sampler_states]


def reduced_potentials(thermodynamic_state, sampler_states,
                       context_cache=None):
    """beta (U + p V - gamma A) of each sampler state, U by
    :func:`potential_energies`."""
    ts = thermodynamic_state
    return [ts.reduced_potential(ss, potential_energy=u) for ss, u in zip(
        sampler_states, potential_energies(ts, sampler_states,
                                           context_cache))]


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

    def _apply(self, thermodynamic_state, sampler_state, generator,
               context_cache):
        for move in self.move_list:
            sampler_state = move.apply(thermodynamic_state, sampler_state,
                                       context_cache=context_cache)
        return sampler_state

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

    def _apply(self, thermodynamic_state, sampler_state, generator,
               context_cache):
        weights = torch.as_tensor([w for _, w in self.move_set],
                                  dtype=torch.float64, device=generator.device)
        idx = int(torch.multinomial(weights / weights.sum(), 1,
                                    generator=generator))
        return self.move_set[idx][0].apply(thermodynamic_state, sampler_state,
                                           context_cache=context_cache)

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

    def apply_batch(self, thermodynamic_states, sampler_states,
                    generators) -> list:
        """Apply the move to B replicas as one batch: replica b at
        ``thermodynamic_states[b]`` (all of one system), drawing from
        ``generators[b]``. One bound integrator (that of the first state)
        serves them all: each replica's kT and global parameters ride in
        the batched state. Returns the B new sampler states. A replica that
        went to NaN is redone alone, by :meth:`apply`'s restarts from the
        second attempt on; the others keep the batch's result."""
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
        if bool(ok.any()):
            keep = torch.nonzero(ok).reshape(-1).to(state.n_accepted.device)
            self._on_integration_end(state.replace(
                n_accepted=state.n_accepted[keep],
                n_proposed=state.n_proposed[keep]))
        for b in torch.nonzero(~ok).reshape(-1).tolist():
            logger.warning("NaN in %s (replica %d of a batch); restarting "
                           "it alone", type(self).__name__, b)
            out[b] = self._attempts(states[b], sampler_states[b],
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
    atom subset; :meth:`metropolis_step` is the deterministic core.
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

    def metropolis_step(self, thermodynamic_state, sampler_state, draw,
                        log_u, context_cache=None):
        """One move given its draws (the proposal's ``draw`` and ``log_u``
        = ln u of the acceptance test): the new sampler state and the
        accept flag, a tensor. Both reduced potentials take U from the
        context cache's bound integrator (``reduced_potentials``)."""
        x = sampler_state.positions
        subset = (torch.arange(x.shape[0], device=x.device)
                  if self.atom_subset is None
                  else torch.as_tensor(self.atom_subset, dtype=torch.int64,
                                       device=x.device))
        x_new = x.index_put((subset,),
                            self._propose_positions(draw, x[subset]))
        proposed = sampler_state.replace(positions=x_new)
        u_old, u_new = reduced_potentials(
            thermodynamic_state, (sampler_state, proposed), context_cache)
        accept = log_u < -(u_new - u_old)
        return (sampler_state.replace(positions=torch.where(accept, x_new, x)),
                accept)

    def _apply(self, thermodynamic_state, sampler_state, generator,
               context_cache):
        x = sampler_state.positions
        draw = self._draw(generator, x)
        log_u = torch.log(draw_uniform(generator, (), x))
        new_ss, accept = self.metropolis_step(thermodynamic_state,
                                              sampler_state, draw, log_u,
                                              context_cache)
        self.n_proposed += 1
        self.n_accepted += int(accept)
        return new_ss


class MCDisplacementMove(MetropolizedMove):
    """Rigid Gaussian translation of the atom subset, ``displacement_sigma``
    nm on each axis; the draw is the displacement vector (3,)."""

    def __init__(self, displacement_sigma=0.1, **kwargs):
        super().__init__(**kwargs)
        self.displacement_sigma = displacement_sigma

    def _draw(self, generator, like):
        return self.displacement_sigma * draw_normal(generator, (3,), like)

    def _propose_positions(self, draw, sub_positions):
        return sub_positions + draw


class MCRotationMove(MetropolizedMove):
    """Random rigid rotation of the subset about its centroid, uniform over
    SO(3) through a random unit quaternion; the draw is its three
    uniforms."""

    def _draw(self, generator, like):
        return draw_uniform(generator, (3,), like)

    def _propose_positions(self, draw, sub_positions):
        R = self._quat_to_matrix(self._random_quaternion(draw))
        centroid = torch.mean(sub_positions, dim=0, keepdim=True)
        return (sub_positions - centroid) @ R.t() + centroid

    @staticmethod
    def _random_quaternion(u):
        a = torch.sqrt(1.0 - u[0])
        b = torch.sqrt(u[0])
        return torch.stack([a * torch.sin(2 * math.pi * u[1]),
                            a * torch.cos(2 * math.pi * u[1]),
                            b * torch.sin(2 * math.pi * u[2]),
                            b * torch.cos(2 * math.pi * u[2])])

    @staticmethod
    def _quat_to_matrix(q):
        x, y, z, w = q[0], q[1], q[2], q[3]
        return torch.stack([
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                         2 * (x * z + y * w)]),
            torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                         2 * (y * z - x * w)]),
            torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                         1 - 2 * (x * x + y * y)]),
        ])


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
    (``energies_at``), the trial one at the scaled box: sweep mode on a
    water box on the card, with a fresh sort at that box.

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

    def attempt(self, thermodynamic_state, sampler_state, eps, log_u,
                mol_ids, n_molecules, context_cache=None):
        """One volume attempt given its draws (``eps``, the ln V step, and
        ``log_u``): the new sampler state and the accept flag, a tensor.
        Both energies come from the context cache's bound integrator
        (``potential_energies``)."""
        ts = thermodynamic_state
        box = sampler_state.box_vectors
        x = sampler_state.positions
        v_old = box_volume(box)
        v_new = v_old * torch.exp(eps)
        scale = torch.exp(eps / 3.0)
        box_new = box * scale
        # rigid molecule translation: x += (scale - 1) centroid[mol]
        counts = torch.zeros((n_molecules,), dtype=x.dtype,
                             device=x.device).index_add_(
            0, mol_ids, torch.ones_like(x[:, 0]))
        centers = torch.zeros((n_molecules, 3), dtype=x.dtype,
                              device=x.device).index_add_(0, mol_ids, x)
        centers = centers / counts[:, None]
        x_new = x + (scale - 1.0) * centers[mol_ids]
        if x.dtype == torch.float32 and ts.system.constraints.n_constraints:
            x_new = _context(ts, context_cache)._constrain_positions(x_new, x)
        u_old, u_new = potential_energies(
            ts, (sampler_state, sampler_state.replace(
                positions=x_new, box_vectors=box_new)), context_cache)
        beta = ts.beta
        p = ts.pressure * BAR_TO_KJ_PER_MOL_NM3
        log_alpha = (-(beta * (u_new - u_old) + beta * p * (v_new - v_old))
                     + (n_molecules + 1) * eps)
        accept = log_u < log_alpha
        return sampler_state.replace(
            positions=torch.where(accept, x_new, x),
            box_vectors=torch.where(accept, box_new, box)), accept

    def _apply(self, thermodynamic_state, sampler_state, generator,
               context_cache):
        ts = thermodynamic_state
        if ts.pressure is None:
            raise MCMCMoveError("MonteCarloBarostatMove requires an NPT state")
        mol_ids, n_molecules = self._molecules_for(ts.system)
        like = sampler_state.box_vectors
        n_acc = torch.zeros((), dtype=torch.int64, device=like.device)
        for _ in range(self.n_attempts):
            eps = self.volume_scale * (2.0 * draw_uniform(generator, (), like)
                                       - 1.0)
            log_u = torch.log(draw_uniform(generator, (), like))
            sampler_state, accept = self.attempt(ts, sampler_state, eps,
                                                 log_u, mol_ids, n_molecules,
                                                 context_cache)
            n_acc = n_acc + accept.to(torch.int64)
        self.n_proposed += self.n_attempts
        self.n_accepted += int(n_acc)
        return sampler_state


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
