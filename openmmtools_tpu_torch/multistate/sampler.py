"""MultiStateSampler: N replicas x K thermodynamic states (counterpart of
``multistate/sampler.py``).

An iteration runs as the reference runs it (multistatesampler.py):

1. mix: the subclass's mixing (replica exchange, SAMS jumps) on the host,
   on CPU tensors, from the N x K energy matrix of the previous iteration;
2. propagate: where every move of every state's tree batches
   (``MCMCMove.batches``: integrator moves whose bound integrator runs the
   package's step program, the displacement, rotation and barostat moves,
   and ``SequenceMove`` and ``WeightedMove`` of such moves) and the states
   share one system, the replicas advance as batches (``propagation_route``
   "batched": the JAX package's move program vmapped over replicas). Within
   each block of replicas on one device, the replicas are grouped by their
   state's move (one object, or trees equal under ``mcmc.moves_equal``)
   and each group runs as one ``apply_batch``: in sweep mode one launch of
   each sweep kernel a force evaluation, and one a Metropolized move or
   barostat attempt, for the whole group. Each replica's statistics go to
   its own state's move. Any other tree (a bound class with its own step,
   a move that implements only ``_apply``) keeps the eager loop ("eager"),
   each replica applying its state's whole tree,
   ``moves[s].apply(state_s, sampler_state_n, generator=...)``. The route
   follows from the moves, fixed before the run;
3. energies: u[n, k] = beta_k (U_k(x_n) + p_k V_n) at the post-move boxes.
   For the sampled states and the unsampled states that share their
   system, U_k comes from ``BoundIntegrator.energies_batch`` of the first
   integrator move's bound integrator, the path its step program takes,
   over every (replica, column) pair at once (in sweep mode one sort of
   each x_n, then ONE launch of each sweep kernel for all pairs); without
   an integrator move, the dense energy. Unsampled states with a system of
   their own are evaluated by the first integrator move's integrator bound
   to their system through the global context cache (``cache.py``), the
   same path on their own system; their own dense ``reduced_potential``
   serves only without an integrator move. A sweep path's
   exclusion-bitfield overflow flags are read once a matrix, an OR over
   the replicas. With ``locality`` only the 2L+1 states around a replica's
   state are evaluated; the rest of its row is +inf. The matrix comes to
   the host once an iteration, in the positions' dtype;
4. NaN check, report, online analysis, timing.

With a ``mesh`` (``create(..., mesh=...)``, a
:class:`~openmmtools_tpu_torch.parallel.ReplicaMesh`) the replicas live on
the mesh's devices in contiguous blocks, and propagation and energies run
block by block, each on its device with the system moved there.

Randomness is a pure function of (rng_seed, iteration): iteration i's
mixing draws come from a CPU ``torch.Generator`` seeded from (rng_seed, i)
and replica n's move from a generator on the replica's device seeded from
(rng_seed, i, n), so a resume from storage continues the stream without
storing any generator state. Every move of a replica's tree draws from
that generator (a ``SequenceMove`` hands it to each of its moves in order,
a ``WeightedMove`` draws its branch from it and hands it on), on either
route and in the same order, so the two routes give the same replicas.

``iterations_per_sync`` > 1 changes when results are reported
(checkpoints and analysis positions at the last iteration of each window,
the stop criterion and timing once a window), never what they are.
"""
from __future__ import annotations

import collections
import logging
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from openmmtools_tpu_torch.constants import BAR_TO_KJ_PER_MOL_NM3, kB
from openmmtools_tpu_torch.integrators.langevin import thermalize_velocities
from openmmtools_tpu_torch.mcmc import (
    BaseIntegratorMove,
    MCMCMove,
    MetropolizedMove,
    SequenceMove,
    WeightedMove,
    _MetropolizedIntegratorMove,
    _resolve,
    moves_equal,
)
from openmmtools_tpu_torch.multistate.mbar import mbar_free_energies
from openmmtools_tpu_torch.multistate.reporter import (
    MultiStateReporter,
    init_parameters,
)
from openmmtools_tpu_torch.multistate.utils import SimulationNaNError
from openmmtools_tpu_torch.parallel.mesh import (
    canonical_device,
    on_device,
    replica_sharding,
)
from openmmtools_tpu_torch.states import (
    SamplerState,
    is_state_compatible,
    stack_thermodynamic_states,
)
from openmmtools_tpu_torch.system import make_energy_fn, refuse_dense, volume

logger = logging.getLogger(__name__)


def derived_seed(*values: int) -> int:
    """A 63-bit generator seed that is a pure function of ``values``."""
    entropy = [int(v) % (1 << 64) for v in values]
    return int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


class _StoredProperty:
    """Validated sampler option, persisted to storage (the reference's
    _StoredProperty descriptors, multistatesampler.py:1225-1260). Each
    assignment runs the validator; ``declared`` collects every declared
    property from the class MRO, so subclasses add options by declaration
    alone."""

    def __init__(self, validator=None, doc=None):
        self._validator = validator
        self.__doc__ = doc

    def __set_name__(self, owner, name):
        self.name = name
        self.attr = "_stored_" + name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return getattr(obj, self.attr)

    def __set__(self, obj, value):
        if self._validator is not None:
            value = self._validator(value, self.name)
        setattr(obj, self.attr, value)

    @staticmethod
    def nonnegative(value, name):
        if value is None or (isinstance(value, float) and math.isinf(value)):
            return value
        if value < 0:
            raise ValueError(f"{name} must be >= 0, got {value!r}")
        return value

    @staticmethod
    def positive_or_none(value, name):
        if value is None:
            return None
        value = int(value)
        if value < 1:
            raise ValueError(f"{name} must be >= 1 or None, got {value!r}")
        return value

    @staticmethod
    def positive_int(value, name):
        value = int(value)
        if value < 1:
            raise ValueError(f"{name} must be >= 1, got {value!r}")
        return value

    @classmethod
    def declared(cls, klass):
        out = {}
        for k in reversed(klass.__mro__):
            for name, attr in vars(k).items():
                if isinstance(attr, cls):
                    out[name] = attr
        return out


def first_integrator_move(move) -> Optional[BaseIntegratorMove]:
    """The first integrator move of a move tree, or None."""
    if isinstance(move, BaseIntegratorMove):
        return move
    children = []
    if isinstance(move, SequenceMove):
        children = move.move_list
    elif isinstance(move, WeightedMove):
        children = [m for m, _ in move.move_set]
    for child in children:
        found = first_integrator_move(child)
        if found is not None:
            return found
    return None


def statistics_leaves(move) -> List[MCMCMove]:
    """The moves of a tree that carry (accepted, proposed) statistics, in
    traversal order: Metropolized integrator moves and Metropolized
    configurational moves (the barostat among them)."""
    if isinstance(move, SequenceMove):
        return [leaf for m in move.move_list for leaf in statistics_leaves(m)]
    if isinstance(move, WeightedMove):
        return [leaf for m, _ in move.move_set
                for leaf in statistics_leaves(m)]
    if isinstance(move, (_MetropolizedIntegratorMove, MetropolizedMove)):
        return [move]
    return []


class MultiStateSampler:
    """Base multistate sampler: propagation and the energy matrix, no
    mixing (subclasses add replica exchange and SAMS jumps).

    Parameters (multistatesampler.py:63): ``mcmc_moves``, one move for all
    states or a list of one a state; ``number_of_iterations``; the online
    MBAR analysis every ``online_analysis_interval`` iterations from
    ``online_analysis_minimum_iterations`` on, stopping the run once the
    error of Delta f(0, K-1) is at most ``online_analysis_target_error``;
    ``locality``; ``rng_seed``; ``iterations_per_sync``.
    """

    number_of_iterations = _StoredProperty(_StoredProperty.nonnegative)
    online_analysis_interval = _StoredProperty(
        _StoredProperty.positive_or_none)
    online_analysis_target_error = _StoredProperty(_StoredProperty.nonnegative)
    online_analysis_minimum_iterations = _StoredProperty(
        _StoredProperty.nonnegative)
    locality = _StoredProperty(_StoredProperty.positive_or_none)
    iterations_per_sync = _StoredProperty(_StoredProperty.positive_int)

    _ONLINE_MAX_SAMPLES = 20000
    # accepted/proposed semantics tag written to storage (None: no mixing)
    _mixing_statistics_scheme: Optional[str] = None

    def __init__(self, mcmc_moves=None, number_of_iterations=1,
                 online_analysis_interval=200,
                 online_analysis_target_error=0.0,
                 online_analysis_minimum_iterations=200,
                 locality=None, rng_seed=0, iterations_per_sync=1):
        self._mcmc_moves = mcmc_moves
        self.number_of_iterations = number_of_iterations
        self.online_analysis_interval = online_analysis_interval
        self.online_analysis_target_error = online_analysis_target_error
        self.online_analysis_minimum_iterations = \
            online_analysis_minimum_iterations
        self.locality = locality
        self._rng_seed = rng_seed
        self.iterations_per_sync = iterations_per_sync

        self._thermodynamic_states = []
        self._unsampled_states = []
        self._unsampled_separate = False
        self._stacked_sampled = None
        self._stacked_states = None
        self._sampler_states: List[SamplerState] = []
        self._replica_states: Optional[torch.Tensor] = None   # (N,) int64
        self._energies: Optional[torch.Tensor] = None         # (N, Ktot)
        self._n_accepted: Optional[torch.Tensor] = None       # (K, K) int64
        self._n_proposed: Optional[torch.Tensor] = None
        self._rng_iteration = 0
        self._iteration = 0
        self._reporter = None
        self._energy_history: List[np.ndarray] = []
        self._state_history: List[np.ndarray] = []
        self._last_err_free_energy = None
        self._online_data: Dict[str, Any] = {}
        self._timing: Dict[str, float] = {}
        self._stats_baseline = None
        self._device_params: Dict[Any, List[Dict[str, torch.Tensor]]] = {}
        self._device_states: Dict[str, List[Any]] = {}
        self._mesh = None
        self._sharding = None
        self.phase_seconds: Dict[str, List[float]] = \
            collections.defaultdict(list)

    # ------------------------------------------------------------------
    # properties
    # ------------------------------------------------------------------
    @property
    def n_replicas(self) -> int:
        return len(self._sampler_states)

    @property
    def n_states(self) -> int:
        return len(self._thermodynamic_states)

    @property
    def iteration(self) -> int:
        return self._iteration

    @property
    def mcmc_moves(self):
        return self._mcmc_moves

    @property
    def sampler_states(self) -> List[SamplerState]:
        return list(self._sampler_states)

    @property
    def replica_states(self) -> np.ndarray:
        return self._replica_states.numpy().copy()

    @property
    def energies_last_iteration(self) -> np.ndarray:
        return self._energies.numpy().copy()

    @property
    def move_statistics(self) -> np.ndarray:
        """(S, 2) (accepted, proposed) totals of the statistics-carrying
        moves, in traversal order, summed over the distinct per-state moves
        (padded to the longest) since ``create``. In memory only."""
        return self._move_stats_now() - self._stats_baseline

    @property
    def is_completed(self) -> bool:
        return self._is_completed(self.number_of_iterations)

    @property
    def mesh(self):
        """The replica mesh given to ``create`` (None: every replica where
        its positions are)."""
        return self._mesh

    @property
    def propagation_route(self) -> str:
        """How an iteration propagates the replicas: "batched" when the
        states share one system and every state's move tree batches
        (``MCMCMove.batches``, asked once a distinct move at the first
        state that takes it), so that the replicas of each group of equal
        moves advance as one batch (``apply_batch``); "eager" otherwise,
        one ``apply`` of the whole tree a replica."""
        moves = self._moves_per_state()
        states = self._thermodynamic_states
        fingerprint = states[0].system.fingerprint
        if not all(ts.system is states[0].system
                   or ts.system.fingerprint == fingerprint for ts in states):
            return "eager"
        first = {}
        for move, ts in zip(moves, states):
            first.setdefault(id(move), (move, ts))
        if all(move.batches(ts) for move, ts in first.values()):
            return "batched"
        return "eager"

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------
    def create(self, thermodynamic_states: Sequence, sampler_states,
               storage=None, initial_thermodynamic_states=None,
               unsampled_thermodynamic_states=None, mesh=None):
        """Bind states and storage, thermalize missing velocities once, and
        take the initial energy matrix (multistatesampler.py:537). With a
        ``mesh`` (:func:`~openmmtools_tpu_torch.parallel.replica_mesh`) the
        replicas are placed on its devices in contiguous blocks (the JAX
        package's replica sharding)."""
        self._mesh = mesh
        self._sharding = (None if mesh is None
                          else replica_sharding(mesh, mesh.axis_name))
        self._device_states = {}
        self._thermodynamic_states = [_resolve(ts)
                                      for ts in thermodynamic_states]
        self._moves_per_state()   # validate the moves now, not at run
        self._unsampled_states = [
            _resolve(ts) for ts in (unsampled_thermodynamic_states or [])]
        sampled0 = self._thermodynamic_states[0]

        def same_system(ts):
            return is_state_compatible(sampled0, ts) and (
                ts.system is sampled0.system
                or ts.system.fingerprint == sampled0.system.fingerprint)

        # unsampled states with a system of their own (expanded-cutoff
        # endpoints) are evaluated by their own bound integrator
        self._unsampled_separate = bool(self._unsampled_states) and not all(
            same_system(ts) for ts in self._unsampled_states)
        self._stacked_sampled = stack_thermodynamic_states(
            self._thermodynamic_states)
        self._stacked_states = (
            self._stacked_sampled if self._unsampled_separate
            else stack_thermodynamic_states(self._thermodynamic_states
                                            + self._unsampled_states))
        self._device_params = {}

        if isinstance(sampler_states, SamplerState):
            sampler_states = [sampler_states]
        sampler_states = list(sampler_states)
        k = len(self._thermodynamic_states)
        n = len(sampler_states)
        # one sampler state serves every replica: one a state, or one for
        # each entry of initial_thermodynamic_states
        n_target = (k if initial_thermodynamic_states is None
                    else len(initial_thermodynamic_states))
        if n == 1 and n_target > 1:
            sampler_states = sampler_states * n_target
            n = n_target
        if initial_thermodynamic_states is None:
            replica_states = np.arange(n) % k
        else:
            replica_states = np.asarray(initial_thermodynamic_states)
            if replica_states.shape != (n,):
                raise ValueError(
                    f"{n} sampler states but initial_thermodynamic_states "
                    f"of length {replica_states.shape[0]}")
        self._replica_states = torch.as_tensor(
            np.asarray(replica_states, dtype=np.int64))

        system = sampled0.system
        dtype = sampler_states[0].positions.dtype
        temps = self._stacked_sampled.temperature
        states = []
        for i, ss in enumerate(sampler_states):
            box = ss.box_vectors
            if box is None and system.default_box is not None:
                box = system.default_box.to(dtype)
            v = ss.velocities
            if v is None:   # thermalized once, at the replica's state
                gen = torch.Generator(device=ss.positions.device).manual_seed(
                    derived_seed(self._rng_seed, i, 0x5EED, 0))
                kT = kB * float(temps[int(self._replica_states[i])])
                v = thermalize_velocities(system.masses, kT, gen, dtype=dtype)
            states.append(SamplerState(positions=ss.positions, velocities=v,
                                       box_vectors=box))
        if mesh is not None:
            for device, idx in self._sharding.blocks(len(states)):
                for i in idx:
                    states[i] = states[i].to(device=device)
        self._n_accepted = torch.zeros((k, k), dtype=torch.int64)
        self._n_proposed = torch.zeros((k, k), dtype=torch.int64)
        self._rng_iteration = 0
        self._iteration = 0
        if isinstance(storage, (str, os.PathLike)):
            storage = MultiStateReporter(os.fspath(storage))
        self._reporter = storage
        self._sampler_states = states
        self._stats_baseline = self._move_stats_now()

        if self._reporter is not None:
            self._reporter.open(mode="w")
            self._reporter.write_thermodynamic_states(
                self._thermodynamic_states, self._unsampled_states)
            self._reporter.write_options(self._stored_options())
            self._reporter.write_mcmc_moves(self._mcmc_moves)
            if self._mixing_statistics_scheme is not None:
                self._reporter.write_mixing_scheme(
                    self._mixing_statistics_scheme)

        # iteration 0: the full matrix, in the positions' dtype (the stored
        # dataset's and the mixing's, which a resume must not change)
        self._energies = self._energy_matrix(windowed=False)
        self._check_nan_energy()
        self._report_iteration()

    def _stored_options(self) -> Dict[str, Any]:
        out = {name: getattr(self, name)
               for name in _StoredProperty.declared(type(self))}
        out["rng_seed"] = self._rng_seed
        return out

    # ------------------------------------------------------------------
    # resume (multistatesampler.py:264)
    # ------------------------------------------------------------------
    @classmethod
    def from_storage(cls, reporter, device="cuda"):
        """Rebuild a sampler from its storage and continue where the last
        checkpoint left it: the systems move to ``device``, the positions,
        velocities and boxes come from the checkpoint (float32), the last
        energy matrix, mixing statistics and online-analysis history from
        the analysis file, and the generators from (rng_seed, iteration)."""
        reporter.open(mode="r")
        options = reporter.read_options()
        moves = reporter.read_mcmc_moves()
        accepted = set(init_parameters(cls)[0]) - {"mcmc_moves", "rng_seed"}
        sampler = cls(mcmc_moves=moves, **{
            k: v for k, v in options.items() if k in accepted})
        sampler._rng_seed = options.get("rng_seed", 0)
        thermo_states, unsampled = reporter.read_thermodynamic_states()
        moved = {}

        def on_device(ts):
            key = id(ts.system)
            if key not in moved:
                moved[key] = ts.system.to(device=device)
            return ts.replace(system=moved[key])

        thermo_states = [on_device(ts) for ts in thermo_states]
        unsampled = [on_device(ts) for ts in unsampled]
        it = reporter.read_last_iteration()
        data = reporter.read_checkpoint(it)

        def tensor(a):
            return torch.as_tensor(np.asarray(a), device=device)

        sampler_states = [
            SamplerState(positions=tensor(data["positions"][i]),
                         velocities=tensor(data["velocities"][i]),
                         box_vectors=(None if data.get("box_vectors") is None
                                      else tensor(data["box_vectors"][i])))
            for i in range(data["positions"].shape[0])]
        replica_states = reporter.read_replica_states(it)
        sampler.create(thermo_states, sampler_states,
                       initial_thermodynamic_states=replica_states,
                       unsampled_thermodynamic_states=unsampled)
        sampler._reporter = reporter
        reporter.open(mode="a")
        sampler._iteration = it
        # the generators continue at the stored counter (equilibrate() runs
        # ahead of the iteration number); older files: the iteration
        sampler._rng_iteration = int(data.get("rng_iteration", it))
        acc, prop = reporter.read_mixing_statistics(it)
        if acc is not None:
            sampler._n_accepted = torch.as_tensor(np.asarray(acc),
                                                  dtype=torch.int64)
            sampler._n_proposed = torch.as_tensor(np.asarray(prop),
                                                  dtype=torch.int64)
        sampler._restore_adaptation(reporter, it)
        # the online-analysis history, and the last energy matrix exactly
        # as stored (create() recomputed it)
        u_all, s_all = reporter.read_energies(slice(0, it + 1))
        u_all = np.asarray(u_all)
        s_all = np.asarray(s_all)
        sampler._energy_history = [u_all[i] for i in range(u_all.shape[0])]
        sampler._state_history = [s_all[i] for i in range(s_all.shape[0])]
        sampler._energies = torch.as_tensor(u_all[it]).to(
            sampler._energies.dtype)
        return sampler

    def _restore_adaptation(self, reporter, iteration):
        """Subclass hook: restore adaptive state (SAMS) from storage."""

    @staticmethod
    def read_status(reporter):
        """Iteration and completion target without rebuilding the sampler
        (multistatesampler.py:308)."""
        reporter.open(mode="r")
        options = reporter.read_options()
        it = reporter.read_last_iteration()
        return {"iteration": it,
                "number_of_iterations": options.get("number_of_iterations")}

    # ------------------------------------------------------------------
    # moves
    # ------------------------------------------------------------------
    def _moves_per_state(self) -> List[MCMCMove]:
        """One move a thermodynamic state: a single move serves all; a list
        must match the state count."""
        k = max(1, len(self._thermodynamic_states))
        moves = self._mcmc_moves
        if not isinstance(moves, (list, tuple)):
            moves = [moves]
        if len(moves) == 1:
            moves = list(moves) * k
        if len(moves) != k:
            raise ValueError(
                "mcmc_moves list length %d != number of thermodynamic "
                "states %d" % (len(moves), k))
        for m in moves:
            if not isinstance(m, MCMCMove):
                raise TypeError(
                    "MultiStateSampler moves must be MCMCMove instances "
                    "(got %r)" % type(m))
        return list(moves)

    def _move_stats_now(self) -> np.ndarray:
        distinct = list({id(m): m for m in self._moves_per_state()}.values())
        rows = [[[leaf.n_accepted, leaf.n_proposed]
                 for leaf in statistics_leaves(m)] for m in distinct]
        s_max = max(len(r) for r in rows)
        total = np.zeros((s_max, 2), dtype=np.int64)
        for r in rows:
            if r:
                total[:len(r)] += np.asarray(r, dtype=np.int64)
        return total

    def _matrix_bound(self, device=None):
        """The bound integrator whose path evaluates the energy matrix: that
        of the first integrator move of state 0's move (on ``device``'s copy
        of the system), or None."""
        move = first_integrator_move(self._moves_per_state()[0])
        if move is None:
            return None
        return move._bound(self._states_on(device)[0])

    def _states_on(self, device=None):
        """The sampled thermodynamic states with their system on
        ``device`` (None: as given), each system moved once."""
        if device is None:
            return self._thermodynamic_states
        device = canonical_device(device)
        key = str(device)
        states = self._device_states.get(key)
        if states is None:
            moved = {}

            def on(ts):
                if ts.system.device == device:
                    return ts
                if id(ts.system) not in moved:
                    moved[id(ts.system)] = ts.system.to(device=device)
                return ts.replace(system=moved[id(ts.system)])

            states = self._device_states[key] = [
                on(ts) for ts in self._thermodynamic_states]
        return states

    def _blocks(self):
        """(device, replica indices) of each block of replicas: the mesh's
        contiguous blocks, else runs of replicas on one device."""
        if self._mesh is not None:
            return [(device, list(idx)) for device, idx
                    in self._sharding.blocks(self.n_replicas)]
        out = []
        for n, ss in enumerate(self._sampler_states):
            device = ss.positions.device
            if out and out[-1][0] == device:
                out[-1][1].append(n)
            else:
                out.append((device, [n]))
        return out

    # ------------------------------------------------------------------
    # one iteration
    # ------------------------------------------------------------------
    def _mix_kernel(self, generator, states, u, n_acc, n_prop):
        """Subclass hook: (states, n_acc, n_prop) after mixing; None means
        no mixing."""
        return None

    def _advance(self):
        """Mix, propagate and take the energy matrix; the generator counter
        advances by one."""
        i = self._rng_iteration
        t0 = time.perf_counter()
        mixed = self._mix_kernel(
            torch.Generator().manual_seed(derived_seed(self._rng_seed, i)),
            self._replica_states, self._energies, self._n_accepted,
            self._n_proposed)
        if mixed is not None:
            (self._replica_states, self._n_accepted,
             self._n_proposed) = mixed
        t1 = time.perf_counter()
        moves = self._moves_per_state()
        propagated = list(self._sampler_states)
        batched = self.propagation_route == "batched"
        for device, idx in self._blocks():
            states = self._states_on(device)
            gens = [torch.Generator(device=device).manual_seed(
                derived_seed(self._rng_seed, i, n)) for n in idx]
            s_of = [int(self._replica_states[n]) for n in idx]
            with on_device(device):
                if batched:
                    out = self._propagate_groups(
                        moves, [states[s] for s in s_of],
                        [self._sampler_states[n] for n in idx], gens, s_of)
                else:
                    out = [moves[s].apply(states[s], self._sampler_states[n],
                                          generator=gen)
                           for n, s, gen in zip(idx, s_of, gens)]
            for n, ss in zip(idx, out):
                propagated[n] = ss
        self._sampler_states = propagated
        t2 = time.perf_counter()
        self._energies = self._energy_matrix(windowed=True)
        t3 = time.perf_counter()
        self._rng_iteration = i + 1
        self.phase_seconds["mixing"].append(t1 - t0)
        self.phase_seconds["propagation"].append(t2 - t1)
        self.phase_seconds["energy_matrix"].append(t3 - t2)

    @staticmethod
    def move_groups(moves, s_of) -> List[List[int]]:
        """The replicas of a block (``s_of``, each one's state) grouped by
        their state's move: positions in ``s_of``, a group for each move
        tree not equal (``moves_equal``) to an earlier group's, in order of
        first appearance."""
        reps: List[MCMCMove] = []
        groups: List[List[int]] = []
        of_state: Dict[int, int] = {}
        for j, s in enumerate(s_of):
            g = of_state.get(s)
            if g is None:
                g = next((i for i, m in enumerate(reps)
                          if moves_equal(m, moves[s])), None)
                if g is None:
                    reps.append(moves[s])
                    groups.append([])
                    g = len(reps) - 1
                of_state[s] = g
            groups[g].append(j)
        return groups

    def _propagate_groups(self, moves, states, sampler_states, gens, s_of):
        """The batched route for a block: one ``apply_batch`` a group of
        equal moves (:meth:`move_groups`), by the group's first move, each
        replica's statistics counted on its own state's move."""
        out = list(sampler_states)
        for group in self.move_groups(moves, s_of):
            move = moves[s_of[group[0]]]
            new = move.apply_batch(
                [states[j] for j in group], [sampler_states[j] for j in group],
                [gens[j] for j in group],
                owners=[moves[s_of[j]] for j in group])
            for j, ss in zip(group, new):
                out[j] = ss
        return out

    # ------------------------------------------------------------------
    # the energy matrix
    # ------------------------------------------------------------------
    def _params_on(self, device, dtype):
        """Each stacked state's global parameters as 0-d tensors on
        ``device`` (made once: no host-to-device copy an evaluation)."""
        key = (device, dtype)
        if key not in self._device_params:
            stacked = self._stacked_states
            self._device_params[key] = [
                {name: v[k].to(device=device, dtype=dtype)
                 for name, v in stacked.global_params.items()}
                for k in range(stacked.n_states)]
        return self._device_params[key]

    def _param_table(self, device, dtype):
        """Each global parameter of the stacked states as one (Ktot,)
        tensor on ``device`` (made once)."""
        key = ("table", device, dtype)
        if key not in self._device_params:
            self._device_params[key] = {
                name: v.to(device=device, dtype=dtype)
                for name, v in self._stacked_states.global_params.items()}
        return self._device_params[key]

    def _block_potentials(self, device, replicas: List[int],
                          cols_of: List[List[int]], windowed: bool):
        """(U, overflow) of a block of replicas on ``device``: U a list of
        (len(cols),) float64 tensors, one a replica, at the stacked states
        of its columns; ``overflow`` the sweep path's exclusion-bitfield
        flag (a device bool, None off sweep mode), which the matrix checks
        once for all replicas. By the bound integrator's path, every
        (replica, column) pair of the block in one batch
        (``energies_batch``), or, without an integrator move, the dense
        energy of each pair."""
        sss = [self._sampler_states[n] for n in replicas]
        x = torch.stack([ss.positions for ss in sss])
        boxes = [ss.box_vectors for ss in sss]
        box = None if boxes[0] is None else torch.stack(boxes)
        bound = self._matrix_bound(device)
        if bound is None:
            system = self._states_on(device)[0].system
            refuse_dense(system, x, "the energy matrix without an "
                         "integrator move")
            u_fn = make_energy_fn(system)
            params = self._params_on(x.device, x.dtype)
            return [torch.stack([
                u_fn(ss.positions, ss.box_vectors, params[c]).to(
                    torch.float64) for c in cols])
                for ss, cols in zip(sss, cols_of)], None
        rep = torch.as_tensor([j for j, cols in enumerate(cols_of)
                               for _ in cols], device=x.device)
        cols = torch.as_tensor([c for cols in cols_of for c in cols],
                               device=x.device)
        params = {k: v[cols] for k, v in
                  self._param_table(x.device, x.dtype).items()}
        U, overflow = bound.energies_batch(x, box, rep, params)
        return list(torch.split(U, [len(c) for c in cols_of])), overflow

    def _unsampled_bound(self, thermodynamic_state):
        """The bound integrator that evaluates an unsampled state with a
        system of its own: the first integrator move's integrator (its
        class and settings), bound to that state's system through the
        global context cache; None without an integrator move."""
        from openmmtools_tpu_torch.cache import global_context_cache

        move = first_integrator_move(self._moves_per_state()[0])
        if move is None:
            return None
        integrator = move._get_integrator(self._thermodynamic_states[0])
        bound, _ = global_context_cache.get_context(thermodynamic_state,
                                                    integrator)
        return bound

    def _unsampled_potentials(self, ss: SamplerState):
        """[(u (1,) float64, overflow, bound)] of one configuration at each
        unsampled state with a system of its own: the reduced potential by
        that state's bound integrator (``_unsampled_bound``) or, without
        an integrator move, by its own dense ``reduced_potential``."""
        out = []
        for ts in self._unsampled_states:
            bound = self._unsampled_bound(ts)
            U = flag = None
            if bound is not None:
                U, flag = bound.energies_and_overflow_at(
                    ss.positions, ss.box_vectors, [ts.global_params])
                U = U[0]
            u = torch.as_tensor(ts.reduced_potential(ss, potential_energy=U))
            out.append((u.to(torch.float64).reshape(1), flag, bound))
        return out

    def _columns(self, state_index: int, windowed: bool) -> List[int]:
        """The stacked states a replica at ``state_index`` evaluates: all,
        or under ``locality`` its window of sampled states and every
        unsampled one that shares their system."""
        k = len(self._thermodynamic_states)
        k_stack = self._stacked_states.n_states
        if not windowed or self.locality is None:
            return list(range(k_stack))
        window = 2 * int(self.locality) + 1
        start = min(max(state_index - int(self.locality), 0),
                    max(0, k - window))
        return list(range(start, min(start + window, k))) + list(
            range(k, k_stack))

    def _energy_matrix(self, windowed: bool) -> torch.Tensor:
        """u (N, Ktot) on the host in the positions' dtype. Each replica's
        potentials (and volume, and reduced potentials at the unsampled
        states with a system of their own) stay on its device until one
        copy brings them all to the host."""
        stacked = self._stacked_states
        cols_of = [self._columns(int(s), windowed)
                   for s in self._replica_states]
        potentials, flags = [None] * self.n_replicas, []
        with torch.no_grad():
            for device, idx in self._blocks():
                with on_device(device):
                    U, flag = self._block_potentials(
                        device, idx, [cols_of[n] for n in idx], windowed)
                flags.append((flag, self._matrix_bound(device)))
                for n, u in zip(idx, U):
                    potentials[n] = u
            parts = []
            for ss, u in zip(self._sampler_states, potentials):
                parts.append(u)
                if stacked.pressure is not None:
                    parts.append(volume(ss.box_vectors).to(
                        torch.float64).reshape(1))
                if self._unsampled_separate:
                    for u, flag, bound in self._unsampled_potentials(ss):
                        parts.append(u)
                        flags.append((flag, bound))
        flags = [(f, b) for f, b in flags if f is not None]
        if flags:
            # the replicas' overflow flags, read once for the matrix
            flags[0][1].check_sweep_overflow(
                torch.stack([f.to(flags[0][0].device)
                             for f, _ in flags]).any())
        flat = torch.cat([p.to(parts[0].device) for p in parts]).cpu()
        n_uns = len(self._unsampled_states) if self._unsampled_separate else 0
        rows, at = [], 0
        for cols in cols_of:
            idx = torch.as_tensor(cols)
            U = flat[at:at + len(cols)]
            at += len(cols)
            if stacked.pressure is not None:
                U = U + stacked.pressure[idx] * BAR_TO_KJ_PER_MOL_NM3 \
                    * flat[at]
                at += 1
            row = torch.full((stacked.n_states,), float("inf"),
                             dtype=torch.float64)
            row[idx] = stacked.beta[idx] * U
            rows.append(torch.cat([row, flat[at:at + n_uns]]))
            at += n_uns
        dtype = self._sampler_states[0].positions.dtype
        return torch.stack(rows).to(dtype)

    # ------------------------------------------------------------------
    # run loop
    # ------------------------------------------------------------------
    def run(self, n_iterations: Optional[int] = None):
        """Advance the sampler (multistatesampler.py:724)."""
        iteration_limit = self.number_of_iterations
        if n_iterations is not None:
            iteration_limit = min(self._iteration + n_iterations,
                                  self.number_of_iterations)
        while not self._is_completed(iteration_limit):
            t0 = time.perf_counter()
            k = min(max(1, self.iterations_per_sync),
                    iteration_limit - self._iteration)
            for i in range(k):
                self._iteration += 1
                self._advance()
                self._after_iteration()
                t_report = time.perf_counter()
                u = self.energies_last_iteration
                s = self.replica_states
                self._check_nan_energy(u, s)
                self._report_iteration(u, s, allow_checkpoint=(i == k - 1))
                self._after_report()
                self._update_analysis()
                self.phase_seconds["reporting"].append(
                    time.perf_counter() - t_report)
            self._update_timing((time.perf_counter() - t0) / k)

    def _after_iteration(self):
        """Subclass hook after an iteration's energies (SAMS adapts)."""

    def _after_report(self):
        """Subclass hook after an iteration's report (SAMS writes)."""

    def extend(self, n_iterations: int):
        """Extend past number_of_iterations."""
        if self._iteration >= self.number_of_iterations:
            self.number_of_iterations += n_iterations
        self.run(n_iterations)

    def equilibrate(self, n_iterations: int, mcmc_moves=None):
        """Equilibrate all replicas (multistatesampler.py:649): whole
        iterations that do not advance the iteration counter and are not
        stored. ``mcmc_moves`` substitutes other moves (one, or one a
        state) for these iterations."""
        if self._energies is None:
            raise RuntimeError("Cannot equilibrate replicas. The simulation "
                               "must be created first.")
        production_moves = self._mcmc_moves
        if mcmc_moves is not None:
            n_states = len(self._thermodynamic_states)
            if not isinstance(mcmc_moves, (list, tuple)):
                mcmc_moves = [mcmc_moves]
            if len(mcmc_moves) not in (1, n_states):
                raise RuntimeError(
                    "The number of MCMCMoves (%d) and ThermodynamicStates "
                    "(%d) for equilibration must be the same."
                    % (len(mcmc_moves), n_states))
            self._mcmc_moves = list(mcmc_moves)
        try:
            for _ in range(n_iterations):
                self._advance()
            self._check_nan_energy()
        finally:
            self._mcmc_moves = production_moves

    def minimize(self, tolerance=1.0, max_iterations=500):
        """FIRE-minimize every replica at its state's parameters
        (multistatesampler.py:1351), with the bound integrator's forces
        (sweep mode on a large system) and, on a constrained system, its
        constraint projection each step; the replicas stay as they were if
        any result is not finite."""
        from openmmtools_tpu_torch.integrators.minimize import fire_minimize

        out = []
        for ss, s in zip(self._sampler_states, self._replica_states):
            x, box = ss.positions, ss.box_vectors
            system = self._states_on(x.device)[0].system
            bound = self._matrix_bound(x.device)
            params = self._params_on(x.device, x.dtype)[int(s)]
            energy_forces = constrain = None
            if bound is not None:
                def energy_forces(xx, _box=box, _params=params):
                    return bound.energy_forces_at(xx, _box, _params)
                if system.constraints.n_constraints > 0:
                    constrain = bound._constrain_positions
            else:
                refuse_dense(system, x, "minimization without an integrator "
                             "move")
            with on_device(x.device):
                x_min, _ = fire_minimize(system, x, box, params,
                                         max_steps=max_iterations,
                                         energy_forces=energy_forces,
                                         constrain=constrain)
            out.append(x_min)
        if not all(bool(torch.isfinite(x).all()) for x in out):
            logger.warning("minimization produced non-finite positions; "
                           "keeping original replicas")
            return
        self._sampler_states = [ss.replace(positions=x) for ss, x
                                in zip(self._sampler_states, out)]
        self._energies = self._energy_matrix(windowed=False)

    # ------------------------------------------------------------------
    # bookkeeping
    # ------------------------------------------------------------------
    def _check_nan_energy(self, u=None, s=None):
        """Fail on a non-finite energy at a replica's own state
        (multistatesampler.py:1049)."""
        if u is None:
            u = self.energies_last_iteration
        if s is None:
            s = self.replica_states
        sampled = u[np.arange(u.shape[0]), s]
        nan_replicas = np.where(~np.isfinite(sampled))[0]
        if nan_replicas.size:
            raise SimulationNaNError(
                f"NaN energy for replicas {nan_replicas.tolist()} at "
                f"iteration {self._iteration}")

    def _neighborhoods(self, u, s):
        """(replica, state) mask of the energies computed this iteration
        under ``locality`` (the reporter's 'neighborhoods'): each replica's
        columns, the unsampled states of their own system, and any finite
        entry."""
        nb = np.isfinite(u)
        nb[:, self._stacked_states.n_states:] = True
        for n, state_index in enumerate(s):
            nb[n, self._columns(int(state_index), windowed=True)] = True
        return nb

    def _report_iteration(self, u=None, s=None, allow_checkpoint=True):
        if u is None:
            u = self.energies_last_iteration
        if s is None:
            s = self.replica_states
        self._energy_history.append(u.copy())
        self._state_history.append(s.copy())
        if self._reporter is None:
            return
        analysis_positions = analysis_velocities = None
        idx = getattr(self._reporter, "analysis_particle_indices", None)
        if idx is not None and len(idx) and allow_checkpoint:
            idx = torch.as_tensor(np.asarray(idx))
            analysis_positions = np.stack([
                ss.positions[idx.to(ss.positions.device)].cpu().numpy()
                for ss in self._sampler_states])
            if getattr(self._reporter, "analysis_velocities", False):
                analysis_velocities = np.stack([
                    ss.velocities[idx.to(ss.velocities.device)].cpu().numpy()
                    for ss in self._sampler_states])
        neighborhoods = (None if self.locality is None
                         else self._neighborhoods(u, s))
        self._reporter.write_iteration(
            iteration=self._iteration, energies=u, replica_states=s,
            n_accepted=self._n_accepted.numpy(),
            n_proposed=self._n_proposed.numpy(),
            analysis_positions=analysis_positions,
            analysis_velocities=analysis_velocities,
            neighborhoods=neighborhoods)
        if allow_checkpoint and \
                self._iteration % self._checkpoint_interval() == 0:
            boxes = [ss.box_vectors for ss in self._sampler_states]
            self._reporter.write_checkpoint(
                iteration=self._iteration,
                positions=np.stack([ss.positions.cpu().numpy()
                                    for ss in self._sampler_states]),
                velocities=np.stack([ss.velocities.cpu().numpy()
                                     for ss in self._sampler_states]),
                box_vectors=(None if boxes[0] is None else
                             np.stack([b.cpu().numpy() for b in boxes])),
                rng_iteration=self._rng_iteration)
        self._reporter.write_last_iteration(self._iteration)

    def _checkpoint_interval(self) -> int:
        if self._reporter is not None:
            return getattr(self._reporter, "checkpoint_interval", 50)
        return 50

    def _update_analysis(self):
        """Online free-energy estimate and the stop criterion
        (multistatesampler.py:1526-1694); off under locality, whose matrix
        is not MBAR-complete."""
        interval = self.online_analysis_interval
        if interval is None or self._iteration % interval != 0:
            return
        if self.locality is not None:
            if not getattr(self, "_warned_locality_analysis", False):
                logger.warning(
                    "online analysis is disabled when locality is set: the "
                    "windowed energy matrix is not MBAR-complete; run the "
                    "offline analyzer on the stored energies instead")
                self._warned_locality_analysis = True
            return
        if self._iteration < self.online_analysis_minimum_iterations:
            return
        try:
            f, df = self._online_free_energy()
        except Exception as e:  # analysis failures are logged, not fatal
            logger.warning("online analysis failed: %s", e)
            return
        self._last_err_free_energy = df
        self._online_data = {"iteration": self._iteration,
                             "f_k": f, "err_free_energy": df}
        if self._reporter is not None:
            self._reporter.write_online_analysis(self._iteration, f, df)

    def _online_free_energy(self) -> Tuple[np.ndarray, float]:
        """MBAR over the accumulated energies, stride-subsampled to at most
        _ONLINE_MAX_SAMPLES rows and warm-started from the last estimate."""
        k = self.n_states
        k_total = k + len(self._unsampled_states)
        u_all = np.concatenate(self._energy_history, axis=0)
        s_all = np.concatenate(self._state_history, axis=0)
        if u_all.shape[0] > self._ONLINE_MAX_SAMPLES:
            stride = -(-u_all.shape[0] // self._ONLINE_MAX_SAMPLES)
            u_all = u_all[::stride]
            s_all = s_all[::stride]
        n_k = np.bincount(s_all, minlength=k).astype(np.float64)
        if k_total != k:
            n_k = np.concatenate([n_k, np.zeros(k_total - k)])
        f_init = None
        if len(self._online_data.get("f_k", ())) == k_total:
            f_init = np.asarray(self._online_data["f_k"])
        result = mbar_free_energies(u_all.T, n_k, f_init=f_init)
        f = result.free_energies.numpy()
        df = float(result.delta_f(0, k - 1)[1])
        return f, df

    def _is_completed(self, iteration_limit) -> bool:
        if self._iteration >= iteration_limit:
            return True
        if (self.online_analysis_target_error > 0
                and self._last_err_free_energy is not None
                and self._last_err_free_energy
                <= self.online_analysis_target_error):
            logger.info("online error target reached at iteration %d",
                        self._iteration)
            return True
        return False

    def _update_timing(self, iteration_seconds: float):
        """Seconds an iteration and the ns/day of one replica
        (multistatesampler.py:1766)."""
        self._timing["iteration_seconds"] = iteration_seconds
        move = first_integrator_move(self._moves_per_state()[0])
        if move is not None:
            integ = move._get_integrator(self._thermodynamic_states[0])
            ps_per_iter = move.n_steps * integ.timestep
            self._timing["ns_per_day"] = (
                ps_per_iter / 1000.0) / iteration_seconds * 86400.0
        remaining = self.number_of_iterations - self._iteration
        self._timing["estimated_time_remaining_seconds"] = (
            remaining * iteration_seconds)
        if self._reporter is not None:
            self._reporter.write_timing(self._iteration, dict(self._timing))
