"""Langevin splitting integrators (counterpart of ``integrators/langevin.py``).

The operator-splitting language of openmmtools' ``LangevinIntegrator``:

* ``R``      position drift x += (dt/n_R) v
* ``V``      full-force kick; ``V0``..``V31`` per-force-group kicks (MTS)
* ``O``      Ornstein–Uhlenbeck: v = a v + b sqrt(kT/m) xi with
             a = exp(-gamma h), b = sqrt(1 - a^2)
* ``{ ... }`` Metropolization of the enclosed deterministic substeps (GHMC)

``BoundIntegrator`` owns the step program (a splitting turned into
substeps over tensors, run eagerly by ``run(state, n_steps)``), the state
constructors and the CUDA-graph policy. It evaluates forces through its
``force_path``, chosen once at bind time
(:mod:`openmmtools_tpu_torch.integrators.force_paths`: K1's fused kernel,
K2's bounded sweep, a neighbour list or the dense program), and projects
constraints through its ``constraint_solver``
(:class:`openmmtools_tpu_torch.ops.constraints.ConstraintSolver`).

On the card, a step on a ``graphable`` path (the sweep path), batched or
not, is replayed as one CUDA graph
(:mod:`openmmtools_tpu_torch.integrators.step_graph`) where it holds no
host decision (no H step, no ``_pre_step`` hook, no Jacobi SHAKE/RATTLE):
captured at a bound integrator's first ``run`` of a state's shapes, after
that run's first step ran eagerly. Everything else, and everything on the
CPU, runs the step eagerly.

Replicas as one batched axis (the JAX package's ``jax.vmap`` of the step
program over replicas): :meth:`BoundIntegrator.initial_state_batch` stacks
B configurations into one state whose tensors carry a leading axis (kT,
box and each global parameter one a replica, the generators a tuple), and
the same step program advances them together, the force path and the
constraint solver each taking the batch as they can; a ``per_replica``
path (K1, the neighbour list) advances one replica at a time.
:meth:`BoundIntegrator.energies_batch` evaluates B (configuration,
parameters) pairs, the multistate energy matrix, the same way.

Noise comes from the ``torch.Generator`` the caller hands to
``initial_state``; the state carries it and each run advances it. The H
token (alchemical perturbation) belongs to the nonequilibrium integrators of
:mod:`openmmtools_tpu_torch.integrators.nonequilibrium`, which use the
``_pre_step`` hook and the ``lambda_``/``lambda_step`` fields of the state.

"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from openmmtools_tpu_torch.constants import kB
from openmmtools_tpu_torch.integrators import force_paths, step_graph
from openmmtools_tpu_torch.integrators.force_paths import IntegratorError
from openmmtools_tpu_torch.ops import constraints
from openmmtools_tpu_torch.ops.fused_langevin import brings_own_step
from openmmtools_tpu_torch.states import SamplerState, ThermodynamicState
from openmmtools_tpu_torch.system import (  # noqa: F401
    System,
    value_and_grad,   # the neighbour path calls it through this module
)
from openmmtools_tpu_torch.utils import tracing
from openmmtools_tpu_torch.utils.pytree import static_field, tensor_dataclass


logger = logging.getLogger(__name__)


_MAX_GROUPS = 32


def parse_splitting(splitting: str) -> List[str]:
    """Tokenize and validate a splitting string.

    Tokens are R, O, V, V0..V31, {, } (and H for the nonequilibrium
    integrators); braces must match, not nest, and may not contain O (the
    Metropolized block must be deterministic); bare V and numbered Vn may not
    be mixed.
    """
    tokens = splitting.upper().split()
    if not tokens:
        raise IntegratorError("empty splitting string")
    depth = 0
    seen_block = False
    has_bare_v = False
    has_numbered_v = False
    for tok in tokens:
        if tok == "{":
            if depth:
                raise IntegratorError("nested Metropolization blocks")
            if seen_block:
                raise IntegratorError("only one Metropolization block allowed")
            depth += 1
            seen_block = True
        elif tok == "}":
            if not depth:
                raise IntegratorError("unmatched '}'")
            depth -= 1
        elif tok == "R":
            pass
        elif tok == "O":
            if depth:
                raise IntegratorError("O step inside Metropolization block")
        elif tok == "V":
            has_bare_v = True
        elif tok.startswith("V") and tok[1:].isdigit():
            g = int(tok[1:])
            if not 0 <= g < _MAX_GROUPS:
                raise IntegratorError(f"force group {g} out of range")
            has_numbered_v = True
        elif tok == "H":
            pass  # alchemical perturbation (nonequilibrium subclasses)
        else:
            raise IntegratorError(f"unknown splitting token {tok!r}")
    if depth:
        raise IntegratorError("unmatched '{'")
    if has_bare_v and has_numbered_v:
        raise IntegratorError("cannot mix bare V with numbered Vn tokens")
    return tokens


@tensor_dataclass
class IntegratorState:
    """Carried state of an integrator: positions, velocities, kT, box, the
    per-force-group force/energy caches, work/heat bookkeeping and GHMC
    counters, the nonequilibrium protocol's ``lambda_`` (a tensor) and
    ``lambda_step`` (its H-step counter, an int like ``step_count``), and
    in sweep mode the sweep state (None otherwise). ``generator`` is the
    noise source (advanced in place)."""

    positions: torch.Tensor
    velocities: torch.Tensor
    kT: torch.Tensor
    box: Optional[torch.Tensor] = None
    global_params: Dict[str, Any] = None
    forces: Tuple[torch.Tensor, ...] = ()
    potentials: Tuple[torch.Tensor, ...] = ()
    heat: Any = 0.0
    shadow_work: Any = 0.0
    protocol_work: Any = 0.0
    n_accepted: Any = 0
    n_proposed: Any = 0
    lambda_: Any = 0.0
    lambda_step: int = 0
    step_count: int = 0
    # neighbour-list state (None when neighbour mode is off)
    nbr_idx: Optional[torch.Tensor] = None       # (N, k_max) int32
    nbr_mask: Optional[torch.Tensor] = None      # (N, k_max) bool
    nbr_overflow: Optional[torch.Tensor] = None  # () bool, sticky
    nbr_at: Optional[torch.Tensor] = None        # the positions it was built at
    # bounded-sweep state (ops/sweep_nb.py; None when sweep mode is off)
    sweep_perm: Optional[torch.Tensor] = None   # (N,) sorted slot -> atom
    sweep_inv: Optional[torch.Tensor] = None    # (N,) atom -> sorted slot
    sweep_snap: Optional[torch.Tensor] = None   # (N, 3) sorted coords at rebuild
    sweep_nblk: Optional[torch.Tensor] = None   # () int32; -1 forces a rebuild
    sweep_excl: Optional[torch.Tensor] = None   # (mask_rows, n_pad) int32
    sweep_par: Optional[torch.Tensor] = None    # (n_par, n_pad) sorted parameters
    sweep_overflow: Optional[torch.Tensor] = None  # () bool, sticky
    # the noise source; a tuple of one generator a replica in a batch
    generator: Any = static_field(default=None)

    @property
    def temperature(self):
        return self.kT / kB


def _draw(sample, generator, shape, like):
    """``sample`` (``torch.rand`` or ``torch.randn``) of ``like``'s dtype,
    drawn on the generator's device and moved to ``like``'s. A tuple of
    generators (a batch) draws row b of ``shape`` from generator b."""
    if isinstance(generator, (tuple, list)):
        return torch.stack([_draw(sample, g, shape[1:], like)
                            for g in generator])
    return sample(shape, generator=generator, dtype=like.dtype,
                  device=generator.device).to(like.device)


def draw_uniform(generator, shape, like):
    """Uniforms in [0, 1) (:func:`_draw`)."""
    return _draw(torch.rand, generator, shape, like)


def draw_normal(generator, shape, like):
    """Standard normals (:func:`_draw`): one draw a replica."""
    return _draw(torch.randn, generator, shape, like)


def stack_states(states):
    """One batched IntegratorState of single states (every tensor stacked
    on a new leading axis, the generators a tuple); the integer counters
    must agree."""
    out = {}
    for f in dataclasses.fields(IntegratorState):
        vals = [getattr(s, f.name) for s in states]
        first = vals[0]
        if f.name == "generator":
            out[f.name] = tuple(vals)
        elif isinstance(first, torch.Tensor):
            out[f.name] = torch.stack(vals)
        elif isinstance(first, tuple):
            out[f.name] = tuple(torch.stack(c) for c in zip(*vals))
        elif isinstance(first, dict):
            out[f.name] = {k: torch.stack([torch.as_tensor(v[k])
                                           for v in vals]) for k in first}
        else:
            if any(v != first for v in vals):
                raise IntegratorError(f"replicas disagree on {f.name}")
            out[f.name] = first
    return IntegratorState(**out)


def unstack_states(state):
    """The single states of a batched IntegratorState, in order."""
    n = state.positions.shape[0]
    out = []
    for b in range(n):
        fields = {}
        for f in dataclasses.fields(IntegratorState):
            v = getattr(state, f.name)
            if f.name == "generator":
                v = v[b]
            elif isinstance(v, torch.Tensor):
                v = v[b]
            elif isinstance(v, tuple):
                v = tuple(t[b] for t in v)
            elif isinstance(v, dict):
                v = {k: t[b] for k, t in v.items()}
            fields[f.name] = v
        out.append(IntegratorState(**fields))
    return out


def thermalize_velocities(masses, kT, generator, dtype=torch.float32):
    """Draw Maxwell–Boltzmann velocities (massless particles get 0)."""
    n = masses.shape[0]
    sigma = torch.where(masses > 0,
                        torch.sqrt(kT / torch.clamp(masses, min=1e-30)), 0.0)
    noise = torch.randn((n, 3), generator=generator, dtype=dtype,
                        device=generator.device).to(masses.device)
    return noise * sigma[:, None].to(dtype)


class _Env:
    """Mutable environment threaded through the substep emitters: the
    state's fields, the per-group caches ``U`` and ``F`` (None where
    stale), the force path's context and the Metropolis block's stash."""

    def __init__(self, state, groups, ctx):
        self.x, self.v = state.positions, state.velocities
        self.generator, self.kT = state.generator, state.kT
        self.box, self.params = state.box, state.global_params
        cached = len(state.forces) == len(groups)
        self.F: Dict[Any, Any] = {}
        self.U: Dict[Any, Any] = {}
        for i, g in enumerate(groups):
            self.F[g] = state.forces[i] if cached else None
            self.U[g] = state.potentials[i] if cached else None
        self.heat, self.shadow_work = state.heat, state.shadow_work
        self.protocol_work = state.protocol_work
        self.n_accepted, self.n_proposed = state.n_accepted, state.n_proposed
        self.lambda_, self.lambda_step = state.lambda_, state.lambda_step
        self.step_count = state.step_count
        self.ctx = ctx
        self.stash = None


class BoundIntegrator:
    """An integrator bound to a specific System: the step program and the
    state constructors (OpenMM Context creation, minus the device), over
    the force path and the constraint solver chosen here once."""

    def __init__(self, integrator: "LangevinIntegrator", system: System):
        self.integrator = integrator
        self.system = system
        self.masses = system.masses
        self.inv_mass = torch.where(
            system.masses > 0, 1.0 / torch.clamp(system.masses, min=1e-30), 0.0)
        self.tokens = parse_splitting(integrator.splitting)

        numbered = sorted({int(t[1:]) for t in self.tokens
                           if t.startswith("V") and len(t) > 1})
        self.groups: List[Any] = numbered if numbered else [None]

        self.n_R = max(1, self.tokens.count("R"))
        self.n_O = max(1, self.tokens.count("O"))
        self.n_V = {g: max(1, (self.tokens.count("V") if g is None
                               else self.tokens.count(f"V{g}")))
                    for g in self.groups}
        self.n_H = self.tokens.count("H")
        toks = self.tokens
        self._h_in_block = "{" in toks and "H" in toks[
            toks.index("{"):toks.index("}")]

        dt = integrator.timestep
        gamma = integrator.collision_rate
        self.h_R = dt / self.n_R
        self.h_O = dt / self.n_O
        self.ou_a = math.exp(-gamma * self.h_O)
        self.ou_b = math.sqrt(1.0 - math.exp(-2.0 * gamma * self.h_O))

        self.constraint_solver = (
            constraints.ConstraintSolver(system.constraints, system.masses,
                                         integrator.constraint_tolerance)
            if system.constraints.n_constraints > 0 else None)
        # a subclass with its own step (integrators/extras.py) evaluates by
        # the dense program in its step and its initial state alike
        self._own_step = brings_own_step(type(self))
        self.force_path = (
            force_paths.DensePath(system, self.groups) if self._own_step
            else force_paths.choose_path(integrator, system, self.tokens,
                                         self.groups))
        # inside a run the trailing velocity projection of each step is
        # dropped when the next step's leading V/O re-projects at the same
        # positions (see _vproj_skip_eligible); run_program restores the
        # final state's projection once per run
        self._vproj_skip = (not self._own_step
                            and self._vproj_skip_eligible())
        # one step as a CUDA graph (step_graph.py) where the path allows it
        # and the step holds no host decision: no H steps (their protocol
        # position is a host count), no _pre_step hook and no Jacobi
        # SHAKE/RATTLE (iterated to a tolerance read on the host)
        solver = self.constraint_solver
        self._graph_program = (
            self.force_path.graphable and "H" not in self.tokens
            and type(self)._pre_step is BoundIntegrator._pre_step
            and not (solver is not None and solver.host_iterated))
        self._graphs: Dict[Any, Optional[step_graph.StepGraph]] = {}

    @property
    def sweep_mode(self) -> bool:
        """Whether K2's bounded sweep serves the NonbondedTerm."""
        return isinstance(self.force_path, force_paths.SweepPath)

    @property
    def neighbor_mode(self) -> bool:
        """Whether the NonbondedTerm goes over a neighbour list."""
        return isinstance(self.force_path, force_paths.NeighborPath)

    @property
    def _sweep_kernel(self):
        """K2 (``ops.sweep_nb.SweepNonbonded``) on the sweep path, the
        object whose ``evaluate`` the step calls; None off it."""
        path = self.force_path
        return path.kernel if isinstance(path, force_paths.SweepPath) else None

    # -- energies at other parameters (the multistate energy matrix) -------
    def check_sweep_overflow(self, flag):
        """Raise while ``flag`` (a device bool, or None off sweep mode) is
        set: its energies are wrong (``force_path.check_overflow``)."""
        self.force_path.check_overflow(flag)

    def energies_batch(self, x, box, rep, params):
        """Potential energies (B,) float64 of B (configuration, parameters)
        pairs, and the overflow flag of the configurations' fresh sorts (a
        device bool, None off sweep mode): ``x`` (R, N, 3) with boxes (R,
        3, 3) (None: the default), ``rep`` (B,) int64 the configuration of
        each pair, ``params`` a dict of (B,) tensors. By the force path (in
        sweep mode one sort a configuration, then one launch of each kernel
        for all B); the dense sum raises at ``DENSE_LIMIT`` atoms or more
        on the card. The caller checks the flag."""
        with tracing.span("integrator.energies_batch"):
            return self.force_path.energies_batch(x, box, rep, params)

    def energies_and_overflow_at(self, x, box, params_list):
        """:meth:`energies_at` without its host read: (U (K,) float64, the
        fresh sort's overflow flag, a device bool or None), the K sets of
        parameters evaluated as one batch of K pairs (:meth:`energies_batch`).
        A caller that evaluates many configurations ORs the flags and checks
        once (:meth:`check_sweep_overflow`)."""
        if box is None:
            box = self.system.default_box
        params = {}
        if params_list:
            names = list((params_list[0] or {}).keys())
            params = {k: torch.stack([torch.as_tensor(
                (p or {})[k], dtype=x.dtype, device=x.device)
                for p in params_list]) for k in names}
        rep = torch.zeros((len(params_list),), dtype=torch.long,
                          device=x.device)
        return self.energies_batch(x[None], None if box is None else box[None],
                                   rep, params)

    def energies_at(self, x, box, params_list) -> torch.Tensor:
        """Potential energies (K,) float64 of one configuration ``x`` at K
        sets of global parameters, by the force path; raises as ``run``
        does on an exclusion-bitfield overflow."""
        u, overflow = self.energies_and_overflow_at(x, box, params_list)
        self.check_sweep_overflow(overflow)
        return u

    def energy_forces_at(self, x, box, params):
        """(U float64, F) of ``x`` at the global parameters ``params`` by
        the force path, on a fresh sort in sweep mode; raises as ``run``
        does on an exclusion-bitfield overflow."""
        return self.force_path.energy_forces_at(x, box, params)

    # -- energy plumbing ----------------------------------------------------
    def _ensure_forces(self, env: _Env, groups=None):
        todo = [g for g in (self.groups if groups is None else groups)
                if env.F[g] is None]
        us, fs, env.ctx = self.force_path.evaluate_groups(
            env.x, env.box, env.params, env.ctx, todo)
        for g, u, f in zip(todo, us, fs):
            env.U[g], env.F[g] = u, f

    def _invalidate(self, env: _Env):
        """Mark every group's cached energy and forces stale."""
        for g in self.groups:
            env.U[g] = None
            env.F[g] = None

    def _total_potential(self, env: _Env):
        self._ensure_forces(env)
        total = env.U[self.groups[0]]
        for g in self.groups[1:]:
            total = total + env.U[g]
        return total

    def _kinetic(self, env: _Env):
        ke = self.masses[:, None] * env.v * env.v
        if ke.dim() == 3:
            return 0.5 * torch.sum(ke, dim=(-2, -1))
        return 0.5 * torch.sum(ke)

    # the step's constraint projections: the solver's, called through these
    # two methods so that a caller may wrap them on the class or an instance
    def _constrain_positions(self, x_new, x_old):
        return self.constraint_solver.positions(x_new, x_old)

    def _constrain_velocities(self, x, v):
        return self.constraint_solver.velocities(x, v)

    # -- substep emitters ----------------------------------------------------
    def _emit_R(self, env: _Env):
        integ = self.integrator
        if integ.measure_shadow_work:
            u_old = self._total_potential(env)
        x_new = env.x + self.h_R * env.v
        if self.system.constraints.n_constraints > 0:
            x_proj = self._constrain_positions(x_new, env.x)
            # velocity correction v += (x_proj - x_unconstrained) / h
            env.v = env.v + (x_proj - x_new) / self.h_R
            x_new = x_proj
        env.x = x_new
        self._invalidate(env)
        if integ.measure_shadow_work:
            env.shadow_work = env.shadow_work + (
                self._total_potential(env) - u_old)

    def _emit_V(self, env: _Env, g, skip_constrain=False):
        integ = self.integrator
        self._ensure_forces(env, [g])
        if integ.measure_shadow_work:
            ke_old = self._kinetic(env)
        h = integ.timestep / self.n_V[g]
        env.v = env.v + h * env.F[g] * self.inv_mass[:, None]
        if self.system.constraints.n_constraints > 0 and not skip_constrain:
            env.v = self._constrain_velocities(env.x, env.v)
        if integ.measure_shadow_work:
            env.shadow_work = env.shadow_work + (self._kinetic(env) - ke_old)

    def _emit_O(self, env: _Env, skip_constrain=False):
        integ = self.integrator
        if integ.measure_heat:
            ke_old = self._kinetic(env)
        sigma = torch.sqrt(env.kT[..., None] * self.inv_mass)[..., None]
        noise = draw_normal(env.generator, env.v.shape, env.v)
        env.v = self.ou_a * env.v + self.ou_b * sigma * noise
        if self.system.constraints.n_constraints > 0 and not skip_constrain:
            env.v = self._constrain_velocities(env.x, env.v)
        if integ.measure_heat:
            env.heat = env.heat + (self._kinetic(env) - ke_old)

    def _emit_block_start(self, env: _Env):
        e_old = self._total_potential(env) + self._kinetic(env)
        env.stash = (env.x, env.v, dict(env.U), dict(env.F), e_old,
                     env.protocol_work)

    def _emit_block_end(self, env: _Env):
        x0, v0, U0, F0, e_old, w0 = env.stash
        e_new = self._total_potential(env) + self._kinetic(env)
        # Metropolize on the block's SHADOW work: the energy change not
        # accounted for by H-step protocol work
        shadow = (e_new - e_old) - (env.protocol_work - w0)
        u = draw_uniform(env.generator, e_new.shape, e_new)
        accept = u < torch.exp(-shadow / env.kT)
        acc = accept[..., None, None]
        env.x = torch.where(acc, env.x, x0)
        env.v = torch.where(acc, env.v, -v0)   # momentum flip on rejection
        if self._h_in_block:
            # the global parameters moved inside the block: the stashed U/F
            # belong to the old lambda, so recompute at (the kept x, the
            # current parameters)
            self._invalidate(env)
            self._ensure_forces(env)
        else:
            for g in self.groups:
                env.U[g] = torch.where(accept, env.U[g], U0[g])
                env.F[g] = torch.where(acc, env.F[g], F0[g])
        env.n_accepted = env.n_accepted + accept.to(torch.int64)
        env.n_proposed = env.n_proposed + 1
        env.stash = None

    def _emit_H(self, env: _Env):
        raise IntegratorError(
            "H token requires a nonequilibrium integrator subclass")

    # -- program assembly ---------------------------------------------------
    def _pre_step(self, env: _Env):
        """Hook run at the start of each step (the nonequilibrium cycle
        reset)."""

    def _vproj_skip_eligible(self) -> bool:
        """True when the LAST substep's velocity projection is redundant
        inside a run: the RATTLE projection P is linear and idempotent in v,
        so P(P(v + d1) + d2) == P(v + d1 + d2) at unchanged x and the next
        step's leading V/O projection subsumes it. Requires constraints, a
        splitting that starts and ends with V/Vn/O, no Metropolis block (it
        stashes projected velocities) and no heat or shadow work (they read
        the kinetic energy around every V and O)."""
        toks = self.tokens
        if not toks or self.system.constraints.n_constraints == 0:
            return False
        if "{" in toks:
            return False
        if self.integrator.measure_shadow_work or self.integrator.measure_heat:
            return False

        def is_vel(t):
            return t == "O" or t.startswith("V")

        return is_vel(toks[0]) and is_vel(toks[-1])

    def step(self, state: IntegratorState,
             skip_trailing_vproj=False) -> IntegratorState:
        """One step of the splitting program; ``skip_trailing_vproj`` drops
        the last substep's velocity projection (see _vproj_skip_eligible)."""
        with tracing.span("integrator.step"):
            tracing.count("integrator.steps")
            return self._step(state, skip_trailing_vproj)

    def _step(self, state: IntegratorState,
              skip_trailing_vproj=False) -> IntegratorState:
        skip_idx = len(self.tokens) - 1 if skip_trailing_vproj else -1
        env = _Env(state, self.groups, self.force_path.context(state))

        self._pre_step(env)
        for ti, tok in enumerate(self.tokens):
            if tok == "R":
                self._emit_R(env)
            elif tok == "O":
                self._emit_O(env, skip_constrain=(ti == skip_idx))
            elif tok == "V":
                self._emit_V(env, None, skip_constrain=(ti == skip_idx))
            elif tok == "{":
                self._emit_block_start(env)
            elif tok == "}":
                self._emit_block_end(env)
            elif tok == "H":
                self._emit_H(env)
            else:
                self._emit_V(env, int(tok[1:]),
                             skip_constrain=(ti == skip_idx))
        # leave caches valid for the next step
        self._ensure_forces(env)
        state = self.force_path.store(state, env.ctx)
        return state.replace(
            positions=env.x, velocities=env.v, kT=env.kT,
            global_params=env.params,
            forces=tuple(env.F[g] for g in self.groups),
            potentials=tuple(env.U[g] for g in self.groups),
            heat=env.heat, shadow_work=env.shadow_work,
            protocol_work=env.protocol_work,
            n_accepted=env.n_accepted, n_proposed=env.n_proposed,
            lambda_=env.lambda_, lambda_step=env.lambda_step,
            step_count=state.step_count + 1)

    # -- public API ---------------------------------------------------------
    def initial_state(self, sampler_state: SamplerState,
                      generator: torch.Generator, temperature=None,
                      thermodynamic_state: Optional[ThermodynamicState] = None,
                      global_params: Optional[Dict[str, Any]] = None
                      ) -> IntegratorState:
        """Build the integrator state from a sampler state. Velocities are
        thermalized from ``generator`` if absent; forces and potentials are
        precomputed so the first V substep is exact (on the fused path by
        its force kernel; in neighbour mode over a list built here)."""
        if thermodynamic_state is not None:
            temperature = thermodynamic_state.temperature
            global_params = dict(thermodynamic_state.global_params)
        if temperature is None:
            temperature = self.integrator.temperature
        x = sampler_state.positions
        kT = torch.as_tensor(kB * temperature, dtype=x.dtype, device=x.device)
        box = sampler_state.box_vectors
        if box is None:
            box = self.system.default_box
        params = {k: torch.as_tensor(v, dtype=x.dtype, device=x.device)
                  for k, v in (global_params or {}).items()}
        v = sampler_state.velocities
        if v is None:
            v = thermalize_velocities(self.masses, kT, generator, dtype=x.dtype)
        return self._new_state(x, v, kT, box, params, generator, ())

    def initial_state_batch(self, sampler_states: Sequence[SamplerState],
                            generators: Sequence[torch.Generator],
                            temperatures=None,
                            thermodynamic_states=None,
                            global_params=None) -> IntegratorState:
        """One batched state of B replicas: replica b at
        ``sampler_states[b]``, drawing from ``generators[b]``, at the
        temperature and global parameters of ``thermodynamic_states[b]``
        (else ``temperatures`` and ``global_params``, one a replica or one
        for all; else the integrator's temperature), which ride in the
        state; missing velocities are thermalized from the replica's own
        generator. The forces come from one batched evaluation; a
        ``per_replica`` path builds each replica's state and stacks them."""
        n_rep = len(sampler_states)
        if thermodynamic_states is not None:
            temperatures = [ts.temperature for ts in thermodynamic_states]
            global_params = [dict(ts.global_params)
                             for ts in thermodynamic_states]
        if temperatures is None:
            temperatures = self.integrator.temperature
        if not isinstance(temperatures, (list, tuple)):
            temperatures = [temperatures] * n_rep
        if not isinstance(global_params, (list, tuple)):
            global_params = [global_params] * n_rep
        if self.force_path.per_replica:
            return stack_states([
                self.initial_state(ss, gen, temperature=t, global_params=p)
                for ss, gen, t, p in zip(sampler_states, generators,
                                         temperatures, global_params)])
        x = torch.stack([ss.positions for ss in sampler_states])
        like = x[0]
        kT = torch.stack([torch.as_tensor(kB * t, dtype=x.dtype,
                                          device=x.device)
                          for t in temperatures])
        boxes = [ss.box_vectors if ss.box_vectors is not None
                 else self.system.default_box for ss in sampler_states]
        box = None if boxes[0] is None else torch.stack(boxes)
        names = list((global_params[0] or {}).keys())
        params = {k: torch.stack([torch.as_tensor(
            (p or {})[k], dtype=x.dtype, device=x.device)
            for p in global_params]) for k in names}
        v = torch.stack([
            ss.velocities if ss.velocities is not None
            else thermalize_velocities(self.masses, kT[b], gen,
                                       dtype=like.dtype)
            for b, (ss, gen) in enumerate(zip(sampler_states, generators))])
        return self._new_state(x, v, kT, box, params, tuple(generators),
                               (n_rep,))

    def _new_state(self, x, v, kT, box, params, generator, batch):
        """A state at its start (no work, heat or counts; ``batch`` the
        leading shape) with the forces of its positions."""
        zero = torch.zeros(batch, dtype=x.dtype, device=x.device)
        izero = torch.zeros(batch, dtype=torch.int64, device=x.device)
        return self._with_initial_forces(IntegratorState(
            positions=x, velocities=v, kT=kT, box=box, global_params=params,
            heat=zero, shadow_work=zero, protocol_work=zero,
            n_accepted=izero, n_proposed=izero, lambda_=zero, lambda_step=0,
            step_count=0, generator=generator))

    def _with_initial_forces(self, state: IntegratorState) -> IntegratorState:
        """``state`` with the forces and potentials of its positions (a
        fresh sort in sweep mode, a list built here in neighbour mode), so
        that the first V substep is exact."""
        return self.force_path.initial_forces(state)

    def _graph_for(self, state: IntegratorState, skip: bool):
        """The CUDA graph of one step (:mod:`.step_graph`) that serves
        ``state``, not yet captured at its first use; None where the step
        runs eagerly: a program with a host decision (``_graph_program``,
        read on every call), a state the graph cannot hold
        (``step_graph.signature``) or a failed capture. One graph a
        signature; the replicas' kT and parameters are buffer contents."""
        if not self._graph_program:
            return None
        key = step_graph.signature(state, len(self.groups), skip)
        if key is None:
            return None
        if key not in self._graphs:
            self._graphs[key] = step_graph.StepGraph(self, state, skip, key)
        return self._graphs[key]

    def run_program(self, n_steps: int):
        """The function state -> state advancing ``n_steps`` steps. The
        force path is refreshed every ``refresh_interval`` steps and at the
        start of the run (the sweep ring re-sorted, the neighbour list
        rebuilt); with the trailing-projection skip the final state's
        velocities are projected once at the end. Between re-sorts the
        steps replay one CUDA graph where :meth:`_graph_for` gives one."""
        skip = self._vproj_skip

        def steps(state, count):
            graph = self._graph_for(state, skip) if count else None
            if graph is not None and graph.graph is None:
                # the first use: one eager step makes what the capture
                # records (K2's scratch, tickets and launch counters, the
                # libraries' plans), then the capture
                state = self.step(state, skip_trailing_vproj=skip)
                count -= 1
                try:
                    graph.capture()
                except step_graph.CaptureError as err:
                    logger.warning("the step program runs eagerly: its "
                                   "CUDA graph failed to capture (%s)", err)
                    self._graphs[graph.key] = graph = None
            if graph is not None and count:
                return graph.run(state, count)
            for _ in range(count):
                state = self.step(state, skip_trailing_vproj=skip)
            return state

        def chunked(state, refresh, interval):
            n_chunks, remainder = divmod(n_steps, interval)
            for _ in range(n_chunks):
                state = steps(refresh(state), interval)
            if remainder:
                state = steps(refresh(state), remainder)
            return state

        def run_fn(state):
            path = self.force_path
            if path.refresh_interval is None:
                state = steps(state, n_steps)
            else:
                state = chunked(state, path.refresh, path.refresh_interval)
            if self._vproj_skip and n_steps > 0:
                state = state.replace(velocities=self._constrain_velocities(
                    state.positions, state.velocities))
            return state
        return run_fn

    def run(self, state: IntegratorState, n_steps: int) -> IntegratorState:
        """Advance ``n_steps`` by the force path: K1's kernel on the fused
        path, else the step program (:meth:`run_program`), the sweep path
        raising on its sticky overflow flag (one host read a call) and the
        neighbour path leaving its flag (``nbr_overflow``) to the caller.
        A batched state advances its replicas together, or one at a time
        on a ``per_replica`` path."""
        if state.positions.dim() == 3 and self.force_path.per_replica:
            return stack_states([self.run(s, n_steps)
                                 for s in unstack_states(state)])
        return self.force_path.run(state, n_steps, self.run_program)

    def pretty_print(self) -> str:
        """The step program as text: a header with the splitting, then one
        line a token (the reference's PrettyPrintableIntegrator)."""
        lines = [f"# splitting: {self.integrator.splitting}"]
        for tok in self.tokens:
            if tok == "R":
                lines.append(f"x += {self.h_R:.6g} * v   ; constrain positions")
            elif tok == "O":
                lines.append(
                    f"v = {self.ou_a:.6g} v + {self.ou_b:.6g} sqrt(kT/m) xi")
            elif tok.startswith("V"):
                g = tok[1:] or "all"
                lines.append(f"v += h * F[{g}]/m       ; constrain velocities")
            elif tok == "{":
                lines.append("begin Metropolize(save x, v, E)")
            elif tok == "}":
                lines.append("end Metropolize(accept/reject; flip v on reject)")
            elif tok == "H":
                lines.append("lambda step: perturb global params, "
                             "protocol_work += dU")
        return "\n".join(lines)

    def sampler_state_from(self, state: IntegratorState) -> SamplerState:
        return SamplerState(positions=state.positions,
                            velocities=state.velocities, box_vectors=state.box)

    def sampler_states_from(self, state: IntegratorState
                            ) -> List[SamplerState]:
        """The replicas of a batched state as sampler states, in order."""
        return [SamplerState(positions=state.positions[b],
                             velocities=state.velocities[b],
                             box_vectors=(None if state.box is None
                                          else state.box[b]))
                for b in range(state.positions.shape[0])]


class LangevinIntegrator:
    """System-independent integrator spec; binds to a System on demand.

    Parameters mirror openmmtools' LangevinIntegrator: temperature (K),
    collision_rate (1/ps), timestep (ps), splitting, constraint_tolerance,
    measure_shadow_work, measure_heat. ``neighborlist=None`` keeps a system
    on the generic dense program (no fused kernel), as in the JAX package.
    ``sweep`` is the sweep-mode policy ("auto": CUDA systems with N >= 1024;
    "force" or "interpret": any system, plain versions on the CPU; None:
    off), re-sorting every ``sweep_sort_interval`` steps (default 100) with
    ``sweep_shell_block`` shells a block (default 8) and a Verlet skin of
    ``neighbor_skin`` nm (default 0.1). Neighbour mode (``neighborlist``
    "auto", see ``force_paths.NeighborPath.build``) takes the same
    ``neighbor_skin`` (default 0.35 cutoff there) and rebuilds every
    ``neighbor_rebuild_interval`` steps (default from the thermal drift).
    """

    _default_splitting = "V R O R V"

    def __init__(self, temperature=298.0, collision_rate=1.0, timestep=0.001,
                 splitting: Optional[str] = None, constraint_tolerance=1e-8,
                 measure_shadow_work=False, measure_heat=False,
                 neighborlist="auto", neighbor_skin=None,
                 neighbor_rebuild_interval=None, sweep="auto",
                 sweep_sort_interval=None, sweep_shell_block=None):
        self.temperature = temperature
        self.collision_rate = collision_rate
        self.timestep = timestep
        self.splitting = splitting or self._default_splitting
        self.constraint_tolerance = constraint_tolerance
        self.measure_shadow_work = measure_shadow_work
        self.measure_heat = measure_heat
        self.neighborlist = neighborlist
        self.neighbor_skin = neighbor_skin
        self.neighbor_rebuild_interval = neighbor_rebuild_interval
        self.sweep = sweep
        self.sweep_sort_interval = sweep_sort_interval
        self.sweep_shell_block = sweep_shell_block
        parse_splitting(self.splitting)  # fail fast
        self._bound: Dict[str, BoundIntegrator] = {}

    _bound_class = BoundIntegrator

    def __getstate__(self):
        # the bound integrators are a cache of the system's programs
        return {k: v for k, v in self.__dict__.items() if k != "_bound"}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._bound = {}

    def bind(self, system: System) -> BoundIntegrator:
        # content hash, not id(): structurally identical systems share one
        # bound integrator, and a recreated system never aliases a stale key;
        # the same system on another device (a replica mesh) binds anew
        key = (system.fingerprint, str(system.device))
        bound = self._bound.get(key)
        if bound is None:
            self._bound[key] = bound = self._bound_class(self, system)
        return bound

    @staticmethod
    def acceptance_rate(state: IntegratorState):
        return state.n_accepted / torch.clamp(state.n_proposed, min=1)


class BAOABIntegrator(LangevinIntegrator):
    """BAOAB: 'V R O R V'."""

    _default_splitting = "V R O R V"


class VVVRIntegrator(LangevinIntegrator):
    """VVVR: 'O V R V O'."""

    _default_splitting = "O V R V O"


class GeodesicBAOABIntegrator(LangevinIntegrator):
    """g-BAOAB with K_r position substeps: 'V R..R O R..R V'."""

    def __init__(self, K_r=2, temperature=298.0, collision_rate=1.0,
                 timestep=0.001, constraint_tolerance=1e-8,
                 measure_shadow_work=False, measure_heat=False):
        r = " ".join(["R"] * K_r)
        super().__init__(temperature=temperature,
                         collision_rate=collision_rate, timestep=timestep,
                         splitting=f"V {r} O {r} V",
                         constraint_tolerance=constraint_tolerance,
                         measure_shadow_work=measure_shadow_work,
                         measure_heat=measure_heat)
        self.K_r = K_r


class GHMCIntegrator(LangevinIntegrator):
    """Generalized hybrid MC: 'O { V R V } O'."""

    _default_splitting = "O { V R V } O"


class VelocityVerletIntegrator(LangevinIntegrator):
    """Deterministic velocity Verlet: 'V R V'."""

    _default_splitting = "V R V"

    def __init__(self, timestep=0.001, **kwargs):
        kwargs.setdefault("temperature", 298.0)
        kwargs.setdefault("collision_rate", 1.0)
        super().__init__(timestep=timestep, **kwargs)
