"""Langevin splitting integrators (counterpart of ``integrators/langevin.py``).

The operator-splitting language of openmmtools' ``LangevinIntegrator``:

* ``R``      position drift x += (dt/n_R) v
* ``V``      full-force kick; ``V0``..``V31`` per-force-group kicks (MTS)
* ``O``      Ornstein–Uhlenbeck: v = a v + b sqrt(kT/m) xi with
             a = exp(-gamma h), b = sqrt(1 - a^2)
* ``{ ... }`` Metropolization of the enclosed deterministic substeps (GHMC)

``BoundIntegrator`` turns a splitting into a step program over tensors, run
eagerly by ``run(state, n_steps)``. Three production paths take over where
they qualify, with the JAX package's eligibility rules and "the system lives
on a CUDA device" in place of "the backend is a TPU":

* neighbour mode (one periodic cutoff NonbondedTerm, one force group, from
  128 particles on the CPU and 100,000 on the card): the NonbondedTerm's
  energy over a fixed-capacity neighbour list
  (:mod:`openmmtools_tpu_torch.ops.neighborlist`), autograd forces, the list
  rebuilt every ``neighbor_rebuild_interval`` steps with a sticky overflow
  flag in the state; sweep mode and the fused kernel replace it where they
  engage;
* sweep mode (large periodic systems with a real force field, N >= 1024): the
  NonbondedTerm's direct space goes through the bounded-sweep kernel of
  :mod:`openmmtools_tpu_torch.ops.sweep_nb`, and the bonded terms, exception
  add-back, reciprocal space and constraints run as tensor code around it;
  an AlchemicalNonbondedTerm (softcore beta = 0, c = 6) goes through the
  kernel's alchemical variant, its class scalars computed from the global
  parameters on the device at every evaluation;
* the fused kernel of :mod:`openmmtools_tpu_torch.ops.fused_langevin` for a
  plain R/V/O splitting of a monodisperse, uncharged, periodic LJ fluid; it
  supersedes sweep mode.

A subclass whose bound class brings its own ``step`` (the integrators of
:mod:`openmmtools_tpu_torch.integrators.extras`) takes neither path.

Replicas as one batched axis (the JAX package's ``jax.vmap`` of the step
program over replicas): :meth:`BoundIntegrator.initial_state_batch` stacks
B configurations into one state whose tensors carry a leading axis (kT,
box and each global parameter one a replica, the generators a tuple, one a
replica), and the same step program advances them together. Sweep mode
sorts each configuration and evaluates all of them in one launch of each
sweep kernel; the remainder around it, the generic program's energy and
the constraints run under ``torch.func.vmap`` (the kernels are opaque to
it, so it never wraps them), with autograd of the summed energies giving
each replica's forces, since replicas do not interact. The fused path
(K1) and neighbour mode advance a batch one replica at a time; so does
Jacobi SHAKE, whose iteration count is read on the host.
:meth:`BoundIntegrator.energies_batch` evaluates B (configuration,
parameters) pairs, the multistate energy matrix, the same way.

Constraints follow OpenMM's SETTLE + CCMA architecture: SETTLE for rigid
waters, cluster M-SHAKE/M-RATTLE for the remaining small clusters, Jacobi
SHAKE/RATTLE where clustering fails (:mod:`openmmtools_tpu_torch.ops.constraints`).

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

from openmmtools_tpu_torch.alchemy import AlchemicalNonbondedTerm
from openmmtools_tpu_torch.constants import kB
from openmmtools_tpu_torch.ops import bonded, constraints, nonbonded, sweep_nb
from openmmtools_tpu_torch.ops.fused_langevin import brings_own_step
from openmmtools_tpu_torch.ops.geometry import minimum_image
from openmmtools_tpu_torch.ops.pme import EwaldReciprocalTerm
from openmmtools_tpu_torch.states import SamplerState, ThermodynamicState
from openmmtools_tpu_torch.system import (
    DENSE_LIMIT,
    HarmonicAngleTerm,
    HarmonicBondTerm,
    NonbondedTerm,
    PeriodicTorsionTerm,
    System,
    make_energy_fn,
    make_energy_force_fn,
    value_and_grad,
)
from openmmtools_tpu_torch.utils.pytree import static_field, tensor_dataclass


logger = logging.getLogger(__name__)


class IntegratorError(Exception):
    pass


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


def draw_uniform(generator, shape, like):
    """Uniforms in [0, 1) of ``like``'s dtype, drawn on the generator's
    device and moved to ``like``'s. A tuple of generators (a batch) draws
    row b of ``shape`` from generator b."""
    if isinstance(generator, (tuple, list)):
        return torch.stack([draw_uniform(g, shape[1:], like)
                            for g in generator])
    return torch.rand(shape, generator=generator, dtype=like.dtype,
                      device=generator.device).to(like.device)


def draw_normal(generator, shape, like):
    """Standard normals of ``like``'s dtype, drawn on the generator's device
    and moved to ``like``'s. A tuple of generators (a batch) draws row b of
    ``shape`` from generator b: one draw a replica."""
    if isinstance(generator, (tuple, list)):
        return torch.stack([draw_normal(g, shape[1:], like)
                            for g in generator])
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=generator.device).to(like.device)


# bytes a torch.func.vmap chunk of the batched energies may hold: the
# dense program holds a dozen or so (N, N) tensors a configuration, the
# reciprocal space (N, 2 kmax + 2, 2 kmax + 2) tables
_VMAP_BYTES = 1 << 31


def _vmap_chunk(per_item_bytes):
    """Configurations a vmap chunk evaluates at once."""
    return max(1, _VMAP_BYTES // max(1, int(per_item_bytes)))


def _box_lengths(box):
    """The edges (..., 3) of a box (..., 3, 3)."""
    return torch.diagonal(box, dim1=-2, dim2=-1)


def batched_value_and_grad(fn, x):
    """``(fn(x), d sum(fn) / dx)`` for ``fn`` mapping a batch (B, N, 3) to
    energies (B,): each replica's gradient, since no energy reads another
    replica's positions; a zero gradient where ``fn`` does not depend on
    ``x``."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        u = fn(xx)
        if not u.requires_grad:
            return u.detach(), torch.zeros_like(x)
        (g,) = torch.autograd.grad(u.sum(), xx)
    return u.detach(), g


def _per_item(fn, params, batch, *args, chunk=None):
    """``fn(params_b, *args_b)`` for every b, under ``torch.func.vmap``
    over the leading axis of ``params`` (a dict of (B,) tensors) and of
    ``args``, ``chunk`` at a time (None: all); with no parameters and no
    args ``fn`` is evaluated once and broadcast to ``batch`` rows."""
    if not params and not args:
        out = fn({})
        if isinstance(out, tuple):
            return tuple(o.expand((batch,) + o.shape) for o in out)
        return out.expand((batch,) + out.shape)
    return torch.func.vmap(fn, chunk_size=chunk)(params, *args)


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
    """Mutable environment threaded through the substep emitters."""

    def __init__(self):
        self.x = None
        self.v = None
        self.generator = None
        self.kT = None
        self.params = None
        self.U: Dict[Any, Any] = {}      # group -> cached potential (or None)
        self.F: Dict[Any, Any] = {}      # group -> cached force (or None)
        self.heat = None
        self.shadow_work = None
        self.protocol_work = None
        self.n_accepted = None
        self.n_proposed = None
        self.lambda_ = None
        self.lambda_step = None
        self.step_count = None
        self.box = None
        self.nbr = None
        self.sweep = None
        self.stash = None


def fused_lj_eligible(system: System) -> bool:
    """Whether the fused LJ kernel (K1) can integrate ``system``: one
    uncharged periodic LJ ``NonbondedTerm`` (cutoff, no exceptions, no
    global LJ scale parameter) of uniform sigma, epsilon and mass,
    no constraints, 192 to 32,768 particles in an orthorhombic box at least
    twice the cutoff. The kernel reads neither the global parameters nor
    per-atom parameters, so a term with an ``lj_scale_param`` would be
    integrated at full epsilon whatever the state's scale."""
    if (system.constraints.n_constraints > 0 or len(system.terms) != 1
            or system.default_box is None
            or not 192 <= system.n_particles <= 32768):
        return False
    term = system.terms[0]
    if not isinstance(term, NonbondedTerm):
        return False
    if (term.method != "cutoff_periodic" or term.cutoff is None
            or term.exception_index.shape[0] > 0
            or term.lj_scale_param is not None):
        return False
    sig = term.sigma.cpu()
    eps = term.epsilon.cpu()
    q = term.charge.cpu()
    mass = system.masses.cpu()
    box = system.default_box.cpu()
    diag = torch.diagonal(box)
    if not (bool(torch.all(sig == sig[0])) and bool(torch.all(eps == eps[0]))
            and bool(torch.all(q == 0.0)) and bool(torch.all(mass == mass[0]))
            and torch.allclose(box, torch.diag(diag))):
        return False
    return float(term.cutoff) <= 0.5 * float(diag.min())   # minimum image


class BoundIntegrator:
    """An integrator bound to a specific System: the step program and the
    state constructors (OpenMM Context creation, minus the device)."""

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
        self._ef_fns = {g: make_energy_force_fn(
            system, groups=None if g is None else [g]) for g in self.groups}
        self._e_fns = {g: make_energy_fn(
            system, groups=None if g is None else [g]) for g in self.groups}
        # massless virtual sites, which the step never moves: neighbour and
        # sweep mode rebuild them from their parents before they read the
        # positions (None for a system without them)
        vsites = system.virtual_sites
        self._vsites = (vsites if vsites is not None and vsites.n_sites > 0
                        else None)

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

        # constraint solver dispatch (OpenMM's SETTLE + CCMA architecture):
        # analytic SETTLE for rigid isosceles triangles and cluster M-SHAKE
        # for the remaining small clusters, on their disjoint atom sets;
        # Jacobi SHAKE/RATTLE where clustering fails
        self._settle = None
        self._clusters = None
        self._rest_constraints = None
        if system.constraints.n_constraints > 0:
            self._settle, rest = constraints.partition_constraints(
                system.constraints, system.masses)
            if rest is not None:
                self._rest_constraints = rest
                self._clusters = constraints.analyze_clusters(
                    rest, system.masses)

        # a subclass with its own step (integrators/extras.py) evaluates by
        # the dense program in its step and its initial state alike: it
        # takes neither the fused kernel nor sweep mode
        self._own_step = brings_own_step(type(self))
        self._neighbor_setup()
        self._sweep_setup()   # replaces neighbour mode where it engages
        self._fused = None
        self._fused_setup()   # after the sweep: the fused kernel supersedes it
        # inside a run the trailing velocity projection of each step is
        # dropped when the next step's leading V/O re-projects at the same
        # positions (see _vproj_skip_eligible); run_program restores the
        # final state's projection once per run
        self._vproj_skip = (not self._own_step
                            and self._vproj_skip_eligible())

    # -- neighbour-list production path -------------------------------------
    def _neighbor_setup(self):
        """Enable the fixed-capacity neighbour-list force path for a system
        with one periodic cutoff NonbondedTerm and one force group, from
        128 particles on the CPU and 100,000 on the card (the JAX package's
        thresholds for its CPU and its TPU). The list radius is cutoff +
        ``neighbor_skin`` (default 0.35 cutoff), its capacity
        ceil(2.5 avg + 8) for the average count within the radius, and the
        rebuild interval ``neighbor_rebuild_interval``, by default the
        steps in which four times the fastest thermal speed drifts skin/2,
        at most 200. ``neighborlist=None`` disables it, as does a class
        with its own step (``brings_own_step``): such a step evaluates by
        the dense program, in the JAX package too. A system with virtual
        sites has them rebuilt before each list build and inside the
        energy, as the dense program rebuilds them."""
        self.neighbor_mode = False
        integ = self.integrator
        system = self.system
        if (integ.neighborlist is None or self._own_step
                or self.groups != [None] or system.default_box is None):
            return
        nb_terms = [t for t in system.terms
                    if isinstance(t, NonbondedTerm) and t.cutoff is not None
                    and t.method != "no_cutoff" and t.periodic]
        min_particles = 128 if system.device.type == "cpu" else 100_000
        if len(nb_terms) != 1 or system.n_particles < min_particles:
            return
        term = nb_terms[0]
        n = system.n_particles
        skin = integ.neighbor_skin
        if skin is None:
            skin = 0.35 * term.cutoff
        r_list = term.cutoff + skin
        vol = float(torch.prod(torch.diagonal(system.default_box)))
        avg = n / vol * 4.0 / 3.0 * math.pi * r_list ** 3
        k_max = min(int(math.ceil(2.5 * avg + 8)), n - 1)
        interval = integ.neighbor_rebuild_interval
        if interval is None:
            # four times the fastest thermal speed must not drift more than
            # skin/2 over the interval
            kT = kB * float(integ.temperature)
            masses = system.masses
            v_th = float(torch.max(torch.sqrt(kT / torch.clamp(
                torch.where(masses > 0, masses, math.inf), min=1e-30))))
            drift = 4.0 * max(v_th, 1e-6) * integ.timestep
            interval = min(max(1, int((0.5 * skin) / max(drift, 1e-12))),
                           200)
        self.neighbor_mode = True
        self._nbr_term = term
        self._nbr_other = tuple(t for t in system.terms if t is not term)
        self.neighbor_k_max = k_max
        self.neighbor_r_list = r_list
        self.neighbor_rebuild_interval = interval

    def _neighbor_energy(self, x, box, params, nbr):
        """The whole system's energy with the NonbondedTerm over ``nbr``."""
        if self._vsites is not None:
            x = self._vsites.reconstruct(x)
        total = self._nbr_term.energy_neighbors(x, box, params, nbr)
        for t in self._nbr_other:
            total = total + t.energy(x, box, params)
        return total

    def _build_nbr(self, x, box):
        from openmmtools_tpu_torch.ops.neighborlist import build_neighbor_list

        x = x.detach()
        if self._vsites is not None:
            x = self._vsites.reconstruct(x)   # the sites where they are now
        return build_neighbor_list(x, box, self.neighbor_r_list,
                                   self.neighbor_k_max, periodic=True)

    def _rebuild_neighbors(self, state: IntegratorState) -> IntegratorState:
        """A fresh list at the state's positions; the overflow flag stays
        set once set. A list built at these very positions (the state's
        tensor itself, as ``initial_state`` leaves it for ``run``) is kept:
        the build is O(N^2)."""
        if state.nbr_idx is not None and state.nbr_at is state.positions:
            return state
        box = state.box if state.box is not None else self.system.default_box
        nbr = self._build_nbr(state.positions, box)
        overflow = nbr.overflow
        if state.nbr_overflow is not None:
            overflow = overflow | state.nbr_overflow
        return state.replace(nbr_idx=nbr.idx, nbr_mask=nbr.mask,
                             nbr_overflow=overflow, nbr_at=state.positions)

    def _state_nbr(self, state: IntegratorState):
        """The state's list as a NeighborList (None off neighbour mode)."""
        if not self.neighbor_mode or state.nbr_idx is None:
            return None
        from openmmtools_tpu_torch.ops.neighborlist import NeighborList

        return NeighborList(idx=state.nbr_idx, mask=state.nbr_mask,
                            overflow=state.nbr_overflow,
                            r_list=self.neighbor_r_list)

    def _eval_group(self, g, x, box, params, nbr=None):
        """(U, F) of force group ``g``: over the list in neighbour mode
        (autograd forces), else the group's dense function; a batch (B, N,
        3) by the dense energy under vmap, each replica's forces by
        autograd of the summed energies."""
        if x.dim() == 3:
            u, grad = batched_value_and_grad(
                lambda xx: self._dense_energies(g, xx, box, None, params), x)
            return u, -grad
        if self.neighbor_mode and nbr is not None:
            u, grad = value_and_grad(
                lambda xx: self._neighbor_energy(xx, box, params, nbr), x)
            return u, -grad
        return self._ef_fns[g](x, box, params)

    # -- bounded-sweep production path (large heterogeneous systems) -------
    def _sweep_setup(self):
        """Enable the bounded-sweep direct-space kernel (ops/sweep_nb.py) for
        large periodic systems with real force fields. The kernel replaces
        the NonbondedTerm's standard pair sum (exception pairs masked, added
        back as tensor code); bonded terms, reciprocal space, constraints
        and the splitting run around it. An AlchemicalNonbondedTerm takes
        the kernel's alchemical variant when its softcore is the factory's
        default (beta = 0, c = 6), for any number of regions; any other
        softcore keeps the dense path, with a warning at N >= 4096.
        ``sweep="auto"`` engages on a CUDA system with N >= 1024; "force"
        (or "interpret", the JAX package's name for its CPU mode) engages on
        any device, where a CPU system runs the kernels' plain versions; None
        disables. A class with its own step (``brings_own_step``) keeps
        sweep mode off: its step evaluates by the dense program. A system
        with virtual sites has them rebuilt from their parents before each
        sort and each evaluation, and the sites' forces spread back onto
        the parents (``VirtualSites.spread_forces``)."""
        self.sweep_mode = False
        self._sweep_group = None
        integ = self.integrator
        policy = integ.sweep
        system = self.system
        if policy is None or system.default_box is None or self._own_step:
            return
        nb_terms = [t for t in system.terms
                    if type(t) in (NonbondedTerm, AlchemicalNonbondedTerm)]
        if len(nb_terms) != 1:
            return
        term = nb_terms[0]
        alchemical = type(term) is AlchemicalNonbondedTerm
        if alchemical and (term.softcore_beta != 0.0
                           or term.softcore_c != 6.0):
            if system.n_particles >= DENSE_LIMIT:
                # the dense path holds (N, N) matrices: losing the kernel
                # at this size is a cliff, so say so
                logger.warning(
                    "alchemical system with softcore_beta=%g, softcore_c=%g "
                    "(N=%d) falls back to the dense O(N^2) force path; the "
                    "sweep kernel covers beta=0, c=6 only",
                    term.softcore_beta, term.softcore_c, system.n_particles)
            return
        # the sweep serves the force group holding the NonbondedTerm; with
        # numbered Vn splittings (MTS) the other groups evaluate normally
        if self.groups == [None]:
            sweep_group = None
        elif term.force_group in self.groups:
            sweep_group = term.force_group
        else:
            return
        if (term.method not in ("pme", "ewald", "cutoff_periodic")
                or term.cutoff is None):
            return
        if policy == "auto" and (system.device.type != "cuda"
                                 or system.n_particles < 1024):
            return
        diag = torch.diagonal(system.default_box).cpu()
        if float(term.cutoff) > 0.5 * float(diag.min()):
            return
        n = system.n_particles
        n_pad = -(-n // 128) * 128
        mask_shells = min(2048, max(32, (n_pad // 2 // 32) * 32))
        self._sweep_kernel = sweep_nb.SweepNonbonded(
            n, term.method, float(term.cutoff),
            switch_width=term.switch_width, dielectric=term.dielectric,
            ewald_alpha=term.ewald_alpha, shift_rf=term.shift_rf,
            switch_coulomb=term.switch_coulomb,
            shell_block=integ.sweep_shell_block or 8,
            skin=integ.neighbor_skin or 0.1, mask_shells=mask_shells,
            n_regions=term.n_regions if alchemical else None,
            coulomb_pme_treatment=(alchemical
                                   and term.coulomb_pme_treatment))
        self.sweep_mode = True
        self.neighbor_mode = False   # the sweep replaces the list path
        self._sweep_group = sweep_group
        self._sweep_term = term
        self._sweep_alch = term if alchemical else None
        self._sweep_pairs = sweep_nb.unique_pairs(term.exception_index)
        # the unsorted per-atom rows (sigma, sqrt(eps), charge, region
        # code); an alchemical term's sigma clamped to 1e-6
        self._sweep_atom_rows = sweep_nb.term_params(term)
        self.sweep_sort_interval = integ.sweep_sort_interval or 100
        self._sweep_remainder_setup()
        self._sweep_tail_setup()

    def _sweep_tail_setup(self):
        """The dispersion tail's pair-averaged integral does not depend on
        the configuration: summed once here in float64 on the system's
        device, over the atoms' distinct (sigma, epsilon[, region code])
        rows weighted by their counts (a few rows for a force field; the
        N^2 pairs took seconds on the host at 23,000 atoms), in chunks of
        rows. For an alchemical term one sum per region-pair class (env-env
        first), which the tail weights by each class's lam_s^a at every
        evaluation (the dense path's lambda-weighted tail)."""
        term = self._sweep_term
        n = self.system.n_particles
        self._sweep_disp_avg = None
        self._sweep_disp_class = None
        if not term.use_dispersion_correction:
            return
        sig, _, _, code = self._sweep_atom_rows
        cols = [sig.to(torch.float64), term.epsilon.to(torch.float64)]
        if code is not None:
            cols.append(code.to(torch.float64))
        rows, counts = torch.unique(torch.stack(cols, dim=1), dim=0,
                                    return_counts=True)
        sig, eps = rows[:, 0], rows[:, 1]
        weight = counts.to(torch.float64)
        m = rows.shape[0]
        rc3 = float(term.cutoff) ** 3
        rc9 = rc3 ** 3
        chunk = max(1, (1 << 22) // m)
        if code is not None:
            # class of the pair (g_i, g_j), env-env = 0
            table = sweep_nb.class_index(term.n_regions, sig.device) + 1
            code = rows[:, 2].long()
            n_all = (term.n_regions + 1) * (term.n_regions + 2) // 2
            sums = torch.zeros((n_all,), dtype=torch.float64,
                               device=sig.device)
        total = torch.zeros((), dtype=torch.float64, device=sig.device)
        for lo in range(0, m, chunk):
            s_ij = 0.5 * (sig[lo:lo + chunk, None] + sig[None, :])
            e_ij = torch.sqrt(eps[lo:lo + chunk, None] * eps[None, :])
            s6 = s_ij ** 6
            integral = (4.0 * e_ij * (s6 * s6 / (9.0 * rc9) - s6 / (3.0 * rc3))
                        * weight[lo:lo + chunk, None] * weight[None, :])
            if code is None:
                total = total + torch.sum(integral)
            else:
                cls = table[code[lo:lo + chunk, None], code[None, :]]
                # in index order on the card too (index_add_'s atomics
                # would vary the last bits from one bind to the next)
                sums.index_put_((cls.reshape(-1),), integral.reshape(-1),
                                accumulate=True)
        if code is None:
            self._sweep_disp_avg = float(total) / (n * n)
        else:
            self._sweep_disp_class = sums / (n * n)

    def _sweep_remainder_setup(self):
        """Sort the terms sharing the sweep's force group into what one
        gather of positions serves (the plain valence terms, the exception
        add-back and, when its exclusion list is the exception list, the
        reciprocal term's exclusion correction from the same r) and the
        leftovers, each evaluated by its own energy()."""
        term = self._sweep_term
        g = self._sweep_group
        other = [t for t in self.system.terms
                 if t is not term and (g is None or t.force_group == g)]
        exc = term.exception_index
        self._sweep_recip = None
        # the alchemical term adds its exceptions back through its own
        # exception_add_energy (lambda-scaled), and the reciprocal term then
        # evaluates whole, its exclusion correction included
        fuse = exc.shape[0] > 0 and self._sweep_alch is None
        if fuse:
            for t in other:
                if (isinstance(t, EwaldReciprocalTerm) and t.kmax is not None
                        and t.exclusion_index.shape == exc.shape
                        and torch.equal(t.exclusion_index.cpu().long(),
                                        exc.cpu().long())):
                    self._sweep_recip = t
                    break
        self._sweep_valence = []
        self._sweep_leftover = []
        cols = []
        for t in other:
            if t is self._sweep_recip:
                continue
            if type(t) in (HarmonicBondTerm, HarmonicAngleTerm,
                           PeriodicTorsionTerm):
                if t.index.shape[0] == 0:
                    continue   # an empty term contributes exactly 0
                self._sweep_valence.append(t)
                cols += [t.index[:, c] for c in range(t.index.shape[1])]
            else:
                self._sweep_leftover.append(t)
        if fuse:
            cols += [exc[:, 0], exc[:, 1]]
        self._sweep_rows = (torch.cat(cols).long() if cols else None)
        # a batch's remainder under vmap, in chunks that bound the
        # reciprocal space's (N, 2 kmax + 2, 2 kmax + 2) tables
        n = self.system.n_particles
        side = max([2 * int(t.kmax) + 2 for t in other
                    if isinstance(t, EwaldReciprocalTerm)
                    and t.kmax is not None] + [1])
        self._rest_chunk = _vmap_chunk(32 * n * side * side)

    def _resort_sweep(self, state: IntegratorState) -> IntegratorState:
        """Re-sort the sweep ring by current x; invalidates the block bound
        (the next force evaluation rebuilds) and re-scatters the exception
        bitfield for the new order. A batch sorts each replica; their
        bitfield overflow flags are ORed into one."""
        k = self._sweep_kernel
        box = state.box if state.box is not None else self.system.default_box
        x = self._reconstruct(state.positions)
        perm, inv = sweep_nb.sort_for_sweep(x, box, k.n_pad)
        excl, max_sep = sweep_nb.scatter_exclusion_bitfield(
            self._sweep_pairs, inv, k.n_pad, k.mask_rows)
        # the unscaled [sigma, sqrt(eps), charge(, code)] rows in the new
        # order, in the kernels' layout; _sweep_eval folds in any scale
        # parameters
        sigma, sqrt_eps, charge, code = self._sweep_atom_rows
        par = sweep_nb.sorted_params(
            sigma, sqrt_eps, charge, perm.long(), k.n_pad,
            k.input_dtype(state.positions), code)
        overflow = torch.any(max_sep > k.mask_shells)
        if state.sweep_overflow is not None:
            overflow = overflow | state.sweep_overflow
        return state.replace(
            sweep_perm=perm, sweep_inv=inv,
            sweep_snap=torch.zeros_like(state.positions),
            sweep_nblk=torch.full(tuple(x.shape[:-2]), -1, dtype=torch.int32,
                                  device=state.positions.device),
            sweep_excl=excl, sweep_par=par, sweep_overflow=overflow)

    @staticmethod
    def _sweep_dict(state: IntegratorState):
        """The sweep state that _sweep_eval reads and updates."""
        return {"perm": state.sweep_perm, "inv": state.sweep_inv,
                "snap": state.sweep_snap, "nblk": state.sweep_nblk,
                "excl": state.sweep_excl, "par": state.sweep_par}

    def _sweep_rest_energy(self, xx, box, params):
        """Energy of the terms around the sweep kernel: valence terms,
        exception add-back, reciprocal space and leftovers. The parts add
        up in float64, and the large sums among them (the Ewald self energy
        and exclusion correction, about 2e6 kJ/mol each and of opposite
        sign at 24,000 atoms; the exception add-back) accumulate in
        float64: in float32 their roundings moved the water box's total by
        0.25 kJ/mol between two builds of one system (1.25e-5 of U). The
        forces are those of the float32 terms."""
        term = self._sweep_term
        f64 = torch.float64
        tot = torch.zeros((), dtype=f64, device=xx.device)
        X = xx[self._sweep_rows] if self._sweep_rows is not None else None
        off = 0

        def seg(count):
            nonlocal off
            rows = X[off:off + count]
            off += count
            return rows

        for t in self._sweep_valence:
            m = t.index.shape[0]
            if type(t) is HarmonicBondTerm:
                tot = tot + bonded.harmonic_bond_energy_rows(
                    seg(m), seg(m), t.length, t.k).to(f64)
            elif type(t) is HarmonicAngleTerm:
                tot = tot + bonded.harmonic_angle_energy_rows(
                    seg(m), seg(m), seg(m), t.angle, t.k).to(f64)
            else:
                tot = tot + bonded.periodic_torsion_energy_rows(
                    seg(m), seg(m), seg(m), seg(m), t.periodicity, t.phase,
                    t.k).to(f64)
        recip = self._sweep_recip
        m = term.exception_index.shape[0]
        if self._sweep_alch is not None:
            # the kernel masked the exception pairs (the subtract); their own
            # lambda-scaled interaction remains
            tot = tot + term.exception_add_energy(xx, box, params).to(f64)
        elif m > 0:
            # exception pairs REPLACE the combined-rule pair: plain no-cutoff
            # LJ + Coulomb ...
            d = seg(m) - seg(m)
            if term.periodic:
                d = minimum_image(d, box)
            r2 = torch.clamp(torch.sum(d * d, dim=-1), min=1e-12)
            r = torch.sqrt(r2)
            e = (nonbonded.lj_pair(r2, term.exception_sigma,
                                   term.exception_epsilon)
                 + nonbonded.coulomb_pair(r, term.exception_chargeprod,
                                          "no_cutoff"))
            tot = tot + torch.sum(e, dtype=f64)
            if recip is not None:
                # ... and the same r serves the reciprocal term's
                # -erf(alpha r)/r exclusion correction
                tot = tot + recip.exclusion_correction_of_r(
                    recip.effective_charge(params).to(f64), r.to(f64))
        if recip is not None:
            tot = tot + recip.energy_without_exclusions(xx, box, params)
        for t in self._sweep_leftover:
            tot = tot + t.energy(xx, box, params).to(f64)
        return tot

    def _reconstruct(self, x):
        """The virtual sites rebuilt from their parents (x itself without
        sites); a batch rebuilds each replica's."""
        if self._vsites is None:
            return x
        if x.dim() == 3:
            return torch.func.vmap(self._vsites.reconstruct)(x)
        return self._vsites.reconstruct(x)

    def _spread(self, x, f):
        """Forces ``f`` on the reconstructed positions of ``x`` as forces on
        ``x`` (``VirtualSites.spread_forces``, a batch at once)."""
        if x.dim() == 2:
            return self._vsites.spread_forces(x, f)
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self._reconstruct(xx), xx,
                                       grad_outputs=f)
        return g

    def _rest_energies(self, x, box, params):
        """:meth:`_sweep_rest_energy` of a batch (B,) float64, under
        vmap."""
        return torch.func.vmap(self._sweep_rest_energy,
                               chunk_size=self._rest_chunk)(x, box, params)

    def _sweep_eval(self, x, box, params, sw, forces=True, rep=None):
        """Energy and forces of the sweep's force group: the sweep kernel
        for the NonbondedTerm's standard pairs plus the remainder with
        autograd forces (``forces=False``: the remainder's energy alone,
        and F None). ``sw`` is a dict of the sweep state; returns (u, F,
        new_sw), u in float64. The rebuild flag stays on the device.

        A batch: ``x`` (R, N, 3), ``box`` (R, 3, 3), ``sw`` the R sort sets
        and ``params`` a dict of (B,) tensors, one evaluation a row; the
        evaluation b takes the configuration ``rep[b]`` (the identity where
        ``rep`` is None, B = R; only energies with ``rep``). One launch of
        each sweep kernel evaluates all B; u is (B,), F (B, N, 3). A single
        evaluation is the batch of one."""
        if x.dim() == 3:
            return self._sweep_eval_batch(x, box, params, sw, forces, rep)
        u, f, new_sw = self._sweep_eval_batch(
            x[None], box[None],
            {k: torch.as_tensor(v, dtype=x.dtype, device=x.device).reshape(1)
             for k, v in (params or {}).items()},
            {k: v[None] for k, v in sw.items()}, forces)
        return (u[0], None if f is None else f[0],
                {k: v[0] for k, v in new_sw.items()})

    def _sweep_eval_batch(self, x, box, params, sw, forces=True, rep=None):
        x_in = x
        x = self._reconstruct(x)
        k = self._sweep_kernel
        term = self._sweep_term
        n = self.system.n_particles
        dtype = k.input_dtype(x)
        perm = sw["perm"].long()
        y, xT = sweep_nb.sorted_positions(x, box, perm, k.n_pad, dtype)
        lengths = _box_lengths(box)
        disp = y - sw["snap"]
        disp = disp - lengths[:, None, :] * torch.round(
            disp / lengths[:, None, :])
        moved = torch.amax(torch.sum(disp * disp, dim=-1), dim=-1) > (
            0.5 * k.skin) ** 2
        rebuild = (sw["nblk"] < 0) | moved

        par = sw["par"] if rep is None else sw["par"][rep]
        batch = par.shape[0]
        lj_scale = None
        lam = lam_s_cls = None
        alch = self._sweep_alch
        if alch is not None:
            # the kernel's per-class scalars of each evaluation, from its
            # parameters by tensor operations on the device; 'exact' scales
            # the charges by region
            def scalars(p):
                out = alch.sweep_lambdas(p, xT)
                return out if out[2] is not None else out[:2]

            out = _per_item(scalars, params, batch)
            lam, lam_s_cls = out[0].to(dtype).contiguous(), out[1]
            if len(out) == 3:
                par = sweep_nb.scale_charges_by_code(par, out[2])
        elif (term.lj_scale_param is not None
                or term.charge_scale_param is not None):
            # global charge/lj scale parameters fold into the per-atom
            # rows: q -> q scale and sqrt_eps -> sqrt_eps sqrt(lj_scale)
            one = torch.ones((batch,), dtype=dtype, device=x.device)
            scale = [one, one, one]
            if term.lj_scale_param is not None:
                lj_scale = params.get(term.lj_scale_param)
                if lj_scale is None:
                    lj_scale = torch.ones((batch,), dtype=x.dtype,
                                          device=x.device)
                scale[1] = torch.sqrt(lj_scale.to(dtype))
            if term.charge_scale_param is not None:
                q_scale = params.get(term.charge_scale_param)
                if q_scale is not None:
                    scale[2] = q_scale.to(dtype)
            par = par * torch.stack(scale, dim=-1)[:, :, None]
        L = lengths.to(dtype).contiguous()
        rep_k = None
        if rep is not None:
            rep_k = rep.to(device=x.device, dtype=torch.int32)
        F_s, u_s, nblk = k.evaluate(xT, par.contiguous(), sw["excl"], L,
                                    rebuild, sw["nblk"], lam, rep_k)
        if rep is None:
            x_r, box_r, lengths_r = x, box, lengths
        else:
            x_r, box_r, lengths_r = x[rep], box[rep], lengths[rep]
        if forces:
            inv = sw["inv"].long()[..., None].expand(x.shape)
            F_direct = torch.gather(F_s.transpose(-1, -2), -2, inv).to(
                x.dtype)
            u_r, g_r = batched_value_and_grad(
                lambda xx: self._rest_energies(xx, box, params), x)
        else:
            with torch.no_grad():
                u_r = self._rest_energies(x_r, box_r, params)
        # the parts add up in float64, as OpenMM's mixed precision sums
        # energies: a float32 total of 24,000 waters (-3.2e5 kJ/mol) moves
        # in steps of 0.03 kJ/mol, and the nonequilibrium work is a sum of
        # differences of such totals
        u = u_s.to(torch.float64) + u_r.to(torch.float64)
        volume = torch.prod(lengths_r.to(torch.float64), dim=-1)
        if self._sweep_disp_avg is not None:
            tail = (2.0 * math.pi * n * n / volume) * self._sweep_disp_avg
            if lj_scale is not None:
                tail = tail * lj_scale   # eps_ij scales linearly in lj_scale
            u = u + tail
        elif self._sweep_disp_class is not None:
            # class sums (env-env first) weighted by lam_s^a per class
            weights = torch.cat([torch.ones((batch, 1), dtype=torch.float64,
                                            device=x.device),
                                 lam_s_cls.to(torch.float64)], dim=-1)
            u = u + (2.0 * math.pi * n * n / volume) * torch.sum(
                self._sweep_disp_class * weights, dim=-1)
        new_sw = dict(sw)
        new_sw["snap"] = torch.where(rebuild[:, None, None], y, sw["snap"])
        new_sw["nblk"] = nblk
        if not forces:
            return u, None, new_sw
        f = F_direct - g_r
        if self._vsites is not None:
            f = self._spread(x_in, f)
        return u, f, new_sw

    # -- energies at other parameters (the multistate energy matrix) -------
    def _group_energy_forces(self, g, x, box, params, sw, forces=True):
        """(U, F, sw) of force group ``g`` by the path the step program
        takes: sweep mode for the sweep's group, else the group's own
        (``forces=False``: F None)."""
        if sw is not None and g == self._sweep_group:
            return self._sweep_eval(x, box, params, sw, forces=forces)
        if forces:
            u, f = self._ef_fns[g](x, box, params)
            return u, f, sw
        with torch.no_grad():
            return self._e_fns[g](x, box, params), None, sw

    def _path_inputs(self, x, box, params_list):
        """The box, the sweep state of a fresh sort of ``x`` (None off
        sweep mode), that sort's exclusion-bitfield overflow flag (a device
        bool, None off sweep mode) and the parameter dicts as tensors on
        ``x``'s device. Raises where the dense O(N^2) sum would serve a
        system of ``DENSE_LIMIT`` atoms or more on the card: there sweep
        mode should have engaged. ``x`` may be a batch (R, N, 3) with its
        boxes (R, 3, 3)."""
        if box is None:
            box = self.system.default_box
            if x.dim() == 3 and box is not None:
                box = box.expand((x.shape[0],) + box.shape)
        self._refuse_dense(x)
        sw = overflow = None
        if self.sweep_mode:
            zero = torch.zeros(tuple(x.shape[:-2]), dtype=x.dtype,
                               device=x.device)
            state = self._resort_sweep(IntegratorState(
                positions=x, velocities=x, kT=zero, box=box))
            sw, overflow = self._sweep_dict(state), state.sweep_overflow
        params_list = [{k: torch.as_tensor(v, dtype=x.dtype, device=x.device)
                        for k, v in (params or {}).items()}
                       for params in params_list]
        return box, sw, overflow, params_list

    def _refuse_dense(self, x):
        n = self.system.n_particles
        if (self._fused is None and not self.sweep_mode
                and x.device.type == "cuda" and n >= DENSE_LIMIT):
            raise IntegratorError(
                f"sweep mode is off for a {n}-atom system on the card; the "
                "energies would take the dense O(N^2) sum")

    def check_sweep_overflow(self, flag):
        """Raise while ``flag`` (a device bool, or None off sweep mode) is
        set: an exception pair's sorted separation exceeded the bitfield's
        ``mask_shells``, so its full interaction was evaluated at bonded
        distance and the energies are wrong. One host read."""
        if flag is not None and bool(flag):
            raise IntegratorError(
                "sweep kernel exclusion-bitfield overflow: an exception "
                "pair's sorted separation exceeded mask_shells="
                f"{self._sweep_kernel.mask_shells}; forces are wrong. "
                "Disable sweep mode (integrator.sweep=None).")

    def energies_batch(self, x, box, rep, params):
        """Potential energies (B,) float64 of B (configuration, parameters)
        pairs, and the overflow flag of the configurations' fresh sorts (a
        device bool, None off sweep mode): ``x`` (R, N, 3) configurations
        with their boxes (R, 3, 3) (None: the default box), ``rep`` (B,)
        int64 the configuration of each pair, ``params`` a dict of (B,)
        tensors, each pair's global parameters. By the path the step program
        takes: in sweep mode one sort of each configuration, then ONE launch
        of each sweep kernel for all B pairs and the rest of each force
        group under vmap; on the fused path K1's force kernel once a
        configuration (it reads no global parameter); else each force
        group's dense function under vmap. The caller checks the flag
        (:meth:`check_sweep_overflow`)."""
        default = self.system.default_box
        if box is None and default is not None:
            box = default.expand((x.shape[0],) + default.shape)
        self._refuse_dense(x)
        rep = torch.as_tensor(rep, device=x.device).long()
        if self._fused is not None:
            u = torch.stack([self._fused_energy_forces(x[r], box[r])[0]
                             for r in range(x.shape[0])])
            return u.to(torch.float64)[rep], None
        box, sw, overflow, _ = self._path_inputs(x, box, [])
        total = torch.zeros((rep.shape[0],), dtype=torch.float64,
                            device=x.device)
        for g in self.groups:
            if sw is not None and g == self._sweep_group:
                u, _, sw = self._sweep_eval(x, box, params, sw, forces=False,
                                            rep=rep)
            else:
                with torch.no_grad():
                    u = self._dense_energies(g, x[rep], box, rep, params)
            total = total + u.to(torch.float64)
        return total, overflow

    def _dense_energies(self, g, x, box, rep, params):
        """Force group ``g``'s dense energy of a batch ``x`` (B, N, 3) at
        ``params`` (B,), under vmap; ``box`` (R, 3, 3) indexed by ``rep``
        (None: the identity), or None for a non-periodic system."""
        n = self.system.n_particles
        chunk = _vmap_chunk(128 * n * n)
        if box is None:
            return _per_item(lambda p, xx: self._e_fns[g](xx, None, p),
                             params, x.shape[0], x, chunk=chunk)
        box = box if rep is None else box[rep]
        return _per_item(lambda p, xx, bb: self._e_fns[g](xx, bb, p),
                         params, x.shape[0], x, box, chunk=chunk)

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
        sets of global parameters, by the path the step program takes: in
        sweep mode one sort of ``x``, then the sweep kernel (and the rest
        of each force group by its own function) at each set; on the fused
        path K1's force kernel (the fused path takes no term that reads
        global parameters: ``fused_lj_eligible``); else each force group's
        dense function. Raises as ``run`` does on an exclusion-bitfield
        overflow."""
        u, overflow = self.energies_and_overflow_at(x, box, params_list)
        self.check_sweep_overflow(overflow)
        return u

    def energy_forces_at(self, x, box, params):
        """(U float64, F) of ``x`` at the global parameters ``params`` by
        the step program's path, on a fresh sort in sweep mode; raises as
        ``run`` does on an exclusion-bitfield overflow."""
        box, sw, overflow, (params,) = self._path_inputs(x, box, [params])
        if self._fused is not None:
            u, f = self._fused_energy_forces(x, box)
            return u.to(torch.float64), f.to(x.dtype)
        total_u = torch.zeros((), dtype=torch.float64, device=x.device)
        total_f = torch.zeros_like(x)
        for g in self.groups:
            u, f, sw = self._group_energy_forces(g, x, box, params, sw)
            total_u = total_u + u.to(torch.float64)
            total_f = total_f + f
        self.check_sweep_overflow(overflow)
        return total_u, total_f

    def _fused_setup(self):
        """Enable the fused Langevin kernel for the production case: a plain
        R/V/O splitting of a monodisperse uncharged periodic LJ fluid with no
        constraints, on a CUDA device. Same rules as the JAX package's TPU
        path, with "the system lives on a CUDA device" in place of "the
        backend is a TPU", and three more: the term must read no global
        LJ scale (``fused_lj_eligible``), since the kernel integrates at
        the term's own epsilon; the splitting's step program must fit the
        chunk kernel's table (``fits_chunk_table``), where the TPU kernel
        unrolls any token string; and the class must run this module's
        step program (``brings_own_step``), where the JAX package would
        hand an extras subclass's splitting to its TPU kernel. Everything
        else takes sweep mode or the generic program."""
        integ = self.integrator
        if integ.neighborlist is None or self._own_step:
            return
        system = self.system
        if system.device.type != "cuda":
            return
        if not set(self.tokens) <= {"R", "V", "O"}:
            return   # Metropolization/MTS/H need the generic emitters
        if integ.measure_shadow_work or integ.measure_heat:
            return
        if not fused_lj_eligible(system):
            return
        from openmmtools_tpu_torch.ops.fused_langevin import (
            FusedSortedBAOAB,
            fits_chunk_table,
        )

        if not fits_chunk_table(self.tokens):
            return   # the chunk kernel's step-program table cannot hold it

        term = system.terms[0]
        self.sweep_mode = False   # the fused kernel supersedes the sweep
        self.neighbor_mode = False
        self._fused_term = term
        self._fused = FusedSortedBAOAB(
            system.n_particles, float(term.cutoff), term.switch_width,
            float(term.sigma[0]), float(term.epsilon[0]),
            float(system.masses[0]), integ.timestep, integ.collision_rate,
            tokens=tuple(self.tokens))

    # -- energy plumbing ----------------------------------------------------
    def _ensure_forces(self, env: _Env, groups=None):
        for g in (self.groups if groups is None else groups):
            if env.F[g] is None:
                if (self.sweep_mode and g == self._sweep_group
                        and env.sweep is not None):
                    env.U[g], env.F[g], env.sweep = self._sweep_eval(
                        env.x, env.box, env.params, env.sweep)
                else:
                    env.U[g], env.F[g] = self._eval_group(
                        g, env.x, env.box, env.params, nbr=env.nbr)

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

    def _per_replica(self, fn, a, b):
        """``fn`` of a batch, replica by replica: under vmap, except for
        Jacobi SHAKE/RATTLE, which iterate to a tolerance read on the
        host."""
        if self._rest_constraints is not None and self._clusters is None:
            return torch.stack([fn(ai, bi) for ai, bi in zip(a, b)])
        return torch.func.vmap(fn)(a, b)

    # -- constraint dispatch: SETTLE + M-SHAKE on disjoint partitions -----
    def _constrain_positions(self, x_new, x_old):
        if x_new.dim() == 3:
            return self._per_replica(self._constrain_positions, x_new, x_old)
        if self._settle is not None:
            x_new = constraints.settle_positions(x_new, x_old, self._settle,
                                                 self.masses)
        if self._rest_constraints is not None:
            tol = self.integrator.constraint_tolerance
            if self._clusters is not None:
                x_new = constraints.mshake_positions(
                    x_new, x_old, self._rest_constraints, self._clusters,
                    self.masses, tol=tol)
            else:
                x_new = constraints.shake_positions(
                    x_new, x_old, self._rest_constraints, self.masses, tol=tol)
        return x_new

    def _constrain_velocities(self, x, v):
        if v.dim() == 3:
            return self._per_replica(self._constrain_velocities, x, v)
        if self._settle is not None:
            v = constraints.settle_velocities(x, v, self._settle, self.masses)
        if self._rest_constraints is not None:
            if self._clusters is not None:
                v = constraints.mrattle_velocities(
                    x, v, self._rest_constraints, self._clusters, self.masses)
            else:
                v = constraints.rattle_velocities(
                    x, v, self._rest_constraints, self.masses,
                    tol=self.integrator.constraint_tolerance)
        return v

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
        for g in self.groups:
            env.U[g] = None
            env.F[g] = None
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
            for g in self.groups:
                env.U[g] = None
                env.F[g] = None
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
        inside a run: the RATTLE projection P is linear and idempotent in v
        (it depends on x only), so for adjacent velocity substeps at
        unchanged x, P(P(v + d1) + d2) == P(v + d1 + d2) -- the next step's
        leading V/O projection subsumes the trailing one. Requires
        constraints; a splitting that starts and ends with a projecting
        velocity substep (V/Vn/O); no Metropolis block (it stashes projected
        velocities); no kinetic-energy measurement (shadow work and heat read
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
        skip_idx = len(self.tokens) - 1 if skip_trailing_vproj else -1
        env = _Env()
        env.x = state.positions
        env.v = state.velocities
        env.generator = state.generator
        env.kT = state.kT
        env.box = state.box
        env.params = state.global_params
        has_cache = len(state.forces) == len(self.groups)
        for i, g in enumerate(self.groups):
            env.F[g] = state.forces[i] if has_cache else None
            env.U[g] = state.potentials[i] if has_cache else None
        env.heat = state.heat
        env.shadow_work = state.shadow_work
        env.protocol_work = state.protocol_work
        env.n_accepted = state.n_accepted
        env.n_proposed = state.n_proposed
        env.lambda_ = state.lambda_
        env.lambda_step = state.lambda_step
        env.step_count = state.step_count
        env.nbr = self._state_nbr(state)
        if self.sweep_mode and state.sweep_perm is not None:
            env.sweep = self._sweep_dict(state)

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
        if env.sweep is not None:
            state = state.replace(sweep_snap=env.sweep["snap"],
                                  sweep_nblk=env.sweep["nblk"])
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
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        izero = torch.zeros((), dtype=torch.int64, device=x.device)
        state = IntegratorState(
            positions=x, velocities=v, kT=kT, box=box, global_params=params,
            heat=zero, shadow_work=zero, protocol_work=zero,
            n_accepted=izero, n_proposed=izero, lambda_=zero, lambda_step=0,
            step_count=0, generator=generator)
        return self._with_initial_forces(state)

    def initial_state_batch(self, sampler_states: Sequence[SamplerState],
                            generators: Sequence[torch.Generator],
                            temperatures=None,
                            thermodynamic_states=None,
                            global_params=None) -> IntegratorState:
        """One batched state of B replicas (the batched step program's
        input): replica b at ``sampler_states[b]``, drawing from
        ``generators[b]``, at the temperature and global parameters of
        ``thermodynamic_states[b]`` (else ``temperatures`` and
        ``global_params``, one a replica or one for all; else the
        integrator's temperature). Each replica's kT, box and global
        parameters ride in the state, so one bound integrator serves
        replicas at different temperatures and parameters; missing
        velocities are thermalized from the replica's own generator. The
        forces come from one batched evaluation (in sweep mode one launch
        of each sweep kernel); the fused path and neighbour mode build each
        replica's state on its own and stack them."""
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
        if self._fused is not None or self.neighbor_mode:
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
        zero = torch.zeros((n_rep,), dtype=x.dtype, device=x.device)
        izero = torch.zeros((n_rep,), dtype=torch.int64, device=x.device)
        state = IntegratorState(
            positions=x, velocities=v, kT=kT, box=box, global_params=params,
            heat=zero, shadow_work=zero, protocol_work=zero,
            n_accepted=izero, n_proposed=izero, lambda_=zero, lambda_step=0,
            step_count=0, generator=tuple(generators))
        return self._with_initial_forces(state)

    def _with_initial_forces(self, state: IntegratorState) -> IntegratorState:
        """``state`` with the forces and potentials of its positions (a
        fresh sort in sweep mode, a list built here in neighbour mode), so
        that the first V substep is exact."""
        x, box, params = state.positions, state.box, state.global_params
        if self._fused is not None:
            u, f = self._fused_energy_forces(x, box)
            return state.replace(forces=(f,), potentials=(u,))
        sw = None
        if self.sweep_mode:
            state = self._resort_sweep(state)
            sw = self._sweep_dict(state)
        if self.neighbor_mode:
            state = self._rebuild_neighbors(state)
        nbr = self._state_nbr(state)
        forces, potentials = [], []
        for g in self.groups:
            if sw is not None and g == self._sweep_group:
                u, f, sw = self._sweep_eval(x, box, params, sw)
                state = state.replace(sweep_snap=sw["snap"],
                                      sweep_nblk=sw["nblk"])
            else:
                u, f = self._eval_group(g, x, box, params, nbr=nbr)
            potentials.append(u)
            forces.append(f)
        return state.replace(forces=tuple(forces),
                             potentials=tuple(potentials))

    def run_program(self, n_steps: int):
        """The function state -> state advancing ``n_steps`` steps. In sweep
        mode the sweep ring is re-sorted every ``sweep_sort_interval`` steps
        (and at the start of the run), in neighbour mode the list is rebuilt
        every ``neighbor_rebuild_interval`` steps (and at the start of the
        run); with the trailing-projection skip the final state's
        velocities are projected once at the end."""
        def steps(state, count):
            for _ in range(count):
                state = self.step(state, skip_trailing_vproj=self._vproj_skip)
            return state

        def chunked(state, refresh, interval):
            n_chunks, remainder = divmod(n_steps, interval)
            for _ in range(n_chunks):
                state = steps(refresh(state), interval)
            if remainder:
                state = steps(refresh(state), remainder)
            return state

        def run_fn(state):
            if self.sweep_mode:
                state = chunked(state, self._resort_sweep,
                                self.sweep_sort_interval)
            elif self.neighbor_mode:
                state = chunked(state, self._rebuild_neighbors,
                                self.neighbor_rebuild_interval)
            else:
                state = steps(state, n_steps)
            if self._vproj_skip and n_steps > 0:
                state = state.replace(velocities=self._constrain_velocities(
                    state.positions, state.velocities))
            return state
        return run_fn

    def run(self, state: IntegratorState, n_steps: int) -> IntegratorState:
        """Advance ``n_steps``: through the fused kernel when eligible
        (``_fused_setup``), else through the step program (sweep mode or
        generic). In sweep mode one host read per call checks the sticky
        exclusion-bitfield overflow flag and raises while it is set: an
        exception pair outside the bitfield's coverage would have had its
        full interaction evaluated at bonded distance. In neighbour mode the
        state carries the list's sticky overflow flag (``nbr_overflow``), as
        in the JAX package, and the caller reads it once (the MCMC moves
        raise on it). A batched state (:meth:`initial_state_batch`) advances
        its replicas together through the step program; on the fused path
        and in neighbour mode one replica at a time."""
        if state.positions.dim() == 3 and (self._fused is not None
                                           or self.neighbor_mode):
            return stack_states([self.run(s, n_steps)
                                 for s in unstack_states(state)])
        if self._fused is None:
            state = self.run_program(n_steps)(state)
            if self.sweep_mode:
                self.check_sweep_overflow(state.sweep_overflow)
            return state
        box = state.box if state.box is not None else self.system.default_box
        x, v, f, u = self._fused.run(state.positions, state.velocities, box,
                                     state.kT, state.generator, n_steps)
        return state.replace(positions=x, velocities=v, forces=(f,),
                             potentials=(self._fused_total(u, box),),
                             step_count=state.step_count + n_steps)

    def _fused_total(self, u, box):
        """The fused kernel's pair energy ``u`` plus the dispersion
        correction where the term asks for it."""
        term = self._fused_term
        if not term.use_dispersion_correction:
            return u
        from openmmtools_tpu_torch.ops.nonbonded import (
            dispersion_correction_energy,
        )

        return u + dispersion_correction_energy(
            box, term.sigma, term.epsilon, term.cutoff)

    def _fused_energy_forces(self, x, box):
        """(U, F) of positions x (N, 3) by the fused path's force kernel
        (one launch of K1's ``lj_forces_kernel``), float32 as ``run``
        returns them."""
        xT = x.detach().t().to(torch.float32).contiguous()
        L = torch.diagonal(box).to(torch.float32).contiguous()
        F, U = self._fused.forces(xT, L)
        return self._fused_total(U[0], box), F.t().contiguous()

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
    "auto", see ``BoundIntegrator._neighbor_setup``) takes the same
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
