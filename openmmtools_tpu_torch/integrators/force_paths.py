"""The force paths: which code evaluates a bound integrator's forces and
energies, chosen once when it binds.

The layers, from the top: a sampler hands states to a move, the move to a
bound integrator (:mod:`openmmtools_tpu_torch.integrators.langevin`: the
step program and the state constructors), which evaluates forces through
its force path here and projects constraints through its
:class:`~openmmtools_tpu_torch.ops.constraints.ConstraintSolver`; both
call the kernels of :mod:`openmmtools_tpu_torch.ops`.

:func:`choose_path` takes the first of :class:`FusedPath` (K1),
:class:`SweepPath` (K2) and :class:`NeighborPath` whose ``build`` rules
hold for the integrator's options, the system and the step program, else
:class:`DensePath`. Every path gives the integrator one interface: its
``name`` and flags (``per_replica``, ``graphable``, ``dense_sums``,
``batches_energies``); ``refresh`` every ``refresh_interval`` steps;
``context``/``store``, the part of the state its evaluations thread;
``evaluate`` of one force group and ``evaluate_groups`` of several; and
the whole-state entry points (``initial_forces``, ``energy_forces_at``,
``energies_batch``, ``run``, ``check_overflow``).
"""
from __future__ import annotations

import logging
import math

import torch

from openmmtools_tpu_torch.alchemy import AlchemicalNonbondedTerm
from openmmtools_tpu_torch.constants import kB
from openmmtools_tpu_torch.ops import bonded, nonbonded, sweep_nb
from openmmtools_tpu_torch.ops.geometry import minimum_image
from openmmtools_tpu_torch.ops.pme import EwaldReciprocalTerm
from openmmtools_tpu_torch.system import (
    DENSE_LIMIT,
    HarmonicAngleTerm,
    HarmonicBondTerm,
    NonbondedTerm,
    PeriodicTorsionTerm,
    System,
    make_energy_fn,
    make_energy_force_fn,
)
from openmmtools_tpu_torch.utils import tracing

logger = logging.getLogger(__name__)

# bytes a torch.func.vmap chunk of the batched energies may hold: the
# dense program holds a dozen or so (N, N) tensors a configuration, the
# reciprocal space (N, 2 kmax + 2, 2 kmax + 2) tables
_VMAP_BYTES = 1 << 31


class IntegratorError(Exception):
    """An integrator cannot serve a system or a state (re-exported by
    :mod:`openmmtools_tpu_torch.integrators.langevin`)."""


def _vmap_chunk(per_item_bytes):
    """Configurations a vmap chunk evaluates at once."""
    return max(1, _VMAP_BYTES // max(1, int(per_item_bytes)))


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


def fused_lj_eligible(system: System) -> bool:
    """Whether the fused LJ kernel (K1) can integrate ``system``: one
    uncharged periodic LJ ``NonbondedTerm`` (cutoff, no exceptions, no
    global LJ scale parameter: the kernel reads no parameters) of uniform
    sigma, epsilon and mass, no constraints, 192 to 32,768 particles in an
    orthorhombic box at least twice the cutoff."""
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


def choose_path(integrator, system, tokens, groups):
    """The force path of ``system`` under ``integrator``'s options and the
    step program's ``tokens`` and force ``groups``: the first of the fused,
    sweep and neighbour paths whose rules hold, else the dense program."""
    for path in (FusedPath, SweepPath, NeighborPath):
        chosen = path.build(integrator, system, tokens, groups)
        if chosen is not None:
            return chosen
    return DensePath(system, groups)


class DensePath:
    """Each force group's dense energy function, forces by autograd; a
    batch (B, N, 3) under ``torch.func.vmap``, each replica's forces by
    autograd of the summed energies. The other paths evaluate what they do
    not serve this way."""

    name = "dense"
    refresh_interval = None     # steps between refreshes; None: none
    per_replica = False         # a batch runs one replica at a time
    graphable = False           # the step may be one CUDA graph
    dense_sums = True           # the whole-state energies sum densely
    batches_energies = False    # energies_batch: one launch for all pairs

    def __init__(self, system, groups):
        self.system = system
        self.groups = groups
        self.ef_fns = {g: make_energy_force_fn(
            system, groups=None if g is None else [g]) for g in groups}
        self.e_fns = {g: make_energy_fn(
            system, groups=None if g is None else [g]) for g in groups}
        # massless virtual sites, which the step never moves: the sweep and
        # the neighbour path rebuild them from their parents before they
        # read the positions (None for a system without them)
        vsites = system.virtual_sites
        self.vsites = (vsites if vsites is not None and vsites.n_sites > 0
                       else None)

    def refresh(self, state):
        """``state`` ready for the next ``refresh_interval`` steps."""
        return state

    def context(self, state):
        """What evaluations of ``state`` thread (None here)."""
        return None

    def store(self, state, ctx):
        """``state`` with what the evaluations changed of ``ctx``."""
        return state

    def fresh(self, x, box):
        """The box (else the default, one a configuration of a batch), and
        a fresh refresh's context at ``x`` with its overflow flag (None
        here). Raises where the dense O(N^2) sum would serve a system of
        ``DENSE_LIMIT`` atoms or more on the card."""
        if box is None:
            box = self.system.default_box
            if x.dim() == 3 and box is not None:
                box = box.expand((x.shape[0],) + box.shape)
        n = self.system.n_particles
        if self.dense_sums and x.device.type == "cuda" and n >= DENSE_LIMIT:
            raise IntegratorError(
                f"sweep mode is off for a {n}-atom system on the card; the "
                "energies would take the dense O(N^2) sum")
        return box, None, None

    def check_overflow(self, flag):
        """Raise while the sweep's overflow ``flag`` is set (none here)."""

    def evaluate(self, g, x, box, params, ctx, forces=True, rep=None):
        """(U, F, ctx) of force group ``g`` at ``x`` (N, 3) or a batch (B,
        N, 3); with ``rep`` (B,) the energies (F None) of B pairs, pair b
        at configuration ``x[rep[b]]`` and the parameters' row b. Only the
        sweep's group heeds ``forces=False``."""
        if rep is not None:
            with torch.no_grad():
                return (self._dense_energies(g, x[rep], box, rep, params),
                        None, ctx)
        if x.dim() == 3:
            u, grad = batched_value_and_grad(
                lambda xx: self._dense_energies(g, xx, box, None, params), x)
            return u, -grad, ctx
        u, f = self.ef_fns[g](x, box, params)
        return u, f, ctx

    def evaluate_groups(self, x, box, params, ctx, groups=None, forces=True,
                        rep=None):
        """(U list, F list, ctx) of ``groups`` (None: every group of the
        splitting) by :meth:`evaluate`, threading ``ctx``."""
        us, fs = [], []
        for g in self.groups if groups is None else groups:
            u, f, ctx = self.evaluate(g, x, box, params, ctx, forces, rep)
            us.append(u)
            fs.append(f)
        return us, fs, ctx

    def _dense_energies(self, g, x, box, rep, params):
        """Force group ``g``'s dense energy of a batch ``x`` (B, N, 3) at
        ``params`` (B,), under vmap; ``box`` (R, 3, 3) indexed by ``rep``
        (None: the identity), or None for a non-periodic system."""
        n = self.system.n_particles
        chunk = _vmap_chunk(128 * n * n)
        e_fn = self.e_fns[g]
        if box is None:
            return _per_item(lambda p, xx: e_fn(xx, None, p),
                             params, x.shape[0], x, chunk=chunk)
        box = box if rep is None else box[rep]
        return _per_item(lambda p, xx, bb: e_fn(xx, bb, p),
                         params, x.shape[0], x, box, chunk=chunk)

    # -- the whole-state entry points ----------------------------------------
    def initial_forces(self, state):
        """``state`` refreshed, with the forces and potentials of its
        positions."""
        state = self.refresh(state)
        us, fs, ctx = self.evaluate_groups(state.positions, state.box,
                                           state.global_params,
                                           self.context(state))
        return self.store(state, ctx).replace(forces=tuple(fs),
                                              potentials=tuple(us))

    def energy_forces_at(self, x, box, params):
        """(U float64, F) of ``x`` at ``params`` on a fresh refresh."""
        box, ctx, overflow = self.fresh(x, box)
        params = {k: torch.as_tensor(v, dtype=x.dtype, device=x.device)
                  for k, v in (params or {}).items()}
        total_u = torch.zeros((), dtype=torch.float64, device=x.device)
        total_f = torch.zeros_like(x)
        us, fs, _ = self.evaluate_groups(x, box, params, ctx)
        for u, f in zip(us, fs):
            total_u = total_u + u.to(torch.float64)
            total_f = total_f + f
        self.check_overflow(overflow)
        return total_u, total_f

    def energies_batch(self, x, box, rep, params):
        """(U (B,) float64, overflow flag) of B (configuration, parameters)
        pairs (``BoundIntegrator.energies_batch``)."""
        rep = torch.as_tensor(rep, device=x.device).long()
        box, ctx, overflow = self.fresh(x, box)
        total = torch.zeros((rep.shape[0],), dtype=torch.float64,
                            device=x.device)
        us, _, _ = self.evaluate_groups(x, box, params, ctx, forces=False,
                                        rep=rep)
        for u in us:
            total = total + u.to(torch.float64)
        return total, overflow

    def run(self, state, n_steps, program):
        """``state`` advanced ``n_steps`` by the step program
        (``program(n_steps)``, the bound integrator's ``run_program``),
        then :meth:`check_overflow` of its flag."""
        state = program(n_steps)(state)
        self.check_overflow(state.sweep_overflow)
        return state


class NeighborPath(DensePath):
    """The NonbondedTerm over a fixed-capacity neighbour list
    (:mod:`openmmtools_tpu_torch.ops.neighborlist`) rebuilt every
    ``refresh_interval`` steps, the rest dense, forces by autograd; the
    list's sticky overflow flag rides in the state for the caller. The
    list serves the step; the whole-state energies take the dense sum."""

    name = "neighbour list"
    per_replica = True

    @classmethod
    def build(cls, integ, system, tokens, groups):
        """The path for one periodic cutoff NonbondedTerm and one force
        group, from 128 particles on the CPU and 100,000 on the card (the
        JAX package's CPU and TPU thresholds); else None. The list radius
        is cutoff + ``neighbor_skin`` (default 0.35 cutoff), its capacity
        ceil(2.5 avg + 8) for the average count within it, the rebuild
        interval by default the steps in which four times the fastest
        thermal speed drifts skin/2, at most 200."""
        if (integ.neighborlist is None or groups != [None]
                or system.default_box is None):
            return None
        nb_terms = [t for t in system.terms
                    if isinstance(t, NonbondedTerm) and t.cutoff is not None
                    and t.method != "no_cutoff" and t.periodic]
        min_particles = 128 if system.device.type == "cpu" else 100_000
        if len(nb_terms) != 1 or system.n_particles < min_particles:
            return None
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
        path = cls(system, groups)
        path.term = term
        path.other = tuple(t for t in system.terms if t is not term)
        path.k_max, path.r_list = k_max, r_list
        path.refresh_interval = interval
        return path

    def _energy(self, x, box, params, nbr):
        """The whole system's energy with the NonbondedTerm over ``nbr``."""
        if self.vsites is not None:
            x = self.vsites.reconstruct(x)
        total = self.term.energy_neighbors(x, box, params, nbr)
        for t in self.other:
            total = total + t.energy(x, box, params)
        return total

    def build_list(self, x, box):
        """A fresh list at ``x`` (its virtual sites rebuilt first)."""
        from openmmtools_tpu_torch.ops.neighborlist import build_neighbor_list

        x = x.detach()
        if self.vsites is not None:
            x = self.vsites.reconstruct(x)   # the sites where they are now
        return build_neighbor_list(x, box, self.r_list, self.k_max,
                                   periodic=True)

    def refresh(self, state):
        """A fresh list at the state's positions; the overflow flag stays
        set once set. A list built at these very positions (the state's
        tensor itself, as ``initial_state`` leaves it for ``run``) is kept:
        the build is O(N^2)."""
        if state.nbr_idx is not None and state.nbr_at is state.positions:
            return state
        box = state.box if state.box is not None else self.system.default_box
        nbr = self.build_list(state.positions, box)
        overflow = nbr.overflow
        if state.nbr_overflow is not None:
            overflow = overflow | state.nbr_overflow
        return state.replace(nbr_idx=nbr.idx, nbr_mask=nbr.mask,
                             nbr_overflow=overflow, nbr_at=state.positions)

    def context(self, state):
        """The state's list as a NeighborList (None without one)."""
        if state.nbr_idx is None:
            return None
        from openmmtools_tpu_torch.ops.neighborlist import NeighborList

        return NeighborList(idx=state.nbr_idx, mask=state.nbr_mask,
                            overflow=state.nbr_overflow, r_list=self.r_list)

    def evaluate(self, g, x, box, params, ctx, forces=True, rep=None):
        """Over the list ``ctx`` for a single configuration (autograd by
        ``langevin.value_and_grad``, which a caller may wrap), else dense."""
        if ctx is None or x.dim() == 3 or rep is not None:
            return super().evaluate(g, x, box, params, ctx, forces, rep)
        from openmmtools_tpu_torch.integrators import langevin

        u, grad = langevin.value_and_grad(
            lambda xx: self._energy(xx, box, params, ctx), x)
        return u, -grad, ctx


class SweepPath(DensePath):
    """The bounded-sweep kernel (K2) for the NonbondedTerm's standard pair
    sum (exception pairs masked), the rest of its force group (the
    remainder: valence terms, exception add-back, reciprocal space,
    leftovers) as tensor code with autograd forces, other MTS groups dense.
    The context is the sweep state (the sort, exclusion bitfield, sorted
    parameters and block bound), re-sorted every ``refresh_interval``
    steps. Virtual sites are rebuilt before each sort and evaluation, their
    forces spread back onto their parents."""

    graphable = True
    dense_sums = False
    batches_energies = True

    @classmethod
    def build(cls, integ, system, tokens, groups):
        """The path for a periodic system with a real force field, else
        None. An AlchemicalNonbondedTerm takes the alchemical variant for
        the factory's softcore (beta = 0, c = 6); any other keeps the dense
        path, with a warning from ``DENSE_LIMIT`` atoms. ``sweep="auto"``
        engages on a CUDA system with N >= 1024, "force" (or "interpret")
        on any device, the CPU running the kernels' plain versions."""
        policy = integ.sweep
        if policy is None or system.default_box is None:
            return None
        nb_terms = [t for t in system.terms
                    if type(t) in (NonbondedTerm, AlchemicalNonbondedTerm)]
        if len(nb_terms) != 1:
            return None
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
            return None
        # the sweep serves the force group holding the NonbondedTerm; with
        # numbered Vn splittings (MTS) the other groups evaluate normally
        if groups == [None]:
            group = None
        elif term.force_group in groups:
            group = term.force_group
        else:
            return None
        if (term.method not in ("pme", "ewald", "cutoff_periodic")
                or term.cutoff is None):
            return None
        if policy == "auto" and (system.device.type != "cuda"
                                 or system.n_particles < 1024):
            return None
        diag = torch.diagonal(system.default_box).cpu()
        if float(term.cutoff) > 0.5 * float(diag.min()):
            return None
        return cls(integ, system, groups, term, group)

    def __init__(self, integ, system, groups, term, group):
        super().__init__(system, groups)
        alchemical = type(term) is AlchemicalNonbondedTerm
        n = self.system.n_particles
        n_pad = -(-n // 128) * 128
        mask_shells = min(2048, max(32, (n_pad // 2 // 32) * 32))
        self.kernel = sweep_nb.SweepNonbonded(
            n, term.method, float(term.cutoff),
            switch_width=term.switch_width, dielectric=term.dielectric,
            ewald_alpha=term.ewald_alpha, shift_rf=term.shift_rf,
            switch_coulomb=term.switch_coulomb,
            shell_block=integ.sweep_shell_block or 8,
            skin=integ.neighbor_skin or 0.1, mask_shells=mask_shells,
            n_regions=term.n_regions if alchemical else None,
            coulomb_pme_treatment=(alchemical
                                   and term.coulomb_pme_treatment))
        self.name = "K2-alchemical" if alchemical else "K2"
        self.group = group
        self.term = term
        self.alch = term if alchemical else None
        self.pairs = sweep_nb.unique_pairs(term.exception_index)
        # the unsorted per-atom rows (sigma, sqrt(eps), charge, region
        # code); an alchemical term's sigma clamped to 1e-6
        self.atom_rows = sweep_nb.term_params(term)
        self.refresh_interval = integ.sweep_sort_interval or 100
        self._remainder_setup()
        self._tail_setup()

    def _tail_setup(self):
        """The dispersion tail's pair-averaged integral, once, in float64
        on the system's device, over the atoms' distinct (sigma, epsilon[,
        region code]) rows weighted by their counts, in chunks of rows; for
        an alchemical term one sum per region-pair class (env-env first),
        weighted by each class's lam_s^a at every evaluation."""
        term = self.term
        n = self.system.n_particles
        self.disp_avg = None
        self.disp_class = None
        if not term.use_dispersion_correction:
            return
        sig, _, _, code = self.atom_rows
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
            self.disp_avg = float(total) / (n * n)
        else:
            self.disp_class = sums / (n * n)

    def _remainder_setup(self):
        """Sort the terms sharing the sweep's force group into what one
        gather of positions serves (the plain valence terms, the exception
        add-back and, when its exclusion list is the exception list, the
        reciprocal term's exclusion correction from the same r) and the
        leftovers, each evaluated by its own energy()."""
        term = self.term
        g = self.group
        other = [t for t in self.system.terms
                 if t is not term and (g is None or t.force_group == g)]
        exc = term.exception_index
        self.recip = None
        # the alchemical term adds its exceptions back through its own
        # exception_add_energy (lambda-scaled), and the reciprocal term then
        # evaluates whole, its exclusion correction included
        fuse = exc.shape[0] > 0 and self.alch is None
        if fuse:
            for t in other:
                if (isinstance(t, EwaldReciprocalTerm) and t.kmax is not None
                        and t.exclusion_index.shape == exc.shape
                        and torch.equal(t.exclusion_index.cpu().long(),
                                        exc.cpu().long())):
                    self.recip = t
                    break
        self.valence = []
        self.leftover = []
        cols = []
        for t in other:
            if t is self.recip:
                continue
            if type(t) in (HarmonicBondTerm, HarmonicAngleTerm,
                           PeriodicTorsionTerm):
                if t.index.shape[0] == 0:
                    continue   # an empty term contributes exactly 0
                self.valence.append(t)
                cols += [t.index[:, c] for c in range(t.index.shape[1])]
            else:
                self.leftover.append(t)
        if fuse:
            cols += [exc[:, 0], exc[:, 1]]
        self.rows = (torch.cat(cols).long() if cols else None)
        # a batch's remainder under vmap, in chunks that bound the
        # reciprocal space's (N, 2 kmax + 2, 2 kmax + 2) tables
        n = self.system.n_particles
        side = max([2 * int(t.kmax) + 2 for t in other
                    if isinstance(t, EwaldReciprocalTerm)
                    and t.kmax is not None] + [1])
        self.rest_chunk = _vmap_chunk(32 * n * side * side)

    def _sort(self, x, box, overflow=None):
        """The sweep state of a sort of ``x`` (as :meth:`context` gives it;
        the block bound invalid, so the next evaluation rebuilds) and its
        exclusion-bitfield overflow flag ORed into ``overflow``; a batch
        sorts each replica, their flags ORed into one."""
        with tracing.span("integrator.resort"):
            k = self.kernel
            y = self._reconstruct(x)
            perm, inv = sweep_nb.sort_for_sweep(y, box, k.n_pad)
            excl, max_sep = sweep_nb.scatter_exclusion_bitfield(
                self.pairs, inv, k.n_pad, k.mask_rows)
            # the unscaled [sigma, sqrt(eps), charge(, code)] rows in the
            # new order, in the kernels' layout; evaluate_sweep folds in
            # any scale parameters
            sigma, sqrt_eps, charge, code = self.atom_rows
            par = sweep_nb.sorted_params(
                sigma, sqrt_eps, charge, perm.long(), k.n_pad,
                k.input_dtype(x), code)
            flag = torch.any(max_sep > k.mask_shells)
            if overflow is not None:
                flag = flag | overflow
            return {"perm": perm, "inv": inv, "snap": torch.zeros_like(x),
                    "nblk": torch.full(tuple(y.shape[:-2]), -1,
                                       dtype=torch.int32, device=x.device),
                    "excl": excl, "par": par}, flag

    def refresh(self, state):
        """Re-sort the sweep ring by the state's positions; the overflow
        flag stays set once set."""
        box = state.box if state.box is not None else self.system.default_box
        sw, overflow = self._sort(state.positions, box, state.sweep_overflow)
        return state.replace(
            sweep_perm=sw["perm"], sweep_inv=sw["inv"], sweep_snap=sw["snap"],
            sweep_nblk=sw["nblk"], sweep_excl=sw["excl"], sweep_par=sw["par"],
            sweep_overflow=overflow)

    def context(self, state):
        """The sweep state that :meth:`evaluate_sweep` reads and updates
        (None for a state that was never sorted)."""
        if state.sweep_perm is None:
            return None
        return {"perm": state.sweep_perm, "inv": state.sweep_inv,
                "snap": state.sweep_snap, "nblk": state.sweep_nblk,
                "excl": state.sweep_excl, "par": state.sweep_par}

    def store(self, state, ctx):
        if ctx is None:
            return state
        return state.replace(sweep_snap=ctx["snap"], sweep_nblk=ctx["nblk"])

    def fresh(self, x, box):
        box, _, _ = super().fresh(x, box)
        sw, overflow = self._sort(x, box)
        return box, sw, overflow

    def check_overflow(self, flag):
        """Raise while ``flag`` (a device bool, None for none) is set: an
        exception pair's sorted separation exceeded the bitfield's
        ``mask_shells``, so its full interaction was evaluated at bonded
        distance and the energies are wrong. One host read."""
        if flag is None:
            return
        with tracing.span("integrator.overflow_check"):
            overflowed = bool(flag)
        if overflowed:
            raise IntegratorError(
                "sweep kernel exclusion-bitfield overflow: an exception "
                "pair's sorted separation exceeded mask_shells="
                f"{self.kernel.mask_shells}; forces are wrong. "
                "Disable sweep mode (integrator.sweep=None).")

    def evaluate(self, g, x, box, params, ctx, forces=True, rep=None):
        """The sweep's force group by :meth:`evaluate_sweep` where the
        state was sorted, else dense."""
        if ctx is not None and g == self.group:
            return self.evaluate_sweep(x, box, params, ctx, forces, rep)
        return super().evaluate(g, x, box, params, ctx, forces, rep)

    # -- the sweep's force group ---------------------------------------------
    def _rest_energy(self, xx, box, params):
        """Energy of the terms around the sweep kernel: valence terms,
        exception add-back, reciprocal space and leftovers. The parts add
        up in float64, and the large sums among them (the Ewald self energy
        and exclusion correction, about 2e6 kJ/mol each and of opposite
        sign at 24,000 atoms; the exception add-back) accumulate in
        float64: in float32 their roundings moved the water box's total by
        0.25 kJ/mol between two builds of one system (1.25e-5 of U). The
        forces are those of the float32 terms."""
        term = self.term
        f64 = torch.float64
        tot = torch.zeros((), dtype=f64, device=xx.device)
        X = xx[self.rows] if self.rows is not None else None
        off = 0

        def seg(count):
            nonlocal off
            rows = X[off:off + count]
            off += count
            return rows

        for t in self.valence:
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
        recip = self.recip
        m = term.exception_index.shape[0]
        if self.alch is not None:
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
        for t in self.leftover:
            tot = tot + t.energy(xx, box, params).to(f64)
        return tot

    def _rest_energies(self, x, box, params):
        """:meth:`_rest_energy` of a batch (B,) float64, under vmap."""
        return torch.func.vmap(self._rest_energy,
                               chunk_size=self.rest_chunk)(x, box, params)

    def _reconstruct(self, x):
        """The virtual sites rebuilt from their parents (x itself without
        sites); a batch rebuilds each replica's."""
        if self.vsites is None:
            return x
        if x.dim() == 3:
            return torch.func.vmap(self.vsites.reconstruct)(x)
        return self.vsites.reconstruct(x)

    def _spread(self, x, f):
        """Forces ``f`` on the reconstructed positions of ``x`` (B, N, 3)
        as forces on ``x``."""
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self._reconstruct(xx), xx,
                                       grad_outputs=f)
        return g

    def evaluate_sweep(self, x, box, params, sw, forces=True, rep=None):
        """(u float64, F, new_sw) of the sweep's force group: the kernel
        for the NonbondedTerm's standard pairs plus the remainder with
        autograd forces (``forces=False``: F None); ``sw`` the sweep state.
        The rebuild flag stays on the device. A batch: ``x`` (R, N, 3),
        ``box`` (R, 3, 3), ``sw`` the R sort sets, ``params`` (B,) tensors;
        evaluation b takes configuration ``rep[b]`` (the identity where
        ``rep`` is None; only energies with ``rep``), all B in one launch
        of each kernel. A single evaluation is the batch of one."""
        single = x.dim() == 2
        if single:
            x, box = x[None], box[None]
            params = {k: torch.as_tensor(v, dtype=x.dtype,
                                         device=x.device).reshape(1)
                      for k, v in (params or {}).items()}
            sw = {k: v[None] for k, v in sw.items()}
        with tracing.span("forces.sweep"):
            x_in = x
            x = self._reconstruct(x)
            k = self.kernel
            term = self.term
            n = self.system.n_particles
            dtype = k.input_dtype(x)
            perm = sw["perm"].long()
            y, xT = sweep_nb.sorted_positions(x, box, perm, k.n_pad, dtype)
            lengths = torch.diagonal(box, dim1=-2, dim2=-1)
            disp = y - sw["snap"]
            disp = disp - lengths[:, None, :] * torch.round(
                disp / lengths[:, None, :])
            moved = torch.amax(torch.sum(disp * disp, dim=-1), dim=-1) > (
                0.5 * k.skin) ** 2
            rebuild = (sw["nblk"] < 0) | moved
            tracing.count("k2.rebuilds", rebuild)
            tracing.count("k2.sort_sets", rebuild.shape[0])

            par = sw["par"] if rep is None else sw["par"][rep]
            batch = par.shape[0]
            lj_scale = None
            lam = lam_s_cls = None
            alch = self.alch
            if alch is not None:
                # the kernel's per-class scalars of each evaluation, from
                # its parameters by tensor operations on the device;
                # 'exact' scales the charges by region
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
            with tracing.span("k2.evaluate"):
                F_s, u_s, nblk = k.evaluate(xT, par.contiguous(), sw["excl"],
                                            L, rebuild, sw["nblk"], lam,
                                            rep_k)
            if rep is None:
                x_r, box_r, lengths_r = x, box, lengths
            else:
                x_r, box_r, lengths_r = x[rep], box[rep], lengths[rep]
            if forces:
                inv = sw["inv"].long()[..., None].expand(x.shape)
                F_direct = torch.gather(F_s.transpose(-1, -2), -2, inv).to(
                    x.dtype)
                with tracing.span("forces.remainder"):
                    u_r, g_r = batched_value_and_grad(
                        lambda xx: self._rest_energies(xx, box, params), x)
            else:
                with torch.no_grad(), tracing.span("forces.remainder"):
                    u_r = self._rest_energies(x_r, box_r, params)
            # the parts add up in float64, as OpenMM's mixed precision sums
            # energies: a float32 total of 24,000 waters (-3.2e5 kJ/mol)
            # moves in steps of 0.03 kJ/mol, and the nonequilibrium work is
            # a sum of differences of such totals
            u = u_s.to(torch.float64) + u_r.to(torch.float64)
            volume = torch.prod(lengths_r.to(torch.float64), dim=-1)
            if self.disp_avg is not None:
                tail = (2.0 * math.pi * n * n / volume) * self.disp_avg
                if lj_scale is not None:
                    tail = tail * lj_scale   # eps_ij scales linearly
                u = u + tail
            elif self.disp_class is not None:
                # class sums (env-env first) weighted by lam_s^a per class
                weights = torch.cat([torch.ones((batch, 1),
                                                dtype=torch.float64,
                                                device=x.device),
                                     lam_s_cls.to(torch.float64)], dim=-1)
                u = u + (2.0 * math.pi * n * n / volume) * torch.sum(
                    self.disp_class * weights, dim=-1)
            new_sw = dict(sw)
            new_sw["snap"] = torch.where(rebuild[:, None, None], y,
                                         sw["snap"])
            new_sw["nblk"] = nblk
            f = None
            if forces:
                f = F_direct - g_r
                if self.vsites is not None:
                    f = self._spread(x_in, f)
        if single:
            return (u[0], None if f is None else f[0],
                    {k: v[0] for k, v in new_sw.items()})
        return u, f, new_sw


class FusedPath(DensePath):
    """The fused Langevin kernel (K1,
    :mod:`openmmtools_tpu_torch.ops.fused_langevin`) integrates whole runs
    and evaluates by its force kernel; the step program never runs (a
    direct ``step`` evaluates densely)."""

    name = "K1"
    per_replica = True
    dense_sums = False

    @classmethod
    def build(cls, integ, system, tokens, groups):
        """The path for a plain R/V/O splitting of a ``fused_lj_eligible``
        fluid on a CUDA device, with no heat or shadow work measured and a
        step program that fits the chunk kernel's table
        (``fits_chunk_table``; the TPU kernel unrolls any splitting); else
        None."""
        if integ.neighborlist is None or system.device.type != "cuda":
            return None
        if not set(tokens) <= {"R", "V", "O"}:
            return None   # Metropolization/MTS/H need the generic emitters
        if integ.measure_shadow_work or integ.measure_heat:
            return None
        if not fused_lj_eligible(system):
            return None
        from openmmtools_tpu_torch.ops.fused_langevin import (
            FusedSortedBAOAB,
            fits_chunk_table,
        )

        if not fits_chunk_table(tokens):
            return None   # the chunk kernel's step-program table cannot hold it
        path = cls(system, groups)
        term = path.term = system.terms[0]
        path.kernel = FusedSortedBAOAB(
            system.n_particles, float(term.cutoff), term.switch_width,
            float(term.sigma[0]), float(term.epsilon[0]),
            float(system.masses[0]), integ.timestep, integ.collision_rate,
            tokens=tuple(tokens))
        return path

    def _total(self, u, box):
        """The kernel's pair energy ``u`` plus the dispersion correction
        where the term asks for it."""
        term = self.term
        if not term.use_dispersion_correction:
            return u
        return u + nonbonded.dispersion_correction_energy(
            box, term.sigma, term.epsilon, term.cutoff)

    def kernel_energy_forces(self, x, box):
        """(U, F) of positions x (N, 3) by the force kernel (one launch of
        K1's ``lj_forces_kernel``), float32 as ``run`` returns them."""
        xT = x.detach().t().to(torch.float32).contiguous()
        L = torch.diagonal(box).to(torch.float32).contiguous()
        F, U = self.kernel.forces(xT, L)
        return self._total(U[0], box), F.t().contiguous()

    def initial_forces(self, state):
        u, f = self.kernel_energy_forces(state.positions, state.box)
        return state.replace(forces=(f,), potentials=(u,))

    def energy_forces_at(self, x, box, params):
        box, _, _ = self.fresh(x, box)
        u, f = self.kernel_energy_forces(x, box)
        return u.to(torch.float64), f.to(x.dtype)

    def energies_batch(self, x, box, rep, params):
        """The force kernel once a configuration (it reads no global
        parameter)."""
        box, _, _ = self.fresh(x, box)
        rep = torch.as_tensor(rep, device=x.device).long()
        u = torch.stack([self.kernel_energy_forces(x[r], box[r])[0]
                         for r in range(x.shape[0])])
        return u.to(torch.float64)[rep], None

    def run(self, state, n_steps, program):
        box = state.box if state.box is not None else self.system.default_box
        x, v, f, u = self.kernel.run(state.positions, state.velocities, box,
                                     state.kT, state.generator, n_steps)
        return state.replace(positions=x, velocities=v, forces=(f,),
                             potentials=(self._total(u, box),),
                             step_count=state.step_count + n_steps)
