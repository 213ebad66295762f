"""Bounded-sweep direct-space nonbonded forces (counterpart of
``ops/sweep_nb.py``).

The production direct-space path for large periodic systems with real force
fields, in the role OpenMM's neighbour-list direct-space kernels play. Atoms
are wrapped into the box and sorted by x; slot ``i`` interacts with the ring
partners ``i +- s`` of the sorted order for ``s`` up to ``bound * shell_block``
(the x-sorted window that can hold a partner within the cutoff), where
``bound`` is a block count measured at each rebuild with a Verlet skin:

* Lorentz-Berthelot LJ (sigma_ij = (s_i + s_j)/2, eps_ij = se_i se_j from the
  square-rooted per-atom epsilons);
* Coulomb as Ewald/PME direct space qq erfc(alpha r)/r, or reaction field
  qq (1/r + k_rf r^2 - c_rf);
* OpenMM's quintic switch on LJ, or on LJ + Coulomb (``switch_coulomb``);
* exception pairs masked through the per-shell bitfield of
  :func:`build_exclusion_bitfield` (bit ``s-1`` of lane ``i`` marks the pair
  (i, i+s)); the caller adds their own interaction back;
* a distance-only pass that re-measures the block bound on rebuild:
  1 + the last block of ``shell_block`` shells holding a pair of real slots
  within (cutoff + skin)^2, exactly, on any ring (the path re-sorts only
  every ``sweep_sort_interval`` steps, so the ring it rebuilds on is
  usually stale: only roughly sorted);
* the alchemical variant (``alchemical=True``, ``n_regions``): a 4th
  parameter row carries each slot's region code g = region_id + 1 (0 =
  environment), and every pair takes the scalars (lam_s, asc, lam_e) of its
  region-pair class {min(g_i, g_j), max(g_i, g_j)} from the ``lam`` input
  [lam_s x C, asc x C, lam_e x C] (C = (R+1)(R+2)/2 - 1 classes, env-env
  excluded: it keeps lam_s = lam_e = 1, asc = 0): softcore LJ (beta = 0,
  c = 6) x = s6/(asc s6 + 1) with s6 clamped to 1e18, U = 4 eps lam_s
  x (x - 1), and the Coulomb term times lam_e; the 'coulomb' PME treatment
  uses plain 1/r for pairs with an alchemical member.

:class:`SweepNonbonded` has the arguments and the ``forces`` contract of the
TPU kernel ``openmmtools_tpu.ops.sweep_nb.SweepNonbonded``, both variants,
and a replica axis (the JAX package batches the kernel under ``jax.vmap``):
one launch of each kernel evaluates a batch, R sort sets (a configuration's
sorted positions, bitfield, box, rebuild flag and bound) and B evaluations,
evaluation b on the set ``rep[b]`` with its own parameters and class
scalars. Propagation takes B = R, the multistate energy matrix one
evaluation a (replica, state) pair. A batch of one is the single call. On
CUDA tensors its two wrappers, :meth:`SweepNonbonded.measure_bound` and
:meth:`SweepNonbonded.sweep`, launch the hand-written kernels of
``csrc/sweep_nb.cu`` or raise; on CPU tensors they run the plain PyTorch
versions :func:`measure_bound_reference` and :func:`sweep_forces_reference`,
which are also the kernels' oracle on the card. The rebuild flag, the bound
and the alchemical scalars stay device tensors that the kernels read, so a
step never waits on the host.

Launch shapes (``csrc/sweep_nb.cu`` says why): the bound kernel is one
cooperative launch of at most the co-resident blocks of 4 warps, whatever
the batch, its blocks walking (set, tile) pairs. Its first
phase gives each tile of 32 ring slots its periodic x-arc, measured from one
of its members so that an atom that crossed the x face since the sort does
not widen it; after one grid barrier a warp takes a tile's slots as a group
and scans its partner tiles from the farthest shell inward, skipping a tile
whose arc lies beyond (cutoff + skin) (1 + 1e-5) + 1e-5 L of the group's or
whose shells cannot beat the best block found so far (a device-wide int),
and stops at its first hit. It never trusts the ring to be sorted: a stale
ring only makes it test more tiles. Its scratch, the arcs and R + 1 ints
(each set's best block and a ticket, re-armed by the last block), lives on
the wrapper across calls. Its arcs are staged in shared memory up to about
188,000 slots of all sets together and read from L2 past that, so no ring
size is refused.
:func:`tile_arcs` and :func:`far_tiles` are plain versions of its cull, kept
beside the plain bound and used by no path (the tests hold the kernel's scan
against the plain bound with them, and ``chip_smoke.py`` counts the tile
tests that the scan cannot skip). The force kernel, both variants, gives
one warp to a sorted slot and 16 slots to a block (n_pad / 16 blocks, 1,504
at 24,064 slots; a grid row an evaluation of a batch), in one launch: the
block stages its shared partner window in shared memory, the lanes test 32
partners at once, and the pairs inside the cutoff are compacted into a
per-warp queue (``__ballot_sync``) and evaluated 32 at a time, so both the
distance tests and the pair arithmetic run at full warp width. Its scratch
is one energy partial a block and an integer ticket an evaluation kept at 0
(the last block of an evaluation sums its partials in a fixed order).

Semantics kept from the TPU kernel: pad slots (``n <= i < n_pad``) take no
part; the minimum image is one conditional shift per axis (exact for wrapped
coordinates); the shell ``s = n_pad/2`` reaches the same partner from both
sides and counts half from each; an exception bit is read only for
``s <= 32 * mask_rows``. Divergences: erfc is exact (``erfcf`` in the kernel,
``torch.special.erfc`` here) where the TPU kernel uses the Abramowitz-Stegun
7.1.26 rational (|error| < 1.5e-7); a pair's region-pair class is an integer
index computed from (min(g_i, g_j), max(g_i, g_j)) where the TPU kernel
compares float (g_i + g_j, g_i g_j) against each class.
"""
from __future__ import annotations

import collections
import collections.abc
import math

import torch

from openmmtools_tpu_torch.constants import ONE_4PI_EPS0
from openmmtools_tpu_torch.ops._build import (
    check,
    check_input,
    kernels_for,
    load_library,
)

__all__ = ["SweepNonbonded", "PlainSweepNonbonded", "build_exclusion_bitfield",
           "sort_for_sweep", "sorted_positions", "sorted_params",
           "sorted_inputs", "term_params", "scale_charges_by_code",
           "class_index",
           "measure_bound_reference", "sweep_forces_reference"]

# rows of sorted slots per chunk of the plain versions: a chunk holds
# (rows, partners) tensors, never (N, N) ones
_CHUNK_ELEMENTS = 1 << 22


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _ring_delta(d, L):
    """Minimum image by one conditional shift (coordinates in [0, L))."""
    d = d + torch.where(d < -0.5 * L, L, 0.0)
    return d - torch.where(d > 0.5 * L, L, 0.0)


def _pair_r2(xT, L, i, j):
    """Displacements (3 of (rows, cols)) and squared distance of slot pairs."""
    ds = [_ring_delta(xT[c][i] - xT[c][j], L[c]) for c in range(3)]
    return ds, ds[0] * ds[0] + ds[1] * ds[1] + ds[2] * ds[2]


def measure_bound_reference(xT, L, rebuild, bound, *, n, cutoff, skin,
                            shell_block):
    """The block bound after this evaluation, as an int32 tensor (1,): on
    rebuild 1 + the last block of ``shell_block`` shells holding a pair of
    real slots within (cutoff + skin)^2, else ``bound``. The plain version of
    ``sweep_bound_kernel``; ``xT`` (3, n_pad) sorted positions. A batch of R
    sort sets (``xT`` (R, 3, n_pad), ``L`` (R, 3), ``rebuild`` and ``bound``
    (R,)) gives the R bounds (R,), each set measured on its own."""
    if xT.dim() == 3:
        return torch.cat([measure_bound_reference(
            xT[r], L[r], rebuild[r], bound[r], n=n, cutoff=cutoff, skin=skin,
            shell_block=shell_block) for r in range(xT.shape[0])])
    dev = xT.device
    if not bool(rebuild):
        return torch.as_tensor(bound, dtype=torch.int32,
                               device=dev).reshape(1).clone()
    n_pad = xT.shape[1]
    half = n_pad // 2
    w2 = (cutoff + skin) ** 2
    s = torch.arange(1, half + 1, device=dev)
    blk = (s - 1) // shell_block
    rows = max(1, _CHUNK_ELEMENTS // half)
    last = torch.full((), -1, dtype=torch.int64, device=dev)
    for i0 in range(0, n, rows):
        i = torch.arange(i0, min(i0 + rows, n), device=dev)
        j = (i[:, None] + s[None, :]) % n_pad
        _, r2 = _pair_r2(xT, L, i[:, None], j)
        active = (r2 <= w2) & (r2 > 1e-12) & (j < n)
        last = torch.maximum(last, torch.max(torch.where(active, blk, -1)))
    return (last + 1).to(torch.int32).reshape(1)


def tile_arcs(xT, L, n):
    """The periodic x-arcs of the ring's tiles of 32 slots, as the bound
    kernel's first phase computes them, float32: (start (T,), width (T,)),
    a tile's members in [start, start + width] modulo L[0]. A member is a
    real slot (index < ``n``) of finite x; a tile without one has width -1.
    The offsets are taken from the tile's first member by the minimum image,
    so an atom that crossed the x face lies beside its neighbours."""
    x = xT[0].to(torch.float32)
    Lx = L[0].to(torch.float32)
    tiles = x.reshape(-1, _GROUP)
    real = (torch.arange(x.shape[0], device=x.device) < n).reshape(-1, _GROUP)
    member = real & torch.isfinite(tiles)
    first = torch.argmax(member.to(torch.int8), dim=1)
    ref = torch.gather(tiles, 1, first[:, None])
    d = _ring_delta(tiles - ref, Lx)
    lo = torch.where(member, d, math.inf).amin(dim=1)
    hi = torch.where(member, d, -math.inf).amax(dim=1)
    empty = ~member.any(dim=1)
    start = torch.where(empty, 0.0, ref[:, 0] + lo)
    width = torch.where(empty, -1.0, hi - lo)
    return start, width


def far_tiles(xT, L, n, cutoff, skin):
    """(T, T) bool, [g, t] set where the bound kernel skips the partner tile
    t for the slots of tile g: g or t has no member, or their x-arcs lie more
    than W = w (1 + 1e-5) + 1e-5 L apart on the periodic circle, w = cutoff
    + skin. The plain version of the kernel's cull, used by no path: no pair
    within w may fall in a skipped (g, t)."""
    start, width = tile_arcs(xT, L, n)
    Lx = L[0].to(torch.float32)
    w = torch.sqrt(torch.tensor((cutoff + skin) ** 2, dtype=torch.float32,
                                device=start.device))
    W = w * (1.0 + 1e-5) + 1e-5 * Lx
    u = start[None, :] - start[:, None]
    u = u - Lx * torch.floor(u * (1.0 / Lx))
    apart = (u > width[:, None] + W) & (u + width[None, :] < Lx - W)
    return apart | (width[None, :] < 0) | (width[:, None] < 0)


def _excluded(excl, o, i, j):
    """Exception bits of the pairs (i, j = i + o): bit |o|-1 of lane i for
    o > 0 and of lane j for o < 0, read where |o| <= 32 * mask_rows."""
    mask_rows, n_pad = excl.shape
    ao = o.abs()
    lane = torch.where(o > 0, i, j)
    word = torch.clamp((ao - 1) // 32, max=mask_rows - 1)
    bits = (excl.reshape(-1)[word * n_pad + lane] >> ((ao - 1) % 32)) & 1
    return (bits == 1) & (ao <= 32 * mask_rows)


def class_index(n_regions, device=None):
    """(R+1, R+1) int64 table of the region-pair class of two region codes:
    the position of {min, max} in the classes (a, b), 0 <= a <= b <= R, in
    order, less one (env-env, which has no class, gives -1). The kernel
    computes the same index arithmetically."""
    R = int(n_regions)
    a = torch.arange(R + 1, device=device)
    lo = torch.minimum(a[:, None], a[None, :])
    hi = torch.maximum(a[:, None], a[None, :])
    return lo * (R + 1) - lo * (lo - 1) // 2 + (hi - lo) - 1


def sweep_forces_reference(xT, par, excl, L, nblk, *, n, cutoff, method,
                           shell_block, switch_width=None, dielectric=78.3,
                           alpha=None, shift_rf=True, switch_coulomb=False,
                           n_regions=0, coulomb_plain=False, lam=None,
                           rep=None):
    """Forces (3, n_pad) and energy (1,) of the bounded sweep: the plain
    version of ``sweep_forces_kernel``. ``xT`` (3, n_pad) sorted wrapped
    positions, ``par`` (3, n_pad) sorted [sigma, sqrt(eps), charge] (the
    alchemical variant, ``n_regions`` > 0: (4, n_pad) with the region codes
    g as the 4th row, and ``lam`` the (3 C,) class scalars), ``excl``
    (mask_rows, n_pad) int32 bitfield, ``nblk`` (1,) the block bound; any
    floating dtype. Each slot sums its full ring neighbourhood i +- s. The
    alchemical variant's energy is float64, as the kernel's.

    A batch: R sort sets (``xT`` (R, 3, n_pad), ``excl`` (R, mask_rows,
    n_pad), ``L`` (R, 3), ``nblk`` (R,)) and B evaluations, evaluation b on
    the set ``rep[b]`` (the identity where ``rep`` is None) with its own
    ``par[b]`` and ``lam[b]``; gives F (B, 3, n_pad) and U (B,), each
    evaluation computed on its own."""
    if xT.dim() == 3:
        out = []
        for b in range(par.shape[0]):
            r = b if rep is None else int(rep[b])
            out.append(sweep_forces_reference(
                xT[r], par[b], excl[r], L[r], nblk[r:r + 1], n=n,
                cutoff=cutoff, method=method, shell_block=shell_block,
                switch_width=switch_width, dielectric=dielectric,
                alpha=alpha, shift_rf=shift_rf,
                switch_coulomb=switch_coulomb, n_regions=n_regions,
                coulomb_plain=coulomb_plain,
                lam=None if lam is None else lam[b]))
        return (torch.stack([F for F, _ in out]),
                torch.cat([U for _, U in out]))
    dev, dtype = xT.device, xT.dtype
    alch = n_regions > 0
    if alch:
        table = class_index(n_regions, dev)
        n_cls = (n_regions + 1) * (n_regions + 2) // 2 - 1
        lam = lam.to(device=dev, dtype=dtype)
        code = par[3].long()
    n_pad = xT.shape[1]
    half = n_pad // 2
    S = min(int(nblk.reshape(-1)[0]) * shell_block, half)
    F = torch.zeros((3, n_pad), dtype=dtype, device=dev)
    # the alchemical variant's energy total is float64, as the kernel's
    acc = torch.float64 if alch else dtype
    U = torch.zeros((), dtype=acc, device=dev)
    if S <= 0:
        return F, U.reshape(1)
    rc2 = cutoff * cutoff
    o = torch.cat([torch.arange(-S, 0, device=dev),
                   torch.arange(1, S + 1, device=dev)])
    weight = torch.where(o.abs() == half, 0.5, 1.0).to(dtype)
    if method in ("pme", "ewald"):
        two_over_sqrt_pi = 2.0 / math.sqrt(math.pi)
    else:
        k_rf = ((1.0 / cutoff ** 3) * (dielectric - 1.0)
                / (2.0 * dielectric + 1.0))
        c_rf = ((1.0 / cutoff) * (3.0 * dielectric)
                / (2.0 * dielectric + 1.0)) if shift_rf else 0.0
    rows = max(1, _CHUNK_ELEMENTS // o.shape[0])
    for i0 in range(0, n, rows):
        i = torch.arange(i0, min(i0 + rows, n), device=dev)[:, None]
        j = (i + o[None, :]) % n_pad
        ds, r2 = _pair_r2(xT, L, i, j)
        mask = (r2 < rc2) & (r2 > 1e-12) & (j < n)
        mask = mask & ~_excluded(excl, o[None, :], i, j)
        inv_r = torch.where(mask, torch.rsqrt(torch.where(mask, r2, 1.0)), 0.0)
        inv_r2 = inv_r * inv_r
        r = r2 * inv_r
        sig = 0.5 * (par[0][i] + par[0][j])
        eps = par[1][i] * par[1][j]
        s2 = sig * sig * inv_r2
        s6 = s2 * s2 * s2
        if alch:
            # the pair's class scalars; env-env pairs (class -1) keep
            # lam_s = lam_e = 1, asc = 0
            gi, gj = code[i], code[j]
            ci = table[gi, gj]
            has = ci >= 0
            ci = torch.clamp(ci, min=0)
            lam_s = torch.where(has, lam[ci], 1.0)
            asc = torch.where(has, lam[n_cls + ci], 0.0)
            lam_e = torch.where(has, lam[2 * n_cls + ci], 1.0)
            # softcore (beta = 0, c = 6): x = s6/(asc s6 + 1); s6 clamped so
            # that asc s6 + 1 cannot overflow at deep overlap
            s6 = torch.clamp(s6, max=1e18)
            inv_den = 1.0 / (asc * s6 + 1.0)
            xsc = s6 * inv_den
            el4 = (4.0 * eps) * lam_s
            e_lj = el4 * (xsc * xsc - xsc)
            w_lj = (6.0 * el4) * (2.0 * xsc - 1.0) * xsc * inv_den * inv_r2
        else:
            s12 = s6 * s6
            e_lj = 4.0 * eps * (s12 - s6)
            w_lj = eps * (48.0 * s12 - 24.0 * s6) * inv_r2
        qq = ONE_4PI_EPS0 * par[2][i] * par[2][j]
        if method in ("pme", "ewald"):
            z = alpha * r
            erfc = torch.special.erfc(z)
            e_c = qq * erfc * inv_r
            w_c = qq * inv_r2 * (erfc * inv_r
                                 + two_over_sqrt_pi * alpha * torch.exp(-z * z))
            if alch and coulomb_plain:
                # 'coulomb' PME treatment: plain 1/r for involved pairs
                involved = (gi > 0) | (gj > 0)
                e_c = torch.where(involved, qq * inv_r, e_c)
                w_c = torch.where(involved, qq * inv_r2 * inv_r, w_c)
        else:
            e_c = qq * (inv_r + k_rf * r2 - c_rf)
            w_c = qq * (inv_r2 * inv_r - 2.0 * k_rf)
        if alch:
            e_c = e_c * lam_e
            w_c = w_c * lam_e
        if switch_width is not None:
            inv_span = 1.0 / switch_width
            tt = torch.clamp((r - (cutoff - switch_width)) * inv_span, 0.0, 1.0)
            Sw = 1.0 + tt * tt * tt * (-10.0 + tt * (15.0 - 6.0 * tt))
            omt = 1.0 - tt
            dS = (-30.0 * inv_span) * (tt * tt) * (omt * omt)
            if switch_coulomb:
                w = (w_lj + w_c) * Sw - (e_lj + e_c) * dS * inv_r
                e = (e_lj + e_c) * Sw
            else:
                w = w_lj * Sw - e_lj * dS * inv_r + w_c
                e = e_lj * Sw + e_c
        else:
            e = e_lj + e_c
            w = w_lj + w_c
        e = torch.where(mask, e, 0.0) * weight
        w = torch.where(mask, w, 0.0) * weight
        rows_i = i[:, 0]
        for c in range(3):
            F[c, rows_i] = torch.sum(w * ds[c], dim=1)
        U = U + 0.5 * torch.sum(e, dtype=acc)
    return F, U.reshape(1)


class LaunchCounts(collections.abc.MutableMapping):
    """K2's launch counts by ``key(kernel, B)``, read from the counters the
    kernels add to themselves (``counters``: (kernel, B, device) -> an
    int64 () tensor on the card, 1 added by each launch's first thread), so
    a launch that a CUDA graph replays counts each time it runs. Reading a
    count reads the card. A count that is set is kept as an offset from
    the counters, which only grow; a count of 0 is no entry, except for the
    keys in ``always``."""

    def __init__(self, counters, key, always=()):
        self._counters = counters
        self._key = key
        self._always = tuple(always)
        self._offset = collections.Counter()

    def _device(self):
        counts = collections.Counter()
        for (kernel, B, _), counter in self._counters.items():
            counts[self._key(kernel, B)] += int(counter)
        return counts

    def _read(self):
        counts = self._device()
        counts.update(self._offset)
        return {**dict.fromkeys(self._always, 0),
                **{key: n for key, n in counts.items() if n}}

    def __getitem__(self, key):
        return self._read().get(key, 0)

    def __setitem__(self, key, value):
        self._offset[key] = value - self._device()[key]

    def __delitem__(self, key):
        self[key] = 0

    def __contains__(self, key):
        return key in self._read()

    def __iter__(self):
        return iter(self._read())

    def __len__(self):
        return len(self._read())

    def clear(self):
        self._offset = collections.Counter(
            {key: -n for key, n in self._device().items()})

    def __repr__(self):
        return repr(self._read())


class SweepNonbonded:
    """Bounded-sweep direct-space force program for one NonbondedTerm
    configuration, standard or alchemical.

    Static per instance: method, cutoff, switch, dielectric, alpha, particle
    count, and for the alchemical variant the region count and the
    'coulomb' PME treatment. Runtime inputs: sorted coordinates and
    parameters, box, exclusion bitfield, rebuild flag, current block bound
    and the alchemical class scalars ``lam``. Both wrappers take one
    evaluation or a batch (R sort sets, B evaluations, see
    :meth:`measure_bound` and :meth:`sweep`), one launch either way.
    ``launches`` counts kernel launches per kernel, on CUDA tensors only:
    ``sweep_bound`` and ``sweep_forces`` (standard) or ``sweep_forces_alch``
    (alchemical); ``batch_launches`` the same launches by (kernel, batch
    size): sort sets for ``sweep_bound``, evaluations for the force
    kernel. The kernels count their own launches on the device
    (:class:`LaunchCounts`), so the launches of a replayed CUDA graph
    count as they run.
    """

    def __init__(self, n_particles, method, cutoff, switch_width=None,
                 dielectric=78.3, ewald_alpha=None, shift_rf=True,
                 switch_coulomb=False, shell_block=8, skin=0.1,
                 mask_shells=2048, alchemical=False, n_regions=None,
                 coulomb_pme_treatment=False):
        if method not in ("pme", "ewald", "cutoff_periodic"):
            raise ValueError(f"sweep kernel: unsupported method {method!r}")
        self.n = int(n_particles)
        self.n_pad = _round_up(self.n, 128)
        self.method = method
        self.rc = float(cutoff)
        self.switch_width = (None if switch_width is None
                             else float(switch_width))
        self.dielectric = float(dielectric)
        self.alpha = None if ewald_alpha is None else float(ewald_alpha)
        self.shift_rf = bool(shift_rf)
        self.switch_coulomb = bool(switch_coulomb)
        self.bs = int(shell_block)
        self.skin = float(skin)
        self.mask_shells = int(mask_shells)
        if self.mask_shells % 32:
            raise ValueError("mask_shells must be a multiple of 32")
        self.mask_rows = self.mask_shells // 32
        self.n_blocks = -(-(self.n_pad // 2) // self.bs)
        # alchemical variant: region codes g = region_id + 1 in a 4th
        # parameter row, and 3 scalars per region-pair class (a, b),
        # 0 <= a <= b <= R, env-env (0, 0) excluded
        self.n_regions = (int(n_regions) if n_regions is not None
                          else (1 if alchemical else 0))
        self.alchemical = self.n_regions > 0
        R = self.n_regions
        self.alch_classes = tuple(
            (a, b) for a in range(R + 1) for b in range(a, R + 1))[1:]
        self.n_lam = 3 * len(self.alch_classes)
        self.coulomb_pme_treatment = (self.alchemical
                                      and bool(coulomb_pme_treatment))
        self.n_par = 4 if self.alchemical else 3
        self.forces_kernel = ("sweep_forces_alch" if self.alchemical
                              else "sweep_forces")
        # (kernel, B, device) -> the launches the kernel counted at batch
        # size B: never replaced, since a captured graph holds its address
        self._launch_counters = {}
        self.launches = LaunchCounts(self._launch_counters,
                                     lambda kernel, B: kernel,
                                     ("sweep_bound", self.forces_kernel))
        self.batch_launches = LaunchCounts(self._launch_counters,
                                           lambda kernel, B: (kernel, B))
        # (device, B) -> the force kernel's B tickets, kept at 0: never
        # replaced, since a captured graph holds their address
        self._tickets = {}
        # (device, R) -> the bound kernel's scratch for R sort sets
        self._bound_scratch = {}
        self._identity = {}   # (device, B) -> rep of B evaluations on B sets

    def physics(self):
        """Keyword arguments of :func:`sweep_forces_reference` (``lam``
        aside)."""
        return dict(n=self.n, cutoff=self.rc, method=self.method,
                    shell_block=self.bs, switch_width=self.switch_width,
                    dielectric=self.dielectric, alpha=self.alpha,
                    shift_rf=self.shift_rf,
                    switch_coulomb=self.switch_coulomb,
                    n_regions=self.n_regions,
                    coulomb_plain=self.coulomb_pme_treatment)

    def _launch_counter(self, kernel, B, dev):
        """The device counter that ``kernel``'s launches at batch size ``B``
        add to, made by an eager launch before any capture records one."""
        counter = self._launch_counters.get((kernel, B, dev))
        if counter is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"no launch counter of {kernel} at B = {B} before the "
                    f"capture")
            counter = self._launch_counters[(kernel, B, dev)] = torch.zeros(
                (), dtype=torch.int64, device=dev)
        return counter

    def measure_bound(self, xT, L, rebuild, bound):
        """The block bound (int32 (1,)) for this evaluation: re-measured when
        the device flag ``rebuild`` (bool) is set, else ``bound`` (int32).
        A batch of R sort sets, ``xT`` (R, 3, n_pad), ``L`` (R, 3),
        ``rebuild`` and ``bound`` (R,), gives the R bounds (R,) in one
        launch."""
        if not kernels_for(xT, "sweep kernel"):
            return measure_bound_reference(
                xT, L, rebuild, bound, n=self.n, cutoff=self.rc,
                skin=self.skin, shell_block=self.bs)
        dev = xT.device
        single = xT.dim() == 2
        R = 1 if single else xT.shape[0]
        lead = () if single else (R,)
        rebuild = torch.as_tensor(rebuild, dtype=torch.bool,
                                  device=dev).reshape(-1)
        bound = torch.as_tensor(bound, dtype=torch.int32,
                                device=dev).reshape(-1)
        check_input(xT, torch.float32, lead + (3, self.n_pad))
        check_input(L, torch.float32, lead + (3,))
        check_input(rebuild, torch.bool, (R,))
        check_input(bound, torch.int32, (R,))
        scratch = self._bound_scratch.get((dev, R))
        if scratch is None:
            # the tiles' arcs, and (best block of each set, ticket) armed at
            # (-1, ..., -1, 0)
            words = torch.full((R + 1,), -1, dtype=torch.int32, device=dev)
            words[R] = 0
            scratch = self._bound_scratch[(dev, R)] = (
                torch.empty((R * 2 * self.n_pad // _GROUP,),
                            dtype=torch.float32, device=dev), words)
        arcs, words = scratch
        nblk = torch.empty((R,), dtype=torch.int32, device=dev)
        err = load_library().sweep_bound_f32(
            xT.data_ptr(), self.n, self.n_pad, R, L.data_ptr(),
            (self.rc + self.skin) ** 2, self.bs, rebuild.data_ptr(),
            bound.data_ptr(), arcs.data_ptr(), words.data_ptr(),
            nblk.data_ptr(),
            self._launch_counter("sweep_bound", R, dev).data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        check(err, "sweep_bound_f32")
        return nblk

    def sweep(self, xT, par, excl, L, nblk, lam=None, rep=None):
        """Forces (3, n_pad) and energy (1,) of sorted positions ``xT`` at
        the block bound ``nblk`` (int32 (1,), read on the device); the
        alchemical variant reads its class scalars from ``lam`` (n_lam,),
        also on the device.

        A batch in one launch: R sort sets (``xT`` (R, 3, n_pad), ``excl``
        (R, mask_rows, n_pad), ``L`` (R, 3), ``nblk`` (R,)) and B
        evaluations, evaluation b on the set ``rep[b]`` (int32 (B,) on the
        device; None: B = R, the identity) with its own ``par[b]`` and
        ``lam[b]`` (``par`` (B, n_par, n_pad), ``lam`` (B, n_lam)); gives F
        (B, 3, n_pad) and U (B,)."""
        if self.alchemical and lam is None:
            raise ValueError("the alchemical sweep needs its class scalars")
        if not kernels_for(xT, "sweep kernel"):
            return sweep_forces_reference(xT, par, excl, L, nblk, lam=lam,
                                          rep=rep, **self.physics())
        single = xT.dim() == 2
        R = 1 if single else xT.shape[0]
        B = 1 if single else par.shape[0]
        sets, evals = ((), ()) if single else ((R,), (B,))
        dev = xT.device
        check_input(xT, torch.float32, sets + (3, self.n_pad))
        check_input(par, torch.float32, evals + (self.n_par, self.n_pad))
        check_input(excl, torch.int32, sets + (self.mask_rows, self.n_pad))
        check_input(L, torch.float32, sets + (3,))
        check_input(nblk, torch.int32, (R,))
        if rep is None:
            if B != R:
                raise ValueError(f"{B} evaluations on {R} sort sets need rep")
            rep = self._identity.get((dev, B))
            if rep is None:
                rep = self._identity[(dev, B)] = torch.arange(
                    B, dtype=torch.int32, device=dev)
        check_input(rep, torch.int32, (B,))
        e_part = torch.empty((B * self.n_pad // _WARPS,), dtype=torch.float32,
                             device=dev)
        ticket = self._tickets.get((dev, B))
        if ticket is None:
            ticket = self._tickets[(dev, B)] = torch.zeros(
                (B,), dtype=torch.int32, device=dev)
        F = torch.empty((B, 3, self.n_pad), dtype=torch.float32, device=dev)
        # the alchemical variant's energy totals are doubles (their
        # differences are nonequilibrium work)
        U = torch.empty((B,), dtype=(torch.float64 if self.alchemical
                                     else torch.float32), device=dev)
        ewald = self.method in ("pme", "ewald")
        if ewald:
            k_rf = c_rf = 0.0
        else:
            d = self.dielectric
            k_rf = (1.0 / self.rc ** 3) * (d - 1.0) / (2.0 * d + 1.0)
            c_rf = ((1.0 / self.rc) * (3.0 * d) / (2.0 * d + 1.0)
                    if self.shift_rf else 0.0)
        sw = self.switch_width
        args = [xT.data_ptr(), par.data_ptr(), excl.data_ptr(), self.n,
                self.n_pad, self.mask_rows, self.bs, L.data_ptr(),
                nblk.data_ptr(), B, rep.data_ptr(), self.rc * self.rc,
                int(not ewald), self.alpha if ewald else 0.0, k_rf, c_rf,
                int(sw is not None), int(self.switch_coulomb),
                0.0 if sw is None else self.rc - sw,
                0.0 if sw is None else 1.0 / sw, ONE_4PI_EPS0]
        lib = load_library()
        if self.alchemical:
            if self.n_lam > _MAX_LAM:
                raise ValueError(
                    f"the alchemical sweep kernel takes at most "
                    f"{_MAX_REGIONS} regions, got {self.n_regions}")
            check_input(lam, torch.float32, evals + (self.n_lam,))
            fn, name = lib.sweep_forces_alch_f32, "sweep_forces_alch_f32"
            args += [lam.data_ptr(), self.n_regions,
                     int(self.coulomb_pme_treatment)]
        else:
            fn, name = lib.sweep_forces_f32, "sweep_forces_f32"
        counter = self._launch_counter(self.forces_kernel, B, dev)
        err = fn(*args, e_part.data_ptr(), ticket.data_ptr(), F.data_ptr(),
                 U.data_ptr(), counter.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
        check(err, name)
        if single:
            return F[0], U
        return F, U

    def input_dtype(self, t):
        """The float type the wrappers take for tensors on ``t``'s device:
        float32 for the kernels, the caller's own for the plain versions."""
        return (torch.float32 if kernels_for(t, "sweep kernel")
                else t.dtype)

    def evaluate(self, xT, par, excl, L, rebuild, bound, lam=None, rep=None):
        """One force evaluation on the (3, n_pad) layout: the bound, then the
        sweep at it. Returns (F (3, n_pad), U (1,), new_bound (1,) int32).
        A batch (see :meth:`sweep`) gives (F (B, 3, n_pad), U (B,), the R
        new bounds (R,)): one launch of each kernel."""
        nblk = self.measure_bound(xT, L, rebuild, bound)
        F, U = self.sweep(xT, par, excl, L, nblk, lam, rep)
        return F, U, nblk

    def forces(self, x_sorted, par_sorted, box, excl, rebuild, bound,
               lam=None):
        """One force evaluation, the TPU kernel's contract.

        x_sorted: (n_pad, 3) sorted, wrapped positions (pad rows ignored);
        par_sorted: (n_pad, n_par) [sigma, sqrt_eps, charge(, code)],
            sorted, 0 pad;
        excl: (mask_rows, n_pad) int32 exception bitfield;
        rebuild: () bool tensor -- re-measure the bound before the sweep;
        bound: () int32 tensor -- the current block bound;
        lam: (n_lam,) class scalars [lam_s x C, asc x C, lam_e x C] in the
            order of ``alch_classes`` (alchemical variant only).

        Returns (F (n_pad, 3), U (), new_bound () int32).
        """
        dtype = self.input_dtype(x_sorted)
        xT = x_sorted.t().to(dtype).contiguous()
        par = par_sorted.t().to(dtype).contiguous()
        L = torch.diagonal(box).to(device=xT.device, dtype=dtype).contiguous()
        if lam is not None:
            lam = lam.to(device=xT.device, dtype=dtype).contiguous()
        F, U, nblk = self.evaluate(xT, par, excl, L, rebuild, bound, lam)
        return F.t(), U[0], nblk[0]


class PlainSweepNonbonded(SweepNonbonded):
    """A SweepNonbonded whose two wrappers run the plain versions on any
    device: the kernels' oracle on the card. It launches nothing."""

    @classmethod
    def like(cls, k: SweepNonbonded) -> "PlainSweepNonbonded":
        return cls(k.n, k.method, k.rc, switch_width=k.switch_width,
                   dielectric=k.dielectric, ewald_alpha=k.alpha,
                   shift_rf=k.shift_rf, switch_coulomb=k.switch_coulomb,
                   shell_block=k.bs, skin=k.skin, mask_shells=k.mask_shells,
                   n_regions=k.n_regions,
                   coulomb_pme_treatment=k.coulomb_pme_treatment)

    def measure_bound(self, xT, L, rebuild, bound):
        return measure_bound_reference(xT, L, rebuild, bound, n=self.n,
                                       cutoff=self.rc, skin=self.skin,
                                       shell_block=self.bs)

    def sweep(self, xT, par, excl, L, nblk, lam=None, rep=None):
        return sweep_forces_reference(xT, par, excl, L, nblk, lam=lam,
                                      rep=rep, **self.physics())

    def input_dtype(self, t):
        """The plain versions take the caller's own float type anywhere."""
        return t.dtype


# kernel launch shapes, mirrored in csrc/sweep_nb.cu: the bound kernel cuts
# the ring into tiles of 32 slots (_GROUP), one warp a tile, 4 warps a block
# (its block count is set in C, from the co-resident blocks); the force
# kernel one warp a sorted slot, 16 slots a block, n_pad / 16 blocks, each
# writing one energy partial
_GROUP = 32
_WARPS = 16
# the alchemical kernel stages its class scalars in shared memory: at most
# 16 regions, 3 * (17 * 18 / 2 - 1) = 456 scalars
_MAX_REGIONS = 16
_MAX_LAM = 3 * ((_MAX_REGIONS + 1) * (_MAX_REGIONS + 2) // 2 - 1)


# ---------------------------------------------------------------------------
# sort and exclusion bitfield (plain tensor code on any device)
# ---------------------------------------------------------------------------


def _box_lengths(box):
    """The box edges (..., 1, 3) of a box (..., 3, 3), to broadcast against
    positions (..., N, 3)."""
    return torch.diagonal(box, dim1=-2, dim2=-1)[..., None, :]


def sort_for_sweep(x, box, n_pad):
    """Wrap + x-sort positions; returns (perm, inv_perm), int32: perm maps a
    sorted slot to its atom, inv_perm the reverse. A batch (x (R, N, 3),
    box (R, 3, 3)) sorts each configuration: (R, N) each."""
    n = x.shape[-2]
    L = _box_lengths(box)
    xw = x - L * torch.floor(x / L)
    perm = torch.argsort(xw[..., 0], dim=-1, stable=True)
    inv = torch.empty_like(perm).scatter_(
        -1, perm, torch.arange(n, device=x.device).expand_as(perm))
    return perm.to(torch.int32), inv.to(torch.int32)


def unique_pairs(pairs):
    """The distinct (min, max) pairs of an (E, 2) pair list, int64."""
    if pairs.shape[0] == 0:
        return pairs.long()
    return torch.unique(torch.sort(pairs.long(), dim=1).values, dim=0)


def scatter_exclusion_bitfield(pairs, inv_perm, n_pad, mask_rows):
    """:func:`build_exclusion_bitfield` for pairs already deduplicated by
    :func:`unique_pairs`: no host synchronisation. A batch of orders
    (``inv_perm`` (R, N)) gives one bitfield and one ``max_sep`` an order:
    ((R, mask_rows, n_pad), (R,))."""
    dev = inv_perm.device
    lead = tuple(inv_perm.shape[:-1])
    field = torch.zeros(lead + (mask_rows * n_pad,), dtype=torch.int32,
                        device=dev)
    if pairs.shape[0] == 0:
        return (field.reshape(lead + (mask_rows, n_pad)),
                torch.zeros(lead, dtype=torch.int32, device=dev))
    pairs = pairs.to(dev).long()
    si = inv_perm[..., pairs[:, 0]].long()
    sj = inv_perm[..., pairs[:, 1]].long()
    sep = torch.remainder(sj - si, n_pad)
    flip = sep > n_pad // 2
    lane = torch.where(flip, sj, si)
    sep = torch.where(flip, n_pad - sep, sep)
    word = (sep - 1) // 32        # >= mask_rows when the pair overflows
    bit = ((sep - 1) % 32).to(torch.int32)
    keep = word < mask_rows
    index = torch.where(keep, word * n_pad + lane, 0)
    value = torch.where(keep, torch.bitwise_left_shift(
        torch.ones_like(bit), bit), 0)
    field.scatter_add_(-1, index, value)
    return (field.reshape(lead + (mask_rows, n_pad)),
            torch.amax(sep, dim=-1).to(torch.int32))


def build_exclusion_bitfield(pairs, inv_perm, n_pad, mask_rows):
    """Scatter exception pairs into the per-shell bitfield of the current
    sorted order. Returns (bitfield (mask_rows, n_pad) int32, max_sep ()).

    Duplicate pairs (either orientation) are merged first: the scatter adds
    bits, so a duplicate would carry into a higher bit. Pairs whose sorted
    separation exceeds the coverage 32 * mask_rows are dropped, not clamped:
    a clamped bit would mask an unrelated shell. ``max_sep`` still reports
    the overflow so that callers can raise."""
    return scatter_exclusion_bitfield(unique_pairs(pairs), inv_perm, n_pad,
                                      mask_rows)


# ---------------------------------------------------------------------------
# the kernels' sorted (3, n_pad) inputs
# ---------------------------------------------------------------------------

# coordinate of the pad slots: far from every real slot (the kernels also
# mask pad slots by index)
_PAD_COORD = 1e6


def sorted_positions(x, box, perm, n_pad, dtype=None):
    """Positions wrapped into the box in the sorted order: (y (N, 3) in
    ``x``'s type, xT (3, n_pad) in ``dtype``, pad slots at 1e6). A batch
    (x (R, N, 3), box (R, 3, 3), perm (R, N)) gives (R, N, 3) and
    (R, 3, n_pad)."""
    L = _box_lengths(box)
    xw = x - L * torch.floor(x / L)
    y = torch.gather(xw, -2, perm.long()[..., None].expand(xw.shape))
    dtype = y.dtype if dtype is None else dtype
    pad = torch.full(tuple(y.shape[:-2]) + (3, n_pad - y.shape[-2]),
                     _PAD_COORD, dtype=dtype, device=y.device)
    return y, torch.cat([y.transpose(-1, -2).to(dtype), pad], dim=-1)


def sorted_params(sigma, sqrt_eps, charge, perm, n_pad, dtype=None,
                  code=None):
    """(3, n_pad) [sigma, sqrt(eps), charge] in the sorted order, 0 on the
    pad slots; with the region codes ``code`` (N,) a 4th row (the
    alchemical variant; pad slots get 0, the environment). A batch of
    orders (``perm`` (R, N)) gives (R, 3 or 4, n_pad)."""
    rows = [sigma, sqrt_eps, charge]
    if code is not None:
        rows.append(code.to(charge.dtype))
    par = torch.stack(rows)[:, perm]
    if perm.dim() == 2:
        par = par.transpose(0, 1)
    dtype = par.dtype if dtype is None else dtype
    pad = torch.zeros(tuple(par.shape[:-1]) + (n_pad - par.shape[-1],),
                      dtype=dtype, device=par.device)
    return torch.cat([par.to(dtype), pad], dim=-1)


def scale_charges_by_code(par, scale):
    """The alchemical variant's (4, n_pad) ``par`` with its charge row
    scaled by ``scale`` (R+1,) at each slot's region code: the 'exact' PME
    treatment's per-particle charge scaling in the kernels' layout. A batch
    (``par`` (B, 4, n_pad), ``scale`` (B, R+1)) scales each row by its
    own."""
    code = par[..., 3, :].long()
    q = par[..., 2, :] * torch.gather(scale.to(par.dtype), -1, code)
    return torch.stack([par[..., 0, :], par[..., 1, :], q, par[..., 3, :]],
                       dim=-2)


def term_params(term):
    """The unsorted per-atom rows the kernels take for ``term``: (sigma,
    sqrt(eps), charge, code); an alchemical term (one with ``region_id``)
    gets sigma clamped to 1e-6 (sigma = 0 sites) and its region codes
    g = region_id + 1, a standard one no code."""
    region_id = getattr(term, "region_id", None)
    if region_id is None:
        return term.sigma, torch.sqrt(term.epsilon), term.charge, None
    return (torch.clamp(term.sigma, min=1e-6), torch.sqrt(term.epsilon),
            term.charge, region_id + 1)


def sorted_inputs(term, x, box, k):
    """The inputs of ``k``'s wrappers for the term ``term`` (a
    NonbondedTerm, or an AlchemicalNonbondedTerm for the alchemical
    variant) at positions ``x``, in a fresh sort: (xT, par, excl, L,
    max_sep). The charges are the term's own, unscaled."""
    dtype = k.input_dtype(x)
    perm, inv = sort_for_sweep(x, box, k.n_pad)
    perm = perm.long()
    _, xT = sorted_positions(x, box, perm, k.n_pad, dtype)
    sigma, sqrt_eps, charge, code = term_params(term)
    par = sorted_params(sigma, sqrt_eps, charge, perm, k.n_pad, dtype, code)
    excl, max_sep = build_exclusion_bitfield(term.exception_index, inv,
                                             k.n_pad, k.mask_rows)
    L = torch.diagonal(box).to(dtype).contiguous()
    return xT, par, excl, L, max_sep
