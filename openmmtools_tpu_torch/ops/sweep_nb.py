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
  1 + the last block of ``shell_block`` shells holding a pair within
  (cutoff + skin)^2.

:class:`SweepNonbonded` has the arguments and the ``forces`` contract of the
TPU kernel ``openmmtools_tpu.ops.sweep_nb.SweepNonbonded`` (standard variant;
the alchemical variant comes with the alchemy port). On CUDA tensors its two
wrappers, :meth:`SweepNonbonded.measure_bound` and :meth:`SweepNonbonded.sweep`,
launch the hand-written kernels of ``csrc/sweep_nb.cu`` or raise; on CPU
tensors they run the plain PyTorch versions :func:`measure_bound_reference` and
:func:`sweep_forces_reference`, which are also the kernels' oracle on the card.
The rebuild flag and the bound stay device tensors that the kernels read, so a
step never waits on the host.

Semantics kept from the TPU kernel: pad slots (``n <= i < n_pad``) take no
part; the minimum image is one conditional shift per axis (exact for wrapped
coordinates); the shell ``s = n_pad/2`` reaches the same partner from both
sides and counts half from each; an exception bit is read only for
``s <= 32 * mask_rows``. Divergence: erfc is exact (``erfcf`` in the kernel,
``torch.special.erfc`` here) where the TPU kernel uses the Abramowitz-Stegun
7.1.26 rational (|error| < 1.5e-7).
"""
from __future__ import annotations

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
           "sorted_inputs", "measure_bound_reference",
           "sweep_forces_reference"]

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
    ``sweep_bound_kernel``; ``xT`` (3, n_pad) sorted positions."""
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


def _excluded(excl, o, i, j):
    """Exception bits of the pairs (i, j = i + o): bit |o|-1 of lane i for
    o > 0 and of lane j for o < 0, read where |o| <= 32 * mask_rows."""
    mask_rows, n_pad = excl.shape
    ao = o.abs()
    lane = torch.where(o > 0, i, j)
    word = torch.clamp((ao - 1) // 32, max=mask_rows - 1)
    bits = (excl.reshape(-1)[word * n_pad + lane] >> ((ao - 1) % 32)) & 1
    return (bits == 1) & (ao <= 32 * mask_rows)


def sweep_forces_reference(xT, par, excl, L, nblk, *, n, cutoff, method,
                           shell_block, switch_width=None, dielectric=78.3,
                           alpha=None, shift_rf=True, switch_coulomb=False):
    """Forces (3, n_pad) and energy (1,) of the bounded sweep: the plain
    version of ``sweep_forces_kernel``. ``xT`` (3, n_pad) sorted wrapped
    positions, ``par`` (3, n_pad) sorted [sigma, sqrt(eps), charge], ``excl``
    (mask_rows, n_pad) int32 bitfield, ``nblk`` (1,) the block bound; any
    floating dtype. Each slot sums its full ring neighbourhood i +- s."""
    dev, dtype = xT.device, xT.dtype
    n_pad = xT.shape[1]
    half = n_pad // 2
    S = min(int(nblk.reshape(-1)[0]) * shell_block, half)
    F = torch.zeros((3, n_pad), dtype=dtype, device=dev)
    U = torch.zeros((), dtype=dtype, device=dev)
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
        else:
            e_c = qq * (inv_r + k_rf * r2 - c_rf)
            w_c = qq * (inv_r2 * inv_r - 2.0 * k_rf)
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
        U = U + 0.5 * torch.sum(e)
    return F, U.reshape(1)


class SweepNonbonded:
    """Bounded-sweep direct-space force program for one NonbondedTerm
    configuration (the standard, non-alchemical variant).

    Static per instance: method, cutoff, switch, dielectric, alpha, particle
    count. Runtime inputs: sorted coordinates and parameters, box, exclusion
    bitfield, rebuild flag and current block bound. ``launches`` counts
    kernel launches per kernel, on CUDA tensors only.
    """

    def __init__(self, n_particles, method, cutoff, switch_width=None,
                 dielectric=78.3, ewald_alpha=None, shift_rf=True,
                 switch_coulomb=False, shell_block=8, skin=0.1,
                 mask_shells=2048):
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
        self.launches = {"sweep_bound": 0, "sweep_forces": 0}

    def physics(self):
        """Keyword arguments of :func:`sweep_forces_reference`."""
        return dict(n=self.n, cutoff=self.rc, method=self.method,
                    shell_block=self.bs, switch_width=self.switch_width,
                    dielectric=self.dielectric, alpha=self.alpha,
                    shift_rf=self.shift_rf,
                    switch_coulomb=self.switch_coulomb)

    def measure_bound(self, xT, L, rebuild, bound):
        """The block bound (int32 (1,)) for this evaluation: re-measured when
        the device flag ``rebuild`` (bool) is set, else ``bound`` (int32)."""
        if not kernels_for(xT, "sweep kernel"):
            return measure_bound_reference(
                xT, L, rebuild, bound, n=self.n, cutoff=self.rc,
                skin=self.skin, shell_block=self.bs)
        dev = xT.device
        rebuild = torch.as_tensor(rebuild, dtype=torch.bool, device=dev)
        bound = torch.as_tensor(bound, dtype=torch.int32, device=dev)
        check_input(xT, torch.float32, (3, self.n_pad))
        check_input(L, torch.float32, (3,))
        check_input(rebuild.reshape(-1), torch.bool, (1,))
        check_input(bound.reshape(-1), torch.int32, (1,))
        grid = self.n_pad // _BLOCK
        partial = torch.empty((_SLICES * grid,), dtype=torch.int32, device=dev)
        nblk = torch.empty((1,), dtype=torch.int32, device=dev)
        err = load_library().sweep_bound_f32(
            xT.data_ptr(), self.n, self.n_pad, L.data_ptr(),
            (self.rc + self.skin) ** 2, self.bs, rebuild.data_ptr(),
            bound.data_ptr(), partial.data_ptr(), nblk.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        self.launches["sweep_bound"] += 1
        check(err, "sweep_bound_f32")
        return nblk

    def sweep(self, xT, par, excl, L, nblk):
        """Forces (3, n_pad) and energy (1,) of sorted positions ``xT`` at
        the block bound ``nblk`` (int32 (1,), read on the device)."""
        if not kernels_for(xT, "sweep kernel"):
            return sweep_forces_reference(xT, par, excl, L, nblk,
                                          **self.physics())
        check_input(xT, torch.float32, (3, self.n_pad))
        check_input(par, torch.float32, (3, self.n_pad))
        check_input(excl, torch.int32, (self.mask_rows, self.n_pad))
        check_input(L, torch.float32, (3,))
        check_input(nblk, torch.int32, (1,))
        dev = xT.device
        grid = self.n_pad // _BLOCK
        f_part = torch.empty((_SLICES, 3, self.n_pad), dtype=torch.float32,
                             device=dev)
        e_part = torch.empty((_SLICES * grid,), dtype=torch.float32,
                             device=dev)
        F = torch.empty((3, self.n_pad), dtype=torch.float32, device=dev)
        U = torch.empty((1,), dtype=torch.float32, device=dev)
        ewald = self.method in ("pme", "ewald")
        if ewald:
            k_rf = c_rf = 0.0
        else:
            d = self.dielectric
            k_rf = (1.0 / self.rc ** 3) * (d - 1.0) / (2.0 * d + 1.0)
            c_rf = ((1.0 / self.rc) * (3.0 * d) / (2.0 * d + 1.0)
                    if self.shift_rf else 0.0)
        sw = self.switch_width
        err = load_library().sweep_forces_f32(
            xT.data_ptr(), par.data_ptr(), excl.data_ptr(), self.n,
            self.n_pad, self.mask_rows, self.bs, L.data_ptr(),
            nblk.data_ptr(), self.rc * self.rc, int(not ewald),
            self.alpha if ewald else 0.0, k_rf, c_rf, int(sw is not None),
            int(self.switch_coulomb), 0.0 if sw is None else self.rc - sw,
            0.0 if sw is None else 1.0 / sw, ONE_4PI_EPS0,
            f_part.data_ptr(), e_part.data_ptr(), F.data_ptr(), U.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        self.launches["sweep_forces"] += 1
        check(err, "sweep_forces_f32")
        return F, U

    def input_dtype(self, t):
        """The float type the wrappers take for tensors on ``t``'s device:
        float32 for the kernels, the caller's own for the plain versions."""
        return (torch.float32 if kernels_for(t, "sweep kernel")
                else t.dtype)

    def evaluate(self, xT, par, excl, L, rebuild, bound):
        """One force evaluation on the (3, n_pad) layout: the bound, then the
        sweep at it. Returns (F (3, n_pad), U (1,), new_bound (1,) int32)."""
        nblk = self.measure_bound(xT, L, rebuild, bound)
        F, U = self.sweep(xT, par, excl, L, nblk)
        return F, U, nblk

    def forces(self, x_sorted, par_sorted, box, excl, rebuild, bound):
        """One force evaluation, the TPU kernel's contract.

        x_sorted: (n_pad, 3) sorted, wrapped positions (pad rows ignored);
        par_sorted: (n_pad, 3) [sigma, sqrt_eps, charge], sorted, 0 pad;
        excl: (mask_rows, n_pad) int32 exception bitfield;
        rebuild: () bool tensor -- re-measure the bound before the sweep;
        bound: () int32 tensor -- the current block bound.

        Returns (F (n_pad, 3), U (), new_bound () int32).
        """
        dtype = self.input_dtype(x_sorted)
        xT = x_sorted.t().to(dtype).contiguous()
        par = par_sorted.t().to(dtype).contiguous()
        L = torch.diagonal(box).to(device=xT.device, dtype=dtype).contiguous()
        F, U, nblk = self.evaluate(xT, par, excl, L, rebuild, bound)
        return F.t(), U[0], nblk[0]


class PlainSweepNonbonded(SweepNonbonded):
    """A SweepNonbonded whose two wrappers run the plain versions on any
    device: the kernels' oracle on the card. It launches nothing."""

    @classmethod
    def like(cls, k: SweepNonbonded) -> "PlainSweepNonbonded":
        return cls(k.n, k.method, k.rc, switch_width=k.switch_width,
                   dielectric=k.dielectric, ewald_alpha=k.alpha,
                   shift_rf=k.shift_rf, switch_coulomb=k.switch_coulomb,
                   shell_block=k.bs, skin=k.skin, mask_shells=k.mask_shells)

    def measure_bound(self, xT, L, rebuild, bound):
        return measure_bound_reference(xT, L, rebuild, bound, n=self.n,
                                       cutoff=self.rc, skin=self.skin,
                                       shell_block=self.bs)

    def sweep(self, xT, par, excl, L, nblk):
        return sweep_forces_reference(xT, par, excl, L, nblk,
                                      **self.physics())


# kernel launch shape, mirrored in csrc/sweep_nb.cu: 128 sorted slots a
# block, the partner range cut into 8 slices (grid.y)
_BLOCK = 128
_SLICES = 8


# ---------------------------------------------------------------------------
# sort and exclusion bitfield (plain tensor code on any device)
# ---------------------------------------------------------------------------


def sort_for_sweep(x, box, n_pad):
    """Wrap + x-sort positions; returns (perm, inv_perm), int32: perm maps a
    sorted slot to its atom, inv_perm the reverse."""
    n = x.shape[0]
    L = torch.diagonal(box)
    xw = x - L * torch.floor(x / L)
    perm = torch.argsort(xw[:, 0], stable=True).to(torch.int32)
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(n, dtype=torch.int32, device=x.device)
    return perm, inv


def unique_pairs(pairs):
    """The distinct (min, max) pairs of an (E, 2) pair list, int64."""
    if pairs.shape[0] == 0:
        return pairs.long()
    return torch.unique(torch.sort(pairs.long(), dim=1).values, dim=0)


def scatter_exclusion_bitfield(pairs, inv_perm, n_pad, mask_rows):
    """:func:`build_exclusion_bitfield` for pairs already deduplicated by
    :func:`unique_pairs`: no host synchronisation."""
    dev = inv_perm.device
    field = torch.zeros((mask_rows * n_pad,), dtype=torch.int32, device=dev)
    if pairs.shape[0] == 0:
        return (field.reshape(mask_rows, n_pad),
                torch.zeros((), dtype=torch.int32, device=dev))
    pairs = pairs.to(dev).long()
    si = inv_perm[pairs[:, 0]].long()
    sj = inv_perm[pairs[:, 1]].long()
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
    field.scatter_add_(0, index, value)
    return field.reshape(mask_rows, n_pad), torch.max(sep).to(torch.int32)


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
    ``x``'s type, xT (3, n_pad) in ``dtype``, pad slots at 1e6)."""
    L = torch.diagonal(box)
    y = (x - L * torch.floor(x / L))[perm]
    dtype = y.dtype if dtype is None else dtype
    pad = torch.full((3, n_pad - y.shape[0]), _PAD_COORD, dtype=dtype,
                     device=y.device)
    return y, torch.cat([y.t().to(dtype), pad], dim=1)


def sorted_params(sigma, sqrt_eps, charge, perm, n_pad, dtype=None):
    """(3, n_pad) [sigma, sqrt(eps), charge] in the sorted order, 0 on the
    pad slots."""
    par = torch.stack([sigma, sqrt_eps, charge])[:, perm]
    dtype = par.dtype if dtype is None else dtype
    pad = torch.zeros((3, n_pad - par.shape[1]), dtype=dtype,
                      device=par.device)
    return torch.cat([par.to(dtype), pad], dim=1)


def sorted_inputs(term, x, box, k):
    """The inputs of ``k``'s wrappers for the NonbondedTerm ``term`` at
    positions ``x``, in a fresh sort: (xT, par, excl, L, max_sep)."""
    dtype = k.input_dtype(x)
    perm, inv = sort_for_sweep(x, box, k.n_pad)
    perm = perm.long()
    _, xT = sorted_positions(x, box, perm, k.n_pad, dtype)
    par = sorted_params(term.sigma, torch.sqrt(term.epsilon), term.charge,
                        perm, k.n_pad, dtype)
    excl, max_sep = build_exclusion_bitfield(term.exception_index, inv,
                                             k.n_pad, k.mask_rows)
    L = torch.diagonal(box).to(dtype).contiguous()
    return xT, par, excl, L, max_sep
