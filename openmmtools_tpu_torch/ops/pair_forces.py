"""Analytic dense pair forces: hand-differentiated LJ + Coulomb.

Counterpart of ``openmmtools_tpu.ops.pair_forces``. Energy and forces come
out of one per-component pass over the (N, N) pair domain; no (N, N, 3)
tensor is formed. This is the generic integrator's force provider and the
CPU oracle of the fused Langevin kernel (``ops/fused_langevin.py``).

Force convention: F_i = sum_j w(r_ij) * d_ij with d_ij = x_i - x_j
(minimum image) and w = -(dU/dr)/r = -2 dU/d(r^2):

* LJ:           w = (24 eps / r^2) (2 s12 - s6),  s6 = (sigma/r)^6
* switched LJ:  U = U_lj S(r)  =>  w = w_lj S - U_lj S'(r)/r
                with OpenMM's quintic S and S'(x)/dx = -30 x^2 (1-x)^2 / (rc - rs)
* Coulomb:      w = k qq / r^3                       (no_cutoff)
* reaction fld: w = k qq (1/r^3 - 2 k_rf)            (cutoff_*)
* Ewald direct: w = k qq [erfc(ar)/r^3 + (2a/sqrt(pi)) exp(-a^2 r^2)/r^2]

Semantics (cutoff, switch, exceptions) match
:func:`openmmtools_tpu_torch.ops.nonbonded.all_pairs_energy`. The row-blocked
mode (``row_start``/``row_block``/``n_valid``) serves atom sharding
(:mod:`openmmtools_tpu_torch.parallel.atom_shard`).
"""
from __future__ import annotations

import math

import torch

from openmmtools_tpu_torch.constants import ONE_4PI_EPS0
from openmmtools_tpu_torch.ops.nonbonded import (
    _exclusion_keep,
    pair_list_energy,
    reaction_field_constants,
)

__all__ = ["dense_pair_energy_forces", "pair_list_energy_forces"]


def dense_pair_energy_forces(
    x,
    box,
    charges,
    sigmas,
    epsilons,
    *,
    method="no_cutoff",
    cutoff=None,
    switch_width=None,
    dielectric=78.3,
    alpha=None,
    periodic=False,
    charge_scale=None,
    lj_scale=None,
    shift_rf=True,
    switch_coulomb=False,
    exclude_index=None,
    row_start=None,
    row_block=None,
    n_valid=None,
):
    """Energy and forces of the dense all-pairs LJ+Coulomb sum.

    Returns ``(U, F)``: ``U`` scalar and ``F`` (N, 3), the value and
    ``-grad`` of :func:`ops.nonbonded.all_pairs_energy`. ``charges=None``
    skips all Coulomb math (uncharged LJ systems).

    Row-blocked mode (atom sharding): with ``row_start`` and ``row_block``
    (host ints) only the (row_block, N) plane of the rows row_start ..
    row_start + row_block - 1 against every column is formed; ``U`` is that
    plane's half-sum, summed in float64 (the blocks' values add up to the
    total, whose parts cancel to a few parts in 10^4 on water) and ``F``
    (row_block, 3) the owned rows' exact forces. ``n_valid`` masks the rows
    and columns from ``n_valid`` on (the zero padding of N up to a whole
    number of blocks).
    """
    n = x.shape[0]
    dtype = x.dtype
    if n < 2:
        rows = n if row_block is None else int(row_block)
        return (torch.zeros((), dtype=dtype, device=x.device),
                torch.zeros((rows, 3), dtype=dtype, device=x.device))

    q = charges if charge_scale is None or charges is None \
        else charges * charge_scale
    eps = epsilons if lj_scale is None else epsilons * lj_scale

    if row_start is None:
        b, lo = n, 0
        x_i = x
    else:
        b, lo = int(row_block), int(row_start)
        x_i = x[lo:lo + b]

    ds = []
    r2 = None
    if periodic:
        Ld = torch.diagonal(box)
    for c in range(3):
        d = x_i[:, c][:, None] - x[None, :, c]
        if periodic:
            d = d - Ld[c] * torch.round(d * (1.0 / Ld[c]))
        ds.append(d)
        r2 = d * d if r2 is None else r2 + d * d

    # ordered pairs (i != j): each unordered pair counted twice, so energy
    # is halved below while the force row-sums come out exact
    if row_start is None:
        mask = ~torch.eye(n, dtype=torch.bool, device=x.device)
    else:
        row = torch.arange(lo, lo + b, device=x.device)[:, None]
        col = torch.arange(n, device=x.device)[None, :]
        mask = row != col
        if n_valid is not None and n_valid < n:
            mask = mask & (row < n_valid) & (col < n_valid)
    if cutoff is not None and method != "no_cutoff":
        mask = mask & (r2 < cutoff * cutoff)
    if exclude_index is not None and exclude_index.shape[0] > 0:
        keep = _exclusion_keep(exclude_index, n, x.device)
        mask = mask & (keep if row_start is None else keep[lo:lo + b])

    # clamp masked-out entries to a safe distance (double-where pattern)
    inv_r2 = torch.where(mask, 1.0 / torch.clamp(r2, min=1e-12), 0.0)

    seps = torch.sqrt(eps)
    sig_ij = 0.5 * (sigmas[lo:lo + b][:, None] + sigmas[None, :])
    eps_ij = seps[lo:lo + b][:, None] * seps[None, :]

    s2 = sig_ij * sig_ij * inv_r2
    s6 = s2 * s2 * s2
    s12 = s6 * s6
    e_lj = 4.0 * eps_ij * (s12 - s6)
    w_lj = (24.0 * eps_ij) * (2.0 * s12 - s6) * inv_r2

    inv_r = torch.sqrt(inv_r2)
    r = r2 * inv_r  # masked entries have inv_r = 0 -> r = 0

    if q is None:
        e_c = w_c = None
    elif method in ("no_cutoff", "cutoff_nonperiodic_nocoulombmod"):
        kqq = ONE_4PI_EPS0 * (q[lo:lo + b][:, None] * q[None, :])
        e_c = kqq * inv_r
        w_c = kqq * inv_r2 * inv_r
    elif method in ("cutoff_periodic", "cutoff_nonperiodic"):
        k_rf, c_rf = reaction_field_constants(cutoff, dielectric)
        if not shift_rf:
            c_rf = 0.0
        kqq = ONE_4PI_EPS0 * (q[lo:lo + b][:, None] * q[None, :])
        e_c = kqq * (inv_r + k_rf * r2 - c_rf)
        w_c = kqq * (inv_r2 * inv_r - 2.0 * k_rf)
    elif method in ("pme", "ewald"):
        kqq = ONE_4PI_EPS0 * (q[lo:lo + b][:, None] * q[None, :])
        erfc_ar = torch.special.erfc(alpha * r)
        gauss = (2.0 * alpha / math.sqrt(math.pi)) * torch.exp(
            -(alpha * alpha) * r2)
        e_c = kqq * erfc_ar * inv_r
        w_c = kqq * (erfc_ar * inv_r2 * inv_r + gauss * inv_r2)
    else:
        raise ValueError(f"unknown nonbonded method {method!r}")

    if switch_width is not None and cutoff is not None:
        r_switch = cutoff - switch_width
        inv_span = 1.0 / (cutoff - r_switch)
        t = torch.clamp((r - r_switch) * inv_span, 0.0, 1.0)
        one_m_t = 1.0 - t
        S = 1.0 + t * t * t * (-10.0 + t * (15.0 - 6.0 * t))
        dS_dr = -30.0 * (t * t) * (one_m_t * one_m_t) * inv_span
        if switch_coulomb and e_c is not None:
            e_all = e_lj + e_c
            w = (w_lj + w_c) * S - e_all * dS_dr * inv_r
            e_pair_val = e_all * S
        else:
            w = w_lj * S - e_lj * dS_dr * inv_r
            e_pair_val = e_lj * S
            if e_c is not None:
                w = w + w_c
                e_pair_val = e_pair_val + e_c
    else:
        w = w_lj
        e_pair_val = e_lj
        if e_c is not None:
            w = w + w_c
            e_pair_val = e_pair_val + e_c

    e_pair = torch.where(mask, e_pair_val, 0.0)
    w = torch.where(mask, w, 0.0)

    F = torch.stack([torch.sum(w * d, dim=1) for d in ds], dim=-1)
    if row_start is not None:
        return 0.5 * torch.sum(e_pair, dtype=torch.float64), F.to(dtype)
    U = 0.5 * torch.sum(e_pair)
    return U.to(dtype), F.to(dtype)


def pair_list_energy_forces(
    x,
    box,
    pairs,
    qq,
    sigma,
    epsilon,
    *,
    method="no_cutoff",
    cutoff=None,
    switch_width=None,
    dielectric=78.3,
    alpha=None,
    periodic=False,
    apply_cutoff=True,
    shift_rf=True,
    switch_coulomb=False,
):
    """(U, F) over an explicit pair list (exceptions), by autograd of
    :func:`ops.nonbonded.pair_list_energy`: the pair count is O(N), so hand
    differentiation buys little."""
    if pairs.shape[0] == 0:
        return torch.zeros((), dtype=x.dtype, device=x.device), torch.zeros_like(x)
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        u = pair_list_energy(
            xx, box, pairs, qq, sigma, epsilon, method=method, cutoff=cutoff,
            switch_width=switch_width, dielectric=dielectric, alpha=alpha,
            periodic=periodic, apply_cutoff=apply_cutoff, shift_rf=shift_rf,
            switch_coulomb=switch_coulomb)
        (g,) = torch.autograd.grad(u, xx)
    return u.detach(), -g
