"""Atom-axis sharding of one system's force evaluation (counterpart of
``openmmtools_tpu/parallel/atom_shard.py``).

The system's atoms are cut into equal blocks of rows, one a mesh device
(N padded with zeros up to a whole number of blocks), and the two O(N^2)
pieces are split by block:

* direct space (the dense LJ/Coulomb/erfc pair sum of each
  ``NonbondedTerm``): each block evaluates the (block, N) ordered-pair plane
  of its rows against every column (``dense_pair_energy_forces``'s
  row-blocked mode); the blocks' half-sums add up to the total energy and
  each block's row sums are its atoms' exact forces. No halo exchange: the
  positions go whole to every device;
* reciprocal space (the factorized Ewald structure factors of each
  ``EwaldReciprocalTerm`` with ``kmax``): T is a sum over particles, so each
  block contracts its own atoms' tables, the partial T add up on the first
  device, and each block's forces come from the port's hand backward
  ``_sf_real_backward`` with its own tables and the summed T.

The O(N) remainder (exception pairs, the dispersion tail, the self and
exclusion corrections, every other term) is evaluated whole, once, on the
first device. The blocks' sums meet on the first device.

Divergences: the JAX package runs every block in one SPMD program
(``shard_map``, ``psum``) and evaluates the remainder on every device; here
each block is its own evaluation on its device, and the remainder runs
once. On the card a block's plane obeys ``refuse_dense``'s limit:
block x N entries at most ``DENSE_LIMIT`` squared.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from openmmtools_tpu_torch.constants import ONE_4PI_EPS0
from openmmtools_tpu_torch.ops import nonbonded, pair_forces
from openmmtools_tpu_torch.ops.pme import (
    EwaldReciprocalTerm,
    _real_weight_full,
    _sf_forward_real,
    _sf_real_backward,
)
from openmmtools_tpu_torch.parallel.mesh import ReplicaMesh
from openmmtools_tpu_torch.system import (
    DENSE_LIMIT,
    NonbondedTerm,
    _param,
    value_and_grad,
)

__all__ = ["make_sharded_energy_force_fn"]


def _recip_partials(term, q_blk, x_blk, lengths, M):
    """The block's partial real-basis structure factor T and its tables'
    angles (tx, ty, tz)."""
    two_pi = 2.0 * math.pi
    tx = (two_pi / lengths[0]) * x_blk[:, 0]
    ty = (two_pi / lengths[1]) * x_blk[:, 1]
    tz = (two_pi / lengths[2]) * x_blk[:, 2]
    T, _, _, _ = _sf_forward_real(q_blk, tx, ty, tz, M)
    return T, (tx, ty, tz)


def make_sharded_energy_force_fn(system, mesh: ReplicaMesh,
                                 axis_name: str = "atom"):
    """Return ``(x, box, params) -> (U, F)`` evaluated block by block over
    the mesh's devices, with the single-device semantics of
    :func:`~openmmtools_tpu_torch.system.make_energy_force_fn` to
    reduction-order rounding. U and F land on the mesh's first device.
    Virtual sites are not supported: raises."""
    if system.virtual_sites is not None and system.virtual_sites.n_sites > 0:
        raise NotImplementedError(
            "atom-axis sharding does not support virtual-site systems yet; "
            "use the unsharded energy/force path")
    devices = list(mesh.devices)
    n_devices = len(devices)
    n = system.n_particles
    block = -(-n // n_devices)
    n_pad = block * n_devices

    def pad(t, rows=n_pad):
        if t.shape[0] == rows:
            return t
        return torch.cat([t, torch.zeros((rows - t.shape[0],) + t.shape[1:],
                                         dtype=t.dtype, device=t.device)])

    nb_terms = [t for t in system.terms if type(t) is NonbondedTerm]
    recip_terms = [t for t in system.terms
                   if isinstance(t, EwaldReciprocalTerm)
                   and t.kmax is not None]
    sharded = {id(t) for t in nb_terms + recip_terms}
    other_terms = [t for t in system.terms if id(t) not in sharded]
    # each device's copy of the sharded terms' per-atom rows, padded
    per_device = []
    for dev in devices:
        nb = [(t, pad(t.charge).to(dev), pad(t.sigma).to(dev),
               pad(t.epsilon).to(dev), t.exception_index.to(dev))
              for t in nb_terms]
        per_device.append((nb, [t.to(device=dev) for t in recip_terms]))

    def energy_force_fn(x, box=None, params: Optional[dict] = None):
        if box is None:
            box = system.default_box
        box = box.to(dtype=x.dtype)
        params = {} if params is None else params
        first = devices[0]
        if (x.device.type == "cuda"
                and block * n > DENSE_LIMIT * DENSE_LIMIT):
            raise RuntimeError(
                f"a block's pair plane ({block} x {n} entries) is past the "
                f"dense limit ({DENSE_LIMIT} squared) on the card; use more "
                "blocks")
        x_pad = pad(x)
        # the parts add up in float64, as the sweep path sums them
        u_total = torch.zeros((), dtype=torch.float64, device=first)
        blocks_f = []
        recip_T = [[] for _ in recip_terms]
        recip_tables = []
        for k, dev in enumerate(devices):
            lo = k * block
            xd = x_pad.to(dev)
            boxd = box.to(dev)
            pd = {name: torch.as_tensor(v).to(dev)
                  for name, v in params.items()}
            f_blk = torch.zeros((block, 3), dtype=x.dtype, device=dev)
            u_blk = torch.zeros((), dtype=torch.float64, device=dev)
            nb, recip_on = per_device[k]
            for term, q_pad, sig_pad, eps_pad, exc in nb:
                charge_scale = _param(pd, term.charge_scale_param, None)
                lj_scale = _param(pd, term.lj_scale_param, None)
                charges = q_pad
                if charge_scale is None and term.uncharged:
                    charges = None
                u, f = pair_forces.dense_pair_energy_forces(
                    xd, boxd, charges, sig_pad, eps_pad,
                    method=term.method, cutoff=term.cutoff,
                    switch_width=term.switch_width,
                    dielectric=term.dielectric, alpha=term.ewald_alpha,
                    periodic=term.periodic, charge_scale=charge_scale,
                    lj_scale=lj_scale, shift_rf=term.shift_rf,
                    switch_coulomb=term.switch_coulomb, exclude_index=exc,
                    row_start=lo, row_block=block, n_valid=n)
                u_blk = u_blk + u
                f_blk = f_blk + f
            tables = []
            for term in recip_on:
                q = pad(term.effective_charge(pd))
                lengths = torch.diagonal(boxd)
                T, angles = _recip_partials(term, q[lo:lo + block],
                                            xd[lo:lo + block], lengths,
                                            int(term.kmax))
                recip_T[len(tables)].append(T.to(first))
                tables.append((q[lo:lo + block], angles, lengths))
            recip_tables.append(tables)
            u_total = u_total + u_blk.to(first)
            blocks_f.append(f_blk)

        # reciprocal space: the summed T, then each block's forces by the
        # hand backward with its own tables
        for i, term in enumerate(recip_terms):
            M = int(term.kmax)
            T = torch.stack(recip_T[i]).sum(dim=0)
            lengths = torch.diagonal(box.to(first))
            w = term.weight_grid(box.to(first))
            c = ONE_4PI_EPS0 * (2.0 * math.pi / torch.prod(lengths))
            u_total = u_total + c * torch.sum(_real_weight_full(w, M) * T * T)
            for k, dev in enumerate(devices):
                q_blk, (tx, ty, tz), lengths_d = recip_tables[k][i]
                _, dtx, dty, dtz, _ = _sf_real_backward(
                    q_blk, tx, ty, tz, w.to(dev), T.to(dev), M,
                    c.to(dev))
                two_pi = 2.0 * math.pi
                blocks_f[k] = blocks_f[k] - torch.stack(
                    [dtx * (two_pi / lengths_d[0]),
                     dty * (two_pi / lengths_d[1]),
                     dtz * (two_pi / lengths_d[2])], dim=-1)

        # the O(N) remainder, whole, on the first device
        xf = x.to(first)
        boxf = box.to(first)
        pf = {name: torch.as_tensor(v).to(first)
              for name, v in params.items()}
        f_rest = torch.zeros_like(xf)
        for term in nb_terms:
            lj_scale = _param(pf, term.lj_scale_param, None)
            if term.exception_index.shape[0] > 0:
                u_exc, f_exc = pair_forces.pair_list_energy_forces(
                    xf, boxf, term.exception_index.to(first),
                    term.exception_chargeprod.to(first),
                    term.exception_sigma.to(first),
                    term.exception_epsilon.to(first),
                    method="no_cutoff", periodic=term.periodic)
                u_total = u_total + u_exc
                f_rest = f_rest + f_exc
            if term.use_dispersion_correction and term.periodic:
                u_total = u_total + nonbonded.dispersion_correction_energy(
                    boxf, term.sigma.to(first), term.epsilon.to(first),
                    term.cutoff, lj_scale=lj_scale)
        for term in recip_terms:
            term_f = term.to(device=first)
            q = term_f.effective_charge(pf)
            u_se, g_se = value_and_grad(
                lambda xx, t=term_f, q=q: t.self_exclusion_energy(
                    q, xx, boxf), xf)
            u_total = u_total + u_se
            f_rest = f_rest - g_se
        for term in other_terms:
            term_f = term.to(device=first)
            if hasattr(term_f, "energy_forces"):
                u, f = term_f.energy_forces(xf, boxf, pf)
            else:
                u, g = value_and_grad(
                    lambda xx, t=term_f: t.energy(xx, boxf, pf), xf)
                f = -g
            u_total = u_total + u
            f_rest = f_rest + f
        f_all = torch.cat([f.to(first) for f in blocks_f])[:n]
        return u_total, f_all + f_rest

    return energy_force_fn
