"""Bonded energy terms: harmonic bonds/angles, periodic torsions
(counterpart of ``ops/bonded.py``).

Energy conventions match OpenMM:

* bond:    U = (k/2) (r - r0)^2
* angle:   U = (k/2) (theta - theta0)^2
* torsion: U = k (1 + cos(n*phi - phase))

All functions are vectorized over the leading term axis and return the summed
energy; empty term arrays contribute 0. The ``*_rows`` variants take rows
gathered by the caller, so several terms can share one gather (the sweep
path's remainder, ``integrators/langevin.py``). Forces come from autograd.
"""
from __future__ import annotations

import torch

from openmmtools_tpu_torch.ops.geometry import angle, dihedral, safe_norm


def harmonic_bond_energy_rows(xi, xj, length, k, scale=None):
    """Bond energy from pre-gathered endpoint rows."""
    r = safe_norm(xi - xj)
    e = 0.5 * k * (r - length) ** 2
    if scale is not None:
        e = e * scale
    return torch.sum(e)


def harmonic_bond_energy(x, index, length, k, scale=None):
    """Sum of (k/2)(r - r0)^2 over bonds.

    x: (N,3); index: (B,2) int; length,k: (B,). ``scale`` optionally
    multiplies each bond's energy (used by alchemical bond softening).
    """
    if index.shape[0] == 0:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    idx = index.long()
    return harmonic_bond_energy_rows(x[idx[:, 0]], x[idx[:, 1]], length, k,
                                     scale)


def harmonic_angle_energy_rows(xi, xj, xk, theta0, k, scale=None):
    """Angle energy from pre-gathered rows."""
    th = angle(xi, xj, xk)
    e = 0.5 * k * (th - theta0) ** 2
    if scale is not None:
        e = e * scale
    return torch.sum(e)


def harmonic_angle_energy(x, index, theta0, k, scale=None):
    """Sum of (k/2)(theta - theta0)^2 over angles. index: (A,3)."""
    if index.shape[0] == 0:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    idx = index.long()
    return harmonic_angle_energy_rows(x[idx[:, 0]], x[idx[:, 1]],
                                      x[idx[:, 2]], theta0, k, scale)


def periodic_torsion_energy_rows(xi, xj, xk, xl, periodicity, phase, k,
                                 scale=None):
    """Torsion energy from pre-gathered rows."""
    phi = dihedral(xi, xj, xk, xl)
    e = k * (1.0 + torch.cos(periodicity * phi - phase))
    if scale is not None:
        e = e * scale
    return torch.sum(e)


def periodic_torsion_energy(x, index, periodicity, phase, k, scale=None):
    """Sum of k(1 + cos(n*phi - phase)) over torsions. index: (T,4)."""
    if index.shape[0] == 0:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    idx = index.long()
    return periodic_torsion_energy_rows(x[idx[:, 0]], x[idx[:, 1]],
                                        x[idx[:, 2]], x[idx[:, 3]],
                                        periodicity, phase, k, scale)
