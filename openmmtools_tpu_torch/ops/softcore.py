"""Softcore pair potentials for alchemical transformations (counterpart of
``ops/softcore.py``).

Functional forms of openmmtools' alchemical factory:

* sterics:        U = lam^a * 4 eps * x (x - 1),  x = (sigma/reff)^6,
                  reff = sigma * (alpha (1-lam)^b + (r/sigma)^c)^(1/c)
* electrostatics: U = lam^d * k_e * qq * g(reff_elec),
                  reff_elec = sigma * (beta (1-lam)^e + (r/sigma)^f)^(1/f)
  with g the method kernel: 1/r (no cutoff), reaction field, or erfc direct
  space.

At lam = 1 both reduce exactly to the standard forms; at lam = 0 the
prefactor kills the interaction while the softcore keeps r -> 0 finite.
Defaults are AlchemicalRegion's: alpha=0.5, a=b=1, c=6; beta=0, d=e=1, f=2.
``lam`` may be a float or a tensor of any shape that broadcasts.
"""
from __future__ import annotations

import torch

from openmmtools_tpu_torch.constants import ONE_4PI_EPS0
from openmmtools_tpu_torch.ops.nonbonded import reaction_field_constants


def softcore_lj(r2, sigma, epsilon, lam, *, alpha=0.5, a=1.0, b=1.0, c=6.0):
    """Softcore Lennard-Jones from squared distance. All args broadcast."""
    sigma2 = sigma * sigma
    if c == 6.0:
        rc_term = (r2 / sigma2) ** 3  # (r/sigma)^6 without sqrt
    else:
        rc_term = (torch.sqrt(r2) / sigma) ** c
    one_minus_lam = 1.0 - lam
    core = alpha * _pow(one_minus_lam, b) + rc_term
    if c == 6.0:
        x = 1.0 / core
    else:
        x = core ** (-6.0 / c)
    return _pow(lam, a) * 4.0 * epsilon * x * (x - 1.0)


def softcore_reff_electrostatics(r, sigma, lam, *, beta=0.0, e=1.0, f=2.0):
    if beta == 0.0:
        return r
    if f == 2.0:
        return sigma * torch.sqrt(beta * _pow(1.0 - lam, e) + (r / sigma) ** 2)
    return sigma * (beta * _pow(1.0 - lam, e) + (r / sigma) ** f) ** (1.0 / f)


def softcore_coulomb(r, qq, sigma, lam, *, method="no_cutoff", cutoff=None,
                     dielectric=78.3, ewald_alpha=None,
                     beta=0.0, d=1.0, e=1.0, f=2.0, shift_rf=True):
    """Softcore Coulomb with the method's kernel: plain 1/reff, reaction
    field in reff (shifted, or with c_rf = 0 for the switched reaction-field
    treatment), or erfc(alpha reff)/reff for PME direct space."""
    reff = softcore_reff_electrostatics(r, sigma, lam, beta=beta, e=e, f=f)
    if method in ("no_cutoff", "cutoff_nonperiodic_nocoulombmod"):
        g = 1.0 / reff
    elif method in ("cutoff_periodic", "cutoff_nonperiodic"):
        k_rf, c_rf = reaction_field_constants(cutoff, dielectric)
        if not shift_rf:
            c_rf = 0.0
        g = 1.0 / reff + k_rf * reff * reff - c_rf
    elif method in ("pme", "ewald"):
        g = torch.special.erfc(ewald_alpha * reff) / reff
    else:
        raise ValueError(f"unknown method {method!r}")
    return _pow(lam, d) * ONE_4PI_EPS0 * qq * g


def _pow(base, p):
    """base**p with integer fast paths (p is a Python number)."""
    if p == 1.0 or p == 1:
        return base
    if p == 2.0 or p == 2:
        return base * base
    return base ** p
