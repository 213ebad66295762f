"""The reference's parameters, worked out from the benchmark's own inputs.

A :class:`Spec` holds, as numpy arrays in nm, kJ/mol, e and amu, everything
the reference evaluates and the checks compare against: charges and
Lennard-Jones parameters, excluded and scaled pairs, masses, constraints
and molecules. :func:`water_spec` derives it from the water model's
published numbers in a configuration file. Nothing here reads the
program's objects.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Spec:
    n_atoms: int
    box_edge: float
    cutoff: float
    ewald_tolerance: float
    switch_width: Optional[float]
    dispersion_correction: bool
    charge: np.ndarray
    sigma: np.ndarray
    epsilon: np.ndarray
    masses: np.ndarray
    exception_pairs: np.ndarray      # (E, 2): excluded and scaled 1-4 pairs
    exception_qq: np.ndarray
    exception_sigma: np.ndarray
    exception_epsilon: np.ndarray
    constraints: np.ndarray          # (C, 2)
    constraint_distance: np.ndarray  # (C,)
    molecule: np.ndarray             # (N,) molecule index of each atom
    alchemical: np.ndarray           # (N,) bool
    softcore_alpha: float = 0.5


def water_spec(n_waters, box_edge, model, cutoff, ewald_tolerance,
               switch_width, alchemical_waters=()):
    """The Spec of ``n_waters`` rigid waters of ``model`` (a configuration
    file's dict: charges, sigma, epsilon, masses, r_OH, HOH angle), atoms
    O, H, H a molecule, every pair inside a molecule excluded; the waters
    ``alchemical_waters`` form the alchemical region."""
    n = 3 * n_waters
    q = np.tile([model["q_O"], model["q_H"], model["q_H"]], n_waters)
    sigma = np.tile([model["sigma_O_nm"], 0.0, 0.0], n_waters)
    eps = np.tile([model["epsilon_O_kJ"], 0.0, 0.0], n_waters)
    masses = np.tile([model["mass_O"], model["mass_H"], model["mass_H"]],
                     n_waters)
    base = 3 * np.arange(n_waters)[:, None]
    pairs = np.concatenate([base + [0, 1], base + [0, 2], base + [1, 2]])
    r_oh = model["r_OH_nm"]
    r_hh = 2.0 * r_oh * math.sin(math.radians(model["HOH_deg"]) / 2.0)
    dist = np.concatenate([np.full(n_waters, r_oh), np.full(n_waters, r_oh),
                           np.full(n_waters, r_hh)])
    alch = np.zeros(n, bool)
    for w in alchemical_waters:
        alch[3 * w:3 * w + 3] = True
    zeros = np.zeros(len(pairs))
    return Spec(
        n_atoms=n, box_edge=float(box_edge), cutoff=cutoff,
        ewald_tolerance=ewald_tolerance, switch_width=switch_width,
        dispersion_correction=True, charge=q, sigma=sigma, epsilon=eps,
        masses=masses, exception_pairs=pairs.astype(np.int64),
        exception_qq=zeros, exception_sigma=zeros, exception_epsilon=zeros,
        constraints=pairs.astype(np.int64), constraint_distance=dist,
        molecule=np.repeat(np.arange(n_waters), 3), alchemical=alch,
        softcore_alpha=model.get("softcore_alpha", 0.5))
