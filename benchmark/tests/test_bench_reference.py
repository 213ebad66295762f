"""The reference against closed forms: the Madelung constant of rock salt,
and the softcore's end points."""
import math

import numpy as np
import pytest
import torch

from benchmark.reference import forcefield
from benchmark.reference.energy import (
    ONE_4PI_EPS0,
    Reference,
    lj,
    softcore_lj,
    switch,
)

MADELUNG_NACL = 1.747564594633


def ions_spec(x, q, box_edge, cutoff, tol):
    n = len(q)
    zero = np.zeros(n)
    return forcefield.Spec(
        n_atoms=n, box_edge=box_edge, cutoff=cutoff, ewald_tolerance=tol,
        switch_width=None, dispersion_correction=False, charge=np.asarray(q),
        sigma=zero, epsilon=zero, masses=np.ones(n),
        exception_pairs=np.zeros((0, 2), np.int64),
        exception_qq=np.zeros(0), exception_sigma=np.zeros(0),
        exception_epsilon=np.zeros(0),
        constraints=np.zeros((0, 2), np.int64),
        constraint_distance=np.zeros(0), molecule=np.arange(n),
        alchemical=np.zeros(n, bool))


def test_ewald_reproduces_the_madelung_constant_of_rock_salt():
    r0, m = 0.25, 8                      # nearest-neighbour distance, sites
    grid = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    q = np.where(grid.sum(1) % 2 == 0, 1.0, -1.0)
    box = m * r0
    spec = ions_spec(grid * r0, q, box, 0.99, 1e-10)
    u, f = Reference(spec, "cpu").energy_forces(grid * r0, box)
    per_pair = u / (len(q) / 2)
    assert per_pair == pytest.approx(-MADELUNG_NACL * ONE_4PI_EPS0 / r0,
                                     rel=1e-6)
    # every ion sits at a centre of symmetry: no force
    assert np.abs(f).max() < 1e-6 * ONE_4PI_EPS0 / r0 ** 2


def test_softcore_end_points():
    r2 = torch.linspace(0.05, 1.0, 50, dtype=torch.float64) ** 2
    sig = torch.full_like(r2, 0.3)
    eps = torch.full_like(r2, 0.6)
    assert torch.allclose(softcore_lj(r2, sig, eps, 1.0, 0.5),
                          lj(r2, sig, eps), rtol=1e-14, atol=0)
    assert torch.all(softcore_lj(r2, sig, eps, 0.0, 0.5) == 0)
    # finite at contact for lam < 1
    assert torch.isfinite(softcore_lj(torch.zeros(1, dtype=torch.float64),
                                      sig[:1], eps[:1], 0.5, 0.5)).all()


TIP3P = dict(q_O=-0.834, q_H=0.417, sigma_O_nm=0.31507,
             epsilon_O_kJ=0.635968, mass_O=15.99943, mass_H=1.007947,
             r_OH_nm=0.09572, HOH_deg=104.52)


def water(n_side=6, edge=1.9, seed=0):
    rng = np.random.default_rng(seed)
    a = math.radians(TIP3P["HOH_deg"]) / 2
    s, c = math.sin(a), math.cos(a)
    geom = TIP3P["r_OH_nm"] * np.array([[0, 0, 0], [s, 0, c], [-s, 0, c]])
    x = []
    for c in np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"),
                      -1).reshape(-1, 3):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        x.append(geom @ q.T + (c + 0.5) * edge / n_side)
    return np.concatenate(x), edge


def test_alchemical_end_points_against_the_pair_sum():
    """At (1, 1) the alchemical water is a plain one; at (0, 0) its direct
    space is gone and nothing else changes (the reciprocal sum keeps its
    charges: the direct-space treatment)."""
    x, edge = water()
    n_w = len(x) // 3
    alch = forcefield.water_spec(n_w, edge, TIP3P, 0.9, 5e-4, 0.15, [0])
    plain = forcefield.water_spec(n_w, edge, TIP3P, 0.9, 5e-4, 0.15, [])
    ra, rp = Reference(alch, "cpu"), Reference(plain, "cpu")
    u_p, f_p = rp.energy_forces(x, edge)
    u_1, f_1 = ra.energy_forces(x, edge, 1.0, 1.0)
    assert u_1 == pytest.approx(u_p, rel=1e-13)
    assert np.allclose(f_1, f_p, rtol=0, atol=1e-9)
    # the water's direct-space pairs with the others, by hand
    d = x[:3, None, :] - x[None, 3:, :]
    d -= edge * np.round(d / edge)
    r = np.sqrt((d * d).sum(-1))
    inside = r < 0.9
    qq = alch.charge[:3, None] * alch.charge[None, 3:]
    from scipy.special import erfc
    e_c = ONE_4PI_EPS0 * qq * erfc(rp.alpha * r) / r
    sig = 0.5 * (alch.sigma[:3, None] + alch.sigma[None, 3:])
    eps = np.sqrt(alch.epsilon[:3, None] * alch.epsilon[None, 3:])
    s6 = np.where(eps > 0, (np.where(eps > 0, sig, 1) / r) ** 6, 0)
    sw = switch(torch.as_tensor(r), 0.9, 0.15).numpy()
    e_lj = 4 * eps * s6 * (s6 - 1) * sw
    direct = float(np.sum(np.where(inside, e_c + e_lj, 0)))
    u_0 = ra.energies_over(x, edge, [(0.0, 0.0)])[0]
    # the dispersion tail of the water's pairs goes with them
    tail = ra.constant_terms(edge, 1.0) - ra.constant_terms(edge, 0.0)
    assert u_0 == pytest.approx(u_p - direct - float(tail), rel=1e-12)
