"""Bonded terms: the port's ops/bonded.py and system terms against the JAX
package's, at float64 on the CPU (rel 1e-10 for energies and forces).

Geometry comes from a numpy seed: random chains of atoms with bonds, angles
and torsions over them, in both packages from the same arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmtools_tpu.models import FlexibleWaterBox as JaxFlexibleWaterBox
from openmmtools_tpu.ops import bonded as jb
from openmmtools_tpu.system import make_energy_force_fn as jax_ef
from openmmtools_tpu_torch.ops import bonded as tb
from openmmtools_tpu_torch.system import (
    HarmonicAngleTerm,
    HarmonicBondTerm,
    PeriodicTorsionTerm,
    make_energy_force_fn,
    value_and_grad,
)

from test_torch_support import jax_f64, np64, port_system

REL = 1e-10


def _chain(seed=0, n=40):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.normal(scale=0.12, size=(n, 3)), axis=0)
    bonds = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    angles = np.stack([np.arange(n - 2), np.arange(1, n - 1),
                       np.arange(2, n)], 1)
    torsions = np.stack([np.arange(n - 3), np.arange(1, n - 2),
                         np.arange(2, n - 1), np.arange(3, n)], 1)
    return rng, x, bonds.astype(np.int32), angles.astype(np.int32), \
        torsions.astype(np.int32)


def _case(kind):
    """(positions, energy function name, index, parameter arrays)."""
    rng, x, bonds, angles, torsions = _chain()
    if kind == "bond":
        return x, "harmonic_bond_energy", bonds, (
            rng.uniform(0.09, 0.15, len(bonds)),
            rng.uniform(1e5, 4e5, len(bonds)))
    if kind == "angle":
        return x, "harmonic_angle_energy", angles, (
            rng.uniform(1.6, 2.1, len(angles)),
            rng.uniform(300.0, 800.0, len(angles)))
    return x, "periodic_torsion_energy", torsions, (
        rng.integers(1, 4, len(torsions)).astype(np.float64),
        rng.uniform(-np.pi, np.pi, len(torsions)),
        rng.uniform(0.5, 10.0, len(torsions)))


@pytest.mark.parametrize("kind", ["bond", "angle", "torsion"])
def test_bonded_energy_and_forces_match_jax(kind):
    """Energy and its gradient in positions, from the same arrays."""
    x, name, index, params = _case(kind)
    jfn, tfn = getattr(jb, name), getattr(tb, name)
    u_j, g_j = jax.value_and_grad(
        lambda xx: jfn(xx, jnp.asarray(index), *map(jnp.asarray, params)))(
            jnp.asarray(x))
    u_t, g_t = value_and_grad(
        lambda xx: tfn(xx, torch.as_tensor(index),
                       *map(torch.as_tensor, params)), torch.as_tensor(x))
    assert abs(float(u_t) - float(u_j)) <= REL * abs(float(u_j))
    assert np.abs(np64(g_t) - np.asarray(g_j)).max() <= \
        REL * np.abs(np.asarray(g_j)).max()


def test_empty_bonded_terms_are_zero():
    x = torch.zeros((4, 3), dtype=torch.float64)
    empty = torch.zeros((0,), dtype=torch.float64)
    assert float(tb.harmonic_bond_energy(
        x, torch.zeros((0, 2), dtype=torch.int32), empty, empty)) == 0.0
    assert float(tb.harmonic_angle_energy(
        x, torch.zeros((0, 3), dtype=torch.int32), empty, empty)) == 0.0
    assert float(tb.periodic_torsion_energy(
        x, torch.zeros((0, 4), dtype=torch.int32), empty, empty, empty)) == 0.0


def test_rows_variants_match_gathered_forms():
    """The *_rows forms on pre-gathered rows equal the indexed forms (the
    sweep path feeds them from one shared gather)."""
    _, x, bonds, angles, torsions = _chain(seed=3)
    xt = torch.as_tensor(x)
    b = torch.as_tensor(bonds).long()
    a = torch.as_tensor(angles).long()
    t = torch.as_tensor(torsions).long()
    ones = lambda m: torch.ones(m, dtype=torch.float64)  # noqa: E731
    assert float(tb.harmonic_bond_energy_rows(
        xt[b[:, 0]], xt[b[:, 1]], 0.1 * ones(len(b)), ones(len(b)))) == \
        float(tb.harmonic_bond_energy(xt, b, 0.1 * ones(len(b)), ones(len(b))))
    assert float(tb.harmonic_angle_energy_rows(
        xt[a[:, 0]], xt[a[:, 1]], xt[a[:, 2]], ones(len(a)), ones(len(a)))) \
        == float(tb.harmonic_angle_energy(xt, a, ones(len(a)), ones(len(a))))
    assert float(tb.periodic_torsion_energy_rows(
        xt[t[:, 0]], xt[t[:, 1]], xt[t[:, 2]], xt[t[:, 3]], 3 * ones(len(t)),
        ones(len(t)), ones(len(t)))) == float(tb.periodic_torsion_energy(
            xt, t, 3 * ones(len(t)), ones(len(t)), ones(len(t))))


def test_bonded_system_terms_match_jax():
    """The system terms built from the JAX package's numpy form (a flexible
    water box's bonds and angles plus a torsion term) give the JAX energy
    and forces."""
    from openmmtools_tpu.system import (
        HarmonicAngleTerm as JaxAngle,
        HarmonicBondTerm as JaxBond,
        PeriodicTorsionTerm as JaxTorsion,
    )

    jw = JaxFlexibleWaterBox(box_edge=1.9, cutoff=0.9)
    valence = tuple(t for t in jw.system.terms
                    if isinstance(t, (JaxBond, JaxAngle)))
    n = jw.system.n_particles
    rng = np.random.default_rng(5)
    quads = np.stack([rng.choice(n, 4, replace=False) for _ in range(30)])
    torsion = JaxTorsion(index=quads.astype(np.int32),
                         periodicity=rng.integers(1, 4, 30).astype(np.float32),
                         phase=rng.uniform(-3, 3, 30).astype(np.float32),
                         k=rng.uniform(1, 5, 30).astype(np.float32))
    jsys = jw.system.replace(terms=valence + (torsion,))
    port = port_system(jsys)
    assert [type(t) for t in port.terms] == [HarmonicBondTerm,
                                             HarmonicAngleTerm,
                                             PeriodicTorsionTerm]
    x = np.asarray(jw.positions, np.float64) + rng.normal(
        scale=0.005, size=(n, 3))
    u_j, f_j = jax_ef(jax_f64(jsys))(x)
    u_t, f_t = make_energy_force_fn(port)(torch.as_tensor(x))
    assert abs(float(u_t) - float(u_j)) <= REL * abs(float(u_j))
    assert np.abs(np64(f_t) - np.asarray(f_j)).max() <= \
        REL * np.abs(np.asarray(f_j)).max()
