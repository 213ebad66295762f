"""Constraints: the port's ops/constraints.py against the JAX package's, at
float64 on the CPU (positions and velocities to rel 1e-10).

SETTLE runs on a rigid water box in its contiguous layout and with the
molecules' atoms scattered (the gather path); M-SHAKE/M-RATTLE on methyl-like
clusters of three constraints; Jacobi SHAKE/RATTLE on a chain too long to
cluster. Displacements and velocities come from a numpy seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmmtools_tpu.models import WaterBox as JaxWaterBox
from openmmtools_tpu.ops import constraints as jc
from openmmtools_tpu.system import Constraints as JaxConstraints
from openmmtools_tpu_torch.ops import constraints as tc
from openmmtools_tpu_torch.system import Constraints

from test_torch_support import np64

REL = 1e-10


def _close(a, b, rel=REL):
    a, b = np64(a), np.asarray(b, np.float64)
    return np.abs(a - b).max() <= rel * np.abs(b).max()


def _pair(index, distance, masses):
    """The same constraint set and masses in both packages, float64."""
    jax_c = JaxConstraints(index=np.asarray(index, np.int32),
                           distance=np.asarray(distance, np.float64))
    port_c = Constraints(index=torch.as_tensor(np.asarray(index, np.int32)),
                         distance=torch.as_tensor(distance, dtype=torch.float64))
    return jax_c, port_c, np.asarray(masses, np.float64), torch.as_tensor(
        masses, dtype=torch.float64)


@pytest.fixture(scope="module", params=["contiguous", "scattered"])
def water(request):
    """648-atom rigid TIP3P box; "scattered" renumbers the atoms so that no
    molecule is an (apex, sat, sat) run of consecutive indices."""
    w = JaxWaterBox(box_edge=1.9, cutoff=0.9)
    n = w.system.n_particles
    x = np.asarray(w.positions, np.float64)
    masses = np.asarray(w.system.masses, np.float64)
    idx = np.asarray(w.system.constraints.index)
    dist = np.asarray(w.system.constraints.distance, np.float64)
    if request.param == "scattered":
        perm = np.random.default_rng(1).permutation(n)   # new -> old
        new_of_old = np.argsort(perm)
        x, masses, idx = x[perm], masses[perm], new_of_old[idx]
    rng = np.random.default_rng(3)
    v = rng.normal(scale=1.5, size=(n, 3))
    return (request.param, x, x + 0.002 * v, v) + _pair(idx, dist, masses)


def test_settle_spec_matches_jax(water):
    layout, x, _, _, jcon, tcon, m, mt = water
    js = jc.analyze_settle(jcon, m)
    ts = tc.analyze_settle(tcon, mt)
    assert (ts.contig is None) == (layout == "scattered")
    assert ts.contig == js.contig
    for a, b in ((ts.a, js.a), (ts.b, js.b), (ts.c, js.c), (ts.ra, js.ra),
                 (ts.rb, js.rb), (ts.rc, js.rc)):
        np.testing.assert_allclose(np64(a), np.asarray(b, np.float64),
                                   rtol=1e-15)
    settle, rest = tc.partition_constraints(tcon, mt)
    assert rest is None and settle.contig == ts.contig


def test_settle_positions_and_velocities_match_jax(water):
    _, x, x_new, v, jcon, tcon, m, mt = water
    js = jc.analyze_settle(jcon, m)
    ts = tc.analyze_settle(tcon, mt)
    xp_j = np.asarray(jc.settle_positions(jnp.asarray(x_new),
                                         jnp.asarray(x), js, jnp.asarray(m)))
    xp_t = tc.settle_positions(torch.as_tensor(x_new), torch.as_tensor(x),
                               ts, mt)
    assert _close(xp_t, xp_j)
    # the projection lands on the manifold
    i, j = (tcon.index[:, k].long() for k in (0, 1))
    r = torch.linalg.norm(xp_t[i] - xp_t[j], dim=1)
    assert float((r - tcon.distance).abs().max()) < 1e-10
    vp_j = np.asarray(jc.settle_velocities(jnp.asarray(xp_j), jnp.asarray(v),
                                          js, jnp.asarray(m)))
    vp_t = tc.settle_velocities(xp_t, torch.as_tensor(v), ts, mt)
    assert _close(vp_t, vp_j)
    rel_v = torch.sum((vp_t[i] - vp_t[j]) * (xp_t[i] - xp_t[j]), dim=1)
    assert float(rel_v.abs().max()) < 1e-10


def _methyls(n_groups=12, seed=4):
    """Methyl-like groups: a heavy atom bonded to three hydrogens, plus one
    chain of 10 bonds that no cluster of <= 8 constraints can hold."""
    rng = np.random.default_rng(seed)
    x, masses, index, dist = [], [], [], []
    for g in range(n_groups):
        c = rng.uniform(0, 2, size=3)
        x.append(c)
        masses.append(12.011)
        base = 4 * g
        for h in range(3):
            d = rng.normal(size=3)
            x.append(c + 0.109 * d / np.linalg.norm(d))
            masses.append(1.008)
            index.append((base, base + 1 + h))
            dist.append(0.109)
    start = 4 * n_groups
    p = np.array([0.0, 3.0, 3.0])
    for k in range(11):
        if k:
            d = rng.normal(size=3)
            p = p + 0.15 * d / np.linalg.norm(d)
            index.append((start + k - 1, start + k))
            dist.append(0.15)
        x.append(p)
        masses.append(14.0)
    x = np.asarray(x)
    v = rng.normal(scale=1.0, size=x.shape)
    return x, x + 0.002 * v, v, index, dist, masses


def test_cluster_partition_matches_jax():
    x, _, _, index, dist, masses = _methyls()
    jcon, tcon, m, mt = _pair(index, dist, masses)
    js, jrest = jc.partition_constraints(jcon, m)
    ts, trest = tc.partition_constraints(tcon, mt)
    assert js is None and ts is None
    np.testing.assert_array_equal(trest.index.numpy(), np.asarray(jrest.index))
    assert tc.analyze_clusters(trest, mt) is None   # the 10-bond chain
    methyls = Constraints(index=tcon.index[:36], distance=tcon.distance[:36])
    jmeth = JaxConstraints(index=np.asarray(index[:36], np.int32),
                           distance=np.asarray(dist[:36]))
    tspec = tc.analyze_clusters(methyls, mt)
    jspec = jc.analyze_clusters(jmeth, m)
    assert tspec.block == jspec.block == 3
    for a, b in ((tspec.cons, jspec.cons), (tspec.valid, jspec.valid),
                 (tspec.w, jspec.w)):
        np.testing.assert_allclose(np64(a), np.asarray(b, np.float64),
                                   rtol=1e-6)


def test_mshake_and_mrattle_match_jax():
    x, x_new, v, index, dist, masses = _methyls()
    index, dist = index[:36], dist[:36]           # the methyl clusters
    jcon, tcon, m, mt = _pair(index, dist, masses)
    jspec = jc.analyze_clusters(jcon, m)
    tspec = tc.analyze_clusters(tcon, mt)
    xp_j = np.asarray(jc.mshake_positions(jnp.asarray(x_new), jnp.asarray(x),
                                         jcon, jspec, jnp.asarray(m)))
    xp_t = tc.mshake_positions(torch.as_tensor(x_new), torch.as_tensor(x),
                               tcon, tspec, mt)
    assert _close(xp_t, xp_j)
    vp_j = np.asarray(jc.mrattle_velocities(
        jnp.asarray(xp_j), jnp.asarray(v), jcon, jspec, jnp.asarray(m)))
    vp_t = tc.mrattle_velocities(xp_t, torch.as_tensor(v), tcon, tspec, mt)
    assert _close(vp_t, vp_j)


def test_jacobi_shake_and_rattle_match_jax():
    x, x_new, v, index, dist, masses = _methyls()
    jcon, tcon, m, mt = _pair(index, dist, masses)
    xp_j = np.asarray(jc.shake_positions(jnp.asarray(x_new), jnp.asarray(x),
                                        jcon, jnp.asarray(m)))
    xp_t = tc.shake_positions(torch.as_tensor(x_new), torch.as_tensor(x),
                              tcon, mt)
    assert _close(xp_t, xp_j)
    vp_j = np.asarray(jc.rattle_velocities(jnp.asarray(xp_j), jnp.asarray(v),
                                          jcon, jnp.asarray(m)))
    vp_t = tc.rattle_velocities(xp_t, torch.as_tensor(v), tcon, mt)
    assert _close(vp_t, vp_j)
    i, j = (tcon.index[:, k].long() for k in (0, 1))
    r2 = torch.sum((xp_t[i] - xp_t[j]) ** 2, dim=1)
    assert float(((r2 - tcon.distance ** 2) / tcon.distance ** 2).abs().max()) \
        <= 2e-8


@pytest.mark.parametrize("splitting", ["V R O R V", "O V R V O"])
def test_constrained_generic_trajectory_matches_jax(splitting):
    """The integrator's constraint dispatch (SETTLE after every R, V and O,
    the trailing projection skipped inside a run and restored at its end):
    a rigid PME water box, 8 steps at collision_rate 0 on the generic dense
    program, float64, port against JAX to 1e-9 of scale."""
    import jax

    from openmmtools_tpu.integrators import LangevinIntegrator as JaxLangevin
    from openmmtools_tpu.models import PMEWaterBox as JaxPMEWaterBox
    from openmmtools_tpu.states import SamplerState as JaxSamplerState
    from openmmtools_tpu_torch.integrators import LangevinIntegrator
    from openmmtools_tpu_torch.states import SamplerState

    from test_torch_support import jax_f64, port_system

    jw = JaxPMEWaterBox(box_edge=1.5, cutoff=0.7)
    jsys = jax_f64(jw.system)
    n = jsys.n_particles
    x = np.asarray(jw.positions, np.float64)
    box = np.asarray(jsys.default_box, np.float64)
    m = np.asarray(jsys.masses)
    v = np.random.default_rng(6).normal(size=(n, 3)) * np.sqrt(
        2.494 / m)[:, None]
    kw = dict(temperature=300.0, collision_rate=0.0, timestep=0.002,
              splitting=splitting, neighborlist=None, sweep=None)
    jb = JaxLangevin(**kw).bind(jsys)
    js = jb.run(jb.initial_state(JaxSamplerState(
        positions=x, velocities=v, box_vectors=box), jax.random.PRNGKey(0)), 8)
    tb = LangevinIntegrator(**kw).bind(port_system(jw.system))
    assert tb._settle is not None and tb._vproj_skip
    ts = tb.run(tb.initial_state(SamplerState(
        positions=torch.as_tensor(x), velocities=torch.as_tensor(v),
        box_vectors=torch.as_tensor(box)), torch.Generator()), 8)
    for port, ref in ((ts.positions, js.positions),
                      (ts.velocities, js.velocities)):
        assert _close(port, ref, rel=1e-9)
    assert abs(float(ts.potentials[0]) - float(js.potentials[0])) <= \
        1e-9 * abs(float(js.potentials[0]))
