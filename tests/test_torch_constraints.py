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
    assert tb.constraint_solver.settle is not None and tb._vproj_skip
    ts = tb.run(tb.initial_state(SamplerState(
        positions=torch.as_tensor(x), velocities=torch.as_tensor(v),
        box_vectors=torch.as_tensor(box)), torch.Generator()), 8)
    for port, ref in ((ts.positions, js.positions),
                      (ts.velocities, js.velocities)):
        assert _close(port, ref, rel=1e-9)
    assert abs(float(ts.potentials[0]) - float(js.potentials[0])) <= \
        1e-9 * abs(float(js.potentials[0]))


# -- SETTLE on a batch, and the integrator's dispatch around it -------------


def _batch(x, x_new, v, n_rep=3, seed=11):
    """``n_rep`` replicas of one configuration, each moved and kicked by
    its own draw: (x_ref, x_new, v), each (B, N, 3) float64."""
    rng = np.random.default_rng(seed)
    xs, xn, vs = [], [], []
    for _ in range(n_rep):
        kick = rng.normal(scale=1.0, size=x.shape)
        xs.append(x)
        xn.append(x_new + 0.002 * kick)
        vs.append(v + kick)
    return tuple(torch.as_tensor(np.stack(t)) for t in (xs, xn, vs))


def test_batched_settle_equals_per_replica_calls(water):
    """A (B, N, 3) batch through the public SETTLE calls gives each
    replica's single call to the bit, in both layouts."""
    _, x, x_new, v, _, tcon, _, mt = water
    ts = tc.analyze_settle(tcon, mt)
    xr, xn, vb = _batch(x, x_new, v)
    xp = tc.settle_positions(xn, xr, ts, mt)
    vp = tc.settle_velocities(xp, vb, ts, mt)
    assert xp.shape == xn.shape and vp.shape == vb.shape
    for b in range(xn.shape[0]):
        assert torch.equal(xp[b], tc.settle_positions(xn[b], xr[b], ts, mt))
        assert torch.equal(vp[b], tc.settle_velocities(xp[b], vb[b], ts, mt))
        assert torch.equal(xp[b], tc.settle_positions_reference(
            xn[b], xr[b], ts, mt))


def test_settle_counts_projections_and_no_launch_on_the_cpu():
    """On the CPU each public call counts one ``constraints.settle``, a
    batch too, and no ``constraints.settle_kernel``: the plain version
    launches nothing."""
    from openmmtools_tpu_torch.utils import tracing

    w = JaxWaterBox(box_edge=1.2, cutoff=0.5)
    m = torch.as_tensor(np.asarray(w.system.masses, np.float64))
    con = Constraints(index=torch.as_tensor(np.asarray(
        w.system.constraints.index)), distance=torch.as_tensor(np.asarray(
            w.system.constraints.distance, np.float64)))
    spec = tc.analyze_settle(con, m)
    x = torch.as_tensor(np.asarray(w.positions, np.float64))
    tracing.reset()
    tracing.enable()
    try:
        xp = tc.settle_positions(x + 1e-3, x, spec, m)
        tc.settle_velocities(xp, torch.ones_like(x), spec, m)
        tc.settle_positions(torch.stack([x + 1e-3] * 4),
                            torch.stack([x] * 4), spec, m)
        counters = tracing.snapshot().counters
    finally:
        tracing.disable()
        tracing.reset()
    assert counters == {"constraints.settle": 3}
    assert spec.launches == {"settle_positions": 0, "settle_velocities": 0}


@pytest.mark.parametrize("dtype, shape_ref, error", [
    (torch.float16, (6, 3), TypeError),
    (torch.int64, (6, 3), TypeError),
    (torch.float32, (2, 6, 3), ValueError),     # a batch against one
    (torch.float32, (6, 2), ValueError),
])
def test_settle_kernel_refuses_what_it_cannot_take(dtype, shape_ref, error):
    """The kernel's wrapper raises on a type other than float32 and
    float64 and on mismatched shapes, before it reaches the library."""
    m = torch.tensor([16.0, 1.0, 1.0, 16.0, 1.0, 1.0])
    con = Constraints(index=torch.tensor([[0, 1], [0, 2], [1, 2],
                                          [3, 4], [3, 5], [4, 5]]),
                      distance=torch.tensor([0.1, 0.1, 0.16] * 2))
    spec = tc.analyze_settle(con, m)
    x = torch.zeros((6, 3), dtype=dtype)
    y = torch.zeros(shape_ref, dtype=dtype)
    with pytest.raises(error):
        tc._settle_launch("settle_positions", x, y, x, spec)
    assert spec.launches["settle_positions"] == 0


def _mixed(rest):
    """Rigid waters beside methyl-like clusters (and, for ``rest`` =
    "jacobi", the chain no cluster holds): the positions, a move, the
    velocities, the constraints and the masses, float64."""
    w = JaxWaterBox(box_edge=1.5, cutoff=0.7)
    xw = np.asarray(w.positions, np.float64)
    nw = xw.shape[0]
    xm, _, _, index, dist, masses = _methyls()
    if rest == "mshake":
        index, dist = index[:36], dist[:36]
    x = np.concatenate([xw, xm])
    idx = np.concatenate([np.asarray(w.system.constraints.index),
                          np.asarray(index) + nw])
    d = np.concatenate([np.asarray(w.system.constraints.distance,
                                   np.float64), dist])
    m = np.concatenate([np.asarray(w.system.masses, np.float64), masses])
    con = Constraints(index=torch.as_tensor(idx),
                      distance=torch.as_tensor(d))
    rng = np.random.default_rng(21)
    v = rng.normal(scale=1.0, size=x.shape)
    return x, x + 0.002 * v, v, con, torch.as_tensor(m)


def _dispatch(con, m, tol=1e-8):
    """The constraint solver of ``con`` alone, without a system to bind:
    the partition, the clusters and the tolerance."""
    return tc.ConstraintSolver(con, m, tol)


def _old_positions(b, x_new, x_old):
    """The composition the dispatch ran before SETTLE took a batch whole:
    SETTLE, then the other constraints, in one function of a replica."""
    x_new = tc.settle_positions_reference(x_new, x_old, b.settle, b.masses)
    if b.clusters is not None:
        return tc.mshake_positions(x_new, x_old, b.rest, b.clusters,
                                   b.masses, tol=b.tolerance)
    return tc.shake_positions(x_new, x_old, b.rest, b.masses,
                              tol=b.tolerance)


def _old_velocities(b, x, v):
    v = tc.settle_velocities_reference(x, v, b.settle, b.masses)
    if b.clusters is not None:
        return tc.mrattle_velocities(x, v, b.rest, b.clusters, b.masses)
    return tc.rattle_velocities(x, v, b.rest, b.masses, tol=b.tolerance)


@pytest.mark.parametrize("rest", ["mshake", "jacobi"])
def test_constrain_batch_equals_the_per_replica_composition(rest):
    """SETTLE + M-SHAKE (or Jacobi SHAKE) on a batch of three: SETTLE on
    the whole batch, then the rest replica by replica, gives the bits of
    the composition a replica at a time (under vmap for M-SHAKE, a loop for
    Jacobi SHAKE), and one configuration the bits of the plain
    composition."""
    x, x_new, v, con, m = _mixed(rest)
    b = _dispatch(con, m)
    assert b.settle is not None and b.rest is not None
    assert (b.clusters is None) == (rest == "jacobi") == b.host_iterated
    xr, xn, vb = _batch(x, x_new, v)
    xp = b.positions(xn, xr)
    vp = b.velocities(xp, vb)
    if rest == "mshake":
        xo = torch.func.vmap(lambda p, q: _old_positions(b, p, q))(xn, xr)
        vo = torch.func.vmap(lambda p, q: _old_velocities(b, p, q))(xo, vb)
    else:
        xo = torch.stack([_old_positions(b, p, q) for p, q in zip(xn, xr)])
        vo = torch.stack([_old_velocities(b, p, q) for p, q in zip(xo, vb)])
    assert torch.equal(xp, xo) and torch.equal(vp, vo)
    x1 = b.positions(xn[0], xr[0])
    assert torch.equal(x1, _old_positions(b, xn[0], xr[0]))
    assert torch.equal(b.velocities(x1, vb[0]),
                       _old_velocities(b, x1, vb[0]))
    # every constraint holds
    i, j = (con.index[:, k].long() for k in (0, 1))
    r = torch.linalg.norm(xp[:, i] - xp[:, j], dim=-1)
    assert float((r - con.distance).abs().max()) < 1e-6
