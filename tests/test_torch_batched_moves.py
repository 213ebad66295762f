"""Every move tree as one batch of replicas (``MCMCMove.apply_batch``), on
the CPU.

* Batched against eager, bit for bit, in float64 and float32, for each
  move type: the displacement, the rotation, the barostat, ``SequenceMove``
  and ``WeightedMove``, on the generic program (an LJ fluid, a harmonic
  oscillator) and in forced sweep mode on the small alchemical water box,
  three replicas at three states drawing from three generators (the water
  box's moves act on its alchemical water, which the decoupled states
  accept); per-state
  moves through the sampler's batched route against its eager loop.
* The batched Metropolized and barostat cores against the JAX package's
  ``_metropolis_kernel`` and ``_scan_attempts``, fed the same draws, replica
  by replica, at rel 1e-10 in float64.
* ``move_statistics`` in the JAX sampler's layout for the same tree.
* A harmonic-oscillator ladder under ``SequenceMove([MCDisplacementMove,
  LangevinDynamicsMove])`` through the JAX sampler and the port's batched
  route: <U> per state within 3 sigma (the noise streams cannot match).
* F9: the replica's generator reaches every leaf of a container. Under a
  ``SequenceMove`` two rng seeds give two trajectories, one seed the same
  bits, and a resume from storage continues the run bitwise; a
  ``WeightedMove`` picks its branch and runs it from the replica's stream.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmmtools_tpu.mcmc as jmc
import openmmtools_tpu.multistate as jms
from openmmtools_tpu.models import HarmonicOscillator as JaxHO
from openmmtools_tpu.models import testsystems as jts
from openmmtools_tpu.models import water as jwater
from openmmtools_tpu.states import SamplerState as JaxSS
from openmmtools_tpu.states import ThermodynamicState as JaxState
import openmmtools_tpu_torch.mcmc as tmc
import openmmtools_tpu_torch.multistate as tms
from openmmtools_tpu_torch.cache import ContextCache
from openmmtools_tpu_torch.constants import kB
from openmmtools_tpu_torch.models import (
    AlchemicalWaterBox,
    HarmonicOscillator,
    LennardJonesCluster,
    LennardJonesFluid,
)
from openmmtools_tpu_torch.multistate.sampler import statistics_leaves
from openmmtools_tpu_torch.states import SamplerState, ThermodynamicState

from test_torch_support import jax_f64, port_system

REL = 1e-10
TEMPS = [300.0, 320.0, 350.0]
LAMBDAS = [(1.0, 1.0), (0.6, 0.0), (0.3, 0.0)]   # (sterics, electrostatics)
SEEDS = [11, 12, 13]
DTYPES = [torch.float64, torch.float32]


# -- the systems: three replicas at three states ------------------------------


def _water(dtype, pressure=None):
    """The small alchemical water box (648 atoms), three perturbed
    replicas at three (lambda, T) states, and a cache that forces sweep
    mode."""
    w = AlchemicalWaterBox(box_edge=1.9, cutoff=0.9, device="cpu")
    system = w.system.to(dtype=dtype)
    states = [ThermodynamicState(
        system=system, temperature=t, pressure=pressure,
        global_params={"lambda_sterics": ls, "lambda_electrostatics": le})
        for t, (ls, le) in zip(TEMPS, LAMBDAS)]
    rng = np.random.default_rng(3)
    x = w.positions.to(dtype)
    box = system.default_box.to(dtype)
    sss = [SamplerState(positions=x + torch.as_tensor(
        rng.normal(scale=2e-3, size=x.shape), dtype=dtype),
        box_vectors=box.clone()) for _ in TEMPS]
    return states, sss, ContextCache(sweep="force")


def _lj(dtype, pressure=None):
    """LJ-64 (the generic program): three replicas at three
    temperatures."""
    f = LennardJonesFluid(nparticles=64, reduced_density=0.3, device="cpu")
    system = f.system.to(dtype=dtype)
    states = [ThermodynamicState(system=system, temperature=t / 2.5,
                                 pressure=pressure) for t in TEMPS]
    rng = np.random.default_rng(4)
    x = f.positions.to(dtype)
    sss = [SamplerState(positions=x + torch.as_tensor(
        rng.normal(scale=1e-2, size=x.shape), dtype=dtype),
        box_vectors=system.default_box.to(dtype).clone()) for _ in TEMPS]
    return states, sss, ContextCache()


def _cluster(dtype, pressure=None):
    """A 2 x 2 x 2 LJ cluster (not periodic, the generic program) at three
    temperatures."""
    cl = LennardJonesCluster(nx=2, ny=2, nz=2, device="cpu")
    system = cl.system.to(dtype=dtype)
    states = [ThermodynamicState(system=system, temperature=t / 2.5)
              for t in TEMPS]
    rng = np.random.default_rng(6)
    x = cl.positions.to(dtype)
    sss = [SamplerState(positions=x + torch.as_tensor(
        rng.normal(scale=1e-2, size=x.shape), dtype=dtype)) for _ in TEMPS]
    return states, sss, ContextCache()


def _ho(dtype, pressure=None):
    """The harmonic oscillator (K 100, the generic program) at three
    temperatures."""
    ho = HarmonicOscillator(K=100.0, device="cpu")
    system = ho.system.to(dtype=dtype)
    states = [ThermodynamicState(system=system, temperature=t)
              for t in TEMPS]
    sss = [SamplerState(positions=torch.tensor([[0.1 * b, -0.05, 0.02]],
                                               dtype=dtype))
           for b in range(len(TEMPS))]
    return states, sss, ContextCache()


def _langevin(n_steps=4):
    return tmc.LangevinDynamicsMove(timestep=0.002, collision_rate=5.0,
                                    n_steps=n_steps)


MOVES = {
    # the first three atoms: the alchemical water of the water box
    "displacement": lambda: tmc.MCDisplacementMove(
        displacement_sigma=0.05, atom_subset=[0, 1, 2]),
    "water_displacement": lambda: tmc.MCDisplacementMove(
        displacement_sigma=0.02, atom_subset=[0, 1, 2]),
    "water_rotation": lambda: tmc.MCRotationMove(atom_subset=[0, 1, 2]),
    "rotation": lambda: tmc.MCRotationMove(),
    "barostat": lambda: tmc.MonteCarloBarostatMove(volume_scale=0.02,
                                                   n_attempts=3),
    "sequence": lambda: tmc.SequenceMove([
        tmc.MCDisplacementMove(displacement_sigma=0.05, atom_subset=[0]),
        _langevin()]),
    "weighted": lambda: tmc.WeightedMove([
        (tmc.MCDisplacementMove(displacement_sigma=0.05, atom_subset=[0]),
         0.5), (_langevin(), 0.5)]),
    "water_sequence": lambda: tmc.SequenceMove([
        tmc.MCDisplacementMove(displacement_sigma=0.05, atom_subset=[0, 1, 2]),
        tmc.MCRotationMove(atom_subset=[0, 1, 2]), _langevin()]),
    "water_weighted": lambda: tmc.WeightedMove([
        (tmc.MCDisplacementMove(displacement_sigma=0.05,
                                atom_subset=[0, 1, 2]), 1.0),
        (tmc.MCRotationMove(atom_subset=[0, 1, 2]), 1.0),
        (_langevin(), 1.0)]),
}
# (move, system) cases: the generic program and forced sweep mode
CASES = [("displacement", "lj"), ("rotation", "cluster"), ("barostat", "lj"),
         ("sequence", "ho"), ("weighted", "ho"),
         ("water_displacement", "water"), ("water_rotation", "water"),
         ("barostat", "water"), ("water_sequence", "water"),
         ("water_weighted", "water")]
SYSTEMS = {"water": _water, "lj": _lj, "cluster": _cluster, "ho": _ho}


def _leaves(move):
    """Every leaf of a move tree, in traversal order."""
    if isinstance(move, tmc.SequenceMove):
        return [leaf for m in move.move_list for leaf in _leaves(m)]
    if isinstance(move, tmc.WeightedMove):
        return [leaf for m, _ in move.move_set for leaf in _leaves(m)]
    return [move]


def _force_sweep(move, states):
    """Every integrator move's integrator at every state in sweep mode."""
    for leaf in _leaves(move):
        if isinstance(leaf, tmc.BaseIntegratorMove):
            for ts in states:
                leaf._get_integrator(ts).sweep = "force"


def _gens():
    return [torch.Generator().manual_seed(s) for s in SEEDS]


def _assert_same_states(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a.positions, b.positions)
        for name in ("velocities", "box_vectors"):
            va, vb = getattr(a, name), getattr(b, name)
            assert (va is None) == (vb is None)
            if va is not None:
                assert torch.equal(va, vb), name


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("name,system", CASES)
def test_batched_equals_eager_bit_for_bit(name, system, dtype):
    pressure = 50.0 if name == "barostat" else None
    states, sss, cache = SYSTEMS[system](dtype, pressure)
    move = MOVES[name]()
    assert move.batches(states[0])
    batch_move, eager_move = copy.deepcopy(move), copy.deepcopy(move)
    if system == "water":
        _force_sweep(batch_move, states)
        _force_sweep(eager_move, states)
    batch = batch_move.apply_batch(states, sss, _gens(), cache)
    eager = [eager_move.apply(ts, ss, generator=gen, context_cache=cache)
             for ts, ss, gen in zip(states, sss, _gens())]
    _assert_same_states(batch, eager)
    assert any(not torch.equal(a.positions, b.positions)
               for a, b in zip(batch, sss))
    assert ([leaf.statistics for leaf in statistics_leaves(batch_move)]
            == [leaf.statistics for leaf in statistics_leaves(eager_move)])
    # the moves' own generators drew nothing
    assert all(not leaf._generators for leaf in _leaves(batch_move)
               + _leaves(eager_move))


class _EagerSampler(tms.ReplicaExchangeSampler):
    """The sampler held to its eager loop, one ``apply`` a replica."""

    @property
    def propagation_route(self):
        return "eager"


def _per_state_moves():
    """States 0 and 1 take equal trees (two objects: one group), state 2
    another timestep (a second group)."""
    def tree(timestep):
        return tmc.SequenceMove([
            tmc.MCDisplacementMove(displacement_sigma=0.05,
                                   atom_subset=[0, 1, 2]),
            tmc.LangevinDynamicsMove(timestep=timestep, collision_rate=5.0,
                                     n_steps=3)])
    return [tree(0.002), tree(0.002), tree(0.001)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_per_state_moves_batched_equal_eager(dtype, monkeypatch):
    states, sss, _ = _water(dtype)
    monkeypatch.setattr("openmmtools_tpu_torch.cache.global_context_cache",
                        ContextCache(sweep="force"))
    moves = _per_state_moves()
    assert tms.MultiStateSampler.move_groups(moves, [0, 1, 2, 2, 0]) == [
        [0, 1, 4], [2, 3]]
    out = []
    for klass in (tms.ReplicaExchangeSampler, _EagerSampler):
        mine = copy.deepcopy(moves)
        for m in mine:
            _force_sweep(m, states)
        sampler = klass(mcmc_moves=mine, number_of_iterations=2,
                        online_analysis_interval=None, rng_seed=5)
        sampler.create(states, sss)
        sampler.run()
        out.append((sampler, mine))
    (batched, bm), (eager, em) = out
    assert batched.propagation_route == "batched"
    _assert_same_states(batched.sampler_states, eager.sampler_states)
    np.testing.assert_array_equal(batched.energies_last_iteration,
                                  eager.energies_last_iteration)
    for a, b in zip(bm, em):      # each state's move counts its replicas
        assert [leaf.statistics for leaf in statistics_leaves(a)] == [
            leaf.statistics for leaf in statistics_leaves(b)]
    assert sum(m.move_list[0].n_proposed for m in bm) == 2 * 3
    np.testing.assert_array_equal(batched.move_statistics,
                                  eager.move_statistics)


def test_moves_equal_recurses():
    a, b, c = _per_state_moves()
    assert tmc.moves_equal(a, b) and not tmc.moves_equal(a, c)
    b.move_list[0].displacement_sigma = 0.06     # deep inside the tree
    assert not tmc.moves_equal(a, b)
    b.move_list[0].displacement_sigma = 0.05
    b.move_list[0].n_accepted = 7                # statistics play no part
    assert tmc.moves_equal(a, b)
    w1 = tmc.WeightedMove([(a, 1.0), (c, 2.0)])
    w2 = tmc.WeightedMove([(copy.deepcopy(a), 1.0), (copy.deepcopy(c), 2.0)])
    assert tmc.moves_equal(w1, w2)
    w2.move_set[1] = (c, 3.0)
    assert not tmc.moves_equal(w1, w2)


def test_a_move_that_only_applies_keeps_the_eager_route():
    class Jiggle(tmc.MCMCMove):
        def _apply(self, ts, ss, generator, context_cache):
            return ss.replace(positions=ss.positions + 0.01 * torch.randn(
                ss.positions.shape, generator=generator,
                dtype=ss.positions.dtype))

    states, sss, _ = _ho(torch.float64)
    sampler = tms.MultiStateSampler(
        mcmc_moves=tmc.SequenceMove([_langevin(), Jiggle()]),
        number_of_iterations=1, online_analysis_interval=None)
    sampler.create(states, sss)
    assert sampler.propagation_route == "eager"
    sampler.run()
    assert np.isfinite(sampler.energies_last_iteration).all()


# -- the cores against the JAX package's on its draws --------------------------


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _jax_port_states(js, temps, pressures=None):
    jsys, psys = jax_f64(js.system), port_system(js.system)
    pressures = pressures or [None] * len(temps)
    return ([JaxState(system=jsys, temperature=np.float64(t),
                      pressure=None if p is None else np.float64(p))
             for t, p in zip(temps, pressures)],
            [ThermodynamicState(system=psys, temperature=t, pressure=p)
             for t, p in zip(temps, pressures)])


@pytest.mark.parametrize("kind", ["displacement", "rotation"])
def test_metropolis_batch_matches_jax(kind):
    cl = jts.LennardJonesCluster(nx=2, ny=2, nz=2)
    rng = np.random.default_rng(8)
    x = np.asarray(cl.positions, np.float64)
    xs = [x + rng.normal(scale=0.01, size=x.shape) for _ in TEMPS]
    jstates, pstates = _jax_port_states(cl, [t / 2.5 for t in TEMPS])
    subset = [0, 1, 2, 5]
    if kind == "displacement":
        jmove = jmc.MCDisplacementMove(displacement_sigma=0.03,
                                       atom_subset=subset)
        tmove = tmc.MCDisplacementMove(displacement_sigma=0.03,
                                       atom_subset=subset)
    else:
        jmove = jmc.MCRotationMove(atom_subset=subset)
        tmove = tmc.MCRotationMove(atom_subset=subset)
    keys = jax.random.split(jax.random.PRNGKey(4), len(TEMPS))
    draws, log_u, want = [], [], []
    for js, xb, key in zip(jstates, xs, keys):
        k1, k2 = jax.random.split(key)
        if kind == "displacement":
            draws.append(0.03 * jax.random.normal(k1, (3,), jnp.float64))
        else:
            draws.append(jax.random.uniform(k1, (3,), jnp.float64))
        log_u.append(jnp.log(jax.random.uniform(k2)))
        want.append(jmove._metropolis_kernel(
            js, JaxSS(positions=jnp.asarray(xb)), key))
    out, accept = tmove.metropolis_batch(
        pstates, [SamplerState(positions=_t(xb)) for xb in xs],
        torch.stack([_t(d) for d in draws]), torch.stack([_t(u)
                                                          for u in log_u]))
    for ss, acc, (jss, jacc) in zip(out, accept, want):
        assert bool(acc) == bool(jacc)
        want_x = np.asarray(jss.positions)
        assert np.abs(ss.positions.numpy() - want_x).max() <= REL * np.abs(
            want_x).max()


@pytest.mark.parametrize("name", ["lj", "water"])
def test_barostat_attempt_batch_matches_jax_scan(name):
    if name == "lj":
        js = jts.LennardJonesFluid(nparticles=64, reduced_density=0.3)
        temps, pressures = [120.0, 130.0, 150.0], [50.0, 40.0, 60.0]
    else:
        js = jwater.WaterBox(box_edge=1.5, cutoff=0.6)
        temps, pressures = TEMPS, [1.0, 100.0, 1000.0]
    jstates, pstates = _jax_port_states(js, temps, pressures)
    rng = np.random.default_rng(9)
    x = np.asarray(js.positions, np.float64)
    box = np.asarray(js.system.default_box, np.float64)
    xs = [x + rng.normal(scale=1e-3, size=x.shape) for _ in temps]
    n_attempts, scale = 3, 0.05
    jmove = jmc.MonteCarloBarostatMove(volume_scale=scale,
                                       n_attempts=n_attempts)
    tmove = tmc.MonteCarloBarostatMove(volume_scale=scale,
                                       n_attempts=n_attempts)
    jids, jn = jmove._molecule_ids(jstates[0].system)
    pids, pn = tmove._molecule_ids(pstates[0].system)
    keys = jax.random.split(jax.random.PRNGKey(2), len(temps))
    want = [jmove._scan_attempts(
        s, JaxSS(positions=jnp.asarray(xb), box_vectors=jnp.asarray(box)),
        key, jids, jn) for s, xb, key in zip(jstates, xs, keys)]
    attempt_keys = [jax.random.split(key, n_attempts) for key in keys]
    sss = [SamplerState(positions=_t(xb), box_vectors=_t(box)) for xb in xs]
    n_acc = torch.zeros(len(temps), dtype=torch.int64)
    for a in range(n_attempts):
        eps, log_u = [], []
        for ks in attempt_keys:
            k1, k2 = jax.random.split(ks[a])
            eps.append(scale * (2.0 * jax.random.uniform(
                k1, dtype=jnp.float64) - 1.0))
            log_u.append(jnp.log(jax.random.uniform(k2, dtype=jnp.float64)))
        sss, accept = tmove.attempt_batch(
            pstates, sss, torch.stack([_t(e) for e in eps]),
            torch.stack([_t(u) for u in log_u]), pids, pn)
        n_acc += accept.to(torch.int64)
    for ss, acc, (jss, jacc) in zip(sss, n_acc.tolist(), want):
        assert acc == int(jacc)
        for got, ref in ((ss.positions, jss.positions),
                         (ss.box_vectors, jss.box_vectors)):
            ref = np.asarray(ref)
            assert np.abs(got.numpy() - ref).max() <= REL * np.abs(ref).max()
    assert 0 < int(n_acc.sum()) < n_attempts * len(temps) or name == "lj"


# -- the statistics layout, and sampling against the JAX sampler ---------------


def _ho_pair(temps):
    jho = JaxHO(K=100.0)
    jsys, psys = jax_f64(jho.system), port_system(jho.system)
    return ([JaxState(system=jsys, temperature=np.float64(t)) for t in temps],
            [ThermodynamicState(system=psys, temperature=t) for t in temps])


def test_move_statistics_layout_matches_jax():
    """Sequence(GHMC, Weighted(displacement, displacement), displacement):
    four rows in traversal order, the proposed counts of the fixed rows
    equal to the JAX sampler's and the weighted pair's summing to the
    same."""
    jst, pst = _ho_pair(TEMPS)

    def tree(mc):
        return mc.SequenceMove([
            mc.GHMCMove(timestep=0.01, n_steps=3),
            mc.WeightedMove([(mc.MCDisplacementMove(displacement_sigma=0.05),
                              1.0),
                             (mc.MCDisplacementMove(displacement_sigma=0.1),
                              1.0)]),
            mc.MCDisplacementMove(displacement_sigma=0.02)])

    x = np.random.default_rng(1).normal(scale=0.1, size=(3, 1, 3))
    js = jms.MultiStateSampler(mcmc_moves=tree(jmc), number_of_iterations=4,
                               online_analysis_interval=None)
    js.create(jst, [JaxSS(positions=jnp.asarray(p)) for p in x])
    js.run()
    ps = tms.MultiStateSampler(mcmc_moves=tree(tmc), number_of_iterations=4,
                               online_analysis_interval=None)
    ps.create(pst, [SamplerState(positions=torch.as_tensor(p)) for p in x])
    assert ps.propagation_route == "batched"
    ps.run()
    mine, theirs = ps.move_statistics, np.asarray(js.move_statistics)
    assert mine.shape == theirs.shape == (js._count_move_stats(), 2) == (4, 2)
    assert mine[0, 1] == theirs[0, 1] == 4 * 3 * 3
    assert mine[3, 1] == theirs[3, 1] == 4 * 3
    assert mine[1, 1] + mine[2, 1] == theirs[1, 1] + theirs[2, 1] == 4 * 3
    assert (mine[:, 0] <= mine[:, 1]).all() and mine[:, 0].sum() > 0


def _mean_u(history, states_hist, temps):
    """<U> per state and its standard error (the iterations' means of each
    state's replicas, corrected for their lag-1 correlation)."""
    out = []
    for k, t in enumerate(temps):
        beta = 1.0 / (kB * t)
        series = np.asarray([u[s == k, k].mean() / beta
                             for u, s in zip(history, states_hist)])
        x = series - series.mean()
        rho = float(np.dot(x[:-1], x[1:]) / max(np.dot(x, x), 1e-300))
        g = max(1.0, (1.0 + rho) / (1.0 - rho))
        out.append((series.mean(), series.std() * np.sqrt(g / len(series))))
    return out


def test_sequence_ladder_samples_as_the_jax_sampler():
    temps = [300.0, 600.0, 1200.0]
    jst, pst = _ho_pair(temps)
    n_rep, n_iter = 12, 80

    def tree(mc):
        return mc.SequenceMove([
            mc.MCDisplacementMove(displacement_sigma=0.2),
            mc.LangevinDynamicsMove(timestep=0.05, collision_rate=2.0,
                                    n_steps=20)])

    x = np.zeros((n_rep, 1, 3))
    init = [i % 3 for i in range(n_rep)]
    js = jms.MultiStateSampler(mcmc_moves=tree(jmc),
                               number_of_iterations=n_iter,
                               online_analysis_interval=None)
    js.create(jst, [JaxSS(positions=jnp.asarray(p)) for p in x],
              initial_thermodynamic_states=init)
    js.run()
    ps = tms.MultiStateSampler(mcmc_moves=tree(tmc),
                               number_of_iterations=n_iter,
                               online_analysis_interval=None, rng_seed=2)
    ps.create(pst, [SamplerState(positions=torch.as_tensor(p)) for p in x],
              initial_thermodynamic_states=init)
    assert ps.propagation_route == "batched"
    ps.run()
    skip = 5
    theirs = _mean_u(js._energy_history[skip:], js._state_history[skip:],
                     temps)
    mine = _mean_u(ps._energy_history[skip:], ps._state_history[skip:],
                   temps)
    for t, (m, sm), (j, sj) in zip(temps, mine, theirs):
        assert abs(m - j) <= 3.0 * np.hypot(sm, sj), (t, m, sm, j, sj)
        assert abs(m - 1.5 * kB * t) <= 4.0 * sm, (t, m, sm)


# -- F9: the replica's stream reaches every leaf --------------------------------


def _seq_sampler(seed, n_iterations=1, klass=tms.MultiStateSampler):
    ho = HarmonicOscillator(K=100.0, device="cpu")
    states = [ho.thermodynamic_state(t) for t in TEMPS[:2]]
    sampler = klass(
        mcmc_moves=tmc.SequenceMove([tmc.LangevinDynamicsMove(
            timestep=0.01, n_steps=5, reassign_velocities=True)]),
        number_of_iterations=n_iterations, online_analysis_interval=None,
        rng_seed=seed)
    return sampler, states, ho.sampler_state()


@pytest.mark.parametrize("klass", [tms.MultiStateSampler, _EagerSampler])
def test_f9_rng_seed_drives_a_sequence_move(klass):
    runs = []
    for seed in (1, 2, 1):
        sampler, states, ss = _seq_sampler(seed, klass=klass)
        sampler.create(states, ss)
        sampler.run()
        runs.append(torch.stack([s.positions for s in
                                 sampler.sampler_states]))
    assert not torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0], runs[2])


def test_f9_resume_continues_a_sequence_move_bitwise(tmp_path):
    pytest.importorskip("h5py")
    straight, states, ss = _seq_sampler(4, n_iterations=6,
                                        klass=tms.ReplicaExchangeSampler)
    straight.create(states, ss)
    straight.run()
    path = str(tmp_path / "seq.h5")
    first, states, ss = _seq_sampler(4, n_iterations=6,
                                     klass=tms.ReplicaExchangeSampler)
    first.create(states, ss,
                 storage=tms.MultiStateReporter(path, checkpoint_interval=1))
    first.run(3)
    first._reporter.close()
    resumed = tms.ReplicaExchangeSampler.from_storage(
        tms.MultiStateReporter(path, checkpoint_interval=1), device="cpu")
    assert isinstance(resumed.mcmc_moves, tmc.SequenceMove)
    resumed.run(3)
    _assert_same_states(resumed.sampler_states, straight.sampler_states)
    np.testing.assert_array_equal(resumed.energies_last_iteration,
                                  straight.energies_last_iteration)
    resumed._reporter.close()


def test_f9_weighted_move_draws_from_the_replica_stream():
    states, sss, cache = _ho(torch.float64)
    ts, ss = states[0], sss[0]
    a = tmc.MCDisplacementMove(displacement_sigma=0.05)
    b = tmc.MCDisplacementMove(displacement_sigma=0.5)
    move = tmc.WeightedMove([(a, 1.0), (b, 1.0)])
    picks = set()
    for seed in range(8):
        got = move.apply(ts, ss, generator=torch.Generator().manual_seed(
            seed), context_cache=cache)
        # the same draws by hand: the branch, then the branch's move, both
        # from the one generator
        gen = torch.Generator().manual_seed(seed)
        i = move._pick(gen)
        want = copy.deepcopy(move.move_set[i][0]).apply(
            ts, ss, generator=gen, context_cache=cache)
        assert torch.equal(got.positions, want.positions)
        picks.add(i)
    assert picks == {0, 1}
    assert a.n_proposed + b.n_proposed == 8
    assert not (move._generators or a._generators or b._generators)
    # without a generator each draws from its own, as before
    move.apply(ts, ss, context_cache=cache)
    assert move._generators and (a._generators or b._generators)
