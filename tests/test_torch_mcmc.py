"""The MCMC layer against the JAX package's, on the CPU.

* Each Metropolized core (displacement, rotation, barostat attempt) is fed
  the JAX package's own draws, computed here from the JAX key as the JAX
  move splits it: the same positions, box and accept at float64 (rel
  1e-10).
* The barostat's molecules (``_molecule_ids``) equal the JAX package's on
  a small water box and on the diatom.
* Where noise enters, statistics as ``tests/test_mcmc.py`` holds them:
  <U> = 3/2 kT on the oscillator (within 35 %), the NPT ideal gas's <V> =
  (N+1) kT / p (within 6 standard errors or 10 %), rotation preserving
  shape (rel 1e-12 at float64).
* The NaN restart and its error log, the serialization round trip, the
  statistics of the containers.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmmtools_tpu.mcmc as jmc
import openmmtools_tpu_torch.mcmc as tmc
from openmmtools_tpu.models import testsystems as jts
from openmmtools_tpu.models import water as jwater
from openmmtools_tpu.states import SamplerState as JaxSamplerState
from openmmtools_tpu.states import ThermodynamicState as JaxState
from openmmtools_tpu_torch.constants import BAR_TO_KJ_PER_MOL_NM3, kB
from openmmtools_tpu_torch.models import testsystems as tts
from openmmtools_tpu_torch.models import water as twater
from openmmtools_tpu_torch.states import SamplerState, ThermodynamicState

from test_torch_support import jax_f64, port_system

TEMP = 300.0
REL = 1e-10


def _close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= rel * scale


def _states(js, x, box=None, pressure=None):
    """The JAX and port (thermodynamic, sampler) states of a JAX test
    system at float64, the port's system converted from the JAX leaves."""
    jsys = jax_f64(js.system)
    psys = port_system(js.system)
    p = None if pressure is None else np.float64(pressure)
    jstate = JaxState(system=jsys, temperature=np.float64(TEMP), pressure=p)
    pstate = ThermodynamicState(system=psys, temperature=TEMP,
                                pressure=pressure)
    jb = None if box is None else jnp.asarray(box)
    pb = None if box is None else torch.as_tensor(box)
    return (jstate, JaxSamplerState(positions=jnp.asarray(x), box_vectors=jb),
            pstate, SamplerState(positions=torch.as_tensor(x),
                                 box_vectors=pb))


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("seed", range(4))
def test_displacement_core_matches_jax(seed):
    ho = jts.HarmonicOscillator()
    x = np.random.default_rng(seed).normal(scale=0.005, size=(1, 3))
    jstate, jss, pstate, pss = _states(ho, x)
    jmove = jmc.MCDisplacementMove(displacement_sigma=0.008)
    tmove = tmc.MCDisplacementMove(displacement_sigma=0.008)
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    disp = 0.008 * jax.random.normal(k1, (3,), dtype=jnp.float64)
    log_u = jnp.log(jax.random.uniform(k2))
    jss1, jacc = jmove._metropolis_kernel(jstate, jss, key)
    pss1, pacc = tmove.metropolis_step(pstate, pss, _t(disp), _t(log_u))
    assert bool(pacc) == bool(jacc)
    _close(pss1.positions, jss1.positions)


@pytest.mark.parametrize("seed", range(4))
def test_rotation_core_matches_jax(seed):
    cl = jts.LennardJonesCluster(nx=2, ny=2, nz=2)
    x = np.asarray(cl.positions, np.float64)
    jstate, jss, pstate, pss = _states(cl, x)
    subset = [0, 1, 2, 5]
    jmove = jmc.MCRotationMove(atom_subset=subset)
    tmove = tmc.MCRotationMove(atom_subset=subset)
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    u3 = jax.random.uniform(k1, (3,), dtype=jnp.float64)
    log_u = jnp.log(jax.random.uniform(k2))
    jss1, jacc = jmove._metropolis_kernel(jstate, jss, key)
    pss1, pacc = tmove.metropolis_step(pstate, pss, _t(u3), _t(log_u))
    assert bool(pacc) == bool(jacc)
    _close(pss1.positions, jss1.positions)


def _barostat_case(name):
    if name == "lj":
        js = jts.LennardJonesFluid(nparticles=64, reduced_density=0.3)
        return js, np.asarray(js.positions, np.float64), 50.0
    js = jwater.WaterBox(box_edge=1.5, cutoff=0.6)
    return js, np.asarray(js.positions, np.float64), 1.0


@pytest.mark.parametrize("name", ["lj", "water"])
@pytest.mark.parametrize("seed", [0, 1])
def test_barostat_attempts_match_jax(name, seed):
    """``n_attempts`` = 3 volume attempts: the JAX scan against the port's
    core, attempt by attempt on the JAX draws."""
    js, x, pressure = _barostat_case(name)
    box = np.asarray(js.system.default_box, np.float64)
    jstate, jss, pstate, pss = _states(js, x, box, pressure)
    jmove = jmc.MonteCarloBarostatMove(volume_scale=0.05, n_attempts=3)
    tmove = tmc.MonteCarloBarostatMove(volume_scale=0.05, n_attempts=3)
    jids, jn = jmove._molecule_ids(jstate.system)
    pids, pn = tmove._molecule_ids(pstate.system)
    key = jax.random.PRNGKey(seed)
    jss1, jacc = jmove._scan_attempts(jstate, jss, key, jids, jn)
    n_acc = 0
    for k in jax.random.split(key, 3):
        k1, k2 = jax.random.split(k)
        eps = 0.05 * (2.0 * jax.random.uniform(k1, dtype=jnp.float64) - 1.0)
        log_u = jnp.log(jax.random.uniform(k2, dtype=jnp.float64))
        pss, acc = tmove.attempt(pstate, pss, _t(eps), _t(log_u), pids, pn)
        n_acc += int(acc)
    assert n_acc == int(jacc)
    _close(pss.positions, jss1.positions)
    _close(pss.box_vectors, jss1.box_vectors)


def test_barostat_attempts_keep_float32_waters_rigid(monkeypatch):
    """Twenty accepted attempts in a row on a float32 water box: each trial
    is projected onto the constraints, so the rigid geometry stays within
    one rounding of exact (sqrt(3) ulp of the largest coordinate over the
    shortest constraint) and does not build up over the attempts; without
    the projection this run exceeds that bound. The energies play no part
    (ln u = -inf accepts), so they are stubbed."""
    monkeypatch.setattr(tmc, "potential_energies",
                        lambda ts, states, cache=None: [
                            torch.zeros((), dtype=torch.float64)] * 2)
    w = twater.WaterBox(box_edge=2.5, device="cpu")
    system = w.system
    ts = w.thermodynamic_state(TEMP, pressure=1.0)
    s = w.sampler_state()
    assert s.positions.dtype == torch.float32
    c = system.constraints
    i, j = c.index[:, 0].long(), c.index[:, 1].long()
    move = tmc.MonteCarloBarostatMove()
    ids, n = move._molecule_ids(system)
    rng = np.random.default_rng(0)
    top = float(s.positions.abs().max())
    for _ in range(20):
        eps = torch.tensor(0.01 * (2.0 * rng.random() - 1.0),
                           dtype=torch.float32)
        s, accept = move.attempt(ts, s, eps, torch.tensor(-math.inf), ids, n)
        assert bool(accept)
        top = max(top, float(s.positions.abs().max()))
    L = torch.diagonal(s.box_vectors)
    d = s.positions[i] - s.positions[j]
    d = d - L * torch.round(d / L)
    error = float(((torch.linalg.norm(d, dim=1).double() - c.distance.double())
                   / c.distance.double()).abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 23)
    bound = math.sqrt(3.0) * ulp / float(c.distance.min())
    assert error <= bound, (error, bound)


@pytest.mark.parametrize("name", ["water", "diatom", "lj"])
def test_molecule_ids_match_jax(name):
    js = {"water": lambda: jwater.WaterBox(box_edge=1.5, cutoff=0.6),
          "diatom": lambda: jts.Diatom(constraint=True),
          "lj": lambda: jts.LennardJonesFluid(nparticles=27)}[name]()
    jids, jn = jmc.MonteCarloBarostatMove._molecule_ids(js.system)
    pids, pn = tmc.MonteCarloBarostatMove._molecule_ids(
        port_system(js.system))
    assert pn == jn
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))


def test_molecule_ids_of_the_port_water_box():
    """The port's own water box: one molecule per water."""
    w = twater.WaterBox(box_edge=1.5, cutoff=0.6, device="cpu")
    ids, n = tmc.MonteCarloBarostatMove._molecule_ids(w.system)
    assert n * 3 == w.system.n_particles
    assert torch.equal(ids, torch.arange(n).repeat_interleave(3))


# ---------------------------------------------------------------------------
# statistics, as tests/test_mcmc.py holds the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ho():
    return tts.HarmonicOscillator(device="cpu")


@pytest.mark.parametrize("factory", [
    lambda: tmc.LangevinDynamicsMove(timestep=0.002, collision_rate=20.0,
                                     n_steps=100),
    lambda: tmc.LangevinSplittingDynamicsMove(
        splitting="O V R V O", timestep=0.002, collision_rate=20.0,
        n_steps=100),
    lambda: tmc.GHMCMove(timestep=0.004, n_steps=100),
    lambda: tmc.HMCMove(timestep=0.004, n_inner_steps=5, n_steps=10),
], ids=["langevin", "splitting", "ghmc", "hmc"])
def test_moves_sample_the_oscillator(ho, factory):
    move = factory()
    state = ho.thermodynamic_state(TEMP)
    ss = SamplerState(positions=ho.positions)
    us = []
    for _ in range(30):
        ss = move.apply(state, ss)
        us.append(float(state.potential_energy(ss)))
    expected = 1.5 * kB * TEMP
    assert abs(np.mean(us[5:]) - expected) < 0.35 * expected


def test_ghmc_move_statistics(ho):
    move = tmc.GHMCMove(timestep=0.004, n_steps=50)
    state = ho.thermodynamic_state(TEMP)
    ss = SamplerState(positions=ho.positions)
    for _ in range(3):
        ss = move.apply(state, ss)
    assert move.n_proposed == 150 and 0 < move.n_accepted <= 150
    stats = move.statistics
    move.statistics = {"n_accepted": 0, "n_proposed": 0}
    assert move.n_proposed == 0 and math.isnan(move.fraction_accepted)
    move.statistics = stats
    assert move.n_proposed == 150


def test_barostat_samples_the_ideal_gas_volume():
    n = 32
    gas = tts.IdealGas(nparticles=n, device="cpu")
    state = gas.thermodynamic_state(gas.temperature0, pressure=gas.pressure0)
    move = tmc.MonteCarloBarostatMove(volume_scale=0.15, seed=3)
    ss = gas.sampler_state()
    vols = []
    for i in range(400):
        ss = move.apply(state, ss)
        if i >= 100:
            vols.append(float(ss.volume))
    expected = gas.get_volume_expectation(state)
    assert expected == pytest.approx((n + 1) * kB * gas.temperature0 / (
        gas.pressure0 * BAR_TO_KJ_PER_MOL_NM3))
    stderr = np.std(vols) / math.sqrt(len(vols) / 20)
    assert abs(np.mean(vols) - expected) < max(6 * stderr, 0.1 * expected)
    assert 0.2 < move.n_accepted / move.n_proposed <= 1.0
    assert move.n_proposed == 400


def test_barostat_counts_every_attempt_and_keeps_molecules_rigid():
    w = twater.WaterBox(box_edge=1.5, cutoff=0.6, device="cpu")
    state = w.thermodynamic_state(TEMP, pressure=1.0)
    move = tmc.MonteCarloBarostatMove(volume_scale=0.02, n_attempts=4,
                                      seed=1)
    ss = w.sampler_state()
    for _ in range(3):
        ss = move.apply(state, ss)
    assert move.n_proposed == 12 and move.n_accepted >= 1
    c = w.system.constraints
    i, j = c.index[:, 0].long(), c.index[:, 1].long()
    d = torch.linalg.norm(ss.positions[i] - ss.positions[j], dim=1)
    torch.testing.assert_close(d, c.distance, rtol=1e-5, atol=0)
    assert float(ss.volume) != pytest.approx(1.5**3, rel=1e-9)


def test_barostat_requires_npt():
    gas = tts.IdealGas(nparticles=8, device="cpu")
    with pytest.raises(tmc.MCMCMoveError, match="NPT"):
        tmc.MonteCarloBarostatMove().apply(gas.thermodynamic_state(TEMP),
                                           gas.sampler_state())


def test_displacement_move_on_a_free_particle():
    gas = tts.IdealGas(nparticles=8, device="cpu")
    move = tmc.MCDisplacementMove(displacement_sigma=0.5, atom_subset=[0])
    state = gas.thermodynamic_state(TEMP)
    ss = gas.sampler_state()
    x0 = ss.positions.clone()
    for _ in range(5):
        ss = move.apply(state, ss)
    assert move.n_accepted == 5
    assert not torch.allclose(ss.positions[0], x0[0])
    assert torch.equal(ss.positions[1:], x0[1:])


def test_rotation_preserves_shape():
    d = tts.Diatom(device="cpu")
    system = d.system.to(dtype=torch.float64)
    state = ThermodynamicState(system=system, temperature=TEMP)
    ss = SamplerState(positions=d.positions.to(torch.float64))
    move = tmc.MCRotationMove()
    r0 = float(torch.linalg.norm(ss.positions[0] - ss.positions[1]))
    for _ in range(8):
        ss = move.apply(state, ss)
    r1 = float(torch.linalg.norm(ss.positions[0] - ss.positions[1]))
    assert r1 == pytest.approx(r0, rel=1e-12)
    assert move.n_accepted >= 1


def test_nan_restart_writes_the_error_log(ho, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    move = tmc.LangevinDynamicsMove(timestep=1000.0, n_steps=60,
                                    n_restart_attempts=1)
    state = ho.thermodynamic_state(TEMP)
    ss = SamplerState(positions=torch.tensor([[100.0, 0.0, 0.0]]))
    with pytest.raises(tmc.IntegratorMoveError) as err:
        move.apply(state, ss)
    assert err.value.sampler_state is ss
    saved = np.load(tmp_path / "nan-error-logs"
                    / "LangevinDynamicsMove-state.npz")
    np.testing.assert_array_equal(saved["positions"], ss.positions.numpy())
    assert "LangevinDynamicsMove" in (
        tmp_path / "nan-error-logs" / "LangevinDynamicsMove-move.txt"
    ).read_text()


def test_last_restart_draws_fresh_velocities(ho, monkeypatch):
    """The first attempt keeps the given velocities, the last draws
    fresh ones."""
    move = tmc.LangevinDynamicsMove(timestep=0.002, n_steps=5,
                                    n_restart_attempts=2)
    state = ho.thermodynamic_state(TEMP)
    bound = move._bound(state)
    seen = []
    real_run = bound.run

    def run(s, n):
        seen.append(s.velocities.clone())
        out = real_run(s, n)
        if len(seen) < 3:   # NaN on every attempt but the last
            out = out.replace(positions=out.positions * float("nan"))
        return out

    monkeypatch.setattr(bound, "run", run)
    v = torch.full((1, 3), 0.25)
    move.apply(state, SamplerState(positions=ho.positions, velocities=v))
    assert len(seen) == 3
    assert torch.equal(seen[0], v) and torch.equal(seen[1], v)
    assert not torch.equal(seen[2], v)


def test_moves_round_trip_through_serialization(ho):
    """Parameters, statistics, nested containers and the generators'
    states survive; the copy goes on drawing what the original draws."""
    from openmmtools_tpu_torch.utils.serialization import (
        deserialize,
        serialize,
    )

    disp = tmc.MCDisplacementMove(displacement_sigma=0.2)
    move = tmc.SequenceMove([
        tmc.LangevinDynamicsMove(timestep=0.004, collision_rate=3.0,
                                 n_steps=10),
        tmc.WeightedMove([(tmc.GHMCMove(timestep=0.002, n_steps=5), 0.25),
                          (disp, 0.75)]),
    ])
    state = ho.thermodynamic_state(TEMP)
    ss = SamplerState(positions=ho.positions)
    ss = move.apply(state, ss)
    back = deserialize(serialize(move))
    assert isinstance(back, tmc.SequenceMove)
    assert back.move_list[0].n_steps == 10
    assert back.move_list[0].timestep == 0.004
    inner = back.move_list[1]
    assert isinstance(inner, tmc.WeightedMove)
    assert [w for _, w in inner.move_set] == [0.25, 0.75]
    assert inner.move_set[1][0].displacement_sigma == 0.2
    assert back.statistics == move.statistics
    a = move.apply(state, ss)
    b = back.apply(state, ss)
    assert torch.equal(a.positions, b.positions)
    # a bound integrator is a cache: an applied IntegratorMove leaves it out
    from openmmtools_tpu_torch.integrators import VVVRIntegrator

    im = tmc.IntegratorMove(VVVRIntegrator(timestep=0.002), n_steps=3)
    im.apply(state, ss)
    assert im.integrator._bound
    im2 = deserialize(serialize(im))
    assert im2.integrator._bound == {} and im2.integrator.timestep == 0.002
    assert torch.equal(im.apply(state, ss).positions,
                       im2.apply(state, ss).positions)


def test_serialization_encodes_like_jax():
    """Plain values, numpy arrays (a zero-size one too) and containers
    encode to the JAX package's own form; tensors encode as arrays tagged
    "tensor" and come back as tensors."""
    from openmmtools_tpu.utils import serialization as jser
    from openmmtools_tpu_torch.utils import serialization as tser

    value = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
             "b": [1, 2.5, "x", None, (True, np.zeros((0, 3)))]}
    assert tser._encode(value) == jser._encode(value)
    back = tser._decode(tser._encode(value))
    np.testing.assert_array_equal(back["a"], value["a"])
    assert back["b"][4][1].shape == (0, 3)
    t = torch.arange(4, dtype=torch.float64).reshape(2, 2)
    enc = tser._encode(t)
    assert enc["_type"] == "tensor" and enc["dtype"] == "float64"
    assert torch.equal(tser._decode(enc), t)


def test_sequence_move_keeps_each_moves_statistics_in_order(ho):
    g1 = tmc.GHMCMove(timestep=0.004, n_steps=10)
    g2 = tmc.GHMCMove(timestep=0.004, n_steps=20)
    seq = tmc.SequenceMove([g1, g2])
    state = ho.thermodynamic_state(TEMP)
    ss = SamplerState(positions=ho.positions)
    for _ in range(3):
        ss = seq.apply(state, ss)
    assert g1.n_proposed == 30 and g2.n_proposed == 60
    assert seq.statistics == [g1.statistics, g2.statistics]
    seq.statistics = [{"n_accepted": 1, "n_proposed": 2},
                      {"n_accepted": 3, "n_proposed": 4}]
    assert (g1.n_proposed, g2.n_proposed) == (2, 4)


def test_weighted_move_draws_by_weight(ho):
    never = tmc.GHMCMove(timestep=0.004, n_steps=10)
    always = tmc.GHMCMove(timestep=0.004, n_steps=10)
    wm = tmc.WeightedMove([(never, 0.0), (always, 1.0)])
    state = ho.thermodynamic_state(TEMP)
    ss = SamplerState(positions=ho.positions)
    for _ in range(4):
        ss = wm.apply(state, ss)
    assert never.n_proposed == 0 and always.n_proposed == 40
    assert wm.statistics == [never.statistics, always.statistics]


def test_integrator_move_follows_the_state_temperature(ho):
    from openmmtools_tpu_torch.integrators import VVVRIntegrator

    move = tmc.IntegratorMove(VVVRIntegrator(temperature=10.0), n_steps=5)
    ss = move.apply(ho.thermodynamic_state(TEMP),
                    SamplerState(positions=ho.positions))
    assert move.integrator.temperature == TEMP
    assert not bool(ss.has_nan())


def test_mcmc_sampler_minimizes_and_runs(ho):
    sampler = tmc.MCMCSampler(
        ho.thermodynamic_state(TEMP),
        SamplerState(positions=torch.tensor([[0.5, 0.0, 0.0]])),
        move=tmc.LangevinDynamicsMove(n_steps=20, timestep=0.002))
    sampler.minimize(max_iterations=100)
    u_min = float(sampler.thermodynamic_state.potential_energy(
        sampler.sampler_state))
    assert u_min < 1.0
    sampler.run(3)
    assert not bool(sampler.sampler_state.has_nan())
