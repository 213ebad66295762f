"""The port's replica-exchange and parallel-tempering samplers against the
JAX package's, on the CPU.

* The mixing cores fed the JAX package's own draws (computed here from the
  JAX key as its kernels split it): the same states and the same
  (accepted, proposed) matrices, exactly, for swap-all and swap-neighbors,
  with as many replicas as states, more replicas than states, a state
  held by no replica, and unsampled columns in u.
* Where noise enters: replica exchange on the harmonic K ladder gives MBAR
  free energies within 6 sigma of the analytic ones (the port of
  ``tests/test_multistate.py:84``); parallel tempering on the min/max
  ladder (``:1388``).
* Determinism: iterations_per_sync > 1 equals 1 bitwise (``:800``); a run
  of 2k iterations equals k, a resume from storage and k more, bitwise
  (``:1261``).
* Options and edges: the validators (``:953``), per-state moves and their
  statistics in the JAX package's (S, 2) layout, FIRE minimization against
  the JAX package's, equilibrate, extend, the online stop criterion, and a
  NaN energy raising SimulationNaNError.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmmtools_tpu.mcmc as jmc
import openmmtools_tpu.multistate as jms
from openmmtools_tpu.models import HarmonicOscillator as JaxHO
from openmmtools_tpu.multistate.replicaexchange import _mix_all as jax_mix_all
from openmmtools_tpu.multistate.replicaexchange import (
    _mix_neighbors as jax_mix_neighbors,
)
from openmmtools_tpu.states import SamplerState as JaxSS
from openmmtools_tpu.states import ThermodynamicState as JaxState
from openmmtools_tpu.states import create_thermodynamic_state_protocol as jproto
import openmmtools_tpu_torch.multistate as tms
from openmmtools_tpu_torch.constants import kB
from openmmtools_tpu_torch.mcmc import (
    GHMCMove,
    LangevinDynamicsMove,
    MCDisplacementMove,
    SequenceMove,
)
from openmmtools_tpu_torch.models import HarmonicOscillator
from openmmtools_tpu_torch.multistate.replicaexchange import (
    mix_all,
    mix_neighbors,
)
from openmmtools_tpu_torch.states import (
    SamplerState,
    ThermodynamicState,
    create_thermodynamic_state_protocol,
)

from test_torch_support import jax_f64, port_system

TEMP = 300.0
KT = kB * TEMP
K_LADDER = [100.0, 200.0, 400.0, 800.0]
K_NAME = "testsystems_HarmonicOscillator_K"


def _analytic_f(K):
    return -1.5 * math.log(2.0 * math.pi * KT / K)


def _states():
    ho = HarmonicOscillator(K=K_LADDER[0], device="cpu")
    return ho, create_thermodynamic_state_protocol(
        ho.thermodynamic_state(TEMP), {K_NAME: K_LADDER})


def _move(n_steps=20):
    return LangevinDynamicsMove(timestep=0.01, collision_rate=5.0,
                                n_steps=n_steps)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


# -- mixing cores on the JAX draws -----------------------------------------

MIX_CASES = [
    # (replica states, number of sampled states, extra unsampled columns)
    ([0, 1, 2, 3, 4], 5, 0),
    ([0, 1, 2, 3, 0, 2], 4, 0),      # more replicas than states
    ([0, 2, 3], 5, 0),               # states 1 and 4 held by no replica
    ([3, 1, 0, 2], 4, 2),            # unsampled columns in u
]


def _mix_inputs(states, k_s, extra, seed):
    rng = np.random.default_rng(seed)
    n = len(states)
    u = rng.normal(scale=1.5, size=(n, k_s + extra))
    acc = rng.integers(0, 5, (k_s, k_s))
    prop = acc + rng.integers(0, 5, (k_s, k_s))
    return np.asarray(states, np.int32), u, acc, prop


@pytest.mark.parametrize("case", range(len(MIX_CASES)))
@pytest.mark.parametrize("seed", range(2))
def test_mix_all_on_jax_draws(case, seed):
    states, u, acc, prop = _mix_inputs(*MIX_CASES[case], seed)
    n = states.shape[0]
    key = jax.random.PRNGKey(100 + seed)
    j_states, j_acc, j_prop = jax_mix_all(
        key, jnp.asarray(states), jnp.asarray(u), jnp.asarray(acc, jnp.int32),
        jnp.asarray(prop, jnp.int32))
    n_sweeps = 2 * n * n
    kp, ka = jax.random.split(key)
    perms = jax.random.permutation(
        kp, jnp.broadcast_to(jnp.arange(n), (n_sweeps, n)), axis=1,
        independent=True)
    log_us = jnp.log(jax.random.uniform(ka, (n_sweeps, n // 2),
                                        dtype=jnp.float64))
    t_states, t_acc, t_prop = mix_all(
        _t(states, torch.int64), _t(u), _t(acc, torch.int64),
        _t(prop, torch.int64), _t(perms, torch.int64), _t(log_us))
    np.testing.assert_array_equal(t_states.numpy(), np.asarray(j_states))
    np.testing.assert_array_equal(t_acc.numpy(), np.asarray(j_acc))
    np.testing.assert_array_equal(t_prop.numpy(), np.asarray(j_prop))
    assert (t_prop.numpy() > prop).any()


@pytest.mark.parametrize("case", range(len(MIX_CASES)))
@pytest.mark.parametrize("seed", range(4))
def test_mix_neighbors_on_jax_draws(case, seed):
    states, u, acc, prop = _mix_inputs(*MIX_CASES[case], seed)
    k_s = prop.shape[0]
    key = jax.random.PRNGKey(200 + seed)
    j_states, j_acc, j_prop = jax_mix_neighbors(
        key, jnp.asarray(states), jnp.asarray(u), jnp.asarray(acc, jnp.int32),
        jnp.asarray(prop, jnp.int32))
    key_par, key_acc = jax.random.split(key)
    parity = jax.random.randint(key_par, (), 0, 2)
    log_r = jnp.log(jax.random.uniform(key_acc, (max(k_s // 2, 1),),
                                       dtype=jnp.float64))
    t_states, t_acc, t_prop = mix_neighbors(
        _t(states, torch.int64), _t(u), _t(acc, torch.int64),
        _t(prop, torch.int64), _t(parity, torch.int64), _t(log_r))
    np.testing.assert_array_equal(t_states.numpy(), np.asarray(j_states))
    np.testing.assert_array_equal(t_acc.numpy(), np.asarray(j_acc))
    np.testing.assert_array_equal(t_prop.numpy(), np.asarray(j_prop))


def test_swap_all_chi2_uniform():
    """With zero energies the swap-all walk over (replica, state)
    assignments is uniform (``tests/test_multistate.py:587``)."""
    from scipy.stats import chi2

    from openmmtools_tpu_torch.multistate.replicaexchange import draw_mix_all

    n = 5
    u = torch.zeros((n, n), dtype=torch.float64)
    states = torch.arange(n)
    acc = torch.zeros((n, n), dtype=torch.int64)
    counts = np.zeros((n, n))
    gen = torch.Generator().manual_seed(0)
    for _ in range(400):
        states, acc, _ = mix_all(states, u, acc, acc,
                                 *draw_mix_all(gen, n, u.dtype))
        counts[np.arange(n), states.numpy()] += 1
    expected = 400 / n
    stat = float(((counts - expected) ** 2 / expected).sum())
    assert stat < chi2.ppf(0.999, n * (n - 1)), (stat, counts)


# -- statistics --------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["swap-all", "swap-neighbors"])
def test_replica_exchange_harmonic_ladder(scheme):
    """REMD over the K ladder: MBAR Delta f within 6 sigma (floor 0.15) of
    the analytic values."""
    ho, states = _states()
    sampler = tms.ReplicaExchangeSampler(
        mcmc_moves=_move(), number_of_iterations=300,
        replica_mixing_scheme=scheme, online_analysis_interval=None,
        rng_seed=42)
    sampler.create(states, ho.sampler_state())
    sampler.run()
    assert sampler.iteration == 300
    assert int(sampler._n_accepted.sum()) > 0
    u = np.stack(sampler._energy_history)[1:]       # (T, N, K)
    s = np.stack(sampler._state_history)[1:]
    result = tms.mbar_free_energies(u.reshape(-1, 4).T,
                                    np.bincount(s.reshape(-1), minlength=4))
    for k in range(1, 4):
        df, ddf = result.delta_f(0, k)
        analytic = _analytic_f(K_LADDER[k]) - _analytic_f(K_LADDER[0])
        assert abs(float(df) - analytic) < max(6 * float(ddf), 0.15), (
            k, float(df), analytic, float(ddf))


def test_parallel_tempering_min_max_ladder():
    """n states spanning [min, max] with the JAX package's spacing, and
    u[n, k] = beta_k U_n after a run."""
    ho = HarmonicOscillator(K=K_LADDER[0], device="cpu")
    jho = JaxHO(K=K_LADDER[0])
    kw = dict(min_temperature=300.0, max_temperature=400.0, n_temperatures=5)
    sampler = tms.ParallelTemperingSampler(
        mcmc_moves=_move(5), number_of_iterations=4,
        online_analysis_interval=None, rng_seed=11)
    sampler.create(ho.thermodynamic_state(300.0), ho.sampler_state(), **kw)
    js = jms.ParallelTemperingSampler(
        mcmc_moves=jmc.LangevinDynamicsMove(n_steps=1),
        number_of_iterations=1, online_analysis_interval=None)
    js.create(JaxState(system=jax_f64(jho.system),
                       temperature=np.float64(300.0)),
              JaxSS(positions=jnp.zeros((1, 3))), **kw)
    temps = [float(s.temperature) for s in sampler._thermodynamic_states]
    np.testing.assert_allclose(
        temps, [float(s.temperature) for s in js._thermodynamic_states],
        rtol=1e-12)
    assert np.isclose(min(temps), 300.0) and np.isclose(max(temps), 400.0)
    assert all(t2 > t1 for t1, t2 in zip(temps, temps[1:]))
    sampler.run()
    u = sampler.energies_last_iteration
    assert np.all(np.isfinite(u))
    betas = sampler._stacked_sampled.beta.numpy()
    np.testing.assert_allclose(u, betas[None, :] * (u[:, :1] / betas[0]),
                               rtol=1e-5)
    with pytest.raises(ValueError):
        sampler.create(ho.thermodynamic_state(300.0), ho.sampler_state())


# -- determinism -------------------------------------------------------------


def _re(n_iterations, ips=1, seed=7):
    return tms.ReplicaExchangeSampler(
        mcmc_moves=_move(5), number_of_iterations=n_iterations,
        online_analysis_interval=None, rng_seed=seed,
        iterations_per_sync=ips)


def test_batched_iterations_match_single(tmp_path):
    pytest.importorskip("h5py")
    ho, states = _states()
    out = []
    for ips in (1, 4):
        sampler = _re(8, ips)
        sampler.create(states, ho.sampler_state(),
                       storage=str(tmp_path / f"b{ips}.h5"))
        sampler.run()
        assert sampler.iteration == 8
        out.append((np.stack(sampler._energy_history),
                    np.stack(sampler._state_history),
                    sampler._sampler_states[0].positions.clone()))
        sampler._reporter.close()
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
    assert torch.equal(out[0][2], out[1][2])


def test_resume_continues_bitwise(tmp_path):
    """2k straight iterations equal k, a resume from storage and k more,
    bitwise (float32 replicas: the checkpoint stores float32)."""
    pytest.importorskip("h5py")
    ho, states = _states()
    straight = _re(6)
    straight.create(states, ho.sampler_state())
    straight.run()

    path = str(tmp_path / "split.h5")
    first = _re(6)
    first.create(states, ho.sampler_state(),
                 storage=tms.MultiStateReporter(path, checkpoint_interval=1))
    first.run(3)
    first._reporter.close()
    resumed = tms.ReplicaExchangeSampler.from_storage(
        tms.MultiStateReporter(path, checkpoint_interval=1), device="cpu")
    assert resumed.iteration == 3 and resumed._rng_iteration == 3
    assert len(resumed._energy_history) == 4
    resumed.run(3)
    np.testing.assert_array_equal(resumed.energies_last_iteration,
                                  straight.energies_last_iteration)
    np.testing.assert_array_equal(resumed.replica_states,
                                  straight.replica_states)
    for a, b in zip(resumed.sampler_states, straight.sampler_states):
        assert torch.equal(a.positions, b.positions)
        assert torch.equal(a.velocities, b.velocities)
    np.testing.assert_array_equal(resumed._n_accepted.numpy(),
                                  straight._n_accepted.numpy())
    resumed._reporter.close()


# -- options and edges ------------------------------------------------------


def test_stored_property_validators():
    s = tms.ReplicaExchangeSampler(number_of_iterations=5,
                                   online_analysis_interval=None)
    for name, bad in (("number_of_iterations", -1),
                      ("online_analysis_interval", 0), ("locality", 0),
                      ("iterations_per_sync", 0)):
        with pytest.raises(ValueError):
            setattr(s, name, bad)
    s.online_analysis_interval = 50
    s.locality = 2
    s.number_of_iterations = float("inf")
    opts = s._stored_options()
    assert opts["online_analysis_interval"] == 50
    assert opts["locality"] == 2
    assert opts["iterations_per_sync"] == 1
    assert "rng_seed" in opts
    with pytest.raises(ValueError):
        tms.ReplicaExchangeSampler(replica_mixing_scheme="swap-some")


def test_per_state_moves_and_statistics():
    """A list of moves, one a state, each applied at its state; the
    statistics rows in the JAX package's layout (the longest per-state
    program's statistics-carrying moves, padded and summed)."""
    ho, states = _states()
    ghmc = GHMCMove(timestep=0.005, collision_rate=5.0, n_steps=10)
    seq = SequenceMove([GHMCMove(timestep=0.005, n_steps=5),
                        MCDisplacementMove(displacement_sigma=0.01)])
    moves = [_move(10), ghmc, seq, _move(15)]
    sampler = tms.ReplicaExchangeSampler(
        mcmc_moves=moves, number_of_iterations=20,
        online_analysis_interval=None, rng_seed=3)
    sampler.create(states, ho.sampler_state())
    sampler.run()
    stats = sampler.move_statistics
    jmoves = [jmc.LangevinDynamicsMove(n_steps=1),
              jmc.GHMCMove(n_steps=1),
              jmc.SequenceMove([jmc.GHMCMove(n_steps=1),
                                jmc.MCDisplacementMove()]),
              jmc.LangevinDynamicsMove(n_steps=1)]
    js = jms.ReplicaExchangeSampler(mcmc_moves=jmoves,
                                    online_analysis_interval=None)
    js._thermodynamic_states = [None] * 4
    assert stats.shape == (js._count_move_stats(), 2) == (2, 2)
    inner = seq.move_list
    np.testing.assert_array_equal(stats, [
        [ghmc.n_accepted + inner[0].n_accepted,
         ghmc.n_proposed + inner[0].n_proposed],
        [inner[1].n_accepted, inner[1].n_proposed]])
    assert stats[1, 1] > 0 and stats[0, 1] > 0
    # 20 iterations, one replica at each state: states 1 and 2 apply their
    # moves 20 times each
    assert ghmc.n_proposed == 20 * 10 and inner[0].n_proposed == 20 * 5
    assert stats[1, 1] == 20
    bad = tms.ReplicaExchangeSampler(mcmc_moves=moves[:2], rng_seed=3)
    with pytest.raises(ValueError):
        bad.create(states, ho.sampler_state())


def test_minimize_matches_jax():
    """Per-replica FIRE at each replica's state against the JAX sampler's
    minimize, at float64."""
    jho = JaxHO(K=K_LADDER[0])
    jsys, psys = jax_f64(jho.system), port_system(jho.system)
    jst = jproto(JaxState(system=jsys, temperature=np.float64(TEMP)),
                 {K_NAME: K_LADDER})
    pst = create_thermodynamic_state_protocol(
        ThermodynamicState(system=psys, temperature=TEMP), {K_NAME: K_LADDER})
    x = np.random.default_rng(0).normal(scale=0.1, size=(4, 1, 3))
    js = jms.ReplicaExchangeSampler(
        mcmc_moves=jmc.LangevinDynamicsMove(n_steps=1),
        online_analysis_interval=None)
    ps = tms.ReplicaExchangeSampler(mcmc_moves=_move(1),
                                    online_analysis_interval=None)
    js.create(jst, [JaxSS(positions=jnp.asarray(p)) for p in x])
    ps.create(pst, [SamplerState(positions=torch.as_tensor(p)) for p in x])
    js.minimize(max_iterations=40)
    ps.minimize(max_iterations=40)
    got = np.stack([s.positions.numpy() for s in ps.sampler_states])
    want = np.asarray(js._carry.positions)
    assert np.abs(got - want).max() <= 1e-10 * np.abs(x).max()
    assert np.all(np.sum(got ** 2, axis=(1, 2)) < np.sum(x ** 2, axis=(1, 2)))
    np.testing.assert_allclose(ps.energies_last_iteration,
                               js.energies_last_iteration, rtol=1e-8,
                               atol=1e-12)


def test_equilibrate_and_extend():
    ho, states = _states()
    sampler = _re(5, seed=3)
    with pytest.raises(RuntimeError):
        sampler.equilibrate(1)
    sampler.create(states, ho.sampler_state())
    x0 = sampler._sampler_states[0].positions.clone()
    production = sampler.mcmc_moves
    sampler.equilibrate(3, mcmc_moves=_move(5))
    assert sampler.iteration == 0 and sampler._rng_iteration == 3
    assert not torch.equal(sampler._sampler_states[0].positions, x0)
    assert sampler.mcmc_moves is production
    with pytest.raises(RuntimeError):
        sampler.equilibrate(1, mcmc_moves=[_move(5), _move(5)])
    sampler.run()
    assert sampler.iteration == 5
    sampler.run(10)             # clamped at number_of_iterations
    assert sampler.iteration == 5
    sampler.extend(4)
    assert sampler.iteration == 9 and sampler.number_of_iterations == 9
    assert len(sampler._energy_history) == 10
    assert sampler.is_completed


def test_online_analysis_stops_the_run():
    ho, states = _states()
    sampler = tms.ReplicaExchangeSampler(
        mcmc_moves=_move(), number_of_iterations=100,
        online_analysis_interval=10, online_analysis_minimum_iterations=10,
        online_analysis_target_error=50.0, rng_seed=6)
    sampler.create(states, ho.sampler_state())
    sampler.run()
    assert sampler.iteration == 10
    assert sampler._last_err_free_energy is not None
    assert sampler._online_data["f_k"].shape == (4,)


def test_nan_energy_raises():
    ho, states = _states()
    sampler = tms.ReplicaExchangeSampler(
        mcmc_moves=_move(2), number_of_iterations=3,
        replica_mixing_scheme=None, online_analysis_interval=None)
    sampler.create(states, ho.sampler_state())
    # state 1's column of the energy matrix becomes NaN
    sampler._stacked_states.global_params[K_NAME][1] = float("nan")
    sampler._device_params = {}
    with pytest.raises(tms.SimulationNaNError, match=r"replicas \[1\]"):
        sampler.run(1)
    nan_state = states[1].replace(global_params={K_NAME: float("nan")})
    with pytest.raises(tms.SimulationNaNError):
        tms.MultiStateSampler(mcmc_moves=_move(2)).create(
            [states[0], nan_state], ho.sampler_state())
