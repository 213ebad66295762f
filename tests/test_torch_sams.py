"""The port's SAMS sampler against the JAX package's, on the CPU.

* The jump core fed the JAX package's draws: ``jax.random.categorical`` is
  the argmax of the logits plus Gumbel noise from the same key; the port's
  core takes that noise and gives the same states and (accepted, proposed)
  matrices, exactly, for 'global-jump', 'local-jump' and
  'restricted-range-jump' (locality 1 and 2).
* The host logZ adaptation from the same states and energies: logZ, the
  histogram, the stage and t0 equal the JAX package's (rel 1e-12) over a
  sequence of updates, for both weight-update methods and each flatness
  criterion.
* Where noise enters: logZ converges on the harmonic K ladder
  (``tests/test_multistate.py:199``), and the visit histogram counts every
  replica-iteration (``:1339``).
* Persistence: the adaptation survives a resume from storage (``:640``),
  and the analyzer's log-weight correction of the effective energy
  (``:716``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import logsumexp

import openmmtools_tpu.mcmc as jmc
import openmmtools_tpu.multistate as jms
from openmmtools_tpu.models import HarmonicOscillator as JaxHO
from openmmtools_tpu.states import SamplerState as JaxSS
from openmmtools_tpu.states import ThermodynamicState as JaxState
from openmmtools_tpu.states import create_thermodynamic_state_protocol as jproto
import openmmtools_tpu_torch.multistate as tms
from openmmtools_tpu_torch.constants import kB
from openmmtools_tpu_torch.mcmc import LangevinDynamicsMove
from openmmtools_tpu_torch.models import HarmonicOscillator
from openmmtools_tpu_torch.multistate.sams import sams_jump
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


def _pair(**kw):
    """A JAX and a port SAMS sampler created on the same four replicas of
    the K ladder at float64."""
    jho = JaxHO(K=K_LADDER[0])
    jst = jproto(JaxState(system=jax_f64(jho.system),
                          temperature=np.float64(TEMP)), {K_NAME: K_LADDER})
    pst = create_thermodynamic_state_protocol(
        ThermodynamicState(system=port_system(jho.system), temperature=TEMP),
        {K_NAME: K_LADDER})
    common = dict(number_of_iterations=50, online_analysis_interval=None,
                  **kw)
    js = jms.SAMSSampler(mcmc_moves=jmc.LangevinDynamicsMove(n_steps=1),
                         **common)
    ps = tms.SAMSSampler(mcmc_moves=_move(1), **common)
    x = np.random.default_rng(0).normal(scale=0.05, size=(4, 1, 3))
    js.create(jst, [JaxSS(positions=jnp.asarray(p)) for p in x])
    ps.create(pst, [SamplerState(positions=torch.as_tensor(p)) for p in x])
    return js, ps


@pytest.mark.parametrize("scheme,locality", [
    ("global-jump", None), ("local-jump", None), ("local-jump", 2),
    ("restricted-range-jump", 1)])
@pytest.mark.parametrize("seed", range(3))
def test_jump_core_on_jax_draws(scheme, locality, seed):
    js, ps = _pair(state_update_scheme=scheme, locality=locality)
    rng = np.random.default_rng(seed)
    n, k = 6, 4
    u = rng.normal(scale=2.0, size=(n, k + 1))      # one unsampled column
    states = rng.integers(0, k, n)
    log_w = rng.normal(size=k)
    acc = rng.integers(0, 3, (k, k))
    prop = acc + rng.integers(0, 3, (k, k))
    key = jax.random.PRNGKey(seed)
    j_states, j_acc, j_prop = js._mix_kernel(
        key, jnp.asarray(states, jnp.int32), jnp.asarray(u),
        jnp.asarray(acc, jnp.int32), jnp.asarray(prop, jnp.int32),
        {"log_weights": jnp.asarray(log_w)})
    # categorical(key, logits) = argmax(logits + gumbel(key, logits.shape))
    gumbel = jax.random.gumbel(key, (n, k), jnp.float64)
    t_states, t_acc, t_prop = sams_jump(
        torch.as_tensor(states), torch.as_tensor(u), torch.as_tensor(log_w),
        torch.as_tensor(acc), torch.as_tensor(prop),
        torch.as_tensor(np.array(gumbel)),
        None if scheme == "global-jump" else (locality or 1))
    np.testing.assert_array_equal(t_states.numpy(), np.asarray(j_states))
    np.testing.assert_array_equal(t_acc.numpy(), np.asarray(j_acc))
    np.testing.assert_array_equal(t_prop.numpy(), np.asarray(j_prop))
    if scheme != "global-jump":
        assert np.all(np.abs(t_states.numpy() - states) <= (locality or 1))


@pytest.mark.parametrize("method,criterion,threshold", [
    ("rao-blackwellized", "logZ-flatness", 6.0),
    ("optimal", "minimum-visits", 0.5),
    ("rao-blackwellized", "histogram-flatness", 0.5),
])
def test_logZ_update_matches_jax(method, criterion, threshold):
    js, ps = _pair(weight_update_method=method, flatness_criteria=criterion,
                   minimum_visits=3, flatness_threshold=threshold, gamma0=0.5)
    rng = np.random.default_rng(1)
    stages = []
    for it in range(1, 13):
        u = rng.normal(scale=2.0, size=(4, 4))
        s = rng.integers(0, 4, 4)
        js._carry = js._carry.replace(energies=jnp.asarray(u),
                                      replica_states=jnp.asarray(s, jnp.int32))
        ps._energies = torch.as_tensor(u)
        ps._replica_states = torch.as_tensor(s)
        js._iteration = ps._iteration = it
        js._update_logZ_estimates()
        ps._update_logZ_estimates()
        np.testing.assert_allclose(ps.logZ, js.logZ, rtol=1e-12, atol=1e-14)
        np.testing.assert_array_equal(ps._histogram, js._histogram)
        assert (ps._stage, ps._t0) == (js._stage, js._t0)
        np.testing.assert_allclose(ps.log_weights, js.log_weights,
                                   rtol=1e-12, atol=1e-14)
        stages.append(ps._stage)
    assert stages[0] == 0 and stages[-1] == 1, stages   # both stages


def test_sams_logZ_converges():
    """logZ_k approaches -(f_k - f_0) on the ladder, with a roughly flat
    histogram."""
    ho, states = _states()
    sampler = tms.SAMSSampler(
        mcmc_moves=_move(), number_of_iterations=600,
        state_update_scheme="global-jump", flatness_criteria="minimum-visits",
        minimum_visits=20, weight_update_method="rao-blackwellized",
        gamma0=0.25, online_analysis_interval=None, rng_seed=3)
    sampler.create(states, ho.sampler_state())
    sampler.run()
    logZ = sampler.logZ
    f_expected = np.asarray([_analytic_f(K) - _analytic_f(K_LADDER[0])
                             for K in K_LADDER])
    assert np.all(np.isfinite(logZ))
    assert np.all(np.diff(logZ) < 0), logZ
    assert np.allclose(logZ, -f_expected, atol=0.5), (logZ, -f_expected)
    hist = sampler._histogram
    assert hist.sum() == 4 * 600
    assert hist.min() > 0.5 * hist.mean()
    assert sampler._stage == 1


def test_single_replica_histogram_and_scheme_tag(tmp_path):
    pytest.importorskip("h5py")
    ho, states = _states()
    sampler = tms.SAMSSampler(
        mcmc_moves=_move(5), number_of_iterations=30,
        state_update_scheme="global-jump", flatness_criteria="minimum-visits",
        online_analysis_interval=None, rng_seed=17)
    reporter = tms.MultiStateReporter(str(tmp_path / "one.h5"),
                                      checkpoint_interval=10)
    sampler.create(states, [ho.sampler_state()], storage=reporter,
                   initial_thermodynamic_states=[0])
    sampler.run()
    assert sampler.n_replicas == 1
    hist = np.asarray(sampler._histogram)
    assert hist.sum() == 30 and (hist >= 0).all()
    assert reporter.read_mixing_scheme() == "gibbs-jump"
    stats = tms.SAMSAnalyzer(reporter).generate_mixing_statistics()
    assert stats.scheme == "gibbs-jump"
    assert stats.transition_matrix.shape == (4, 4)
    reporter.close()


def test_adaptation_survives_resume(tmp_path):
    pytest.importorskip("h5py")
    ho, states = _states()
    path = str(tmp_path / "sams.h5")
    sampler = tms.SAMSSampler(
        mcmc_moves=_move(5), number_of_iterations=8,
        state_update_scheme="global-jump", gamma0=2.0,
        flatness_criteria="minimum-visits", minimum_visits=2,
        online_analysis_interval=None, rng_seed=3)
    sampler.create(states, ho.sampler_state(),
                   storage=tms.MultiStateReporter(path, checkpoint_interval=1))
    sampler.run(5)
    logZ, hist, stage = sampler.logZ.copy(), sampler._histogram.copy(), \
        sampler._stage
    sampler._reporter.close()
    resumed = tms.SAMSSampler.from_storage(
        tms.MultiStateReporter(path, checkpoint_interval=1), device="cpu")
    assert resumed.iteration == 5
    np.testing.assert_allclose(resumed.logZ, logZ, atol=1e-12)
    np.testing.assert_array_equal(resumed._histogram, hist)
    assert resumed._stage == stage
    assert resumed.gamma0 == 2.0
    assert resumed.flatness_criteria == "minimum-visits"
    resumed.run(3)
    assert resumed._histogram.sum() == hist.sum() + 3 * 4
    # and the continued run equals one that never stopped
    straight = tms.SAMSSampler(
        mcmc_moves=_move(5), number_of_iterations=8,
        state_update_scheme="global-jump", gamma0=2.0,
        flatness_criteria="minimum-visits", minimum_visits=2,
        online_analysis_interval=None, rng_seed=3)
    straight.create(states, ho.sampler_state())
    straight.run()
    np.testing.assert_array_equal(resumed.replica_states,
                                  straight.replica_states)
    np.testing.assert_allclose(resumed.logZ, straight.logZ, rtol=1e-12)
    resumed._reporter.close()


def test_analyzer_log_weight_correction(tmp_path):
    pytest.importorskip("h5py")
    ho, states = _states()
    reporter = tms.MultiStateReporter(str(tmp_path / "sams2.h5"),
                                      checkpoint_interval=2)
    sampler = tms.SAMSSampler(
        mcmc_moves=_move(5), number_of_iterations=6,
        state_update_scheme="global-jump", online_analysis_interval=None,
        rng_seed=5)
    sampler.create(states, ho.sampler_state(), storage=reporter)
    sampler.run()
    reporter.close()
    reporter.open("r")
    series = tms.SAMSAnalyzer(reporter).get_effective_energy_timeseries()
    u, s = reporter.read_energies()
    lw = reporter.read_log_weights()
    f_l = -np.asarray(reporter.read_logZ(-1))
    for t in (0, 3, u.shape[0] - 1):
        plain = u[t][np.arange(u.shape[1]), s[t]].sum()
        lw_t = lw[min(t, lw.shape[0] - 1)]
        expected = plain - lw_t[s[t]].sum() + logsumexp(-f_l + lw_t)
        assert abs(series[t] - expected) < 1e-8
    reporter.close()
