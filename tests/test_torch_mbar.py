"""The port's MBAR, EXP and BAR estimators and timeseries helpers against
the JAX package's, on the CPU at float64.

* MBAR free energies and their covariance, the augmented-state
  expectations, EXP and BAR: rel 1e-10 of the JAX package's values on
  synthetic u_kn (gaussian states), on a harmonic ladder's u_kn with
  unequal N_k and with an empty state, on disconnected states (+inf
  covariance), and on gaussian work distributions.
* ``multistate/utils``: the port's functions equal the JAX package's on
  seeded series.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest

import openmmtools_tpu.multistate.mbar as jmbar
import openmmtools_tpu.multistate.utils as jutils
import openmmtools_tpu_torch.multistate.mbar as tmbar
import openmmtools_tpu_torch.multistate.utils as tutils

REL = 1e-10


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    if not fin.any():
        return
    scale = max(float(np.abs(want[fin]).max()), 1e-300)
    assert float(np.abs(got[fin] - want[fin]).max()) <= rel * scale, (
        float(np.abs(got[fin] - want[fin]).max()), scale)


def _gaussian_u_kn(rng, mus, sigs, ns):
    xs = [rng.normal(m, s, n) for m, s, n in zip(mus, sigs, ns) if n > 0]
    x = np.concatenate(xs)
    return np.stack([0.5 * ((x - m) / s) ** 2 + math.log(s)
                     for m, s in zip(mus, sigs)]), np.asarray(ns, float)


def _harmonic_u_kn(rng, ns, kT=2.494):
    """A 3D harmonic K ladder's reduced potentials."""
    ks = np.asarray([100.0, 200.0, 400.0, 800.0])
    xs = [rng.normal(0, math.sqrt(kT / k), (n, 3)) for k, n in zip(ks, ns)
          if n > 0]
    r2 = np.sum(np.concatenate(xs) ** 2, axis=1)
    return np.stack([0.5 * k * r2 / kT for k in ks]), np.asarray(ns, float)


CASES = {
    "gaussian": lambda rng: _gaussian_u_kn(rng, [0.0, 1.0, 2.5],
                                           [1.0, 1.2, 0.8], [300, 300, 300]),
    "harmonic-unequal": lambda rng: _harmonic_u_kn(rng, [400, 150, 250, 90]),
    "harmonic-empty-state": lambda rng: _harmonic_u_kn(rng, [300, 0, 200, 250]),
    "empty-endpoint": lambda rng: _gaussian_u_kn(rng, [0.0, 2.0],
                                                 [1.0, 1.0], [400, 0]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mbar_matches_jax(case):
    u_kn, n_k = CASES[case](np.random.default_rng(0))
    jr = jmbar.mbar_free_energies(jnp.asarray(u_kn), jnp.asarray(n_k))
    tr = tmbar.mbar_free_energies(u_kn, n_k)
    _close(tr.free_energies.numpy(), jr.free_energies)
    _close(tr.theta.numpy(), jr.theta)
    for i, j in ((0, None), (1, u_kn.shape[0] - 1)):
        jdf, jddf = jr.delta_f(i, j)
        tdf, tddf = tr.delta_f(i, j)
        _close(float(tdf), float(jdf))
        _close(float(tddf), float(jddf))
    # a warm start from a perturbed estimate converges to the same answer
    f0 = np.asarray(jr.free_energies) + 0.3
    _close(tmbar.mbar_free_energies(u_kn, n_k, f_init=f0).free_energies,
           jmbar.mbar_free_energies(jnp.asarray(u_kn), jnp.asarray(n_k),
                                    f_init=jnp.asarray(f0)).free_energies)


@pytest.mark.parametrize("case", ["gaussian", "harmonic-unequal"])
def test_expectations_match_jax(case):
    u_kn, n_k = CASES[case](np.random.default_rng(1))
    jr = jmbar.mbar_free_energies(jnp.asarray(u_kn), jnp.asarray(n_k))
    tr = tmbar.mbar_free_energies(u_kn, n_k)
    jout = jmbar.mbar_expectations(jnp.asarray(u_kn), jnp.asarray(n_k),
                                   jr.free_energies, jnp.asarray(u_kn))
    tout = tmbar.mbar_expectations(u_kn, n_k, tr.free_energies, u_kn)
    for got, want in zip(tout, jout):
        _close(got.numpy(), want, rel=1e-9)


def test_disconnected_states_report_inf():
    """Zero overlap: a null space of more than one dimension gives an
    infinite covariance on both sides."""
    u_kn, n_k = _gaussian_u_kn(np.random.default_rng(6), [0.0, 60.0],
                               [1.0, 1.0], [200, 200])
    jr = jmbar.mbar_free_energies(jnp.asarray(u_kn), jnp.asarray(n_k))
    tr = tmbar.mbar_free_energies(u_kn, n_k)
    assert np.all(np.isinf(np.asarray(jr.theta)))
    assert bool(torch_all_inf(tr.theta))


def torch_all_inf(t):
    return np.all(np.isinf(t.numpy()))


@pytest.mark.parametrize("seed", range(3))
def test_exp_and_bar_match_jax(seed):
    rng = np.random.default_rng(seed)
    df_true, s = 2.0, 1.0 + 0.3 * seed
    w_f = rng.normal(df_true + s ** 2 / 2, s, 1500 + 200 * seed)
    w_r = rng.normal(-df_true + s ** 2 / 2, s, 1200)
    for got, want in zip(tmbar.exp_free_energy(w_f),
                         jmbar.exp_free_energy(jnp.asarray(w_f))):
        _close(float(got), float(want))
    for got, want in zip(tmbar.bar_free_energy(w_f, w_r),
                         jmbar.bar_free_energy(jnp.asarray(w_f),
                                               jnp.asarray(w_r))):
        _close(float(got), float(want))
    df, ddf = tmbar.bar_free_energy(w_f, w_r)
    assert abs(float(df) - df_true) < 6 * max(float(ddf), 0.02)


# -- multistate/utils ------------------------------------------------------


def _series(seed, n=400, tau=8.0, drift=True):
    """An AR(1) series, with an equilibration transient when ``drift``."""
    rng = np.random.default_rng(seed)
    phi = math.exp(-1.0 / tau)
    a = np.empty(n)
    a[0] = 0.0
    for t in range(1, n):
        a[t] = phi * a[t - 1] + rng.normal()
    if drift:
        a += 10.0 * np.exp(-np.arange(n) / 30.0)
    return a


@pytest.mark.parametrize("seed", range(3))
def test_timeseries_helpers_match_jax(seed):
    a = _series(seed)
    for fast in (False, True):
        assert tutils.statistical_inefficiency(a, fast=fast) == \
            jutils.statistical_inefficiency(a, fast=fast)
    assert tutils.detect_equilibration(a) == jutils.detect_equilibration(a)
    assert tutils.detect_equilibration(a, nskip=5) == \
        jutils.detect_equilibration(a, nskip=5)
    assert tutils.get_equilibration_data_per_sample(a) == \
        jutils.get_equilibration_data_per_sample(a)
    g = tutils.statistical_inefficiency(a)
    np.testing.assert_array_equal(tutils.subsample_correlated_data(a),
                                  jutils.subsample_correlated_data(a))
    np.testing.assert_array_equal(tutils.subsample_correlated_data(a, g=g),
                                  jutils.subsample_correlated_data(a, g=g))
    data = np.random.default_rng(seed).normal(size=(50, 3, 4))
    np.testing.assert_array_equal(
        tutils.remove_unequilibrated_data(data, 7, axis=0),
        jutils.remove_unequilibrated_data(data, 7, axis=0))
    np.testing.assert_array_equal(
        tutils.subsample_data_along_axis(data, [0, 3, 9], axis=0),
        jutils.subsample_data_along_axis(data, [0, 3, 9], axis=0))
    # the edges: a constant series and a short one
    assert tutils.statistical_inefficiency(np.ones(10)) == 1.0
    assert tutils.detect_equilibration(np.ones(10)) == \
        jutils.detect_equilibration(np.ones(10))
    assert tutils.detect_equilibration(a[:2]) == \
        jutils.detect_equilibration(a[:2])
    assert issubclass(tutils.SimulationNaNError, Exception)
