"""The cases of ``tests/test_mbar_theta.py`` on the port's MBAR: the
asymptotic covariance against a bootstrap of the estimate and against the
spread of independent replications, on gaussian states in the
well-conditioned, poor-overlap (< 0.1), empty-bridge, empty-endpoint and
no-overlap regimes, and the augmented-state expectation covariance against
a bootstrap.
"""
import math

import numpy as np
import pytest

import openmmtools_tpu_torch.multistate.mbar as tmbar

K_VALS = np.asarray([1.0, 2.5, 6.0])


def _gaussian_u_kn(rng, mus, sigs, ns):
    xs = [rng.normal(m, s, n) for m, s, n in zip(mus, sigs, ns) if n > 0]
    x = np.concatenate(xs)
    return np.stack([0.5 * ((x - m) / s) ** 2 + math.log(s)
                     for m, s in zip(mus, sigs)]), np.asarray(ns, float)


def _draw_u_kn(rng, n=800):
    xs = [rng.normal(0, 1.0 / math.sqrt(k), n) for k in K_VALS]
    x = np.concatenate(xs)
    return np.stack([0.5 * k * x ** 2 for k in K_VALS]), np.full(3, n)


def test_theta_matches_bootstrap():
    rng = np.random.default_rng(0)
    u_kn, n_k = _draw_u_kn(rng)
    res = tmbar.mbar_free_energies(u_kn, n_k)
    df, ddf = res.delta_f(0, 2)
    analytic = -0.5 * math.log(K_VALS[0] / K_VALS[-1])
    assert abs(float(df) - analytic) < 6 * max(float(ddf), 1e-3)
    n = 800
    dfs = []
    for _ in range(60):
        cols = np.concatenate([k * n + rng.integers(0, n, n)
                               for k in range(3)])
        f = tmbar.mbar_free_energies(u_kn[:, cols], n_k,
                                     compute_theta=False).free_energies
        dfs.append(float(f[-1] - f[0]))
    boot_std = float(np.std(dfs, ddof=1))
    assert 0.6 * boot_std < float(ddf) < 1.6 * boot_std, (float(ddf),
                                                          boot_std)


def test_expectation_covariance_matches_bootstrap():
    rng = np.random.default_rng(2)
    u_kn, n_k = _draw_u_kn(rng)
    res = tmbar.mbar_free_energies(u_kn, n_k)
    h, cov_hh, cov_hf, t_ff = [a.numpy() for a in tmbar.mbar_expectations(
        u_kn, n_k, res.free_energies, u_kn)]
    np.testing.assert_allclose(h, 0.5, atol=0.05)
    i, j = 0, 2
    var_dh = cov_hh[i, i] + cov_hh[j, j] - 2 * cov_hh[i, j]
    var_df = t_ff[i, i] + t_ff[j, j] - 2 * t_ff[i, j]
    cov_cross = cov_hf[j, j] - cov_hf[j, i] - cov_hf[i, j] + cov_hf[i, i]
    var_ds = var_dh + var_df - 2 * cov_cross
    n = 800
    dhs, dss = [], []
    for _ in range(60):
        cols = np.concatenate([k * n + rng.integers(0, n, n)
                               for k in range(3)])
        ub = u_kn[:, cols]
        fb = tmbar.mbar_free_energies(ub, n_k,
                                      compute_theta=False).free_energies
        hb = tmbar.mbar_expectations(ub, n_k, fb, ub)[0].numpy()
        fb = fb.numpy()
        dhs.append(hb[j] - hb[i])
        dss.append(hb[j] - hb[i] - (fb[j] - fb[i]))
    boot_dh = float(np.std(dhs, ddof=1))
    boot_ds = float(np.std(dss, ddof=1))
    assert 0.55 * boot_dh < math.sqrt(var_dh) < 1.8 * boot_dh
    assert 0.55 * boot_ds < math.sqrt(max(var_ds, 0.0)) < 1.8 * boot_ds


def _replication(mus, sigs, ns, reps=60, seed=0):
    rng = np.random.default_rng(seed)
    dfs, ddfs = [], []
    for _ in range(reps):
        u_kn, n_k = _gaussian_u_kn(rng, mus, sigs, ns)
        df, ddf = tmbar.mbar_free_energies(u_kn, n_k).delta_f(0, len(mus) - 1)
        dfs.append(float(df))
        ddfs.append(float(ddf))
    return float(np.std(dfs, ddof=1)), float(np.mean(ddfs))


@pytest.mark.parametrize("mus,ns,seed", [
    ([0.0, 6.0], [200, 200], 3),          # poor overlap (< 0.1)
    ([0.0, 3.0, 6.0], [300, 0, 300], 4),  # an empty bridge state
    ([0.0, 2.0], [400, 0], 5),            # an empty endpoint
])
def test_theta_against_replication_spread(mus, ns, seed):
    spread, ddf = _replication(mus, [1.0] * len(mus), ns, seed=seed)
    assert 0.5 * spread < ddf < 2.0 * spread, (ddf, spread)


def test_theta_no_overlap_fails_loud():
    _, ddf = _replication([0.0, 10.0], [1.0, 1.0], [300, 300], reps=10,
                          seed=6)
    assert ddf > 10.0 or math.isinf(ddf) or math.isnan(ddf), ddf


def test_theta_matches_replication_spread():
    rng = np.random.default_rng(1)
    dfs, ddfs = [], []
    for _ in range(40):
        u_kn, n_k = _draw_u_kn(rng, n=400)
        df, ddf = tmbar.mbar_free_energies(u_kn, n_k).delta_f(0, 2)
        dfs.append(float(df))
        ddfs.append(float(ddf))
    true_std = float(np.std(dfs, ddof=1))
    assert 0.6 * true_std < float(np.mean(ddfs)) < 1.6 * true_std
    analytic = -0.5 * math.log(K_VALS[0] / K_VALS[-1])
    assert abs(np.mean(dfs) - analytic) < 4 * true_std / math.sqrt(40)
