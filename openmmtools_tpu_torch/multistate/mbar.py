"""MBAR, EXP and BAR free-energy estimators (counterpart of
``multistate/mbar.py``).

The multistate Bennett acceptance ratio solved by self-consistent logsumexp
iteration on the u_kn matrix, with the asymptotic covariance estimator
(Shirts & Chodera 2008, Eq. 8 and Appendix D6) and the augmented-state
expectations; the one-sided exponential average (EXP, Zwanzig) and the
two-state Bennett acceptance ratio (BAR) from work samples.

Everything runs on the host in float64 (CPU tensors): u_kn holds one row a
state and one column a sample, small next to the configurations that
produced it. Inputs may be numpy arrays or tensors on any device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

_F64 = torch.float64


def _host64(a) -> torch.Tensor:
    """``a`` as a float64 CPU tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device="cpu", dtype=_F64)
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


class MBARResult(NamedTuple):
    """free_energies: (K,) dimensionless f_k with f_0 = 0;
    theta: (K, K) asymptotic covariance of the f_k."""

    free_energies: torch.Tensor
    theta: torch.Tensor

    def delta_f(self, i: int = 0, j: Optional[int] = None):
        """Delta f_ij and its uncertainty (kT units), as 0-d tensors."""
        f = self.free_energies
        th = self.theta
        if j is None:
            j = f.shape[0] - 1
        df = f[j] - f[i]
        ddf = torch.sqrt(torch.clamp(th[i, i] + th[j, j] - 2.0 * th[i, j],
                                     min=0.0))
        return df, ddf


def _log_denominators(u_kn, log_nk, f_k):
    """d_n = ln sum_l N_l exp(f_l - u_ln)."""
    return torch.logsumexp(log_nk[:, None] + f_k[:, None] - u_kn, dim=0)


def _solve_mbar(u_kn, n_k, f_init, tol=1e-10, max_iter=10000):
    """Fixed-point iteration f_k <- -ln sum_n exp(-u_kn - d_n) (then
    f_0 = 0) until the largest change is at most ``tol`` or ``max_iter``
    updates have run."""
    log_nk_minus_u = torch.log(n_k)[:, None] - u_kn
    minus_u = -u_kn
    f = f_init - f_init[0]
    f_prev = f + 1.0
    it = 0
    while bool(torch.max(torch.abs(f - f_prev)) > tol) and it < max_iter:
        d_n = torch.logsumexp(log_nk_minus_u + f[:, None], dim=0)
        f_new = -torch.logsumexp(minus_u - d_n, dim=1)
        f, f_prev = f_new - f_new[0], f
        it += 1
    return f


def _mbar_theta(u_kn, n_k, f_k):
    """Asymptotic covariance Theta of the f_k from the weight matrix
    W_kn = exp(f_k - u_kn - d_n): Theta = pinv(I - W W^T diag(N)) W W^T,
    the D6 form pinv(pinv(W W^T) - diag(N)) without inverting W W^T first.
    (I - W W^T diag(N)) always has the normalization null vector 1; the
    pinv cut (rcond 1e-10) drops that gauge mode. A null space of more than
    one dimension means the sample graph is disconnected: Theta is +inf."""
    d_n = _log_denominators(u_kn, torch.log(n_k), f_k)
    w = torch.exp(f_k[:, None] - u_kn - d_n[None, :])   # (K, n)
    wtw = w @ w.t()                                      # sum_n w_kn w_ln
    eye = torch.eye(w.shape[0], dtype=w.dtype)
    a = eye - wtw * n_k[None, :]
    theta = torch.linalg.pinv(a, rtol=1e-10) @ wtw
    s_vals = torch.linalg.svdvals(a)
    n_null = int(torch.sum(s_vals < 1e-7 * torch.clamp(s_vals[0], min=1.0)))
    if n_null > 1:
        theta = torch.full_like(theta, float("inf"))
    return 0.5 * (theta + theta.t())


def mbar_free_energies(u_kn, n_k, f_init=None, tol=1e-10,
                       compute_theta=True) -> MBARResult:
    """Solve MBAR for dimensionless free energies.

    Parameters
    ----------
    u_kn : (K, n_total) reduced potentials of every sample at every state
        (the 'ln' layout of the analyzer's reformatting).
    n_k : (K,) number of samples drawn from each state (sum = n_total);
        a state with no samples is held at 1e-300.
    """
    u_kn = _host64(u_kn)
    n_k = _host64(n_k)
    k = u_kn.shape[0]
    f_init = (torch.zeros((k,), dtype=_F64) if f_init is None
              else _host64(f_init))
    n_k_safe = torch.clamp(n_k, min=1e-300)
    f = _solve_mbar(u_kn, n_k_safe, f_init, tol=tol)
    theta = (_mbar_theta(u_kn, n_k_safe, f) if compute_theta
             else torch.zeros((k, k), dtype=_F64))
    return MBARResult(free_energies=f, theta=theta)


def mbar_expectations(u_kn, n_k, f_k, a_kn):
    """Per-state MBAR expectations with the full asymptotic covariance by
    the augmented-state method (Shirts & Chodera 2008 Sec. IV).

    Parameters
    ----------
    u_kn : (K, N) reduced potentials (every sample at every state).
    n_k : (K,) samples per state.
    f_k : (K,) converged MBAR free energies.
    a_kn : (K, N) observable values: row i is the observable whose
        expectation is taken under state i (for enthalpy, a_kn = u_kn).

    Returns
    -------
    means : (K,) <A_i>_i
    cov_aa : (K, K) cov(<A_i>, <A_j>)
    cov_af : (K, K) cov(<A_i>, f_j)
    theta : (K, K) cov(f_i, f_j) from the same augmented estimator
    """
    u_kn = _host64(u_kn)
    a_kn = _host64(a_kn)
    n_k = _host64(n_k)
    f_k = _host64(f_k)
    k = u_kn.shape[0]
    log_nk = torch.log(torch.clamp(n_k, min=1e-300))
    d_n = _log_denominators(u_kn, log_nk, f_k)
    log_w = f_k[:, None] - u_kn - d_n[None, :]        # (K, N), rows sum to 1

    # positive-shifted observable A' = A - (min - 1): constants cancel in
    # all covariances; the shift keeps ln A' finite
    shift = torch.min(a_kn) - 1.0
    log_a = torch.log(a_kn - shift)

    # augmented rows: state K+i carries weights ~ W_i * A'_i
    log_wa_un = log_w + log_a
    log_norm = torch.logsumexp(log_wa_un, dim=1, keepdim=True)
    log_wa = log_wa_un - log_norm
    means_shifted = torch.exp(log_norm[:, 0])          # <A'>_i
    means = means_shifted + shift

    w_aug = torch.cat([torch.exp(log_w), torch.exp(log_wa)], dim=0)
    n_aug = torch.cat([n_k, torch.zeros_like(n_k)])
    wtw = w_aug @ w_aug.t()                            # (2K, 2K)
    eye = torch.eye(2 * k, dtype=_F64)
    theta_aug = torch.linalg.pinv(eye - wtw * n_aug[None, :],
                                  rtol=1e-10) @ wtw
    theta_aug = 0.5 * (theta_aug + theta_aug.t())

    t_ff = theta_aug[:k, :k]
    t_fa = theta_aug[:k, k:]
    t_aa = theta_aug[k:, k:]
    m = means_shifted
    # delta method on ln<A'>_i = ln c_{K+i} - ln c_i
    cov_aa = (m[:, None] * m[None, :]) * (t_aa - t_fa.t() - t_fa + t_ff)
    # cov(ln<A'>_i, -ln c_j) = Theta_ij - Theta_{K+i,j}
    cov_af = m[:, None] * (t_ff - t_fa.t())
    return means, cov_aa, cov_af, t_ff


def exp_free_energy(w_f):
    """One-sided exponential (Zwanzig) estimate from forward work samples:
    Delta f = -ln <exp(-w)>. Returns (df, ddf), 0-d float64 tensors."""
    w_f = _host64(w_f)
    n = w_f.shape[0]
    df = -(torch.logsumexp(-w_f, dim=0) - np.log(n))
    ex = torch.exp(-w_f + df)   # normalized to mean ~1
    ddf = torch.std(ex, correction=0) / np.sqrt(n)
    return df, ddf


def bar_free_energy(w_f, w_r, tol=1e-10, max_iter=1000):
    """Bennett acceptance ratio from forward and reverse work samples.

    Solves sum_f 1/(1 + exp(M + w_f - df)) = sum_r 1/(1 + exp(-(M + w_r +
    df))) with M = ln(n_f / n_r) by 100 bisections of [-500, 500]. Returns
    (df, ddf), 0-d float64 tensors; ddf is Bennett's asymptotic error."""
    w_f = _host64(w_f)
    w_r = _host64(w_r)
    n_f, n_r = w_f.shape[0], w_r.shape[0]
    m = float(np.log(n_f / n_r))
    zero = torch.zeros((), dtype=_F64)

    def objective(df):
        # monotonically increasing in df, root at the BAR estimate
        return (torch.logsumexp(-torch.logaddexp(zero, m + w_f - df), dim=0)
                - torch.logsumexp(-torch.logaddexp(zero, -m + w_r + df),
                                  dim=0))

    lo = torch.tensor(-500.0, dtype=_F64)
    hi = torch.tensor(500.0, dtype=_F64)
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        below = bool(objective(mid) < 0)
        lo, hi = (mid, hi) if below else (lo, mid)
    df = 0.5 * (lo + hi)

    # asymptotic variance (Bennett 1976)
    ff = 1.0 / (1.0 + torch.exp(m + w_f - df))
    fr = 1.0 / (1.0 + torch.exp(-m + w_r + df))
    n_tot = n_f + n_r
    mean_sq = (torch.sum(ff ** 2) + torch.sum(fr ** 2)) / n_tot
    mean = (torch.sum(ff) + torch.sum(fr)) / n_tot
    var = (mean_sq / mean ** 2 - 1.0) / n_tot * 2.0
    ddf = torch.sqrt(torch.clamp(var, min=0.0))
    return df, ddf
