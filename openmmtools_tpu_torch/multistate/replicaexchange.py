"""Replica exchange: Gibbs swap mixing on the host (counterpart of
``multistate/replicaexchange.py``).

Each scheme is a draw and a deterministic core that takes the draws as
arguments, on CPU tensors (the core loops over numpy views of them):

* 'swap-all' (:func:`mix_all`): 2 n^2 sweeps of n/2 disjoint random
  replica pairs, each pair accepted by Metropolis on log_p = -(u[i, s_j] +
  u[j, s_i]) + u[i, s_i] + u[j, s_j]; the draws are a permutation of the
  replicas a sweep and ln u of each pair's test;
* 'swap-neighbors' (:func:`mix_neighbors`): one sweep over the state pairs
  (k, k + 1), k of a random parity, between the replicas that hold them (a
  state held by no replica sits out; with several replicas at a state the
  highest-numbered one swaps); the draws are the parity and ln u of each
  pair's test;
* None: no mixing.

The counters (K, K) count proposals and acceptances between the sampled
states (u may carry unsampled columns beyond them).
"""
from __future__ import annotations

import numpy as np
import torch

from openmmtools_tpu_torch.multistate.sampler import MultiStateSampler


class ReplicaExchangeSampler(MultiStateSampler):
    """Gibbs-sampled state swaps every iteration (replicaexchange.py:52).

    replica_mixing_scheme: 'swap-all' (default), 'swap-neighbors', or None.
    """

    # the counters record Metropolis swap outcomes
    _mixing_statistics_scheme = "metropolis-swap"

    def __init__(self, *args, replica_mixing_scheme="swap-all", **kwargs):
        super().__init__(*args, **kwargs)
        if replica_mixing_scheme not in ("swap-all", "swap-neighbors", None):
            raise ValueError(
                f"unknown replica_mixing_scheme {replica_mixing_scheme!r}")
        self.replica_mixing_scheme = replica_mixing_scheme

    def _mix_kernel(self, generator, states, u, n_acc, n_prop):
        if self.replica_mixing_scheme is None:
            return None
        if self.replica_mixing_scheme == "swap-neighbors":
            draws = draw_mix_neighbors(generator, n_prop.shape[0], u.dtype)
            return mix_neighbors(states, u, n_acc, n_prop, *draws)
        draws = draw_mix_all(generator, states.shape[0], u.dtype)
        return mix_all(states, u, n_acc, n_prop, *draws)


def draw_mix_all(generator, n, dtype):
    """The swap-all draws for n replicas: (perms (2 n^2, n) int64, log_us
    (2 n^2, n // 2) of ``dtype``)."""
    n_sweeps = 2 * n * n
    perms = torch.argsort(torch.rand((n_sweeps, n), generator=generator,
                                     dtype=torch.float64), dim=1)
    log_us = torch.log(torch.rand((n_sweeps, n // 2), generator=generator,
                                  dtype=dtype))
    return perms, log_us


def mix_all(states, u, n_acc, n_prop, perms, log_us):
    """Swap-all mixing given its draws: sweep t pairs replicas perms[t, :h]
    with perms[t, h:2h] (h = n // 2) and accepts pair p when log_us[t, p] <
    log_p. Returns (states, n_acc, n_prop), new tensors."""
    s = states.numpy().copy()
    n = s.shape[0]
    n_half = n // 2
    acc = n_acc.numpy().copy()
    prop = n_prop.numpy().copy()
    if n_half == 0:
        return torch.as_tensor(s), torch.as_tensor(acc), torch.as_tensor(prop)
    uu = u.numpy()
    p = perms.numpy()
    lu = log_us.numpy()
    # the sweeps are sequential; their bookkeeping is one scatter after
    s_is = np.empty((p.shape[0], n_half), dtype=np.int64)
    s_js = np.empty_like(s_is)
    accepts = np.empty(s_is.shape, dtype=bool)
    for t in range(p.shape[0]):
        i = p[t, :n_half]
        j = p[t, n_half:2 * n_half]
        s_i = s[i]
        s_j = s[j]
        log_p = -(uu[i, s_j] + uu[j, s_i]) + uu[i, s_i] + uu[j, s_j]
        accept = lu[t] < log_p
        s[i] = np.where(accept, s_j, s_i)
        s[j] = np.where(accept, s_i, s_j)
        s_is[t], s_js[t], accepts[t] = s_i, s_j, accept
    a = accepts.astype(np.int64)
    for x, y in ((s_is, s_js), (s_js, s_is)):
        np.add.at(prop, (x, y), 1)
        np.add.at(acc, (x, y), a)
    return torch.as_tensor(s), torch.as_tensor(acc), torch.as_tensor(prop)


def draw_mix_neighbors(generator, k_s, dtype):
    """The swap-neighbors draws over k_s sampled states: (parity () int64,
    log_r (max(k_s // 2, 1),) of ``dtype``)."""
    parity = torch.randint(0, 2, (), generator=generator)
    log_r = torch.log(torch.rand((max(k_s // 2, 1),), generator=generator,
                                 dtype=dtype))
    return parity, log_r


def mix_neighbors(states, u, n_acc, n_prop, parity, log_r):
    """Neighbour swaps given their draws: pair p tries states (2p + parity,
    2p + parity + 1) between the replicas holding them. Returns (states,
    n_acc, n_prop), new tensors."""
    s = states.numpy().copy()
    acc = n_acc.numpy().copy()
    prop = n_prop.numpy().copy()
    uu = u.numpy()
    n = s.shape[0]
    k_s = prop.shape[0]
    # the replica at each sampled state (-1: none; the highest-numbered
    # replica where several share one)
    replica_of = np.full((k_s,), -1, dtype=np.int64)
    np.maximum.at(replica_of, s, np.arange(n))
    n_pairs = max(k_s // 2, 1)
    pair_start = np.arange(n_pairs) * 2 + int(parity)
    s_a = np.clip(pair_start, 0, k_s - 1)
    s_b = np.clip(pair_start + 1, 0, k_s - 1)
    valid = ((pair_start + 1 < k_s) & (replica_of[s_a] >= 0)
             & (replica_of[s_b] >= 0))
    i = np.maximum(replica_of[s_a], 0)
    j = np.maximum(replica_of[s_b], 0)
    log_p = -(uu[i, s_b] + uu[j, s_a]) + uu[i, s_a] + uu[j, s_b]
    accept = (log_r.numpy() < log_p) & valid
    s[i[valid]] = np.where(accept, s_b, s_a)[valid]
    s[j[valid]] = np.where(accept, s_a, s_b)[valid]
    inc_p = valid.astype(np.int64)
    inc_a = accept.astype(np.int64)
    np.add.at(prop, (s_a, s_b), inc_p)
    np.add.at(prop, (s_b, s_a), inc_p)
    np.add.at(acc, (s_a, s_b), inc_a)
    np.add.at(acc, (s_b, s_a), inc_a)
    return torch.as_tensor(s), torch.as_tensor(acc), torch.as_tensor(prop)
