"""SAMS: self-adjusted mixture sampling (counterpart of
``multistate/sams.py``).

Each replica jumps between states by an exact Gibbs draw from its row of the
energy matrix and the current log weights: 'global-jump' over all states,
'local-jump' and 'restricted-range-jump' over the states within
``locality`` (1 by default) of its own. The draw is Gumbel noise (N, K) and
the core (:func:`sams_jump`) takes it as an argument: the new state is
argmax(log_w - u + gumbel) over the allowed states, in float64.

The log normalizing constants logZ adapt on the host after each iteration
(Tan 2017): a burn-in gain min(K / sqrt(t + 1), gamma0) until the
flatness criterion ('minimum-visits', 'histogram-flatness' or
'logZ-flatness') holds, then 1 / (t - t0 + 1 / gamma0); the 'optimal'
update adds the gain at each replica's state, the 'rao-blackwellized' one
spreads it over each replica's conditional state distribution. logZ is
re-referenced to state 0 in the asymptotic stage. logZ, the log weights,
the visit histogram, the stage and t0 are written to storage every
iteration and read back on resume.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch
from scipy.special import logsumexp

from openmmtools_tpu_torch.multistate.sampler import MultiStateSampler

logger = logging.getLogger(__name__)


def draw_sams_jump(generator, shape, dtype):
    """Standard Gumbel noise of ``shape`` (N, K): -ln(-ln U), U in (0, 1)."""
    uniform = torch.rand(shape, generator=generator, dtype=dtype)
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(torch.clamp(uniform, min=tiny)))


def sams_jump(states, u, log_weights, n_acc, n_prop, gumbel, locality=None):
    """The jump given its Gumbel draw: new state argmax over the allowed
    states of log_w - u + gumbel (all states, or with ``locality`` those
    within it of the replica's). Every draw is a proposal; a changed state
    counts as accepted. Returns (states, n_acc, n_prop), new tensors."""
    k = log_weights.shape[0]
    logp = log_weights[None, :] - u[:, :k]
    if locality is not None:
        mask = (torch.abs(torch.arange(k)[None, :] - states[:, None])
                <= locality)
        logp = torch.where(mask, logp, torch.full_like(logp, -float("inf")))
    new_states = torch.argmax(logp + gumbel, dim=1).to(states.dtype)
    n_prop = n_prop.clone()
    n_acc = n_acc.clone()
    n_prop.index_put_((states, new_states), torch.ones_like(states),
                      accumulate=True)
    n_acc.index_put_((states, new_states), (new_states != states).to(
        n_acc.dtype), accumulate=True)
    return new_states, n_acc, n_prop


class SAMSSampler(MultiStateSampler):
    """Single- or multi-replica SAMS sampler (sams.py:43).

    state_update_scheme in {'global-jump', 'local-jump',
    'restricted-range-jump'}; locality for the local schemes; update_stages
    in {'one-stage', 'two-stage'}; flatness_criteria in {'minimum-visits',
    'histogram-flatness', 'logZ-flatness'} with flatness_threshold and
    minimum_visits; weight_update_method in {'optimal',
    'rao-blackwellized'}; gamma0; log_target_probabilities.
    """

    # exact Gibbs draws: 'accepted' counts state changes, every draw is
    # 'proposed'
    _mixing_statistics_scheme = "gibbs-jump"

    def __init__(self, *args, state_update_scheme="global-jump",
                 locality=None, update_stages="two-stage",
                 flatness_criteria="logZ-flatness", flatness_threshold=0.2,
                 weight_update_method="rao-blackwellized", gamma0=1.0,
                 log_target_probabilities=None, minimum_visits=100, **kwargs):
        super().__init__(*args, locality=locality, **kwargs)
        if state_update_scheme not in ("global-jump", "local-jump",
                                       "restricted-range-jump"):
            raise ValueError(f"unknown state_update_scheme "
                             f"{state_update_scheme!r}")
        if update_stages not in ("one-stage", "two-stage"):
            raise ValueError(f"unknown update_stages {update_stages!r}")
        if flatness_criteria not in ("minimum-visits", "histogram-flatness",
                                     "logZ-flatness"):
            raise ValueError(f"unknown flatness_criteria {flatness_criteria!r}")
        if weight_update_method not in ("optimal", "rao-blackwellized"):
            raise ValueError(f"unknown weight_update_method "
                             f"{weight_update_method!r}")
        self.state_update_scheme = state_update_scheme
        self.update_stages = update_stages
        self.flatness_criteria = flatness_criteria
        self.flatness_threshold = flatness_threshold
        self.weight_update_method = weight_update_method
        self.gamma0 = gamma0
        self.minimum_visits = minimum_visits
        self._log_target_probabilities = log_target_probabilities
        self._logZ: Optional[np.ndarray] = None
        self._histogram: Optional[np.ndarray] = None
        self._stage = 0          # 0: burn-in, 1: asymptotic
        self._t0 = 0             # iteration at which stage 1 began

    @property
    def log_target_probabilities(self) -> np.ndarray:
        k = self.n_states
        if self._log_target_probabilities is None:
            return np.full(k, -np.log(k))
        p = np.asarray(self._log_target_probabilities, dtype=np.float64)
        return p - logsumexp(p)

    @property
    def logZ(self) -> np.ndarray:
        return self._logZ

    @property
    def log_weights(self) -> np.ndarray:
        """log w_k = log pi_k - logZ_k (sams.py:683-691)."""
        return self.log_target_probabilities - self._logZ

    def create(self, *args, **kwargs):
        super().create(*args, **kwargs)
        k = self.n_states
        self._logZ = np.zeros(k)
        self._histogram = np.zeros(k, dtype=np.int64)
        self._stage = 0 if self.update_stages == "two-stage" else 1
        self._t0 = 0
        # the iteration-0 row keeps the SAMS arrays aligned with energies
        self._write_sams_data()

    def _stored_options(self):
        options = super()._stored_options()
        options.update({
            "state_update_scheme": self.state_update_scheme,
            "update_stages": self.update_stages,
            "flatness_criteria": self.flatness_criteria,
            "flatness_threshold": self.flatness_threshold,
            "weight_update_method": self.weight_update_method,
            "gamma0": self.gamma0,
            "minimum_visits": self.minimum_visits,
        })
        return options

    def _write_sams_data(self):
        if self._reporter is None:
            return
        self._reporter.write_sams_data(
            self._iteration, self._logZ, self.log_weights,
            self._histogram, self._stage, self._t0)

    def _restore_adaptation(self, reporter, iteration):
        """Resume the logZ adaptation where the stored run left it."""
        data = reporter.read_sams_data(iteration)
        if data is None:
            logger.warning("no stored SAMS adaptation state at iteration "
                           "%d; adaptation restarts from zero", iteration)
            return
        self._logZ = np.asarray(data["logZ"], dtype=np.float64)
        self._histogram = np.asarray(data["histogram"], dtype=np.int64)
        self._stage = int(data["stage"])
        self._t0 = int(data["t0"])

    # -- the jump -----------------------------------------------------------
    def _mix_kernel(self, generator, states, u, n_acc, n_prop):
        locality = None
        if self.state_update_scheme != "global-jump":
            locality = 1 if self.locality is None else self.locality
        gumbel = draw_sams_jump(generator, (states.shape[0], self.n_states),
                                torch.float64)
        return sams_jump(states, u, torch.as_tensor(self.log_weights),
                         n_acc, n_prop, gumbel, locality)

    # -- the adaptation, after each iteration ------------------------------
    def _after_iteration(self):
        self._update_logZ_estimates()

    def _after_report(self):
        self._write_sams_data()

    def _gamma(self) -> float:
        """Adaptation gain (Tan 2017 Eq. 15; sams.py:634-643)."""
        t = self._iteration
        k = self.n_states
        if self._stage == 0:
            return min(np.exp(np.log(t + 1) * -0.5) * k, self.gamma0)
        return 1.0 / max(t - self._t0 + 1.0 / self.gamma0, 1.0)

    def _update_logZ_estimates(self):
        """One host update from this iteration's states and energies, the
        log weights frozen at the iteration's start (sams.py:648-691)."""
        k = self.n_states
        states = self.replica_states
        gamma = self._gamma()
        log_pi = self.log_target_probabilities
        np.add.at(self._histogram, states, 1)
        if self.weight_update_method == "optimal":
            np.add.at(self._logZ, states, gamma / np.exp(log_pi[states]))
        else:
            u = self.energies_last_iteration[:, :k]
            logp = self.log_weights[None, :] - u
            logp = logp - logsumexp(logp, axis=1, keepdims=True)
            self._logZ += gamma * np.exp(logp).sum(axis=0) / np.exp(log_pi)
        # re-referenced only in the asymptotic stage: the burn-in
        # logZ-flatness criterion reads the accumulated magnitudes
        if self._stage == 1:
            self._logZ -= self._logZ[0]
        if self._stage == 0 and self._check_flatness():
            logger.info("SAMS burn-in complete at iteration %d "
                        "(criterion %s); switching to asymptotic stage",
                        self._iteration, self.flatness_criteria)
            self._stage = 1
            self._t0 = self._iteration
            self._logZ -= self._logZ[0]

    def _check_flatness(self) -> bool:
        total = self._histogram.sum()
        if total == 0:
            return False
        if self.flatness_criteria == "minimum-visits":
            return bool(self._histogram.min() >= self.minimum_visits)
        if self.flatness_criteria == "histogram-flatness":
            target = np.exp(self.log_target_probabilities)
            empirical = self._histogram / total
            return bool(np.all(
                np.abs(empirical - target) / target
                < self.flatness_threshold))
        return bool(np.all(
            np.abs(self._logZ / self.gamma0) > self.flatness_threshold))
