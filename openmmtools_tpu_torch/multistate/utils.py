"""Timeseries analysis helpers (the port's own copy of
``multistate/utils.py``): statistical inefficiency, equilibration
detection, subsampling.

Native replacements for the pymbar.timeseries functions the reference wraps
in ``multistate/utils.py`` (get_equilibration_data_per_sample :107,
remove_unequilibrated_data :238, subsample_data_along_axis :269) and for
``SimulationNaNError`` (:51). Algorithms follow Chodera et al. JCTC 2007
(statistical inefficiency via the integrated autocorrelation time with the
Geyer-style positivity cutoff and the (1 - t/T) bias correction) and
Chodera JCTC 2016 (equilibration detection by maximizing effective samples).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


class SimulationNaNError(Exception):
    """Raised when energies/positions go NaN (multistate/utils.py:51)."""


def statistical_inefficiency(a_t: np.ndarray, fast: bool = False,
                             mintime: int = 3) -> float:
    """g = 1 + 2 sum_t C(t) (1 - t/T), truncated at the first non-positive
    autocorrelation beyond ``mintime``. Returns g >= 1."""
    a_t = np.asarray(a_t, dtype=np.float64)
    n = a_t.shape[0]
    if n < 3:
        return 1.0
    mu = a_t.mean()
    da = a_t - mu
    var = (da * da).mean()
    if var <= 0.0:
        return 1.0
    g = 1.0
    t = 1
    increment = 1
    while t < n - 1:
        c = np.mean(da[: n - t] * da[t:]) / var
        if c <= 0.0 and t > mintime:
            break
        g += 2.0 * c * (1.0 - t / n) * increment
        t += increment
        if fast:
            increment += 1  # geometric-ish acceleration for long series
    return max(g, 1.0)


def detect_equilibration(a_t: np.ndarray, nskip: int = 1
                         ) -> Tuple[int, float, float]:
    """Pick t0 maximizing the effective sample count of a_t[t0:]
    (pymbar.timeseries.detect_equilibration analog). Returns
    (t0, g, n_effective)."""
    a_t = np.asarray(a_t, dtype=np.float64)
    n = a_t.shape[0]
    if n < 3 or np.allclose(a_t, a_t[0]):
        return 0, 1.0, float(max(n, 1))
    t0s = np.arange(0, n - 2, nskip)
    best = (0, 1.0, 0.0)
    for t0 in t0s:
        g = statistical_inefficiency(a_t[t0:], fast=True)
        n_eff = (n - t0) / g
        if n_eff > best[2]:
            best = (int(t0), float(g), float(n_eff))
    return best


def subsample_correlated_data(a_t: np.ndarray, g: float = None) -> np.ndarray:
    """Indices of an effectively-uncorrelated subsample (stride ceil(g))."""
    a_t = np.asarray(a_t)
    n = a_t.shape[0]
    if g is None:
        g = statistical_inefficiency(a_t)
    stride = max(int(np.ceil(g)), 1)
    return np.arange(0, n, stride)


def remove_unequilibrated_data(data: np.ndarray, n_equilibration: int,
                               axis: int = 0) -> np.ndarray:
    """Drop the first n_equilibration frames along ``axis``
    (multistate/utils.py:238)."""
    slices = [slice(None)] * data.ndim
    slices[axis] = slice(n_equilibration, None)
    return np.asarray(data)[tuple(slices)]


def subsample_data_along_axis(data: np.ndarray, uncorrelated_indices,
                              axis: int = 0) -> np.ndarray:
    """Take the given frame indices along ``axis`` (multistate/utils.py:269)."""
    return np.take(np.asarray(data), np.asarray(uncorrelated_indices,
                                                dtype=np.int64), axis=axis)


def get_equilibration_data_per_sample(timeseries_to_analyze: np.ndarray,
                                      fast: bool = True, nskip: int = 1):
    """(t0, g, n_effective) sweep used by the analyzer
    (multistate/utils.py:107)."""
    return detect_equilibration(timeseries_to_analyze, nskip=nskip)
