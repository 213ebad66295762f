"""Parallel tempering: replica exchange over a temperature ladder with the
O(N) energy matrix (counterpart of ``multistate/paralleltempering.py``).

One reference state at K temperatures: the states differ only in beta, so
an iteration's energy matrix evaluates U(x_n) once a replica, by the
system's dense energy function at the replica's state, and the base
sampler's assembly gives u_k = beta_k (U + p_k V) (paralleltempering.py:
175-238). The initial matrix (create, minimize) takes the generic path.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from openmmtools_tpu_torch.mcmc import _resolve
from openmmtools_tpu_torch.multistate.replicaexchange import (
    ReplicaExchangeSampler,
)
from openmmtools_tpu_torch.multistate.sampler import refuse_dense
from openmmtools_tpu_torch.system import make_energy_fn


def temperature_ladder(min_temperature, max_temperature, n_temperatures):
    """The reference's exponentially spaced ladder: T_i = T_min + (T_max -
    T_min) (exp(i / (n - 1)) - 1) / (e - 1)."""
    tmin, tmax = float(min_temperature), float(max_temperature)
    return list(tmin + (tmax - tmin)
                * (np.exp(np.linspace(0, 1, n_temperatures)) - 1.0)
                / (np.e - 1.0))


class ParallelTemperingSampler(ReplicaExchangeSampler):
    """Replica exchange over a temperature ladder (paralleltempering.py:44)."""

    def create(self, thermodynamic_state, sampler_states, storage=None,
               temperatures: Optional[Sequence[float]] = None,
               min_temperature: Optional[float] = None,
               max_temperature: Optional[float] = None,
               n_temperatures: Optional[int] = None, **kwargs):
        """Create from one reference state and explicit ``temperatures``,
        or the ladder of ``n_temperatures`` from ``min_temperature`` to
        ``max_temperature`` (paralleltempering.py:109)."""
        if isinstance(thermodynamic_state, (list, tuple)):
            raise ValueError(
                "ParallelTemperingSampler.create takes a single reference "
                "thermodynamic state (paralleltempering.py:109)")
        if temperatures is not None:
            temps = [float(t) for t in temperatures]
        elif None not in (min_temperature, max_temperature, n_temperatures):
            temps = temperature_ladder(min_temperature, max_temperature,
                                       n_temperatures)
        else:
            raise ValueError("give either temperatures or "
                             "min/max_temperature + n_temperatures")
        reference = _resolve(thermodynamic_state)
        states = [reference.replace(temperature=float(t)) for t in temps]
        super().create(states, sampler_states, storage=storage, **kwargs)

    def _columns(self, state_index: int, windowed: bool):
        """Every state: the O(N) matrix has no window."""
        return super()._columns(state_index, windowed=False)

    def _potentials(self, ss, cols, state_index, windowed):
        """An iteration's O(N) potentials: U(x_n) once, by the dense energy
        at the replica's own state, for every column; the matrix of create
        and minimize takes the generic path."""
        if not windowed:
            return super()._potentials(ss, cols, state_index, windowed)
        system = self._thermodynamic_states[0].system
        x = ss.positions
        refuse_dense(system, x, "parallel tempering's O(N) energies")
        params = self._params_on(x.device, x.dtype)[state_index]
        U = make_energy_fn(system)(x, ss.box_vectors, params)
        return U.to(torch.float64).expand(len(cols))
