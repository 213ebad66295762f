"""Parallel tempering: replica exchange over a temperature ladder with the
O(N) energy matrix (counterpart of ``multistate/paralleltempering.py``).

One reference state at K temperatures: the states differ only in beta, so
an iteration's energy matrix evaluates U(x_n) once a replica, and the base
sampler's assembly gives u_k = beta_k (U + p_k V) (paralleltempering.py:
175-238). U(x_n) comes from the first integrator move's bound integrator
(``energies_batch``, every replica of a block at its own state in one
batch) where it is in sweep mode or the system has ``DENSE_LIMIT`` atoms
or more: on the card that is one launch of each sweep kernel for all the
replicas, and a large system never takes the dense sum. Otherwise (a small
system, the fused LJ path, no integrator move) it is the system's dense
energy at the replica's state. The initial matrix (create, minimize) takes
the generic path.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from openmmtools_tpu_torch.mcmc import _resolve
from openmmtools_tpu_torch.multistate.replicaexchange import (
    ReplicaExchangeSampler,
)
from openmmtools_tpu_torch.system import (
    DENSE_LIMIT,
    make_energy_fn,
    refuse_dense,
)


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

    def _block_potentials(self, device, replicas, cols_of, windowed):
        """An iteration's O(N) potentials: U(x_n) once at the replica's own
        state, for every column (see the module docstring for the path);
        the matrix of create and minimize takes the generic path."""
        if not windowed:
            return super()._block_potentials(device, replicas, cols_of,
                                             windowed)
        system = self._states_on(device)[0].system
        sss = [self._sampler_states[n] for n in replicas]
        own = [int(self._replica_states[n]) for n in replicas]
        bound = self._matrix_bound(device)
        if bound is not None and (bound.force_path.batches_energies
                                  or system.n_particles >= DENSE_LIMIT):
            x = torch.stack([ss.positions for ss in sss])
            boxes = [ss.box_vectors for ss in sss]
            table = self._param_table(x.device, x.dtype)
            own_t = torch.as_tensor(own, device=x.device)
            U, overflow = bound.energies_batch(
                x, None if boxes[0] is None else torch.stack(boxes),
                torch.arange(len(sss), device=x.device),
                {k: v[own_t] for k, v in table.items()})
            return [u.expand(len(cols)) for u, cols in zip(U, cols_of)], \
                overflow
        out = []
        for ss, s, cols in zip(sss, own, cols_of):
            x = ss.positions
            refuse_dense(system, x, "parallel tempering's O(N) energies")
            params = self._params_on(x.device, x.dtype)[s]
            U = make_energy_fn(system)(x, ss.box_vectors, params)
            out.append(U.to(torch.float64).expand(len(cols)))
        return out, None
