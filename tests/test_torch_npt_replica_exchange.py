"""NPT replica exchange through the port's sampler, on the CPU
(``tests/test_multistate_moves.py``'s NPT tests, at their sizes and
bounds): ``SequenceMove([LangevinDynamicsMove, MonteCarloBarostatMove])``
over a temperature ladder of the ideal gas at its pressure.

* <V> at each state matches the exact (N + 1) kT / p within max(5 SEM,
  5 %), and the barostat's counts are what the run proposed;
* the energy matrix takes each replica's own box;
* 3 iterations, a checkpoint, a resume and 3 more equal 6 straight
  iterations bit for bit, the boxes included.
"""
import math

import numpy as np
import pytest
import torch

from openmmtools_tpu_torch.constants import BAR_TO_KJ_PER_MOL_NM3, kB
from openmmtools_tpu_torch.mcmc import (
    LangevinDynamicsMove,
    MonteCarloBarostatMove,
    SequenceMove,
)
from openmmtools_tpu_torch.models import IdealGas
from openmmtools_tpu_torch.multistate import (
    MultiStateReporter,
    ReplicaExchangeSampler,
)
from openmmtools_tpu_torch.system import volume

TEMPS = (300.0, 350.0, 400.0)


def _npt_gas_states(n):
    gas = IdealGas(nparticles=n, device="cpu")
    states = [gas.thermodynamic_state(t, pressure=gas.pressure0)
              for t in TEMPS]
    return gas, states


def _npt_move(n_steps=5, volume_scale=0.25, n_attempts=3):
    return SequenceMove([
        LangevinDynamicsMove(timestep=0.002, n_steps=n_steps),
        MonteCarloBarostatMove(volume_scale=volume_scale,
                               n_attempts=n_attempts),
    ])


def test_npt_remd_ideal_gas_volume_per_state():
    """<V> at each state of the ladder against the ideal gas's exact
    (N + 1) kT / p (multistatesampler.py:63 with mcmc.py:1597)."""
    n, n_iterations, burn_in, block = 32, 2000, 500, 50
    gas, states = _npt_gas_states(n)
    sampler = ReplicaExchangeSampler(
        mcmc_moves=_npt_move(), number_of_iterations=n_iterations,
        online_analysis_interval=None, iterations_per_sync=block,
        rng_seed=11)
    sampler.create(states, [gas.sampler_state()], storage=None)
    assert sampler.propagation_route == "batched"

    vols = {k: [] for k in range(len(TEMPS))}
    for it in range(block, n_iterations + 1, block):
        sampler.run(block)
        if it <= burn_in:
            continue
        s = sampler.replica_states
        for r, ss in enumerate(sampler.sampler_states):
            vols[int(s[r])].append(float(volume(ss.box_vectors)))

    stats = sampler.move_statistics
    assert stats.shape == (1, 2)
    acc, prop = stats[0]
    assert prop == n_iterations * 3 * len(TEMPS)
    assert 0.3 < acc / prop <= 1.0

    for k, t in enumerate(TEMPS):
        v_expected = (n + 1) * kB * t / (gas.pressure0
                                         * BAR_TO_KJ_PER_MOL_NM3)
        v_mean = np.mean(vols[k])
        sem = np.std(vols[k]) / math.sqrt(len(vols[k]))
        assert abs(v_mean - v_expected) < max(5 * sem, 0.05 * v_expected), (
            f"state {k}: <V>={v_mean:.1f} expected {v_expected:.1f} "
            f"sem {sem:.1f}")
    # swaps happened across the ladder
    assert int(sampler._n_accepted.sum()) > 0


def test_npt_energy_matrix_uses_replica_boxes():
    """u[r, k] = beta_k [U(x_r; box_r) + p_k V_r] with each replica's own
    box after its move (multistatesampler.py:1437)."""
    gas, states = _npt_gas_states(16)
    sampler = ReplicaExchangeSampler(
        mcmc_moves=_npt_move(n_steps=3, n_attempts=2),
        number_of_iterations=10, online_analysis_interval=None, rng_seed=5)
    sampler.create(states, [gas.sampler_state()], storage=None)
    sampler.run()
    boxes = [ss.box_vectors for ss in sampler.sampler_states]
    assert not torch.equal(boxes[0], boxes[1])
    u = sampler.energies_last_iteration
    for r, ss in enumerate(sampler.sampler_states):
        for k, ts in enumerate(states):
            expected = float(ts.reduced_potential(ss))
            assert np.isclose(u[r, k], expected, rtol=1e-5, atol=1e-5), (
                r, k, u[r, k], expected)


def test_npt_remd_checkpoint_resume_bitwise(tmp_path):
    """3 iterations, a checkpoint, a resume and 3 more equal 6 straight
    iterations bit for bit, the per-replica boxes included (the checkpoint
    stores the boxes; each replica's stream continues where it
    stopped)."""
    pytest.importorskip("h5py")
    gas, states = _npt_gas_states(16)

    def fresh(storage=None):
        s = ReplicaExchangeSampler(
            mcmc_moves=_npt_move(n_steps=3, n_attempts=2),
            number_of_iterations=6, online_analysis_interval=None,
            rng_seed=7)
        s.create(states, [gas.sampler_state()], storage=storage)
        return s

    straight = fresh()
    straight.run()

    path = str(tmp_path / "npt-split.h5")
    first = fresh(storage=MultiStateReporter(path, checkpoint_interval=1))
    first.run(3)
    first._reporter.close()
    resumed = ReplicaExchangeSampler.from_storage(
        MultiStateReporter(path, checkpoint_interval=1), device="cpu")
    assert resumed.iteration == 3
    assert all(ss.box_vectors is not None for ss in resumed.sampler_states)
    resumed.run(3)

    for a, b in zip(straight.sampler_states, resumed.sampler_states):
        assert torch.equal(a.positions, b.positions)
        assert torch.equal(a.velocities, b.velocities)
        assert torch.equal(a.box_vectors, b.box_vectors)
    np.testing.assert_array_equal(straight.energies_last_iteration,
                                  resumed.energies_last_iteration)
    np.testing.assert_array_equal(straight.replica_states,
                                  resumed.replica_states)
    # the boxes moved: the barostat ran
    assert not torch.equal(straight.sampler_states[0].box_vectors,
                           gas.system.default_box)
    resumed._reporter.close()
