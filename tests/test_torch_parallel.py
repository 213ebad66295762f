"""The port's distribution layer (``parallel/mesh.py``) on the CPU: a mesh
of 8 CPU entries stands in for 8 cards.

* ``distribute`` splits the leading axis into contiguous blocks, one a
  mesh device, runs the (batched) task on each and concatenates the
  results; ``on_single_device`` hands its function numpy arrays
  (``tests/test_cache_utils.py``'s case);
* a replica-exchange sampler with ``mesh=`` holds 8 replicas over 4 states
  (``tests/test_multistate.py``'s case) and advances exactly as one
  without a mesh;
* ``replica_mesh()`` raises without a card.
"""
import numpy as np
import pytest
import torch

from openmmtools_tpu_torch.mcmc import LangevinDynamicsMove
from openmmtools_tpu_torch.models import HarmonicOscillator
from openmmtools_tpu_torch.multistate import ReplicaExchangeSampler
from openmmtools_tpu_torch.parallel import (
    distribute,
    on_single_device,
    replica_mesh,
    replica_sharding,
    replicated_sharding,
)
from openmmtools_tpu_torch.states import (
    SamplerState,
    create_thermodynamic_state_protocol,
)

CPU8 = [torch.device("cpu")] * 8
K_LADDER = [100.0, 200.0, 400.0, 800.0]
TEMP = 300.0


def test_distribute_and_single_device():
    mesh = replica_mesh(devices=CPU8)
    assert mesh.size == 8 and mesh.shape == {"replica": 8}
    xs = torch.arange(8.0).reshape(8, 1)
    sizes = []

    def task(block):
        sizes.append(block.shape[0])
        return block * 2

    out = distribute(task, xs, mesh=mesh)
    assert torch.equal(out, xs * 2) and sizes == [1] * 8
    # an uneven split: the first devices take one item more
    sizes.clear()

    def dict_task(block):
        sizes.append(block["a"].shape[0])
        return {"a": block["a"] * 2}

    out = distribute(dict_task, {"a": torch.arange(11.0)},
                     mesh=replica_mesh(devices=CPU8[:4]))
    assert torch.equal(out["a"], torch.arange(11.0) * 2)
    assert sizes == [3, 3, 3, 2]
    assert torch.equal(distribute(task, xs), xs * 2)   # no mesh

    @on_single_device
    def analyze(arr):
        assert isinstance(arr, np.ndarray)
        return arr.sum()

    assert analyze(xs) == float(xs.sum())


def test_placement_descriptors_and_blocks():
    mesh = replica_mesh(devices=CPU8[:3], axis_name="replica")
    sharding = replica_sharding(mesh)
    assert sharding.axis_name == "replica"
    assert [list(r) for _, r in sharding.blocks(7)] == [[0, 1, 2], [3, 4],
                                                        [5, 6]]
    assert [list(r) for _, r in sharding.blocks(2)] == [[0], [1]]
    whole = replicated_sharding(mesh)
    assert whole.axis_name is None
    assert [list(r) for _, r in whole.blocks(2)] == [[0, 1]] * 3


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_replica_mesh_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replica_mesh()


def _states():
    ho = HarmonicOscillator(K=K_LADDER[0], device="cpu")
    ref = ho.thermodynamic_state(TEMP)
    states = create_thermodynamic_state_protocol(
        ref, {"testsystems_HarmonicOscillator_K": K_LADDER})
    return ho, states


def _sampler(mesh):
    ho, states = _states()
    sampler = ReplicaExchangeSampler(
        mcmc_moves=LangevinDynamicsMove(timestep=0.01, collision_rate=5.0,
                                        n_steps=5),
        number_of_iterations=3, online_analysis_interval=None, rng_seed=5)
    x = torch.as_tensor(np.asarray(ho.positions), dtype=torch.float64)
    sampler.create(states, [SamplerState(positions=x) for _ in range(8)],
                   initial_thermodynamic_states=[0, 1, 2, 3, 0, 1, 2, 3],
                   mesh=mesh)
    return sampler


def test_sharded_replica_mesh():
    """8 replicas over 4 states on an 8-entry CPU mesh: one block a
    replica, batched within each block, the same replicas and energies as
    without a mesh."""
    mesh = replica_mesh(devices=CPU8)
    sampler = _sampler(mesh)
    assert sampler.mesh is mesh
    assert sampler.propagation_route == "batched"
    assert [idx for _, idx in sampler._blocks()] == [[n] for n in range(8)]
    sampler.run()
    assert sampler.iteration == 3
    u = sampler.energies_last_iteration
    assert np.all(np.isfinite(u))
    plain = _sampler(None)
    assert [idx for _, idx in plain._blocks()] == [list(range(8))]
    plain.run()
    np.testing.assert_allclose(u, plain.energies_last_iteration,
                               rtol=1e-12)
    for a, b in zip(sampler.sampler_states, plain.sampler_states):
        np.testing.assert_allclose(a.positions.numpy(), b.positions.numpy(),
                                   rtol=1e-12, atol=1e-15)
