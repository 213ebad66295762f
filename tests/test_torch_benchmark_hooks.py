"""The port's names that the benchmark (``benchmark/``) reaches into, held
on the CPU: the step marks of ``benchmark.workloads.step_marks`` (K2's
``evaluate``, the constraint projections, the Ewald structure factors, the
remainder's autograd), the targets that ``benchmark/faults.py`` patches,
the traffic modules' span marks and the attributes they read and write. A
refactor of the port that moves one of these names fails here, where the
benchmark would otherwise break or silently read nothing."""
import pytest
import torch

from benchmark import faults, workloads
from openmmtools_tpu_torch.integrators import BAOABIntegrator, step_graph
from openmmtools_tpu_torch.integrators.langevin import BoundIntegrator
from openmmtools_tpu_torch.mcmc import (
    LangevinDynamicsMove,
    LangevinSplittingDynamicsMove,
)
from openmmtools_tpu_torch.models import AlchemicalWaterBox
from openmmtools_tpu_torch.multistate.replicaexchange import (
    ReplicaExchangeSampler,
)
from openmmtools_tpu_torch.states import SamplerState, ThermodynamicState

LAMS = [{"lambda_sterics": 1.0, "lambda_electrostatics": 0.5},
        {"lambda_sterics": 0.5, "lambda_electrostatics": 0.0},
        {"lambda_sterics": 0.0, "lambda_electrostatics": 0.0}]


@pytest.fixture(scope="module")
def water():
    return AlchemicalWaterBox(box_edge=1.9, cutoff=0.9, device="cpu")


def _bound(water):
    bound = BAOABIntegrator(temperature=300.0, timestep=0.002,
                            collision_rate=5.0, sweep="force").bind(
        water.system)
    assert bound.sweep_mode
    return bound


def test_every_step_mark_and_fault_target_resolves(water):
    """Each (object, name) of the step marks is a callable of the bound
    integrator's program, and every fault of ``benchmark/faults.py`` can
    patch its targets (entering one reads each target) and put them back."""
    bound = _bound(water)
    marks = workloads.step_marks(bound)
    assert set(marks) == {"K2", "constraints, positions",
                          "constraints, velocities", "PME, forward",
                          "PME, backward", "remainder"}
    for label, (obj, name) in marks.items():
        assert obj is not None, label
        assert callable(getattr(obj, name)), label
    assert marks["K2"][0] is bound.force_path.kernel
    before = {name: vars(BoundIntegrator).get(name) for name in
              ("step", "run", "_constrain_positions", "_with_initial_forces")}
    assert all(before.values())
    for name, fault in faults.FAULTS.items():
        with fault():
            pass
    assert {name: vars(BoundIntegrator).get(name) for name in before} == \
        before
    # the traffic modules' span marks and what they read
    assert callable(BoundIntegrator.energies_batch)
    assert callable(LangevinSplittingDynamicsMove.apply_batch)
    assert callable(ReplicaExchangeSampler._mix_kernel)
    state = ThermodynamicState(system=water.system, temperature=300.0)
    move = LangevinDynamicsMove(timestep=0.002, n_steps=1, seed=3)
    assert callable(move.apply)
    move._get_integrator(state).sweep = "force"
    assert move._bound(state).sweep_mode


def test_the_step_marks_fire_in_a_batched_run(water, monkeypatch):
    """One ``run`` of a 3-replica batch calls K2's ``evaluate`` and both
    constraint projections through the names the marks wrap, and the Ewald
    structure factors forward and backward, which the CPU path calls too;
    the remainder's mark wraps the neighbour path's autograd, which sweep
    mode never calls."""
    bound = _bound(water)
    gens = [torch.Generator().manual_seed(5 + b) for b in range(3)]
    state = bound.initial_state_batch(
        [SamplerState(positions=water.positions)] * 3, gens,
        temperatures=[300.0, 310.0, 320.0], global_params=LAMS)
    calls = {}

    def counting(label, fn):
        def wrapped(*a, **kw):
            calls[label] = calls.get(label, 0) + 1
            return fn(*a, **kw)
        return wrapped

    for label, (obj, name) in workloads.step_marks(bound).items():
        monkeypatch.setattr(obj, name, counting(label, getattr(obj, name)))
    bound.run(state, 2)
    assert calls.get("K2", 0) >= 2
    assert calls.get("constraints, positions", 0) >= 2
    assert calls.get("constraints, velocities", 0) >= 2
    assert calls.get("PME, forward", 0) >= 1
    assert calls.get("PME, backward", 0) >= 1
    assert "remainder" not in calls


def test_a_false_graph_program_keeps_the_step_eager(water, monkeypatch):
    """``_graph_program`` is a writable instance attribute that
    ``_graph_for`` reads on every call: with every state taken for one a
    graph can hold, a graph serves it, and none once the attribute is
    False."""
    bound = _bound(water)
    assert bound._graph_program is True
    state = bound.initial_state(SamplerState(positions=water.positions),
                                torch.Generator().manual_seed(1))
    skip = bound._vproj_skip
    monkeypatch.setattr(step_graph, "signature",
                        lambda state, n_groups, skip: ("any state", skip))
    graph = bound._graph_for(state, skip)
    assert isinstance(graph, step_graph.StepGraph) and graph.graph is None
    bound._graph_program = False
    assert bound._graph_for(state, skip) is None
