"""The step program as a CUDA graph (``integrators/step_graph.py``) on the
CPU: which programs a graph serves, the graph's body (one step on fixed
buffers, each output copied into its buffer) run eagerly against ``step``
to the bit, and the eager program's ATen calls, which the graph's dispatch
leaves as they were. The capture and the replays run only on the card
(``tests/test_torch_cuda.py``, ``-k graph``)."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from openmmtools_tpu_torch.integrators import (
    AlchemicalNonequilibriumLangevinIntegrator,
    AndersenVelocityVerletIntegrator,
    BAOABIntegrator,
)
from openmmtools_tpu_torch.integrators import step_graph
from openmmtools_tpu_torch.models import AlchemicalWaterBox, WaterBox
from openmmtools_tpu_torch.states import SamplerState
from openmmtools_tpu_torch.system import Constraints
from openmmtools_tpu_torch.utils import tracing

LAMS = [{"lambda_sterics": 1.0, "lambda_electrostatics": 0.5},
        {"lambda_sterics": 0.5, "lambda_electrostatics": 0.0},
        {"lambda_sterics": 0.0, "lambda_electrostatics": 0.0}]
TEMPS = [300.0, 310.0, 320.0]


@pytest.fixture(scope="module")
def water():
    return AlchemicalWaterBox(box_edge=1.9, cutoff=0.9, device="cpu")


def _sweep_bound(system, **kwargs):
    bound = BAOABIntegrator(temperature=300.0, timestep=0.002,
                            collision_rate=5.0, sweep="force",
                            **kwargs).bind(system)
    assert bound.sweep_mode
    return bound


def _gens(n, seed=11):
    return [torch.Generator().manual_seed(seed + b) for b in range(n)]


def _batch(bound, water, seed=11):
    ss = [SamplerState(positions=water.positions)] * len(LAMS)
    return bound.initial_state_batch(ss, _gens(len(LAMS), seed),
                                     temperatures=TEMPS, global_params=LAMS)


def test_sweep_mode_langevin_takes_the_graph_but_not_on_the_cpu(water):
    bound = _sweep_bound(water.system)
    assert bound._graph_program
    state = _batch(bound, water)
    assert bound._graph_for(state, bound._vproj_skip) is None
    bound.run(state, 3)
    assert bound._graphs == {}


def test_programs_with_a_host_decision_or_another_route_run_eagerly(water):
    system = water.system
    # H steps: the protocol's position is a host count
    ncmc = AlchemicalNonequilibriumLangevinIntegrator(
        alchemical_functions={"lambda_sterics": "lambda"},
        splitting="V R H O R V", sweep="force").bind(system)
    assert ncmc.sweep_mode and not ncmc._graph_program
    # a class with its own step takes neither sweep mode nor the graph
    andersen = AndersenVelocityVerletIntegrator(sweep="force").bind(system)
    assert andersen._own_step and not andersen._graph_program
    # neighbour mode (sweep off; one NonbondedTerm, from 128 atoms on the
    # CPU)
    plain = WaterBox(box_edge=1.9, cutoff=0.9, device="cpu").system
    nbr = BAOABIntegrator(sweep=None).bind(plain)
    assert nbr.neighbor_mode and not nbr._graph_program


def test_jacobi_shake_runs_eagerly():
    """A chain of nine constraints is no cluster of M-SHAKE's (at most
    eight): Jacobi SHAKE/RATTLE, iterated to a tolerance read on the
    host."""
    w = WaterBox(box_edge=1.9, cutoff=0.9, constrained=False, device="cpu")
    oxygens = torch.arange(0, 30, 3)
    index = torch.stack([oxygens[:-1], oxygens[1:]], dim=1).to(torch.int32)
    d = torch.linalg.norm(w.positions[index[:, 0].long()]
                          - w.positions[index[:, 1].long()], dim=-1)
    system = w.system.replace(constraints=Constraints(index=index,
                                                      distance=d))
    bound = _sweep_bound(system)
    assert bound.constraint_solver.host_iterated
    assert not bound._graph_program


def _same(a, b):
    assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("replicas", [3, 1])
def test_the_graph_body_equals_step_to_the_bit(water, replicas):
    """Five steps of the body on the buffers, B = 3 replicas at their own
    temperatures and lambdas (and one replica, (N, 3)), against five calls
    of ``step`` from the same state and generators: every written field,
    the step count and the generators' states afterwards."""
    bound = _sweep_bound(water.system)
    skip = bound._vproj_skip
    if replicas == 1:
        def start(seed):
            return bound.initial_state(
                SamplerState(positions=water.positions), _gens(1, seed)[0],
                temperature=TEMPS[0], global_params=LAMS[0])
    else:
        def start(seed):
            return _batch(bound, water, seed)
    eager = start(11)
    graphed = start(11)
    assert graphed.generator is not eager.generator
    g = step_graph.StepGraph(bound, graphed, skip)
    g.load(graphed)
    for _ in range(5):
        g.body()
    out = g.unload(graphed, 5)
    for _ in range(5):
        eager = bound.step(eager, skip_trailing_vproj=skip)
    for f in step_graph.WRITTEN:
        _same(getattr(out, f), getattr(eager, f))
    for a, b in zip(out.forces + out.potentials,
                    eager.forces + eager.potentials):
        _same(a, b)
    assert out.step_count == eager.step_count == 5
    assert not torch.equal(out.positions, graphed.positions)
    for a, b in zip(step_graph._generators(out),
                    step_graph._generators(eager)):
        assert torch.equal(a.get_state(), b.get_state())
    # the returned tensors are the state's own, not the buffers
    assert out.positions.data_ptr() != g.bufs.positions.data_ptr()


def test_the_body_refuses_a_step_that_changes_a_field_s_type(water,
                                                              monkeypatch):
    """A step whose output is not its buffer's shape and type leaves the
    program eager (the capture raises) where ``copy_`` would cast."""
    bound = _sweep_bound(water.system)
    g = step_graph.StepGraph(bound, _batch(bound, water), bound._vproj_skip)
    step = bound._step

    def doubled_heat(s, skip):
        out = step(s, skip)
        return out.replace(heat=out.heat.to(torch.float64))

    monkeypatch.setattr(bound, "_step", doubled_heat)
    with pytest.raises(RuntimeError, match="float64"):
        g.body()


def test_the_signature_serves_only_card_states(water):
    bound = _sweep_bound(water.system)
    state = _batch(bound, water)
    assert step_graph.signature(state, len(bound.groups), True) is None


def _aten_calls(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.name.startswith("aten::") for e in prof.events())


def test_the_eager_program_s_aten_calls_are_unchanged(water):
    """``run`` on the CPU issues the ATen calls of the eager program
    written out: the re-sort, the steps, the closing projection and the
    overflow flag's read."""
    bound = _sweep_bound(water.system)
    skip = bound._vproj_skip
    assert skip
    state = _batch(bound, water)

    def written_out():
        s = bound.force_path.refresh(state)
        for _ in range(3):
            s = bound.step(s, skip_trailing_vproj=True)
        s.replace(velocities=bound._constrain_velocities(s.positions,
                                                         s.velocities))
        bound.check_sweep_overflow(s.sweep_overflow)

    # the second reading of each: a profiler's first can miss an operator
    counts = [[_aten_calls(fn) for _ in range(2)][-1]
              for fn in (lambda: bound.run(state, 3), written_out)]
    assert counts[0] == counts[1]


# ATen calls of the eager program, pinned to the counts of the program
# before its force paths and constraint solver moved out of the integrator
# (integrators/force_paths.py, ops/constraints.ConstraintSolver): a step of
# one replica and of three, and a 3 x 3 energy matrix, on one thread. The
# matrix's fresh sort takes 3 fewer than the 7,795 it took there: the
# zeros (aten::zeros, empty, zero_) of a stand-in state's kT that nothing
# read
PINNED_ATEN_CALLS = {"step, B = 1": 3508, "step, B = 3": 6103,
                     "energies_batch, 3 x 3": 7792}


@pytest.mark.parametrize("what", sorted(PINNED_ATEN_CALLS))
def test_the_eager_program_s_aten_calls_are_pinned(water, what):
    """The count of each, the second of two readings, each from cleared
    tracing counters (a profiler turns tracing's device counts on, and a
    count's first addition copies where later ones add), on one intra-op
    thread (more threads split some operators into more calls)."""
    bound = _sweep_bound(water.system)
    skip = bound._vproj_skip
    if what == "step, B = 1":
        single = bound.initial_state(
            SamplerState(positions=water.positions), _gens(1)[0],
            temperature=TEMPS[0], global_params=LAMS[0])
        fn = lambda: bound.step(single, skip_trailing_vproj=skip)  # noqa
    elif what == "step, B = 3":
        batch = _batch(bound, water)
        fn = lambda: bound.step(batch, skip_trailing_vproj=skip)  # noqa
    else:
        x = _batch(bound, water).positions
        rep = torch.arange(3).repeat_interleave(3)
        params = {k: torch.tensor([LAMS[i % 3][k] for i in range(9)])
                  for k in LAMS[0]}
        fn = lambda: bound.energies_batch(x, None, rep, params)  # noqa
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        counts = []
        for _ in range(2):
            tracing.reset()
            counts.append(_aten_calls(fn))
    finally:
        torch.set_num_threads(threads)
    assert counts[-1] == PINNED_ATEN_CALLS[what]


def test_k2_s_launch_counts_read_as_a_mapping_of_ints():
    """K2's launch counts (``sweep_nb.LaunchCounts``) over counters that
    the kernels add to (here added to by hand, on the CPU): by kernel and
    by (kernel, batch size), the kernels' keys 0 with no launch, a set
    count an offset that later launches add to, and a clear that leaves
    the counters (a graph holds their address) as they were."""
    from openmmtools_tpu_torch.ops.sweep_nb import LaunchCounts

    cpu = torch.device("cpu")
    counters = {}
    launches = LaunchCounts(counters, lambda kernel, B: kernel,
                            ("sweep_bound", "sweep_forces"))
    batch = LaunchCounts(counters, lambda kernel, B: (kernel, B))
    assert dict(launches) == {"sweep_bound": 0, "sweep_forces": 0}
    assert dict(batch) == {}

    def launch(kernel, B, n=1):
        c = counters.setdefault((kernel, B, cpu),
                                torch.zeros((), dtype=torch.int64))
        c += n

    launch("sweep_bound", 1, 3)
    launch("sweep_bound", 9)
    assert launches == {"sweep_bound": 4, "sweep_forces": 0}
    assert dict(batch) == {("sweep_bound", 1): 3, ("sweep_bound", 9): 1}
    assert ("sweep_forces", 9) not in batch
    assert batch[("sweep_forces", 9)] == 0
    held = dict(counters)
    launches["sweep_bound"] = 10
    launch("sweep_bound", 9)
    assert launches["sweep_bound"] == 11
    assert batch[("sweep_bound", 9)] == 2
    batch.clear()
    launch("sweep_bound", 1)
    assert dict(batch) == {("sweep_bound", 1): 1}
    assert launches["sweep_bound"] == 12
    assert counters == held and int(counters[("sweep_bound", 1, cpu)]) == 4
