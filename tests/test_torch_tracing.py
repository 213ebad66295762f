"""The program's spans and counters (``openmmtools_tpu_torch.utils.tracing``),
on the CPU.

A replica-exchange iteration of the small alchemical water box (648 atoms,
three states, sweep mode forced, SETTLE and PME) runs on two samplers built
alike, one with tracing off and one with it on:

* off, no profiler range is constructed (constructing one raises here),
  nothing is recorded, and the operations are those of the run with
  tracing on less the counter's own (one an evaluation: an in-place add,
  a copy the first time);
* the positions, velocities and energy matrix are equal to the bit;
* on, one iteration gives the spans of the table in
  ``utils/tracing.py``, each as often as the step program makes it and
  under its cause, and the counters count the evaluations' sort sets.

Besides: the spans' clock against the profiler's ranges, a span's cause
on a thread with none open, the buffer's bound, the device counters read
once, and tracing on exactly while a profiler records.
"""
import collections
import threading

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from openmmtools_tpu_torch.alchemy import AlchemicalState
from openmmtools_tpu_torch.mcmc import LangevinSplittingDynamicsMove
from openmmtools_tpu_torch.models import AlchemicalWaterBox
from openmmtools_tpu_torch.multistate import ReplicaExchangeSampler
from openmmtools_tpu_torch.states import (
    CompoundThermodynamicState,
    ThermodynamicState,
    create_thermodynamic_state_protocol,
)
from openmmtools_tpu_torch.utils import tracing

N_STEPS = 4
SORT_INTERVAL = 3
LADDER = {"lambda_electrostatics": [1.0, 0.5, 0.0],
          "lambda_sterics": [1.0, 1.0, 0.5]}


@pytest.fixture(autouse=True)
def _fresh():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _sampler():
    ts = AlchemicalWaterBox(box_edge=1.9, cutoff=0.9, device="cpu")
    ref = CompoundThermodynamicState(
        base_state=ThermodynamicState(system=ts.system, temperature=300.0),
        composable_states=(AlchemicalState(lambda_electrostatics=1.0,
                                           lambda_sterics=1.0),))
    states = create_thermodynamic_state_protocol(ref, LADDER)
    move = LangevinSplittingDynamicsMove(
        timestep=0.002, collision_rate=1.0, n_steps=N_STEPS,
        splitting="V R O R V")
    integ = move._get_integrator(states[0])
    integ.sweep = "force"
    integ.sweep_sort_interval = SORT_INTERVAL
    sampler = ReplicaExchangeSampler(
        mcmc_moves=move, number_of_iterations=10,
        online_analysis_interval=None, replica_mixing_scheme="swap-all",
        rng_seed=2 ** 31 + 19)
    sampler.create(states, ts.sampler_state())
    assert sampler.propagation_route == "batched"
    assert move._bound(states[0]).sweep_mode
    return sampler


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _refuse(*args, **kwargs):
    raise AssertionError("a profiler range was constructed")


@pytest.fixture(scope="module")
def runs():
    """One iteration of each of two equal samplers, tracing off and on,
    under an operation count; no profiler range may be constructed."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch._C._profiler, "_RecordFunctionFast", _refuse)
        mp.setattr(torch.autograd.profiler, "record_function", _refuse)
        mp.setattr(torch.profiler, "record_function", _refuse)
        for on in (False, True):
            tracing.disable()
            tracing.reset()
            sampler = _sampler()
            if on:
                tracing.enable()
            with _Ops() as counted:
                sampler.run(1)
            tracing.disable()
            out[on] = dict(sampler=sampler, ops=counted.ops,
                           snapshot=tracing.snapshot())
    tracing.reset()
    return out


def test_off_path_records_nothing_and_adds_no_operation(runs):
    off, on = runs[False], runs[True]
    assert off["snapshot"].spans == [] and off["snapshot"].counters == {}
    assert off["snapshot"].dropped == 0
    assert not off["ops"] - on["ops"]
    extra = on["ops"] - off["ops"]
    evaluations = sum(s[0] == "forces.sweep" for s in on["snapshot"].spans)
    assert extra == {"aten._to_copy.default": 1,
                     "aten.add_.Tensor": evaluations - 1}, extra


def test_results_equal_to_the_bit_with_tracing_on_and_off(runs):
    a, b = runs[False]["sampler"], runs[True]["sampler"]
    for sa, sb in zip(a.sampler_states, b.sampler_states):
        assert torch.equal(sa.positions, sb.positions)
        assert torch.equal(sa.velocities, sb.velocities)
    assert (a.energies_last_iteration == b.energies_last_iteration).all()
    assert (a.replica_states == b.replica_states).all()


def test_one_iteration_gives_the_span_tree(runs):
    snap = runs[True]["snapshot"]
    n_rep, k_states = 3, len(LADDER["lambda_sterics"])
    counts = collections.Counter(s[0] for s in snap.spans)
    causes = collections.defaultdict(set)
    for name, _, _, cause, _ in snap.spans:
        causes[name].add(cause)
    evaluations = N_STEPS + 2       # the initial forces, each step, matrix
    resorts = 1 + -(-N_STEPS // SORT_INTERVAL) + 1
    assert counts == {
        "sampler.iteration": 1, "sampler.mixing": 1,
        "sampler.propagation": 1, "sampler.energy_matrix": 1,
        "sampler.report": 1, "move.apply_batch": 1, "move.nan_check": 1,
        "integrator.initial_state": 1, "integrator.run": 1,
        "integrator.sampler_states": 1, "integrator.step": N_STEPS,
        "integrator.overflow_check": 2, "integrator.energies_batch": 1,
        "integrator.resort": resorts, "forces.sweep": evaluations,
        "k2.evaluate": evaluations, "forces.remainder": evaluations,
        # one a configuration: each replica an evaluation with forces,
        # and every (replica, state) pair of the matrix
        "pme.forward": n_rep * (N_STEPS + 1) + n_rep * k_states,
        "pme.backward": n_rep * (N_STEPS + 1),
        # two R substeps a step; V, O and V project, less the trailing
        # projection, which the run's end makes once
        "constraints.positions": 2 * N_STEPS,
        "constraints.velocities": 2 * N_STEPS + 1,
    }, counts
    assert causes == {
        "sampler.iteration": {None},
        "sampler.mixing": {"sampler.iteration"},
        "sampler.propagation": {"sampler.iteration"},
        "sampler.energy_matrix": {"sampler.iteration"},
        "sampler.report": {"sampler.iteration"},
        "move.apply_batch": {"sampler.propagation"},
        "move.nan_check": {"move.apply_batch"},
        "integrator.initial_state": {"move.apply_batch"},
        "integrator.run": {"move.apply_batch"},
        "integrator.sampler_states": {"move.apply_batch"},
        "integrator.step": {"integrator.run"},
        "integrator.overflow_check": {"integrator.run",
                                      "sampler.energy_matrix"},
        "integrator.energies_batch": {"sampler.energy_matrix"},
        "integrator.resort": {"integrator.initial_state", "integrator.run",
                              "integrator.energies_batch"},
        "forces.sweep": {"integrator.initial_state", "integrator.step",
                         "integrator.energies_batch"},
        "k2.evaluate": {"forces.sweep"},
        "forces.remainder": {"forces.sweep"},
        "pme.forward": {"forces.remainder"},
        "pme.backward": {"forces.remainder"},
        "constraints.positions": {"integrator.step"},
        "constraints.velocities": {"integrator.step", "integrator.run"},
    }, causes
    # every span lies inside its iteration, and each nests in time inside
    # a span of its cause's name
    (it,) = [s for s in snap.spans if s[0] == "sampler.iteration"]
    for name, lo, hi, cause, _ in snap.spans:
        assert it[1] <= lo <= hi <= it[2]
        if cause is not None:
            assert any(s[0] == cause and s[1] <= lo and hi <= s[2]
                       for s in snap.spans), name
    # one SETTLE call a constraints span (a batch whole), and on the CPU
    # no kernel launch
    assert snap.counters == {"k2.sort_sets": n_rep * evaluations,
                             "k2.rebuilds": snap.counters["k2.rebuilds"],
                             "integrator.steps": N_STEPS,
                             "constraints.settle": 4 * N_STEPS + 1}
    assert resorts * n_rep <= snap.counters["k2.rebuilds"] <= \
        n_rep * evaluations


def test_spans_start_on_the_profiler_clock():
    """Under a CPU profile each span opens a profiler range of its name,
    and starts within 100 us of it."""
    from torch.profiler import ProfilerActivity, profile

    assert not tracing.enabled()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.enabled()
        for i in range(30):
            with tracing.span("clock.outer"):
                torch.ones(64).sum()
                with tracing.span("clock.inner"):
                    torch.ones(64).cumsum(0)
    assert not tracing.enabled()
    ranges = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("clock."):
            ranges[e.name()].append(e.start_ns())
    spans = collections.defaultdict(list)
    for name, lo, *_ in tracing.snapshot().spans:
        spans[name].append(lo)
    assert set(spans) == set(ranges) == {"clock.outer", "clock.inner"}
    for name in spans:
        assert len(spans[name]) == len(ranges[name]) == 30
        for lo, r in zip(sorted(spans[name]), sorted(ranges[name])):
            assert abs(lo - r) <= 100_000, (name, lo - r)


def test_a_thread_with_no_open_span_takes_the_program_s_innermost():
    """As autograd's device worker does: a span opened on another thread
    while the caller waits inside its own span has that span as cause."""
    tracing.enable()
    with tracing.span("caller"):
        worker = threading.Thread(target=lambda: tracing.span(
            "worker").__enter__().__exit__(None, None, None))
        worker.start()
        worker.join()
        with tracing.span("after"):
            pass
    spans = {s[0]: s for s in tracing.snapshot().spans}
    assert spans["worker"][3] == "caller"
    assert spans["worker"][4] != threading.get_ident()
    assert spans["after"][3] == "caller"
    assert spans["caller"][3] is None


def test_the_buffer_keeps_the_newest_spans_and_counts_the_dropped(
        monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 8)
    tracing.reset()
    tracing.enable()
    for i in range(20):
        with tracing.span(f"s{i}"):
            pass
    snap = tracing.snapshot()
    assert [s[0] for s in snap.spans] == [f"s{i}" for i in range(12, 20)]
    assert snap.dropped == 12
    tracing.reset()
    snap = tracing.snapshot()
    assert snap.spans == [] and snap.dropped == 0


def test_snapshot_reads_the_device_counters_once(monkeypatch):
    reads = []
    real = tracing._read

    def read(values):
        reads.append(values.shape)
        return real(values)

    monkeypatch.setattr(tracing, "_read", read)
    tracing.count("off", torch.ones(3, dtype=torch.bool))
    tracing.enable()
    for _ in range(3):
        tracing.count("flags", torch.tensor([True, False, True]))
    tracing.count("flags", torch.tensor([True, True]))
    tracing.count("ints", torch.arange(5, dtype=torch.int32))
    tracing.count("host", 4)
    tracing.count("host", 3)
    snap = tracing.snapshot()
    assert snap.counters == {"flags": 8, "ints": 10, "host": 7}
    assert reads == [(3,)]


def test_held_counts_are_kept_out_of_the_counters_on_or_off():
    """Inside ``held`` every count, tracing on or off, goes to the block's
    list (a graph's capture); recounted outside, they add as usual."""
    flags = torch.tensor([True, False, True])
    with tracing.held() as held:
        tracing.count("k2.rebuilds", flags)
        tracing.count("k2.sort_sets", 3)
    tracing.enable()
    with tracing.held() as inner:
        tracing.count("k2.sort_sets", 3)
    assert held == [("k2.rebuilds", flags), ("k2.sort_sets", 3)]
    assert inner == [("k2.sort_sets", 3)]
    assert tracing.snapshot().counters == {}
    for _ in range(2):
        for name, n in held:
            tracing.count(name, n)
    assert tracing.snapshot().counters == {"k2.rebuilds": 4,
                                           "k2.sort_sets": 6}


def test_off_a_span_is_one_shared_no_op():
    assert not tracing.enabled()
    assert tracing.span("a") is tracing.span("b")
    with tracing.span("a"):
        pass
    tracing.count("c", 1)
    assert tracing.snapshot() == ([], {}, 0)


def test_threads_lose_no_span_and_no_count(monkeypatch):
    """Spans and host counts from more threads than cores, switching
    often: every one is kept or counted as dropped."""
    import os
    import sys

    monkeypatch.setattr(tracing, "CAPACITY", 1000)
    tracing.reset()
    tracing.enable()
    n_threads, each = 2 * (os.cpu_count() or 1) + 2, 500
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with tracing.span("t"):
                    tracing.count("n", 1)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    snap = tracing.snapshot()
    assert snap.counters == {"n": n_threads * each}
    assert len(snap.spans) == 1000
    assert len(snap.spans) + snap.dropped == n_threads * each
