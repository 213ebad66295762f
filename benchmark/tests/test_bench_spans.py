"""The readers of the program's spans and counters (``metrics/spans.py``) on
a synthetic snapshot: self time on two threads, a span nested in one of
its own name counted once, per-iteration figures over the iteration spans
found, and None where a span or counter is missing."""
import types

import pytest

from benchmark import run
from benchmark.metrics import spans

MS = 1_000_000     # ns


def _snap(spans_, counters=None):
    return types.SimpleNamespace(spans=spans_, counters=counters or {},
                                 dropped=0)


def span(name, lo, hi, cause=None, thread=1):
    return (name, lo * MS, hi * MS, cause, thread)


# two iterations; the first holds the whole tree, the backward's PME on a
# second thread, a resort nested in a resort; a step outside any iteration
SPANS = [
    span("pme.forward", 210, 220, "forces.remainder"),
    span("pme.backward", 300, 330, "forces.remainder", thread=2),
    span("forces.remainder", 200, 340, "forces.sweep"),
    span("forces.sweep", 150, 350, "integrator.step"),
    span("constraints.positions", 120, 130, "integrator.step"),
    span("constraints.velocities", 360, 380, "integrator.step"),
    span("integrator.step", 100, 400, "integrator.run"),
    span("integrator.resort", 520, 540, "integrator.resort"),
    span("integrator.resort", 500, 600, "integrator.run"),
    span("integrator.run", 90, 650, "move.apply_batch"),
    span("move.apply_batch", 50, 900, "sampler.propagation"),
    span("sampler.iteration", 0, 1000),
    span("integrator.step", 2100, 2200, "integrator.run"),
    span("sampler.iteration", 2000, 3000),
    span("integrator.step", 5000, 5500),
]
COUNTERS = {"k2.rebuilds": 3, "k2.sort_sets": 12}

# the readers' expected values, ms an iteration (two iterations)
EXPECTED = {
    # 300 less the sweep's 200 and the constraints' 30 in the first
    # iteration, 100 in the second
    "step.host_ms.re": (70 + 100) / 2,
    # 140 less the forward's 10 and the backward's 30 on the other thread
    "remainder.host_ms.re": 100 / 2,
    # the nested resort counted once
    "sort.host_ms.re": 100 / 2,
    # 850 less the run's 560
    "move.host_ms.re": 290 / 2,
    "k2.rebuilds.re": 3 / 12,
    "constraints.span_ms.re": 30 / 2,
    "pme.span_ms.re": 40 / 2,
}


@pytest.fixture
def snapshot(monkeypatch):
    def use(snap):
        monkeypatch.setattr(spans, "snapshot", lambda: snap)
    return use


def test_innermost_time_on_two_threads():
    got = spans.innermost_ns(SPANS)
    assert got["forces.remainder"] == 100 * MS
    assert got["pme.backward"] == 30 * MS
    assert got["integrator.step"] == 170 * MS
    assert got["integrator.resort"] == 100 * MS
    assert got["sampler.iteration"] == (1000 - 850 + 1000 - 100) * MS
    # every instant inside an iteration counts once
    assert sum(got.values()) == 2000 * MS
    assert spans.innermost_at(SPANS, 315 * MS)[0] == "pme.backward"
    assert spans.innermost_at(SPANS, 1500 * MS) is None


def test_union_and_intersection():
    a = spans.merged([(0, 10), (5, 20), (30, 40)])
    assert a == [[0, 20], [30, 40]]
    assert spans.intersect(a, [[15, 35]]) == [[15, 20], [30, 35]]
    assert spans.length(spans.intersect(a, [[15, 35]])) == 10


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_each_reader_on_a_synthetic_snapshot(metric, snapshot):
    snapshot(_snap(SPANS, COUNTERS))
    got = run.load_metric(metric).read(None)
    assert got == pytest.approx(EXPECTED[metric], rel=1e-12)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_each_reader_gives_none_without_its_span_or_counter(metric,
                                                             snapshot):
    snapshot(None)
    assert run.load_metric(metric).read(None) is None
    snapshot(_snap([], {}))
    assert run.load_metric(metric).read(None) is None
    # only the iteration spans: none of the metric's own
    snapshot(_snap([span("sampler.iteration", 0, 10)],
                   {"k2.sort_sets": 0, "k2.rebuilds": 0}))
    assert run.load_metric(metric).read(None) is None


def test_without_an_iteration_span_a_time_is_none(snapshot):
    snapshot(_snap([s for s in SPANS if s[0] != "sampler.iteration"]))
    assert run.load_metric("step.host_ms.re").read(None) is None


def test_the_program_s_snapshot_is_read():
    from openmmtools_tpu_torch.utils import tracing

    tracing.reset()
    tracing.enable()
    try:
        with tracing.span("sampler.iteration"):
            with tracing.span("integrator.resort"):
                pass
    finally:
        tracing.disable()
    try:
        assert run.load_metric("sort.host_ms.re").read(None) > 0
    finally:
        tracing.reset()
