"""The readers of ``water-md``'s per-layer metrics on synthetic traces and
snapshots: ``step.kernels.md`` counts every device activity of the traced
iteration over the steps the program counted, ``move.host_ms.md`` leaves
``integrator.run`` out of ``move.apply``, ``step.graphed_share.md`` reads
the share of replayed steps, ``device.idle.md`` the idle share and
``k2.roofline.md`` K2's standard kernel against the pairs inside the
cutoff, and the eager rest's readers (``sort.host_ms.md``,
``pme.span_ms.md``, ``constraints.span_ms.md``, ``step.host_ms.md``,
``k2.rebuilds.md``, ``step.aten_calls.md``) their spans, counters and ATen
calls an iteration; each gives None where it finds nothing to read."""
import types

import pytest

from benchmark import run, trace
from benchmark.metrics import pairs, spans, work
from benchmark.reference import forcefield
from benchmark.tests.test_bench_reference import TIP3P, water

MS = 1_000_000     # ns


def _snap(spans_=(), counters=None):
    return types.SimpleNamespace(spans=list(spans_), counters=counters or {},
                                 dropped=0)


def span(name, lo, hi, cause=None, thread=1):
    return (name, lo * MS, hi * MS, cause, thread)


def _trace(work_, wall_s=1.0, units=1, aten_calls=0):
    return trace.Trace(wall_s=wall_s, units=units, work=list(work_),
                       ranges=[], aten_calls=aten_calls)


@pytest.fixture
def snapshot(monkeypatch):
    def use(snap):
        monkeypatch.setattr(spans, "snapshot", lambda: snap)
    return use


def read(metric, ctx=None):
    return run.load_metric(metric).read(ctx)


# kernels, a copy and a fill: every activity counts, launched anywhere
WORK = [("sweep_forces_kernel<false>", 0, 10, "K2"),
        ("void at::native::elementwise_kernel<...>", 10, 12, "other"),
        ("Memcpy DtoD (Device -> Device)", 12, 13, "other"),
        ("Memset (Device)", 13, 14, "propagation"),
        ("sweep_bound_kernel<true>", 20, 25, "other")]


def test_step_kernels_counts_every_device_activity(snapshot):
    snapshot(_snap(counters={"integrator.steps": 2,
                             "integrator.graph_steps": 1}))
    ctx = types.SimpleNamespace(trace=_trace(WORK))
    assert read("step.kernels.md", ctx) == pytest.approx(5 / 2, rel=1e-12)


@pytest.mark.parametrize("snap, tr", [
    (None, _trace(WORK)),                                   # no tracing
    (_snap(counters={}), _trace(WORK)),                     # no step
    (_snap(counters={"integrator.steps": 0}), _trace(WORK)),
    (_snap(counters={"integrator.steps": 3}), None),        # no trace
])
def test_step_kernels_is_none_without_steps_or_trace(snap, tr, snapshot):
    snapshot(snap)
    assert read("step.kernels.md", types.SimpleNamespace(trace=tr)) is None


# two iterations of the single-chain path; the second's move restarted
# once, so it holds two runs
MOVE_SPANS = [
    span("integrator.initial_state", 60, 90, "move.apply"),
    span("integrator.step", 100, 400, "integrator.run"),
    span("integrator.run", 100, 700, "move.apply"),
    span("integrator.sampler_states", 700, 710, "move.apply"),
    span("move.nan_check", 710, 800, "move.apply"),
    span("move.apply", 50, 900, "sampler.iteration"),
    span("sampler.iteration", 0, 1000),
    span("integrator.run", 2100, 2200, "move.apply"),
    span("integrator.run", 2300, 2500, "move.apply"),
    span("move.apply", 2050, 2600, "sampler.iteration"),
    span("sampler.iteration", 2000, 3000),
    # a batch's spans are another metric's
    span("move.apply_batch", 4000, 4500),
]


def test_move_host_ms_leaves_the_run_out(snapshot):
    snapshot(_snap(MOVE_SPANS))
    # (850 - 600) and (550 - 100 - 200) ms over two iterations
    assert read("move.host_ms.md") == pytest.approx((250 + 250) / 2,
                                                     rel=1e-12)


@pytest.mark.parametrize("snap", [
    None, _snap(), _snap([span("sampler.iteration", 0, 10),
                          span("move.apply_batch", 1, 9)])])
def test_move_host_ms_is_none_without_a_move_apply_span(snap, snapshot):
    snapshot(snap)
    assert read("move.host_ms.md") is None


@pytest.mark.parametrize("counters, share", [
    ({"integrator.steps": 250, "integrator.graph_steps": 250}, 100.0),
    ({"integrator.steps": 250, "integrator.graph_steps": 249}, 99.6),
    ({"integrator.steps": 250}, 0.0),
])
def test_step_graphed_share(counters, share, snapshot):
    snapshot(_snap(counters=counters))
    assert read("step.graphed_share.md") == pytest.approx(share, rel=1e-12)


@pytest.mark.parametrize("snap", [None, _snap(),
                                  _snap(counters={"integrator.steps": 0})])
def test_step_graphed_share_is_none_without_steps(snap, snapshot):
    snapshot(snap)
    assert read("step.graphed_share.md") is None


def test_device_idle_is_the_share_outside_the_activities():
    # busy 0-14 and 20-25 ns of a 100 ns window (overlaps counted once)
    ctx = types.SimpleNamespace(trace=_trace(WORK + [("x", 5, 8, "")],
                                             wall_s=100e-9))
    assert read("device.idle.md", ctx) == pytest.approx(81.0, rel=1e-9)
    assert read("device.idle.md", types.SimpleNamespace(trace=None)) is None


def test_k2_roofline_of_one_trajectory():
    """K2's standard kernel's 10 ns against the least time of the pairs
    inside the cutoff of one configuration (counted here by the cell list)
    for each of the iteration's evaluations; the bound kernel and the
    rest are not K2's force kernel."""
    x, edge = water(n_side=5, edge=1.6)
    spec = forcefield.water_spec(len(x) // 3, edge, TIP3P, 0.7, 5e-4, 0.1)
    n_pairs = pairs.cell_list(x, edge, spec.cutoff, spec.exception_pairs)
    ctx = types.SimpleNamespace(
        trace=_trace(WORK, units=2), spec=spec, device="cpu",
        outputs={"x0": x, "box_edge": edge}, evaluations_per_unit=4)
    least = work.least_seconds(n_pairs, spec.n_atoms)
    assert read("k2.roofline.md", ctx) == pytest.approx(
        100.0 * least * 4 * 2 / 10e-9, rel=1e-12)
    ctx.trace = _trace(WORK[1:])
    assert read("k2.roofline.md", ctx) is None


# two iterations of one trajectory's eager rest: the initial forces' PME
# (the backward on autograd's worker thread, inside the forward's time
# once), re-sorts, the closing projection, and replays of the step graph
REST_SPANS = [
    span("integrator.initial_state", 10, 60, "move.apply"),
    span("pme.forward", 20, 30, "integrator.initial_state"),
    span("pme.backward", 25, 40, "integrator.initial_state", thread=2),
    span("integrator.resort", 100, 120, "integrator.run"),
    span("integrator.step", 120, 220, "integrator.run"),
    span("integrator.resort", 300, 325, "integrator.run"),
    span("integrator.step", 325, 400, "integrator.run"),
    span("constraints.velocities", 400, 405, "integrator.run"),
    span("integrator.run", 100, 410, "move.apply"),
    span("move.apply", 5, 450, "sampler.iteration"),
    span("sampler.iteration", 0, 500),
    span("integrator.resort", 1100, 1130, "integrator.run"),
    span("integrator.step", 1130, 1200, "integrator.run"),
    span("constraints.positions", 1150, 1160, "integrator.step"),
    span("constraints.velocities", 1200, 1210, "integrator.run"),
    span("sampler.iteration", 1000, 1500),
    # outside every iteration: not counted
    span("integrator.resort", 2000, 2100),
    span("pme.forward", 2000, 2100),
]


@pytest.mark.parametrize("metric, per_iteration", [
    ("sort.host_ms.md", (20 + 25 + 30) / 2),
    ("pme.span_ms.md", (40 - 20) / 2),
    ("constraints.span_ms.md", (5 + 10 + 10) / 2),
    # an integrator.step span less the SETTLE span inside it
    ("step.host_ms.md", (100 + 75 + 70 - 10) / 2),
])
def test_the_eager_rest_an_iteration(metric, per_iteration, snapshot):
    snapshot(_snap(REST_SPANS))
    assert read(metric) == pytest.approx(per_iteration, rel=1e-12)


@pytest.mark.parametrize("metric", ["sort.host_ms.md", "pme.span_ms.md",
                                    "constraints.span_ms.md",
                                    "step.host_ms.md", "k2.rebuilds.md"])
@pytest.mark.parametrize("snap", [
    None, _snap(), _snap([span("sampler.iteration", 0, 10),
                          span("move.apply", 1, 9)])])
def test_the_eager_rest_is_none_without_its_spans(metric, snap, snapshot):
    snapshot(snap)
    assert read(metric) is None


def test_k2_rebuilds_a_sort_set(snapshot):
    snapshot(_snap(counters={"k2.rebuilds": 60, "k2.sort_sets": 251}))
    assert read("k2.rebuilds.md") == pytest.approx(60 / 251, rel=1e-12)


def test_step_aten_calls_an_iteration():
    ctx = types.SimpleNamespace(trace=_trace(WORK, units=2,
                                             aten_calls=5000))
    assert read("step.aten_calls.md", ctx) == pytest.approx(2500.0)
    assert read("step.aten_calls.md", types.SimpleNamespace(
        trace=_trace(WORK))) is None
    assert read("step.aten_calls.md",
                types.SimpleNamespace(trace=None)) is None
