"""The reader of the step graph's engagement (``step.graphed_share.re``) on
synthetic snapshots of the program's counters: the share of steps that
replayed a CUDA graph, 0 where steps ran and none replayed, None where the
program counts no steps."""
import types

import pytest

from benchmark import run
from benchmark.metrics import spans

METRIC = "step.graphed_share.re"


def _snap(counters):
    return types.SimpleNamespace(spans=[], counters=counters, dropped=0)


@pytest.fixture
def snapshot(monkeypatch):
    def use(snap):
        monkeypatch.setattr(spans, "snapshot", lambda: snap)
    return use


@pytest.mark.parametrize("counters, share", [
    ({"integrator.steps": 100, "integrator.graph_steps": 98}, 98.0),
    ({"integrator.steps": 50, "integrator.graph_steps": 50}, 100.0),
    # steps counted and none replayed (a capture that failed): a share of
    # 0, so a graph that did not engage shows in the metric
    ({"integrator.steps": 50}, 0.0),
])
def test_the_share_of_steps_replayed(counters, share, snapshot):
    snapshot(_snap(counters))
    assert run.load_metric(METRIC).read(None) == pytest.approx(share,
                                                                rel=1e-12)


@pytest.mark.parametrize("snap", [
    None,                                   # a program without tracing
    _snap({}),                              # no step counted
    _snap({"integrator.steps": 0, "integrator.graph_steps": 0}),
    _snap({"k2.rebuilds": 3, "k2.sort_sets": 12}),
])
def test_no_share_without_counted_steps(snap, snapshot):
    snapshot(snap)
    assert run.load_metric(METRIC).read(None) is None
