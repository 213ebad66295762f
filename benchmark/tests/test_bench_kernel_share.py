"""The reader of SETTLE's kernel share (``constraints.kernel_share``) on
synthetic snapshots of the program's counters: the share of projections
that launched the kernel, 0 where projections ran and none launched, None
where the program counts no projection (a program without the counters)."""
import types

import pytest

from benchmark import run
from benchmark.metrics import spans

METRIC = "constraints.kernel_share"


def _snap(counters):
    return types.SimpleNamespace(spans=[], counters=counters, dropped=0)


@pytest.fixture
def snapshot(monkeypatch):
    def use(snap):
        monkeypatch.setattr(spans, "snapshot", lambda: snap)
    return use


@pytest.mark.parametrize("counters, share", [
    ({"constraints.settle": 1001, "constraints.settle_kernel": 1001}, 100.0),
    ({"constraints.settle": 200, "constraints.settle_kernel": 150}, 75.0),
    # projections counted and no launch (the plain version): 0
    ({"constraints.settle": 81, "integrator.steps": 20}, 0.0),
])
def test_the_share_of_projections_launched(counters, share, snapshot):
    snapshot(_snap(counters))
    assert run.load_metric(METRIC).read(None) == pytest.approx(share,
                                                                rel=1e-12)


@pytest.mark.parametrize("snap", [
    None,                                   # a program without tracing
    _snap({}),                              # nothing counted
    _snap({"constraints.settle": 0, "constraints.settle_kernel": 0}),
    _snap({"integrator.steps": 250, "integrator.graph_steps": 249}),
])
def test_no_share_without_counted_projections(snap, snapshot):
    snapshot(snap)
    assert run.load_metric(METRIC).read(None) is None
