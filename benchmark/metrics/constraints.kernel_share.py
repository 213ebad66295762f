"""The share of SETTLE's projections that launched its CUDA kernel (%):
the program's counters ``constraints.settle_kernel`` over
``constraints.settle`` in the traced iteration (a graph replay recounts
both); 0 where projections ran and none launched, None where the program
counts no projection. One reader for every cell."""
from benchmark.metrics import spans


def read(ctx):
    snap = spans.snapshot()
    if snap is None or not snap.counters.get("constraints.settle"):
        return None
    counters = snap.counters
    return (100.0 * counters.get("constraints.settle_kernel", 0)
            / counters["constraints.settle"])
