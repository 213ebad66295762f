"""The share of one trajectory's steps that replayed a CUDA graph (%): the
program's counters ``integrator.graph_steps`` over ``integrator.steps`` in
the traced iteration; 0 where steps ran and none replayed, None where the
program counts no steps."""
from benchmark.metrics import spans


def read(ctx):
    snap = spans.snapshot()
    if snap is None or not snap.counters.get("integrator.steps"):
        return None
    counters = snap.counters
    return (100.0 * counters.get("integrator.graph_steps", 0)
            / counters["integrator.steps"])
