"""Device activities a step: every activity of the traced iteration
(kernels, copies and fills, the eager initial forces, re-sorts and closing
projection among them) over the steps the program counted in it
(``integrator.steps``); None without a trace or a counted step."""
from benchmark.metrics import spans


def read(ctx):
    t = ctx.trace
    snap = spans.snapshot()
    if t is None or snap is None or not snap.counters.get("integrator.steps"):
        return None
    return len(t.work) / snap.counters["integrator.steps"]
