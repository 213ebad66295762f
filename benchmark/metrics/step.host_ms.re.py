"""Host ms an iteration of the step program's own work: the self time of
the program's ``integrator.step`` spans (the V, R and O updates, the
draws and the state's bookkeeping, outside the force evaluation and the
constraints)."""
from benchmark.metrics import spans


def read(ctx):
    return spans.self_ms("integrator.step")
