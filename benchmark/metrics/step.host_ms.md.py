"""Host ms an iteration of one trajectory in the self time of the program's
``integrator.step`` spans: each replay call of the step's graph (which
waits while the card's launch queue is full) and any eager step's own
updates."""
from benchmark.metrics import spans


def read(ctx):
    return spans.self_ms("integrator.step")
