"""Ms an iteration inside the program's ``constraints.positions`` and
``constraints.velocities`` spans (SETTLE of every replica, one span a
batched call)."""
from benchmark.metrics import spans


def read(ctx):
    return spans.span_ms({"constraints.positions", "constraints.velocities"})
