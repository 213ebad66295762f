"""Ms an iteration of one trajectory inside the program's
``constraints.positions`` and ``constraints.velocities`` spans: the eager
SETTLE calls (the run's closing velocity projection; a replayed step opens
no span)."""
from benchmark.metrics import spans


def read(ctx):
    return spans.span_ms({"constraints.positions", "constraints.velocities"})
