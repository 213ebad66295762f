"""Host ms an iteration inside the constraint solvers' ranges (SETTLE, on
positions and on velocities, of every replica)."""
from benchmark.metrics import readers


def read(ctx):
    return readers.host_ms_per_unit(ctx, readers.CONSTRAINTS)
