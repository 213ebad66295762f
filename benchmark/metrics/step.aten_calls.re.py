"""ATen operator calls an iteration on the host, from the trace."""
from benchmark.metrics import readers


def read(ctx):
    return readers.aten_calls_per_unit(ctx)
