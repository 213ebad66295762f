"""ATen operator calls an iteration of one trajectory on the host, from the
trace: the eager rest around the step graph's replays (the initial forces,
the re-sorts, the closing projection, the state's conversions)."""
from benchmark.metrics import readers


def read(ctx):
    return readers.aten_calls_per_unit(ctx)
