"""Host ms an iteration inside the Ewald structure factors' ranges,
forward and backward, propagation and energy matrix together."""
from benchmark.metrics import readers


def read(ctx):
    return readers.host_ms_per_unit(ctx, readers.PME)
