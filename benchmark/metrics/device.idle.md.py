"""The device's idle share of the traced iteration of one trajectory (%),
from the trace."""
from benchmark.metrics import readers


def read(ctx):
    return readers.idle_percent(ctx)
