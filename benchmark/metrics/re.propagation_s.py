"""Seconds an iteration in the move's apply_batch, synchronized at its end."""
from benchmark.metrics import readers


def read(ctx):
    return readers.span_per_unit(ctx, "propagation")
