"""K2's share of its roofline in the traced sampler iteration (%)."""
from benchmark.metrics import readers


def read(ctx):
    return readers.k2_roofline(ctx)
