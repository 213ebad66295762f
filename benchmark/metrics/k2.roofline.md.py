"""K2's share of its roofline in the traced iteration of one trajectory
(%): the standard force kernel against the least time of the pairs inside
the cutoff."""
from benchmark.metrics import readers


def read(ctx):
    return readers.k2_roofline(ctx)
