"""K2's block-bound rebuilds a sort-set evaluation in one trajectory: the
program's counters ``k2.rebuilds`` over ``k2.sort_sets`` in the traced
iteration (a replay recounts both)."""
from benchmark.metrics import spans


def read(ctx):
    return spans.ratio("k2.rebuilds", "k2.sort_sets")
