"""Host ms an iteration inside the program's ``integrator.resort`` spans:
the sweep ring's re-sorts (the sort, the exclusion bitfield and the sorted
parameters of every replica)."""
from benchmark.metrics import spans


def read(ctx):
    return spans.span_ms({"integrator.resort"})
