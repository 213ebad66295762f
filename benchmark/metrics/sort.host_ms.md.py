"""Ms an iteration of one trajectory inside the program's
``integrator.resort`` spans: the sweep ring's re-sorts (the sort, the
exclusion bitfield and the sorted parameters), eager between the step
graph's replays."""
from benchmark.metrics import spans


def read(ctx):
    return spans.span_ms({"integrator.resort"})
