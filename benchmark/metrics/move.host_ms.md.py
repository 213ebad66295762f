"""Ms an iteration inside the program's ``move.apply`` spans and outside
its ``integrator.run`` spans: the move's eager initial forces, the state's
conversions and the host read of the NaN flag."""
from benchmark.metrics import spans


def read(ctx):
    return spans.less_ms("move.apply", "integrator.run")
