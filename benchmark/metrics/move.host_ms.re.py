"""Host ms an iteration inside the program's ``move.apply_batch`` spans and
outside its ``integrator.run`` spans: the batch's state built and taken
apart, the initial forces, the NaN read and the statistics."""
from benchmark.metrics import spans


def read(ctx):
    return spans.less_ms("move.apply_batch", "integrator.run")
