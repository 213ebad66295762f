"""Ms an iteration of one trajectory inside the program's ``pme.forward``
and ``pme.backward`` spans: the Ewald structure factors of the eager
evaluations (the move's initial forces; a replayed step opens no span)."""
from benchmark.metrics import spans


def read(ctx):
    return spans.span_ms({"pme.forward", "pme.backward"})
