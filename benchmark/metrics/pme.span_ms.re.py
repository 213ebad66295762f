"""Ms an iteration inside the program's ``pme.forward`` and
``pme.backward`` spans (the Ewald structure factors, one span a
configuration, the backward's on autograd's worker thread)."""
from benchmark.metrics import spans


def read(ctx):
    return spans.span_ms({"pme.forward", "pme.backward"})
