"""Host ms an iteration of the sweep remainder outside the Ewald structure
factors: the self time of the program's ``forces.remainder`` spans (the
terms around the sweep kernels under vmap, forward and backward)."""
from benchmark.metrics import spans


def read(ctx):
    return spans.self_ms("forces.remainder")
