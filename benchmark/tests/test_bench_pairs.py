"""Pairs inside the cutoff, by brute force and by a cell list."""
import numpy as np

from benchmark.reference import forcefield
from benchmark.tests.test_bench_reference import TIP3P, water
from benchmark.metrics import pairs


def test_brute_force_and_cell_list_count_the_same_pairs():
    x, edge = water(n_side=7, edge=2.2)
    spec = forcefield.water_spec(len(x) // 3, edge, TIP3P, 0.7, 5e-4, None)
    for cutoff in (0.5, 0.7):
        a = pairs.brute_force(x, edge, cutoff, spec.exception_pairs,
                              block=97)
        b = pairs.cell_list(x, edge, cutoff, spec.exception_pairs)
        assert a == b
        # and both against the plain double loop
        d = x[:, None, :] - x[None, :, :]
        d -= edge * np.round(d / edge)
        r2 = (d * d).sum(-1)
        n = len(x)
        every = int(np.sum(np.triu(r2 < cutoff * cutoff, 1)))
        assert a == every - n // 3 * 3
