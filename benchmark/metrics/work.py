"""The least time a nonbonded evaluation needs on the card, from what its
inputs need and never from what a kernel tests.

Operations: the pairs inside the cutoff at the evaluated positions times
``OPS_PER_PAIR``, the float32 operations of one pair interaction: the
displacement and its minimum image (9), r^2 (5), the reciprocal square root
(4), the erfc of the Ewald direct term by a rational approximation with its
exponential (20), Coulomb and Lennard-Jones with their scalar force (13),
and the force added to both atoms (9): 60. An alchemical pair's softcore
adds some 20 more; alchemical pairs are a few hundredths of a percent of
the pairs here and are counted at 60 too. Bytes: each atom's inputs read
once (position, charge, sigma, epsilon: 24 bytes) and its force written
once (12 bytes). The least time is the larger of the operations over the
float32 peak and the bytes over the memory bandwidth."""
from __future__ import annotations

from benchmark.metrics.peaks import FP32_FLOPS, HBM_BYTES_PER_S

OPS_PER_PAIR = 60
BYTES_PER_ATOM = 36


def least_seconds(n_pairs, n_atoms):
    return max(n_pairs * OPS_PER_PAIR / FP32_FLOPS,
               n_atoms * BYTES_PER_ATOM / HBM_BYTES_PER_S)
