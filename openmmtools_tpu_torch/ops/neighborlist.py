"""Fixed-capacity neighbour lists (counterpart of ``ops/neighborlist.py``).

A (N, k_max) int32 index table with a validity mask, rebuilt from an O(N^2)
distance check: for each particle, the first ``k_max`` particles within
``r_list`` (= cutoff + skin) in index order, the remaining slots holding the
particle's own index with the mask off. Between rebuilds particles may
drift up to skin/2 each without missing an interaction. ``overflow`` is set
when some particle has more than ``k_max`` candidates; the caller decides
whether to raise or rebuild with a larger capacity.

The JAX package takes the first ``k_max`` by ``jax.lax.top_k`` on the 0/1
score, which keeps tied entries in index order; ``torch.topk`` promises no
order among ties, so the list here is compacted from ``within`` directly
(``nonzero`` walks it row-major, so each row's entries come in index
order). The JAX build materialises the (N, N) distance plane at once; here
the plane is built in blocks of rows (as many as keep a block near 2^26
entries), each block's rows finding their own first
``k_max`` columns, and ``overflow`` is the OR over the blocks: the same list
for any block size.

None of this is a Pallas kernel in the JAX package (plain XLA there), so
plain PyTorch is its port.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from openmmtools_tpu_torch.ops.geometry import minimum_image

# entries of the (rows, N) distance plane a build block holds at most
_BLOCK_ENTRIES = 1 << 26


class NeighborList(NamedTuple):
    idx: torch.Tensor       # (N, k_max) int32 neighbour indices (self-padded)
    mask: torch.Tensor      # (N, k_max) bool validity
    overflow: torch.Tensor  # () bool: some particle exceeded k_max
    r_list: float           # build radius (cutoff + skin)


def _block_r2(x, lo, hi, lengths):
    """Squared minimum-image distances (hi - lo, N) of rows lo..hi-1 to
    every particle, summed over the axes in order as the JAX build sums
    its (..., 3) axis."""
    r2 = None
    for a in range(3):
        d = x[lo:hi, None, a] - x[None, :, a]
        if lengths is not None:
            d = d - lengths[a] * torch.round(d / lengths[a])
        r2 = d * d if r2 is None else r2 + d * d
    return r2


def build_neighbor_list(x, box, r_list: float, k_max: int,
                        periodic: bool = True) -> NeighborList:
    """The symmetric full list ((i, j) and (j, i) both appear) of the
    particles within ``r_list`` of each other, built in blocks of rows; the
    list is the same for any block size."""
    n = x.shape[0]
    dev = x.device
    rows = max(1, min(n, _BLOCK_ENTRIES // max(n, 1)))
    lengths = torch.diagonal(box) if periodic else None
    r2_max = r_list * r_list
    idx = torch.arange(n, dtype=torch.int32, device=dev)[:, None].repeat(
        1, k_max)
    counts = torch.empty((n,), dtype=torch.int64, device=dev)
    col = torch.arange(n, device=dev)
    with torch.no_grad():
        for lo in range(0, n, rows):
            hi = min(n, lo + rows)
            within = _block_r2(x, lo, hi, lengths) < r2_max
            within[col[lo:hi] - lo, col[lo:hi]] = False   # no self pairs
            cnt = within.sum(dim=1)
            counts[lo:hi] = cnt
            r, c = within.nonzero(as_tuple=True)   # row-major: index order
            start = torch.cumsum(cnt, 0) - cnt
            rank = torch.arange(r.shape[0], device=dev) - start[r]
            keep = rank < k_max
            idx[lo + r[keep], rank[keep]] = c[keep].to(torch.int32)
    mask = (torch.arange(k_max, device=dev)[None, :] < counts[:, None])
    overflow = torch.any(counts > k_max)
    return NeighborList(idx=idx, mask=mask, overflow=overflow, r_list=r_list)


def neighbor_energy(x, box, nbr: NeighborList, pair_energy_fn,
                    periodic: bool = True):
    """Sum of pair energies over the neighbour list.

    ``pair_energy_fn(r2, i, j)`` returns the pair energies given squared
    distances (N, K) and index tensors. The symmetric list counts each pair
    twice, so the sum is halved. Masked slots (the self padding) take
    r^2 = 1 before the pair function runs, so their values never reach the
    gradient.
    """
    idx = nbr.idx.long()
    d = x[:, None, :] - x[idx]
    if periodic:
        d = minimum_image(d, box)
    r2_raw = torch.sum(d * d, dim=-1)
    r2 = torch.where(nbr.mask, torch.clamp(r2_raw, min=1e-12), 1.0)
    i_idx = torch.arange(x.shape[0], device=x.device)[:, None].expand_as(idx)
    e = pair_energy_fn(r2, i_idx, idx)
    return 0.5 * torch.sum(torch.where(nbr.mask, e, 0.0))
