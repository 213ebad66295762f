"""Pairs inside the cutoff: the work a nonbonded evaluation needs, whatever
computes it. Two counts that must agree: brute force in blocks of rows, and
a cell list. Both count unordered pairs i < j closer than the cutoff under
the minimum image of a cubic box, less the excluded pairs."""
from __future__ import annotations

import numpy as np
import torch


def _less_excluded(count_fn, x, box_edge, cutoff, excluded):
    """Subtract the excluded pairs that lie inside the cutoff."""
    n = count_fn()
    if excluded is not None and len(excluded):
        d = x[excluded[:, 0]] - x[excluded[:, 1]]
        d = d - box_edge * np.round(d / box_edge)
        n -= int(np.sum(np.sum(d * d, -1) < cutoff * cutoff))
    return n


def brute_force(x, box_edge, cutoff, excluded=None, block=512,
                device="cpu"):
    """Every pair tested, in blocks of ``block`` rows on ``device``."""
    x = np.asarray(x, np.float64)

    def count():
        xt = torch.as_tensor(x, device=device)
        n, total = xt.shape[0], 0
        with torch.no_grad():
            for a in range(0, n, block):
                d = xt[a:a + block, None, :] - xt[None, :, :]
                d = d - box_edge * torch.round(d / box_edge)
                inside = torch.sum(d * d, -1) < cutoff * cutoff
                rows = torch.arange(a, min(n, a + block),
                                    device=xt.device)[:, None]
                cols = torch.arange(n, device=xt.device)[None, :]
                total += int(torch.sum(inside & (cols > rows)))
        return total

    return _less_excluded(count, x, box_edge, cutoff, excluded)


def cell_list(x, box_edge, cutoff, excluded=None):
    """Cells of at least the cutoff on an edge; each pair found once from
    the 27 neighbouring cells."""
    x = np.asarray(x, np.float64)

    def count():
        m = max(3, int(box_edge // cutoff))
        cell = np.floor(np.mod(x, box_edge) / (box_edge / m)).astype(int) % m
        key = (cell[:, 0] * m + cell[:, 1]) * m + cell[:, 2]
        members = [np.nonzero(key == k)[0] for k in range(m ** 3)]
        total = 0
        for k in range(m ** 3):
            a = members[k]
            if not len(a):
                continue
            cx, cy, cz = k // (m * m), (k // m) % m, k % m
            nbrs = {((cx + i) % m * m + (cy + j) % m) * m + (cz + l) % m
                    for i in (-1, 0, 1) for j in (-1, 0, 1)
                    for l in (-1, 0, 1)}
            b = np.concatenate([members[q] for q in nbrs])
            d = x[a][:, None, :] - x[b][None, :, :]
            d = d - box_edge * np.round(d / box_edge)
            inside = np.sum(d * d, -1) < cutoff * cutoff
            total += int(np.sum(inside & (b[None, :] > a[:, None])))
        return total

    return _less_excluded(count, x, box_edge, cutoff, excluded)
