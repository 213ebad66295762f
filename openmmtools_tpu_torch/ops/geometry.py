"""Differentiable geometry primitives (counterpart of ``ops/geometry.py``).

Gradients are safe at zero-length separations via the ``safe_norm`` clamp.
"""
from __future__ import annotations

import torch


def safe_norm(d, dim=-1, keepdim=False, eps=1e-12):
    """Norm with a non-NaN gradient at 0."""
    sq = torch.sum(d * d, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp(sq, min=eps))


def minimum_image(d, box):
    """Minimum-image convention for an orthorhombic box.

    ``d``: displacement vectors (..., 3). ``box``: (3, 3) box-vector matrix
    (rows are box vectors); only the diagonal is used. ``torch.round``
    rounds half to even, as ``jnp.round`` does.
    """
    lengths = torch.diagonal(box)
    return d - lengths * torch.round(d / lengths)


def minimum_image_triclinic(d, box):
    """Minimum image for a triclinic box in reduced form (OpenMM's
    convention: box[0] = (a, 0, 0), box[1] = (bx, b, 0), box[2] = (cx, cy,
    c) with |bx| <= a/2 and so on): one reduction along c, then b, then
    a."""
    d = d - box[2] * torch.round(d[..., 2:3] / box[2, 2])
    d = d - box[1] * torch.round(d[..., 1:2] / box[1, 1])
    d = d - box[0] * torch.round(d[..., 0:1] / box[0, 0])
    return d


def distance(xi, xj, box=None):
    d = xi - xj
    if box is not None:
        d = minimum_image(d, box)
    return safe_norm(d)


def angle(xi, xj, xk):
    """Angle at xj between (xi - xj) and (xk - xj), radians."""
    a = xi - xj
    b = xk - xj
    cross = torch.linalg.cross(a, b)
    return torch.atan2(safe_norm(cross), torch.sum(a * b, dim=-1))


def dihedral(xi, xj, xk, xl):
    """Signed dihedral angle of the i-j-k-l chain, radians, via atan2."""
    b1 = xj - xi
    b2 = xk - xj
    b3 = xl - xk
    n1 = torch.linalg.cross(b1, b2)
    n2 = torch.linalg.cross(b2, b3)
    m1 = torch.linalg.cross(n1, b2 / safe_norm(b2, keepdim=True))
    x = torch.sum(n1 * n2, dim=-1)
    y = torch.sum(m1 * n2, dim=-1)
    return torch.atan2(y, x)
