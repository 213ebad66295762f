"""Holonomic distance constraints (counterpart of ``ops/constraints.py``).

OpenMM's SETTLE + CCMA architecture:

* SETTLE (Miyamoto & Kollman, J. Comput. Chem. 13:952, 1992): the analytic
  position and velocity projections of rigid isosceles 3-site molecules
  (rigid water). On a CUDA tensor each projection is one launch of a
  kernel of ``csrc/settle.cu`` (one thread a molecule, float32 or float64,
  a leading batch axis over the grid); on the CPU the plain tensor code
  (``settle_*_reference``), where molecules laid out as contiguous (apex,
  sat, sat) runs are plain reshapes of the position array.
* M-SHAKE / M-RATTLE: per-cluster direct solves for small coupled constraint
  clusters (protein h-bonds): a few Newton iterations with a constant
  per-step coupling matrix, no data-dependent loop.
* Jacobi SHAKE/RATTLE: the iterative general fallback, iterated until the
  worst relative violation is below tolerance (the loop reads the violation
  on the host each iteration; no production path takes it).

``partition_constraints`` splits a mixed topology into the SETTLE triangles
and the rest; :class:`ConstraintSolver` applies both on their disjoint atom
sets, for one configuration or a batch, and is what the integrators,
the minimizers and the barostat call.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from openmmtools_tpu_torch.ops._build import (check, kernels_for,
                                             load_library)
from openmmtools_tpu_torch.ops.sweep_nb import LaunchCounts
from openmmtools_tpu_torch.system import Constraints
from openmmtools_tpu_torch.utils import tracing


def _inv_mass(masses):
    return torch.where(masses > 0, 1.0 / torch.clamp(masses, min=1e-30), 0.0)


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def shake_positions(x, x_ref, constraints: Constraints, masses,
                    tol=1e-8, max_iter=100, omega=1.0):
    """Project positions onto the constraint manifold (Jacobi SHAKE).

    ``x_ref`` supplies the constraint directions (pre-step positions), as in
    classic SHAKE. Returns the corrected positions; no-op without
    constraints.
    """
    if constraints.n_constraints == 0:
        return x
    i = constraints.index[:, 0].long()
    j = constraints.index[:, 1].long()
    d0 = constraints.distance
    d0sq = d0 * d0
    inv_m = _inv_mass(masses)
    imi = inv_m[i][:, None]
    imj = inv_m[j][:, None]
    s = x_ref[i] - x_ref[j]   # reference directions

    def violation(xc):
        r = xc[i] - xc[j]
        r2 = torch.sum(r * r, dim=-1)
        return torch.max(torch.abs(r2 - d0sq) / d0sq)

    xc = x
    it = 0
    while it < max_iter and float(violation(xc)) > 2.0 * tol:
        r = xc[i] - xc[j]
        r2 = torch.sum(r * r, dim=-1)
        rs = torch.sum(r * s, dim=-1)
        # guard: if r is perpendicular to s (pathological), fall back to r.r
        denom = 2.0 * (inv_m[i] + inv_m[j]) * torch.where(
            torch.abs(rs) > 1e-12, rs, r2)
        g = omega * (r2 - d0sq) / denom
        xc = xc.index_add(0, i, -(g[:, None] * imi) * s)
        xc = xc.index_add(0, j, (g[:, None] * imj) * s)
        it += 1
    return xc


def rattle_velocities(x, v, constraints: Constraints, masses,
                      tol=1e-8, max_iter=100, omega=1.0):
    """Project velocities onto the tangent space of the constraint manifold:
    (v_i - v_j) . r_ij = 0 for every constraint (Jacobi RATTLE)."""
    if constraints.n_constraints == 0:
        return v
    i = constraints.index[:, 0].long()
    j = constraints.index[:, 1].long()
    d0sq = constraints.distance ** 2
    inv_m = _inv_mass(masses)
    imi = inv_m[i][:, None]
    imj = inv_m[j][:, None]
    r = x[i] - x[j]
    r2 = torch.sum(r * r, dim=-1)

    # velocity scale for the relative tolerance (avoids 0/0 for v = 0)
    vscale = torch.clamp(torch.max(torch.abs(v)), min=1e-8)

    def violation(vc):
        dv = vc[i] - vc[j]
        return torch.max(torch.abs(torch.sum(dv * r, dim=-1))
                         / (torch.sqrt(d0sq) * vscale))

    vc = v
    it = 0
    while it < max_iter and float(violation(vc)) > tol:
        dv = vc[i] - vc[j]
        g = omega * torch.sum(dv * r, dim=-1) / (r2 * (inv_m[i] + inv_m[j]))
        vc = vc.index_add(0, i, -(g[:, None] * imi) * r)
        vc = vc.index_add(0, j, (g[:, None] * imj) * r)
        it += 1
    return vc


# ---------------------------------------------------------------------------
# Cluster M-SHAKE: direct per-cluster matrix solves
# ---------------------------------------------------------------------------


class ClusterSpec:
    """Static topology for cluster-direct M-SHAKE.

    cons (n_comp, B): constraint index per cluster slot (0-padded);
    valid (n_comp, B): slot mask; w (n_comp, B, B): mass-coupling matrix
    w_cd = sum over shared atoms a of (+-1/m_a), + when the shared atom has
    the same role (i-i or j-j) in both constraints, - otherwise.
    """

    def __init__(self, cons, valid, w, block):
        self.cons = cons
        self.valid = valid
        self.w = w
        self.block = block


def analyze_clusters(constraints: Constraints, masses, max_block=8):
    """Partition the constraint graph into connected components; return a
    ClusterSpec when every component has <= max_block constraints (the
    h-bond case), else None (callers fall back to Jacobi SHAKE)."""
    n_c = constraints.n_constraints
    if n_c == 0:
        return None
    idx = constraints.index.cpu().numpy()
    m = masses.detach().cpu().numpy()

    parent = {}

    def find(a):
        parent.setdefault(a, a)
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for k in range(n_c):
        union(int(idx[k, 0]), int(idx[k, 1]))
    comp_of = {}
    for k in range(n_c):
        comp_of.setdefault(find(int(idx[k, 0])), []).append(k)
    comps = list(comp_of.values())
    block = max(len(c) for c in comps)
    if block > max_block:
        return None

    n_comp = len(comps)
    cons = np.zeros((n_comp, block), np.int64)
    # float32 coupling matrix, as in the JAX package: the Newton loop's
    # residuals are exact, only its step direction carries the rounding
    valid = np.zeros((n_comp, block), np.float32)
    w = np.zeros((n_comp, block, block), np.float32)
    inv_m = np.where(m > 0, 1.0 / np.maximum(m, 1e-30), 0.0)
    for g, comp in enumerate(comps):
        for a, ka in enumerate(comp):
            cons[g, a] = ka
            valid[g, a] = 1.0
            ia, ja = int(idx[ka, 0]), int(idx[ka, 1])
            for b, kb in enumerate(comp):
                ib, jb = int(idx[kb, 0]), int(idx[kb, 1])
                val = 0.0
                if ia == ib:
                    val += inv_m[ia]
                if ja == jb:
                    val += inv_m[ja]
                if ia == jb:
                    val -= inv_m[ia]
                if ja == ib:
                    val -= inv_m[ja]
                w[g, a, b] = val
        # padded slots: identity rows keep the solve nonsingular
        for a in range(len(comp), block):
            w[g, a, a] = 1.0
    dev = masses.device
    return ClusterSpec(torch.as_tensor(cons, device=dev),
                       torch.as_tensor(valid, device=dev),
                       torch.as_tensor(w, device=dev), block)


def _inv_small(A, n):
    """Batched inverse of small (.., n, n) matrices by unrolled
    Gauss-Jordan without pivoting (the constraint coupling matrices are
    diagonally dominant)."""
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    aug = torch.cat([A, eye], dim=-1)                  # (.., n, 2n)
    row_is_k = torch.arange(n, device=A.device)[:, None]
    for k in range(n):
        pivot_row = aug[..., k:k + 1, :] / aug[..., k:k + 1, k:k + 1]
        factors = aug[..., :, k:k + 1]
        eliminated = aug - factors * pivot_row
        aug = torch.where(row_is_k == k, pivot_row, eliminated)
    return aug[..., :, n:]


def mshake_positions(x, x_ref, constraints: Constraints, spec: ClusterSpec,
                     masses, n_iter=None, tol=1e-8):
    """SHAKE projection along reference directions by per-cluster direct
    solves: Newton iterations with the (constant per step) coupling matrix
    A_cd = 2 w_cd (s_c . s_d), run entirely in cluster-block space
    (positions move linearly in lambda, so the residuals obey
    dr_c = sum_d w_cd lam_d s_d). ``n_iter`` derives from ``tol`` when not
    given: 6 iterations reach ~1e-8 relative, each extra digit costs ~1."""
    if n_iter is None:
        digits = -math.log10(max(float(tol), 1e-16))
        n_iter = 6 + max(0, int(math.ceil(digits)) - 8)
    i = constraints.index[:, 0].long()
    j = constraints.index[:, 1].long()
    d0sq = constraints.distance ** 2
    inv_m = _inv_mass(masses)
    imi = inv_m[i][:, None]
    imj = inv_m[j][:, None]
    s = x_ref[i] - x_ref[j]                      # (C, 3) reference directions

    B = spec.block
    s_blk = s[spec.cons]                         # (G, B, 3)
    r_blk = (x[i] - x[j])[spec.cons]             # (G, B, 3)
    d0_blk = d0sq[spec.cons]                     # (G, B)
    w_blk = spec.w.to(x.dtype)                   # (G, B, B)
    vb = spec.valid.to(x.dtype)                  # (G, B)

    A = torch.stack([2.0 * w_blk[:, :, d] * _dot3(s_blk, s_blk[:, d:d + 1, :])
                     for d in range(B)], dim=-1)
    A_inv = _inv_small(A, B)
    lam_tot = torch.zeros(d0_blk.shape, dtype=x.dtype, device=x.device)

    for _ in range(n_iter):
        g = _dot3(r_blk, r_blk) - d0_blk                    # (G, B)
        lam = -sum(A_inv[:, :, d] * g[:, d:d + 1] for d in range(B)) * vb
        r_blk = r_blk + sum(
            (w_blk[:, :, d] * lam[:, d:d + 1])[:, :, None]
            * s_blk[:, d:d + 1, :] for d in range(B))
        lam_tot = lam_tot + lam

    n_c = constraints.n_constraints
    lam_blk = lam_tot * vb
    lam = torch.zeros((n_c,), dtype=x.dtype, device=x.device).index_add(
        0, spec.cons.reshape(-1), lam_blk.reshape(-1))
    x = x.index_add(0, i, (lam[:, None] * imi) * s)
    return x.index_add(0, j, -(lam[:, None] * imj) * s)


def mrattle_velocities(x, v, constraints: Constraints, spec: ClusterSpec,
                       masses):
    """Exact RATTLE velocity projection: the tangency conditions are linear,
    so one per-cluster solve of w_cd (r_c . r_d) mu = rhs removes all
    violations at once."""
    i = constraints.index[:, 0].long()
    j = constraints.index[:, 1].long()
    inv_m = _inv_mass(masses)
    imi = inv_m[i][:, None]
    imj = inv_m[j][:, None]
    r = x[i] - x[j]                              # (C, 3) current directions

    B = spec.block
    r_blk = r[spec.cons]
    w_blk = spec.w.to(x.dtype)
    valid = spec.valid.to(x.dtype)
    A = torch.stack([w_blk[:, :, d] * _dot3(r_blk, r_blk[:, d:d + 1, :])
                     for d in range(B)], dim=-1)
    # invalid slots: identity rows
    eye = torch.eye(B, dtype=x.dtype, device=x.device)
    pad = (1.0 - valid)[:, :, None] * eye[None]
    A = A * (valid[:, :, None] * valid[:, None, :]) + pad

    dv = v[i] - v[j]
    rhs = torch.sum(dv * r, dim=-1)              # (C,)
    rhs_blk = rhs[spec.cons] * valid
    A_inv = _inv_small(A, B)
    mu_blk = sum(A_inv[:, :, d] * rhs_blk[:, d:d + 1]
                 for d in range(B)) * valid
    n_c = constraints.n_constraints
    mu = torch.zeros((n_c,), dtype=v.dtype, device=v.device).index_add(
        0, spec.cons.reshape(-1), mu_blk.reshape(-1))
    v = v.index_add(0, i, -(mu[:, None] * imi) * r)
    return v.index_add(0, j, (mu[:, None] * imj) * r)


# ---------------------------------------------------------------------------
# SETTLE: analytic constraints for rigid isosceles 3-site molecules (water)
# ---------------------------------------------------------------------------


_SETTLE_ENTRIES = ("settle_positions", "settle_velocities")


class SettleSpec:
    """Static per-molecule topology for SETTLE.

    ``a`` is the apex atom (O), ``b``/``c`` the equal-mass satellites (H).
    ``ra``/``rb``/``rc`` are canonical-frame coordinates: apex at (0, ra),
    satellites at (+-rc, -rb); all (W,) tensors, so mixed rigid solvents
    work. ``contig`` = (start, W) when the molecules are (apex, sat, sat)
    runs of stride 3 from ``start``: then the per-molecule arrays are plain
    reshapes of the position array and the projections gather nothing.
    The frame coordinates are computed in float64 and stored in the
    masses' type, on their device. ``tables`` holds the kernels' (5, W)
    table of apex mass, satellite mass, ra, rb, rc in float32 and float64,
    made once and never replaced, since a captured graph holds their
    addresses; ``launches`` counts the kernels' launches by entry point,
    read from counters that the kernels add to on the device, so the
    launches of a replayed CUDA graph count as they run (CUDA tensors
    only).
    """

    def __init__(self, a, b, c, ra, rb, rc, masses):
        device, dtype = masses.device, masses.dtype
        an = np.asarray(a, np.int64)
        bn = np.asarray(b, np.int64)
        cn = np.asarray(c, np.int64)
        ra, rb, rc = (np.asarray(t, np.float64) for t in (ra, rb, rc))
        self.contig = None
        if an.size:
            order = np.argsort(an)
            an_s, bn_s, cn_s = an[order], bn[order], cn[order]
            if ((an_s.size == 1 or (np.diff(an_s) == 3).all())
                    and (bn_s == an_s + 1).all()
                    and (cn_s == an_s + 2).all()):
                self.contig = (int(an_s[0]), int(an_s.size))
                an, bn, cn = an_s, bn_s, cn_s
                ra, rb, rc = ra[order], rb[order], rc[order]

        def t(v, dt=dtype):
            return torch.as_tensor(v, dtype=dt, device=device)

        self.a = t(an, torch.int64)
        self.b = t(bn, torch.int64)
        self.c = t(cn, torch.int64)
        self.ra, self.rb, self.rc = t(ra), t(rb), t(rc)
        tab = torch.stack([masses[self.a], masses[self.b], self.ra, self.rb,
                           self.rc])
        self.tables = {dt: tab.to(dt).contiguous()
                       for dt in (torch.float32, torch.float64)}
        # (entry, None, device) -> an int64 () counter on the device
        self._launch_counters = {
            (entry, None, device): torch.zeros((), dtype=torch.int64,
                                               device=device)
            for entry in _SETTLE_ENTRIES}
        self.launches = LaunchCounts(self._launch_counters,
                                     lambda entry, _: entry, _SETTLE_ENTRIES)


def _settle_triangles(constraints: Constraints, masses):
    """Walk the constraint graph's components; return (triangles, rest):
    triangles as (apex, sat, sat, ra, rb, rc) for each SETTLE-able rigid
    isosceles component, rest as the constraint rows of every other
    component."""
    n_c = constraints.n_constraints
    idx = constraints.index.cpu().numpy()
    dist = constraints.distance.detach().cpu().numpy()
    m = masses.detach().cpu().numpy()
    adj = {}
    for k in range(n_c):
        i, j = int(idx[k, 0]), int(idx[k, 1])
        adj.setdefault(i, []).append((j, k))
        adj.setdefault(j, []).append((i, k))
    seen = set()
    triangles, rest_edges = [], []
    for start in adj:
        if start in seen:
            continue
        comp, edges, stack = set(), set(), [start]
        while stack:
            u = stack.pop()
            if u in comp:
                continue
            comp.add(u)
            for v, k in adj[u]:
                edges.add(k)
                if v not in comp:
                    stack.append(v)
        seen |= comp
        tri = None
        if len(comp) == 3 and len(edges) == 3:
            atoms = sorted(comp)
            # distances keyed by the excluded atom (d[k] = bond not touching k)
            dmap = {}
            for k in edges:
                i, j = int(idx[k, 0]), int(idx[k, 1])
                dmap[(comp - {i, j}).pop()] = dist[k]
            # apex = atom whose two incident bonds are equal, between
            # satellites of equal mass
            apex = None
            for cand in atoms:
                others = [t for t in atoms if t != cand]
                if np.isclose(dmap[others[1]], dmap[others[0]], rtol=1e-5) \
                        and np.isclose(m[others[0]], m[others[1]], rtol=1e-5):
                    apex = cand
                    break
            if apex is not None and m[apex] > 0:
                sat = [t for t in atoms if t != apex]
                if m[sat[0]] > 0:
                    d_ab = float(dmap[sat[1]])
                    d_bc = float(dmap[apex])
                    # canonical frame: apex on +y at ra above the COM,
                    # satellites at (+-rc, -rb); t = apex -> midpoint
                    t = math.sqrt(max(d_ab * d_ab - 0.25 * d_bc * d_bc, 0.0))
                    ma, mh = float(m[apex]), float(m[sat[0]])
                    ra = 2.0 * mh * t / (ma + 2.0 * mh)
                    tri = (apex, sat[0], sat[1], ra, t - ra, 0.5 * d_bc)
        if tri is None:
            rest_edges.extend(sorted(edges))
        else:
            triangles.append(tri)
    return triangles, rest_edges


def _settle_spec(triangles, masses):
    cols = list(zip(*triangles))
    return SettleSpec(*cols, masses=masses)


def analyze_settle(constraints: Constraints, masses):
    """A SettleSpec when EVERY constraint belongs to a disjoint isosceles
    triangle (two equal apex bonds, equal satellite masses), the rigid-water
    case; else None (callers fall back to SHAKE/RATTLE)."""
    n_c = constraints.n_constraints
    if n_c == 0 or n_c % 3 != 0:
        return None
    triangles, rest = _settle_triangles(constraints, masses)
    if rest:
        return None
    return _settle_spec(triangles, masses)


def _molecules(spec: SettleSpec, *arrays):
    """Per-molecule (apex, sat, sat) rows of each (N, 3) array."""
    out = []
    for arr in arrays:
        if spec.contig is not None:
            start, w = spec.contig
            blk = arr[start:start + 3 * w].reshape(w, 3, 3)
            out += [blk[:, 0], blk[:, 1], blk[:, 2]]
        else:
            out += [arr[spec.a], arr[spec.b], arr[spec.c]]
    return out


def _set_molecules(spec: SettleSpec, arr, na, nb, nc, add=False):
    """Write (or add) per-molecule rows back into ``arr``."""
    if spec.contig is not None:
        start, w = spec.contig
        blk = torch.stack([na, nb, nc], dim=1).reshape(3 * w, 3).to(arr.dtype)
        if add:
            blk = arr[start:start + 3 * w] + blk
        return torch.cat([arr[:start], blk, arr[start + 3 * w:]])
    if add:
        arr = arr.index_add(0, spec.a, na.to(arr.dtype))
        arr = arr.index_add(0, spec.b, nb.to(arr.dtype))
        return arr.index_add(0, spec.c, nc.to(arr.dtype))
    arr = arr.index_copy(0, spec.a, na.to(arr.dtype))
    arr = arr.index_copy(0, spec.b, nb.to(arr.dtype))
    return arr.index_copy(0, spec.c, nc.to(arr.dtype))


_KERNEL_TYPES = {torch.float32: "f32", torch.float64: "f64"}


def _settle_launch(entry, x, y, base, spec: SettleSpec):
    """One launch of ``entry`` on (N, 3) or (B, N, 3) CUDA tensors ``x``
    and ``y``: a copy of ``base`` with every triangle's atoms written (no
    copy where the triangles cover every atom). The kernel reads the
    masses the spec was built from."""
    suffix = _KERNEL_TYPES.get(x.dtype)
    if suffix is None:
        raise TypeError(f"SETTLE's kernel takes float32 or float64 tensors, "
                        f"got {x.dtype}")
    if (y.dtype != x.dtype or y.shape != x.shape or y.device != x.device
            or x.dim() not in (2, 3) or x.shape[-1] != 3
            or spec.a.device != x.device):
        raise ValueError(
            f"SETTLE's kernel takes two (N, 3) or (B, N, 3) tensors of one "
            f"type on the spec's device {spec.a.device}, got {x.dtype} "
            f"{tuple(x.shape)} on {x.device} and {y.dtype} {tuple(y.shape)} "
            f"on {y.device}")
    n = x.shape[-2]
    batch = x.shape[0] if x.dim() == 3 else 1
    w = spec.a.shape[0]
    covers = spec.contig == (0, w) and 3 * w == n
    out = (torch.empty_like(base, memory_format=torch.contiguous_format)
           if covers else base.clone(memory_format=torch.contiguous_format))
    x, y = x.contiguous(), y.contiguous()
    err = getattr(load_library(), f"{entry}_{suffix}")(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), spec.a.data_ptr(),
        spec.b.data_ptr(), spec.c.data_ptr(), spec.tables[x.dtype].data_ptr(),
        n, w, batch, spec._launch_counters[(entry, None, x.device)].data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, entry)
    tracing.count("constraints.settle_kernel")
    return out


def settle_positions(x, x_ref, spec: SettleSpec, masses):
    """``x`` (N, 3), or a batch (B, N, 3), with each rigid triangle
    projected onto its constraints from ``x_ref``: on a CUDA tensor one
    launch of ``csrc/settle.cu``'s ``settle_positions_kernel`` (float32 or
    float64; another type raises), on the CPU
    :func:`settle_positions_reference`, a batch under ``torch.func.vmap``.
    The kernel reads the masses the spec was built from (``spec.tables``),
    the plain version ``masses``. Counts ``constraints.settle`` once a
    call."""
    tracing.count("constraints.settle")
    if kernels_for(x, "SETTLE"):
        return _settle_launch("settle_positions", x, x_ref, x, spec)
    if x.dim() == 3:
        return torch.func.vmap(lambda xi, ri: settle_positions_reference(
            xi, ri, spec, masses))(x, x_ref)
    return settle_positions_reference(x, x_ref, spec, masses)


def settle_velocities(x, v, spec: SettleSpec, masses):
    """``v`` (N, 3), or a batch (B, N, 3), with each rigid triangle's
    relative velocities along its bonds at ``x`` removed: on a CUDA tensor
    one launch of ``settle_velocities_kernel``, on the CPU
    :func:`settle_velocities_reference`; as :func:`settle_positions`."""
    tracing.count("constraints.settle")
    if kernels_for(v, "SETTLE"):
        return _settle_launch("settle_velocities", x, v, v, spec)
    if v.dim() == 3:
        return torch.func.vmap(lambda xi, vi: settle_velocities_reference(
            xi, vi, spec, masses))(x, v)
    return settle_velocities_reference(x, v, spec, masses)


def settle_positions_reference(x, x_ref, spec: SettleSpec, masses):
    """Analytic position constraint: rotate each rigid triangle about its
    (momentum-conserving) center of mass so all three distances are exact.

    ``x_ref`` holds the pre-step (constraint-satisfying) positions that fix
    the triangle's prior orientation; ``x`` the unconstrained update. The
    plain version, (N, 3) on any device: the CPU path and the kernel's
    oracle on the card."""
    ma = masses[spec.a][:, None]
    mh = masses[spec.b][:, None]
    M = ma + 2.0 * mh
    a0, b0, c0, a1, b1, c1 = _molecules(spec, x_ref, x)
    com = (ma * a1 + mh * (b1 + c1)) / M
    a1p, b1p, c1p = a1 - com, b1 - com, c1 - com

    # orthonormal frame: z ~ old-plane normal, a1' in the y-z plane
    zax = torch.linalg.cross(b0 - a0, c0 - a0)
    zax = zax / torch.linalg.norm(zax, dim=-1, keepdim=True)
    xax = torch.linalg.cross(a1p, zax)
    xax = xax / torch.clamp(torch.linalg.norm(xax, dim=-1, keepdim=True),
                            min=1e-12)
    yax = torch.linalg.cross(zax, xax)

    def rot(p):
        return torch.stack([torch.sum(xax * p, -1), torch.sum(yax * p, -1),
                            torch.sum(zax * p, -1)], dim=-1)

    # old triangle relative to the OLD APEX (Miyamoto & Kollman eq. A5-A9)
    b0d, c0d = rot(b0 - a0), rot(c0 - a0)
    a1d, b1d, c1d = rot(a1p), rot(b1p), rot(c1p)

    ra, rb, rc = (t.to(x.dtype) for t in (spec.ra, spec.rb, spec.rc))
    sinphi = torch.clamp(a1d[:, 2] / ra, -1.0, 1.0)
    cosphi = torch.sqrt(1.0 - sinphi * sinphi)
    sinpsi = torch.clamp((b1d[:, 2] - c1d[:, 2]) / (2.0 * rc * cosphi),
                         -1.0, 1.0)
    cospsi = torch.sqrt(1.0 - sinpsi * sinpsi)

    ya2 = ra * cosphi
    xb2 = -rc * cospsi
    yb2 = -rb * cosphi - rc * sinpsi * sinphi
    yc2 = -rb * cosphi + rc * sinpsi * sinphi

    alpha = xb2 * (b0d[:, 0] - c0d[:, 0]) + b0d[:, 1] * yb2 \
        + c0d[:, 1] * yc2
    beta = xb2 * (c0d[:, 1] - b0d[:, 1]) + b0d[:, 0] * yb2 \
        + c0d[:, 0] * yc2
    gamma = b0d[:, 0] * b1d[:, 1] - b1d[:, 0] * b0d[:, 1] \
        + c0d[:, 0] * c1d[:, 1] - c1d[:, 0] * c0d[:, 1]
    a2b2 = alpha * alpha + beta * beta
    sintheta = (alpha * gamma
                - beta * torch.sqrt(torch.clamp(a2b2 - gamma * gamma,
                                                min=0.0))) / a2b2
    sintheta = torch.clamp(sintheta, -1.0, 1.0)
    costheta = torch.sqrt(1.0 - sintheta * sintheta)

    za2 = ra * sinphi
    zb2 = -rb * sinphi + rc * sinpsi * cosphi
    zc2 = -rb * sinphi - rc * sinpsi * cosphi
    a3 = torch.stack([-ya2 * sintheta, ya2 * costheta, za2], dim=-1)
    b3 = torch.stack([xb2 * costheta - yb2 * sintheta,
                      xb2 * sintheta + yb2 * costheta, zb2], dim=-1)
    c3 = torch.stack([-xb2 * costheta - yc2 * sintheta,
                      -xb2 * sintheta + yc2 * costheta, zc2], dim=-1)

    def unrot(p):                                      # R^T p
        return xax * p[:, 0:1] + yax * p[:, 1:2] + zax * p[:, 2:3]

    return _set_molecules(spec, x, com + unrot(a3), com + unrot(b3),
                          com + unrot(c3))


def settle_velocities_reference(x, v, spec: SettleSpec, masses):
    """Analytic RATTLE for triangles: a per-molecule 3x3 solve (Cramer's
    rule) for the bond Lagrange multipliers so every relative velocity is
    tangent. The plain version, as :func:`settle_positions_reference`."""
    inv_ma = 1.0 / masses[spec.a]
    inv_mh = 1.0 / masses[spec.b]

    def unit(p, q):
        r = p - q
        return r / torch.linalg.norm(r, dim=-1, keepdim=True)

    xa, xb, xc, va, vb, vc = _molecules(spec, x, v)
    # bonds: 0 = (a,b), 1 = (a,c), 2 = (b,c); unit directions
    e = torch.stack([unit(xa, xb), unit(xa, xc), unit(xb, xc)], dim=1)
    dv = torch.stack([va - vb, va - vc, vb - vc], dim=1)
    rhs = torch.sum(dv * e, dim=-1)                      # (W, 3)

    def dot(p, q):
        return torch.sum(e[:, p] * e[:, q], dim=-1)

    mab = inv_ma + inv_mh
    mbb = 2.0 * inv_mh
    a11, a12, a13 = mab, inv_ma * dot(0, 1), -inv_mh * dot(0, 2)
    a21, a22, a23 = inv_ma * dot(1, 0), mab, inv_mh * dot(1, 2)
    a31, a32, a33 = -inv_mh * dot(2, 0), inv_mh * dot(2, 1), mbb
    r1, r2, r3 = rhs[:, 0], rhs[:, 1], rhs[:, 2]
    det = (a11 * (a22 * a33 - a23 * a32)
           - a12 * (a21 * a33 - a23 * a31)
           + a13 * (a21 * a32 - a22 * a31))
    g0 = (r1 * (a22 * a33 - a23 * a32)
          - a12 * (r2 * a33 - a23 * r3)
          + a13 * (r2 * a32 - a22 * r3)) / det
    g1 = (a11 * (r2 * a33 - a23 * r3)
          - r1 * (a21 * a33 - a23 * a31)
          + a13 * (a21 * r3 - r2 * a31)) / det
    g2 = (a11 * (a22 * r3 - r2 * a32)
          - a12 * (a21 * r3 - r2 * a31)
          + r1 * (a21 * a32 - a22 * a31)) / det

    da = -(g0[:, None] * e[:, 0] + g1[:, None] * e[:, 1]) * inv_ma[:, None]
    db = (g0[:, None] * e[:, 0] - g2[:, None] * e[:, 2]) * inv_mh[:, None]
    dc = (g1[:, None] * e[:, 1] + g2[:, None] * e[:, 2]) * inv_mh[:, None]
    return _set_molecules(spec, v, da, db, dc, add=True)


def partition_constraints(constraints: Constraints, masses):
    """Split a mixed constraint topology into SETTLE-able rigid triangles
    and the rest (OpenMM's SETTLE + CCMA architecture).

    Returns (settle_spec | None, rest_constraints | None): either is None
    when its partition is empty.
    """
    if constraints.n_constraints == 0:
        return None, None
    triangles, rest_edges = _settle_triangles(constraints, masses)
    settle = _settle_spec(triangles, masses) if triangles else None
    rest = None
    if rest_edges:
        rows = torch.as_tensor(np.asarray(rest_edges, np.int64),
                               device=constraints.index.device)
        rest = Constraints(index=constraints.index[rows],
                           distance=constraints.distance[rows])
    return settle, rest


class ConstraintSolver:
    """A system's constraints as one solver, built once from the
    constraints, the masses and the tolerance: SETTLE on the rigid
    triangles, M-SHAKE/M-RATTLE on the rest where every cluster is small,
    else Jacobi SHAKE/RATTLE, on disjoint atom sets. :meth:`positions` and
    :meth:`velocities` take (N, 3) or a batch (B, N, 3): SETTLE takes it
    whole (one launch on the card, which vmap cannot trace through),
    M-SHAKE/M-RATTLE run under ``torch.func.vmap`` and Jacobi one replica
    at a time, iterating to a tolerance read on the host
    (``host_iterated``). One ``constraints.*`` span a call."""

    def __init__(self, constraints: Constraints, masses, tolerance=1e-8):
        self.masses = masses
        self.tolerance = tolerance
        self.settle, self.rest = partition_constraints(constraints, masses)
        self.clusters = (None if self.rest is None
                         else analyze_clusters(self.rest, masses))
        self.host_iterated = self.rest is not None and self.clusters is None

    def _per_replica(self, fn, a, b):
        """``fn`` of one configuration, or of a batch replica by replica."""
        if a.dim() == 2:
            return fn(a, b)
        if self.host_iterated:
            return torch.stack([fn(ai, bi) for ai, bi in zip(a, b)])
        return torch.func.vmap(fn)(a, b)

    def positions(self, x_new, x_old):
        """``x_new`` projected onto the constraints from ``x_old``."""
        with tracing.span("constraints.positions"):
            if self.settle is not None:
                x_new = settle_positions(x_new, x_old, self.settle,
                                         self.masses)
            if self.rest is None:
                return x_new
            return self._per_replica(self._rest_positions, x_new, x_old)

    def velocities(self, x, v):
        """``v`` with its components along the constraints at ``x``
        removed."""
        with tracing.span("constraints.velocities"):
            if self.settle is not None:
                v = settle_velocities(x, v, self.settle, self.masses)
            if self.rest is None:
                return v
            return self._per_replica(self._rest_velocities, x, v)

    def _rest_positions(self, x_new, x_old):
        if self.clusters is not None:
            return mshake_positions(x_new, x_old, self.rest, self.clusters,
                                    self.masses, tol=self.tolerance)
        return shake_positions(x_new, x_old, self.rest, self.masses,
                               tol=self.tolerance)

    def _rest_velocities(self, x, v):
        if self.clusters is not None:
            return mrattle_velocities(x, v, self.rest, self.clusters,
                                      self.masses)
        return rattle_velocities(x, v, self.rest, self.masses,
                                 tol=self.tolerance)
